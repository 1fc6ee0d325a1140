"""Convergence-aware denoiser blend (VERDICT r4 weak #3: denoising must
never regress a converged render)."""
import jax
import numpy as np
import pytest

jax.config.update("jax_platforms", "cpu")

from rene_tpu.models.denoise import convergence_blend


def test_converged_pixels_keep_raw():
    rng = np.random.default_rng(0)
    raw = rng.random((16, 16, 3), np.float32) + 0.5
    den = raw + 0.5  # a denoiser that would badly bias the result
    v = np.zeros((16, 16, 3), np.float32)  # fully converged
    out = convergence_blend(raw, den, v)
    np.testing.assert_allclose(out, raw, atol=1e-5)


def test_noisy_pixels_take_denoiser():
    rng = np.random.default_rng(1)
    raw = rng.random((16, 16, 3), np.float32)
    den = np.full_like(raw, 0.25)
    v = np.full((16, 16, 3), 100.0, np.float32)  # hopelessly noisy
    out = convergence_blend(raw, den, v)
    np.testing.assert_allclose(out, den, atol=1e-3)


def test_single_chunk_inf_var_means_denoise():
    raw = np.ones((8, 8, 3), np.float32)
    den = np.zeros_like(raw)
    v = np.full_like(raw, np.inf)
    out = convergence_blend(raw, den, v)
    np.testing.assert_allclose(out, den, atol=1e-6)


def test_render_want_var_end_to_end():
    from rene_tpu.scene import load_scene
    from rene_tpu.render import render
    import os
    scene_txt = """
Integrator "path" "integer maxdepth" [4]
LookAt 0 -4 1  0 0 1  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [24] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [.6 .6 .7]
AttributeBegin
  Material "matte" "rgb Kd" [.6 .4 .3]
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""
    p = "/tmp/test_want_var.pbrt"
    with open(p, "w") as f:
        f.write(scene_txt)
    out = render(load_scene(p), spp=8, want_var=True)
    v = out["varmean"]
    assert v.shape == out["color"].shape
    assert np.isfinite(v).all() and (v >= 0).all()
    # more samples -> tighter mean
    out2 = render(load_scene(p), spp=32, want_var=True)
    assert out2["varmean"].mean() < v.mean()
