"""Infinite-light importance sampling (env_nee).

Beyond the reference: rene samples the env map only through BSDF rays
(miss shader, lib.rs:120-139), which fireflies on HDR window texels.
env_nee adds the imagemap infinite light to the NEE/MIS strategy set:
a coarse luminance*sin(theta) grid is sampled (device.py env_* buffers)
and the mixture pdf gains the env term. The light-sampled direction
continues the path, so pickup stays the ordinary miss term and the
estimator is plain one-sample MIS — unbiased for ANY grid resolution.
"""
import numpy as np

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.assets.images import save_pfm
from rene_tpu.scene.device import build_device_scene


def env_scene(tmp_path, rgb, radius=1.0):
    save_pfm(str(tmp_path / "env.pfm"), rgb.astype(np.float32))
    src = f"""
Integrator "path" "integer maxdepth" [4]
LookAt 0 0.5 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [24] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "string mapname" ["env.pfm"]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "sphere" "float radius" {radius}
WorldEnd
"""
    return create_scene(parse_pbrt(src), str(tmp_path))


def render_mean(scene, spp, seed=3):
    from rene_tpu.render import render
    out = render(scene, spp=spp, seed=seed)
    return out["color"]


def test_env_grid_buffers(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.rand(32, 64, 3) * 2
    scene = env_scene(tmp_path, rgb)
    bn, cfg = build_device_scene(scene)
    assert cfg.env_nee
    mcdf, ccdf, pdf = bn["env_mcdf"], bn["env_ccdf"], bn["env_pdf"]
    assert mcdf.shape == (64,) and ccdf.shape == (64, 128)
    np.testing.assert_allclose(mcdf[-1], 1.0, rtol=1e-5)
    np.testing.assert_allclose(ccdf[:, -1], 1.0, rtol=1e-5)
    assert np.all(np.diff(mcdf) >= -1e-7)
    assert np.all(np.diff(ccdf, axis=1) >= -1e-7)
    # pdf integrates to 1 over the sphere
    th = (np.arange(64) + 0.5) * np.pi / 64
    dom = (2 * np.pi / 128) * (np.pi / 64) * np.sin(th)
    total = (pdf * dom[:, None]).sum()
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_env_nee_off_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("RENE_ENV_NEE", "0")
    rgb = np.ones((8, 16, 3))
    scene = env_scene(tmp_path, rgb)
    _, cfg = build_device_scene(scene)
    assert not cfg.env_nee


def test_env_nee_unbiased_vs_off(tmp_path, monkeypatch):
    """Same mean with the strategy on and off (one-sample MIS is
    unbiased); a hot-window map must agree within MC noise."""
    rgb = np.full((16, 32, 3), 0.4)
    rgb[3:5, 6:9] = [18.0, 9.0, 3.0]  # HDR window
    scene = env_scene(tmp_path, rgb)
    on = render_mean(scene, spp=256)
    monkeypatch.setenv("RENE_ENV_NEE", "0")
    scene2 = env_scene(tmp_path, rgb)
    off = render_mean(scene2, spp=1024)
    # compare means over sphere pixels (the high-variance region)
    m_on, m_off = on.mean(axis=(0, 1)), off.mean(axis=(0, 1))
    np.testing.assert_allclose(m_on, m_off, rtol=0.08)


def test_env_nee_variance_win(tmp_path, monkeypatch):
    """The whole point: under a small hot window the cosine sampler
    almost never finds the light (a 16-spp render is missing it
    entirely, punctuated by rare fireflies), while the env strategy
    nails it. Low-spp error vs a converged reference must drop >2x on
    the sphere. (Per-pixel std across a few seeds is the WRONG metric
    here: the off-case's rare-event variance doesn't show up in 4
    seeds, and the dominant std lives in background pixels at the
    window's own edge — camera-jitter aliasing NEE cannot touch.)"""
    rgb = np.full((16, 32, 3), 0.05)
    rgb[1:3, :] = 0.0
    rgb[1:3, 6:9] = 60.0  # small window near the zenith

    def floor_scene():
        # camera above a matte floor: every pixel is window-lit, no
        # silhouette pixels to pollute the error metric
        src = """
Integrator "path" "integer maxdepth" [3]
LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
Film "image" "integer xresolution" [24] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "string mapname" ["env.pfm"]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-50 0 -50  50 0 -50  50 0 50  -50 0 50]
WorldEnd
"""
        save_pfm(str(tmp_path / "env.pfm"), rgb.astype(np.float32))
        return create_scene(parse_pbrt(src), str(tmp_path))

    ref = render_mean(floor_scene(), spp=2048, seed=11)

    def err(env_on):
        if not env_on:
            monkeypatch.setenv("RENE_ENV_NEE", "0")
        else:
            monkeypatch.delenv("RENE_ENV_NEE", raising=False)
        sc = floor_scene()
        e = 0.0
        for s in range(3):
            img = render_mean(sc, spp=16, seed=s)
            e += np.sqrt(((img - ref) ** 2).mean())
        return e / 3
    e_on, e_off = err(True), err(False)
    assert e_on < 0.5 * e_off, (e_on, e_off)
