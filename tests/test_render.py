"""End-to-end render tests (small resolutions, CPU backend).

Statistical assertions on physically known values — the CPU analogue of the
reference's visual-golden workflow (SURVEY.md §4).
"""
import numpy as np
import pytest

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.render import render


def render_str(src, spp=8, **kw):
    scene = create_scene(parse_pbrt(src), "/tmp")
    return render(scene, spp=spp, seed=1, **kw)


def test_background_only():
    out = render_str("""
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [.25 .5 .75]
WorldEnd""", spp=2)
    np.testing.assert_allclose(out["color"],
                               np.broadcast_to([0.25, 0.5, 0.75],
                                               (16, 16, 3)), atol=1e-5)


def test_no_light_is_black():
    out = render_str("""
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte"
Shape "sphere" "float radius" 1
WorldEnd""", spp=2)
    assert float(np.abs(out["color"]).max()) == 0.0


def test_lambertian_sphere_single_scatter():
    # first-bounce radiance of a diffuse sphere under a uniform sky is
    # rho * L at the center pixel (plus tiny multi-scatter)
    out = render_str("""
LookAt 0 -5 0  0 0 0  0 0 1
Camera "perspective" "float fov" 30
Film "image" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "matte" "rgb Kd" [ .5 .5 .5 ]
Shape "sphere" "float radius" 1
WorldEnd""", spp=64)
    center = out["color"][16, 16]
    # expected: 0.5 (direct) + small interreflection ~0 (convex object)
    np.testing.assert_allclose(center, [0.5, 0.5, 0.5], atol=0.05)
    # AOV normal at center points towards the camera (-y)
    n = out["normal"][16, 16]
    assert n[1] == pytest.approx(-1.0, abs=0.05)
    # albedo AOV
    np.testing.assert_allclose(out["albedo"][16, 16], [0.5] * 3, atol=0.01)


def test_area_light_emitter_visible():
    out = render_str("""
LookAt 0 -5 0  0 0 0  0 0 1
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [3 2 1]
  Material "matte" "rgb Kd" [0 0 0]
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd""", spp=8)
    # looking straight at the emitter: radiance == L (one-sided emit)
    np.testing.assert_allclose(out["color"][16, 16], [3, 2, 1], atol=0.01)


def test_distant_light_lambertian():
    # plane facing straight up, distant light straight down:
    # L_o = Kd/pi * cos(0) * L
    out = render_str("""
LookAt 0 0 3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "distant" "point from" [0 0 10] "point to" [0 0 0] "rgb L" [2 2 2]
Material "matte" "rgb Kd" [ .6 .6 .6 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-5 -5 0 5 -5 0 5 5 0 -5 5 0]
WorldEnd""", spp=32)
    expected = 0.6 / np.pi * 2.0
    np.testing.assert_allclose(out["color"][8, 8],
                               [expected] * 3, rtol=0.05)


def test_mirror_reflects_background():
    # mirror sphere reflects the env; with Kd(reflectance)=0.9 the center
    # pixel sees 0.9 * L (normal-incidence reflection back to the sky)
    out = render_str("""
LookAt 0 -5 0  0 0 0  0 0 1
Camera "perspective" "float fov" 20
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "mirror"
Shape "sphere" "float radius" 1
WorldEnd""", spp=16)
    np.testing.assert_allclose(out["color"][8, 8], [0.9] * 3, atol=0.02)


def test_maxdepth_one_direct_only():
    # maxdepth 1: only camera-ray emitter hits / background contribute
    out = render_str("""
LookAt 0 -5 0  0 0 0  0 0 1
Camera "perspective" "float fov" 40
Integrator "path" "integer maxdepth" [1]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [1 0 0]
Material "matte" "rgb Kd" [ .9 .9 .9 ]
Shape "sphere" "float radius" 1
WorldEnd""", spp=4)
    # sphere center: no light path possible within 1 vertex -> black
    assert float(out["color"][8, 8].max()) < 1e-6
    np.testing.assert_allclose(out["color"][0, 0], [1, 0, 0], atol=1e-5)


def test_checkpoint_resume(tmp_path):
    src = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [.5 .5 .5]
Material "matte"
Shape "sphere" "float radius" 1
WorldEnd"""
    ckpt = str(tmp_path / "film.npz")
    scene = create_scene(parse_pbrt(src), "/tmp")
    import rene_tpu.render as R
    # full render in one go
    full = R.render(scene, spp=200, seed=9)
    # interrupted: save checkpoint at 100 (LOG_EVERY), resume to 200
    R.render(scene, spp=100, seed=9, checkpoint=ckpt)
    resumed = R.render(scene, spp=200, seed=9, checkpoint=ckpt, resume=True)
    np.testing.assert_allclose(resumed["color"], full["color"], atol=1e-5)

    # resuming with a different seed must refuse the stale checkpoint
    # (fingerprint mismatch) instead of blending mismatched sample sums
    other = R.render(scene, spp=100, seed=10, checkpoint=ckpt, resume=True)
    fresh = R.render(scene, spp=100, seed=10)
    np.testing.assert_allclose(other["color"], fresh["color"], atol=1e-5)


def test_warm_cache_xla():
    """warm_cache compiles the driver's kernels without executing them."""
    from rene_tpu.pbrt import parse_pbrt
    from rene_tpu.render import warm_cache
    from rene_tpu.scene import create_scene
    src = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path" "integer maxdepth" 3
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "sphere" "float radius" 1
WorldEnd"""
    scene = create_scene(parse_pbrt(src), "/tmp")
    assert warm_cache(scene) == 1
