"""Scene compiler tests: flattening semantics, defaults, device SoA."""
import numpy as np
import pytest

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import build_device_scene, create_scene, load_scene
from rene_tpu.scene import types as T


def compile_str(src, base_dir="/tmp"):
    return create_scene(parse_pbrt(src), base_dir)


def test_sphere_scene(sample_scenes):
    scene = load_scene(str(sample_scenes / "sphere.pbrt"))
    assert scene.integrator == "path"
    assert scene.film.xresolution == 640 and scene.film.yresolution == 480
    assert len(scene.tlas) == 1
    inst = scene.tlas[0]
    assert inst.kind == T.KIND_SPHERE
    # matte material with Kd .7 .2 .2
    assert scene.mat_type[inst.material_index] == T.MAT_MATTE
    kd_tex = scene.mat_u0[inst.material_index][0]
    np.testing.assert_allclose(scene.tex_v0[kd_tex][:3], [0.7, 0.2, 0.2],
                               rtol=1e-6)
    # infinite light -> background color
    np.testing.assert_allclose(scene.background_color, [0.4, 0.45, 0.5],
                               rtol=1e-6)


def test_cornell_box(sample_scenes):
    scene = load_scene(str(sample_scenes / "cornell-box/scene.pbrt"))
    assert scene.film.xresolution == 1024
    assert len(scene.blases) == 8  # 7 meshes + light
    buffers, config = build_device_scene(scene)
    assert config.num_triangles == sum(b.num_triangles for b in scene.blases)
    assert config.num_emit_objects == 1
    assert config.num_emit_triangles == 2
    # light L
    li = scene.tlas[-1].area_light_index
    np.testing.assert_allclose(scene.area_color[li], [17, 12, 4])
    # named materials resolve
    assert scene.mat_type[scene.tlas[0].material_index] == T.MAT_MATTE


def test_veach(sample_scenes):
    scene = load_scene(str(sample_scenes / "veach-mis/scene.pbrt"))
    buffers, config = build_device_scene(scene)
    assert config.num_spheres == 3
    assert config.num_emit_spheres == 3
    assert config.num_emit_objects == 3
    # metal material with explicit uroughness/vroughness, remap off
    metal_rows = [i for i, t in enumerate(scene.mat_type)
                  if t == T.MAT_METAL]
    assert len(metal_rows) == 4
    for i in metal_rows:
        assert scene.mat_u1[i][0] == 0  # remaproughness false


def test_attribute_scoping():
    src = """WorldBegin
Material "matte" "rgb Kd" [1 0 0]
AttributeBegin
  Material "mirror"
  Shape "sphere" "float radius" 1
AttributeEnd
Shape "sphere" "float radius" 2
WorldEnd"""
    scene = compile_str(src)
    assert scene.mat_type[scene.tlas[0].material_index] == T.MAT_MIRROR
    assert scene.mat_type[scene.tlas[1].material_index] == T.MAT_MATTE


def test_object_instancing():
    src = """WorldBegin
Material "matte"
ObjectBegin "pair"
  Shape "sphere" "float radius" 1
ObjectEnd
Translate 5 0 0
ObjectInstance "pair"
Translate 5 0 0
ObjectInstance "pair"
WorldEnd"""
    scene = compile_str(src)
    assert len(scene.tlas) == 2
    # recorded matrix (identity) composed with CTMs
    np.testing.assert_allclose(scene.tlas[0].matrix[:3, 3], [5, 0, 0],
                               atol=1e-6)
    np.testing.assert_allclose(scene.tlas[1].matrix[:3, 3], [10, 0, 0],
                               atol=1e-6)


def test_sphere_radius_scale():
    src = """WorldBegin
Shape "sphere" "float radius" 3
WorldEnd"""
    scene = compile_str(src)
    m = scene.tlas[0].matrix
    np.testing.assert_allclose(m[:3, :3], np.eye(3) * 3, atol=1e-6)


def test_medium_interface():
    src = """WorldBegin
MakeNamedMedium "fog" "rgb sigma_a" [1 1 1] "rgb sigma_s" [2 2 2] "float g" 0.3
MediumInterface "fog" ""
Shape "sphere" "float radius" 1
WorldEnd"""
    scene = compile_str(src)
    inst = scene.tlas[0]
    assert inst.interior_medium_index == 1
    assert inst.exterior_medium_index == 0
    assert scene.med_type[1] == T.MEDIUM_HOMOGENEOUS
    np.testing.assert_allclose(scene.med_sigma_s[1], [2, 2, 2])
    assert scene.med_g[1] == pytest.approx(0.3)


def test_default_material_is_none():
    src = """WorldBegin
Shape "sphere" "float radius" 1
WorldEnd"""
    scene = compile_str(src)
    assert scene.tlas[0].material_index == 0
    assert scene.mat_type[0] == T.MAT_NONE


def test_camera_matrices(sample_scenes):
    scene = load_scene(str(sample_scenes / "sphere.pbrt"))
    # camera_to_world maps camera origin to eye position (3,4,1.5)
    eye = scene.camera_to_world @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(eye[:3], [3, 4, 1.5], atol=1e-4)


def test_teapot_texture_table(sample_scenes):
    scene = load_scene(str(sample_scenes / "teapot/scene.pbrt"))
    # checkerboard texture declared and referenced by the floor material
    assert T.TEX_CHECKER in scene.tex_type
    buffers, config = build_device_scene(scene)
    assert config.num_triangles == 2 + 78176 + 47872


def test_dragon_missing_meshes_skipped(sample_scenes):
    scene = load_scene(str(sample_scenes / "dragon/scene.pbrt"))
    # 4 of the referenced plys don't exist in the shipped scene; loader
    # warns and skips them instead of aborting.
    buffers, config = build_device_scene(scene)
    assert config.num_triangles > 40000


def test_scene_overrides():
    """Post-flatten overrides: per-instance material replacement and
    emission scaling (the --scene-overrides compat layer)."""
    import numpy as np

    from rene_tpu.pbrt import parse_pbrt
    from rene_tpu.scene import create_scene
    from rene_tpu.scene import types as T
    from rene_tpu.scene.overrides import apply_overrides

    src = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "matte" "rgb Kd" [.7 .2 .2]
Shape "sphere" "float radius" 1
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 8 6]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [0 0 3  1 0 3  0 1 3]
AttributeEnd
WorldEnd"""
    scene = create_scene(parse_pbrt(src), "/tmp")
    apply_overrides(scene, {"instances": [
        {"index": 0, "matte_kd": [0.1, 0.2, 0.9]},
        {"index": 1, "emission_scale": 0.5},
    ]})
    mi = scene.tlas[0].material_index
    assert scene.mat_type[mi] == T.MAT_MATTE
    kd = scene.tex_v0[scene.mat_u0[mi][0]]
    np.testing.assert_allclose(kd[:3], [0.1, 0.2, 0.9])
    ai = scene.tlas[1].area_light_index
    np.testing.assert_allclose(scene.area_color[ai], [5, 4, 3])

    # metal override with Tungsten alpha convention
    apply_overrides(scene, {"instances": [
        {"index": 0, "metal": {"eta": [0.2, 0.9, 1.1],
                               "k": [3.9, 2.5, 2.1],
                               "uroughness": 0.1, "vroughness": 0.1,
                               "alpha_from_roughness": "square"}}]})
    mi = scene.tlas[0].material_index
    assert scene.mat_type[mi] == T.MAT_METAL
    ru = scene.tex_v0[scene.mat_u0[mi][2]][0]
    assert abs(ru - 0.01) < 1e-7
    # out-of-range index errors
    try:
        apply_overrides(scene, {"instances": [{"index": 99,
                                               "matte_kd": [1, 1, 1]}]})
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_metal_fresnel_scale_override():
    """overrides.py fresnel_scale: scales the conductor response with an
    unchanged Fresnel curve (the veach-forensics knob)."""
    import numpy as np

    from rene_tpu.pbrt import parse_pbrt
    from rene_tpu.render import render
    from rene_tpu.scene import create_scene
    from rene_tpu.scene.overrides import apply_overrides

    src = """
LookAt 0 -5 2  0 0 0.5  0 0 1
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Integrator "path" "integer maxdepth" 3
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "metal" "rgb eta" [0.2 0.92 1.1] "rgb k" [3.9 2.45 2.1]
  "float uroughness" [0.2] "float vroughness" [0.2]
  "bool remaproughness" ["false"]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-2 -2 0  -2 2 0  2 2 0  2 -2 0]
WorldEnd"""

    def mean_radiance(scale):
        scene = create_scene(parse_pbrt(src), "/tmp")
        if scale is not None:
            apply_overrides(scene, {"instances": [
                {"index": 0, "metal": {
                    "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.1],
                    "uroughness": 0.2, "vroughness": 0.2,
                    "fresnel_scale": [scale] * 3}}]})
        return render(scene, spp=16, seed=7)["color"].mean()

    x1 = mean_radiance(None)
    x5 = mean_radiance(0.5)
    # the metal response scales (plate pixels dominate the film; the
    # background is unchanged), and the unscaled override is a no-op
    assert x5 < x1 * 0.95
    x0 = mean_radiance(1.0)
    np.testing.assert_allclose(x0, x1, rtol=1e-6)


def test_tungsten_compat_discovery(tmp_path, monkeypatch):
    """--tungsten-compat: find_tungsten_overrides locates the shipped
    calibration by scene name (PNG-calibrated file wins) and the
    settings block applies mf_dist + max_depth without env vars."""
    import json
    import os

    from rene_tpu.pbrt import parse_pbrt
    from rene_tpu.scene import create_scene
    from rene_tpu.scene.overrides import (apply_overrides,
                                          find_tungsten_overrides)

    d = tmp_path / "ov"
    d.mkdir()
    (d / "veach_tungsten.json").write_text(json.dumps({"instances": []}))
    (d / "veach_tungsten_png.json").write_text(json.dumps(
        {"settings": {"mf_dist": "beckmann", "max_depth": 2},
         "instances": []}))
    got = find_tungsten_overrides(
        "/any/where/veach-mis/scene.pbrt", search_dir=str(d))
    assert got is not None and got.endswith("veach_tungsten_png.json")
    # file-stem token match too (sphere.pbrt has no scene dir)
    (d / "sphere_tungsten.json").write_text(json.dumps({"instances": []}))
    got2 = find_tungsten_overrides("/x/sphere.pbrt", search_dir=str(d))
    assert got2 is not None and got2.endswith("sphere_tungsten.json")
    assert find_tungsten_overrides("/x/unknown/scene.pbrt",
                                   search_dir=str(d)) is None

    src = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Shape "sphere" "float radius" 1
WorldEnd"""
    scene = create_scene(parse_pbrt(src), "/tmp")
    monkeypatch.delenv("RENE_MF_DIST", raising=False)
    apply_overrides(scene, got)
    assert scene.max_depth_hint == 2
    assert os.environ.get("RENE_MF_DIST") == "beckmann"

    # the SHIPPED veach calibration resolves from the real docs dir
    shipped = find_tungsten_overrides(
        "/root/reference/sample_scenes/veach-mis/scene.pbrt")
    assert shipped is not None and shipped.endswith(
        "veach_tungsten_png.json")


def test_pfm_roundtrip(tmp_path):
    """save_pfm output reads back bit-exactly through load_pfm."""
    import numpy as np

    from rene_tpu.scene.assets.images import load_pfm, save_pfm

    rng = np.random.RandomState(0)
    rgb = (rng.rand(12, 20, 3) * 50).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    save_pfm(p, rgb)
    back = load_pfm(p)
    np.testing.assert_array_equal(back.data[..., :3], rgb)
    np.testing.assert_array_equal(back.data[..., 3], 1.0)


def test_background_override(tmp_path):
    """The background override block replaces the infinite light's
    color / environment map / world-to-light matrix (the compat
    surface for scenes whose shipped envmap asset is missing)."""
    import json

    import numpy as np

    from rene_tpu.pbrt import parse_pbrt
    from rene_tpu.scene import create_scene
    from rene_tpu.scene.assets.images import save_pfm
    from rene_tpu.scene.overrides import apply_overrides

    src = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "matte" "rgb Kd" [.7 .2 .2]
Shape "sphere" "float radius" 1
WorldEnd"""
    scene = create_scene(parse_pbrt(src), "/tmp")
    default_tex = scene.background_texture
    rgb = np.ones((4, 8, 3), np.float32) * [2.0, 1.0, 0.5]
    save_pfm(str(tmp_path / "env.pfm"), rgb)
    m = np.eye(4); m[0, 0] = m[2, 2] = 0.0; m[0, 2] = 1.0; m[2, 0] = -1.0
    ovp = tmp_path / "ov.json"
    ovp.write_text(json.dumps({"background": {
        "color": [0.5, 0.6, 0.7],
        "mapname": "env.pfm",              # relative to the json's dir
        "matrix": [float(x) for x in m.reshape(-1)]}}))
    apply_overrides(scene, str(ovp))
    np.testing.assert_allclose(scene.background_color, [0.5, 0.6, 0.7])
    assert scene.background_texture != default_tex
    np.testing.assert_allclose(scene.images[-1].data[..., :3], rgb)
    np.testing.assert_allclose(scene.background_matrix, m)

    # and the lookup actually uses it: build buffers + evaluate
    from rene_tpu.integrators.common import background_radiance
    from rene_tpu.ops.vec3 import V3
    from rene_tpu.scene.device import build_device_scene, to_jax
    import jax.numpy as jnp
    bn, cfg = build_device_scene(scene)
    buffers = to_jax(bn)
    d = V3(jnp.array([1.0]), jnp.array([0.0]), jnp.array([0.0]))
    out = background_radiance(buffers, d, cfg)
    got = np.array([float(out.x[0]), float(out.y[0]), float(out.z[0])])
    np.testing.assert_allclose(
        got, np.array([2.0, 1.0, 0.5]) * [0.5, 0.6, 0.7], rtol=1e-5)


def test_teapot_tungsten_compat_ships_envmap(sample_scenes):
    """--tungsten-compat discovers the shipped teapot calibration and
    installs the probe-reconstructed envmap (the scene's own
    textures/envmap.pfm is not shipped with the reference)."""
    import numpy as np

    from rene_tpu.scene import load_scene
    from rene_tpu.scene.overrides import (apply_overrides,
                                          find_tungsten_overrides)

    p = "/root/reference/sample_scenes/teapot/scene.pbrt"
    ov = find_tungsten_overrides(p)
    assert ov and ov.endswith("teapot_tungsten_png.json")
    scene = load_scene(p)
    before = scene.background_texture
    apply_overrides(scene, ov)
    assert scene.background_texture != before
    img = scene.images[-1].data
    assert img.shape[0] >= 32 and img.shape[2] == 4
    # env NEE importance-samples the window peak, so the shipped map is
    # only lightly clamped (commit 716a3aa raised the old hard clamp)
    assert np.isfinite(img).all() and 0 < img[..., :3].max() <= 128.0
    # world-to-light rotation: world up must map to the latlong pole
    up = np.asarray(scene.background_matrix)[:3, :3] @ np.array([0, 1, 0.0])
    np.testing.assert_allclose(up, [0, 0, 1], atol=1e-6)


def test_teapot_probe_override_is_denoiser_gated():
    """The teapot env-probe calibration declares requires_denoiser, so
    the CLI skips it for raw renders (compat must never lower raw SSIM
    — VALIDATION.md r4: compat raw 0.8882 < plain 0.9252)."""
    import json
    from rene_tpu.scene.overrides import find_tungsten_overrides
    p = find_tungsten_overrides("sample_scenes/teapot/scene.pbrt")
    assert p is not None and "teapot" in p
    with open(p) as f:
        ov = json.load(f)
    assert ov.get("requires_denoiser") is True
    # veach's calibration is material-level and valid for raw renders
    v = find_tungsten_overrides("sample_scenes/veach-mis/scene.pbrt")
    with open(v) as f:
        assert not json.load(f).get("requires_denoiser")
