"""Feature scenes and the three invariants every one of them must keep.

Each scene exercises one feature of the XLA integrators (textures in every
slot, backgrounds, materials, lights, media, many primitives, instancing,
big meshes) on a 16x12 film, and carries a floor or panel of triangles so
both triangle accelerators apply. The invariants, all at one sample per
pixel with the same seed (the per-lane RNG is keyed on pixel and seed):

* accel   — the brute-force matmul intersector and the BVH give the same
            image (up to the rare pixel where float rounding picks another
            triangle on a shared edge and the path diverges);
* tiles   — rendering the frame in ray tiles gives the whole-frame image;
* sharded — `render_tiles_sharded` over the 8 virtual CPU devices gives
            the single-device image.
"""
from __future__ import annotations

import numpy as np

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.assets.images import save_pfm

W, H = 16, 12
SEED = 7
FLOOR = """
AttributeBegin
  Material "matte" "rgb Kd" [ .5 .5 .5 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -6 -6 -1.2  6 -6 -1.2  6 6 -1.2  -6 6 -1.2 ]
    "float uv" [ 0 0  1 0  1 1  0 1 ]
AttributeEnd
"""


def _head(integrator="path", maxdepth=4, fov=50, look="0 -5 1  0 0 0  0 0 1",
          extra=""):
    return f"""
LookAt {look}
Camera "perspective" "float fov" [ {fov} ]
Film "image" "integer xresolution" [ {W} ] "integer yresolution" [ {H} ]
Integrator "{integrator}" "integer maxdepth" [ {maxdepth} ]
{extra}
WorldBegin
"""


def _ramp(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.linspace(0.1, 0.9, w)[None, :]
    img[..., 1] = np.linspace(0.8, 0.2, h)[:, None]
    img[..., 2] = 0.3 + 0.2 * rng.random((h, w))
    return img


def uv_sphere(nu=20, nv=12, r=0.45):
    verts, idx = [], []
    for j in range(nv + 1):
        th = np.pi * j / nv
        for i in range(nu):
            ph = 2 * np.pi * i / nu
            verts.append((r * np.sin(th) * np.cos(ph),
                          r * np.sin(th) * np.sin(ph), r * np.cos(th)))
    for j in range(nv):
        for i in range(nu):
            a, b = j * nu + i, j * nu + (i + 1) % nu
            c, d = (j + 1) * nu + (i + 1) % nu, (j + 1) * nu + i
            if j > 0:
                idx += [a, b, c]
            if j < nv - 1:
                idx += [a, c, d]
    p = " ".join(f"{x:.5f} {y:.5f} {z:.5f}" for x, y, z in verts)
    return p, " ".join(map(str, idx))


def env_map_bg(d):
    save_pfm(str(d / "env.pfm"), _ramp(8, 16, 1))
    return _head() + """
LightSource "infinite" "rgb L" [ 1 .9 .8 ] "string mapname" "env.pfm"
Material "matte" "rgb Kd" [ .5 .4 .3 ]
Shape "sphere" "float radius" 1
""" + FLOOR


def imagemap_kd(d):
    save_pfm(str(d / "kd.pfm"), _ramp(8, 16, 2))
    return _head() + """
LightSource "infinite" "rgb L" [ .9 .9 .9 ]
Texture "kdmap" "spectrum" "imagemap" "string filename" "kd.pfm"
Material "matte" "texture Kd" "kdmap"
Shape "sphere" "float radius" 1
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -3 1.5 -3  -3 1.5 3  3 1.5 3  3 1.5 -3 ]
  "float uv" [ 0 0  0 1  1 1  1 0 ]
"""


def checker_bg(d):
    return _head(fov=70) + """
Texture "sky" "spectrum" "checkerboard" "float uscale" [ 8 ]
  "float vscale" [ 4 ] "rgb tex1" [ .9 .7 .2 ] "rgb tex2" [ .1 .2 .5 ]
LightSource "infinite" "texture L" [ "sky" ]
Material "matte" "rgb Kd" [ .5 .4 .3 ]
Shape "sphere" "float radius" 1
""" + FLOOR


def solid_bg(d):
    return _head() + """
LightSource "infinite" "rgb L" [ .5 .25 .125 ]
Material "matte" "rgb Kd" [ .7 .7 .7 ]
Shape "sphere" "float radius" 1
""" + FLOOR


def substrate_plastic_kdmap(d):
    save_pfm(str(d / "kd2.pfm"), _ramp(8, 16, 3))
    return _head(look="0 -4 1.2  0 0 .6  0 0 1") + """
LightSource "infinite" "rgb L" [ .8 .8 .8 ]
Texture "kdmap" "spectrum" "imagemap" "string filename" "kd2.pfm"
Material "substrate" "texture Kd" "kdmap" "rgb Ks" [ .15 .15 .15 ]
  "float uroughness" [ .1 ] "float vroughness" [ .1 ]
  "bool remaproughness" [ "false" ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -2 1 -2  -2 1 2  2 1 2  2 1 -2 ]
  "float uv" [ 0 0  0 1  1 1  1 0 ]
Material "plastic" "texture Kd" "kdmap" "rgb Ks" [ .2 .2 .2 ]
  "float roughness" [ .2 ] "bool remaproughness" [ "false" ]
Shape "sphere" "float radius" .8
"""


def uber_plastic_checker(d):
    return _head(look="0 -6 1  0 0 1  0 0 1", maxdepth=5) + """
LightSource "infinite" "rgb L" [ .7 .7 .7 ]
LightSource "distant" "rgb L" [ 1.5 1.4 1.2 ] "point from" [ 1 -2 4 ]
  "point to" [ 0 0 0 ]
AttributeBegin
  Material "plastic" "rgb Kd" [ .4 .2 .1 ] "rgb Ks" [ .3 .3 .3 ]
    "float roughness" .2
  Translate -1.5 0 1
  Shape "sphere" "float radius" 1
AttributeEnd
AttributeBegin
  Material "uber" "rgb Kd" [ .2 .3 .4 ] "rgb Ks" [ .2 .2 .2 ]
    "rgb Kr" [ .1 .1 .1 ] "rgb opacity" [ .8 .8 .8 ] "float eta" 1.5
    "float roughness" .15
  Translate 1.5 0 1
  Shape "sphere" "float radius" 1
AttributeEnd
AttributeBegin
  Texture "check" "spectrum" "checkerboard" "rgb tex1" [ .1 .1 .1 ]
    "rgb tex2" [ .7 .7 .7 ] "float uscale" 8 "float vscale" 8
  Material "matte" "texture Kd" "check"
  Translate 0 3 1
  Shape "sphere" "float radius" 1.2
AttributeEnd
""" + FLOOR


def uber_opacity(d):
    return _head(look="0 -4 1  0 0 .5  0 0 1", maxdepth=5) + """
LightSource "infinite" "rgb L" [ .7 .7 .75 ]
Texture "opcheck" "spectrum" "checkerboard" "float uscale" 3
  "float vscale" 3 "rgb tex1" [ 1 1 1 ] "rgb tex2" [ .2 .2 .2 ]
Material "uber" "rgb Kd" [ .35 .3 .2 ] "rgb Ks" [ .15 .15 .15 ]
  "texture opacity" "opcheck" "float roughness" [ .2 ]
  "bool remaproughness" [ "false" ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -1.5 .5 -1.5  -1.5 .5 1.5  1.5 .5 1.5  1.5 .5 -1.5 ]
  "float uv" [ 0 0  0 1  1 1  1 0 ]
Material "matte" "rgb Kd" [ .5 .4 .3 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -4 3 -4  -4 3 4  4 3 4  4 3 -4 ]
"""


def textured_roughness_ks(d):
    rough = np.repeat(np.linspace(0.02, 0.6, 8, dtype=np.float32)
                      [None, :, None], 8, axis=0).repeat(3, axis=2)
    save_pfm(str(d / "rough.pfm"), rough)
    return _head(look="0 -4 1.2  0 0 .6  0 0 1") + """
LightSource "infinite" "rgb L" [ .8 .8 .8 ]
LightSource "distant" "rgb L" [ 2 1.8 1.5 ] "point from" [ 1 -2 4 ]
  "point to" [ 0 0 0 ]
Texture "rmap" "float" "imagemap" "string filename" "rough.pfm"
Texture "kscheck" "spectrum" "checkerboard" "float uscale" 4
  "float vscale" 4 "rgb tex1" [ .05 .05 .05 ] "rgb tex2" [ .4 .4 .4 ]
Material "substrate" "rgb Kd" [ .3 .25 .2 ] "rgb Ks" [ .2 .2 .2 ]
  "texture uroughness" "rmap" "texture vroughness" "rmap"
  "bool remaproughness" [ "true" ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -2 1 -2  -2 1 2  2 1 2  2 1 -2 ]
  "float uv" [ 0 0  0 1  1 1  1 0 ]
Material "plastic" "rgb Kd" [ .4 .2 .15 ] "texture Ks" "kscheck"
  "float roughness" [ .15 ] "bool remaproughness" [ "false" ]
Shape "sphere" "float radius" .8
"""


def beckmann_metal(d):
    return _head(look="0 -4 1  0 0 .5  0 0 1") + """
LightSource "distant" "rgb L" [ 3 3 3 ] "point from" [ 1 -2 3 ]
  "point to" [ 0 0 0 ]
LightSource "infinite" "rgb L" [ .2 .2 .2 ]
Material "metal" "rgb eta" [ .2 .92 1.1 ] "rgb k" [ 3.9 2.45 2.14 ]
  "float roughness" [ .2 ] "bool remaproughness" [ "false" ]
Shape "sphere" "float radius" 1
Material "matte" "rgb Kd" [ .5 .4 .3 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -4 3 -4  -4 3 4  4 3 4  4 3 -4 ]
"""


def pixel_filter(d):
    return _head(look="0 -4 1  0 0 .5  0 0 1", maxdepth=3,
                 extra='PixelFilter "triangle" "float xwidth" [ 1 ] '
                       '"float ywidth" [ 1 ]') + """
LightSource "infinite" "rgb L" [ .8 .8 .85 ]
Material "matte" "rgb Kd" [ .6 .3 .2 ]
Shape "sphere" "float radius" 1
""" + FLOOR


def rotated_emitter_sphere(d):
    return _head(look="0 -6 2.5  0 0 .5  0 0 1") + """
LightSource "infinite" "rgb L" [ .1 .1 .12 ]
Material "matte" "rgb Kd" [ .6 .55 .5 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
  "point P" [ -4 -4 0  -4 4 0  4 4 0  4 -4 0 ]
AttributeBegin
  Material "matte" "rgb Kd" [ .5 .3 .2 ]
  Translate .9 0 1.2
  Shape "sphere" "float radius" .35
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 5 4 3 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  Translate 0 0 1.2
  Rotate 35 0 0 1
  Scale 2.4 .25 .6
  Shape "sphere" "float radius" 1
AttributeEnd
"""


def many_lights_64(d):
    rng = np.random.default_rng(5)
    lights = []
    for i in range(64):
        th = 2 * np.pi * i / 64
        el = 0.4 + 0.5 * rng.random()
        c = 0.03 + 0.03 * rng.random(3)
        lights.append(
            f'LightSource "distant" "rgb L" [ {c[0]:.3f} {c[1]:.3f} '
            f'{c[2]:.3f} ] "point from" [ {6 * np.cos(th):.3f} '
            f'{6 * np.sin(th):.3f} {6 * np.tan(el):.3f} ] '
            f'"point to" [ 0 0 0 ]')
    return _head(maxdepth=2) + "\n".join(lights) + """
Material "plastic" "rgb Kd" [ .4 .3 .5 ] "rgb Ks" [ .3 .3 .3 ]
  "float roughness" [ .08 ] "bool remaproughness" [ "false" ]
Shape "sphere" "float radius" 1.1
""" + FLOOR


def fog_volpath(d):
    return _head(integrator="volpath", maxdepth=6, fov=45,
                 look="0 -5 0  0 0 0  0 0 1") + """
LightSource "infinite" "rgb L" [ .6 .6 .6 ]
LightSource "distant" "rgb L" [ 2 2 2 ] "point from" [ 0 -1 1 ]
  "point to" [ 0 0 0 ]
AttributeBegin
  MakeNamedMedium "fog" "rgb sigma_a" [ .2 .25 .3 ] "rgb sigma_s" [ .8 .7 .6 ]
    "float g" 0.2
  MediumInterface "fog" ""
  Material "none"
  Shape "sphere" "float radius" 1.5
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 6 4 2 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  Translate 0 0 2.5
  Shape "sphere" "float radius" .4
AttributeEnd
""" + FLOOR.replace("-1.2", "-1.6")


def spheres_1000(d):
    rng = np.random.default_rng(11)
    mats = ['Material "matte" "rgb Kd" [ .7 .3 .25 ]',
            'Material "matte" "rgb Kd" [ .25 .6 .3 ]',
            'Material "plastic" "rgb Kd" [ .3 .3 .65 ] "rgb Ks" [ .2 .2 .2 ]'
            ' "float roughness" [ .1 ] "bool remaproughness" [ "false" ]']
    parts = []
    for i in range(1000):
        x = (i % 32 - 16) * 0.6 + rng.uniform(-0.1, 0.1)
        y = (i // 32 - 16) * 0.6 + rng.uniform(-0.1, 0.1)
        r = rng.uniform(0.12, 0.26)
        parts.append(f'AttributeBegin\n  {mats[i % 3]}\n  Translate '
                     f'{x:.3f} {y:.3f} {r - 1.2:.3f}\n  Shape "sphere" '
                     f'"float radius" {r:.3f}\nAttributeEnd')
    return _head(look="0 -14 6  0 0 0  0 0 1", maxdepth=3, fov=55) + """
LightSource "distant" "rgb L" [ 2.2 2 1.8 ] "point from" [ 3 -4 8 ]
  "point to" [ 0 0 0 ]
LightSource "infinite" "rgb L" [ .25 .28 .33 ]
""" + "\n".join(parts) + FLOOR


def instanced(d):
    p, i = uv_sphere()
    insts = []
    for k in range(12):
        s = 0.8 + 0.1 * (k % 3)
        insts.append(f"""AttributeBegin
  Translate {(k % 4) * 1.4 - 2.1:.2f} {(k // 4) * 1.4 - 1.4:.2f} 0.45
  Rotate {30.0 * k:.1f} 0 0 1
  Scale {s:.2f} {s:.2f} {s:.2f}
  ObjectInstance "ball"
AttributeEnd""")
    return _head(look="0 -6 4  0 0 0  0 0 1", maxdepth=4, fov=48) + f"""
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 10 9 8 ]
  Shape "trianglemesh" "point P" [ -.8 -.8 4  .8 -.8 4  .8 .8 4  -.8 .8 4 ]
    "integer indices" [ 0 2 1 0 3 2 ]
AttributeEnd
ObjectBegin "ball"
  Material "matte" "rgb Kd" [ .7 .3 .25 ]
  Shape "trianglemesh" "point P" [ {p} ] "integer indices" [ {i} ]
ObjectEnd
{chr(10).join(insts)}
Material "matte" "rgb Kd" [ .5 .5 .5 ]
Shape "trianglemesh" "point P" [ -8 -8 0  8 -8 0  8 8 0  -8 8 0 ]
  "integer indices" [ 0 1 2 0 2 3 ]
"""


def mesh_8k(d):
    from rene_tpu.scene.synth import mesh_scene_source
    src = mesh_scene_source(seed=3, nlevels=2, xres=W, yres=H)
    return src.replace('"integer maxdepth" [ 65 ]', '"integer maxdepth" [ 4 ]')


def env_nee_emitter(d):
    rgb = np.full((16, 32, 3), 0.3, np.float32)
    rgb[2:4, 4:7] = [25.0, 12.0, 5.0]
    save_pfm(str(d / "hot.pfm"), rgb)
    return _head(look="0 1.2 -3.2  0 .6 0  0 1 0", maxdepth=5, fov=45) + """
LightSource "infinite" "string mapname" [ "hot.pfm" ]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 8 7 6 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -.6 2.2 -.6  .6 2.2 -.6  .6 2.2 .6  -.6 2.2 .6 ]
AttributeEnd
Material "matte" "rgb Kd" [ .6 .5 .4 ]
Shape "sphere" "float radius" .6
Material "matte" "rgb Kd" [ .5 .5 .5 ]
Shape "trianglemesh" "point P" [ -6 0 -6  6 0 -6  6 0 6  -6 0 6 ]
  "integer indices" [ 0 1 2 0 2 3 ]
"""


def sobol_sampler(d):
    return _head(extra='Sampler "sobol" "integer pixelsamples" [ 64 ]') + """
LightSource "infinite" "rgb L" [ .5 .5 .55 ]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 10 8 6 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  Translate 0 0 3
  Shape "sphere" "float radius" .4
AttributeEnd
Material "matte" "rgb Kd" [ .6 .45 .3 ]
Shape "sphere" "float radius" 1
""" + FLOOR


SCENES = {f.__name__: f for f in (
    env_map_bg, imagemap_kd, checker_bg, solid_bg, substrate_plastic_kdmap,
    uber_plastic_checker, uber_opacity, textured_roughness_ks,
    beckmann_metal, pixel_filter, rotated_emitter_sphere, many_lights_64,
    fog_volpath, spheres_1000, instanced, mesh_8k, env_nee_emitter,
    sobol_sampler)}
# process-wide settings a scene needs while it is traced
ENV = {"beckmann_metal": {"RENE_MF_DIST": "beckmann"}}

_baselines = {}


def _run(run, buffers, px, py):
    import jax.numpy as jnp
    out = run(buffers, px, py, jnp.uint32(SEED), 1)
    return {k: np.asarray(out[k]) for k in ("radiance", "normal", "albedo")}


def _baseline(name, scene_dir):
    if name not in _baselines:
        import jax.numpy as jnp

        from rene_tpu.ops.accel import make_accel
        from rene_tpu.render import _batch_fn
        from rene_tpu.scene.device import build_device_scene, to_jax

        d = scene_dir / name
        d.mkdir(exist_ok=True)
        src = SCENES[name](d)
        if "WorldEnd" not in src:
            src += "WorldEnd\n"
        scene = create_scene(parse_pbrt(src), str(d))
        bn, config = build_device_scene(scene)
        assert (config.film.xresolution, config.film.yresolution) == (W, H)
        assert config.num_triangles > 0
        accel = make_accel(bn, config)
        buffers = to_jax(bn)
        ys, xs = np.mgrid[0:H, 0:W]
        px = jnp.asarray(xs.reshape(-1).astype(np.int32))
        py = jnp.asarray(ys.reshape(-1).astype(np.int32))
        run, _ = _batch_fn(config, accel=accel)
        img = _run(run, buffers, px, py)
        assert np.isfinite(img["radiance"]).all()
        assert img["radiance"].mean() > 1e-4, "scene renders black"
        _baselines[name] = (bn, config, accel, run, buffers, px, py, img)
    return _baselines[name]


def _agree(img, ref, exact):
    from rene_tpu.utils.verify import image_agreement
    for k in ("radiance", "normal", "albedo"):
        if exact:
            np.testing.assert_allclose(img[k], ref[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            # same tolerance as the GPU-vs-CPU render check (chip_smoke)
            rep = image_agreement(img[k].reshape(H, W, 3),
                                  ref[k].reshape(H, W, 3))
            assert rep["rel_mse"] <= 1e-3 and rep["rel_mean"] <= 1e-3, \
                (k, rep)


def check(name, invariant, scene_dir, monkeypatch):
    """Assert `invariant` ("accel", "tiles" or "sharded") on scene `name`."""
    for k, v in ENV.get(name, {}).items():
        monkeypatch.setenv(k, v)
    bn, config, accel, run, buffers, px, py, ref = _baseline(name,
                                                             scene_dir)
    if invariant == "accel":
        from rene_tpu.ops.accel import make_accel
        from rene_tpu.ops.bvh import BVH
        from rene_tpu.render import _batch_fn
        other = (make_accel(bn, config, mxu_max_tris=1 << 30)
                 if isinstance(accel.main, BVH)
                 else make_accel(bn, config, force="bvh"))
        assert type(other.main) is not type(accel.main)
        other_run, _ = _batch_fn(config, accel=other)
        _agree(_run(other_run, buffers, px, py), ref, exact=False)
    elif invariant == "tiles":
        n = W * H
        parts = [_run(run, buffers, px[lo:lo + n // 4], py[lo:lo + n // 4])
                 for lo in range(0, n, n // 4)]
        img = {k: np.concatenate([p[k] for p in parts]) for k in ref}
        _agree(img, ref, exact=True)
    elif invariant == "sharded":
        import jax
        import jax.numpy as jnp

        from rene_tpu.parallel.shard import make_mesh, render_tiles_sharded
        mesh = make_mesh(jax.devices()[:8])
        run = render_tiles_sharded(mesh, config, accel=accel)
        out = run(buffers, px, py, jnp.uint32(SEED))
        _agree({k: np.asarray(out[k]) for k in ref}, ref, exact=True)
    else:
        raise ValueError(invariant)
