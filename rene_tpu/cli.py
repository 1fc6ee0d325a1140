"""Command-line interface.

Mirrors the reference CLI (rene/src/main.rs:47-71): positional pbrt scene,
`--aov-normal`, `--aov-albedo`, `--denoiser`, `--dump-module` — plus the
knobs the reference hardcodes (SURVEY.md §5 config table): `--spp`
(reference N_SAMPLES=5000), `--seed`, `--tile-rays`, `--checkpoint/--resume`,
`--output` override, `--devices N --multichip-mode {samples,tiles}` for
multi-device rendering, `--warm-cache` to pre-compile a scene's kernels
into the persistent JAX compilation cache, and `--tungsten-compat` /
`--mf-dist` to apply the shipped Tungsten-golden calibrations
(scene/overrides.py) from the CLI surface.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rene-tpu",
        description="pbrt-v3 path tracer in JAX")
    p.add_argument("scene", help="pbrt scene file")
    p.add_argument("--aov-normal", metavar="PATH",
                   help="write the normal AOV image")
    p.add_argument("--aov-albedo", metavar="PATH",
                   help="write the albedo AOV image")
    p.add_argument("--denoiser", choices=["none", "atrous", "cnn"],
                   default="none",
                   help="AOV-guided denoiser (replaces optix/oidn)")
    p.add_argument("--unet-weights", metavar="PATH",
                   help="trained U-Net weights for --denoiser cnn (train "
                        "with python -m rene_tpu.models.train_denoiser)")
    p.add_argument("--dump-module", action="store_true",
                   help="dump the lowered StableHLO of the render kernel "
                        "and exit (the reference dumps its SPIR-V)")
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (default: 5000, like the "
                        "reference; pbrt pixelsamples is NOT used)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tile-rays", type=int, default=1 << 18)
    p.add_argument("--output", help="override the Film filename")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="film checkpoint file (saved every 100 samples)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if present")
    p.add_argument("--bvh", choices=["auto", "on", "off"], default="auto")
    p.add_argument("--sampler", choices=["auto", "sobol", "independent"],
                   default="auto",
                   help="override the scene's Sampler directive "
                   "(auto honors it; the renderer currently samples "
                   "independently and warns on sobol)")
    p.add_argument("--color-space", choices=["linear", "srgb",
                                             "srgb-lights"],
                   default="linear",
                   help="rgb value interpretation; srgb-lights matches the "
                        "shipped Tungsten goldens")
    p.add_argument("--scene-overrides", metavar="FILE",
                   help="JSON instance/material override file applied "
                        "after scene flattening (diagnostic/compat "
                        "layer; see rene_tpu/scene/overrides.py)")
    p.add_argument("--tungsten-compat", action="store_true",
                   help="auto-apply the shipped Tungsten-golden "
                        "calibration for this scene "
                        "(docs/overrides/<scene>_tungsten*.json: "
                        "Beckmann lobes, conductor normalization, "
                        "golden-matched albedos/depth). One flag "
                        "reproduces veach SSIM >=0.95 vs "
                        "TungstenRender.png")
    p.add_argument("--mf-dist", choices=["auto", "ggx", "beckmann"],
                   default="auto",
                   help="microfacet distribution for all rough "
                        "conductors/dielectrics (auto = ggx unless an "
                        "override file selects otherwise)")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="render across N devices of a 1-D device mesh "
                        "(shard_map; samples mode psums the films)")
    p.add_argument("--multichip-mode", choices=["samples", "tiles"],
                   default="samples",
                   help="samples: each device traces the frame at its "
                        "own sample (spp throughput scales); tiles: "
                        "devices split the frame (per-sample latency "
                        "scales)")
    p.add_argument("--warm-cache", action="store_true",
                   help="compile the scene's render kernels (populating "
                        "the persistent JAX compilation cache) and exit "
                        "without rendering")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s [%(name)s] %(message)s")
    log = logging.getLogger("rene_tpu")

    t0 = time.time()
    from .pbrt import ParseError
    from .scene import load_scene
    try:
        scene = load_scene(args.scene, color_space=args.color_space)
    except ParseError as e:
        # span-labeled report with source excerpts (the reference prints
        # ariadne reports, rene/src/main.rs:129-190)
        print(e.render(args.scene), file=sys.stderr)
        return 1
    if args.sampler != "auto":
        scene.sampler = args.sampler
    if args.mf_dist != "auto":
        os.environ["RENE_MF_DIST"] = args.mf_dist
    ov_file = args.scene_overrides
    if args.tungsten_compat and not ov_file:
        from .scene.overrides import find_tungsten_overrides
        ov_file = find_tungsten_overrides(args.scene)
        if ov_file is None:
            log.warning("--tungsten-compat: no shipped calibration for "
                        "this scene (docs/overrides/); rendering as-is")
        elif args.denoiser == "none":
            # calibration files may declare themselves denoiser-only
            # (e.g. the teapot env probe lowers raw SSIM): never let
            # compat regress a raw render
            import json as _json
            try:
                with open(ov_file) as f:
                    _ov = _json.load(f)
            except Exception:
                _ov = {}
            if _ov.get("requires_denoiser"):
                log.info("--tungsten-compat: %s is calibrated for "
                         "denoised output only; skipping for this raw "
                         "render (pass --denoiser atrous/cnn to apply)",
                         os.path.basename(ov_file))
                ov_file = None
    if ov_file:
        from .scene.overrides import apply_overrides
        apply_overrides(scene, ov_file)
        if args.mf_dist != "auto":  # explicit flag beats the file
            os.environ["RENE_MF_DIST"] = args.mf_dist
        log.info("applied scene overrides from %s", ov_file)
    log.info("scene compiled in %.2fs", time.time() - t0)

    from .utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()

    if args.dump_module:
        import jax

        from .render import _sample_fn
        from .scene.device import build_device_scene, to_jax
        buffers_np, config = build_device_scene(scene)
        buffers = to_jax(buffers_np)
        import jax.numpy as jnp
        px = jnp.zeros((256,), jnp.int32)
        py = jnp.zeros((256,), jnp.int32)
        run = _sample_fn(config)
        lowered = jax.jit(lambda b, x, y, s: run(b, x, y, s)).lower(
            buffers, px, py, jnp.uint32(0))
        print(lowered.as_text())
        return 0

    if args.warm_cache:
        t = time.time()
        from .render import warm_cache
        n_kernels = warm_cache(scene)
        log.info("warmed %d kernel(s) in %.1fs (cache: %s)", n_kernels,
                 time.time() - t, cache_dir)
        return 0

    from .render import DEFAULT_SPP, render
    spp = args.spp if args.spp is not None else DEFAULT_SPP
    use_bvh = {"auto": None, "on": True, "off": False}[args.bvh]
    if args.devices > 1:
        import jax
        devs = jax.devices()
        if len(devs) < args.devices:
            log.error("--devices %d requested but only %d present",
                      args.devices, len(devs))
            return 1
        from .parallel.shard import make_mesh, render_multichip
        mesh = make_mesh(devs[:args.devices])
        t_mc = time.time()
        out = render_multichip(scene, spp=spp, seed=args.seed, mesh=mesh,
                               tile_rays=args.tile_rays,
                               mode=args.multichip_mode)
        out["wall_time"] = time.time() - t_mc
        log.info("multichip: %d devices, mode=%s, effective spp %d",
                 args.devices, args.multichip_mode, out["effective_spp"])
    else:
        out = render(scene, spp=spp, seed=args.seed,
                     tile_rays=args.tile_rays,
                     checkpoint=args.checkpoint, resume=args.resume,
                     use_bvh=use_bvh,
                     want_var=args.denoiser != "none")

    color = out["color"]
    if args.denoiser != "none":
        from .models.denoise import denoise
        unet = None
        if args.denoiser == "cnn" and args.unet_weights:
            from .models.denoise import UNetDenoiser
            unet = UNetDenoiser.load(args.unet_weights)
        t = time.time()
        color = denoise(color, out["normal"], out["albedo"],
                        method=args.denoiser, unet=unet,
                        varmean=out.get("varmean"))
        log.info("denoise (%s) in %.2fs", args.denoiser, time.time() - t)

    from .utils.film import save_png, to_aov8, to_aov_normal8, to_rgb8
    filename = args.output or scene.film.filename
    written = save_png(filename, to_rgb8(color))
    log.info("wrote %s (%.1f Mrays in %.1fs, %.1f Mrays/s)", written,
             out["total_rays"] / 1e6, out["wall_time"],
             out["total_rays"] / max(out["wall_time"], 1e-9) / 1e6)

    if args.aov_normal:
        save_png(args.aov_normal, to_aov_normal8(out["normal"]))
    if args.aov_albedo:
        save_png(args.aov_albedo, to_aov8(out["albedo"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
