"""Quality validation: render the sample scenes and report SSIM vs the
shipped Tungsten goldens (sample_scenes/*/TungstenRender.png).

Usage:
  python scripts/validate.py [--spp N] [--scale S] [--scenes a,b,...]
          [--platform cpu|cuda] [--denoiser atrous|cnn]
          [--tungsten-compat] [--seed N]

With --denoiser, BOTH raw and denoised SSIM are reported from the one
render. --tungsten-compat applies the shipped per-scene calibration
(docs/overrides/<scene>_tungsten*.json) exactly like the CLI flag.

SSIM is computed on gamma-encoded 8-bit images (what the goldens are).
`--scale` renders at reduced resolution and downsamples the golden — useful
for quick CPU checks; full-size numbers use scale 1 on the GPU. The goldens
ship with the reference's sample scenes, which this repository does not
carry: point --root at a copy of them.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SCENES = {
    "cornell-box": "cornell-box/scene.pbrt",
    "veach-mis": "veach-mis/scene.pbrt",
    "dragon": "dragon/scene.pbrt",
    "teapot": "teapot/scene.pbrt",
}


def box_downsample(img, s):
    import numpy as np
    h, w = img.shape[:2]
    h2, w2 = h // s * s, w // s * s
    img = img[:h2, :w2]
    return img.reshape(h2 // s, s, w2 // s, s, -1).mean(axis=(1, 3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--platform", default=None)
    ap.add_argument("--denoiser", default="none")
    ap.add_argument("--save-dir", default="/tmp/rene_validate")
    ap.add_argument("--root", required=True,
                    help="the reference's sample_scenes directory")
    ap.add_argument("--color-space", default="srgb-lights",
                    choices=["linear", "srgb", "srgb-lights"],
                    help="rgb interpretation; the quality table uses "
                         "srgb-lights (README), and an A/B on cornell "
                         "confirms it (cnn 0.787 vs 0.740 linear vs "
                         "0.521 srgb-full @256^2 32spp)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tungsten-compat", action="store_true",
                    help="apply the shipped per-scene Tungsten "
                         "calibration (docs/overrides/) like the CLI "
                         "flag of the same name")
    ap.add_argument("--diff-map", action="store_true",
                    help="save a |render-golden| heatmap and print the "
                         "8x8-grid per-region mean|diff| hotspots (the "
                         "methodology that proved dragon's asset "
                         "ceiling)")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    import numpy as np
    from PIL import Image as PILImage

    from rene_tpu.render import render
    from rene_tpu.scene import load_scene
    from rene_tpu.utils.film import save_png, to_rgb8
    from rene_tpu.utils.ssim import ssim

    os.makedirs(args.save_dir, exist_ok=True)
    results = {}
    for name in args.scenes.split(","):
        path = os.path.join(args.root, SCENES[name])
        golden_path = os.path.join(os.path.dirname(path),
                                   "TungstenRender.png")
        scene = load_scene(path, color_space=args.color_space)
        if args.tungsten_compat:
            from rene_tpu.scene.overrides import (apply_overrides,
                                                  find_tungsten_overrides)
            ov = find_tungsten_overrides(path)
            if ov:
                apply_overrides(scene, ov)
                print(f"{name}: applied {ov}", flush=True)
        if args.scale > 1:
            scene.film.xresolution //= args.scale
            scene.film.yresolution //= args.scale
            # recompute camera for the new aspect (same here) — reload kept
        t0 = time.time()
        out = render(scene, spp=args.spp, seed=args.seed)
        dt = time.time() - t0

        golden = np.asarray(PILImage.open(golden_path).convert("RGB"),
                            dtype=np.float32) / 255.0
        if args.scale > 1:
            golden = box_downsample(golden, args.scale)

        ours8 = to_rgb8(out["color"])
        save_png(os.path.join(args.save_dir, f"{name}.png"), ours8)
        s_raw = ssim(ours8.astype(np.float32) / 255.0, golden)
        results[name] = s_raw
        s_dn = None
        if args.denoiser != "none":
            from rene_tpu.models.denoise import denoise
            color = denoise(out["color"], out["normal"], out["albedo"],
                            method=args.denoiser)
            dn8 = to_rgb8(color)
            save_png(os.path.join(args.save_dir,
                                  f"{name}_{args.denoiser}.png"), dn8)
            s_dn = ssim(dn8.astype(np.float32) / 255.0, golden)
            results[f"{name}_{args.denoiser}"] = s_dn
        mrays = out["total_rays"] / dt / 1e6
        dn_txt = "" if s_dn is None else f"  {args.denoiser}={s_dn:.4f}"
        print(f"{name:12s} SSIM={s_raw:.4f}{dn_txt}  spp={args.spp} "
              f"({dt:.1f}s, {mrays:.1f} Mrays/s)", flush=True)
        if args.diff_map:
            diff = np.abs(ours8.astype(np.float32) / 255.0 - golden)
            save_png(os.path.join(args.save_dir, f"{name}_diff.png"),
                     np.clip(diff * 4.0 * 255.0, 0, 255)
                     .astype(np.uint8))
            h, w = diff.shape[:2]
            gh, gw = max(1, h // 8), max(1, w // 8)
            cells = diff[:gh * 8, :gw * 8].mean(axis=2) \
                .reshape(8, gh, 8, gw).mean(axis=(1, 3))
            order = np.dstack(np.unravel_index(
                np.argsort(cells, axis=None)[::-1], cells.shape))[0]
            hot = ", ".join(f"r{r}c{c}={cells[r, c]:.3f}"
                            for r, c in order[:5])
            print(f"{name:12s} mean|diff|={diff.mean():.4f}  "
                  f"hot cells: {hot}", flush=True)
    print({k: round(v, 4) for k, v in results.items()})


if __name__ == "__main__":
    main()
