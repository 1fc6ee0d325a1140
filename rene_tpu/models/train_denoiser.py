"""U-Net denoiser training, replacing the reference's pre-trained
OIDN/OptiX denoisers (rene/src/main.rs:1812-1911) with one trained on this
renderer's own output and running on the same device as the renderer.

Data: (noisy low-spp, clean high-spp) render pairs — multiple scenes,
noise levels, and seeds — cropped into patches; the noise the net learns
is exactly this integrator's Monte-Carlo noise. The net predicts a
residual over the à-trous output (its 4th input), so untrained it ties
the à-trous filter and training only moves it up from there. A synthetic
generator (piecewise-constant images + luminance-scaled noise) is
provided for quick runs and tests.

Usage:
    python -m rene_tpu.models.train_denoiser --scene a.pbrt --scene b.pbrt \
        --out rene_tpu/models/weights/unet.msgpack --steps 800
"""
from __future__ import annotations

import argparse
import time

import numpy as np

PATCH = 64


def synthetic_pairs(n: int, seed: int = 0, size: int = PATCH):
    """Procedural (noisy, normal, albedo, clean) batches: random soft-edged
    constant regions as 'clean', Monte-Carlo-like noise scaled by
    luminance."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    clean = np.zeros((n, size, size, 3), np.float32)
    normal = np.zeros_like(clean)
    albedo = np.zeros_like(clean)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        nrm = np.zeros((size, size, 3), np.float32)
        alb = np.zeros((size, size, 3), np.float32)
        for _ in range(4):
            cx, cy, rad = r.uniform(0, 1, 3)
            mask = ((xx - cx) ** 2 + (yy - cy) ** 2
                    < (0.15 + 0.3 * rad) ** 2)
            col = r.uniform(0, 1.5, 3).astype(np.float32)
            nv = r.normal(size=3).astype(np.float32)
            nv /= max(np.linalg.norm(nv), 1e-6)
            img[mask] = col
            nrm[mask] = nv
            alb[mask] = col / max(col.max(), 1e-6)
        clean[i], normal[i], albedo[i] = img, nrm, alb
    lum = clean.mean(-1, keepdims=True)
    noisy = np.maximum(
        clean + r.normal(size=clean.shape).astype(np.float32)
        * (0.08 + 0.25 * np.sqrt(np.maximum(lum, 0.0))), 0.0
    ).astype(np.float32)
    # sparse fireflies (low-spp MC outliers): the net must learn to
    # suppress them like the a-trous edge-stopping does
    spark = r.random(noisy.shape[:3]) < 0.002
    noisy[spark] += r.gamma(1.5, 4.0, size=(spark.sum(), 1)).astype(
        np.float32) * r.uniform(0.5, 1.0, (spark.sum(), 3)).astype(
        np.float32)
    from .denoise import atrous_denoise
    base = np.stack([atrous_denoise(noisy[i], normal[i], albedo[i])
                     for i in range(n)]).astype(np.float32)
    return noisy, normal, albedo, clean, base


def render_pairs(scene_path: str, noisy_spps=(4, 32), clean_spp: int = 512,
                 res: int = 256, color_space: str = "srgb-lights",
                 augment: bool = True):
    """Render a scene at several noise levels against one clean render and
    cut the films into PATCH crops (with flip augmentation). The à-trous
    base is computed on the full film before cropping."""
    from ..render import render
    from ..scene import load_scene
    from .denoise import atrous_denoise

    scene = load_scene(scene_path, color_space=color_space)
    scene.set_film_resolution(res, res)  # aspect-safe reprojection
    clean = render(scene, spp=clean_spp, seed=202)

    crops = []
    for k, spp in enumerate(noisy_spps):
        noisy = render(scene, spp=spp, seed=101 + 37 * k)
        base = atrous_denoise(noisy["color"], noisy["normal"],
                              noisy["albedo"])
        films = (noisy["color"], noisy["normal"], noisy["albedo"],
                 clean["color"], base)
        for y in range(0, res - PATCH + 1, PATCH // 2):
            for x in range(0, res - PATCH + 1, PATCH // 2):
                sl = (slice(y, y + PATCH), slice(x, x + PATCH))
                crop = [f[sl] for f in films]
                crops.append(crop)
                if augment:
                    crops.append([c[::-1] for c in crop])
                    crops.append([c[:, ::-1] for c in crop])
    return tuple(np.stack([c[i] for c in crops]).astype(np.float32)
                 for i in range(5))


def train(data, steps: int = 400, batch: int = 8, lr: float = 1e-3,
          features: int = 16, seed: int = 0, log_every: int = 50,
          progress=print):
    """Train a UNetDenoiser on (noisy, normal, albedo, clean, base)
    arrays; returns the trained denoiser and the loss history."""
    import jax
    import jax.numpy as jnp
    import optax

    from .denoise import UNetDenoiser

    # data arrays are jit ARGUMENTS (device buffers), not closure
    # constants — baking 100s of MB of patches into the program blows the
    # remote-compile request limit
    noisy, normal, albedo, clean, base = (jnp.asarray(a) for a in data)
    net = UNetDenoiser(features=features)
    params = net.init(jax.random.PRNGKey(seed), PATCH, PATCH)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)

    def tonemap(x):
        # display-space loss: SSIM is scored on gamma-encoded 8-bit
        # images, so train where the metric looks. The epsilon keeps the
        # gamma gradient finite at 0 (bare x**(1/2.2) NaNs training).
        return (jnp.maximum(x, 0.0) + 1e-3) ** (1.0 / 2.2)

    @jax.jit
    def step(params, opt_state, idx, noisy, base, normal, albedo, clean):
        x = jnp.concatenate([noisy[idx], base[idx], normal[idx],
                             albedo[idx]], axis=-1)

        def loss_fn(p):
            pred = base[idx] + net.module.apply({"params": p}, x)
            return jnp.mean(jnp.abs(tonemap(pred) - tonemap(clean[idx])))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    r = np.random.default_rng(seed)
    n = int(noisy.shape[0])
    losses = []
    t0 = time.time()
    for s in range(steps):
        idx = jnp.asarray(r.integers(0, n, size=batch))
        params, opt_state, loss = step(params, opt_state, idx, noisy,
                                       base, normal, albedo, clean)
        losses.append(float(loss))
        if log_every and (s + 1) % log_every == 0:
            progress(f"step {s + 1}/{steps} loss={losses[-1]:.4f} "
                     f"({time.time() - t0:.1f}s)")
    net.params = params
    return net, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", action="append", default=[],
                    help="pbrt scene(s) for render pairs (repeatable; "
                    "omit for synthetic data)")
    ap.add_argument("--out", required=True, help="weights output path")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--noisy-spp", type=int, action="append", default=[],
                    help="noise levels to render per scene (repeatable; "
                    "default 4 and 32)")
    ap.add_argument("--clean-spp", type=int, default=512)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="also mix in N synthetic patches")
    args = ap.parse_args(argv)

    spps = tuple(args.noisy_spp) or (4, 32)
    parts = []
    for sc in args.scene:
        parts.append(render_pairs(sc, spps, args.clean_spp))
        print(f"{sc}: {parts[-1][0].shape[0]} patches", flush=True)
    if args.synthetic or not args.scene:
        parts.append(synthetic_pairs(args.synthetic or 64))
    data = tuple(np.concatenate([p[i] for p in parts]) for i in range(5))
    print(f"training on {data[0].shape[0]} patches")
    net, losses = train(data, steps=args.steps, batch=args.batch,
                        features=args.features, lr=args.lr)
    net.save(args.out)
    print(f"saved {args.out}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
