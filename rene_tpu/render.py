"""Top-level render driver: sample batching, tiling, timing, checkpointing.

Replaces the reference's render loop (rene/src/main.rs:1301-1402): N_SAMPLES
batches of full-frame traces with per-batch timing logs. Here the sample
loop is a host loop over one jit-compiled wavefront kernel (the XLA
integrators in integrators/path.py and volpath.py); large films are split
into ray tiles to bound device memory; the accumulated film is a host array
and can be checkpointed/resumed per batch (the reference's VRAM-only film
loses all samples on a crash, SURVEY.md §5).
"""
from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Optional

import numpy as np

from .scene.device import RenderConfig, build_device_scene
from .scene.flatten import FlatScene
from .utils.film import rays_to_image

log = logging.getLogger("rene_tpu.render")

DEFAULT_SPP = 5000  # reference N_SAMPLES, main.rs:80
LOG_EVERY = 100     # reference N_SAMPLES_ITER, main.rs:81


def _sample_fn(config: RenderConfig, accel=None):
    import jax

    if config.integrator == "volpath":
        from .integrators.volpath import render_sample
    else:
        from .integrators.path import render_sample

    @functools.partial(jax.jit, static_argnums=())
    def run(buffers, px, py, seed):
        return render_sample(buffers, config, px, py, seed, accel=accel)

    return run


def _batch_fn(config: RenderConfig, accel=None):
    """Jitted multi-sample kernel with path regeneration; returns it with
    the most samples one call traces."""
    import jax

    if config.integrator == "volpath":
        from .integrators.volpath import render_batch
    else:
        from .integrators.path import render_batch

    @functools.partial(jax.jit, static_argnums=(4,))
    def run(buffers, px, py, seed, num_samples):
        return render_batch(buffers, config, px, py, seed, num_samples,
                            accel=accel)

    return run, LOG_EVERY


def warm_cache(scene: FlatScene) -> int:
    """Pre-compile the scene's render kernel WITHOUT executing it,
    populating the persistent JAX compilation cache so a later render
    process skips the compile. Returns the number of kernels compiled."""
    import jax.numpy as jnp

    from .ops.accel import make_accel
    from .scene.device import to_jax

    buffers_np, config = build_device_scene(scene)
    accel = make_accel(buffers_np, config)
    run, max_chunk = _batch_fn(config, accel=accel)
    buffers = to_jax(buffers_np)
    npix = config.film.xresolution * config.film.yresolution
    t = min(1 << 18, npix)
    px = jnp.zeros((t,), jnp.int32)
    py = jnp.zeros((t,), jnp.int32)
    log.info("compiling XLA wavefront kernel (%d rays)...", t)
    run.lower(buffers, px, py, jnp.uint32(0), max_chunk).compile()
    return 1


def render(scene: FlatScene, spp: int = DEFAULT_SPP,
           seed: int = 0, tile_rays: int = 1 << 18,
           checkpoint: Optional[str] = None,
           resume: bool = False,
           progress: Optional[Callable[[int, int, float], None]] = None,
           use_bvh: Optional[bool] = None,
           want_var: bool = False):
    """Render a scene; returns dict of (H,W,3) float32 arrays:
    color (averaged), normal, albedo. want_var additionally returns
    "varmean" — the per-pixel variance of the color MEAN estimated from
    the spread of per-chunk means (no extra device work; used by the
    denoiser's convergence-aware blend so denoising can never degrade a
    converged render).

    Runs on JAX's default device; wrap the call in
    `jax.default_device(d)` to render on another one.
    """
    import jax.numpy as jnp

    from .scene.device import to_jax

    buffers_np, config = build_device_scene(scene)
    buffers = to_jax(buffers_np)

    fingerprint = ""
    if checkpoint:
        from .utils.checkpoint import scene_fingerprint
        fingerprint = scene_fingerprint(buffers_np, config, seed)

    from .ops.accel import make_accel
    force = {None: None, True: "bvh", False: None}[use_bvh]
    accel = make_accel(buffers_np, config, force=force)

    w = config.film.xresolution
    h = config.film.yresolution
    n = w * h
    ys, xs = np.mgrid[0:h, 0:w]
    px_all = jnp.asarray(xs.reshape(-1).astype(np.int32))
    py_all = jnp.asarray(ys.reshape(-1).astype(np.int32))

    run, max_chunk = _batch_fn(config, accel=accel)
    if want_var:  # >=2 chunks so the chunk-mean spread is measurable
        max_chunk = max(1, min(max_chunk, spp // 2))

    accum = {
        "radiance": np.zeros((n, 3), np.float32),
        "normal": np.zeros((n, 3), np.float32),
        "albedo": np.zeros((n, 3), np.float32),
    }
    start_sample = 0
    if checkpoint and resume:
        from .utils.checkpoint import load_checkpoint
        loaded = load_checkpoint(checkpoint, fingerprint)
        if loaded is not None:
            accum, start_sample = loaded
            log.info("resumed from %s at sample %d", checkpoint, start_sample)

    host_rng = np.random.default_rng(seed)
    # consume the seeds of completed chunks when resuming
    consumed = 0
    while consumed < start_sample:
        host_rng.integers(0, 2 ** 32, dtype=np.uint32)
        consumed += min(max_chunk, start_sample - consumed)

    tiles = [(s, min(s + tile_rays, n)) for s in range(0, n, tile_rays)]
    sq_sum = np.zeros((n, 3), np.float32) if want_var else None
    n_chunks = 0
    total_rays = 0.0
    t_batch = time.time()
    t_start = time.time()
    done = start_sample
    while done < spp:
        chunk = min(max_chunk, spp - done)
        chunk_seed = np.uint32(host_rng.integers(0, 2 ** 32,
                                                 dtype=np.uint32))
        for lo, hi in tiles:
            out = run(buffers, px_all[lo:hi], py_all[lo:hi],
                      jnp.uint32(chunk_seed), chunk)
            for k in accum:
                accum[k][lo:hi] += np.asarray(out[k])
            if sq_sum is not None:
                xm = np.asarray(out["radiance"]) / chunk
                sq_sum[lo:hi] += chunk * xm * xm
            total_rays += float(out["rays"])
        done += chunk
        n_chunks += 1
        dt = (time.time() - t_batch) * 1000.0
        log.info("Samples: %d/%d (%.0f ms)", done, spp, dt)
        t_batch = time.time()
        if progress:
            progress(done, spp, dt)
        if checkpoint:
            from .utils.checkpoint import save_checkpoint
            save_checkpoint(checkpoint, accum, done, fingerprint)

    color = accum["radiance"] / max(spp, 1)
    normal = accum["normal"] / max(spp, 1)
    albedo = accum["albedo"] / max(spp, 1)
    result = {
        "color": rays_to_image(color, w, h),
        "normal": rays_to_image(normal, w, h),
        "albedo": rays_to_image(albedo, w, h),
        "config": config,
        "total_rays": total_rays,
        "wall_time": time.time() - t_start,
    }
    if sq_sum is not None:
        result["varmean"] = rays_to_image(
            _var_of_mean(accum["radiance"], sq_sum, spp, n_chunks), w, h)
    return result


def _var_of_mean(sum_x, sq_sum, n_total, n_chunks):
    """Per-pixel variance of the color mean from per-chunk means.

    sum_x = sum of per-sample radiance, sq_sum = sum over chunks of
    n_i * mean_i^2. Unequal-chunk weighted spread, divided once more by
    n_total: Var[mean] ~= (sq_sum - n*mean^2) / ((k-1) * n). One chunk
    -> no estimate (returns +inf so the blend keeps the denoiser)."""
    n_total = max(n_total, 1)
    mean = sum_x / n_total
    if n_chunks < 2:
        return np.full_like(sum_x, np.inf)
    spread = np.maximum(sq_sum - n_total * mean * mean, 0.0)
    return spread / ((n_chunks - 1) * n_total)
