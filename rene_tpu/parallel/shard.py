"""Multi-device scale-out over a 1-D device mesh.

The reference is strictly single-GPU (SURVEY.md §2.6); its only parallelism
axes are pixels (one thread each) and sequential samples. Path tracing has no
inter-ray communication, so the scale-out is data parallelism: over
*samples* (every device renders the full frame with decorrelated RNG streams
and the films are mean-reduced with `psum`) or over *pixels* (film tiles).
Scene buffers are replicated (they are read-only); the film reduction is the
only collective.

`render_sample_sharded` is the multi-device render step: one call = one
sample per device (N_devices effective spp), jitted once under `shard_map`.
"""
from __future__ import annotations

from typing import Optional, Sequence


def make_mesh(devices: Optional[Sequence] = None, axis: str = "spp"):
    import jax
    from jax.sharding import Mesh
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def render_sample_sharded(mesh, config, accel=None, axis: str = "spp"):
    """Build the jitted multi-device sample function.

    Returns fn(buffers, px, py, seed) -> dict of per-ray outputs where
    `radiance` is the mean over the mesh's devices (each device traces its
    own decorrelated sample) — psum across devices, replicated result.
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if config.integrator == "volpath":
        from ..integrators.volpath import render_sample
    else:
        from ..integrators.path import render_sample

    ndev = mesh.devices.size

    def per_device(buffers, px, py, seed):
        idx = jax.lax.axis_index(axis).astype(jnp.uint32)
        # decorrelate each device's sample stream
        dev_seed = seed ^ (idx * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
        out = render_sample(buffers, config, px, py, dev_seed, accel=accel)
        out["radiance"] = jax.lax.psum(out["radiance"], axis) / ndev
        out["normal"] = jax.lax.psum(out["normal"], axis) / ndev
        out["albedo"] = jax.lax.psum(out["albedo"], axis) / ndev
        out["rays"] = jax.lax.psum(out["rays"], axis)
        return out

    rep = P()  # replicated: every device traces the full frame
    # check_vma=False: the integrator's while-loop carry is initialized
    # unvarying but becomes device-varying through the per-device seed.
    fn = shard_map(per_device, mesh=mesh,
                   in_specs=(rep, rep, rep, rep),
                   out_specs=rep, check_vma=False)
    return jax.jit(fn)


def render_tiles_sharded(mesh, config, accel=None, axis: str = "spp"):
    """Build the jitted pixel-sharded step (film-tile parallelism).

    The ray batch is split across the mesh's devices — each one traces
    its own pixel shard of the SAME sample — and the sharded films are
    reassembled by the sharding layer. Sample-DP (`render_sample_sharded`)
    scales samples/second; this scales single-sample latency, the better
    axis when frames are large and spp targets small. The ray-batch
    length must divide the device count (the driver pads)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if config.integrator == "volpath":
        from ..integrators.volpath import render_sample
    else:
        from ..integrators.path import render_sample

    def per_device(buffers, px, py, seed):
        out = render_sample(buffers, config, px, py, seed, accel=accel)
        out["rays"] = jax.lax.psum(out["rays"], axis)
        return out

    sh = P(axis)
    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), sh, sh, P()),
        out_specs={"radiance": sh, "normal": sh, "albedo": sh,
                   "rays": P()},
        check_vma=False)
    return jax.jit(fn)


def render_multichip(scene, spp: int, seed: int = 0, mesh=None,
                     tile_rays: int = 1 << 18, mode: str = "samples"):
    """Full multi-device render loop: like rene_tpu.render.render but
    parallelized over the mesh. mode="samples": each device traces the
    whole frame at its own sample (spp throughput scales). mode="tiles":
    each device traces a pixel shard of the same sample (per-sample
    latency scales; the image equals that of the same call on a
    one-device mesh)."""
    import jax.numpy as jnp
    import numpy as np

    from ..scene.device import build_device_scene, to_jax
    from ..utils.film import rays_to_image

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.devices.size

    buffers_np, config = build_device_scene(scene)

    buffers = to_jax(buffers_np)
    from ..ops.accel import make_accel
    accel = make_accel(buffers_np, config)

    if mode == "tiles":
        run = render_tiles_sharded(mesh, config, accel=accel)
    elif mode == "samples":
        run = render_sample_sharded(mesh, config, accel=accel)
    else:
        raise ValueError(f"unknown multichip mode {mode!r} "
                         "(expected 'samples' or 'tiles')")

    w = config.film.xresolution
    h = config.film.yresolution
    n = w * h
    ys, xs = np.mgrid[0:h, 0:w]
    px_all = xs.reshape(-1).astype(np.int32)
    py_all = ys.reshape(-1).astype(np.int32)
    # tile mode: every device call's batch must divide the mesh; pad with
    # clamped repeats of the last pixel (their results are dropped)
    tile_rays = (tile_rays + ndev - 1) // ndev * ndev

    steps = (max(1, (spp + ndev - 1) // ndev) if mode == "samples"
             else max(1, spp))
    host_rng = np.random.default_rng(seed)
    accum = {k: np.zeros((n, 3), np.float32)
             for k in ("radiance", "normal", "albedo")}
    total_rays = 0.0
    for _ in range(steps):
        s = np.uint32(host_rng.integers(0, 2 ** 32, dtype=np.uint32))
        for lo in range(0, n, tile_rays):
            hi = min(lo + tile_rays, n)
            px = px_all[lo:hi]
            py = py_all[lo:hi]
            pad = (-len(px)) % ndev
            if pad and mode == "tiles":
                px = np.concatenate([px, np.repeat(px[-1:], pad)])
                py = np.concatenate([py, np.repeat(py[-1:], pad)])
            out = run(buffers, jnp.asarray(px), jnp.asarray(py),
                      jnp.uint32(s))
            for k in accum:
                accum[k][lo:hi] += np.asarray(out[k])[:hi - lo]
            # don't count the padded duplicate lanes' rays in the stats
            total_rays += float(out["rays"]) * (hi - lo) / len(px)
    return {
        "color": rays_to_image(accum["radiance"] / steps, w, h),
        "normal": rays_to_image(accum["normal"] / steps, w, h),
        "albedo": rays_to_image(accum["albedo"] / steps, w, h),
        "total_rays": total_rays,
        "effective_spp": steps * (ndev if mode == "samples" else 1),
        "config": config,
    }
