"""Benchmark: Mrays/s of the XLA path tracer on the Cornell box.

Renders `scenes/cornell-box.pbrt` at RES x RES (default 1024, the scene's
own film) for SAMPLES samples per pixel in one device call after a warm-up
call that compiles, and prints ONE JSON line:
{"metric", "value", "unit", "device": {"platform", "kind", "count"}}.

Env overrides: RENE_BENCH_RES, RENE_BENCH_SAMPLES (timed samples, default
32), RENE_BENCH_SCENE (pbrt path), RENE_BENCH_PLATFORM (a jax platform list,
e.g. "cpu"; the device is named in the output either way).
"""
import json
import os
import time


def main():
    platform = os.environ.get("RENE_BENCH_PLATFORM")
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp
    import numpy as np

    from rene_tpu.ops.accel import make_accel
    from rene_tpu.render import _batch_fn
    from rene_tpu.scene import load_scene
    from rene_tpu.scene.device import build_device_scene, to_jax
    from rene_tpu.scene.synth import CORNELL_BOX
    from rene_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    res = int(os.environ.get("RENE_BENCH_RES", "1024"))
    timed_samples = int(os.environ.get("RENE_BENCH_SAMPLES", "32"))
    scene_path = os.environ.get("RENE_BENCH_SCENE", CORNELL_BOX)

    scene = load_scene(scene_path)
    scene.set_film_resolution(res, res)
    buffers_np, config = build_device_scene(scene)
    buffers = to_jax(buffers_np)
    run, _ = _batch_fn(config, accel=make_accel(buffers_np, config))
    ys, xs = np.mgrid[0:res, 0:res]
    px = jnp.asarray(xs.reshape(-1).astype(np.int32))
    py = jnp.asarray(ys.reshape(-1).astype(np.int32))
    jax.block_until_ready(run(buffers, px, py, jnp.uint32(0), timed_samples))
    t0 = time.perf_counter()
    out = jax.block_until_ready(
        run(buffers, px, py, jnp.uint32(1), timed_samples))
    dt = time.perf_counter() - t0

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"Mrays/s {os.path.basename(scene_path)} @{res}x{res}",
        "value": float(out["rays"]) / dt / 1e6,
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
