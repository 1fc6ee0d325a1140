#!/usr/bin/env python3
"""Smoke test of the renderer on the GPU: the main path once, at full size.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the multi-device phase only

Phases (one JSON line each, then the card as nvidia-smi reports it, then
the result line `{"ok": true, "device": {...}}`):

* env        JAX and the device, the compile-cache directory, and whether
             the BVH is built by the native (C++) library or by numpy.
* intersect  the brute-force matmul intersector (36 and 4096 triangles)
             and the BVH (4096 and the >=100k-triangle mesh), 2^18 probe
             rays each, against float64 Möller–Trumbore (utils/verify.py).
* render_vs_cpu  Cornell box and fog at 128x128, 8 spp, rendered on the
             GPU and on the CPU backend of the same process, same seed.
* cornell / mesh  the render kernel at the scene's full film (1024x1024,
             1280x720): set-up, compile cold and from the persistent
             cache, steady-state Mrays/s and s/spp, peak device memory.
* cli_cornell / cli_mesh  `rene_tpu.cli.main` in-process, as a user runs
             it (the Cornell render with --denoiser atrous).
* denoise    à-trous on the 1024x1024 Cornell film and the U-Net's 3x3
             convolution, GPU against CPU.
* fog        `render()` on scripts/train_scenes/fog_sphere.pbrt (volpath).
* four       (--four) render_multichip on four GPUs, tiles and samples
             mode, against the same render on one GPU.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails: every check raises.
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "smoke_out")
FOG_SCENE = os.path.join(REPO, "scripts", "train_scenes", "fog_sphere.pbrt")

# --- tolerances, each with its reason ---------------------------------------
# Interior and grazing probe rays: every float32 intersector must pick the
# float64 triangle (ties allowed, verify.hit_agreement), and its hit point
# must lie within 1e-5 scene diagonals of the float64 one, measured along
# the triangle's normal (|t - t_ref| |cos|; the relative t error itself
# grows as 1/|cos| and reaches 7e-3 for the most grazing of 2^18 rays even
# on the CPU). Float32 measures <= 3e-7 on the CPU at these widths; a TF32
# dot (10-bit mantissa) would be ~1e-4. A target within rounding of the
# open boundary of a mesh patch may miss in either precision: <= 1e-3.
AGREE_MIN = 0.999
PLANE_ERR_MAX = 1e-5
# Rays aimed within rounding of a shared edge may legitimately pass on
# either side. The Plücker test is watertight along shared edges (the
# neighbours' side values are exact negations), so only silhouette edges
# split; the BVH's Möller–Trumbore leaf test is not watertight and lets a
# share of them through the crack (8.5% on the 4096-triangle mesh on the
# CPU in float32).
EDGE_AGREE_MIN = {"matmul": 0.95, "bvh": 0.85}
# Same scene, seed and pixel keys on two backends: the paths are the same
# unless a float difference flips a branch (a hit, a roulette draw), after
# which that pixel follows an independent path. Two renders with different
# seeds differ by rel_mse ~0.07 (Cornell, 8 spp), so 1e-3 allows ~1.4% of
# the pixels to diverge; the image means agree to 1e-3.
RENDER_REL_MSE_MAX = 1e-3
RENDER_REL_MEAN_MAX = 1e-3
# Samples mode on N devices vs one device: independent estimates of the
# same image, so the mean difference is within MC error: |z| of the
# per-channel mean difference over its standard error (pixels are
# independent).
SAMPLES_Z_MAX = 4.5
# à-trous / conv on GPU vs CPU: same float32 arithmetic, different summation
# order and exp/division implementations: relative max error 1e-4.
DENOISE_REL_MAX = 1e-4


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def require_gpu():
    """GPU devices of this process; raises when JAX finds none. The CPU
    backend stays available for the reference phases."""
    import jax
    jax.config.update("jax_platforms", "cuda,cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devices[0].platform} "
                           "devices only")
    return devices


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed(fn, *args):
    """(result, seconds) of fn(*args), synchronised on the result."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# --- intersectors ----------------------------------------------------------

def intersect_case(name, tri_p, accel, n_rays, n_ref, seed=0):
    """Run `accel` (an MXUIntersector or a BVH) on `n_rays` probe rays and
    compare the first `n_ref` of them (interior, edge and grazing kinds in
    proportion) with the float64 reference. Returns the report dict; raises
    when a tolerance is broken."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rene_tpu.ops.bvh import BVH
    from rene_tpu.utils import verify

    kind_name = "bvh" if isinstance(accel, BVH) else "matmul"
    org, d, kinds = verify.probe_rays(tri_p, n_rays, seed=seed)
    tmin = jnp.full((n_rays,), 1e-3, jnp.float32)
    tmax = jnp.full((n_rays,), 1e5, jnp.float32)
    fn = jax.jit(lambda o, dd, a, b: accel.intersect(o, dd, a, b))
    args = (jnp.asarray(org), jnp.asarray(d), tmin, tmax)
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    (t, ids), t_run = timed(fn, *args)
    t = np.asarray(t)
    ids = np.asarray(ids)

    pick = np.random.default_rng(seed + 1).permutation(n_rays)[:n_ref]
    pick.sort()
    t0 = time.perf_counter()
    ref_t, ref_id = verify.closest_hit_f64(org[pick], d[pick], tri_p)
    t_ref = time.perf_counter() - t0
    report = {"case": name, "intersector": kind_name,
              "triangles": int(len(tri_p)), "rays": n_rays,
              "rays_vs_f64": int(n_ref), "precision": "float32, "
              "lax.Precision.HIGHEST dots" if kind_name == "matmul"
              else "float32 elementwise",
              "compile_s": t_compile, "run_s": t_run,
              "mrays_per_s": n_rays / t_run / 1e6, "f64_ref_s": t_ref}
    for k, label in enumerate(("interior", "edge", "grazing")):
        m = kinds[pick] == k
        report[label] = verify.hit_agreement(
            t[pick][m], ids[pick][m], ref_t[m], ref_id[m], org[pick][m],
            d[pick][m], tri_p)
    report["tolerance"] = {"agree_min": AGREE_MIN,
                           "plane_err_max": PLANE_ERR_MAX,
                           "edge_agree_min": EDGE_AGREE_MIN[kind_name]}
    for label in ("interior", "grazing"):
        r = report[label]
        check(r["agree"] >= AGREE_MIN
              and r["max_plane_err"] <= PLANE_ERR_MAX,
              f"{name}/{kind_name} {label}: {r}")
    check(report["edge"]["agree"] >= EDGE_AGREE_MIN[kind_name],
          f"{name}/{kind_name} edge: {report['edge']}")
    return report


def mesh_triangles(nlevels):
    from rene_tpu.scene.device import build_device_scene
    from rene_tpu.scene.synth import load_mesh_scene
    bn, _ = build_device_scene(load_mesh_scene(0, nlevels=nlevels))
    return bn["tri_p"]


def phase_intersect(n_rays=1 << 18):
    from rene_tpu.ops.bvh import build_bvh
    from rene_tpu.ops.mxu_intersect import MXUIntersector
    from rene_tpu.scene import build_device_scene, load_scene
    from rene_tpu.scene.synth import CORNELL_BOX

    cornell = build_device_scene(load_scene(CORNELL_BOX))[0]["tri_p"]
    w4096 = mesh_triangles(2)[2:2 + 4096]   # skip the floor quad
    big = mesh_triangles(4)
    t0 = time.perf_counter()
    big_bvh = build_bvh(big).to_device()
    t_build = time.perf_counter() - t0
    cases = [
        ("cornell", cornell, MXUIntersector(cornell).to_device(), n_rays),
        ("cornell", cornell, build_bvh(cornell).to_device(), n_rays),
        ("mesh4096", w4096, MXUIntersector(w4096).to_device(), 1 << 14),
        ("mesh4096", w4096, build_bvh(w4096).to_device(), 1 << 14),
        ("mesh135k", big, big_bvh, 1 << 10),
    ]
    for name, tri, accel, n_ref in cases:
        rep = intersect_case(name, tri, accel, n_rays, n_ref)
        if name == "mesh135k":
            rep["bvh_build_s"] = t_build
        emit("intersect", **rep)


# --- renders ---------------------------------------------------------------

def render_pair(scene_path, res, spp, seed, cpu):
    """The same render on the default device and on `cpu`."""
    import jax

    from rene_tpu.render import render
    from rene_tpu.scene import load_scene
    from rene_tpu.utils import verify

    scene = load_scene(scene_path)
    scene.set_film_resolution(res, res)
    t0 = time.perf_counter()
    dev = render(scene, spp=spp, seed=seed)
    t_dev = time.perf_counter() - t0
    with jax.default_device(cpu):
        t0 = time.perf_counter()
        ref = render(scene, spp=spp, seed=seed)
        t_cpu = time.perf_counter() - t0
    rep = verify.image_agreement(dev["color"], ref["color"])
    rep.update(scene=os.path.basename(scene_path), res=res, spp=spp,
               wall_s=t_dev, cpu_wall_s=t_cpu,
               tolerance={"rel_mse_max": RENDER_REL_MSE_MAX,
                          "rel_mean_max": RENDER_REL_MEAN_MAX})
    check(rep["rel_mse"] <= RENDER_REL_MSE_MAX
          and rep["rel_mean"] <= RENDER_REL_MEAN_MAX,
          f"render vs cpu {scene_path}: {rep}")
    return rep


def phase_render_vs_cpu(res=128, spp=8):
    import jax

    from rene_tpu.scene.synth import CORNELL_BOX

    cpu = jax.devices("cpu")[0]
    for path in (CORNELL_BOX, FOG_SCENE):
        emit("render_vs_cpu", **render_pair(path, res, spp, 3, cpu))


def kernel_phase(name, scene, spp, device):
    """Set-up, compile (first, then again from the persistent cache: the
    first is cold only when the cache came empty, see the env phase), and
    the steady-state rate of the render kernel on the whole frame of
    `scene` in one call. Returns (report, the kernel's per-ray sums)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rene_tpu.ops.accel import make_accel
    from rene_tpu.ops.bvh import BVH
    from rene_tpu.render import _batch_fn
    from rene_tpu.scene.device import build_device_scene, to_jax

    t0 = time.perf_counter()
    bn, config = build_device_scene(scene)
    accel = make_accel(bn, config)
    buffers = to_jax(bn)
    t_setup = time.perf_counter() - t0
    w, h = config.film.xresolution, config.film.yresolution
    ys, xs = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xs.reshape(-1).astype(np.int32))
    py = jnp.asarray(ys.reshape(-1).astype(np.int32))
    compile_s = []
    for _ in range(2):
        # the second compile, of a fresh jit, reads the persistent cache
        run, _ = _batch_fn(config, accel=accel)
        t0 = time.perf_counter()
        run.lower(buffers, px, py, jnp.uint32(0), spp).compile()
        compile_s.append(time.perf_counter() - t0)
    jax.block_until_ready(run(buffers, px, py, jnp.uint32(1), spp))
    out, dt = timed(run, buffers, px, py, jnp.uint32(2), spp)
    rays = float(out["rays"])
    rad = np.asarray(out["radiance"])
    check(np.isfinite(rad).all() and rad.mean() > 0,
          f"{name}: non-finite or black radiance")
    rep = {"res": [w, h], "spp": spp,
           "triangles": config.num_triangles,
           "accel": "bvh" if isinstance(accel.main, BVH) else "matmul",
           "setup_s": t_setup, "compile_first_s": compile_s[0],
           "compile_again_s": compile_s[1], "steady_s": dt,
           "s_per_spp": dt / spp, "mrays_per_s": rays / dt / 1e6,
           "peak_bytes_in_use": peak_bytes(device)}
    return rep, out


def cli_phase(name, argv, device):
    """rene_tpu.cli.main in-process; returns wall time and what it logs."""
    from rene_tpu import cli

    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("rene_tpu")
    grab = Grab(level=logging.INFO)
    level = logger.level
    logger.addHandler(grab)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(grab)
        logger.setLevel(level)
    check(rc == 0, f"{name}: cli exit code {rc}")
    out_png = argv[argv.index("--output") + 1]
    with open(out_png, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name}: bad PNG")
    rep = {"argv": argv[1:], "wall_s": wall,
           "peak_bytes_in_use": peak_bytes(device)}
    for r in records:
        msg = r.getMessage()
        if msg.startswith("wrote "):
            rep["log_wrote"] = msg
        elif msg.startswith("denoise"):
            rep["log_denoise"] = msg
        elif msg.startswith("Samples:"):
            rep.setdefault("log_chunks", []).append(msg)
    return rep


def phase_denoise(film, cpu, device):
    """à-trous on the film and the U-Net conv, GPU vs CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rene_tpu.models.denoise import _atrous_fn, conv3x3

    color, normal, albedo = (np.asarray(film[k]) for k in
                             ("color", "normal", "albedo"))
    run = _atrous_fn(5, 4.0, 128.0, 8.0)
    args = [jnp.asarray(a) for a in (color, normal, albedo)]
    t0 = time.perf_counter()
    run.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(run(*args))
    gpu, dt = timed(run, *args)
    with jax.default_device(cpu):
        ref = np.asarray(run(*[jnp.asarray(a) for a in
                               (color, normal, albedo)]))
    rel = float(np.abs(np.asarray(gpu) - ref).max()
                / max(np.abs(ref).max(), 1e-30))
    rep = {"atrous": {"res": list(color.shape[:2]), "compile_s": t_compile,
                      "steady_s": dt, "max_rel_err_vs_cpu": rel}}
    check(rel <= DENOISE_REL_MAX, f"atrous vs cpu: {rel}")

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1,) + color.shape[:2] + (12,)).astype(
        np.float32)
    k = (rng.standard_normal((3, 3, 12, 24)) * 0.1).astype(np.float32)
    conv = jax.jit(conv3x3)
    jax.block_until_ready(conv(x, k))
    y, dt = timed(conv, x, k)
    with jax.default_device(cpu):
        y_ref = np.asarray(conv3x3(jnp.asarray(x), jnp.asarray(k)))
    rel = float(np.abs(np.asarray(y) - y_ref).max()
                / max(np.abs(y_ref).max(), 1e-30))
    rep["unet_conv3x3"] = {"shape": list(x.shape), "out_channels": 24,
                           "precision": "lax.Precision.HIGHEST",
                           "steady_s": dt, "max_rel_err_vs_cpu": rel}
    check(rel <= DENOISE_REL_MAX, f"conv3x3 vs cpu: {rel}")
    rep["tolerance"] = {"max_rel_err": DENOISE_REL_MAX}
    rep["peak_bytes_in_use"] = peak_bytes(device)
    return rep


def run_one_gpu(devices):
    import jax
    import numpy as np

    from rene_tpu.render import render
    from rene_tpu.scene import load_scene
    from rene_tpu.scene.synth import (CORNELL_BOX, load_mesh_scene,
                                      mesh_scene_source)
    from rene_tpu.utils.film import rays_to_image

    dev = devices[0]
    cpu = jax.devices("cpu")[0]

    phase_intersect()
    phase_render_vs_cpu()

    spp = 16
    rep, out = kernel_phase("cornell", load_scene(CORNELL_BOX), spp, dev)
    emit("cornell", **rep)
    w, h = rep["res"]
    film = {k: rays_to_image(out[src], w, h) / spp for k, src in
            (("color", "radiance"), ("normal", "normal"),
             ("albedo", "albedo"))}
    emit("cli_cornell", **cli_phase("cli_cornell", [
        CORNELL_BOX, "--spp", str(spp), "--denoiser", "atrous",
        "--output", os.path.join(OUT_DIR, "cornell-box.png")], dev))
    emit("denoise", **phase_denoise(film, cpu, dev))

    rep, _ = kernel_phase("mesh", load_mesh_scene(0), 4, dev)
    emit("mesh", **rep)
    mesh_path = os.path.join(OUT_DIR, "mesh.pbrt")
    with open(mesh_path, "w") as f:
        f.write(mesh_scene_source(0))
    emit("cli_mesh", **cli_phase("cli_mesh", [
        mesh_path, "--spp", "4",
        "--output", os.path.join(OUT_DIR, "mesh.png")], dev))

    fog = load_scene(FOG_SCENE)
    t0 = time.perf_counter()
    out = render(fog, spp=16, seed=0)
    wall = time.perf_counter() - t0
    check(np.isfinite(out["color"]).all() and out["color"].mean() > 0,
          "fog: non-finite or black image")
    emit("fog", res=[fog.film.xresolution, fog.film.yresolution], spp=16,
         wall_s=wall, mrays_per_s=out["total_rays"] / wall / 1e6,
         peak_bytes_in_use=peak_bytes(dev))


def run_four_gpus(devices, spp=8):
    """render_multichip on four GPUs against the same render on one."""
    from rene_tpu.parallel.shard import make_mesh, render_multichip
    from rene_tpu.scene import load_scene
    from rene_tpu.scene.synth import CORNELL_BOX
    from rene_tpu.utils import verify

    check(len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}")
    scene = load_scene(CORNELL_BOX)
    four = make_mesh(devices[:4])
    one = make_mesh(devices[:1])
    for mode in ("tiles", "samples"):
        t0 = time.perf_counter()
        multi = render_multichip(scene, spp=spp, seed=5, mesh=four,
                                 mode=mode)
        t_multi = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = render_multichip(scene, spp=spp, seed=5 if mode == "tiles"
                                  else 6, mesh=one, mode=mode)
        t_single = time.perf_counter() - t0
        rep = {"mode": mode, "devices": 4, "spp": spp,
               "res": list(multi["color"].shape[:2]),
               "wall_s_4": t_multi, "wall_s_1": t_single,
               "mrays_per_s_4": multi["total_rays"] / t_multi / 1e6,
               "mrays_per_s_1": single["total_rays"] / t_single / 1e6}
        if mode == "tiles":
            rep.update(verify.image_agreement(multi["color"],
                                              single["color"]))
            rep["tolerance"] = {"rel_mse_max": RENDER_REL_MSE_MAX,
                                "rel_mean_max": RENDER_REL_MEAN_MAX}
            check(rep["rel_mse"] <= RENDER_REL_MSE_MAX
                  and rep["rel_mean"] <= RENDER_REL_MEAN_MAX,
                  f"tiles on 4 vs 1: {rep}")
        else:
            rep["mean_z"] = verify.mean_z(multi["color"], single["color"])
            rep["tolerance"] = {"mean_z_max": SAMPLES_Z_MAX}
            check(rep["mean_z"] <= SAMPLES_Z_MAX, f"samples on 4 vs 1: {rep}")
        emit("four", **rep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU render_multichip phase")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s [%(name)s] %(message)s")

    devices = require_gpu()
    import jax

    from rene_tpu.ops.native import get_lib
    from rene_tpu.utils.compile_cache import enable_compile_cache

    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    native = get_lib() is not None
    cache = enable_compile_cache()
    entries = (len(os.listdir(cache)) if os.path.isdir(cache) else 0)
    emit("env", jax=jax.__version__, platform=devices[0].platform,
         kind=devices[0].device_kind, count=len(devices),
         compile_cache=cache, compile_cache_entries_at_start=entries,
         bvh_build="native C++" if native else "numpy fallback",
         native_load_s=time.perf_counter() - t0)
    if args.four:
        run_four_gpus(devices)
    else:
        run_one_gpu(devices)
    print(card_line(), flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
