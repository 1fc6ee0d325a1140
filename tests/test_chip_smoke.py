"""chip_smoke.py's pieces on the CPU: scene generators, the float64
reference and comparison helpers, the result line, the refusal to run
without a GPU, and — marked `gpu`, skipped here — its checks on a card."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from rene_tpu.scene import build_device_scene, load_scene
from rene_tpu.scene.synth import CORNELL_BOX, NU, NV, blob_mesh, \
    load_mesh_scene
from rene_tpu.utils import verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cornell_box_stand_in():
    _, cfg = build_device_scene(load_scene(CORNELL_BOX))
    assert cfg.num_triangles == 36 and cfg.num_emit_triangles == 2
    assert (cfg.film.xresolution, cfg.film.yresolution) == (1024, 1024)
    assert cfg.integrator == "path" and cfg.max_depth_hint == 65


@pytest.mark.parametrize("nlevels", [0, 1, 2, 4])
def test_mesh_scene_triangle_count(nlevels):
    _, cfg = build_device_scene(load_mesh_scene(0, nlevels=nlevels,
                                                xres=8, yres=8))
    base = 2 * NU * (NV - 1)
    assert cfg.num_triangles == 2 + base * 4 ** nlevels
    if nlevels == 4:
        assert cfg.num_triangles >= 100_000


def test_mesh_scene_is_seeded():
    a = build_device_scene(load_mesh_scene(5, nlevels=1))[0]["tri_p"]
    b = build_device_scene(load_mesh_scene(5, nlevels=1))[0]["tri_p"]
    c = build_device_scene(load_mesh_scene(6, nlevels=1))[0]["tri_p"]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3
    pos, idx = blob_mesh(5)
    assert idx.max() == len(pos) - 1 and len(idx) == 3 * 2 * NU * (NV - 1)


def test_closest_hit_f64_on_known_geometry():
    # two parallel unit squares at z=0 and z=1 (4 triangles)
    sq = [[[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[0, 0, 0], [1, 1, 0], [0, 1, 0]]]
    tri = np.asarray(sq + [[[x, y, 1.0] for x, y, _ in t] for t in sq])
    org = np.asarray([[0.7, 0.2, 3.0], [0.2, 0.7, 3.0], [5.0, 5.0, 3.0],
                      [0.3, 0.3, 0.5]])
    d = np.asarray([[0, 0, -1.0]] * 3 + [[0, 0, 1.0]])
    t, ids = verify.closest_hit_f64(org, d, tri, threads=2)
    np.testing.assert_allclose(t[[0, 1, 3]], [2.0, 2.0, 0.5])
    assert list(ids[[0, 1, 3]]) == [2, 3, 2] and ids[2] == -1
    assert t[2] == verify.MISS_T


def test_shared_edges():
    quad = np.asarray([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                       [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    e = verify.shared_edges(quad)
    assert e.shape == (1, 2, 3)
    assert {tuple(e[0, 0]), tuple(e[0, 1])} == {(0, 0, 0), (1, 1, 0)}
    cornell = build_device_scene(load_scene(CORNELL_BOX))[0]["tri_p"]
    assert len(verify.shared_edges(cornell)) > 18  # >= one diagonal a quad


def test_probe_rays_kinds_and_edge_targets():
    quad = np.asarray([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                       [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    org, d, kinds = verify.probe_rays(quad, 400, seed=2)
    assert org.dtype == np.float32 and d.shape == (400, 3)
    assert np.bincount(kinds).tolist() == [200, 100, 100]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-6)
    # edge rays cross z=0 on the diagonal x == y
    m = kinds == 1
    s = -org[m, 2] / d[m, 2]
    p = org[m] + s[:, None] * d[m]
    np.testing.assert_allclose(p[:, 0], p[:, 1], atol=1e-4)


def test_hit_agreement_counts_ties_and_errors():
    quad = np.asarray([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                       [[0, 0, 0], [1, 1, 0], [0, 1, 0]]])
    org = np.asarray([[0.5, 0.5, 2.0], [0.8, 0.1, 2.0], [3.0, 3.0, 2.0]])
    d = np.asarray([[0, 0, -1.0]] * 3)
    ref_t, ref_id = verify.closest_hit_f64(org, d, quad)
    # ray 0 hits the diagonal: either triangle is a tie
    tied = verify.hit_agreement(np.asarray([2.0, 2.0, 1e30]),
                                np.asarray([1 - ref_id[0], ref_id[1], 0]),
                                ref_t, ref_id, org, d, quad)
    assert tied["agree"] == 1.0 and tied["hit_mismatch"] == 0.0
    wrong = verify.hit_agreement(np.asarray([2.0, 2.01, 2.0]),
                                 np.asarray([ref_id[0], 1 - ref_id[1], 0]),
                                 ref_t, ref_id, org, d, quad)
    assert wrong["agree"] == pytest.approx(1 / 3)
    assert wrong["hit_mismatch"] == pytest.approx(1 / 3)
    off = verify.hit_agreement(np.asarray([2.0, 2.0 + 1e-3, 1e30]),
                               ref_id, ref_t, ref_id, org, d, quad)
    assert off["max_rel_t"] == pytest.approx(5e-4)
    assert off["max_plane_err"] == pytest.approx(1e-3 / np.sqrt(2))


def test_image_agreement_and_mean_z():
    rng = np.random.default_rng(0)
    a = rng.random((32, 32, 3))
    rep = verify.image_agreement(a, a)
    assert rep == {"rel_mean": 0.0, "rel_mse": 0.0}
    b = a.copy()
    b[0, 0] += 1.0
    rep = verify.image_agreement(b, a)
    assert 0 < rep["rel_mse"] < 1e-2 and rep["rel_mean"] > 0
    c = rng.random((32, 32, 3))
    assert verify.mean_z(a, c) < 4.5
    assert verify.mean_z(a + 0.2, c) > 10


def test_result_line_is_exact():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"
    line = chip_smoke.result_line([Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line([Dev()] * 4))["device"][
        "count"] == 4


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()
    # the refusal must not have moved this process off the CPU
    assert jax.devices()[0].platform == "cpu"


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_exits_nonzero_without_gpu():
    p = _run_smoke(REPO)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_smoke(tmp_path)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.mark.parametrize("which", ["matmul", "bvh"])
def test_intersect_case_small(which):
    from rene_tpu.ops.bvh import build_bvh
    from rene_tpu.ops.mxu_intersect import MXUIntersector
    tri = build_device_scene(load_scene(CORNELL_BOX))[0]["tri_p"]
    accel = (MXUIntersector(tri) if which == "matmul"
             else build_bvh(tri)).to_device()
    rep = chip_smoke.intersect_case("cornell", tri, accel, 2048, 1024)
    assert rep["intersector"] == which
    assert rep["interior"]["agree"] == 1.0


def test_cli_phase_renders_a_png(tmp_path):
    out = str(tmp_path / "c.png")
    scene = tmp_path / "s.pbrt"
    scene.write_text("""
Film "image" "integer xresolution" [ 8 ] "integer yresolution" [ 6 ]
WorldBegin
LightSource "infinite" "rgb L" [ .5 .5 .5 ]
Material "matte"
Shape "sphere" "float radius" 1
WorldEnd""")
    rep = chip_smoke.cli_phase("cli", [str(scene), "--spp", "2",
                                       "--output", out], jax.devices()[0])
    assert rep["wall_s"] > 0 and rep["log_wrote"].startswith("wrote ")
    assert os.path.getsize(out) > 0


@pytest.mark.gpu
def test_intersectors_on_gpu(gpu):
    chip_smoke.phase_intersect(n_rays=1 << 14)


@pytest.mark.gpu
def test_render_matches_cpu_on_gpu(gpu):
    chip_smoke.phase_render_vs_cpu(res=32, spp=2)


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu):
    scene = load_scene(CORNELL_BOX)
    scene.set_film_resolution(64, 64)
    rep, out = chip_smoke.kernel_phase("cornell", scene, 2, gpu)
    assert rep["mrays_per_s"] > 0
    assert np.isfinite(np.asarray(out["radiance"])).all()
