"""Brute-force Plücker (matmul) intersector vs Möller–Trumbore ground truth."""
import jax.numpy as jnp
import numpy as np
import pytest

from rene_tpu.ops import intersect as I
from rene_tpu.ops.mxu_intersect import MXUIntersector
from tests.test_intersect import random_rays, random_tris


@pytest.mark.parametrize("ntri", [8, 36, 500])
def test_matches_moller_trumbore(ntri):
    tri = random_tris(ntri, seed=ntri + 40, scale=3.0)
    org, d = random_rays(800, seed=ntri + 41, scale=4.0)
    tmin = jnp.full((800,), 1e-3)
    tmax = jnp.full((800,), 1e30)
    bt, bid = I.intersect_triangles(org, d, tmin, tmax, jnp.asarray(tri))
    mx = MXUIntersector(tri)
    mt, mid, u, v = mx.intersect(org, d, tmin, tmax, want_bary=True)
    bt = np.asarray(bt)
    mt = np.asarray(mt)
    hit_b = bt < 1e29
    hit_m = mt < 1e29
    # identical hit sets up to f32 edge cases
    assert (hit_b == hit_m).mean() > 0.998
    both = hit_b & hit_m
    assert both.sum() > 10  # the test must actually exercise hits
    np.testing.assert_allclose(mt[both], bt[both], rtol=2e-3, atol=1e-4)
    assert (np.asarray(bid)[both] == np.asarray(mid)[both]).mean() > 0.99


def test_barycentrics_match_mt_convention():
    # one triangle; compare (u, v) against the MT attribute convention
    tri = np.asarray([[[0.0, 0, 0], [2, 0, 0], [0, 2, 0]]], np.float32)
    pts = [(0.3, 0.4), (0.1, 0.05), (0.6, 0.3)]
    org = np.asarray([[2 * u_ + 0 * v_, 2 * v_, 1.0] for u_, v_ in pts],
                     np.float32)
    # ray straight down hits at (x, y, 0); bary u = x/2, v = y/2
    d = np.broadcast_to(np.asarray([0, 0, -1.0], np.float32), (3, 3)).copy()
    mx = MXUIntersector(tri)
    t, tid, u, v = mx.intersect(jnp.asarray(org), jnp.asarray(d),
                                jnp.full((3,), 1e-3), jnp.full((3,), 1e3),
                                want_bary=True)
    for i, (ue, ve) in enumerate(pts):
        assert float(t[i]) == pytest.approx(1.0, rel=1e-4)
        assert float(u[i]) == pytest.approx(ue, abs=1e-4)
        assert float(v[i]) == pytest.approx(ve, abs=1e-4)


def test_backface_hits():
    tri = np.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    mx = MXUIntersector(tri)
    org = jnp.asarray([[0.2, 0.2, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, _ = mx.intersect(org, d, jnp.asarray([1e-3]), jnp.asarray([1e3]))
    assert float(t[0]) == pytest.approx(1.0, rel=1e-4)


def test_every_dot_is_full_float32_precision():
    """Each dot of the lowered intersector asks for HIGHEST precision: a
    GPU may otherwise run a float32 dot in TF32 (10-bit mantissa), which
    breaks the shared-edge sign test and the plane t against TMIN."""
    import re

    import jax

    tri = random_tris(40, seed=3)
    mx = MXUIntersector(tri)
    org, d = random_rays(64, seed=4)
    tmin = jnp.full((64,), 1e-3)
    tmax = jnp.full((64,), 1e30)
    for bary in (False, True):
        text = jax.jit(lambda o, dd: mx.intersect(
            o, dd, tmin, tmax, want_bary=bary)).lower(org, d).as_text()
        dots = re.findall(r"stablehlo\.dot_general.*", text)
        assert len(dots) == 3, dots
        for line in dots:
            assert "precision = [HIGHEST, HIGHEST]" in line, line


def _mesh_tris(n):
    from rene_tpu.scene.device import build_device_scene
    from rene_tpu.scene.synth import load_mesh_scene
    tri = build_device_scene(load_mesh_scene(1, nlevels=2))[0]["tri_p"]
    return tri[2:2 + n]  # a connected patch of the mesh, floor skipped


@pytest.mark.parametrize("kind,ntri", [(0, 4096), (1, 4096), (2, 4096),
                                       (1, 36)])
def test_matches_float64_reference(kind, ntri):
    """Probe rays of one kind (0 interior, 1 aimed at a shared edge, 2
    grazing) against float64 Möller–Trumbore. Interior and grazing rays
    pick the float64 triangle (but for a target within rounding of the
    patch's open boundary) and land within 1e-5 scene diagonals of its
    plane; edge rays may split either way at silhouettes (>= 95%)."""
    from rene_tpu.scene import build_device_scene, load_scene
    from rene_tpu.scene.synth import CORNELL_BOX
    from rene_tpu.utils import verify

    tri = (_mesh_tris(ntri) if ntri == 4096 else
           build_device_scene(load_scene(CORNELL_BOX))[0]["tri_p"])
    assert len(tri) == ntri
    org, d, kinds = verify.probe_rays(tri, 2048, seed=kind + ntri)
    m = kinds == kind
    org, d = org[m], d[m]
    n = len(org)
    t, ids = MXUIntersector(tri).intersect(
        jnp.asarray(org), jnp.asarray(d), jnp.full((n,), 1e-3),
        jnp.full((n,), 1e5))
    ref_t, ref_id = verify.closest_hit_f64(org, d, tri)
    rep = verify.hit_agreement(np.asarray(t), np.asarray(ids), ref_t,
                               ref_id, org, d, tri)
    assert rep["hit_share"] > 0.9, rep
    if kind == 1:
        assert rep["agree"] >= 0.95, rep
    else:
        assert rep["agree"] >= 0.998 and rep["max_plane_err"] <= 1e-5, rep
