"""Plain references and comparison metrics for checking the device kernels.

* `closest_hit_f64` — brute-force float64 Möller–Trumbore over every
  triangle, in numpy: the reference both intersectors (ops/mxu_intersect.py,
  ops/bvh.py) are held to.
* `probe_rays` — seeded rays that stress an intersector: aimed at interiors,
  at points on edges shared by two triangles, and at grazing angles.
* `hit_agreement`, `image_agreement`, `mean_z` — the numbers a comparison
  reports, each against a tolerance stated where it is used.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MISS_T = 1e30


def _mt_f64(o, d, p0, p1, p2, tmin, tmax, slack=0.0):
    """float64 Möller–Trumbore t, MISS_T on a miss, broadcast over the
    leading axes of rays (o, d, tmin, tmax) and triangles (p0, p1, p2);
    the barycentric bounds are widened by `slack`."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, axis=-1)
    ok = np.abs(det) > 1e-300
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tvec = o - p0
    u = np.sum(tvec * pvec, axis=-1) * inv
    qvec = np.cross(tvec, e1)
    v = np.sum(d * qvec, axis=-1) * inv
    t = np.sum(e2 * qvec, axis=-1) * inv
    hit = (ok & (u >= -slack) & (v >= -slack) & (u + v <= 1 + slack)
           & (t >= tmin) & (t <= tmax))
    return np.where(hit, t, MISS_T)


def closest_hit_f64(org, direction, tri_p, tmin=1e-3, tmax=1e5,
                    threads=None):
    """Closest hit of each ray over all triangles, in float64.

    org, direction: (R, 3); tri_p: (C, 3, 3). Returns (t (R,), id (R,)),
    t = MISS_T and id = -1 on a miss. Rays are split into chunks that run
    on a thread pool (numpy releases the interpreter lock)."""
    org = np.asarray(org, np.float64)
    d = np.asarray(direction, np.float64)
    tri = np.asarray(tri_p, np.float64)
    r = org.shape[0]
    tmin_v = np.broadcast_to(np.float64(tmin), (r,))
    tmax_v = np.broadcast_to(np.float64(tmax), (r,))
    rows = max(1, min(4096, (1 << 22) // max(tri.shape[0], 1)))
    t_out = np.full(r, MISS_T)
    id_out = np.full(r, -1, np.int64)

    def work(lo):
        hi = min(lo + rows, r)
        best_t = np.full(hi - lo, MISS_T)
        best_id = np.full(hi - lo, -1, np.int64)
        for c0 in range(0, tri.shape[0], 8192):
            blk = tri[c0:c0 + 8192]
            t = _mt_f64(org[lo:hi, None], d[lo:hi, None], blk[None, :, 0],
                        blk[None, :, 1], blk[None, :, 2],
                        tmin_v[lo:hi, None], tmax_v[lo:hi, None])
            j = np.argmin(t, axis=1)
            tj = t[np.arange(hi - lo), j]
            better = tj < best_t
            best_t = np.where(better, tj, best_t)
            best_id = np.where(better & (tj < MISS_T), c0 + j, best_id)
        t_out[lo:hi] = best_t
        id_out[lo:hi] = best_id

    workers = threads or min(16, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, range(0, r, rows)))
    return t_out, id_out


def t_of_f64(org, direction, tri_p, ids, tmin=1e-3, tmax=1e5, slack=0.0):
    """float64 t of each ray against ONE triangle each (`ids`, -1 = none);
    MISS_T where that triangle is not hit, with the barycentric bounds
    widened by `slack`."""
    tri = np.asarray(tri_p, np.float64)[np.maximum(ids, 0)]
    t = _mt_f64(np.asarray(org, np.float64),
                np.asarray(direction, np.float64), tri[:, 0], tri[:, 1],
                tri[:, 2], tmin, tmax, slack)
    return np.where(np.asarray(ids) >= 0, t, MISS_T)


def shared_edges(tri_p):
    """Edges (as (E, 2, 3) endpoint pairs) that two or more triangles share
    exactly, found by vertex position."""
    tri = np.ascontiguousarray(np.asarray(tri_p, np.float32))
    verts = tri.reshape(-1, 3)
    _, vid = np.unique(verts.view(np.dtype((np.void, 12))),
                       return_inverse=True)
    vid = vid.reshape(-1, 3)
    a = vid[:, [0, 1, 2]].reshape(-1)
    b = vid[:, [1, 2, 0]].reshape(-1)
    key = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
    _, first, counts = np.unique(key, axis=0, return_index=True,
                                 return_counts=True)
    src = first[counts >= 2]
    # half-edge k of triangle f: endpoints are vertices k and (k+1)%3
    f, k = src // 3, src % 3
    return np.stack([tri[f, k], tri[f, (k + 1) % 3]],
                    axis=1).astype(np.float64).reshape(-1, 2, 3)


def probe_rays(tri_p, n: int, seed: int = 0):
    """`n` seeded rays (org, dir, kind) against a triangle set, float32.

    kind 0 (half): from a sphere around the set to a uniform point of a
    random triangle; kind 1 (quarter): to a point on an edge two triangles
    share (a tie for the closest hit); kind 2 (quarter): grazing, 0.06 to
    3 degrees off a random triangle's plane, to a point inside it."""
    rng = np.random.default_rng(seed)
    tri = np.asarray(tri_p, np.float64)
    lo = tri.reshape(-1, 3).min(axis=0)
    hi = tri.reshape(-1, 3).max(axis=0)
    center = 0.5 * (lo + hi)
    radius = 1.5 * np.linalg.norm(hi - lo) + 1e-3

    def bary_point(ids):
        u, v = rng.random(len(ids)), rng.random(len(ids))
        flip = u + v > 1
        u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
        t = tri[ids]
        return t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) \
            + v[:, None] * (t[:, 2] - t[:, 0])

    n_edge = n // 4
    n_graze = n // 4
    n_int = n - n_edge - n_graze
    kinds = np.repeat(np.arange(3, dtype=np.int8), [n_int, n_edge, n_graze])

    # interior
    tgt_i = bary_point(rng.integers(0, len(tri), n_int))
    dirs = rng.standard_normal((n_int, 3))
    org_i = center + radius * dirs / np.linalg.norm(dirs, axis=1,
                                                    keepdims=True)
    # shared edges (fall back to interior targets if there are none)
    edges = shared_edges(tri)
    if len(edges):
        e = edges[rng.integers(0, len(edges), n_edge)]
        s = rng.uniform(0.05, 0.95, (n_edge, 1))
        tgt_e = e[:, 0] + s * (e[:, 1] - e[:, 0])
    else:
        tgt_e = bary_point(rng.integers(0, len(tri), n_edge))
    dirs = rng.standard_normal((n_edge, 3))
    org_e = center + radius * dirs / np.linalg.norm(dirs, axis=1,
                                                    keepdims=True)
    # grazing
    gid = rng.integers(0, len(tri), n_graze)
    tgt_g = bary_point(gid)
    t = tri[gid]
    nrm = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
    inplane = np.cross(nrm, rng.standard_normal((n_graze, 3)))
    inplane /= np.maximum(np.linalg.norm(inplane, axis=1, keepdims=True),
                          1e-300)
    ang = np.radians(rng.uniform(0.06, 3.0, (n_graze, 1)))
    side = np.where(rng.random((n_graze, 1)) < 0.5, -1.0, 1.0)
    gdir = np.cos(ang) * inplane + side * np.sin(ang) * nrm
    org_g = tgt_g - radius * gdir

    org = np.concatenate([org_i, org_e, org_g])
    tgt = np.concatenate([tgt_i, tgt_e, tgt_g])
    d = tgt - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32), kinds


def hit_agreement(t, ids, ref_t, ref_ids, org, direction, tri_p,
                  tie_rtol=1e-4, slack=1e-4):
    """Compare an intersector's (t, id) with the float64 reference.

    A ray agrees when both miss, or the ids match, or the device's
    triangle is hit in float64 — barycentrics widened by `slack` — at the
    reference's closest t within `tie_rtol`: a tie, such as a ray through
    an edge that two triangles share, where float32 rounding of the ray
    decides which neighbour it enters. Returns the agreeing share, the
    share whose hit/miss differs, and the largest relative t error over
    agreeing hits, and that error as a distance from the hit triangle's
    plane relative to the triangle set's bounding-box diagonal
    (`max_plane_err`: |t - t_ref| |cos|, where a grazing ray with a small
    |cos| has a large relative t error for a tiny displacement)."""
    t = np.asarray(t, np.float64)
    ids = np.asarray(ids, np.int64)
    tri = np.asarray(tri_p, np.float64)
    d = np.asarray(direction, np.float64)
    hit = t < 1e29
    ref_hit = ref_t < 1e29
    ids = np.where(hit, ids, -1)
    t_dev_tri = t_of_f64(org, direction, tri, ids, slack=slack)
    tie = hit & ref_hit & (np.abs(t_dev_tri - ref_t)
                           <= tie_rtol * np.maximum(ref_t, 1e-12))
    agree = (~hit & ~ref_hit) | (hit & ref_hit & (ids == ref_ids)) | tie
    both = hit & ref_hit & agree
    err = np.abs(t[both] - ref_t[both])
    rel = err / np.maximum(ref_t[both], 1e-12)
    rt = tri[ref_ids[both]]
    nrm = np.cross(rt[:, 1] - rt[:, 0], rt[:, 2] - rt[:, 0])
    cos = np.abs(np.sum(nrm * d[both], axis=1)) / np.maximum(
        np.linalg.norm(nrm, axis=1) * np.linalg.norm(d[both], axis=1),
        1e-300)
    diag = np.linalg.norm(tri.reshape(-1, 3).max(axis=0)
                          - tri.reshape(-1, 3).min(axis=0))
    return {
        "rays": int(t.shape[0]),
        "hit_share": float(ref_hit.mean()),
        "agree": float(agree.mean()),
        "hit_mismatch": float((hit != ref_hit).mean()),
        "max_rel_t": float(rel.max()) if rel.size else 0.0,
        "max_plane_err": float((err * cos).max() / diag) if rel.size
        else 0.0,
    }


def image_agreement(img, ref):
    """Relative difference of the image means (per channel, largest) and
    relative MSE, sum((img-ref)^2) / sum(ref^2)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    m, mr = img.mean(axis=(0, 1)), ref.mean(axis=(0, 1))
    return {
        "rel_mean": float(np.max(np.abs(m - mr) / np.maximum(np.abs(mr),
                                                             1e-12))),
        "rel_mse": float(np.sum((img - ref) ** 2)
                         / max(np.sum(ref ** 2), 1e-30)),
    }


def mean_z(a, b):
    """Largest per-channel z-score of mean(a) - mean(b) for two images of
    independent per-pixel estimates: the difference over its standard
    error std(a-b)/sqrt(pixels)."""
    diff = (np.asarray(a, np.float64) - np.asarray(b, np.float64))
    diff = diff.reshape(-1, diff.shape[-1])
    se = diff.std(axis=0, ddof=1) / np.sqrt(diff.shape[0])
    return float(np.max(np.abs(diff.mean(axis=0)) / np.maximum(se, 1e-30)))
