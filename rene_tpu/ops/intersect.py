"""Ray-scene intersection: closest hit, occlusion, emissive-pdf traces.

Replaces the reference's Vulkan fixed-function BVH traversal plus its
intersection/closest-hit shaders (rene-shader/src/lib.rs:805-952). All ray
data is component-SoA (`V3`, see vec3.py); the triangle test itself runs as
matmuls (ops/mxu_intersect.py) for brute-force-sized scenes or through the
BVH wavefront traversal (ops/bvh.py) for large meshes. Analytic spheres are
a python-unrolled loop over instances (object-space quadratic, the
reference's sphere_intersection lib.rs:805-839).

Hit records are dicts:
  t (N,), hit (N,) bool, inst (N,) i32, kind (N,) i32,
  prim (N,) i32, position/normal V3, uv (u, v) scalar pair.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..scene import types as T
from . import vec3 as v3
from .vec3 import V3

BIG_T = np.float32(1e30)  # a numpy scalar: see the note in ops/rng.py
TRI_CHUNK = 512


# ---------------------------------------------------------------------------
# Möller–Trumbore over (N, C) arrays — ground truth + BVH leaf tests
# ---------------------------------------------------------------------------

def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def moller_trumbore(org, direction, p0, p1, p2, tmin, tmax):
    """Batched ray/triangle test on (..., 3) arrays (BVH/reference path).

    Returns (t, u, v, hit) with barycentric weights (1-u-v, u, v) matching
    the Vulkan hit attribute convention (lib.rs:926).
    """
    e1 = p1 - p0
    e2 = p2 - p0
    d = direction[..., None, :]
    o = org[..., None, :]
    pvec = jnp.cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - p0
    u = _dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= tmin[..., None]) & (t <= tmax[..., None]))
    return t, u, v, hit


def _pad_chunks(arr, chunk, fill=0.0):
    n = arr.shape[0]
    pad = (-n) % chunk
    if pad:
        pad_block = jnp.full((pad,) + arr.shape[1:], fill, arr.dtype)
        arr = jnp.concatenate([jnp.asarray(arr), pad_block], axis=0)
    return jnp.asarray(arr).reshape((-1, chunk) + tuple(arr.shape[1:]))


def intersect_triangles(org, direction, tmin, tmax, tri_p, chunk=TRI_CHUNK):
    """Closest triangle hit by brute force over (T,3,3) triangles.

    org/direction: (N,3) arrays. Returns (t, prim_id), t = BIG_T on miss.
    """
    ntri = tri_p.shape[0]
    chunk = min(chunk, max(int(ntri), 1))
    chunks = _pad_chunks(tri_p, chunk)
    nchunks = chunks.shape[0]
    base_ids = jnp.arange(chunk, dtype=jnp.int32)

    def body(carry, xs):
        best_t, best_id = carry
        tri_chunk, chunk_idx = xs
        t, _, _, hit = moller_trumbore(
            org, direction, tri_chunk[None, :, 0], tri_chunk[None, :, 1],
            tri_chunk[None, :, 2], tmin, jnp.minimum(tmax, best_t))
        ids = chunk_idx * chunk + base_ids
        valid = hit & (ids[None, :] < ntri)
        t = jnp.where(valid, t, BIG_T)
        arg = jnp.argmin(t, axis=-1)
        tbest = jnp.take_along_axis(t, arg[:, None], axis=-1)[:, 0]
        closer = tbest < best_t
        best_id = jnp.where(closer, ids[arg], best_id)
        best_t = jnp.where(closer, tbest, best_t)
        return (best_t, best_id), None

    n = org.shape[0]
    init = (jnp.full((n,), BIG_T), jnp.full((n,), -1, jnp.int32))
    if nchunks == 1:
        (best_t, best_id), _ = body(init, (chunks[0], jnp.int32(0)))
        return best_t, best_id
    (best_t, best_id), _ = jax.lax.scan(
        body, init, (chunks, jnp.arange(nchunks, dtype=jnp.int32)))
    return best_t, best_id


# ---------------------------------------------------------------------------
# Spheres: python-unrolled analytic intersection (component math)
# ---------------------------------------------------------------------------

def intersect_spheres_v3(buffers, config, org: V3, direction: V3, tmin,
                         tmax):
    """Closest unit-sphere hit across instances (lib.rs:805-839).

    Unrolled python loop over the (static) sphere count — per sphere the
    world->object transform is a traced (3,4) slice, broadcast against (N,)
    component arrays.
    """
    n = org.x.shape[0]
    best_t = jnp.full((n,), BIG_T)
    best_id = jnp.zeros((n,), jnp.int32)
    w2o = buffers["sph_w2o"][:config.num_spheres]

    # lax.scan over spheres: ONE traced body regardless of sphere count
    # (the old unrolled python loop compiled a ~30*S-op graph per tile
    # variant — minutes of XLA CPU compile past ~100 spheres). The
    # sequential min-update order matches the unroll bit-exactly.
    def body(carry, m):
        best_t, best_id, s = carry
        o = v3.affine_point(m, org)
        d = v3.affine_vector(m, direction)
        a = d.dot(d)
        half_b = o.dot(d)
        c = o.dot(o) - 1.0
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / jnp.maximum(a, 1e-20)
        root0 = (-half_b - sq) * inv_a
        root1 = (-half_b + sq) * inv_a
        ok = disc >= 0.0
        r0ok = ok & (root0 >= tmin) & (root0 <= tmax)
        r1ok = ok & (root1 >= tmin) & (root1 <= tmax)
        t = jnp.where(r0ok, root0, jnp.where(r1ok, root1, BIG_T))
        closer = t < best_t
        return (jnp.where(closer, t, best_t),
                jnp.where(closer, s, best_id), s + 1), None

    (best_t, best_id, _), _ = jax.lax.scan(
        body, (best_t, best_id, jnp.int32(0)), w2o)
    return best_t, best_id


# ---------------------------------------------------------------------------
# Main dispatch
# ---------------------------------------------------------------------------

def _main_tri_intersect(buffers, config, org: V3, direction: V3, tminv,
                        tmaxv, accel, want_bary=False):
    """Triangle closest-hit over the selected accelerator (V3 rays)."""
    from .mxu_intersect import MXUIntersector
    n = org.x.shape[0]
    main = getattr(accel, "main", None)
    bu = bv = None
    if config.num_triangles <= 0:
        return (jnp.full((n,), BIG_T), jnp.zeros((n,), jnp.int32), bu, bv)
    if isinstance(main, MXUIntersector):
        if want_bary:
            tri_t, tri_id, bu, bv = main.intersect(org, direction, tminv,
                                                   tmaxv, want_bary=True)
        else:
            tri_t, tri_id = main.intersect(org, direction, tminv, tmaxv)
    else:
        oarr = org.to_array()
        darr = direction.to_array()
        if main is not None:  # BVH
            tri_t, tri_id = main.intersect(oarr, darr, tminv, tmaxv)
        else:
            tri_t, tri_id = intersect_triangles(oarr, darr, tminv, tmaxv,
                                                buffers["tri_p"])
    return tri_t, tri_id, bu, bv


def _gather9(table, idx):
    """(9, T) table -> three V3s of (N,) components."""
    g = jnp.take(table, idx, axis=1)  # (9, N)
    return (V3(g[0], g[1], g[2]), V3(g[3], g[4], g[5]), V3(g[6], g[7], g[8]))


def trace(buffers, config, org: V3, direction: V3, tmin, tmax, accel=None):
    """Full closest-hit trace with shading attributes.

    Equivalent of tlas_main.trace_ray + the closest-hit shaders
    (triangle_closest_hit lib.rs:892-952, sphere_closest_hit lib.rs:852-881).
    """
    n = org.x.shape[0]
    tminv = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    tmaxv = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))

    tri_t, tri_id, bu, bv = _main_tri_intersect(
        buffers, config, org, direction, tminv, tmaxv, accel,
        want_bary=True)

    if config.num_spheres > 0:
        sph_t, sph_id = intersect_spheres_v3(buffers, config, org, direction,
                                             tminv, tmaxv)
    else:
        sph_t = jnp.full((n,), BIG_T)
        sph_id = jnp.zeros((n,), jnp.int32)

    is_sphere = sph_t < tri_t
    t = jnp.minimum(tri_t, sph_t)
    hit = t < BIG_T

    # ---- triangle shading attributes
    tid = jnp.clip(tri_id, 0, max(config.num_triangles - 1, 0))
    p0, p1, p2 = _gather9(buffers["tri_pT"], tid)
    n0, n1, n2 = _gather9(buffers["tri_nT"], tid)
    guv = jnp.take(buffers["tri_uvT"], tid, axis=1)  # (6, N)
    if bu is None:
        oarr = org.to_array()
        darr = direction.to_array()
        tp = jnp.stack([p0.to_array(), p1.to_array(), p2.to_array()], axis=1)
        _, u_, v_, _ = moller_trumbore(oarr, darr, tp[:, None, 0],
                                       tp[:, None, 1], tp[:, None, 2],
                                       tminv, jnp.full_like(tminv, 1e30))
        bu = u_[:, 0]
        bv = v_[:, 0]
    bu = jnp.clip(bu, 0.0, 1.0)
    bv = jnp.clip(bv, 0.0, 1.0)
    w0 = 1.0 - bu - bv
    tri_pos = p0 * w0 + p1 * bu + p2 * bv
    tri_nrm = n0 * w0 + n1 * bu + n2 * bv
    tri_u = guv[0] * w0 + guv[2] * bu + guv[4] * bv
    tri_v = guv[1] * w0 + guv[3] * bu + guv[5] * bv
    tri_inst = buffers["tri_inst"][tid]

    # ---- sphere shading attributes
    sid = jnp.clip(sph_id, 0, max(config.num_spheres - 1, 0))
    g = jnp.take(buffers["sph_w2oT"], sid, axis=1)  # (12, N) rows of w2o
    sph_pos = org + direction * sph_t
    obj = V3(g[0] * sph_pos.x + g[1] * sph_pos.y + g[2] * sph_pos.z + g[3],
             g[4] * sph_pos.x + g[5] * sph_pos.y + g[6] * sph_pos.z + g[7],
             g[8] * sph_pos.x + g[9] * sph_pos.y + g[10] * sph_pos.z
             + g[11])
    # normal = W2O^T @ obj (transpose-multiply, lib.rs:874-878)
    sph_nrm = V3(g[0] * obj.x + g[4] * obj.y + g[8] * obj.z,
                 g[1] * obj.x + g[5] * obj.y + g[9] * obj.z,
                 g[2] * obj.x + g[6] * obj.y + g[10] * obj.z)
    phi = jnp.arctan2(obj.y, obj.x)
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    theta = jnp.arccos(jnp.clip(obj.z, -1.0, 1.0))
    sph_u = phi * (0.5 / math.pi)
    sph_v = (theta - math.pi) * (-1.0 / math.pi)
    sph_inst = buffers["sph_inst"][sid]

    return {
        "t": t,
        "hit": hit,
        "kind": jnp.where(is_sphere, T.KIND_SPHERE,
                          T.KIND_TRIANGLE).astype(jnp.int32),
        "prim": jnp.where(is_sphere, sph_id, tri_id),
        "inst": jnp.where(is_sphere, sph_inst, tri_inst),
        "position": v3.where(is_sphere, sph_pos, tri_pos),
        "normal": v3.where(is_sphere, sph_nrm, tri_nrm),
        "uv": (jnp.where(is_sphere, sph_u, tri_u),
               jnp.where(is_sphere, sph_v, tri_v)),
    }


def occluded(buffers, config, org: V3, direction: V3, tmin, tmax,
             accel=None):
    """Shadow-ray test: any hit in (tmin, tmax). The reference does a full
    closest-hit trace and checks is_miss (lib.rs:244-260)."""
    n = org.x.shape[0]
    tminv = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    tmaxv = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    t = jnp.full((n,), BIG_T)
    if config.num_triangles > 0:
        tri_t, _, _, _ = _main_tri_intersect(
            buffers, config, org, direction, tminv, tmaxv, accel)
        t = jnp.minimum(t, tri_t)
    if config.num_spheres > 0:
        sph_t, _ = intersect_spheres_v3(buffers, config, org, direction,
                                        tminv, tmaxv)
        t = jnp.minimum(t, sph_t)
    return t < BIG_T


def trace_emissive_pdf(buffers, config, org: V3, direction: V3, tmin, tmax,
                       accel=None):
    """Light-pdf ray against the emissive-only set.

    Port of the tlas_emit trace + triangle_closest_hit_pdf /
    sphere_closest_hit_pdf (lib.rs:964-1066): the solid-angle pdf of the
    closest emissive hit (0 on miss); NOT yet divided by emit_object_len.
    """
    n = org.x.shape[0]
    tminv = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    tmaxv = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))

    tri_t = jnp.full((n,), BIG_T)
    tri_pdf = jnp.zeros((n,))
    if config.num_emit_triangles > 0:
        etri = buffers["emit_tri_ids"]
        emit_accel = getattr(accel, "emit", None)
        if emit_accel is not None:
            tt, eid = emit_accel.intersect(org, direction, tminv, tmaxv)
        else:
            tp = buffers["tri_p"][etri]
            tt, eid = intersect_triangles(org.to_array(),
                                          direction.to_array(), tminv,
                                          tmaxv, tp)
        eid = jnp.clip(eid, 0, config.num_emit_triangles - 1)
        gid = etri[eid]
        p0, p1, p2 = _gather9(buffers["tri_pT"], gid)
        ab = p1 - p0
        ac = p2 - p0
        cr = ab.cross(ac)
        cr_len = cr.length()
        gn = cr * (1.0 / jnp.maximum(cr_len, 1e-20))
        area = 0.5 * cr_len
        hit_pos = org + direction * tt
        dist2 = (org - hit_pos).length_squared()
        cosine = jnp.abs(direction.normalized().dot(gn))
        prim_count = buffers["inst_prim_count"][
            buffers["tri_inst"][gid]].astype(jnp.float32)
        tri_pdf = dist2 / jnp.maximum(cosine * area, 1e-20) / prim_count
        tri_t = tt

    sph_t = jnp.full((n,), BIG_T)
    sph_pdf = jnp.zeros((n,))
    if config.num_emit_spheres > 0:
        # closest emissive sphere via the unrolled loop on the subset
        best_t = jnp.full((n,), BIG_T)
        best_k = jnp.zeros((n,), jnp.int32)
        for k in range(config.num_emit_spheres):
            sidx = buffers["emit_sph_ids"][k]
            m = buffers["sph_w2o"][sidx]
            o = v3.affine_point(m, org)
            d = v3.affine_vector(m, direction)
            a = d.dot(d)
            half_b = o.dot(d)
            c = o.dot(o) - 1.0
            disc = half_b * half_b - a * c
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            inv_a = 1.0 / jnp.maximum(a, 1e-20)
            root0 = (-half_b - sq) * inv_a
            root1 = (-half_b + sq) * inv_a
            ok = disc >= 0.0
            r0ok = ok & (root0 >= tminv) & (root0 <= tmaxv)
            r1ok = ok & (root1 >= tminv) & (root1 <= tmaxv)
            t = jnp.where(r0ok, root0, jnp.where(r1ok, root1, BIG_T))
            closer = t < best_t
            best_t = jnp.where(closer, t, best_t)
            best_k = jnp.where(closer, k, best_k)
        # cone pdf (lib.rs:1047-1066); radius from the o2w column norms so
        # rotated instance matrices keep sampler and pdf consistent, and a
        # uniform-sphere pdf when the shading point is inside the emitter
        # (where the cone degenerates; matches sample_emit_object)
        o2wT = buffers["sph_o2wT"]  # rows (12, S)
        sel = buffers["emit_sph_ids"][best_k]
        g = jnp.take(o2wT, sel, axis=1)
        radius = (jnp.sqrt(g[0] ** 2 + g[4] ** 2 + g[8] ** 2)
                  + jnp.sqrt(g[1] ** 2 + g[5] ** 2 + g[9] ** 2)
                  + jnp.sqrt(g[2] ** 2 + g[6] ** 2 + g[10] ** 2)) / 3.0
        center = V3(g[3], g[7], g[11])
        d2 = (center - org).length_squared()
        cos_max = jnp.sqrt(jnp.maximum(
            1.0 - radius * radius / jnp.maximum(d2, 1e-20), 0.0))
        inside = d2 <= radius * radius
        solid_angle = jnp.where(inside, 4.0 * math.pi,
                                2.0 * math.pi * (1.0 - cos_max))
        sph_t = best_t
        sph_pdf = 1.0 / jnp.maximum(solid_angle, 1e-20)

    use_sph = sph_t < tri_t
    t = jnp.minimum(tri_t, sph_t)
    pdf = jnp.where(use_sph, sph_pdf, tri_pdf)
    return jnp.where(t < BIG_T, pdf, 0.0)
