"""Brute-force triangle intersection via Plücker coordinates, as matmuls.

Instead of per-triangle Möller–Trumbore, the three edge side-tests of a ray
against a triangle are *linear* in the ray's Plücker coordinates
(d, w = o x d):

    side(edge a->b) = d . (a x b) + w . (b - a)

so testing N rays against C triangles is one (3C,6) @ (6,N) matmul, plus a
(C,4) @ (4,N) and a (C,3) @ (3,N) matmul for the plane-equation t values
(t = (k - o.n)/(d.n)). A ray hits when all three sides share a sign
(watertight along shared edges up to f32 rounding, no backface culling —
matching the reference's un-culled RT pipeline, main.rs:3078-3105).

Precision: every dot runs at `lax.Precision.HIGHEST`, i.e. full float32
products. A GPU may otherwise run a float32 dot in TF32 (10-bit mantissa),
which flips the sign test on shared edges and moves the plane t by far
more than the integrators' TMIN of 1e-3 (integrators/path.py).

Layout: everything is kept in the (C, N) orientation — ray features stack
along axis 0 (a concat of (N,) component arrays) and all per-candidate
tensors have the ray dimension minor, so no (N, 6) transpose of the ray
features is needed.

Barycentrics for the winning triangle come from the signed side values:
with edges E0: v0->v1, E1: v1->v2, E2: v2->v0,
  bary(v1) = s2/(s0+s1+s2), bary(v2) = s0/(s0+s1+s2)
which equals the Vulkan hit attribute (u, v) convention (lib.rs:926).

Used for scenes below a triangle-count threshold (cornell-box, veach-mis,
sphere/cube); larger scenes go through the BVH.
"""
from __future__ import annotations

import numpy as np


class MXUIntersector:
    """Precomputed triangle constant matrices + the matmul test."""

    def __init__(self, tri_p: np.ndarray):
        tri_p = np.asarray(tri_p, np.float64)
        ntri = tri_p.shape[0]
        pad = (-ntri) % 8
        self.num_tris = ntri
        self.padded = ntri + pad
        v0 = np.concatenate([tri_p[:, 0], np.zeros((pad, 3))], 0)
        v1 = np.concatenate([tri_p[:, 1], np.zeros((pad, 3))], 0)
        v2 = np.concatenate([tri_p[:, 2], np.ones((pad, 3))], 0)

        def edge_rows(a, b):
            # side = d . (a x b) + (o x d) . (b - a)
            m = np.cross(a, b)      # dotted with d
            e = b - a               # dotted with w
            return np.concatenate([m, e], axis=1)  # (C,6)

        # B rows: contiguous blocks [E0 | E1 | E2] -> (3C, 6)
        self.B = np.ascontiguousarray(np.concatenate(
            [edge_rows(v0, v1), edge_rows(v1, v2), edge_rows(v2, v0)],
            axis=0), np.float32)

        n = np.cross(v1 - v0, v2 - v0)  # (C,3) geometric normal
        k = np.sum(n * v0, axis=1)      # plane offset
        # P rows: [-n | k] gives (k - o.n) against [o;1]; [n] gives d.n
        self.P_on = np.ascontiguousarray(
            np.concatenate([-n, k[:, None]], axis=1), np.float32)  # (C,4)
        self.P_dn = np.ascontiguousarray(n, np.float32)            # (C,3)
        self._device = None

    def to_device(self):
        import jax.numpy as jnp
        self._device = {
            "B": jnp.asarray(self.B),
            "P_on": jnp.asarray(self.P_on),
            "P_dn": jnp.asarray(self.P_dn),
        }
        return self

    def intersect(self, org, direction, tmin, tmax, want_bary=False):
        """Closest hit: returns (t, prim_id[, u, v]).

        org/direction: V3 component vectors (or (N,3) arrays).
        """
        import jax
        import jax.numpy as jnp

        from .vec3 import V3

        if self._device is None:
            self.to_device()
        d = self._device
        C = self.padded
        if not isinstance(org, V3):
            org = V3.from_array(org)
            direction = V3.from_array(direction)
        n = org.x.shape[0]

        w = org.cross(direction)
        featT = jnp.stack([direction.x, direction.y, direction.z,
                           w.x, w.y, w.z], axis=0)          # (6, N)
        onT = jnp.stack([org.x, org.y, org.z, jnp.ones_like(org.x)],
                        axis=0)                              # (4, N)
        dT = featT[:3]                                       # (3, N)

        hi = jax.lax.Precision.HIGHEST
        s = jnp.dot(d["B"], featT, precision=hi,
                    preferred_element_type=jnp.float32)
        s0 = s[:C]
        s1 = s[C:2 * C]
        s2 = s[2 * C:]
        pos = (s0 >= 0) & (s1 >= 0) & (s2 >= 0)
        neg = (s0 <= 0) & (s1 <= 0) & (s2 <= 0)

        pp = jnp.dot(d["P_on"], onT, precision=hi,
                     preferred_element_type=jnp.float32)
        dn = jnp.dot(d["P_dn"], dT, precision=hi,
                     preferred_element_type=jnp.float32)
        t = pp / jnp.where(jnp.abs(dn) > 1e-12, dn, 1e-12)

        valid = ((pos | neg) & (jnp.abs(dn) > 1e-12)
                 & (t >= tmin[None, :]) & (t <= tmax[None, :]))
        if self.padded != self.num_tris:
            row = jax.lax.broadcasted_iota(jnp.int32, (C, 1), 0)
            valid = valid & (row < self.num_tris)
        t = jnp.where(valid, t, jnp.float32(1e30))
        best = jnp.argmin(t, axis=0).astype(jnp.int32)       # (N,)
        tbest = jnp.min(t, axis=0)
        if not want_bary:
            return tbest, best

        # onehot row-select of the winning side values
        row = jax.lax.broadcasted_iota(jnp.int32, (C, 1), 0)
        onehot = (row == best[None, :]).astype(jnp.float32)  # (C, N)
        bs0 = jnp.sum(onehot * s0, axis=0)
        bs1 = jnp.sum(onehot * s1, axis=0)
        bs2 = jnp.sum(onehot * s2, axis=0)
        denom = bs0 + bs1 + bs2
        denom = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        u = bs2 / denom  # bary(v1)
        v = bs0 / denom  # bary(v2)
        return tbest, best, u, v

    def occluded(self, org, direction, tmin, tmax):
        t, _ = self.intersect(org, direction, tmin, tmax)
        return t < 1e29
