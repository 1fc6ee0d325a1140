"""Component-SoA 3-vectors: the vector math core.

V3 stores the x, y, z components of N vectors as three independent (N,)
arrays instead of one (N, 3) array, so every elementwise op works on
contiguous ray-major data with no minor dimension of 3, and XLA fuses the
component chains like hand-written scalar code.

V3 is a pytree (works through jit / while_loop carries) and supports the
vector algebra the renderer needs. Use `V3.from_array` / `.to_array` at HBM
buffer boundaries (gathers of (T,3) tables) and keep everything V3 inside
the compute.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_array(a):
        """(..., 3) array -> V3 of (...) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def fill(v, shape=(), dtype=jnp.float32):
        c = jnp.full(shape, v, dtype)
        return V3(c, c, c)

    @staticmethod
    def of(x, y, z):
        return V3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                  jnp.asarray(z, jnp.float32))

    @staticmethod
    def zeros(shape=(), dtype=jnp.float32):
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)

    @staticmethod
    def ones(shape=(), dtype=jnp.float32):
        o = jnp.ones(shape, dtype)
        return V3(o, o, o)

    def to_array(self):
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- algebra -------------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return V3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry ------------------------------------------------------------
    def dot(self, o: "V3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def length_squared(self):
        return self.dot(self)

    def length(self):
        return jnp.sqrt(jnp.maximum(self.length_squared(), 0.0))

    def normalized(self, eps=1e-20):
        inv = 1.0 / jnp.maximum(self.length(), eps)
        return self * inv

    def abs(self) -> "V3":
        return V3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def max_component(self):
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def sum(self):
        return self.x + self.y + self.z

    def any_nonzero(self):
        return (self.x != 0.0) | (self.y != 0.0) | (self.z != 0.0)

    def exp(self) -> "V3":
        return V3(jnp.exp(self.x), jnp.exp(self.y), jnp.exp(self.z))

    def map(self, fn) -> "V3":
        return V3(fn(self.x), fn(self.y), fn(self.z))


def where(mask, a, b) -> V3:
    """Component select; mask is (...,) (no trailing vec dim)."""
    if not isinstance(a, V3):
        a = V3.fill(a)
    if not isinstance(b, V3):
        b = V3.fill(b)
    return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
              jnp.where(mask, a.z, b.z))


def face_forward(v: V3, ref: V3) -> V3:
    return where(v.dot(ref) < 0.0, -v, v)


def reflect(wo: V3, n: V3) -> V3:
    return -wo + n * (2.0 * wo.dot(n))


def coordinate_system(v1: V3):
    """Branch-free port of math.rs:89-97; returns (v2, v3)."""
    x_major = jnp.abs(v1.x) > jnp.abs(v1.y)
    inv = 1.0 / jnp.sqrt(jnp.maximum(
        jnp.where(x_major, v1.x * v1.x + v1.z * v1.z,
                  v1.y * v1.y + v1.z * v1.z), 1e-20))
    zero = jnp.zeros_like(inv)
    v2 = V3(jnp.where(x_major, -v1.z, zero) * inv,
            jnp.where(x_major, zero, v1.z) * inv,
            jnp.where(x_major, v1.x, -v1.y) * inv)
    return v2, v1.cross(v2)


class Onb(NamedTuple):
    u: V3
    v: V3
    w: V3

    @staticmethod
    def from_w(w: V3) -> "Onb":
        u, v = coordinate_system(w)
        return Onb(u, v, w)

    def to_local(self, vec: V3) -> V3:
        return V3(vec.dot(self.u), vec.dot(self.v), vec.dot(self.w))

    def to_world(self, vec: V3) -> V3:
        return self.u * vec.x + self.v * vec.y + self.w * vec.z


# local-frame trig on V3 (z = normal)
def cos_theta(w: V3):
    return w.z


def cos2_theta(w: V3):
    return w.z * w.z


def abs_cos_theta(w: V3):
    return jnp.abs(w.z)


def sin2_theta(w: V3):
    return jnp.maximum(1.0 - w.z * w.z, 0.0)


def sin_theta(w: V3):
    return jnp.sqrt(sin2_theta(w))


def tan_theta(w: V3):
    return sin_theta(w) / w.z


def tan2_theta(w: V3):
    return sin2_theta(w) / jnp.maximum(cos2_theta(w), 1e-30)


def cos_phi(w: V3):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 1.0,
                     jnp.clip(w.x / jnp.maximum(s, 1e-20), -1.0, 1.0))


def sin_phi(w: V3):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 0.0,
                     jnp.clip(w.y / jnp.maximum(s, 1e-20), -1.0, 1.0))


def cos2_phi(w: V3):
    c = cos_phi(w)
    return c * c


def sin2_phi(w: V3):
    s = sin_phi(w)
    return s * s


def same_hemisphere(a: V3, b: V3):
    return a.z * b.z > 0.0


def sphere_uv(p: V3):
    """Unit direction -> (u, v) scalars (math.rs:70-76)."""
    import math
    theta = jnp.arccos(jnp.clip(p.z, -1.0, 1.0))
    phi = jnp.arctan2(p.y, p.x)
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return phi * (0.5 / math.pi), (theta - math.pi) * (-1.0 / math.pi)


def affine_point(m, p: V3) -> V3:
    """Apply a single (3,4) affine (host constant or traced) to V3 points."""
    return V3(m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3],
              m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3],
              m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3])


def affine_vector(m, v: V3) -> V3:
    return V3(m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
              m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
              m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z)


def affine_point_rows(rows, p: V3) -> V3:
    """Per-lane affine: rows is a V3-like tuple of 4 gathered row tuples —
    rows[i][j] are (N,) arrays for i in 0..2, j in 0..3."""
    return V3(rows[0][0] * p.x + rows[0][1] * p.y + rows[0][2] * p.z
              + rows[0][3],
              rows[1][0] * p.x + rows[1][1] * p.y + rows[1][2] * p.z
              + rows[1][3],
              rows[2][0] * p.x + rows[2][1] * p.y + rows[2][2] * p.z
              + rows[2][3])
