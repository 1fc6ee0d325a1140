"""Trowbridge–Reitz (GGX) microfacet distribution, component-SoA.

Port of rene-shader/src/reflection/microfacet.rs (itself pbrt-v3) to
branch-free jnp over (N,) component arrays (see vec3.py for the layout
rationale): `d`, Smith `lambda`/`g`/`g1`, visible-normal sampling
`sample_wh`, `pdf`, and `roughness_to_alpha`.

Deviation (documented): the reference's `trowbridge_reitz_sample11`
mis-parenthesizes the G1 term (`2/(2+1/|a|)` instead of pbrt's
`2/(1+sqrt(1+1/a^2))`, microfacet.rs:91), biasing its visible-normal
sampling; we use the correct pbrt formula.
"""
from __future__ import annotations

import math
import os

import jax.numpy as jnp

from . import vec3 as v3
from .vec3 import V3

PI = math.pi
TWO_PI = 2.0 * math.pi


def _beckmann():
    """RENE_MF_DIST=beckmann swaps the distribution to Beckmann (D +
    pbrt's rational-fit lambda + full-normal sampling with matching
    pdf) — a diagnostic for the veach lobe-shape residual. Read at
    trace time."""
    return os.environ.get("RENE_MF_DIST", "") == "beckmann"


def roughness_to_alpha(roughness):
    """pbrt roughness remap (microfacet.rs:65-74)."""
    r = jnp.maximum(roughness, 1e-3)
    x = jnp.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def tr_d(ax, ay, wh: V3):
    """GGX normal distribution (microfacet.rs:141-155)."""
    tan2 = v3.tan2_theta(wh)
    cos4 = v3.cos2_theta(wh) ** 2
    e = (v3.cos2_phi(wh) / jnp.maximum(ax * ax, 1e-20)
         + v3.sin2_phi(wh) / jnp.maximum(ay * ay, 1e-20)) * tan2
    if _beckmann():
        d = jnp.exp(-jnp.minimum(e, 80.0)) / jnp.maximum(
            PI * ax * ay * cos4, 1e-30)
    else:
        d = 1.0 / jnp.maximum(PI * ax * ay * cos4 * (1.0 + e) ** 2, 1e-30)
    return jnp.where(jnp.isfinite(tan2) & jnp.isfinite(d), d, 0.0)


def tr_lambda(ax, ay, w: V3):
    """Exact GGX Smith lambda: (-1 + sqrt(1 + alpha^2 tan^2)) / 2.

    The reference (microfacet.rs:157-174) copied pbrt's *Beckmann*
    rational fit into its Trowbridge-Reitz lambda; pbrt-v3 proper and
    Tungsten (the golden renders) use the exact closed form. The fit
    underestimates lambda at grazing incidence (GGX's tails are heavier
    than Beckmann's), brightening grazing highlights — measurable on the
    veach-mis plates — so we use the exact form. It is also the exact
    inverse of the sample11 visible-normal sampler."""
    abs_tan = jnp.abs(v3.tan_theta(w))
    alpha = jnp.sqrt(v3.cos2_phi(w) * ax * ax + v3.sin2_phi(w) * ay * ay)
    if _beckmann():
        a = 1.0 / jnp.maximum(alpha * abs_tan, 1e-9)
        lam = jnp.where(
            a >= 1.6, 0.0,
            (1.0 - 1.259 * a + 0.396 * a * a)
            / jnp.maximum(3.535 * a + 2.181 * a * a, 1e-9))
        return jnp.where(jnp.isfinite(abs_tan), lam, 0.0)
    at2 = (alpha * abs_tan) ** 2
    lam = 0.5 * (-1.0 + jnp.sqrt(1.0 + at2))
    return jnp.where(jnp.isfinite(abs_tan), lam, 0.0)


def tr_g(ax, ay, wo: V3, wi: V3):
    return 1.0 / (1.0 + tr_lambda(ax, ay, wo) + tr_lambda(ax, ay, wi))


def tr_g1(ax, ay, w: V3):
    return 1.0 / (1.0 + tr_lambda(ax, ay, w))


def _sample11(cos_theta, u1, u2):
    """Visible-normal slope sampling (pbrt TrowbridgeReitzSample11)."""
    r_s = jnp.sqrt(u1 / jnp.maximum(1.0 - u1, 1e-9))
    phi_s = TWO_PI * u2
    special_x = r_s * jnp.cos(phi_s)
    special_y = r_s * jnp.sin(phi_s)

    c = jnp.clip(cos_theta, -1.0, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
    tan_t = sin_t / jnp.maximum(c, 1e-9)
    a0 = 1.0 / jnp.maximum(tan_t, 1e-9)
    g1 = 2.0 / (1.0 + jnp.sqrt(1.0 + 1.0 / (a0 * a0)))

    a = 2.0 * u1 / jnp.maximum(g1, 1e-9) - 1.0
    tmp = jnp.minimum(1.0 / jnp.where(jnp.abs(a * a - 1.0) > 1e-12,
                                      a * a - 1.0, 1e-12), 1e10)
    b = tan_t
    d = jnp.sqrt(jnp.maximum(b * b * tmp * tmp - (a * a - b * b) * tmp, 0.0))
    slope_x_1 = b * tmp - d
    slope_x_2 = b * tmp + d
    slope_x = jnp.where((a < 0.0) | (slope_x_2 > a0), slope_x_1, slope_x_2)

    s = jnp.where(u2 > 0.5, 1.0, -1.0)
    u2f = jnp.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = ((u2f * (u2f * (u2f * 0.27385 - 0.73369) + 0.46341))
         / (u2f * (u2f * (u2f * 0.093073 + 0.309420) - 1.0) + 0.597999))
    slope_y = s * z * jnp.sqrt(1.0 + slope_x * slope_x)

    take_special = cos_theta > 0.9999
    return (jnp.where(take_special, special_x, slope_x),
            jnp.where(take_special, special_y, slope_y))


def tr_sample_wh(ax, ay, wo: V3, u1, u2) -> V3:
    """Sample a visible microfacet normal (microfacet.rs:124-190)."""
    if _beckmann():
        return _beckmann_sample_wh(ax, ay, wo, u1, u2)
    flip = wo.z < 0.0
    w = v3.where(flip, -wo, wo)
    stretched = V3(ax * w.x, ay * w.y, w.z).normalized()
    sx, sy = _sample11(v3.cos_theta(stretched), u1, u2)
    cp = v3.cos_phi(stretched)
    sp = v3.sin_phi(stretched)
    slope_x = ax * (cp * sx - sp * sy)
    slope_y = ay * (sp * sx + cp * sy)
    wh = V3(-slope_x, -slope_y, jnp.ones_like(slope_x)).normalized()
    return v3.where(flip, -wh, wh)


def _beckmann_sample_wh(ax, ay, wo: V3, u1, u2) -> V3:
    """Full-normal Beckmann sampling (pbrt Sample_wh, non-visible);
    elliptical phi without atan: (cos,sin)phi ∝ (ax cos t, ay sin t)."""
    t = TWO_PI * u2
    rx = ax * jnp.cos(t)
    ry = ay * jnp.sin(t)
    rn = jnp.sqrt(jnp.maximum(rx * rx + ry * ry, 1e-30))
    cphi, sphi = rx / rn, ry / rn
    logs = jnp.log(jnp.maximum(1.0 - u1, 1e-9))
    tan2 = -logs / jnp.maximum(
        cphi * cphi / jnp.maximum(ax * ax, 1e-20)
        + sphi * sphi / jnp.maximum(ay * ay, 1e-20), 1e-20)
    cz = 1.0 / jnp.sqrt(1.0 + tan2)
    sz = jnp.sqrt(jnp.maximum(1.0 - cz * cz, 0.0))
    wh = V3(sz * cphi, sz * sphi, cz)
    return v3.where(wo.z < 0.0, -wh, wh)


def tr_pdf(ax, ay, wo: V3, wh: V3):
    """Visible-normal pdf of wh (microfacet.rs:192-194); under the
    Beckmann diagnostic, the full-normal pdf D |cos wh| to match the
    full-normal sampler."""
    if _beckmann():
        return tr_d(ax, ay, wh) * v3.abs_cos_theta(wh)
    return (tr_d(ax, ay, wh) * tr_g1(ax, ay, wo) * jnp.abs(wo.dot(wh))
            / jnp.maximum(v3.abs_cos_theta(wo), 1e-9))
