"""BSDF stack: material -> lobe slots, and vectorized f / pdf / sample_f.

Vectorized replacement for the reference's `Bsdf` (a stack of up to 5
`EnumBxdf` tagged unions, reflection.rs:228-343) plus the material dispatch
in material.rs. Two layout decisions drive the design (see vec3.py):

* **component-SoA**: all vector math runs on (N,) component arrays instead
  of (N,3) arrays;
* **unrolled lobe slots**: the up-to-5 lobe stack is a *python list* of slot
  dicts, not an (N,5,...) tensor — a matte-only scene carries exactly one
  slot with one live BxDF variant.

Scene-specialized compilation: every function takes the static RenderConfig
and only emits code for the material / BxDF / Fresnel / texture variants the
scene contains.

Lobe slots per material (material.rs):
  matte: lambertian | glass: fresnel-specular | substrate: fresnel-blend |
  metal: microfacet+conductor | mirror: specular+noop |
  plastic: lambertian + microfacet(dielectric 1.5->1.0) |
  uber: opacity spec-transmission, lambertian, microfacet, spec-reflection,
        spec-transmission (each only when its weight is nonzero).

Deviations (documented):
* plastic honors `remaproughness` (the reference stores the flag in u0.z but
  reads u1.z, material.rs:650-676, so it never remaps);
* GGX visible-normal sampling uses pbrt's correct G1 (see microfacet.py).
"""
from __future__ import annotations

import math
from typing import Dict, List

import jax.numpy as jnp

from ..scene import types as T
from . import fresnel as fr
from . import microfacet as mf
from . import rng
from . import vec3 as v3
from .texture import tex_color
from .vec3 import V3

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi

# kind bitflags per BxDF type (reflection/bxdf.rs kind() impls)
_KIND_OF = {
    T.BXDF_LAMBERTIAN: T.KIND_REFLECTION | T.KIND_DIFFUSE,
    T.BXDF_FRESNEL_SPECULAR: T.KIND_REFLECTION | T.KIND_TRANSMISSION,
    T.BXDF_FRESNEL_BLEND: T.KIND_REFLECTION | T.KIND_DIFFUSE,
    T.BXDF_MICROFACET_REFLECTION: T.KIND_REFLECTION | T.KIND_DIFFUSE,
    T.BXDF_SPECULAR_REFLECTION: T.KIND_REFLECTION,
    T.BXDF_SPECULAR_TRANSMISSION: T.KIND_TRANSMISSION,
}

_MAT_LOBES = {
    T.MAT_NONE: (),
    T.MAT_MATTE: (T.BXDF_LAMBERTIAN,),
    T.MAT_GLASS: (T.BXDF_FRESNEL_SPECULAR,),
    T.MAT_SUBSTRATE: (T.BXDF_FRESNEL_BLEND,),
    T.MAT_METAL: (T.BXDF_MICROFACET_REFLECTION,),
    T.MAT_MIRROR: (T.BXDF_SPECULAR_REFLECTION,),
    T.MAT_UBER: (T.BXDF_SPECULAR_TRANSMISSION, T.BXDF_LAMBERTIAN,
                 T.BXDF_MICROFACET_REFLECTION, T.BXDF_SPECULAR_REFLECTION),
    T.MAT_PLASTIC: (T.BXDF_LAMBERTIAN, T.BXDF_MICROFACET_REFLECTION),
}

_MAT_FRESNELS = {
    T.MAT_METAL: (T.FRESNEL_CONDUCTOR,),
    T.MAT_MIRROR: (T.FRESNEL_NOOP,),
    T.MAT_PLASTIC: (T.FRESNEL_DIELECTRIC,),
    T.MAT_UBER: (T.FRESNEL_DIELECTRIC,),
}

# texture payload slots each material reads (0..3 = u0.xyzw, 4..6 = u1.x/z/w)
_MAT_FETCHES = {
    T.MAT_NONE: (),
    T.MAT_MATTE: (0,),
    T.MAT_GLASS: (),
    T.MAT_SUBSTRATE: (0, 1, 2, 3),
    T.MAT_METAL: (0, 1, 2, 3),
    T.MAT_MIRROR: (0,),
    T.MAT_UBER: (0, 1, 2, 3, 4, 5, 6),
    T.MAT_PLASTIC: (0, 1, 3),
}


def lobe_types_for(config):
    out = []
    for mt in config.mat_types:
        for lt in _MAT_LOBES[mt]:
            if lt not in out:
                out.append(lt)
    return tuple(sorted(out))


def fresnel_types_for(config):
    out = []
    for mt in config.mat_types:
        for ft in _MAT_FRESNELS.get(mt, ()):
            if ft not in out:
                out.append(ft)
    return tuple(sorted(out))


def _kind_lookup(lobe_type):
    """Per-lane kind bits from the lobe tag (tiny where-chain)."""
    out = jnp.zeros(lobe_type.shape, jnp.int32)
    for lt, kind in _KIND_OF.items():
        out = jnp.where(lobe_type == lt, kind, out)
    return out


def _empty_slot(n):
    return {
        "type": jnp.zeros((n,), jnp.int32),
        "active": jnp.zeros((n,), bool),
        "v0": V3.zeros((n,)),
        "v1": V3.zeros((n,)),
        "ax": jnp.zeros((n,), jnp.float32),
        "ay": jnp.zeros((n,), jnp.float32),
        "fr_type": jnp.full((n,), T.FRESNEL_NOOP, jnp.int32),
        "fr_eta_i": V3.ones((n,)),
        "fr_eta_t": V3.ones((n,)),
        "fr_k": V3.zeros((n,)),
    }


def _set(slot, mask, ltype, v0=None, v1=None, ax=None, ay=None,
         fr_type=None, fr_eta_i=None, fr_eta_t=None, fr_k=None):
    slot["active"] = slot["active"] | mask
    slot["type"] = jnp.where(mask, ltype, slot["type"])
    if v0 is not None:
        slot["v0"] = v3.where(mask, v0, slot["v0"])
    if v1 is not None:
        slot["v1"] = v3.where(mask, v1, slot["v1"])
    if ax is not None:
        slot["ax"] = jnp.where(mask, ax, slot["ax"])
    if ay is not None:
        slot["ay"] = jnp.where(mask, ay, slot["ay"])
    if fr_type is not None:
        slot["fr_type"] = jnp.where(mask, fr_type, slot["fr_type"])
    if fr_eta_i is not None:
        slot["fr_eta_i"] = v3.where(mask, fr_eta_i, slot["fr_eta_i"])
    if fr_eta_t is not None:
        slot["fr_eta_t"] = v3.where(mask, fr_eta_t, slot["fr_eta_t"])
    if fr_k is not None:
        slot["fr_k"] = v3.where(mask, fr_k, slot["fr_k"])


# ---------------------------------------------------------------------------
# Material -> lobes
# ---------------------------------------------------------------------------

def compute_bsdf(buffers, mat_idx, uv, config) -> List[Dict]:
    """Build the lobe slot list for each ray. mat_idx (N,), uv (u, v)."""
    n = mat_idx.shape[0]
    mats = set(config.mat_types)
    mtype = buffers["mat_type"][mat_idx]
    u0 = buffers["mat_u0"][mat_idx]
    u1 = buffers["mat_u1"][mat_idx]
    v0x = buffers["mat_v0"][mat_idx, 0]

    need = set()
    for mt in mats:
        need.update(_MAT_FETCHES[mt])

    def fetch(slot_id, idx):
        if slot_id not in need:
            return V3.zeros((n,))
        return tex_color(buffers, idx, uv, config)

    t_u0x = fetch(0, u0[:, 0])
    t_u0y = fetch(1, u0[:, 1])
    t_u0z = fetch(2, u0[:, 2])
    t_u0w = fetch(3, u0[:, 3])
    t_u1x = fetch(4, u1[:, 0])
    t_u1z = fetch(5, u1[:, 2])
    t_u1w = fetch(6, u1[:, 3])

    L = config.max_lobes
    slots = [_empty_slot(n) for _ in range(L)]
    one3 = V3.ones((n,))

    def remap_alpha(flag, ru, rv):
        on = flag != 0
        return (jnp.where(on, mf.roughness_to_alpha(ru), ru),
                jnp.where(on, mf.roughness_to_alpha(rv), rv))

    if T.MAT_MATTE in mats:  # material.rs:117-136
        _set(slots[0], mtype == T.MAT_MATTE, T.BXDF_LAMBERTIAN, v0=t_u0x)

    if T.MAT_GLASS in mats:  # ir in lobe v0.x (material.rs:332-351)
        zn = jnp.zeros((n,), jnp.float32)
        _set(slots[0], mtype == T.MAT_GLASS, T.BXDF_FRESNEL_SPECULAR,
             v0=V3(v0x, zn, zn))

    if T.MAT_SUBSTRATE in mats:  # material.rs:187-226
        ax, ay = remap_alpha(u1[:, 0], t_u0z.x, t_u0w.x)
        _set(slots[0], mtype == T.MAT_SUBSTRATE, T.BXDF_FRESNEL_BLEND,
             v0=t_u0x, v1=t_u0y, ax=ax, ay=ay)

    if T.MAT_METAL in mats:  # material.rs:278-317
        ax, ay = remap_alpha(u1[:, 0], t_u0z.x, t_u0w.x)
        # mat_v0.xyz = optional conductor response scale (0 -> 1): the
        # --scene-overrides diagnostic knob for renderer-convention
        # divergence (the veach forensics, scene/overrides.py)
        mv = buffers["mat_v0"][mat_idx]
        fs = V3(jnp.where(mv[:, 0] == 0.0, 1.0, mv[:, 0]),
                jnp.where(mv[:, 1] == 0.0, 1.0, mv[:, 1]),
                jnp.where(mv[:, 2] == 0.0, 1.0, mv[:, 2]))
        _set(slots[0], mtype == T.MAT_METAL, T.BXDF_MICROFACET_REFLECTION,
             v0=fs, ax=ax, ay=ay, fr_type=T.FRESNEL_CONDUCTOR,
             fr_eta_i=one3, fr_eta_t=t_u0x, fr_k=t_u0y)

    if T.MAT_MIRROR in mats:  # material.rs:362-383
        _set(slots[0], mtype == T.MAT_MIRROR, T.BXDF_SPECULAR_REFLECTION,
             v0=t_u0x, fr_type=T.FRESNEL_NOOP)

    if T.MAT_PLASTIC in mats:  # material.rs:679-707; dielectric(1.5 -> 1.0)
        is_pl = mtype == T.MAT_PLASTIC
        a = jnp.where(u1[:, 2] != 0, mf.roughness_to_alpha(t_u0w.x), t_u0w.x)
        _set(slots[0], is_pl & t_u0x.any_nonzero(), T.BXDF_LAMBERTIAN,
             v0=t_u0x)
        _set(slots[1], is_pl & t_u0y.any_nonzero(),
             T.BXDF_MICROFACET_REFLECTION, v0=t_u0y, ax=a, ay=a,
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3 * 1.5,
             fr_eta_t=one3)

    if T.MAT_UBER in mats:  # material.rs:578-630
        is_uber = mtype == T.MAT_UBER
        eta = v0x
        eta3 = V3(eta, eta, eta)
        op = t_u1x
        t_op = 1.0 - op
        kr = op * t_u0z
        kt = op * t_u0w
        ax, ay = remap_alpha(u1[:, 1], t_u1z.x, t_u1w.x)
        one_s = jnp.ones((n,), jnp.float32)
        _set(slots[0], is_uber & t_op.any_nonzero(),
             T.BXDF_SPECULAR_TRANSMISSION, v0=t_op,
             v1=V3(one_s, one_s, one_s), fr_type=T.FRESNEL_DIELECTRIC,
             fr_eta_i=one3, fr_eta_t=one3)
        _set(slots[1], is_uber & t_u0x.any_nonzero(), T.BXDF_LAMBERTIAN,
             v0=t_u0x)
        _set(slots[2], is_uber & t_u0y.any_nonzero(),
             T.BXDF_MICROFACET_REFLECTION, v0=t_u0y, ax=ax, ay=ay,
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3, fr_eta_t=eta3)
        _set(slots[3], is_uber & kr.any_nonzero(),
             T.BXDF_SPECULAR_REFLECTION, v0=kr,
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3, fr_eta_t=eta3)
        _set(slots[4], is_uber & kt.any_nonzero(),
             T.BXDF_SPECULAR_TRANSMISSION, v0=kt,
             v1=V3(one_s, eta, jnp.zeros_like(eta)),
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3, fr_eta_t=eta3)

    return slots


def material_albedo(buffers, mat_idx, uv, config) -> V3:
    """EnumMaterial::albedo for the AOV (material.rs:719-736)."""
    mtype = buffers["mat_type"][mat_idx]
    u0 = buffers["mat_u0"][mat_idx]
    t_u0x = tex_color(buffers, u0[:, 0], uv, config)
    out = v3.where((mtype == T.MAT_MATTE) | (mtype == T.MAT_SUBSTRATE)
                   | (mtype == T.MAT_MIRROR) | (mtype == T.MAT_UBER)
                   | (mtype == T.MAT_PLASTIC), t_u0x, V3.zeros(mtype.shape))
    if T.MAT_METAL in config.mat_types:
        t_u0y = tex_color(buffers, u0[:, 1], uv, config)
        out = v3.where(mtype == T.MAT_METAL, t_u0y, out)
    return out


# ---------------------------------------------------------------------------
# Per-slot BxDF math (local frame; z = shading normal)
# ---------------------------------------------------------------------------

def _refract(wi: V3, n: V3, eta_ratio):
    """(ok, wt): refract wi about n (bxdf.rs:121-136)."""
    cos_i = n.dot(wi)
    sin2_i = jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = -wi * eta_ratio + n * (eta_ratio * cos_i - cos_t)
    return ok, wt


def _schlick(rs: V3, cos_theta) -> V3:
    v = 1.0 - cos_theta
    v5 = (v * v) * (v * v) * v
    return rs + (1.0 - rs) * v5


def _blend_f(slot, wo: V3, wi: V3) -> V3:
    """FresnelBlend::f (bxdf.rs:266-290)."""
    rd = slot["v0"]
    rs = slot["v1"]
    pow5 = lambda x: (x * x) * (x * x) * x
    diffuse = (rd * (1.0 - rs) * (28.0 / (23.0 * math.pi))
               * (1.0 - pow5(1.0 - 0.5 * v3.abs_cos_theta(wi)))
               * (1.0 - pow5(1.0 - 0.5 * v3.abs_cos_theta(wo))))
    wh_raw = wi + wo
    degenerate = wh_raw.length_squared() < 1e-18
    wh = wh_raw.normalized()
    denom = (4.0 * jnp.abs(wi.dot(wh))
             * jnp.maximum(v3.abs_cos_theta(wi), v3.abs_cos_theta(wo)))
    spec = _schlick(rs, wi.dot(wh)) \
        * (mf.tr_d(slot["ax"], slot["ay"], wh) / jnp.maximum(denom, 1e-20))
    return v3.where(degenerate, 0.0, diffuse + spec)


def _microfacet_f(slot, wo: V3, wi: V3, fr_types) -> V3:
    """MicrofacetReflection::f (bxdf.rs:361-383)."""
    ci = v3.abs_cos_theta(wi)
    co = v3.abs_cos_theta(wo)
    wh_raw = wi + wo
    bad = (ci == 0.0) | (co == 0.0) | (wh_raw.length_squared() < 1e-18)
    wh = wh_raw.normalized()
    # face_forward(wh, +z)
    wh = v3.where(wh.z < 0.0, -wh, wh)
    f_term = fr.evaluate(slot["fr_type"], slot["fr_eta_i"],
                         slot["fr_eta_t"], slot["fr_k"], wi.dot(wh),
                         fr_types)
    val = slot["v0"] * f_term * (
        mf.tr_d(slot["ax"], slot["ay"], wh)
        * mf.tr_g(slot["ax"], slot["ay"], wo, wi)
        / jnp.maximum(4.0 * ci * co, 1e-20))
    return v3.where(bad, 0.0, val)


def _slot_f(slot, wo: V3, wi: V3, lobe_types, fr_types) -> V3:
    t = slot["type"]
    out = V3.zeros(t.shape)
    if T.BXDF_LAMBERTIAN in lobe_types:
        out = v3.where(t == T.BXDF_LAMBERTIAN, slot["v0"] * INV_PI, out)
    if T.BXDF_FRESNEL_BLEND in lobe_types:
        out = v3.where(t == T.BXDF_FRESNEL_BLEND, _blend_f(slot, wo, wi),
                       out)
    if T.BXDF_MICROFACET_REFLECTION in lobe_types:
        out = v3.where(t == T.BXDF_MICROFACET_REFLECTION,
                       _microfacet_f(slot, wo, wi, fr_types), out)
    return out


def _slot_pdf(slot, wo: V3, wi: V3, lobe_types):
    t = slot["type"]
    same = v3.same_hemisphere(wo, wi)
    out = jnp.zeros(t.shape, jnp.float32)
    if T.BXDF_LAMBERTIAN in lobe_types:
        lam = jnp.where(same, v3.abs_cos_theta(wi) * INV_PI, 0.0)
        out = jnp.where(t == T.BXDF_LAMBERTIAN, lam, out)
    if (T.BXDF_FRESNEL_BLEND in lobe_types
            or T.BXDF_MICROFACET_REFLECTION in lobe_types):
        wh = (wo + wi).normalized()
        pdf_wh = mf.tr_pdf(slot["ax"], slot["ay"], wo, wh)
        denom = jnp.maximum(4.0 * wo.dot(wh), 1e-20)
        if T.BXDF_FRESNEL_BLEND in lobe_types:
            blend = jnp.where(same,
                              0.5 * (v3.abs_cos_theta(wi) * INV_PI
                                     + pdf_wh / denom), 0.0)
            out = jnp.where(t == T.BXDF_FRESNEL_BLEND, blend, out)
        if T.BXDF_MICROFACET_REFLECTION in lobe_types:
            micro = jnp.where(same, pdf_wh / denom, 0.0)
            out = jnp.where(t == T.BXDF_MICROFACET_REFLECTION, micro, out)
    return out


def sample_chosen(slot, wo: V3, u_coin, u1, u2, lobe_types, fr_types):
    """Sample the (already chosen) slot; pdf NOT yet divided by lobe count.
    Mirrors the sample_f impls in bxdf.rs with a shared 3-draw budget."""
    t = slot["type"]
    n = t.shape[0]
    wi = V3.zeros((n,))
    f = V3.zeros((n,))
    pdf = jnp.zeros((n,), jnp.float32)

    if (T.BXDF_LAMBERTIAN in lobe_types
            or T.BXDF_FRESNEL_BLEND in lobe_types):
        zc = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
        phi = TWO_PI * u1
        r2s = jnp.sqrt(u2)
        cos_dir = V3(jnp.cos(phi) * r2s, jnp.sin(phi) * r2s, zc)
        cos_dir = V3(cos_dir.x, cos_dir.y,
                     jnp.where(wo.z < 0.0, -cos_dir.z, cos_dir.z))

    if (T.BXDF_FRESNEL_BLEND in lobe_types
            or T.BXDF_MICROFACET_REFLECTION in lobe_types):
        wh = mf.tr_sample_wh(slot["ax"], slot["ay"], wo, u1, u2)

    if (T.BXDF_FRESNEL_SPECULAR in lobe_types
            or T.BXDF_SPECULAR_REFLECTION in lobe_types):
        wi_spec = V3(-wo.x, -wo.y, wo.z)

    if (T.BXDF_FRESNEL_SPECULAR in lobe_types
            or T.BXDF_SPECULAR_TRANSMISSION in lobe_types):
        zn = jnp.zeros((n,), jnp.float32)
        n_vec = V3(zn, zn, jnp.where(wo.z > 0.0, 1.0, -1.0))

    if T.BXDF_LAMBERTIAN in lobe_types:  # bxdf.rs:91-105
        sel = t == T.BXDF_LAMBERTIAN
        lam_pdf = jnp.where(v3.same_hemisphere(wo, cos_dir),
                            v3.abs_cos_theta(cos_dir) * INV_PI, 0.0)
        wi = v3.where(sel, cos_dir, wi)
        f = v3.where(sel, slot["v0"] * INV_PI, f)
        pdf = jnp.where(sel, lam_pdf, pdf)

    if T.BXDF_FRESNEL_SPECULAR in lobe_types:  # bxdf.rs:193-226
        sel = t == T.BXDF_FRESNEL_SPECULAR
        ir = slot["v0"].x
        f_diel = fr.fr_dielectric(v3.cos_theta(wo), jnp.ones_like(ir), ir)
        take_refl = u_coin < f_diel
        eta_ratio = jnp.where(v3.cos_theta(wo) > 0.0,
                              1.0 / jnp.maximum(ir, 1e-9), ir)
        ok_t, fs_wi_t = _refract(wo, n_vec, eta_ratio)
        fs_wi = v3.where(take_refl, wi_spec, fs_wi_t)
        fs_val = jnp.where(
            take_refl,
            f_diel / jnp.maximum(v3.abs_cos_theta(wi_spec), 1e-9),
            (1.0 - f_diel) / jnp.maximum(v3.abs_cos_theta(fs_wi_t), 1e-9))
        fs_pdf = jnp.where(take_refl, f_diel,
                           jnp.where(ok_t, 1.0 - f_diel, 0.0))
        wi = v3.where(sel, fs_wi, wi)
        f = v3.where(sel, V3(fs_val, fs_val, fs_val), f)
        pdf = jnp.where(sel, fs_pdf, pdf)

    if T.BXDF_FRESNEL_BLEND in lobe_types:  # bxdf.rs:292-317
        sel = t == T.BXDF_FRESNEL_BLEND
        take_cos = u_coin < 0.5
        wi_sp = v3.reflect(wo, wh)
        fb_wi = v3.where(take_cos, cos_dir, wi_sp)
        fb_bad = ~take_cos & ~v3.same_hemisphere(wo, wi_sp)
        fb_f = v3.where(fb_bad, 0.0, _blend_f(slot, wo, fb_wi))
        fb_wh = (wo + fb_wi).normalized()
        fb_pdf_wh = mf.tr_pdf(slot["ax"], slot["ay"], wo, fb_wh)
        fb_pdf = jnp.where(
            fb_bad | ~v3.same_hemisphere(wo, fb_wi), 0.0,
            0.5 * (v3.abs_cos_theta(fb_wi) * INV_PI
                   + fb_pdf_wh / jnp.maximum(4.0 * wo.dot(fb_wh), 1e-20)))
        wi = v3.where(sel, fb_wi, wi)
        f = v3.where(sel, fb_f, f)
        pdf = jnp.where(sel, fb_pdf, pdf)

    if T.BXDF_MICROFACET_REFLECTION in lobe_types:  # bxdf.rs:385-406
        sel = t == T.BXDF_MICROFACET_REFLECTION
        mr_wi = v3.reflect(wo, wh)
        mr_bad = ((wo.z == 0.0) | (wo.dot(wh) < 0.0)
                  | ~v3.same_hemisphere(wo, mr_wi))
        mr_pdf = jnp.where(
            mr_bad, 0.0,
            mf.tr_pdf(slot["ax"], slot["ay"], wo, wh)
            / jnp.maximum(4.0 * wo.dot(wh), 1e-20))
        mr_f = v3.where(mr_bad, 0.0, _microfacet_f(slot, wo, mr_wi,
                                                   fr_types))
        wi = v3.where(sel, mr_wi, wi)
        f = v3.where(sel, mr_f, f)
        pdf = jnp.where(sel, mr_pdf, pdf)

    if T.BXDF_SPECULAR_REFLECTION in lobe_types:  # bxdf.rs:437-443
        sel = t == T.BXDF_SPECULAR_REFLECTION
        sr_f = (fr.evaluate(slot["fr_type"], slot["fr_eta_i"],
                            slot["fr_eta_t"], slot["fr_k"],
                            v3.cos_theta(wi_spec), fr_types) * slot["v0"]
                * (1.0 / jnp.maximum(v3.abs_cos_theta(wi_spec), 1e-9)))
        wi = v3.where(sel, wi_spec, wi)
        f = v3.where(sel, sr_f, f)
        pdf = jnp.where(sel, 1.0, pdf)

    if T.BXDF_SPECULAR_TRANSMISSION in lobe_types:  # bxdf.rs:481-512
        sel = t == T.BXDF_SPECULAR_TRANSMISSION
        eta_a = slot["v1"].x
        eta_b = slot["v1"].y
        entering = v3.cos_theta(wo) > 0.0
        ei = jnp.where(entering, eta_a, eta_b)
        et = jnp.where(entering, eta_b, eta_a)
        ok, st_wi = _refract(wo, n_vec, ei / jnp.maximum(et, 1e-9))
        st_fr = fr.fr_dielectric(v3.cos_theta(st_wi), eta_a, eta_b)
        st_f = v3.where(
            ok,
            slot["v0"] * ((1.0 - st_fr)
                          / jnp.maximum(v3.abs_cos_theta(st_wi), 1e-9)),
            0.0)
        wi = v3.where(sel, st_wi, wi)
        f = v3.where(sel, st_f, f)
        pdf = jnp.where(sel, jnp.where(ok, 1.0, 0.0), pdf)

    return wi, f, pdf


# ---------------------------------------------------------------------------
# Bsdf aggregate (world-space interface)
# ---------------------------------------------------------------------------

def bsdf_contains(slots, kind):
    """Bsdf::contains (reflection.rs:268-283)."""
    out = jnp.zeros(slots[0]["type"].shape, bool)
    for s in slots:
        out = out | (s["active"] & ((_kind_lookup(s["type"]) & kind) != 0))
    return out


def bsdf_num_lobes(slots):
    num = slots[0]["active"].astype(jnp.int32)
    for s in slots[1:]:
        num = num + s["active"].astype(jnp.int32)
    return num


def bsdf_f(slots, onb: v3.Onb, ng: V3, wo_world: V3, wi_world: V3,
           config) -> V3:
    """Bsdf::f (reflection.rs:286-311): sum lobes on the reflect/transmit
    side of the *geometric* normal."""
    lobe_types = lobe_types_for(config)
    fr_types = fresnel_types_for(config)
    wo = onb.to_local(wo_world)
    wi = onb.to_local(wi_world)
    reflect_side = (wi_world.dot(ng) * wo_world.dot(ng)) > 0.0
    total = V3.zeros(wo.x.shape)
    for s in slots:
        kinds = _kind_lookup(s["type"])
        match = jnp.where(reflect_side, (kinds & T.KIND_REFLECTION) != 0,
                          (kinds & T.KIND_TRANSMISSION) != 0)
        val = _slot_f(s, wo, wi, lobe_types, fr_types)
        total = total + v3.where(match & s["active"], val, 0.0)
    return v3.where(wo.z == 0.0, 0.0, total)


def bsdf_pdf(slots, onb: v3.Onb, wo_world: V3, wi_world: V3, config):
    """Bsdf::pdf (reflection.rs:328-342): average over active lobes."""
    lobe_types = lobe_types_for(config)
    wo = onb.to_local(wo_world)
    wi = onb.to_local(wi_world)
    total = jnp.zeros(wo.x.shape, jnp.float32)
    for s in slots:
        total = total + jnp.where(s["active"],
                                  _slot_pdf(s, wo, wi, lobe_types), 0.0)
    num = jnp.maximum(bsdf_num_lobes(slots), 1)
    return total / num.astype(jnp.float32)


def bsdf_sample_f(slots, onb: v3.Onb, wo_world: V3, state, config):
    """Bsdf::sample_f (reflection.rs:313-326): uniform active-lobe choice.

    Returns (wi_world V3, f V3, pdf, new_state); pdf divided by the lobe
    count; all-zero when no lobes are active.
    """
    lobe_types = lobe_types_for(config)
    fr_types = fresnel_types_for(config)
    wo = onb.to_local(wo_world)
    num = bsdf_num_lobes(slots)

    if len(slots) == 1:
        chosen = slots[0]
    else:
        uidx, state = rng.next_u32(state)
        j = (uidx % jnp.maximum(num, 1).astype(jnp.uint32)).astype(jnp.int32)
        # pick the j-th ACTIVE slot with a running-rank where-chain
        chosen = {k: v for k, v in slots[0].items()}
        rank = slots[0]["active"].astype(jnp.int32) - 1  # rank of slot 0
        for s in slots[1:]:
            rank = rank + s["active"].astype(jnp.int32)
            take = s["active"] & (rank == j)
            for k in chosen:
                if isinstance(chosen[k], V3):
                    chosen[k] = v3.where(take, s[k], chosen[k])
                else:
                    chosen[k] = jnp.where(take, s[k], chosen[k])

    u_coin, state = rng.next_f32(state)
    u1, state = rng.next_f32(state)
    u2, state = rng.next_f32(state)
    wi, f, pdf = sample_chosen(chosen, wo, u_coin, u1, u2, lobe_types,
                               fr_types)
    pdf = pdf / jnp.maximum(num, 1).astype(jnp.float32)
    empty = num == 0
    wi_world = onb.to_world(wi)
    return (v3.where(empty, 0.0, wi_world), v3.where(empty, 0.0, f),
            jnp.where(empty, 0.0, pdf), state)
