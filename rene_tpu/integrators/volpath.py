"""Wavefront volumetric path tracer (the reference's `volpath` integrator).

Port of main_ray_generation_volpath (rene-shader/src/lib.rs:477-803) plus
the `tr`/`tr_emit` transmittance marchers (lib.rs:359-468) to component-SoA
masked wavefront form with path regeneration (see path.py). Per bounce:

  1. closest-hit trace; miss -> background;
  2. sample the current medium along the segment (per-channel distance
     sampling); throughput *= medium weight;
  3. medium interaction: phase-function NEE to distant lights through `tr`
     marching, emitter NEE through `tr_emit` (+ pdf trace against the
     emissive set), then Henyey–Greenstein scattering;
  4. surface interaction: like the `path` integrator but with
     transmittance-weighted NEE; `None`-material surfaces pass through;
     the medium index tracks interior/exterior crossings (lib.rs:775-779);
  5. no Russian roulette (disabled in the reference, lib.rs:787-799).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import bsdf as B
from ..ops import intersect as I
from ..ops import medium as MD
from ..ops import rng
from ..ops import vec3 as v3
from ..ops.vec3 import V3
from ..scene import types as T
from ..scene.device import RenderConfig
from .camera import generate_rays
from .common import background_radiance, sample_emit_object

TMIN = 1e-3
TMAX = 1e5
MAX_TR_MARCH = 32


def max_depth_for(config: RenderConfig) -> int:
    if config.max_depth_hint is not None:
        return max(int(config.max_depth_hint), 1)
    return 80  # reference lib.rs:499


def _gather3(table, idx) -> V3:
    return V3(table[idx, 0], table[idx, 1], table[idx, 2])


def _tr_march(buffers, config, org: V3, direction: V3, med_idx, accel=None,
              want_emit=False):
    """tr / tr_emit (lib.rs:359-468): march transmittance through
    `None`-material boundaries; returns V3 transmittance (or emitter
    radiance for tr_emit)."""
    n = org.x.shape[0]
    carry = {
        "org": org,
        "med": med_idx,
        "tr": V3.ones((n,)),
        "out": V3.zeros((n,)),
        "live": jnp.ones((n,), bool),
        "k": jnp.int32(0),
    }

    def cond(c):
        return jnp.any(c["live"]) & (c["k"] < MAX_TR_MARCH)

    def body(c):
        hit = I.trace(buffers, config, c["org"], direction, TMIN, TMAX,
                      accel=accel)
        live = c["live"]
        inst = hit["inst"]
        mat_none = buffers["mat_type"][
            buffers["inst_material"][inst]] == T.MAT_NONE
        al_idx = buffers["inst_area_light"][inst]
        is_emitter = buffers["area_type"][al_idx] != T.AREA_NULL

        out = c["out"]
        if want_emit:
            wo = -direction.normalized()
            nrm = hit["normal"].normalized()
            emit = v3.where(wo.dot(nrm) > 0.0,
                            _gather3(buffers["area_color"], al_idx), 0.0)
            take = live & hit["hit"] & is_emitter
            out = out + v3.where(take, c["tr"] * emit, 0.0)
            stop = ~hit["hit"] | is_emitter | (~is_emitter & ~mat_none)
        else:
            take = live & ~hit["hit"]
            out = out + v3.where(take, c["tr"], 0.0)
            stop = ~hit["hit"] | ~mat_none

        seg_tr = MD.med_tr(buffers, c["med"], direction, hit["t"])
        cont = live & ~stop
        new_tr = v3.where(cont, c["tr"] * seg_tr, c["tr"])
        crossing_out = direction.dot(hit["normal"]) > 0.0
        new_med = jnp.where(
            cont,
            jnp.where(crossing_out, buffers["inst_exterior"][inst],
                      buffers["inst_interior"][inst]),
            c["med"])
        new_org = v3.where(cont, hit["position"], c["org"])
        return {"org": new_org, "med": new_med, "tr": new_tr, "out": out,
                "live": cont, "k": c["k"] + 1}

    out = jax.lax.while_loop(cond, body, carry)
    return out["out"]


def render_batch(buffers, config: RenderConfig, px, py, seed, num_samples,
                 accel=None):
    """volpath with path regeneration: each lane streams `num_samples`
    samples of its own pixel; returns summed outputs."""
    n = px.shape[0]
    w = config.film.xresolution
    pix_index = (py.astype(jnp.uint32) * jnp.uint32(w)
                 + px.astype(jnp.uint32))
    state = rng.pcg_init(pix_index ^ jnp.uint32(seed))
    org, direction, state = generate_rays(buffers, config, px, py, state)

    max_depth = max_depth_for(config)
    num_emit = config.num_emit_objects

    carry = {
        "state": state,
        "org": org,
        "dir": direction,
        "color": V3.ones((n,)),
        "depth": jnp.zeros((n,), jnp.int32),
        "sample": jnp.zeros((n,), jnp.int32),
        "radiance": V3.zeros((n,)),
        "med": jnp.zeros((n,), jnp.int32),
        "aov_normal": V3.zeros((n,)),
        "aov_albedo": V3.zeros((n,)),
        "rays": jnp.zeros((), jnp.float32),
    }

    def cond(c):
        return jnp.any(c["sample"] < num_samples)

    def body(c):
        state = c["state"]
        active = c["sample"] < num_samples
        color = c["color"]
        radiance = c["radiance"]
        med = c["med"]
        depth = c["depth"]
        rays = c["rays"] + jnp.sum(active.astype(jnp.float32)) \
            * (1.0 + config.num_lights + (1.0 if num_emit > 0 else 0.0))

        hit = I.trace(buffers, config, c["org"], c["dir"], TMIN, TMAX,
                      accel=accel)
        bg = background_radiance(buffers, c["dir"], config)
        miss = active & ~hit["hit"]
        radiance = radiance + v3.where(miss, color * bg, 0.0)
        alive = active & hit["hit"]

        wo = -c["dir"].normalized()
        normal = hit["normal"].normalized()
        position = hit["position"]
        uv = hit["uv"]
        inst = hit["inst"]
        mat_idx = buffers["inst_material"][inst]
        al_idx = buffers["inst_area_light"][inst]
        mat_none = buffers["mat_type"][mat_idx] == T.MAT_NONE

        # -- medium sampling along the segment (lib.rs:561-565)
        sampled, mpos, mtr, state = MD.med_sample(
            buffers, med, c["org"], c["dir"], hit["t"], state)
        sampled = sampled & alive
        color = v3.where(alive, color * mtr, color)

        # =================== medium interaction ===================
        # distant-light NEE as loops (path.py: program size stays flat in
        # the light count)
        def medium_nee(li, radiance):
            ld = buffers["light_dir"][li]
            lc = buffers["light_color"][li]
            wi_l = V3(jnp.broadcast_to(ld[0], position.x.shape),
                      jnp.broadcast_to(ld[1], position.x.shape),
                      jnp.broadcast_to(ld[2], position.x.shape))
            trv = _tr_march(buffers, config, mpos, wi_l, med, accel=accel)
            phase = MD.med_phase(buffers, med, wo, wi_l)
            return radiance + v3.where(
                sampled, color * trv * phase * V3(lc[0], lc[1], lc[2]), 0.0)

        if config.num_lights:
            radiance = jax.lax.fori_loop(0, config.num_lights, medium_nee,
                                         radiance)

        m_dir, state = MD.med_sample_p(buffers, med, wo, state)
        if num_emit > 0:
            ls_wi, state = sample_emit_object(buffers, config, mpos, state)
            epdf = I.trace_emissive_pdf(buffers, config, mpos, ls_wi,
                                        TMIN, TMAX, accel=accel) / num_emit
            tr_e = _tr_march(buffers, config, mpos, ls_wi, med,
                             accel=accel, want_emit=True)
            phase_e = MD.med_phase(buffers, med, wo, ls_wi)
            radiance = radiance + v3.where(
                sampled & (epdf > 1e-5),
                color * tr_e * (phase_e / jnp.maximum(epdf, 1e-5)), 0.0)

        # =================== surface interaction ===================
        surf = alive & ~sampled
        onb = v3.Onb.from_w(normal)
        lobes = B.compute_bsdf(buffers, mat_idx, uv, config)

        al_color = _gather3(buffers["area_color"], al_idx)
        al_on = (buffers["area_type"][al_idx] != T.AREA_NULL) \
            & (wo.dot(normal) > 0.0)
        radiance = radiance + v3.where(surf & al_on, color * al_color, 0.0)

        first = surf & (depth == 0)
        albedo = B.material_albedo(buffers, mat_idx, uv, config)
        aov_normal = c["aov_normal"] + v3.where(first, normal, 0.0)
        aov_albedo = c["aov_albedo"] + v3.where(first, albedo, 0.0)

        surf_scatter = surf & ~mat_none
        def surface_nee(li, radiance):
            ld = buffers["light_dir"][li]
            lc = buffers["light_color"][li]
            wi_l = V3(jnp.broadcast_to(ld[0], position.x.shape),
                      jnp.broadcast_to(ld[1], position.x.shape),
                      jnp.broadcast_to(ld[2], position.x.shape))
            trv = _tr_march(buffers, config, position, wi_l, med,
                            accel=accel)
            f_l = B.bsdf_f(lobes, onb, normal, wo, wi_l, config)
            return radiance + v3.where(
                surf_scatter,
                color * trv * f_l * jnp.abs(wi_l.dot(normal))
                * V3(lc[0], lc[1], lc[2]), 0.0)

        if config.num_lights:
            radiance = jax.lax.fori_loop(0, config.num_lights, surface_nee,
                                         radiance)

        swi, sf, spdf, state = B.bsdf_sample_f(lobes, onb, wo, state, config)
        if num_emit > 0:
            coin, state = rng.next_f32(state)
            ls_wi, state = sample_emit_object(buffers, config, position,
                                              state)
            take_light = coin > 0.5
            use_mis = B.bsdf_contains(lobes, T.KIND_DIFFUSE)
            sel_l = use_mis & take_light
            wi_s = v3.where(sel_l, ls_wi, swi)
            f_s = v3.where(sel_l,
                           B.bsdf_f(lobes, onb, normal, wo, ls_wi, config),
                           sf)
            pdf_b = jnp.where(sel_l,
                              B.bsdf_pdf(lobes, onb, wo, ls_wi, config),
                              spdf)
            light_pdf = I.trace_emissive_pdf(
                buffers, config, position, wi_s, TMIN, TMAX,
                accel=accel) / num_emit
            pdf_s = jnp.where(use_mis, 0.5 * pdf_b + 0.5 * light_pdf, spdf)
            f_s = v3.where(use_mis, f_s, sf)
            wi_s = v3.where(use_mis, wi_s, swi)
        else:
            wi_s, f_s, pdf_s = swi, sf, spdf

        surf_color = color * f_s * (jnp.abs(normal.dot(wi_s))
                                    / jnp.maximum(pdf_s, 1e-20))

        # -- select next ray per lane kind
        new_org = v3.where(sampled, mpos,
                           v3.where(surf, position, c["org"]))
        new_dir = v3.where(sampled, m_dir,
                           v3.where(surf_scatter, wi_s, c["dir"]))
        color = v3.where(surf_scatter, surf_color, color)
        alive = alive & (sampled | (surf & (mat_none | (pdf_s >= 1e-5))))

        # medium interface crossing at surfaces (lib.rs:775-779)
        crossing_out = wo.dot(normal) < 0.0
        new_med = jnp.where(
            surf,
            jnp.where(crossing_out, buffers["inst_exterior"][inst],
                      buffers["inst_interior"][inst]),
            med)

        alive = alive & color.any_nonzero()
        depth = depth + 1
        alive = alive & (depth < max_depth)

        # -- regeneration
        finished = active & ~alive
        sample = c["sample"] + finished.astype(jnp.int32)
        regen = finished & (sample < num_samples)
        cam_org, cam_dir, state = generate_rays(buffers, config, px, py,
                                                state)
        out_org = v3.where(regen, cam_org,
                           v3.where(alive, new_org, c["org"]))
        out_dir = v3.where(regen, cam_dir,
                           v3.where(alive, new_dir, c["dir"]))
        out_color = v3.where(regen, 1.0,
                             v3.where(alive, color, c["color"]))
        out_depth = jnp.where(regen, 0, jnp.where(alive, depth, c["depth"]))
        out_med = jnp.where(regen, 0, jnp.where(alive, new_med, med))

        return {
            "state": state,
            "org": out_org,
            "dir": out_dir,
            "color": out_color,
            "depth": out_depth,
            "sample": sample,
            "radiance": radiance,
            "med": out_med,
            "aov_normal": aov_normal,
            "aov_albedo": aov_albedo,
            "rays": rays,
        }

    out = jax.lax.while_loop(cond, body, carry)
    return {
        "radiance": out["radiance"].to_array(),
        "normal": out["aov_normal"].to_array(),
        "albedo": out["aov_albedo"].to_array(),
        "rays": out["rays"],
    }


def render_sample(buffers, config: RenderConfig, px, py, seed, accel=None):
    return render_batch(buffers, config, px, py, seed, 1, accel=accel)
