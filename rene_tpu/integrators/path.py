"""Wavefront surface path tracer (the reference's `path` integrator).

Port of main_ray_generation_path (rene-shader/src/lib.rs:141-357) to a
lane-per-ray wavefront in component-SoA form (see ops/vec3.py): the
recursive megakernel's bounce loop becomes a `lax.while_loop` over the whole
ray batch; masked lanes replace warp divergence; **path regeneration** keeps
lanes busy — each lane owns one pixel and streams its samples back-to-back,
restarting a fresh camera path the moment one terminates.

Per bounce, matching the reference:
  1. closest-hit trace; on miss add background radiance;
  2. fetch instance tables, build the BSDF lobe slots, add one-sided emitter
     radiance, accumulate normal/albedo AOVs at depth 0;
  3. next-event estimation toward every distant light (shadow trace);
  4. if emitters exist and the BSDF has a diffuse lobe: 50/50 mixture of
     emitter-surface sampling and BSDF sampling, with the light pdf computed
     by a dedicated trace against the emissive-only set and mixed
     0.5/0.5 (lib.rs:274-324); else plain BSDF sampling;
  5. kill on zero throughput / tiny pdf; Russian roulette after depth 12.

Deviations (documented):
* the mixture's BSDF pdf is evaluated as pdf(wo, wi) — the reference calls
  `bsdf.pdf(wi, normal)` (lib.rs:287), an approximation;
* Russian roulette continue probability is clamped to <=1 (the reference
  divides by an unclamped max component, lib.rs:344-354, which is biased);
* every lane uses its own RNG stream — the reference's frame-wide RNG exists
  only to reduce warp divergence, which masked lanes don't suffer from;
* pbrt `maxdepth` is honored when present (the reference parses but ignores
  it, hardcoding 50).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import bsdf as B
from ..ops import intersect as I
from ..ops import rng
from ..ops import vec3 as v3
from ..ops.vec3 import V3
from ..scene import types as T
from ..scene.device import RenderConfig
from .camera import generate_rays
from .common import (background_pdf, background_radiance,
                     sample_background, sample_emit_object)

TMIN = 1e-3
TMAX = 1e5
RR_START = 12


def max_depth_for(config: RenderConfig) -> int:
    if config.max_depth_hint is not None:
        return max(int(config.max_depth_hint), 1)
    return 50  # reference lib.rs:192


def _gather3(table, idx) -> V3:
    return V3(table[idx, 0], table[idx, 1], table[idx, 2])


def render_batch(buffers, config: RenderConfig, px, py, seed, num_samples,
                 accel=None):
    """Trace `num_samples` samples per pixel with path regeneration.

    Returns summed (not averaged) radiance/normal/albedo over the samples,
    as (N,3) arrays, plus the traced-ray count.
    """
    n = px.shape[0]
    w = config.film.xresolution
    pix_index = (py.astype(jnp.uint32) * jnp.uint32(w)
                 + px.astype(jnp.uint32))
    state = rng.pcg_init(pix_index ^ jnp.uint32(seed))

    org, direction, state = generate_rays(buffers, config, px, py, state)

    max_depth = max_depth_for(config)
    num_emit = config.num_emit_objects
    use_rr = max_depth > RR_START + 1

    carry = {
        "state": state,
        "org": org,
        "dir": direction,
        "color": V3.ones((n,)),
        "depth": jnp.zeros((n,), jnp.int32),
        "sample": jnp.zeros((n,), jnp.int32),
        "radiance": V3.zeros((n,)),
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
        depth = c["depth"]
        rays = c["rays"] + jnp.sum(active.astype(jnp.float32)) \
            * (1.0 + config.num_lights + (1.0 if num_emit > 0 else 0.0))

        hit = I.trace(buffers, config, c["org"], c["dir"], TMIN, TMAX,
                      accel=accel)

        # -- miss: background (lib.rs:209-211)
        bg = background_radiance(buffers, c["dir"], config)
        miss = active & ~hit["hit"]
        radiance = radiance + v3.where(miss, color * bg, 0.0)
        path_alive = active & hit["hit"]

        # -- surface setup
        wo = -c["dir"].normalized()
        normal = hit["normal"].normalized()
        position = hit["position"]
        uv = hit["uv"]
        inst = hit["inst"]
        mat_idx = buffers["inst_material"][inst]
        al_idx = buffers["inst_area_light"][inst]

        onb = v3.Onb.from_w(normal)
        lobes = B.compute_bsdf(buffers, mat_idx, uv, config)

        # -- emitter hit (one-sided, area_light.rs:66-73)
        al_color = _gather3(buffers["area_color"], al_idx)
        al_on = (buffers["area_type"][al_idx] != T.AREA_NULL) \
            & (wo.dot(normal) > 0.0)
        radiance = radiance + v3.where(path_alive & al_on, color * al_color,
                                       0.0)

        # -- AOVs at per-path depth 0, accumulated over samples
        first = path_alive & (depth == 0)
        albedo = B.material_albedo(buffers, mat_idx, uv, config)
        aov_normal = c["aov_normal"] + v3.where(first, normal, 0.0)
        aov_albedo = c["aov_albedo"] + v3.where(first, albedo, 0.0)

        # -- NEE for distant lights (lib.rs:234-272), as a loop so that
        # the traced program does not grow with the light count
        def light_nee(li, radiance):
            ld = buffers["light_dir"][li]
            lc = buffers["light_color"][li]
            wi_l = V3(jnp.broadcast_to(ld[0], position.x.shape),
                      jnp.broadcast_to(ld[1], position.x.shape),
                      jnp.broadcast_to(ld[2], position.x.shape))
            shadowed = I.occluded(buffers, config, position, wi_l, TMIN,
                                  TMAX, accel=accel)
            f_l = B.bsdf_f(lobes, onb, normal, wo, wi_l, config)
            contrib = color * f_l * jnp.abs(wi_l.dot(normal)) \
                * V3(lc[0], lc[1], lc[2])
            return radiance + v3.where(path_alive & ~shadowed, contrib, 0.0)

        if config.num_lights:
            radiance = jax.lax.fori_loop(0, config.num_lights, light_nee,
                                         radiance)

        # -- scatter: MIS mixture or plain BSDF sampling. The light
        # strategy set is the emissive objects plus (env_nee) the
        # importance-sampled imagemap infinite light — a light-sampled
        # direction CONTINUES the path, so emitter-hit / miss pickup
        # and the mixture pdf below are the whole MIS.
        n_strat = num_emit + (1 if config.env_nee else 0)
        swi, sf, spdf, state = B.bsdf_sample_f(lobes, onb, wo, state, config)
        if n_strat > 0:
            coin, state = rng.next_f32(state)
            if num_emit > 0:
                ls_wi, state = sample_emit_object(buffers, config,
                                                  position, state)
            if config.env_nee:
                env_wi, _, state = sample_background(buffers, state)
                if num_emit > 0:
                    upick, state = rng.next_f32(state)
                    take_env = upick * n_strat < 1.0
                    ls_wi = v3.where(take_env, env_wi, ls_wi)
                else:
                    ls_wi = env_wi
            take_light = coin > 0.5
            use_mis = B.bsdf_contains(lobes, T.KIND_DIFFUSE)
            sel_l = use_mis & take_light
            wi = v3.where(sel_l, ls_wi, swi)
            f = v3.where(sel_l,
                         B.bsdf_f(lobes, onb, normal, wo, ls_wi, config),
                         sf)
            pdf_b = jnp.where(sel_l,
                              B.bsdf_pdf(lobes, onb, wo, ls_wi, config),
                              spdf)
            light_pdf = jnp.zeros_like(spdf)
            if num_emit > 0:
                light_pdf = light_pdf + I.trace_emissive_pdf(
                    buffers, config, position, wi, TMIN, TMAX,
                    accel=accel)
            if config.env_nee:
                light_pdf = light_pdf + background_pdf(buffers, wi)
            light_pdf = light_pdf / n_strat
            pdf = jnp.where(use_mis, 0.5 * pdf_b + 0.5 * light_pdf, spdf)
            f = v3.where(use_mis, f, sf)
            wi = v3.where(use_mis, wi, swi)
        else:
            wi, f, pdf = swi, sf, spdf

        path_alive = path_alive & (pdf >= 1e-5)
        color = color * f * (jnp.abs(normal.dot(wi))
                             / jnp.maximum(pdf, 1e-20))
        path_alive = path_alive & color.any_nonzero()

        # -- Russian roulette (per-lane depth; clamped p)
        if use_rr:
            rr, state = rng.next_f32(state)
            p_cont = jnp.clip(color.max_component(), 0.0, 1.0)
            do_rr = depth > RR_START
            path_alive = path_alive & (~do_rr | (rr <= p_cont))
            color = v3.where(do_rr & path_alive,
                             color * (1.0 / jnp.maximum(p_cont, 1e-20)),
                             color)

        depth = depth + 1
        path_alive = path_alive & (depth < max_depth)

        # -- regeneration: terminated lanes start their next sample
        finished = active & ~path_alive
        sample = c["sample"] + finished.astype(jnp.int32)
        regen = finished & (sample < num_samples)
        cam_org, cam_dir, state = generate_rays(buffers, config, px, py,
                                                state)
        new_org = v3.where(regen, cam_org,
                           v3.where(path_alive, position, c["org"]))
        new_dir = v3.where(regen, cam_dir,
                           v3.where(path_alive, wi, c["dir"]))
        color = v3.where(regen, 1.0,
                         v3.where(path_alive, color, c["color"]))
        depth = jnp.where(regen, 0, jnp.where(path_alive, depth, c["depth"]))

        return {
            "state": state,
            "org": new_org,
            "dir": new_dir,
            "color": color,
            "depth": depth,
            "sample": sample,
            "radiance": radiance,
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
    """One sample per pixel (compat wrapper over render_batch)."""
    return render_batch(buffers, config, px, py, seed, 1, accel=accel)
