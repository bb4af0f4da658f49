"""Wavefront unidirectional path tracer: NEE + MIS power heuristic +
Russian roulette (port of eidola_tpu/render/tracer.py on its opaque
branch, alpha_geometry=False; ref shaders/indirect_stage.comp:129-226).

`trace_closest` / `trace_occlusion` are the ray front doors: image-tile
packets for coherent (H, W, 3) raster fields, sorted wavefronts for
everything else.  `trace_radiance` is the estimator core the GI stage
drives from G-buffer surfaces; its bounce loop is the JAX package's
scanned body as a Python loop.  The alpha HitTest march and the
opaque/alpha BVH split stay ROADMAP A9.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import rng as erng
from ..ops.math import (dot3, make_frame, offset_ray, power_heuristic,
                        to_local, to_world)
from ..ops.packets import (any_hit_img, any_hit_sorted, closest_hit_img,
                           closest_hit_sorted, make_ray_order)
from ..scene.data import SceneData
from .bsdf import eval_bsdf, pdf_bsdf, sample_bsdf
from .config import RenderConfig, RenderParams
from .pathtrace import (env_pdf_dir, env_radiance, env_selection_prob,
                        light_pdf_for_bsdf_dir, sample_direct_light)
from .shade_state import State, get_state

_TMIN = 1e-4
_TMAX = 1e8


def _check(cfg: RenderConfig, scene: SceneData):
    if cfg.alpha_geometry or scene.bvh_alpha is not None:
        raise NotImplementedError(
            "alpha-tested tracing is ported with ROADMAP A9")


def trace_closest(cfg: RenderConfig, scene: SceneData, o, d, t_min, t_max,
                  rng_state, coherent: bool = False, order=None):
    """Closest hit: image tiles for coherent (H, W, 3) fields, else a
    sorted wavefront (`order` from make_ray_order skips the sort).
    Returns (rng_state, HitRecord)."""
    _check(cfg, scene)
    if coherent and o.dim() == 3:
        rec = closest_hit_img(scene.bvh, o, d, t_min, t_max,
                              max_steps=cfg.traversal_max_steps)
    else:
        rec = closest_hit_sorted(scene.bvh, o, d, t_min, t_max,
                                 max_steps=cfg.traversal_max_steps,
                                 order=order)
    return rng_state, rec


def trace_occlusion(cfg: RenderConfig, scene: SceneData, o, d, t_min, t_max,
                    rng_state, order=None, coherent: bool = False):
    """Occlusion, with the same packet choice.  Returns (rng_state,
    occluded bool)."""
    _check(cfg, scene)
    if coherent and o.dim() == 3:
        occ = any_hit_img(scene.bvh, o, d, t_min, t_max,
                          max_steps=cfg.traversal_max_steps)
    else:
        occ = any_hit_sorted(scene.bvh, o, d, t_min, t_max,
                             max_steps=cfg.traversal_max_steps, order=order)
    return rng_state, occ


class PathVertex(NamedTuple):
    """First-bounce record the ReSTIR GI stage needs (ref GISample
    host_device.h:260-284)."""
    xs: torch.Tensor     # (..., 3) first secondary hit position
    ns: torch.Tensor     # (..., 3) its normal
    valid: torch.Tensor  # (...,) bool


def _flip_to(geo_nrm, w):
    """The geometric normal on the side of direction w."""
    return torch.where(dot3(geo_nrm, w)[..., None] >= 0, geo_nrm, -geo_nrm)


def nee_contribution(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                     state: State, wo, rng_state, active=None,
                     want_order: bool = False):
    """One next-event-estimation sample at `state` with a shadow ray and
    MIS (ref pathtrace.glsl:185-220).  Returns (rng, contribution (..., 3))
    or, with want_order, also the wavefront order of the shadow rays,
    which the next bounce from the same surface reuses.  `active` masks
    lanes whose shadow rays need not be traced at all."""
    rng_state, ls = sample_direct_light(cfg, scene, params, state.pos,
                                        rng_state)
    t, b = make_frame(state.nrm)
    wo_l = to_local(t, b, state.nrm, wo)
    wi_l = to_local(t, b, state.nrm, ls.wi)
    f = eval_bsdf(state.bsdf(), wo_l, wi_l)
    cos_i = torch.clamp(wi_l[..., 2], min=0.0)

    contrib_ok = state.valid & (ls.pdf > 1e-12) & (cos_i > 0.0)
    if active is not None:
        contrib_ok = contrib_ok & active
    origin = offset_ray(state.pos, _flip_to(state.geo_nrm, ls.wi))
    # dead lanes get t_max < t_min so their packets retire in one step
    shadow_tmax = torch.where(contrib_ok, ls.dist * 0.999, -1.0)
    order = make_ray_order(scene.bvh, origin, ls.wi, dead=~contrib_ok)
    rng_state, occluded = trace_occlusion(
        cfg, scene, origin, ls.wi, torch.full_like(shadow_tmax, _TMIN),
        shadow_tmax, rng_state, order=order)

    if cfg.use_mis:
        bsdf_pdf_wi = pdf_bsdf(state.bsdf(), wo_l, wi_l)
        w = torch.where(ls.delta, 1.0, power_heuristic(ls.pdf, bsdf_pdf_wi))
    else:
        w = torch.ones_like(ls.pdf)
    contrib = ls.li * f * (cos_i * w / torch.clamp(ls.pdf, min=1e-12)
                           )[..., None]
    contrib = torch.where((contrib_ok & ~occluded)[..., None], contrib, 0.0)
    if want_order:
        return rng_state, contrib, order
    return rng_state, contrib


def trace_radiance(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                   o, d, rng_state, num_bounces: int | None = None,
                   collect_first_vertex: bool = False,
                   start_state: State | None = None, start_wo=None,
                   nee_start_depth: int = 0,
                   snapshot_after_depth: int | None = None,
                   kill_after_snapshot=None):
    """Trace radiance along rays (o, d), flat or image-shaped.

    With `start_state` the path starts AT that surface (the GI stage's
    G-buffer reconstruction) and (o, d) are ignored; `start_wo` points
    back toward the camera.  With `snapshot_after_depth` = k, also return
    the radiance accumulated through segment k: what a separate
    num_bounces=k run with the same RNG prefix would give.

    Returns (rng_state, radiance, PathVertex|None[, radiance_snapshot])."""
    depth_total = num_bounces if num_bounces is not None else cfg.max_depth
    lanes = (start_state.valid.shape if start_state is not None
             else d.shape[:-1])
    dev = rng_state.device
    f32 = dict(dtype=torch.float32, device=dev)

    radiance = torch.zeros(lanes + (3,), **f32)
    throughput = torch.ones(lanes + (3,), **f32)
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    last_bsdf_pdf = torch.zeros(lanes, **f32)
    first_xs = torch.zeros(lanes + (3,), **f32)
    first_ns = torch.zeros(lanes + (3,), **f32)
    first_ok = torch.zeros(lanes, dtype=torch.bool, device=dev)

    def accumulate(depth_gt_nee: bool, radiance, throughput, alive,
                   last_bsdf_pdf, cur_d, state, wo, tri, rec_t):
        """Add the env/emitter contribution of the vertex just reached;
        `depth_gt_nee`: does NEE at earlier vertices already account for
        light found by this BSDF segment (-> MIS-weight or drop it)?"""
        escaped = alive & ~state.valid
        env = env_radiance(cfg, scene, params, cur_d)
        ones = torch.ones(lanes, **f32)
        if cfg.use_nee and cfg.use_mis:
            lp = env_pdf_dir(cfg, scene, cur_d) * env_selection_prob(
                cfg, scene, params)
            w_env = power_heuristic(last_bsdf_pdf, lp) if depth_gt_nee \
                else ones
        elif cfg.use_nee:
            w_env = ones * (0.0 if depth_gt_nee else 1.0)
        else:
            w_env = ones
        radiance = radiance + torch.where(
            escaped[..., None], throughput * env * w_env[..., None], 0.0)

        hit_em = alive & state.valid
        if cfg.use_nee and cfg.use_mis:
            cos_l = torch.abs(dot3(state.geo_nrm, wo))
            lp = light_pdf_for_bsdf_dir(cfg, scene, params, cur_d, tri, rec_t,
                                        cos_l)
            w_em = power_heuristic(last_bsdf_pdf, lp) if depth_gt_nee \
                else ones
        elif cfg.use_nee:
            # NEE-only: count emitter hits only for lights NEE can't find
            not_nee_light = torch.where(
                scene.tri_light_pmf[torch.clamp(tri, min=0)] > 0.0, 0.0, 1.0)
            w_em = not_nee_light if depth_gt_nee else ones
        else:
            w_em = ones
        return radiance + torch.where(
            hit_em[..., None], throughput * state.emission * w_em[..., None],
            0.0)

    # ---- depth 0: coherent primaries, or the provided surface ----
    if start_state is not None:
        state, wo = start_state, start_wo
    else:
        rng_state, rec = trace_closest(
            cfg, scene, o, d, torch.full(lanes, _TMIN, **f32),
            torch.full(lanes, _TMAX, **f32), rng_state, coherent=True)
        state = get_state(scene, o, d, rec.tri, rec.t, rec.u, rec.v)
        wo = -d
        radiance = accumulate(0 > nee_start_depth, radiance, throughput,
                              alive, last_bsdf_pdf, d, state, wo, rec.tri,
                              rec.t)
        alive = alive & state.valid
    radiance_snap = radiance
    if snapshot_after_depth == 0 and kill_after_snapshot is not None:
        alive = alive & kill_after_snapshot

    # ---- bounces 1..depth_total (the JAX package's scanned body) ----
    for k in range(1, depth_total + 1):
        # NEE at the current vertex, depth k-1 (ref indirect_stage.comp:143)
        order = None
        if cfg.use_nee:
            nee_on = alive if nee_start_depth <= 0 else \
                alive & (k - 1 >= nee_start_depth)
            rng_state, contrib, order = nee_contribution(
                cfg, scene, params, state, wo, rng_state, active=nee_on,
                want_order=True)
            radiance = radiance + torch.where(nee_on[..., None],
                                              throughput * contrib, 0.0)

        # BSDF sample to continue
        rng_state, u1 = erng.rand(rng_state)
        rng_state, u2 = erng.rand(rng_state)
        rng_state, u3 = erng.rand(rng_state)
        t, b = make_frame(state.nrm)
        wo_l = to_local(t, b, state.nrm, wo)
        wi_l, pdf, f = sample_bsdf(state.bsdf(), wo_l, u1, u2, u3)
        wi = to_world(t, b, state.nrm, wi_l)
        cos_i = torch.clamp(wi_l[..., 2], min=0.0)
        ok = alive & (pdf > 1e-9) & (cos_i > 0.0)
        throughput = torch.where(
            ok[..., None],
            throughput * f * (cos_i / torch.clamp(pdf, min=1e-9))[..., None],
            throughput)
        alive = ok
        last_bsdf_pdf = pdf

        # Russian roulette from rr_depth (ref indirect_stage.comp:218-224)
        if cfg.russian_roulette:
            rng_state, u_rr = erng.rand(rng_state)
            if k - 1 >= cfg.rr_depth:
                p_cont = torch.clamp(torch.amax(throughput, dim=-1), 0.05,
                                     1.0)
            else:
                p_cont = torch.ones_like(u_rr)
            survive = u_rr < p_cont
            throughput = torch.where((alive & survive)[..., None],
                                     throughput / p_cont[..., None],
                                     throughput)
            alive = alive & survive

        # segment k: a sorted wavefront reusing the NEE shadow order (same
        # origins); terminated lanes are dead rays that retire at once
        cur_o = offset_ray(state.pos, _flip_to(state.geo_nrm, wi))
        cur_d = wi
        rng_state, rec = trace_closest(
            cfg, scene, cur_o, cur_d, torch.full(lanes, _TMIN, **f32),
            torch.where(alive, _TMAX, -1.0), rng_state, order=order)
        state = get_state(scene, cur_o, cur_d, rec.tri, rec.t, rec.u, rec.v)
        wo = -cur_d
        radiance = accumulate(
            k > nee_start_depth if nee_start_depth > 0 else True,
            radiance, throughput, alive, last_bsdf_pdf, cur_d, state, wo,
            rec.tri, rec.t)

        if collect_first_vertex and k == 1:
            first_ok = state.valid & alive
            first_xs = torch.where(first_ok[..., None], state.pos, 0.0)
            first_ns = torch.where(first_ok[..., None], state.nrm, 0.0)

        if snapshot_after_depth is not None and \
                k == snapshot_after_depth >= 1:
            radiance_snap = radiance
            if kill_after_snapshot is not None:
                # tiled multi-bounce: lanes whose deep contribution is
                # scaled to zero stop tracing here
                alive = alive & kill_after_snapshot

        alive = alive & state.valid

    vert = (PathVertex(xs=first_xs, ns=first_ns, valid=first_ok)
            if collect_first_vertex else None)
    if snapshot_after_depth is not None:
        return rng_state, radiance, vert, radiance_snap
    return rng_state, radiance, vert
