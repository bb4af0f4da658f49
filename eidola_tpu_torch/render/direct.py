"""ReSTIR DI direct stage: G-buffer + RIS + visibility + temporal reuse
(port of eidola_tpu/render/direct.py; ref shaders/direct_stage.comp:129-289).

Per frame, full resolution, SoA over (H, W): primary hit -> motion vector
+ packed G-buffer; RIS over M light candidates; one shadow ray for the
winner; temporal merge with the reprojected history reservoir behind the
normal/depth/matHash gates; M-clamp; albedo-demodulated shading; firefly
clamp and HDR->LDR.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import reservoir as resv
from ..ops import rng as erng
from ..ops.halo import halo_gather_tree
from ..ops.math import (clamp_radiance, dot3, hdr_to_ldr, luminance,
                        make_frame, offset_ray, to_local)
from ..scene.camera import Camera, project_to_pixel, spawn_rays
from ..scene.data import SceneData
from .bsdf import BsdfParams, eval_bsdf
from .config import (RESTIR_NONE, RESTIR_SPATIAL, RESTIR_SPATIOTEMPORAL,
                     RESTIR_TEMPORAL, RenderConfig, RenderParams)
from .gbuffer import (GBuffer, GBufferView, center_rays, decode_gbuffer,
                      pack_gbuffer)
from .pathtrace import env_radiance, sample_direct_light
from .shade_state import State, get_state
from .tracer import trace_closest, trace_occlusion

_TMIN = 1e-4
_TMAX = 1e8


class DirectOut(NamedTuple):
    illum_ldr: torch.Tensor   # (H, W, 3) demodulated direct illumination (LDR)
    emission: torch.Tensor    # (H, W, 3) emitter/env passthrough
    gbuf: GBuffer
    view: GBufferView
    motion: torch.Tensor      # (H, W, 2) int64 last-frame pixel (y, x); -1
    resv: dict                # DI reservoirs carried into the next frame
    state: State
    vis: torch.Tensor         # (H, W) f32 winner visibility (1/0/-1)


def _demod_bsdf(state: State) -> BsdfParams:
    return BsdfParams(albedo=torch.ones_like(state.albedo),
                      metallic=state.metallic, roughness=state.roughness)


def _local_dirs(state: State, wo, wi):
    t, b = make_frame(state.nrm)
    return to_local(t, b, state.nrm, wo), to_local(t, b, state.nrm, wi)


def _phat(state: State, wo, li, wi):
    """Target function: luminance of the unshadowed demodulated
    contribution."""
    wo_l, wi_l = _local_dirs(state, wo, wi)
    f = eval_bsdf(_demod_bsdf(state), wo_l, wi_l)
    return luminance(li * f) * torch.clamp(wi_l[..., 2], min=0.0)


def _shade(state: State, wo, li, wi):
    wo_l, wi_l = _local_dirs(state, wo, wi)
    f = eval_bsdf(_demod_bsdf(state), wo_l, wi_l)
    return li * f * torch.clamp(wi_l[..., 2], min=0.0)[..., None]


def empty_di_reservoir(h: int, w: int, *, device) -> dict:
    f = dict(dtype=torch.float32, device=device)
    sample = {"li": torch.zeros((h, w, 3), **f),
              "wi": torch.zeros((h, w, 3), **f),
              "dist": torch.zeros((h, w), **f)}
    return resv.make_reservoir(sample, (h, w), device=device)


def _temporal_gates(view: GBufferView, hist: GBufferView):
    """Normal dot > 0.9, depth within 5%, material hash equal."""
    n_ok = dot3(view.nrm, hist.nrm) > 0.9
    d_ok = torch.abs(view.depth - hist.depth) < 0.05 * torch.clamp(
        view.depth, min=1e-3)
    m_ok = view.mat_hash == hist.mat_hash
    return view.valid & hist.valid & n_ok & d_ok & m_ok


def _unsupported(cfg: RenderConfig):
    if cfg.primary_seed:
        raise NotImplementedError("primary_seed is ported with ROADMAP A10")
    if cfg.shadow_cadence > 1:
        raise NotImplementedError(
            "shadow_cadence > 1 (visibility reuse) is ported with ROADMAP A10")
    if cfg.spatial_rounds > 0 or cfg.restir_mode in (RESTIR_SPATIAL,
                                                     RESTIR_SPATIOTEMPORAL):
        raise NotImplementedError(
            "spatial ReSTIR reuse is ported with ROADMAP A10")


def direct_stage(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                 cam: Camera, prev_gbuf: GBuffer, prev_resv: dict,
                 prev_cam: Camera, rng_state, timer=None):
    """K1.  Returns (rng_state, DirectOut).  `timer` (utils.profiler
    StageTimer) marks primary_trace, shading_ris, shadow_trace and
    di_temporal_shade."""
    _unsupported(cfg)
    h, w = cfg.height, cfg.width
    dev = rng_state.device
    full = lambda v: torch.full((h, w), v, dtype=torch.float32, device=dev)
    mark = timer.mark if timer is not None else (lambda name: None)

    # --- primary hit ---------------------------------------------------
    rng_state, o, d = spawn_rays(cam, h, w, rng_state)
    rng_state, rec = trace_closest(cfg, scene, o, d, full(_TMIN), full(_TMAX),
                                   rng_state, coherent=True)
    mark("primary_trace")
    t_hit = rec.t
    cone = (2.0 * cam.proj_inv[1, 1] / h) if cfg.texture_mips else None
    state = get_state(scene, o, d, rec.tri, t_hit, rec.u, rec.v,
                      cone_angle=cone)
    wo = -d

    # --- emission / env passthrough --------------------------------------
    env = env_radiance(cfg, scene, params, d)
    emission = torch.where(state.valid[..., None], state.emission, env)

    # --- G-buffer + motion vector ---------------------------------------
    gbuf = pack_gbuffer(state, t_hit, rec.tri)
    view = decode_gbuffer(gbuf, cam.pos, center_rays(cam, h, w))
    py, px, inside = project_to_pixel(cam.last_proj_view, state.pos, h, w)
    mvalid = inside & state.valid
    motion = torch.stack([
        torch.where(mvalid, torch.clamp(py.to(torch.int64), 0, h - 1), -1),
        torch.where(mvalid, torch.clamp(px.to(torch.int64), 0, w - 1), -1),
    ], dim=-1)

    use_restir = cfg.restir_mode != RESTIR_NONE

    # --- RIS candidate loop ---------------------------------------------
    r = empty_di_reservoir(h, w, device=dev)
    for _ in range(cfg.ris_sample_num if use_restir else 1):
        rng_state, ls = sample_direct_light(cfg, scene, params, state.pos,
                                            rng_state)
        p_hat = _phat(state, wo, ls.li, ls.wi)
        wgt = torch.where(ls.pdf > 1e-12,
                          p_hat / torch.clamp(ls.pdf, min=1e-12), 0.0)
        rng_state, u = erng.rand(rng_state)
        r = resv.resv_update(r, {"li": ls.li, "wi": ls.wi, "dist": ls.dist},
                             wgt, u)

    # --- reprojection gates ------------------------------------------------
    temporal_on = cfg.restir_mode == RESTIR_TEMPORAL
    gates = mot_y = mot_x = None
    if temporal_on:
        prev_view = decode_gbuffer(prev_gbuf, prev_cam.pos,
                                   center_rays(prev_cam, h, w))
        mot_y = torch.clamp(motion[..., 0], 0, h - 1)
        mot_x = torch.clamp(motion[..., 1], 0, w - 1)
        hist_view, in_halo = halo_gather_tree(prev_view, mot_y, mot_x,
                                              cfg.temporal_halo)
        gates = (_temporal_gates(view, hist_view) & (motion[..., 0] >= 0)
                 & in_halo)

    # --- shadow ray for the RIS winner ----------------------------------
    sel = r["sample"]
    origin = offset_ray(state.pos, torch.where(
        dot3(state.geo_nrm, sel["wi"])[..., None] >= 0,
        state.geo_nrm, -state.geo_nrm))
    need = state.valid & (r["weight"] > 0.0)
    shadow_tmax = torch.where(need, sel["dist"] * 0.999, -1.0)
    mark("shading_ris")
    rng_state, occluded = trace_occlusion(cfg, scene, origin, sel["wi"],
                                          full(_TMIN), shadow_tmax, rng_state,
                                          coherent=True)
    mark("shadow_trace")
    vis_out = torch.where(need, torch.where(occluded, 0.0, 1.0), -1.0)
    r["weight"] = torch.where(occluded | ~state.valid, 0.0, r["weight"])

    # --- temporal reuse ---------------------------------------------------
    if temporal_on:
        hist_resv, _ = halo_gather_tree(prev_resv, mot_y, mot_x,
                                        cfg.temporal_halo)
        rng_state, u = erng.rand(rng_state)
        r = resv.resv_merge_same_target(r, hist_resv, u, enabled=gates)

    # --- clamp + save carry ---------------------------------------------
    if use_restir:
        carry = resv.resv_clamp(resv.resv_check(r),
                                cfg.ris_sample_num * params.reservoir_clamp)
    else:
        carry = resv.resv_check(r)

    # --- shade --------------------------------------------------------------
    r = resv.resv_check(r)
    sel = r["sample"]
    p_hat_sel = _phat(state, wo, sel["li"], sel["wi"])
    big_w = resv.resv_big_w(r, p_hat_sel)
    illum = _shade(state, wo, sel["li"], sel["wi"]) * big_w[..., None]
    illum = torch.where(state.valid[..., None], illum, 0.0)
    illum = clamp_radiance(illum, params.firefly_clamp)
    mark("di_temporal_shade")

    return rng_state, DirectOut(
        illum_ldr=hdr_to_ldr(illum), emission=emission, gbuf=gbuf, view=view,
        motion=motion, resv=carry, state=state, vis=vis_out)
