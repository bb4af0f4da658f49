"""ReSTIR DI direct stage: G-buffer + RIS + visibility + temporal and
spatial reuse (port of eidola_tpu/render/direct.py; ref
shaders/direct_stage.comp:129-289).

Per frame, full resolution, SoA over (H, W): primary hit (its t_max
seeded from last frame's triangle under `primary_seed`) -> motion vector
+ packed G-buffer; RIS over M light candidates; one shadow ray for the
winner (under `shadow_cadence` > 1 only on 1/cadence of the 8x16 tiles,
the rest reuse the reprojected visibility); temporal merge with the
reprojected history reservoir behind the normal/depth/matHash gates;
M-clamp; spatial disk-neighbour rounds; albedo-demodulated shading;
firefly clamp and HDR->LDR.

Under a shard context (ops/halo.py, parallel/sharding.py) the stage
renders the rank's rows: rays, seeds, tiles and motion vectors in global
pixel coordinates, and the gathers that read other rows (temporal view,
reservoir and visibility within +-temporal_halo rows, spatial taps within
+-spatial_radius) read operands extended by a row exchange of the packed
state (G-buffer words, reservoirs, visibility), decoded after it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import reservoir as resv
from ..ops import rng as erng
from ..ops.halo import get_shard, halo_gather, halo_gather_tree, image_rows
from ..ops.intersect import ray_triangle
from ..ops.math import (clamp_radiance, dot3, hdr_to_ldr, luminance,
                        make_frame, offset_ray, to_local)
from ..ops.packets import TILE_H, TILE_W
from ..parallel.exchange import exchange_rows
from ..scene.camera import Camera, project_to_pixel, spawn_rays
from ..scene.data import ALPHA_OPAQUE, SceneData, shade_row
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


def _seed_tmax(cfg: RenderConfig, scene: SceneData, o, d, prev_tri):
    """primary_seed: re-test last frame's triangle at each pixel against
    this frame's ray.  A hit is a real intersection, so its t bounds the
    walk from step 0.  Instanced BVHs re-test in the instance's object
    space (the unnormalised transformed direction keeps t).  The slot and
    instance tables hold -1 for ids this BVH does not own (the other half
    of an opaque/alpha split): the gathers are clamped and masked, never
    wrapped to the last row.  Under the HitTest only opaque predicted
    hits may seed, since an alpha hit may be passed through."""
    bvh = scene.bvh
    ptc = torch.clamp(prev_tri, min=0)
    slot = bvh.slot_of_tri[ptc]
    row = bvh.leaf_blocks.reshape(-1, 12)[torch.clamp(slot, min=0)]
    if scene.inst is None:
        o_t, d_t = o, d
    else:
        inst = torch.clamp(bvh.inst_of_tri[ptc], min=0)
        r = bvh.inst_inv[inst].reshape(*inst.shape, 3, 4)
        o_t = torch.einsum("...ij,...j->...i", r[..., :3], o) + r[..., 3]
        d_t = torch.einsum("...ij,...j->...i", r[..., :3], d)
    p_hit, p_t, _, _ = ray_triangle(o_t, d_t, row[..., 0:3], row[..., 3:6],
                                    row[..., 6:9], _TMIN, _TMAX)
    ok = (prev_tri >= 0) & (slot >= 0) & p_hit
    if cfg.alpha_geometry:
        arow, _ = shade_row(scene, ptc)
        ok &= scene.materials.alpha_mode[scene.tri_mat[arow]] == ALPHA_OPAQUE
    return torch.where(ok, p_t * (1.0 + 1e-4) + 1e-6, _TMAX)


def _tile_active(h: int, w: int, frame_idx, cadence: int, device,
                 row0: int = 0):
    """Visibility reuse's mask: the 8x16 tiles that re-validate this frame,
    tea(tile id, frame index) % cadence == 0, in uint32 arithmetic; for
    the h rows from global row `row0` (tile ids count over the whole
    image)."""
    fi = erng.u32(0 if frame_idx is None else frame_idx, device=device)
    ty = torch.arange(row0, row0 + h, dtype=torch.int64,
                      device=device)[:, None] // TILE_H
    tx = torch.arange(w, dtype=torch.int64, device=device)[None, :] // TILE_W
    tile_id = (ty * -(-w // TILE_W) + tx) & erng.M32
    return erng.tea(tile_id, fi) % cadence == 0


def _reuse_visibility(cfg: RenderConfig, need, gates, prev_vis, mot_y, mot_x,
                      frame_idx):
    """Visibility reuse for shadow_cadence > 1: only the active tiles
    re-validate their winner; elsewhere a pixel whose reprojection passes
    the gates and whose last winner's visibility is known reuses it (per
    tile, so a skipped packet retires from the walk at once).  Returns
    (must: the shadow rays to trace, vis_prev: the reprojected
    visibility)."""
    h, w = need.shape
    vis_prev, _ = halo_gather(prev_vis, mot_y, mot_x, cfg.temporal_halo)
    vis_known = gates & (vis_prev >= 0.0)
    active = _tile_active(h, w, frame_idx, cfg.shadow_cadence, need.device,
                          row0=image_rows(cfg.height)[0])
    return need & (active | ~vis_known), vis_prev


def history_view(cfg: RenderConfig, prev_gbuf: GBuffer, prev_cam: Camera):
    """The previous frame's G-buffer decoded for the temporal gathers: the
    whole image, or under a shard context the rank's rows with
    cfg.temporal_halo rows above and below (the packed words cross, then
    decode with the previous camera's rays of those global rows)."""
    h, w = cfg.height, cfg.width
    sh = get_shard()
    if sh is None:
        return decode_gbuffer(prev_gbuf, prev_cam.pos,
                              center_rays(prev_cam, h, w))
    halo = cfg.temporal_halo
    ext = exchange_rows(sh, prev_gbuf, halo, "history.gbuf")
    return decode_gbuffer(ext, prev_cam.pos,
                          center_rays(prev_cam, h, w,
                                      rows=_halo_rows(sh, h, halo,
                                                      ext.depth.device)))


def _halo_rows(sh, h: int, halo: int, device):
    """Global rows of a rank's band of an h-row image extended by `halo`
    rows, edge-clamped (what exchange_rows returns)."""
    row0, n = sh.rows(h)
    return torch.clamp(torch.arange(row0 - halo, row0 + n + halo,
                                    device=device), 0, h - 1)


def direct_stage(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                 cam: Camera, prev_gbuf: GBuffer, prev_resv: dict,
                 prev_cam: Camera, rng_state, prev_vis=None, frame_idx=None,
                 timer=None, prev_view=None):
    """K1.  Returns (rng_state, DirectOut).  `prev_vis` and `frame_idx`
    (the FrameState's di_vis and frame_idx) drive visibility reuse;
    `prev_view` is history_view's decode of prev_gbuf when the caller has
    it.  `timer` (utils.profiler StageTimer) marks primary_trace,
    shading_ris, shadow_trace, di_temporal_shade and, in the spatial
    modes, di_spatial."""
    H, w = cfg.height, cfg.width
    row0, h = image_rows(H)
    sh = get_shard()
    dev = rng_state.device
    full = lambda v: torch.full((h, w), v, dtype=torch.float32, device=dev)
    mark = timer.mark if timer is not None else (lambda name: None)

    # --- primary hit ---------------------------------------------------
    rng_state, o, d = spawn_rays(cam, H, w, rng_state, row0=row0)
    t_max0 = full(_TMAX)
    if cfg.primary_seed and scene.bvh.slot_of_tri is not None:
        t_max0 = _seed_tmax(cfg, scene, o, d, prev_gbuf.tri)
    rng_state, rec = trace_closest(cfg, scene, o, d, full(_TMIN), t_max0,
                                   rng_state, coherent=True)
    mark("primary_trace")
    t_hit = rec.t
    cone = (2.0 * cam.proj_inv[1, 1] / H) if cfg.texture_mips else None
    state = get_state(scene, o, d, rec.tri, t_hit, rec.u, rec.v,
                      cone_angle=cone)
    wo = -d

    # --- emission / env passthrough --------------------------------------
    env = env_radiance(cfg, scene, params, d)
    emission = torch.where(state.valid[..., None], state.emission, env)

    # --- G-buffer + motion vector ---------------------------------------
    gbuf = pack_gbuffer(state, t_hit, rec.tri)
    view = decode_gbuffer(gbuf, cam.pos, center_rays(
        cam, H, w, rows=None if sh is None else torch.arange(
            row0, row0 + h, device=dev)))
    py, px, inside = project_to_pixel(cam.last_proj_view, state.pos, H, w)
    mvalid = inside & state.valid
    motion = torch.stack([
        torch.where(mvalid, torch.clamp(py.to(torch.int64), 0, H - 1), -1),
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

    # --- reprojection gates (temporal merge and visibility reuse) ---------
    temporal_on = cfg.restir_mode in (RESTIR_TEMPORAL, RESTIR_SPATIOTEMPORAL)
    use_vis_reuse = cfg.shadow_cadence > 1 and prev_vis is not None
    gates = mot_y = mot_x = None
    if temporal_on or use_vis_reuse:
        if prev_view is None:
            prev_view = history_view(cfg, prev_gbuf, prev_cam)
        if sh is not None:              # the rows the gathers may read
            hist = exchange_rows(sh, {
                "resv": prev_resv if temporal_on else None,
                "vis": prev_vis if use_vis_reuse else None},
                cfg.temporal_halo, "direct.history")
            prev_resv, prev_vis = hist["resv"], hist["vis"]
        mot_y = torch.clamp(motion[..., 0], 0, H - 1)
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
    if use_vis_reuse:
        must, vis_prev = _reuse_visibility(cfg, need, gates, prev_vis, mot_y,
                                           mot_x, frame_idx)
    else:
        must = need
    shadow_tmax = torch.where(must, sel["dist"] * 0.999, -1.0)
    mark("shading_ris")
    # the winners' shadow rays in image-tile packets
    rng_state, occluded = trace_occlusion(
        cfg, scene, origin, sel["wi"], full(_TMIN), shadow_tmax, rng_state,
        coherent=True)
    mark("shadow_trace")
    if use_vis_reuse:
        occluded = torch.where(must, occluded, vis_prev < 0.5)
    vis_out = torch.where(need, torch.where(occluded, 0.0, 1.0), -1.0)
    r["weight"] = torch.where(occluded | ~state.valid, 0.0, r["weight"])

    # --- temporal reuse ---------------------------------------------------
    if temporal_on:
        hist_resv, _ = halo_gather_tree(prev_resv, mot_y, mot_x,
                                        cfg.temporal_halo)
        rng_state, u = erng.rand(rng_state)
        r = resv.resv_merge_same_target(r, hist_resv, u, enabled=gates)

    # --- clamp + save carry (pre-spatial) ---------------------------------
    # the clamped pre-spatial reservoir is the next frame's history, so
    # spatial correlations never compound through the temporal chain
    if use_restir:
        carry = resv.resv_clamp(resv.resv_check(r),
                                cfg.ris_sample_num * params.reservoir_clamp)
    else:
        carry = resv.resv_check(r)

    # --- spatial reuse rounds ---------------------------------------------
    if cfg.restir_mode in (RESTIR_SPATIAL, RESTIR_SPATIOTEMPORAL):
        mark("di_temporal_shade")
        rng_state, r = _spatial_reuse(cfg, view, r, rng_state, gbuf=gbuf,
                                      cam=cam)
        mark("di_spatial")

    # --- shade --------------------------------------------------------------
    # (the unclamped post-spatial reservoir, as the reference shades)
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


def _spatial_gates(view: GBufferView, n_view: GBufferView):
    """Normal dot > 0.5, depth within 10%, no material-hash test: looser
    than the temporal gates (ref direct_stage.comp:95-105)."""
    n_ok = dot3(view.nrm, n_view.nrm) > 0.5
    d_ok = torch.abs(view.depth - n_view.depth) < 0.1 * torch.clamp(
        view.depth, min=1e-3)
    return view.valid & n_view.valid & n_ok & d_ok


def _disk_offset(cfg: RenderConfig, rng_state):
    """A neighbour offset per pixel, uniform on the disk of
    cfg.spatial_radius pixels, rounded half to even.  Draws a1, a2.
    Returns (rng_state, oy, ox)."""
    rng_state, a1 = erng.rand(rng_state)
    rng_state, a2 = erng.rand(rng_state)
    ang = 2.0 * math.pi * a1
    rad = cfg.spatial_radius * torch.sqrt(a2)
    oy = torch.round(rad * torch.sin(ang)).to(torch.int64)
    ox = torch.round(rad * torch.cos(ang)).to(torch.int64)
    return rng_state, oy, ox


def _spatial_reuse(cfg: RenderConfig, view: GBufferView, r_src: dict,
                   rng_state, gbuf: GBuffer = None, cam: Camera = None):
    """Spatial rounds (ref direct_stage.comp:224-255, 86-121): each round
    merges cfg.spatial_neighbors disk-distributed neighbours of the cached
    post-temporal reservoirs `r_src` (every round reads the same cache)
    into a per-round aggregate; the rounds' aggregates merge into one
    reservoir, which folds into the pixel's own once at the end.
    Self-merges are skipped.  The rng draws come in the JAX package's
    order: a1, a2 (_disk_offset) and u per neighbour, u per round, u at
    the end.  As
    there, the neighbour disk has the declared radius and the gate tests
    the actual neighbour (the reference's +-1 px pick and self-gate are
    not replicated).  Under a shard context the taps read the rank's rows
    of `gbuf` (decoded with `cam`) and `r_src` extended by a row exchange.
    Returns (rng_state, merged reservoir)."""
    h, w = view.depth.shape
    dev = view.depth.device
    # |offset| <= spatial_radius, so every in-bounds tap is inside the halo
    s_halo = int(math.ceil(cfg.spatial_radius))
    sh = get_shard()
    row0, H = 0, h
    src_view, src_resv = view, r_src
    if sh is not None:
        H = cfg.height
        row0 = sh.rows(H)[0]
        ext = exchange_rows(sh, {"gbuf": gbuf, "resv": r_src}, s_halo,
                            "direct.spatial")
        src_view = decode_gbuffer(ext["gbuf"], cam.pos, center_rays(
            cam, H, w, rows=_halo_rows(sh, H, s_halo, dev)))
        src_resv = ext["resv"]
    ys = torch.arange(row0, row0 + h, dtype=torch.int64,
                      device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(h, w)
    spatial = empty_di_reservoir(h, w, device=dev)
    for _round in range(max(cfg.spatial_rounds, 1)):
        agg = empty_di_reservoir(h, w, device=dev)
        for _k in range(cfg.spatial_neighbors):
            rng_state, oy, ox = _disk_offset(cfg, rng_state)
            ny, nx = ys + oy, xs + ox
            inb = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < w)
            not_self = (oy != 0) | (ox != 0)
            nyc = torch.clamp(ny, 0, H - 1)
            nxc = torch.clamp(nx, 0, w - 1)
            n_view, _ = halo_gather_tree(src_view, nyc, nxc, s_halo)
            n_resv, _ = halo_gather_tree(src_resv, nyc, nxc, s_halo)
            gates = _spatial_gates(view, n_view) & inb & not_self
            rng_state, u = erng.rand(rng_state)
            agg = resv.resv_merge_same_target(agg, n_resv, u, enabled=gates)
        rng_state, u = erng.rand(rng_state)
        spatial = resv.resv_merge_same_target(spatial, agg, u)
    rng_state, u = erng.rand(rng_state)
    return rng_state, resv.resv_merge_same_target(r_src, spatial, u)
