"""ReSTIR GI indirect stage at quarter pixel count (port of
eidola_tpu/render/indirect.py; ref shaders/indirect_stage.comp:129-309).

Per half-res pixel: rebuild the primary surface from the full-res
G-buffer, BSDF-sample a first bounce and trace it, collect the radiance
arriving from its hit (NEE there plus MIS-weighted deeper hits; the
depth-1 segment itself adds nothing, DI covers it), with tiled
multi-bounce: exactly round(p * n_tiles) 8x8 tiles trace the deep
bounces on a compacted lane set, compensated by 1/p.  Then a ReSTIR GI
reservoir with temporal reuse, shading and HDR->LDR.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import reservoir as resv
from ..ops import rng as erng
from ..ops.halo import halo_gather_tree
from ..ops.math import (clamp_radiance, hdr_to_ldr, luminance, make_frame,
                        normalize, offset_ray, to_local, to_world)
from ..scene.camera import Camera
from ..scene.data import SceneData
from .bsdf import BsdfParams, eval_bsdf, sample_bsdf
from .config import RESTIR_NONE, RESTIR_RIS, RenderConfig, RenderParams
from .direct import _temporal_gates
from .gbuffer import GBufferView
from .shade_state import State, get_state
from .tracer import trace_closest, trace_radiance

_TMIN = 1e-4
_TMAX = 1e8
_ENV_DIST = 1e6


class IndirectOut(NamedTuple):
    illum_ldr: torch.Tensor  # (h2, w2, 3) demodulated indirect illumination
    resv: dict               # GI reservoirs to carry


def empty_gi_reservoir(h2: int, w2: int, *, device) -> dict:
    f = dict(dtype=torch.float32, device=device)
    sample = {k: torch.zeros((h2, w2, 3), **f) for k in ("xs", "ns", "l")}
    return resv.make_reservoir(sample, (h2, w2), device=device)


def _surface_from_view(view: GBufferView, cam: Camera) -> State:
    """Rebuild a demodulated (albedo = 1) shading State from the decoded
    G-buffer (ref pathtrace.glsl:296-360)."""
    ones3 = torch.ones_like(view.pos)
    return State(
        pos=view.pos, nrm=view.nrm, geo_nrm=view.nrm,
        uv=torch.zeros(view.pos.shape[:-1] + (2,), dtype=torch.float32,
                       device=view.pos.device),
        albedo=ones3, opacity=torch.ones_like(view.depth),
        metallic=view.metallic, roughness=view.roughness, ior=view.ior,
        transmission=view.transmission, emission=torch.zeros_like(ones3),
        mat_id=view.mat_hash.to(torch.int64), valid=view.valid)


def _long_tile_lanes(cfg: RenderConfig, frame_word, h2: int, w2: int):
    """Pick exactly round(p * n_tiles) tiles to trace deep bounces this
    frame (ref indirect_stage.comp:283-288 flips one coin per 8x8
    workgroup).  The tiles are the first k of the tile ids ordered by a
    pcg2d key salted with the frame word, exactly as the JAX package picks
    them.  Returns (flat lane indices (k*ts*ts,) with out-of-image lanes
    set to the sentinel h2*w2, inverse scale n_tiles / k)."""
    ts = cfg.multibounce_tile
    th = (h2 + ts - 1) // ts
    tw = (w2 + ts - 1) // ts
    n_tiles = th * tw
    k_long = max(1, int(round(cfg.multibounce_prob * n_tiles)))
    dev = frame_word.device
    tid = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    salt = torch.broadcast_to((frame_word + 0x9E37) & erng.M32, (n_tiles,))
    key = erng.pcg2d(torch.stack([erng.mul32(tid, 7919), salt], -1))[..., 0]
    long_ids = torch.argsort(key, stable=True)[:k_long]
    ty, tx = long_ids // tw, long_ids % tw
    d = torch.arange(ts, dtype=torch.int64, device=dev)
    rows = ty[:, None, None] * ts + d[None, :, None]
    cols = tx[:, None, None] * ts + d[None, None, :]
    inside = (rows < h2) & (cols < w2)
    flat = torch.where(inside, rows * w2 + cols, h2 * w2).reshape(-1)
    return flat, float(n_tiles) / float(k_long)


def indirect_stage(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                   cam: Camera, view_full: GBufferView, motion_full,
                   prev_view_full: GBufferView, prev_resv: dict, rng_state,
                   frame_word, timer=None):
    """K2.  rng_state: (h2, w2) uint32-in-int64 stream of the half-res
    lanes; frame_word: the frame's salt (picks the deep tiles).  `timer`
    (utils.profiler.StageTimer) marks gi_trace and gi_resample.
    Returns (rng_state, IndirectOut)."""
    stride = 2 if cfg.indirect_half_res else 1
    h2 = cfg.height // stride
    w2 = cfg.width // stride
    dev = rng_state.device
    f32 = dict(dtype=torch.float32, device=dev)
    mark = timer.mark if timer is not None else (lambda name: None)

    view = GBufferView(*[a[::stride, ::stride] for a in view_full])
    surf = _surface_from_view(view, cam)
    wo = normalize(torch.broadcast_to(cam.pos, surf.pos.shape) - surf.pos)

    # --- first bounce direction (BSDF sample at xv) -------------- K2:155
    rng_state, u1 = erng.rand(rng_state)
    rng_state, u2 = erng.rand(rng_state)
    rng_state, u3 = erng.rand(rng_state)
    bp = BsdfParams(albedo=view.albedo, metallic=surf.metallic,
                    roughness=surf.roughness)
    t, b = make_frame(surf.nrm)
    wo_l = to_local(t, b, surf.nrm, wo)
    wi_l, p1, _ = sample_bsdf(bp, wo_l, u1, u2, u3)
    d1 = to_world(t, b, surf.nrm, wi_l)
    gen_ok = surf.valid & (p1 > 1e-9) & (wi_l[..., 2] > 0.0)

    origin = offset_ray(surf.pos, surf.nrm)
    rng_state, rec = trace_closest(
        cfg, scene, origin, d1, torch.full((h2, w2), _TMIN, **f32),
        torch.where(gen_ok, _TMAX, -1.0), rng_state)
    cone = ((2.0 * stride * cam.proj_inv[1, 1] / cfg.height)
            if cfg.texture_mips else None)
    xs_state = get_state(scene, origin, d1, rec.tri, rec.t, rec.u, rec.v,
                         cone_angle=cone)
    hit1 = xs_state.valid & gen_ok

    # the depth-1 segment adds no radiance (ReSTIR DI's NEE at the primary
    # vertex covers it, ref indirect_stage.comp:180-216): L is the
    # continuation only
    L = torch.zeros_like(xs_state.pos)
    if cfg.max_depth > 1:
        if cfg.tiled_multibounce and cfg.max_depth > 2:
            rng_state, L_one_all, _ = trace_radiance(
                cfg, scene, params, None, None, rng_state, num_bounces=1,
                start_state=xs_state, start_wo=-d1, nee_start_depth=0)
            flat, inv_p = _long_tile_lanes(cfg, frame_word, h2, w2)
            gidx = torch.clamp(flat, max=h2 * w2 - 1)

            def g(a):
                return a.reshape((h2 * w2,) + tuple(a.shape[2:]))[gidx]

            xs_c = State(*[g(f) for f in xs_state])
            rng_c = erng.pcg(g(rng_state) ^ 0xB5297A4D)
            d1_c = g(d1)
            _, L_sub_c, _, L_one_c = trace_radiance(
                cfg, scene, params, None, None, rng_c,
                num_bounces=cfg.max_depth - 1, start_state=xs_c,
                start_wo=-d1_c, nee_start_depth=0, snapshot_after_depth=1)
            deep = (L_sub_c - L_one_c) * inv_p
            deep_full = torch.zeros((h2 * w2 + 1, 3), **f32).index_add_(
                0, flat, deep)[:h2 * w2].reshape(h2, w2, 3)
            L_cont = L_one_all + deep_full
        else:
            rng_state, L_cont, _ = trace_radiance(
                cfg, scene, params, None, None, rng_state,
                num_bounces=cfg.max_depth - 1, start_state=xs_state,
                start_wo=-d1, nee_start_depth=0)
        L = L + torch.where(hit1[..., None], L_cont, 0.0)
    mark("gi_trace")

    xs = torch.where(hit1[..., None], xs_state.pos, origin + d1 * _ENV_DIST)
    ns = torch.where(hit1[..., None], xs_state.nrm, -d1)

    # --- ReSTIR GI reservoir ------------------------------------ K2:228
    use_restir = cfg.restir_mode not in (RESTIR_NONE, RESTIR_RIS)
    p_hat_new = luminance(L)
    w_new = torch.where(gen_ok & (p1 > 1e-9),
                        p_hat_new / torch.clamp(p1, min=1e-9), 0.0)
    r = empty_gi_reservoir(h2, w2, device=dev)
    rng_state, u = erng.rand(rng_state)
    r = resv.resv_update(r, {"xs": xs, "ns": ns, "l": L}, w_new, u)

    if use_restir:
        # temporal fetch via the motion vector at coord*stride -- K2:234
        motion = motion_full[::stride, ::stride]
        m_ok = motion[..., 0] >= 0
        hist_y2 = torch.clamp(torch.div(motion[..., 0], stride,
                                        rounding_mode="floor"), 0, h2 - 1)
        hist_x2 = torch.clamp(torch.div(motion[..., 1], stride,
                                        rounding_mode="floor"), 0, w2 - 1)
        hist_resv, r_halo = halo_gather_tree(
            prev_resv, hist_y2, hist_x2, max(cfg.temporal_halo // stride, 1))
        # geometric gates vs the history G-buffer at the full-res coord
        hy = torch.clamp(motion[..., 0], 0, cfg.height - 1)
        hx = torch.clamp(motion[..., 1], 0, cfg.width - 1)
        hist_view, v_halo = halo_gather_tree(prev_view_full, hy, hx,
                                             cfg.temporal_halo, stride=stride)
        gates = _temporal_gates(view, hist_view) & m_ok & r_halo & v_halo
        rng_state, u = erng.rand(rng_state)
        r = resv.resv_merge_same_target(r, hist_resv, u, enabled=gates)
        r = resv.resv_clamp(r, 2.0 * params.reservoir_clamp)
    r = resv.resv_check(r)

    # --- shade --------------------------------------------------- K2:255
    sel = r["sample"]
    dir_s = normalize(sel["xs"] - surf.pos)
    wi_sel = to_local(t, b, surf.nrm, dir_s)
    f = eval_bsdf(BsdfParams(albedo=torch.ones_like(view.albedo),
                             metallic=surf.metallic,
                             roughness=surf.roughness), wo_l, wi_sel)
    cos_i = torch.clamp(wi_sel[..., 2], min=0.0)
    big_w = resv.resv_big_w(r, luminance(sel["l"]))
    illum = sel["l"] * f * (cos_i * big_w)[..., None]
    illum = torch.where(surf.valid[..., None], illum, 0.0)
    illum = clamp_radiance(illum, params.firefly_clamp)
    mark("gi_resample")
    return rng_state, IndirectOut(illum_ldr=hdr_to_ldr(illum), resv=r)
