"""The frame function (port of eidola_tpu/render/frame.py):
    state', outputs = render_frame(cfg, scene, camera, params, tonemap, state)

Stage chain per frame (ref renderer.cpp:163-205):
  direct stage (G-buffer + ReSTIR DI)            -> K1
  indirect stage (ReSTIR GI, quarter res)        -> K2
  a-trous denoise direct / indirect              -> K3 / K4
  compose (re-modulate albedo, upsample)         -> K5
  accumulation + tonemap/post                    -> K8
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import rng as erng
from ..ops.math import ldr_to_hdr
from ..scene.camera import Camera
from ..scene.data import SceneData
from .compose import compose
from .config import (DEBUG_BASE_COLOR, DEBUG_DEPTH, DEBUG_DIRECT,
                     DEBUG_EMISSIVE, DEBUG_INDIRECT, DEBUG_METALLIC,
                     DEBUG_NONE, DEBUG_NORMAL, DEBUG_ROUGHNESS,
                     DEBUG_TEXCOORD, RenderConfig, RenderParams,
                     TonemapParams)
from .denoise import atrous_denoise
from .direct import DirectOut, direct_stage, empty_di_reservoir
from .gbuffer import (GBuffer, GBufferView, center_rays, decode_gbuffer,
                      empty_gbuffer)
from .indirect import IndirectOut, empty_gi_reservoir, indirect_stage
from .post import post_process


class FrameState(NamedTuple):
    """Carried frame-to-frame state (field-for-field the JAX FrameState)."""
    frame_idx: torch.Tensor   # () int64
    gbuf: GBuffer
    di_resv: dict
    di_vis: torch.Tensor
    gi_resv: dict             # GI reservoirs (H/2, W/2)
    prev_cam: Camera
    accum: torch.Tensor       # (H, W, 3)
    accum_count: torch.Tensor  # () f32


def init_frame_state(cfg: RenderConfig, cam: Camera) -> FrameState:
    h, w = cfg.height, cfg.width
    dev = cam.pos.device
    stride = 2 if cfg.indirect_half_res else 1
    return FrameState(
        frame_idx=torch.zeros((), dtype=torch.int64, device=dev),
        gbuf=empty_gbuffer(h, w, device=dev),
        di_resv=empty_di_reservoir(h, w, device=dev),
        di_vis=torch.full((h, w), -1.0, dtype=torch.float32, device=dev),
        gi_resv=empty_gi_reservoir(h // stride, w // stride, device=dev),
        prev_cam=cam,
        accum=torch.zeros((h, w, 3), dtype=torch.float32, device=dev),
        accum_count=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _camera_moved(cam: Camera, prev: Camera):
    return (torch.any(torch.abs(cam.view - prev.view) > 1e-6)
            | torch.any(torch.abs(cam.proj - prev.proj) > 1e-6))


def _debug_image(cfg: RenderConfig, out_d: DirectOut, direct_hdr,
                 indirect_hdr):
    """Debug channels (ref DebugMode host_device.h:128-139)."""
    v = out_d.view
    mode = cfg.debug_mode
    if mode == DEBUG_DIRECT:
        return direct_hdr
    if mode == DEBUG_INDIRECT:
        return indirect_hdr
    if mode == DEBUG_BASE_COLOR:
        return v.albedo
    if mode == DEBUG_NORMAL:
        return v.nrm * 0.5 + 0.5
    if mode == DEBUG_DEPTH:
        return torch.clamp(v.depth / 10.0, 0.0, 1.0)[..., None].expand(
            *v.depth.shape, 3)
    if mode == DEBUG_METALLIC:
        return v.metallic[..., None].expand(*v.metallic.shape, 3)
    if mode == DEBUG_ROUGHNESS:
        return v.roughness[..., None].expand(*v.roughness.shape, 3)
    if mode == DEBUG_EMISSIVE:
        return out_d.emission
    if mode == DEBUG_TEXCOORD:
        uv = out_d.state.uv
        return torch.cat([torch.remainder(uv, 1.0),
                          torch.zeros_like(uv[..., :1])], dim=-1)
    raise ValueError(f"unknown debug mode {mode}")


def render_frame(cfg: RenderConfig, scene: SceneData, cam: Camera,
                 params: RenderParams, tm: TonemapParams, state: FrameState,
                 timer=None):
    """One full frame.  Returns (new_state, outputs dict).  `timer`
    (utils.profiler.StageTimer) marks the stages of the frame."""
    h, w = cfg.height, cfg.width
    stride = 2 if cfg.indirect_half_res else 1
    h2, w2 = h // stride, w // stride
    dev = cam.pos.device
    mark = timer.mark if timer is not None else (lambda name: None)
    if timer is not None:
        timer.start()

    moved = _camera_moved(cam, state.prev_cam)
    reset = moved & cfg.accumulate
    accum = torch.where(reset, 0.0, state.accum)
    accum_count = torch.where(reset, 0.0, state.accum_count)

    salt = (params.time_word + state.frame_idx) & erng.M32
    rng_full = erng.seed_pixels(h, w, salt)
    rng_half = erng.seed_pixels(h2, w2, salt ^ 0x8F1BBCDC)

    # ---- direct stage (K1) ---------------------------------------------
    rng_full, out_d = direct_stage(
        cfg, scene, params, cam, state.gbuf, state.di_resv, state.prev_cam,
        rng_full, timer=timer)

    # ---- indirect stage (K2) -------------------------------------------
    if cfg.indirect_enabled and cfg.max_depth >= 1:
        prev_view_full = decode_gbuffer(
            state.gbuf, state.prev_cam.pos, center_rays(state.prev_cam, h, w))
        rng_half, out_i = indirect_stage(
            cfg, scene, params, cam, out_d.view, out_d.motion,
            prev_view_full, state.gi_resv, rng_half, frame_word=salt,
            timer=timer)
    else:
        out_i = IndirectOut(
            illum_ldr=torch.zeros((h2, w2, 3), dtype=torch.float32,
                                  device=dev),
            resv=state.gi_resv)

    # ---- denoise (K3/K4) -----------------------------------------------
    if cfg.denoise:
        direct_ldr = atrous_denoise(
            out_d.illum_ldr, out_d.view, cfg.denoise_direct_levels,
            params.sigma_lum_direct, params.sigma_norm_direct,
            params.sigma_depth_direct)
        view_half = GBufferView(*[a[::stride, ::stride] for a in out_d.view])
        indirect_ldr = atrous_denoise(
            out_i.illum_ldr, view_half, cfg.denoise_indirect_levels,
            params.sigma_lum_indirect, params.sigma_norm_indirect,
            params.sigma_depth_indirect)
        mark("denoise")
    else:
        direct_ldr = out_d.illum_ldr
        indirect_ldr = out_i.illum_ldr

    # ---- compose (K5) + progressive accumulation ------------------------
    hdr = compose(direct_ldr, indirect_ldr if cfg.indirect_enabled else None,
                  out_d.emission, out_d.view, modulate=cfg.modulate_albedo)
    if cfg.accumulate:
        accum = accum + hdr
        accum_count = accum_count + 1.0
        display_hdr = accum / torch.clamp(accum_count, min=1.0)
    else:
        display_hdr = hdr

    if cfg.debug_mode != DEBUG_NONE:
        up = indirect_ldr.repeat_interleave(stride, 0).repeat_interleave(
            stride, 1)[:h, :w]
        display_hdr = _debug_image(cfg, out_d, ldr_to_hdr(direct_ldr),
                                   ldr_to_hdr(up))

    # ---- post / tonemap (K8) -------------------------------------------
    image = post_process(display_hdr, tm, frame_word=salt,
                         tonemap_kind=cfg.tonemap_kind)
    mark("compose_post")

    new_state = FrameState(
        frame_idx=state.frame_idx + 1,
        gbuf=out_d.gbuf,
        di_resv=out_d.resv,
        di_vis=out_d.vis,
        gi_resv=out_i.resv,
        prev_cam=cam,
        accum=accum,
        accum_count=accum_count,
    )
    outputs = {
        "image": image,
        "hdr": display_hdr,
        "direct_ldr": direct_ldr,
        "indirect_ldr": indirect_ldr,
        "motion": out_d.motion,
    }
    return new_state, outputs


def make_step(cfg: RenderConfig):
    """The frame function for a fixed config (the JAX package's jitted
    step; PyTorch runs eagerly, so this is a plain closure)."""
    def step(scene, cam, params, tm, state, timer=None):
        return render_frame(cfg, scene, cam, params, tm, state, timer=timer)

    return step
