"""The frame function (port of eidola_tpu/render/frame.py):
    state', outputs = render_frame(cfg, scene, camera, params, tonemap, state)

This slice runs the direct-lighting frame: K1 direct stage, compose
(K5), progressive accumulation and post (K8).  The indirect stage (K2)
and the a-trous denoiser (K3/K4) come with the next slice, so
`indirect_enabled=True` and `denoise=True` raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import reservoir as resv
from ..ops import rng as erng
from ..scene.camera import Camera
from ..scene.data import SceneData
from .compose import compose
from .config import DEBUG_NONE, RenderConfig, RenderParams, TonemapParams
from .direct import direct_stage, empty_di_reservoir
from .gbuffer import GBuffer, empty_gbuffer
from .post import post_process


class FrameState(NamedTuple):
    """Carried frame-to-frame state (field-for-field the JAX FrameState)."""
    frame_idx: torch.Tensor   # () int64
    gbuf: GBuffer
    di_resv: dict
    di_vis: torch.Tensor
    gi_resv: dict             # GI reservoirs (H/2, W/2); unused until GI
    prev_cam: Camera
    accum: torch.Tensor       # (H, W, 3)
    accum_count: torch.Tensor  # () f32


def _empty_gi_reservoir(h: int, w: int, *, device) -> dict:
    """Same layout as eidola_tpu/render/indirect.py:empty_gi_reservoir."""
    f = dict(dtype=torch.float32, device=device)
    sample = {k: torch.zeros((h, w, 3), **f) for k in ("xs", "ns", "l")}
    return resv.make_reservoir(sample, (h, w), device=device)


def init_frame_state(cfg: RenderConfig, cam: Camera) -> FrameState:
    h, w = cfg.height, cfg.width
    dev = cam.pos.device
    stride = 2 if cfg.indirect_half_res else 1
    return FrameState(
        frame_idx=torch.zeros((), dtype=torch.int64, device=dev),
        gbuf=empty_gbuffer(h, w, device=dev),
        di_resv=empty_di_reservoir(h, w, device=dev),
        di_vis=torch.full((h, w), -1.0, dtype=torch.float32, device=dev),
        gi_resv=_empty_gi_reservoir(h // stride, w // stride, device=dev),
        prev_cam=cam,
        accum=torch.zeros((h, w, 3), dtype=torch.float32, device=dev),
        accum_count=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _camera_moved(cam: Camera, prev: Camera):
    return (torch.any(torch.abs(cam.view - prev.view) > 1e-6)
            | torch.any(torch.abs(cam.proj - prev.proj) > 1e-6))


def _check(cfg: RenderConfig):
    if cfg.indirect_enabled and cfg.max_depth >= 1:
        raise NotImplementedError(
            "the indirect stage (ReSTIR GI) is ported with the next slice "
            "(ROADMAP A6); use indirect_enabled=False")
    if cfg.denoise:
        raise NotImplementedError(
            "the a-trous denoiser is ported with the next slice "
            "(ROADMAP A7); use denoise=False")
    if cfg.debug_mode != DEBUG_NONE:
        raise NotImplementedError("debug channels are ported with ROADMAP A7")


def render_frame(cfg: RenderConfig, scene: SceneData, cam: Camera,
                 params: RenderParams, tm: TonemapParams, state: FrameState,
                 timer=None):
    """One direct-lighting frame.  Returns (new_state, outputs dict).
    `timer` (utils.profiler.StageTimer) marks the stages of the frame."""
    _check(cfg)
    h, w = cfg.height, cfg.width
    if timer is not None:
        timer.start()

    moved = _camera_moved(cam, state.prev_cam)
    reset = moved & cfg.accumulate
    accum = torch.where(reset, 0.0, state.accum)
    accum_count = torch.where(reset, 0.0, state.accum_count)

    salt = (params.time_word + state.frame_idx) & erng.M32
    rng_full = erng.seed_pixels(h, w, salt)

    rng_full, out_d = direct_stage(
        cfg, scene, params, cam, state.gbuf, state.di_resv, state.prev_cam,
        rng_full, timer=timer)

    direct_ldr = out_d.illum_ldr
    hdr = compose(direct_ldr, None, out_d.emission, out_d.view,
                  modulate=cfg.modulate_albedo)
    if cfg.accumulate:
        accum = accum + hdr
        accum_count = accum_count + 1.0
        display_hdr = accum / torch.clamp(accum_count, min=1.0)
    else:
        display_hdr = hdr

    image = post_process(display_hdr, tm, frame_word=salt,
                         tonemap_kind=cfg.tonemap_kind)
    if timer is not None:
        timer.mark("temporal_compose_post")

    new_state = FrameState(
        frame_idx=state.frame_idx + 1,
        gbuf=out_d.gbuf,
        di_resv=out_d.resv,
        di_vis=out_d.vis,
        gi_resv=state.gi_resv,
        prev_cam=cam,
        accum=accum,
        accum_count=accum_count,
    )
    outputs = {
        "image": image,
        "hdr": display_hdr,
        "direct_ldr": direct_ldr,
        "indirect_ldr": torch.zeros((h // 2, w // 2, 3), dtype=torch.float32,
                                    device=image.device),
        "motion": out_d.motion,
    }
    return new_state, outputs


def make_step(cfg: RenderConfig):
    """The frame function for a fixed config (the JAX package's jitted
    step; PyTorch runs eagerly, so this is a plain closure)."""
    def step(scene, cam, params, tm, state, timer=None):
        return render_frame(cfg, scene, cam, params, tm, state, timer=timer)

    return step
