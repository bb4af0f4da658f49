"""Runtime configuration (port of eidola_tpu/render/config.py).

- `RenderConfig` (frozen dataclass) = structural switches: the same fields
  and defaults as the JAX package.
- `RenderParams` / `TonemapParams` = per-frame scalars, here NamedTuples
  of 0-d tensors on the render device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# DebugMode channels (ref host_device.h:128-139)
DEBUG_NONE = 0
DEBUG_DIRECT = 1
DEBUG_INDIRECT = 2
DEBUG_BASE_COLOR = 3
DEBUG_NORMAL = 4
DEBUG_DEPTH = 5
DEBUG_METALLIC = 6
DEBUG_EMISSIVE = 7
DEBUG_ROUGHNESS = 8
DEBUG_TEXCOORD = 9

# ReSTIR modes (ref host_device.h:142-148)
RESTIR_NONE = 0
RESTIR_RIS = 1
RESTIR_SPATIAL = 2
RESTIR_TEMPORAL = 3
RESTIR_SPATIOTEMPORAL = 4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static renderer configuration (field-for-field the JAX one)."""
    width: int = 512
    height: int = 512
    max_depth: int = 4
    ris_sample_num: int = 4
    restir_mode: int = RESTIR_TEMPORAL
    spatial_rounds: int = 0
    spatial_neighbors: int = 5
    spatial_radius: float = 30.0
    temporal_halo: int = 64
    denoise: bool = True
    denoise_direct_levels: int = 4
    denoise_indirect_levels: int = 5
    tiled_multibounce: bool = True
    multibounce_tile: int = 8
    multibounce_prob: float = 0.25
    russian_roulette: bool = True
    rr_depth: int = 1
    use_mis: bool = True
    use_nee: bool = True
    indirect_half_res: bool = True
    indirect_enabled: bool = True
    env_mode: str = "sunsky"
    debug_mode: int = DEBUG_NONE
    accumulate: bool = True
    modulate_albedo: bool = True
    traversal_max_steps: int = 8192
    alpha_geometry: bool = False
    alpha_hops: int = 4
    texture_mips: bool = True
    primary_seed: bool = False
    shadow_cadence: int = 1
    tonemap_kind: int = 0

    @property
    def half_width(self) -> int:
        return max(self.width // 2, 1)

    @property
    def half_height(self) -> int:
        return max(self.height // 2, 1)


class RenderParams(NamedTuple):
    """Dynamic per-frame scalars (RtxState push-constant analog).
    time_word is an int64 tensor holding a uint32 value."""
    time_word: torch.Tensor
    firefly_clamp: torch.Tensor
    hdr_multiplier: torch.Tensor
    environment_prob: torch.Tensor
    reservoir_clamp: torch.Tensor
    sigma_lum_direct: torch.Tensor
    sigma_norm_direct: torch.Tensor
    sigma_depth_direct: torch.Tensor
    sigma_lum_indirect: torch.Tensor
    sigma_norm_indirect: torch.Tensor
    sigma_depth_indirect: torch.Tensor


def default_params(time_word: int = 0, *, device) -> RenderParams:
    """Defaults mirroring sample_example.hpp:154-184."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return RenderParams(
        time_word=torch.tensor(int(time_word) & 0xFFFFFFFF,
                               dtype=torch.int64, device=device),
        firefly_clamp=f32(80.0),
        hdr_multiplier=f32(1.0),
        environment_prob=f32(0.25),
        reservoir_clamp=f32(20.0),
        sigma_lum_direct=f32(4.0),
        sigma_norm_direct=f32(128.0),
        sigma_depth_direct=f32(2.0),
        sigma_lum_indirect=f32(4.0),
        sigma_norm_indirect=f32(128.0),
        sigma_depth_indirect=f32(2.0),
    )


class TonemapParams(NamedTuple):
    """Tonemapper push constant analog (ref host_device.h:336-351)."""
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    vignette: torch.Tensor
    avg_lum: torch.Tensor
    zoom: torch.Tensor
    auto_exposure: torch.Tensor     # int bitfield: 1 = auto key, 2 = local
    exposure: torch.Tensor
    dither: torch.Tensor            # int 0/1
    y_white: torch.Tensor
    key: torch.Tensor


def default_tonemap(*, device) -> TonemapParams:
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    i64 = lambda x: torch.tensor(x, dtype=torch.int64, device=device)
    return TonemapParams(
        brightness=f32(1.0),
        contrast=f32(1.0),
        saturation=f32(1.0),
        vignette=f32(0.0),
        avg_lum=f32(1.0),
        zoom=f32(1.0),
        auto_exposure=i64(0),
        exposure=f32(1.0),
        dither=i64(1),
        y_white=f32(0.5),
        key=f32(0.5),
    )
