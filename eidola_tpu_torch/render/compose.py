"""Compose: re-modulate albedo and merge direct + indirect (port of
eidola_tpu/render/compose.py; ref shaders/compose.comp:23-42)."""
from __future__ import annotations

import torch

from ..ops.math import ldr_to_hdr
from .gbuffer import GBufferView


def upsample2x(img_half, out_h: int, out_w: int):
    """Nearest upsample of the half-res indirect field."""
    up = img_half.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[:out_h, :out_w]


def compose(direct_ldr, indirect_ldr_half, emission, view: GBufferView,
            modulate: bool = True):
    h, w = direct_ldr.shape[:2]
    direct = ldr_to_hdr(direct_ldr)
    if indirect_ldr_half is not None:
        if tuple(indirect_ldr_half.shape[:2]) != (h, w):
            indirect = ldr_to_hdr(upsample2x(indirect_ldr_half, h, w))
        else:
            indirect = ldr_to_hdr(indirect_ldr_half)
    else:
        indirect = torch.zeros_like(direct)
    if modulate:
        return (direct + indirect) * view.albedo + emission
    return indirect
