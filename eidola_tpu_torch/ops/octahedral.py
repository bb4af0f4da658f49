"""Octahedral unit-vector <-> 32-bit codec, bit-exact with
eidola_tpu/ops/octahedral.py (ref shaders/compress.glsl:31-180).
Packed words are uint32 values held in int64 tensors."""
from __future__ import annotations

import numpy as np
import torch


def _oct_wrap(x, y):
    wx = (1.0 - torch.abs(y)) * torch.where(x >= 0.0, 1.0, -1.0)
    wy = (1.0 - torch.abs(x)) * torch.where(y >= 0.0, 1.0, -1.0)
    return wx, wy


def dir_to_oct(n):
    denom = torch.abs(n[..., 0]) + torch.abs(n[..., 1]) + torch.abs(n[..., 2])
    denom = torch.clamp(denom, min=1e-20)
    x = n[..., 0] / denom
    y = n[..., 1] / denom
    wx, wy = _oct_wrap(x, y)
    below = n[..., 2] < 0.0
    return torch.stack([torch.where(below, wx, x), torch.where(below, wy, y)],
                       dim=-1)


def oct_to_dir(o):
    x = o[..., 0]
    y = o[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    wx, wy = _oct_wrap(x, y)
    below = z < 0.0
    x = torch.where(below, wx, x)
    y = torch.where(below, wy, y)
    v = torch.stack([x, y, z], dim=-1)
    return v / torch.clamp(
        torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-20
    )


def encode_unit_u32(n):
    """Unit direction -> packed snorm16x2 word."""
    o = dir_to_oct(n)
    q = torch.round(torch.clamp(o, -1.0, 1.0) * 32767.0).to(torch.int64)
    qu = q & 0xFFFF
    return qu[..., 0] | (qu[..., 1] << 16)


def decode_unit_u32(p):
    p = p.to(torch.int64)
    lo = p & 0xFFFF
    hi = (p >> 16) & 0xFFFF
    lo = torch.where(lo >= 32768, lo - 65536, lo)
    hi = torch.where(hi >= 32768, hi - 65536, hi)
    o = torch.stack([lo, hi], dim=-1).to(torch.float32) / 32767.0
    return oct_to_dir(o)


def encode_unit_u32_np(n):
    """Pure-numpy encode_unit_u32 for host-side scene building."""
    n = np.asarray(n, np.float32)
    denom = np.maximum(
        np.abs(n[..., 0]) + np.abs(n[..., 1]) + np.abs(n[..., 2]), 1e-20
    )
    x = n[..., 0] / denom
    y = n[..., 1] / denom
    wx = (1.0 - np.abs(y)) * np.where(x >= 0.0, 1.0, -1.0)
    wy = (1.0 - np.abs(x)) * np.where(y >= 0.0, 1.0, -1.0)
    below = n[..., 2] < 0.0
    ox = np.where(below, wx, x)
    oy = np.where(below, wy, y)
    qx = np.round(np.clip(ox, -1.0, 1.0) * 32767.0).astype(np.int32)
    qy = np.round(np.clip(oy, -1.0, 1.0) * 32767.0).astype(np.int32)
    return (
        (qx & 0xFFFF).astype(np.uint32)
        | ((qy & 0xFFFF).astype(np.uint32) << np.uint32(16))
    )


def pack_unorm4x8_np(v):
    q = np.round(np.clip(np.asarray(v), 0.0, 1.0) * 255.0).astype(np.uint32)
    return (
        q[..., 0]
        | (q[..., 1] << np.uint32(8))
        | (q[..., 2] << np.uint32(16))
        | (q[..., 3] << np.uint32(24))
    )


def pack_unorm4x8(v):
    q = torch.round(torch.clamp(v, 0.0, 1.0) * 255.0).to(torch.int64)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)


def unpack_unorm4x8(p):
    p = p.to(torch.int64)
    return torch.stack(
        [p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF, (p >> 24) & 0xFF],
        dim=-1,
    ).to(torch.float32) / 255.0


def pack_albedo_hash(albedo, mat_hash):
    """Linear RGB in [0,1] + 8-bit hash -> word (ref direct_stage.comp:37-45)."""
    q = torch.round(torch.clamp(albedo, 0.0, 1.0) * 255.0).to(torch.int64)
    return (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
            | ((mat_hash.to(torch.int64) & 0xFF) << 24))


def unpack_albedo_hash(p):
    p = p.to(torch.int64)
    albedo = torch.stack(
        [p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF], dim=-1
    ).to(torch.float32) / 255.0
    return albedo, (p >> 24) & 0xFF
