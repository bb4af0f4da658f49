"""Texture sampling from the padded mip-atlas stack (port of
eidola_tpu/scene/textures.py): per-texture wrap modes and ray-cone
trilinear mip filtering; an untextured scene skips every gather."""
from __future__ import annotations

import torch

from .data import WRAP_CLAMP, WRAP_MIRROR, TexStack


def _wrap_coord(x, n, mode):
    rep = torch.remainder(x, n)
    clamp = torch.minimum(torch.clamp(x, min=0), n - 1)
    m = torch.remainder(x, torch.clamp(2 * n, min=1))
    mir = torch.where(m >= n, 2 * n - 1 - m, m)
    out = torch.where(mode == WRAP_CLAMP, clamp, rep)
    return torch.where(mode == WRAP_MIRROR, mir, out)


def _bilinear_level(stack: TexStack, tid, uv, level):
    """Bilinear fetch at integer mip `level` (per-lane int64)."""
    tw_stack = stack.data.shape[2] // 2
    hw = stack.size[tid]
    h = torch.clamp((hw[..., 0] + (1 << level) - 1) >> level, min=1)
    w = torch.clamp((hw[..., 1] + (1 << level) - 1) >> level, min=1)
    wrap = stack.wrap[tid]
    xoff = torch.where(
        level == 0, 0,
        2 * tw_stack - (tw_stack >> torch.clamp(level - 1, min=0)))

    u = uv[..., 0] * w.to(torch.float32) - 0.5
    v = uv[..., 1] * h.to(torch.float32) - 0.5
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    fx = (u - x0f)[..., None]
    fy = (v - y0f)[..., None]
    x0i = x0f.to(torch.int64)
    y0i = y0f.to(torch.int64)
    x0 = _wrap_coord(x0i, w, wrap[..., 0])
    x1 = _wrap_coord(x0i + 1, w, wrap[..., 0])
    y0 = _wrap_coord(y0i, h, wrap[..., 1])
    y1 = _wrap_coord(y0i + 1, h, wrap[..., 1])

    img = stack.data
    c00 = img[tid, y0, xoff + x0]
    c01 = img[tid, y0, xoff + x1]
    c10 = img[tid, y1, xoff + x0]
    c11 = img[tid, y1, xoff + x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (
        c10 * (1 - fx) + c11 * fx) * fy


def sample_texture(stack: TexStack, tex_id, uv, lod=None, footprint=None):
    """RGBA fetch with wrap modes and optional trilinear mip filtering;
    tex_id < 0 returns white ("no texture")."""
    if stack.data.shape[0] == 1 and stack.data.shape[1] == 1:
        return torch.ones(tuple(tex_id.shape) + (4,), dtype=torch.float32,
                          device=uv.device)
    tid = torch.clamp(tex_id, min=0)
    if footprint is not None:
        hw = stack.size[tid]
        res = torch.maximum(hw[..., 0], hw[..., 1]).to(torch.float32)
        lod = torch.log2(torch.clamp(footprint * res, min=1.0))
    if lod is None:
        c = _bilinear_level(stack, tid, uv, torch.zeros_like(tid))
    else:
        tw_stack = stack.data.shape[2] // 2
        max_l = max(int(tw_stack).bit_length() - 1, 0)
        hw = stack.size[tid]
        res = torch.maximum(hw[..., 0], hw[..., 1]).to(torch.float32)
        max_l_tex = torch.ceil(torch.log2(torch.clamp(res, min=1.0))).to(
            torch.int64)
        max_l_tex = torch.clamp(max_l_tex, max=max_l)
        lod = torch.minimum(torch.clamp(lod, min=0.0),
                            max_l_tex.to(torch.float32))
        l0 = torch.floor(lod).to(torch.int64)
        fl = (lod - l0.to(torch.float32))[..., None]
        c0 = _bilinear_level(stack, tid, uv, l0)
        c1 = _bilinear_level(stack, tid, uv, torch.minimum(l0 + 1, max_l_tex))
        c = c0 * (1.0 - fl) + c1 * fl
    none = (tex_id < 0)[..., None]
    return torch.where(none, torch.ones_like(c), c)


def sample_bilinear(stack: TexStack, tex_id, uv, lod=None, footprint=None):
    """Back-compat name; see sample_texture."""
    return sample_texture(stack, tex_id, uv, lod, footprint)
