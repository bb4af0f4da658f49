"""Stateless counter-based RNG, bit-exact with eidola_tpu/ops/rng.py
(ref shaders/random.glsl:34-102).

uint32 arithmetic is emulated in int64 tensors holding values in
[0, 2**32): every add, shift and multiply is masked back to 32 bits, and
products are split so no intermediate leaves the int64 range.  Right
shifts of non-negative int64 values are logical, so
`state >> ((state >> 28) + 4)` matches the uint32 original.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(x, *, device=None) -> torch.Tensor:
    """Any int tensor / python int -> int64 tensor of its uint32 value."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & M32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & M32


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64 (b: int or tensor)."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def tea(val0, val1, rounds: int = 16):
    """TEA hash seed mixer (ref random.glsl:34-48)."""
    v0, v1 = torch.broadcast_tensors(u32(val0), u32(val1))
    s = torch.zeros_like(v0)
    delta = 0x9E3779B9
    k = (0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E)
    for _ in range(rounds):
        s = (s + delta) & M32
        v0 = (v0 + ((((v1 << 4) + k[0]) & M32) ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + k[1]) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + k[2]) & M32) ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + k[3]) & M32))) & M32
    return v0


def _permute(state):
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def pcg(state):
    """PCG-RXS-M-XS single-word advance (ref random.glsl:59-66)."""
    return _permute(u32(state))


def pcg_advance(state):
    """LCG advance + output permutation."""
    state = (mul32(u32(state), 747796405) + 2891336453) & M32
    return state, _permute(state)


def pcg2d(v):
    """pcg2d hash (ref random.glsl:70-78). v: (..., 2) uint32-in-int64."""
    v = u32(v)
    x = (mul32(v[..., 0], 1664525) + 1013904223) & M32
    y = (mul32(v[..., 1], 1664525) + 1013904223) & M32
    x = (x + mul32(y, 1664525)) & M32
    y = (y + mul32(x, 1664525)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    x = (x + mul32(y, 1664525)) & M32
    y = (y + mul32(x, 1664525)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    return torch.stack([x, y], dim=-1)


def pcg3d(v):
    """pcg3d hash (ref random.glsl:82-92). v: (..., 3) uint32-in-int64."""
    v = (mul32(u32(v), 1664525) + 1013904223) & M32
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + mul32(y, z)) & M32
    y = (y + mul32(z, x)) & M32
    z = (z + mul32(x, y)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + mul32(y, z)) & M32
    y = (y + mul32(z, x)) & M32
    z = (z + mul32(x, y)) & M32
    return torch.stack([x, y, z], dim=-1)


def _to_float01(bits):
    """uint32 -> float32 in [0, 1) using the mantissa trick."""
    mant = (u32(bits) >> 9) | 0x3F800000       # < 2**31: fits int32
    return mant.to(torch.int32).view(torch.float32) - 1.0


def rand(state):
    """Advance state, return (new_state, float32 uniform [0,1))."""
    new_state, word = pcg_advance(state)
    return new_state, _to_float01(word)


def seed_pixels(h: int, w: int, frame_word, *, device=None):
    """Per-pixel seeds for one frame: tea(pixelIndex, frame_word)."""
    if isinstance(frame_word, torch.Tensor):
        device = frame_word.device
    idx = torch.arange(h * w, dtype=torch.int64, device=device).reshape(h, w)
    return tea(idx, u32(frame_word, device=device))
