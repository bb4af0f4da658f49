"""Shared math helpers (port of eidola_tpu/ops/math.py; ref
shaders/common.glsl).  Vectors live in the trailing axis of size 3."""
from __future__ import annotations

import math

import torch


def dot3(a, b):
    return torch.sum(a * b, dim=-1)


def length(v):
    return torch.sqrt(torch.clamp(dot3(v, v), min=0.0))


def normalize(v, eps: float = 1e-20):
    return v * torch.reciprocal(torch.clamp(length(v), min=eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def make_frame(n):
    """Branchless Frisvad/Duff orthonormal frame around unit normal n."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1
    )
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(t, b, n, v):
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def to_local(t, b, n, v):
    return torch.stack([dot3(v, t), dot3(v, b), dot3(v, n)], dim=-1)


def offset_ray(p, n):
    """Self-intersection-safe origin offset (ref common.glsl:98-113):
    integer-bit nudge along n, bit-exact with the JAX version."""
    int_scale = 256.0
    float_scale = 1.0 / 65536.0
    origin_thresh = 1.0 / 32.0

    of_i = (int_scale * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    p_i = torch.where(p < 0.0, p_bits - of_i, p_bits + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < origin_thresh, p + float_scale * n, p_i)


def spherical_uv(v):
    """Unit direction -> equirect uv (ref common.glsl:68-75)."""
    theta = torch.arccos(torch.clamp(v[..., 1], -1.0, 1.0))
    phi = torch.atan2(v[..., 2], v[..., 0])
    u = phi * (0.5 / math.pi) + 0.5
    w = theta / math.pi
    return torch.stack([u, w], dim=-1)


def uv_to_dir(uv):
    """Inverse of spherical_uv."""
    phi = (uv[..., 0] - 0.5) * (2.0 * math.pi)
    theta = uv[..., 1] * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta),
                        st * torch.sin(phi)], dim=-1)


def concentric_sample_disk(u1, u2):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    sx = torch.where(use_x, ox, oy)
    denom = torch.where(use_x, ox, oy)
    denom = torch.where(denom == 0.0, 1.0, denom)
    ratio = torch.where(use_x, oy / denom, ox / denom)
    theta = torch.where(
        use_x, (math.pi / 4.0) * ratio, (math.pi / 2.0) - (math.pi / 4.0) * ratio
    )
    r = torch.where(zero, 0.0, sx)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u1, u2):
    x, y = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def power_heuristic(f, g):
    """MIS power heuristic, beta=2 (ref common.glsl:177-180)."""
    f2 = f * f
    return torch.where(f2 + g * g > 0.0,
                       f2 / torch.clamp(f2 + g * g, min=1e-30), 0.0)


def hdr_to_ldr(c):
    return c / (1.0 + c)


def ldr_to_hdr(c):
    return c / torch.clamp(1.0 - c, min=1e-6)


def clamp_radiance(c, clamp_val):
    """Firefly clamp: scale so the max channel <= clamp_val."""
    m = torch.amax(c, dim=-1, keepdim=True)
    scale = torch.where(m > clamp_val, clamp_val / torch.clamp(m, min=1e-20),
                        1.0)
    return c * scale


def hash8bit(mat_id):
    """8-bit material hash (ref common.glsl:141-143); uint32-in-int64."""
    from .rng import mul32

    return mul32(mat_id.to(torch.int64) & 0xFFFFFFFF, 0x9E3779B1) >> 24
