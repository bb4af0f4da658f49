"""The frame's image stages, written out from the JAX package's
render/denoise.py, render/compose.py, render/post.py and ops/tonemap.py
(the reference renderer's denoise_direct.comp, compose.comp, post.frag
and tonemapping.glsl), in the reference's precision `num`.

  denoise   the edge-avoiding a-trous wavelet: per level a 5x5 B3-spline
            with taps 2^level apart on an edge-padded image, weighted by
            exp(-|dlum| / s_lum) exp(-|dn|^2 / s_norm)
            exp(-|dx|^2 / (s_depth 2^level)) and a hard material gate
  compose   (direct + nearest-upsampled indirect) x albedo + emission,
            each of the two re-expanded by c / (1 - c)
  post      exposure 1, Uncharted 2 filmic curve to sRGB, grade (contrast,
            brightness, saturation 1, vignette 0), 1/255 of dither from
            the frame's seeds
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng

K5 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


class Sigmas(NamedTuple):
    lum: float
    norm: float
    depth: float


# the renderer's defaults (ref sample_example.hpp:154-184), one set for
# the direct and one for the indirect light
DIRECT = Sigmas(4.0, 128.0, 2.0)
INDIRECT = Sigmas(4.0, 128.0, 2.0)


def luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def ldr_to_hdr(c):
    return c / torch.clamp(1.0 - c, min=1e-6)


def _pad(a, pad: int):
    h, w = a.shape[:2]
    rows = torch.clamp(torch.arange(-pad, h + pad, device=a.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pad, w + pad, device=a.device), 0, w - 1)
    return a[rows][:, cols]


def _shift(a, dy: int, dx: int, pad: int):
    h, w = a.shape[0] - 2 * pad, a.shape[1] - 2 * pad
    return a[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def atrous_level(img, pos, nrm, mat, valid, level: int, s: Sigmas, num):
    stride = 1 << level
    pad = 2 * stride
    img_p, pos_p, nrm_p = _pad(img, pad), _pad(pos, pad), _pad(nrm, pad)
    mat_p, valid_p = _pad(mat, pad), _pad(valid, pad)
    lum_c = luminance(img)
    inv_sl = 1.0 / max(s.lum, 1e-4)
    inv_sn = 1.0 / max(s.norm, 1e-4)
    inv_sd = 1.0 / max(s.depth * stride, 1e-4)
    acc = torch.zeros_like(img)
    wsum = torch.zeros_like(lum_c)
    for iy, ky in enumerate(K5):
        for ix, kx in enumerate(K5):
            dy, dx = (iy - 2) * stride, (ix - 2) * stride
            q = _shift(img_p, dy, dx, pad)
            dn = nrm - _shift(nrm_p, dy, dx, pad)
            dp = pos - _shift(pos_p, dy, dx, pad)
            gate = ((_shift(mat_p, dy, dx, pad) == mat)
                    & _shift(valid_p, dy, dx, pad) & valid)
            wt = ((ky * kx) * torch.exp(-(luminance(q) - lum_c).abs()
                                        * inv_sl)
                  * torch.exp(-(dn * dn).sum(-1) * inv_sn)
                  * torch.exp(-(dp * dp).sum(-1) * inv_sd) * gate)
            acc = acc + q * wt[..., None]
            wsum = wsum + wt
    out = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return num(torch.where(valid[..., None], out, img))


def denoise(img, pos, nrm, mat, valid, levels: int, s: Sigmas, num):
    """The a-trous chain over `levels` levels of the LDR image (H, W, 3)
    on the surface planes (positions, normals, material hashes, valid)."""
    img, pos, nrm = num(img), num(pos), num(nrm)
    for level in range(levels):
        img = atrous_level(img, pos, nrm, mat, valid, level, s, num)
    return img


def compose(direct_ldr, indirect_ldr_half, emission, albedo, num):
    h, w = direct_ldr.shape[:2]
    up = num(indirect_ldr_half)
    if tuple(up.shape[:2]) != (h, w):
        up = up.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
    hdr = (ldr_to_hdr(num(direct_ldr)) + ldr_to_hdr(up)) * num(albedo) \
        + num(emission)
    return num(hdr)


def _linear_to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.clamp(c, min=0.0031308) ** (1.0 / 2.4)
                       - 0.055)


def _uncharted2(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f) - e / f


def post(hdr, frame_word: int, num):
    """The LDR image (H, W, 3) in [0, 1] of the displayed HDR."""
    h, w = hdr.shape[:2]
    white = _uncharted2(torch.tensor(11.2, dtype=num.dtype))
    c = _linear_to_srgb(torch.clamp(_uncharted2(2.0 * num(hdr)) / white,
                                    0.0, 1.0))
    lum = luminance(c)[..., None]           # saturation 1, vignette 0
    c = lum + (c - lum)
    _, n = rng.rand(rng.seed_pixels(h, w, (int(frame_word) & rng.M32)
                                    ^ 0xD17, hdr.device))
    c = c + (num(n)[..., None] - 0.5) * (1.0 / 255.0)
    return num(torch.clamp(c, 0.0, 1.0))
