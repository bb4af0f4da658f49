"""Edge-avoiding a-trous wavelet denoiser (port of
eidola_tpu/render/denoise.py:atrous_level / atrous_denoise; ref
shaders/denoise_direct.comp:19-71, denoise_common.glsl:15-55).

Each level applies a 5x5 B3-spline kernel with taps at stride 2^level,
weighted by
    exp(-|lum_p - lum_q| / sigma_lum)
  * exp(-||n_p - n_q||^2 / sigma_norm)
  * exp(-||x_p - x_q||^2 / (sigma_depth * 2^level))
  * a hard material-hash gate.
Taps are static shifted slices of an edge-padded tensor, as in the JAX
package.  The single-pass `bilateral_denoise` stays ROADMAP A10.
"""
from __future__ import annotations

import torch

from ..ops.math import luminance
from .gbuffer import GBufferView

_K5 = [1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0]


def _pad(a, pad: int):
    """Edge ('replicate') padding of the two leading axes."""
    h, w = a.shape[:2]
    rows = torch.clamp(torch.arange(-pad, h + pad, device=a.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pad, w + pad, device=a.device), 0, w - 1)
    return a[rows][:, cols]


def _shift(a, dy: int, dx: int, pad: int):
    """Static shifted view of an edge-padded array (H+2p, W+2p, ...)."""
    h = a.shape[0] - 2 * pad
    w = a.shape[1] - 2 * pad
    return a[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def atrous_level(img, view: GBufferView, level: int, sigma_lum, sigma_norm,
                 sigma_depth):
    """One a-trous iteration at stride 2^level (ref
    denoise_direct.comp:19-71)."""
    stride = 1 << level
    pad = 2 * stride
    img_p = _pad(img, pad)
    pos_p = _pad(view.pos, pad)
    nrm_p = _pad(view.nrm, pad)
    hash_p = _pad(view.mat_hash, pad)
    valid_p = _pad(view.valid, pad)

    lum_c = luminance(img)
    inv_sl = 1.0 / torch.clamp(sigma_lum, min=1e-4)
    inv_sn = 1.0 / torch.clamp(sigma_norm, min=1e-4)
    inv_sd = 1.0 / torch.clamp(sigma_depth * stride, min=1e-4)

    acc = torch.zeros_like(img)
    wsum = torch.zeros_like(lum_c)
    for iy, ky in enumerate(_K5):
        for ix, kx in enumerate(_K5):
            dy = (iy - 2) * stride
            dx = (ix - 2) * stride
            q_img = _shift(img_p, dy, dx, pad)
            q_pos = _shift(pos_p, dy, dx, pad)
            q_nrm = _shift(nrm_p, dy, dx, pad)
            q_hash = _shift(hash_p, dy, dx, pad)
            q_valid = _shift(valid_p, dy, dx, pad)

            w_l = torch.exp(-torch.abs(luminance(q_img) - lum_c) * inv_sl)
            dn = view.nrm - q_nrm
            w_n = torch.exp(-torch.sum(dn * dn, dim=-1) * inv_sn)
            dp = view.pos - q_pos
            w_x = torch.exp(-torch.sum(dp * dp, dim=-1) * inv_sd)
            gate = (q_hash == view.mat_hash) & q_valid & view.valid

            w = (ky * kx) * w_l * w_n * w_x * gate.to(torch.float32)
            acc = acc + q_img * w[..., None]
            wsum = wsum + w

    out = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return torch.where(view.valid[..., None], out, img)


def atrous_denoise(img, view: GBufferView, levels: int, sigma_lum, sigma_norm,
                   sigma_depth):
    """Levels 0..levels-1 (ref renderer.cpp:178-202: 4 direct / 5
    indirect iterations)."""
    for level in range(levels):
        img = atrous_level(img, view, level, sigma_lum, sigma_norm,
                           sigma_depth)
    return img
