"""Edge-avoiding a-trous wavelet denoiser (port of
eidola_tpu/render/denoise.py:atrous_level / atrous_denoise; ref
shaders/denoise_direct.comp:19-71, denoise_common.glsl:15-55).

Each level applies a 5x5 B3-spline kernel with taps at stride 2^level,
weighted by
    exp(-|lum_p - lum_q| / sigma_lum)
  * exp(-||n_p - n_q||^2 / sigma_norm)
  * exp(-||x_p - x_q||^2 / (sigma_depth * 2^level))
  * a hard material-hash gate.
In the torch level taps are static shifted slices of an edge-padded
tensor, as in the JAX package.  `bilateral_denoise` is the single-pass
alternative (ref denoise_direct.comp:73-137, compile-time
DENOISER_DIRECT_BILATERAL); no RenderConfig selects it.

On the card a level is one launch of a hand-written kernel
(ops/atrous.py, csrc/atrous.cu) with the same arithmetic, bit for bit:
the taps clamp their rows and columns in the kernel, so nothing is
padded, and `atrous_denoise` launches only the level kernels (4 + 5 a
default frame, where the torch level issued ~875 launches each).  CPU
tensors take the torch level (`atrous_level`).

Under a shard context (ops/halo.py) each level reads the rows that its
taps reach beyond the rank's band (2 * 2^level) from the ranks above and
below: one row exchange of the image per level.  The edge stops read the
same view planes at every level, so `atrous_denoise` exchanges them once,
at its largest pad.  At the image border the exchange gives edge rows,
the padding of the single-process filter.
"""
from __future__ import annotations

import math

import torch

from ..ops import atrous
from ..ops.halo import get_shard
from ..ops.math import luminance
from ..parallel.exchange import exchange_rows
from .gbuffer import GBufferView

_K5 = [1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0]


def _pad(a, pad: int):
    """Edge ('replicate') padding of the two leading axes."""
    h, w = a.shape[:2]
    rows = torch.clamp(torch.arange(-pad, h + pad, device=a.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pad, w + pad, device=a.device), 0, w - 1)
    return a[rows][:, cols]


def _pad_cols(a, pad: int):
    """Edge padding of the second axis only (the rows came padded)."""
    w = a.shape[1]
    return a[:, torch.clamp(torch.arange(-pad, w + pad, device=a.device), 0,
                            w - 1)]


def _view_planes(view: GBufferView):
    """The planes of the view the edge stops read."""
    return (view.pos, view.nrm, view.mat_hash, view.valid)


def _shift(a, dy: int, dx: int, pad: int):
    """Static shifted view of an edge-padded array (H+2p, W+2p, ...)."""
    h = a.shape[0] - 2 * pad
    w = a.shape[1] - 2 * pad
    return a[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _edge_stopped(img, view: GBufferView, taps, sigma_lum, sigma_norm,
                  sigma_depth, view_ext=None):
    """The weighted mean over `taps` (dy, dx, spatial weight k) of the
    edge-padded image, each tap weighted by k and the edge stops (luma,
    normal, position, material gate); pixels without a surface keep
    their value.  Under a shard context the padded rows come from a row
    exchange; `view_ext` = (the view planes exchanged with e >= pad rows,
    e) saves exchanging them here."""
    pad = max(max(abs(dy), abs(dx)) for dy, dx, _ in taps)
    sh = get_shard()
    if sh is None:
        img_p = _pad(img, pad)
        pos_p, nrm_p, hash_p, valid_p = [_pad(a, pad)
                                         for a in _view_planes(view)]
    else:
        img_p = _pad_cols(exchange_rows(sh, img, pad, "denoise.img"), pad)
        if view_ext is None:
            view_ext = (exchange_rows(sh, _view_planes(view), pad,
                                      "denoise.view"), pad)
        planes, e = view_ext
        h = img.shape[0]
        pos_p, nrm_p, hash_p, valid_p = [
            _pad_cols(a[e - pad:e + h + pad], pad) for a in planes]

    lum_c = luminance(img)
    inv_sl = 1.0 / torch.clamp(sigma_lum, min=1e-4)
    inv_sn = 1.0 / torch.clamp(sigma_norm, min=1e-4)
    inv_sd = 1.0 / torch.clamp(sigma_depth, min=1e-4)

    acc = torch.zeros_like(img)
    wsum = torch.zeros_like(lum_c)
    for dy, dx, k in taps:
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

        w = k * w_l * w_n * w_x * gate.to(torch.float32)
        acc = acc + q_img * w[..., None]
        wsum = wsum + w

    out = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return torch.where(view.valid[..., None], out, img)


def atrous_level(img, view: GBufferView, level: int, sigma_lum, sigma_norm,
                 sigma_depth, view_ext=None):
    """One a-trous iteration at stride 2^level (ref
    denoise_direct.comp:19-71): the torch level, which `atrous_denoise`
    runs for CPU tensors and ops/atrous.py's kernel equals on the card."""
    stride = 1 << level
    taps = [((iy - 2) * stride, (ix - 2) * stride, ky * kx)
            for iy, ky in enumerate(_K5) for ix, kx in enumerate(_K5)]
    return _edge_stopped(img, view, taps, sigma_lum, sigma_norm,
                         sigma_depth * stride, view_ext=view_ext)


def atrous_denoise(img, view: GBufferView, levels: int, sigma_lum, sigma_norm,
                   sigma_depth):
    """Levels 0..levels-1 (ref renderer.cpp:178-202: 4 direct / 5
    indirect iterations): on the card one kernel launch a level."""
    sh = get_shard()
    view_ext = None
    if sh is not None and levels > 0:
        e = 2 << (levels - 1)               # the last level's pad
        view_ext = (exchange_rows(sh, _view_planes(view), e,
                                  "denoise.view"), e)
    if img.device.type != "cpu":
        planes, e = view_ext or (_view_planes(view), 0)
        exchange = None if sh is None else (
            lambda a, pad: exchange_rows(sh, a, pad, "denoise.img"))
        return atrous.run_levels(img, atrous.View(*planes), levels,
                                 sigma_lum, sigma_norm, sigma_depth,
                                 e_view=e, exchange=exchange)
    for level in range(levels):
        img = atrous_level(img, view, level, sigma_lum, sigma_norm,
                           sigma_depth, view_ext=view_ext)
    return img


def bilateral_denoise(img, view: GBufferView, radius: int, sigma_lum,
                      sigma_norm, sigma_depth):
    """Single-pass bilateral filter over a (2 radius + 1)^2 window with a
    Gaussian spatial weight and the a-trous edge stops (ref
    denoise_direct.comp:73-137)."""
    sigma_px = max(radius / 2.0, 1.0)
    taps = [(dy, dx, math.exp(-(dx * dx + dy * dy)
                              / (2.0 * sigma_px * sigma_px)))
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    return _edge_stopped(img, view, taps, sigma_lum, sigma_norm, sigma_depth)
