"""Post/tonemap pass (port of eidola_tpu/render/post.py; ref
shaders/post.frag:29-176): exposure (manual, global or local auto) ->
filmic tonemap -> grade -> vignette -> PCG dither."""
from __future__ import annotations

import torch

from ..ops import rng as erng
from ..ops.math import luminance
from ..ops.tonemap import apply_tonemap
from .config import TonemapParams

_EPSILON = 0.05
_PHI = 2.0
_LEVELS = 7


def avg_luminance(img):
    lum = torch.clamp(luminance(img), min=1e-6)
    return torch.exp(torch.mean(torch.log(lum)))


def _down2(a):
    h, w = a.shape
    if h % 2:
        a = torch.cat([a, a[-1:]], dim=0)
        h += 1
    if w % 2:
        a = torch.cat([a, a[:, -1:]], dim=1)
        w += 1
    return a.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def _lum_pyramid(lum, out_h, out_w, levels=_LEVELS + 1):
    out = [lum]
    cur = lum
    for _ in range(levels - 1):
        if cur.shape[0] > 1 or cur.shape[1] > 1:
            cur = _down2(cur)
        ry = -(-out_h // cur.shape[0])
        rx = -(-out_w // cur.shape[1])
        up = cur.repeat_interleave(ry, dim=0).repeat_interleave(rx, dim=1)
        out.append(up[:out_h, :out_w])
    return out


def tone_exposure(rgb, log_avg, key, y_white):
    y = torch.clamp(luminance(rgb), min=1e-9)
    ys = (key / log_avg) * y
    yd = ys * (1.0 + ys / (y_white * y_white)) / (1.0 + ys)
    return rgb * (yd / y)[..., None]


def tone_local_exposure(rgb, log_avg, key, y_white):
    h, w = rgb.shape[:2]
    y = torch.clamp(luminance(rgb), min=1e-9)
    factor = key / log_avg
    ys = factor * y
    pyr = _lum_pyramid(y, h, w)
    la = pyr[_LEVELS] * factor
    done = torch.zeros((h, w), dtype=torch.bool, device=rgb.device)
    for i in range(_LEVELS):
        v1 = pyr[i] * factor
        v2 = pyr[i + 1] * factor
        scale = float(1 << i)
        stop = (torch.abs(v1 - v2)
                / (key * (2.0 ** _PHI) / (scale * scale) + v1) > _EPSILON)
        la = torch.where(stop & ~done, v1, la)
        done = done | stop
    yd = ys / (1.0 + la)
    return rgb * (yd / y)[..., None]


def post_process(img, tm: TonemapParams, frame_word=0, tonemap_kind: int = 0):
    h, w = img.shape[:2]
    dev = img.device
    auto = (tm.auto_exposure & 1) > 0
    local = (tm.auto_exposure & 2) > 0
    avg = torch.where(auto, avg_luminance(img), torch.clamp(tm.avg_lum,
                                                             min=1e-6))
    c_global = tone_exposure(img, avg, tm.key, tm.y_white)
    c_local = tone_local_exposure(img, avg, tm.key, tm.y_white)
    c_auto = torch.where(local, c_local, c_global)
    c = torch.where(auto, c_auto, img * tm.exposure)

    c = apply_tonemap(c, tonemap_kind)

    c = (c - 0.5) * tm.contrast + 0.5 + (tm.brightness - 1.0)
    lum = luminance(c)[..., None]
    c = lum + (c - lum) * tm.saturation

    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w - 0.5
    r2 = (ys * ys)[:, None] + (xs * xs)[None, :]
    c = c * (1.0 - tm.vignette * torch.clamp(r2 * 2.0, 0.0, 1.0))[..., None]

    seed = erng.seed_pixels(h, w, erng.u32(frame_word, device=dev) ^ 0xD17)
    _, n = erng.rand(seed)
    c = c + (n[..., None] - 0.5) * (tm.dither.to(torch.float32) / 255.0)
    return torch.clamp(c, 0.0, 1.0)
