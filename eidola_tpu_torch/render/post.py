"""Post/tonemap pass (port of eidola_tpu/render/post.py; ref
shaders/post.frag:29-176): exposure (manual, global or local auto) ->
filmic tonemap -> grade -> vignette -> PCG dither.

Under a shard context (ops/halo.py) the image is the rank's rows.  The
log-average luminance is a sum of logs and a count, all_reduced (so its
rounding differs from the single-process mean).  The local exposure's
luminance pyramid is down-sampled on the rank while the band's row count
is even: its first row is then even too, so each 2x2 block is one of the
whole image's and the level is exactly the whole image's rows of the
band.  At the first level whose band has an odd row count (at 1920x1088
on 8 ranks: level 3, 136 x 240 texels) the ranks all_gather that small
plane, and every rank builds the coarser levels from the whole plane.
Vignette and dither read the global row and the full height.
"""
from __future__ import annotations

import torch

from ..ops import rng as erng
from ..ops.halo import get_shard
from ..ops.math import luminance
from ..parallel.exchange import all_gather_rows, all_reduce_sum
from ..ops.tonemap import apply_tonemap
from .config import TonemapParams

_EPSILON = 0.05
_PHI = 2.0
_LEVELS = 7


def avg_luminance(img):
    lum = torch.clamp(luminance(img), min=1e-6)
    sh = get_shard()
    if sh is None:
        return torch.exp(torch.mean(torch.log(lum)))
    s = all_reduce_sum(sh, torch.stack([
        torch.log(lum).sum(dtype=torch.float64),
        torch.tensor(float(lum.numel()), dtype=torch.float64,
                     device=lum.device)]), "post.avg_luminance")
    return torch.exp(s[0] / s[1]).to(torch.float32)


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
    if get_shard() is not None:
        return _lum_pyramid_band(get_shard(), lum, out_w, levels)
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


def _lum_pyramid_band(sh, lum, out_w, levels):
    """The rank's rows of _lum_pyramid over the whole image (see the
    module docstring)."""
    n = lum.shape[0]
    rows = torch.arange(sh.rank * n, (sh.rank + 1) * n, device=lum.device)
    out, cur, cur_row0, whole = [lum], lum, sh.rank * n, False
    for _ in range(levels - 1):
        if not whole and cur.shape[0] % 2:
            cur = all_gather_rows(sh, cur, "post.pyramid")
            cur_row0, whole = 0, True
        gh = cur.shape[0] * (1 if whole else sh.world)   # the whole level
        if gh > 1 or cur.shape[1] > 1:
            cur = _down2(cur)
            cur_row0 //= 2
            gh = cur.shape[0] * (1 if whole else sh.world)
        ry = -(-n * sh.world // gh)
        rx = -(-out_w // cur.shape[1])
        up = cur[rows // ry - cur_row0].repeat_interleave(rx, dim=1)
        out.append(up[:, :out_w])
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

    sh = get_shard()
    row0, H = (0, h) if sh is None else (sh.rank * h, sh.world * h)
    ys = (torch.arange(row0, row0 + h, dtype=torch.float32, device=dev)
          + 0.5) / H - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w - 0.5
    r2 = (ys * ys)[:, None] + (xs * xs)[None, :]
    c = c * (1.0 - tm.vignette * torch.clamp(r2 * 2.0, 0.0, 1.0))[..., None]

    seed = erng.seed_pixels(h, w, erng.u32(frame_word, device=dev) ^ 0xD17,
                            row0=row0)
    _, n = erng.rand(seed)
    c = c + (n[..., None] - 0.5) * (tm.dither.to(torch.float32) / 255.0)
    return torch.clamp(c, 0.0, 1.0)
