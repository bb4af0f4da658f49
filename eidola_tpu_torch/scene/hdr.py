"""HDR environment importance sampling (port of the device half of
eidola_tpu/scene/hdr.py; ref src/hdr_sampling.cpp:107-242,
shaders/env_sampling.glsl:38-99).

Load time (host numpy): each texel of an equirect image is weighted by
luminance x solid angle and one alias table is built over all texels.
Device side: sampling is two gathers (alias redirect) and a uniform
direction within the chosen texel; evaluation is a bilinear lookup by
spherical uv.  The .hdr codec stays ROADMAP A11.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.alias_table import make_alias_table, sample_alias
from ..ops.math import spherical_uv, uv_to_dir
from ..utils.transfer import to_device
from .data import EnvMap

_LUM = np.asarray([0.2126, 0.7152, 0.0722])


def build_env_map(image: np.ndarray, *, device) -> EnvMap:
    """Solid-angle-weighted luminance alias map over all texels
    (ref hdr_sampling.cpp:181-242)."""
    image = np.asarray(image, np.float32)
    H, W = image.shape[:2]
    lum = (image[..., :3] * _LUM).sum(-1)
    theta = (np.arange(H) + 0.5) / H * np.pi
    d_omega = (2.0 * np.pi / W) * (np.pi / H) * np.sin(theta)[:, None]
    table, integral = make_alias_table((lum * d_omega).ravel())
    return to_device(EnvMap(
        image=np.ascontiguousarray(image[..., :3]),
        table=table,
        integral=np.float32(integral),
        average=np.float32(integral / (4.0 * np.pi)),
    ), device)


def _texel_solid_angle(y, H: int, W: int):
    theta = (y.to(torch.float32) + 0.5) / H * math.pi
    return (2.0 * math.pi / W) * (math.pi / H) * torch.clamp(
        torch.sin(theta), min=1e-6)


def env_eval(env: EnvMap, d, hdr_multiplier=1.0):
    """Radiance along direction d (bilinear; ref pathtrace.glsl:40-47)."""
    H, W = env.image.shape[:2]
    uv = spherical_uv(d)
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.remainder(x0 + 1, W)
    x0 = torch.remainder(x0, W)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    y0 = torch.clamp(y0, 0, H - 1)
    img = env.image
    c00, c01 = img[y0, x0], img[y0, x1]
    c10, c11 = img[y1, x0], img[y1, x1]
    c = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx)
                                                  + c11 * fx) * fy
    return c * hdr_multiplier


def env_pdf(env: EnvMap, d):
    """Solid-angle pdf of env_sample for direction d."""
    H, W = env.image.shape[:2]
    uv = spherical_uv(d)
    x = torch.clamp((uv[..., 0] * W).to(torch.int64), 0, W - 1)
    y = torch.clamp((uv[..., 1] * H).to(torch.int64), 0, H - 1)
    return env.table.pdf[y * W + x] / _texel_solid_angle(y, H, W)


def env_sample(env: EnvMap, u1, u2, u3, u4, hdr_multiplier=1.0):
    """Draw a direction ~ luminance: texel via the alias table, then
    uniform within the texel (ref env_sampling.glsl:38-99).
    Returns (dir, pdf_solid_angle, radiance)."""
    H, W = env.image.shape[:2]
    flat, pmf = sample_alias(env.table, u1, u2)
    y = flat // W
    x = flat % W
    u = (x.to(torch.float32) + u3) / W
    v = (y.to(torch.float32) + u4) / H
    d = uv_to_dir(torch.stack([u, v], dim=-1))
    pdf = pmf / _texel_solid_angle(y, H, W)
    return d, pdf, env.image[y, x] * hdr_multiplier
