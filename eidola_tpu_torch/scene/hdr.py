"""HDR environment: the Radiance .hdr codec and importance sampling
(port of eidola_tpu/scene/hdr.py; ref src/hdr_sampling.cpp:56-242,
shaders/env_sampling.glsl:38-99).

Load time (host numpy): `load_hdr` reads a Radiance file (flat and
new-style RLE scanlines; a PNG through utils/png.py), and each texel of
the equirect image is weighted by luminance x solid angle into one alias
table over all texels.  Device side: sampling is two gathers (alias
redirect) and a uniform direction within the chosen texel; evaluation is
a bilinear lookup by spherical uv.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.alias_table import make_alias_table, sample_alias
from ..ops.math import spherical_uv, uv_to_dir
from ..utils.transfer import batched_device_put
from .data import EnvMap

_LUM = np.asarray([0.2126, 0.7152, 0.0722])


def load_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr into (H, W, 3) linear RGB, as the JAX
    package's load_hdr computes it, bit for bit (its RGBE scale is
    float64, and so is the result).  A PNG is read as 8-bit RGB / 255;
    any other format raises."""
    if path.endswith((".hdr", ".pic")):
        return _read_radiance(path)
    from ..utils.png import SIGNATURE, decode_png

    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a Radiance .hdr or a PNG file")
    return decode_png(data)[..., :3].astype(np.float32) / 255.0


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) linear (stb_image semantics)."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128-8)
    return (rgbe[..., :3].astype(np.float32)) * scale[..., None]


def _read_radiance(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance file")
    pos = 0
    while True:                      # header lines up to a blank one
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    H, W = int(res[1]), int(res[3])

    out = np.empty((H, W, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(H):
        if W < 8 or W > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            out[y] = buf[bp: bp + W * 4].reshape(W, 4)     # flat scanline
            bp += W * 4
            continue
        if (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != W:
            raise ValueError(f"{path}: scanline {y} has the wrong width")
        bp += 4
        for c in range(4):           # each component run-length coded
            x = 0
            while x < W:
                count = int(buf[bp])
                if count > 128:      # a run
                    out[y, x: x + count - 128, c] = buf[bp + 1]
                    x += count - 128
                    bp += 2
                else:                # literals
                    out[y, x: x + count, c] = buf[bp + 1: bp + 1 + count]
                    x += count
                    bp += 1 + count
    return _rgbe_to_float(out)


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) linear RGB as a flat Radiance .hdr (the JAX
    package's writer, byte for byte)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    m = img.max(-1)
    e = np.where(m > 1e-32, np.ceil(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, np.ldexp(1.0, (-e + 8).astype(np.int32)),
                     0.0)
    rgbe = np.zeros((H, W, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(
        np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        f.write(rgbe.tobytes())


def build_env_map(image: np.ndarray, *, device) -> EnvMap:
    """Solid-angle-weighted luminance alias map over all texels
    (ref hdr_sampling.cpp:181-242)."""
    image = np.asarray(image, np.float32)
    H, W = image.shape[:2]
    lum = (image[..., :3] * _LUM).sum(-1)
    theta = (np.arange(H) + 0.5) / H * np.pi
    d_omega = (2.0 * np.pi / W) * (np.pi / H) * np.sin(theta)[:, None]
    table, integral = make_alias_table((lum * d_omega).ravel())
    return batched_device_put(EnvMap(
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
