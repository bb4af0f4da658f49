"""Tonemapping operators + sRGB converters (port of
eidola_tpu/ops/tonemap.py; ref shaders/tonemapping.glsl:24-105)."""
from __future__ import annotations

import torch

TONEMAP_UNCHARTED2 = 0
TONEMAP_HEJL_RICHARD = 1
TONEMAP_ACES = 2


def srgb_to_linear(c):
    return torch.where(
        c <= 0.04045, c / 12.92,
        torch.pow((torch.clamp(c, min=0.04045) + 0.055) / 1.055, 2.4),
    )


def linear_to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=0.0031308), 1.0 / 2.4) - 0.055,
    )


def _uncharted2_curve(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def tonemap_uncharted2(color):
    exposure_bias = 2.0
    W = torch.tensor(11.2, dtype=torch.float32, device=color.device)
    curr = _uncharted2_curve(exposure_bias * color)
    white_scale = 1.0 / _uncharted2_curve(W)
    return linear_to_srgb(torch.clamp(curr * white_scale, 0.0, 1.0))


def tonemap_hejl_richard(color):
    c = torch.clamp(color - 0.004, min=0.0)
    return (c * (6.2 * c + 0.5)) / (c * (6.2 * c + 1.7) + 0.06)


def tonemap_aces(color):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = torch.clamp(color, min=0.0)
    tone = torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    return linear_to_srgb(tone)


def apply_tonemap(color, kind: int = TONEMAP_UNCHARTED2):
    if kind == TONEMAP_UNCHARTED2:
        return tonemap_uncharted2(color)
    if kind == TONEMAP_HEJL_RICHARD:
        return tonemap_hejl_richard(color)
    if kind == TONEMAP_ACES:
        return tonemap_aces(color)
    raise ValueError(f"unknown tonemap kind {kind}")
