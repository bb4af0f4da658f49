"""Metallic-roughness BSDF with VNDF GGX sampling (port of
eidola_tpu/render/bsdf.py; ref shaders/pbr_metallicworkflow.glsl:22-173).
Local shading space (n = +z); eval returns f without the cosine."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.math import cosine_sample_hemisphere, cross, dot3, normalize


class BsdfParams(NamedTuple):
    albedo: torch.Tensor     # (..., 3)
    metallic: torch.Tensor   # (...,)
    roughness: torch.Tensor  # (...,)


def _alpha(p: BsdfParams):
    return torch.clamp(p.roughness, min=1e-4)


def _f0(p: BsdfParams):
    m = p.metallic[..., None]
    return 0.08 * (1.0 - m) + p.albedo * m


def _fresnel_schlick(f0, cos_h):
    c = torch.clamp(1.0 - cos_h, 0.0, 1.0)
    return f0 + (1.0 - f0) * (c ** 5)[..., None]


def _ggx_d(alpha, cos_nh):
    a2 = alpha * alpha
    d = cos_nh * cos_nh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-12)


def _smith_g1(alpha, cos_nv):
    k = alpha * 0.5
    return cos_nv / torch.clamp(cos_nv * (1.0 - k) + k, min=1e-9)


def _spec_prob(p: BsdfParams):
    return 1.0 / (2.0 - p.metallic)


def eval_bsdf(p: BsdfParams, wo, wi):
    """BRDF value f(wo, wi) in local space; zero below the horizon."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    valid = (cos_o > 1e-6) & (cos_i > 1e-6)
    h = normalize(wo + wi)
    cos_nh = torch.clamp(h[..., 2], 0.0, 1.0)
    cos_oh = torch.clamp(dot3(wo, h), 0.0, 1.0)
    alpha = _alpha(p)
    D = _ggx_d(alpha, cos_nh)
    G = _smith_g1(alpha, torch.clamp(cos_o, min=1e-6)) * _smith_g1(
        alpha, torch.clamp(cos_i, min=1e-6))
    F = _fresnel_schlick(_f0(p), cos_oh)
    spec = (D * G / torch.clamp(4.0 * cos_o * cos_i, min=1e-9))[..., None]
    diff = p.albedo * ((1.0 - p.metallic) / math.pi)[..., None]
    f = diff * (1.0 - F) + spec * F
    return torch.where(valid[..., None], f, 0.0)


def pdf_bsdf(p: BsdfParams, wo, wi):
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    valid = (cos_o > 1e-6) & (cos_i > 1e-6)
    h = normalize(wo + wi)
    cos_nh = torch.clamp(h[..., 2], 0.0, 1.0)
    alpha = _alpha(p)
    D = _ggx_d(alpha, cos_nh)
    g1 = _smith_g1(alpha, torch.clamp(cos_o, min=1e-6))
    pdf_spec = D * g1 / torch.clamp(4.0 * cos_o, min=1e-9)
    pdf_diff = torch.clamp(cos_i, min=0.0) / math.pi
    ps = _spec_prob(p)
    pdf = ps * pdf_spec + (1.0 - ps) * pdf_diff
    return torch.where(valid, pdf, 0.0)


def _sample_vndf(alpha, wo, u1, u2):
    vh = normalize(torch.stack([alpha * wo[..., 0], alpha * wo[..., 1],
                                wo[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device)
    t1 = torch.where(
        (lensq > 1e-10)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], -1),
        torch.broadcast_to(x_axis, vh.shape))
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = t1 * p1[..., None] + t2 * p2[..., None] + vh * p3[..., None]
    h = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                     torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return normalize(h)


def sample_bsdf(p: BsdfParams, wo, u1, u2, u3):
    """Sample an incident direction.  Returns (wi, pdf, f)."""
    alpha = _alpha(p)
    pick_spec = u3 < _spec_prob(p)
    h = _sample_vndf(alpha, wo, u1, u2)
    wi_spec = 2.0 * dot3(wo, h)[..., None] * h - wo
    wi_diff = cosine_sample_hemisphere(u1, u2)
    wi = normalize(torch.where(pick_spec[..., None], wi_spec, wi_diff))
    return wi, pdf_bsdf(p, wo, wi), eval_bsdf(p, wo, wi)
