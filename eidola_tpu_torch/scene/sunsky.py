"""Procedural sun & sky (port of eidola_tpu/scene/sunsky.py; ref
shaders/sun_and_sky.glsl:141-601).  Vectorized over direction tensors;
SunSkyParams fields are tensors on the render device."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.math import dot3, luminance, make_frame, normalize, to_world
from .data import SunSkyParams

_XYZ2RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)
_RADIANCE_SCALE = 0.035


def _perez(theta_cos, gamma, gamma_cos, A, B, C, D, E):
    theta_cos = torch.clamp(theta_cos, min=0.01)
    return (1.0 + A * torch.exp(B / theta_cos)) * (
        1.0 + C * torch.exp(D * gamma) + E * gamma_cos * gamma_cos)


def _zenith_chromaticity(T, ts):
    t2, t3 = ts * ts, ts * ts * ts
    xz = (T * T * (0.00166 * t3 - 0.00375 * t2 + 0.00209 * ts)
          + T * (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * ts + 0.00394)
          + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * ts + 0.25886))
    yz = (T * T * (0.00275 * t3 - 0.00610 * t2 + 0.00317 * ts)
          + T * (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * ts + 0.00516)
          + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * ts + 0.26688))
    return xz, yz


def _vec(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def calc_sun_color(sun_elev, turbidity):
    """Atmospheric transmittance colour of direct sunlight
    (ref sun_and_sky.glsl:141-165)."""
    z = torch.clamp(sun_elev, min=1e-4)
    wavelength = _vec([0.610, 0.550, 0.470], z)
    ko = _vec([12.0, 8.5, 0.9], z)
    sol = _vec([1.0, 0.992, 0.911], z)
    ang_deg = torch.rad2deg(torch.arccos(torch.clamp(z, 0.0, 1.0)))
    m = 1.0 / (z + 0.15 * torch.pow(torch.clamp(93.885 - ang_deg, min=1.0),
                                    -1.253))
    beta = 0.04608 * turbidity - 0.04586
    ta = torch.exp(-m * beta * torch.pow(wavelength, -1.3))
    to = torch.exp(-m * ko * 0.0035)
    tr = torch.exp(-m * 0.008735 * torch.pow(wavelength, -4.08))
    c = ta * to * tr * sol
    return torch.where(sun_elev > 0.0, c, torch.zeros_like(c))


def _night_factor(sun_elev):
    lmt = 0.30901699
    f = torch.clamp((sun_elev + lmt) / lmt, 0.0, 1.0)
    f2 = f * f
    return torch.where(sun_elev >= 0.0, 1.0, f2 * f2)


def _env_color(p: SunSkyParams, d, sun, T):
    """Perez sky colour for directions d (ref calc_env_color)."""
    cos_theta = torch.clamp(d[..., 1], -1.0, 1.0)
    cos_gamma = torch.clamp(dot3(d, sun), -1.0, 1.0)
    gamma = torch.arccos(cos_gamma)
    theta_s = torch.arccos(torch.clamp(sun[1], -1.0, 1.0))

    AY, BY = 0.1787 * T - 1.4630, -0.3554 * T + 0.4275
    CY, DY, EY = -0.0227 * T + 5.3251, 0.1206 * T - 2.5771, -0.0670 * T + 0.3703
    Ax, Bx = -0.0193 * T - 0.2592, -0.0665 * T + 0.0008
    Cx, Dx, Ex = -0.0004 * T + 0.2125, -0.0641 * T - 0.8989, -0.0033 * T + 0.0452
    Ay, By = -0.0167 * T - 0.2608, -0.0950 * T + 0.0092
    Cy, Dy, Ey = -0.0079 * T + 0.2102, -0.0441 * T - 1.6537, -0.0109 * T + 0.0529

    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * theta_s)
    Yz = torch.clamp((4.0453 * T - 4.9710) * torch.tan(chi) - 0.2155 * T
                     + 2.4192, min=0.0)
    xz, yz = _zenith_chromaticity(T, theta_s)

    cos_ts = torch.cos(theta_s)
    one = torch.ones((), dtype=torch.float32, device=d.device)
    denomY = _perez(one, theta_s, cos_ts, AY, BY, CY, DY, EY)
    denomx = _perez(one, theta_s, cos_ts, Ax, Bx, Cx, Dx, Ex)
    denomy = _perez(one, theta_s, cos_ts, Ay, By, Cy, Dy, Ey)

    ct = torch.clamp(cos_theta, min=0.01)
    Y = Yz * _perez(ct, gamma, cos_gamma, AY, BY, CY, DY, EY) / denomY
    x = xz * _perez(ct, gamma, cos_gamma, Ax, Bx, Cx, Dx, Ex) / denomx
    y = yz * _perez(ct, gamma, cos_gamma, Ay, By, Cy, Dy, Ey) / denomy

    y = torch.clamp(y, min=1e-4)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    xyz = torch.stack([X, Y, Z], dim=-1)
    return torch.clamp(xyz @ _vec(_XYZ2RGB, d).T, min=0.0)


def _irradiance(p: SunSkyParams, sun, T):
    """25-point cosine-hemisphere quadrature of the sky (calc_irrad)."""
    us = (np.arange(5) + 0.5) / 5.0
    dirs = []
    for u in us:
        for v in us:
            st = np.sqrt(u)
            phi = 2.0 * np.pi * v
            dirs.append([st * np.cos(phi), np.sqrt(max(1.0 - u, 0.0)),
                         st * np.sin(phi)])
    dd = torch.from_numpy(np.asarray(dirs, np.float32)).to(sun.device)
    return torch.mean(_env_color(p, dd, sun, T), dim=0)


def finalize_sunsky(p: SunSkyParams) -> SunSkyParams:
    """Precompute the ground irradiance on the host CPU (f32) from numpy
    params; returns numpy params with ground_irradiance set."""
    tp = SunSkyParams(*[torch.as_tensor(np.array(x)) for x in p])
    T = torch.clamp(tp.turbidity.float(), min=2.0)
    sun = normalize(tp.sun_direction.float())
    sun_c = normalize(torch.stack([sun[0], torch.clamp(sun[1], min=0.001),
                                   sun[2]]))
    irr = _irradiance(tp, sun_c, T)
    return p._replace(ground_irradiance=irr.numpy().astype(np.float32))


def _colortweak(rgb, saturation, redness):
    inten = luminance(rgb)[..., None]
    sat = torch.clamp(saturation, min=0.0)
    out = torch.clamp(rgb * sat + inten * (1.0 - sat), min=0.0)
    shift = torch.stack([1.0 + redness, torch.ones_like(redness),
                         1.0 - redness])
    return out * shift


def sky_radiance(p: SunSkyParams, d):
    """Sky dome radiance for unit directions d (..., 3), linear RGB."""
    T = torch.clamp(p.turbidity, min=2.0)
    sun = normalize(p.sun_direction)
    night = _night_factor(sun[1])
    sun_c = normalize(torch.stack([sun[0], torch.clamp(sun[1], min=0.001),
                                   sun[2]]))
    cos_gamma = torch.clamp(dot3(d, sun), -1.0, 1.0)
    gamma = torch.arccos(cos_gamma)
    downness = d[..., 1]
    d_c = normalize(torch.stack(
        [d[..., 0], torch.clamp(d[..., 1], min=0.001), d[..., 2]], dim=-1))

    tint = _env_color(p, d_c, sun_c, T) * night

    sun_color = calc_sun_color(sun[1], T)
    solid_angle = 2.0 * math.pi * (1.0 - torch.cos(p.sun_angular_radius))
    core_w = 25.0 / torch.clamp(solid_angle * _RADIANCE_SCALE, min=1e-12)
    glow_radius = p.sun_angular_radius * 50.0
    in_core = (gamma < p.sun_angular_radius).to(torch.float32)
    glow = (torch.clamp(1.0 - gamma / glow_radius, 0.0, 1.0) ** 3
            * 50.0 * p.sun_glow_intensity)
    disk_w = in_core * core_w + glow * (1.0 - in_core)
    tint = tint + sun_color * (disk_w * night)[..., None]

    irrad = p.ground_irradiance
    downcolor = p.ground_color * (
        irrad + sun_color * torch.clamp(sun[1], min=0.0)) * night
    hor_blur = 0.05
    dness = torch.clamp(-downness / hor_blur, 0.0, 1.0)
    dness = dness * dness * (3.0 - 2.0 * dness)
    rgb = tint * (1.0 - dness[..., None]) + downcolor * dness[..., None]
    night_w = 1.0 - dness

    rgb = _colortweak(rgb, p.saturation, p.redblueshift)
    rgb = rgb * (_RADIANCE_SCALE * p.sun_intensity) * p.sky_tint
    return torch.maximum(rgb, p.night_color * night_w[..., None])


def sun_disk_radiance(p: SunSkyParams):
    sun = normalize(p.sun_direction)
    night = _night_factor(sun[1])
    sun_color = calc_sun_color(sun[1], torch.clamp(p.turbidity, min=2.0))
    solid_angle = 2.0 * math.pi * (1.0 - torch.cos(p.sun_angular_radius))
    rad = sun_color * (25.0 / torch.clamp(solid_angle, min=1e-12)) * night
    rad = _colortweak(rad, p.saturation, p.redblueshift)
    return rad * p.sun_intensity * p.sky_tint


def sample_sun(p: SunSkyParams, u1, u2):
    """Uniform direction within the sun cone.  Returns (dir, pdf, radiance)."""
    sun = normalize(p.sun_direction)
    cos_max = torch.cos(p.sun_angular_radius)
    cz = 1.0 - u1 * (1.0 - cos_max)
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    phi = 2.0 * math.pi * u2
    local = torch.stack([sz * torch.cos(phi), sz * torch.sin(phi), cz], dim=-1)
    sb = torch.broadcast_to(sun, local.shape)
    t, b = make_frame(sb)
    d = to_world(t, b, sb, local)
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-9)
    rad = sun_disk_radiance(p)
    return d, torch.broadcast_to(pdf, u1.shape), torch.broadcast_to(rad, d.shape)


def sun_pdf(p: SunSkyParams, d):
    sun = normalize(p.sun_direction)
    cos_max = torch.cos(p.sun_angular_radius)
    inside = dot3(d, sun) > cos_max
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-9)
    return torch.where(inside, pdf, 0.0)
