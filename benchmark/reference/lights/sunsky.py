"""The sun and sky: directions drawn uniformly in the cone of the sun's
disk, and the radiance of the sky dome with the disk and its glow, the
ground below the horizon, the night roll-off and the colour tweak.

Written from the JAX package's scene/sunsky.py (the reference renderer's
shaders/sun_and_sky.glsl:141-601 and env_sampling.glsl:110-125): the
Preetham sky (Perez luminance and chromaticity, zenith values, XYZ to
linear sRGB), the sun's transmittance colour by air mass, a disk whose
radiance gives a surface facing the sun an irradiance of 25 times the
intensity, a glow out to 50 radii, the ground lit by the sky's 25-point
cosine quadrature and the sun.  Everything, the ground's quadrature
included, is computed here in the precision `num` from the scene's
parameters alone.
"""
from __future__ import annotations

import math

import torch

XYZ_TO_RGB = ((3.2404542, -1.5371385, -0.4985314),
              (-0.9692660, 1.8760108, 0.0415560),
              (0.0556434, -0.2040259, 1.0572252))
RADIANCE_SCALE = 0.035      # the sky model's kcd/m^2 to scene radiance
GLOW_RADII = 50.0           # the glow's reach, in radii of the disk
HORIZON_BLUR = 0.05         # the sky blends into the ground below this
NIGHT_ELEVATION = 0.30901699  # sin 18 deg: the sky is dark below it


def dot(a, b):
    return (a * b).sum(-1)


def unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def make_frame(n):
    """(tangent, bitangent) about the unit normal n: the branchless
    Frisvad / Duff frame the renderer builds its local directions in."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def perez(cos_theta, gamma, cos_gamma, coef):
    a, b, c, d, e = coef
    cos_theta = torch.clamp(cos_theta, min=0.01)
    return ((1.0 + a * torch.exp(b / cos_theta))
            * (1.0 + c * torch.exp(d * gamma) + e * cos_gamma * cos_gamma))


def perez_coefficients(t):
    """(A, B, C, D, E) of the luminance Y and the chromaticities x, y at
    turbidity t."""
    return ((0.1787 * t - 1.4630, -0.3554 * t + 0.4275,
             -0.0227 * t + 5.3251, 0.1206 * t - 2.5771,
             -0.0670 * t + 0.3703),
            (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008,
             -0.0004 * t + 0.2125, -0.0641 * t - 0.8989,
             -0.0033 * t + 0.0452),
            (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092,
             -0.0079 * t + 0.2102, -0.0441 * t - 1.6537,
             -0.0109 * t + 0.0529))


def zenith_chromaticity(t, theta_s):
    t2, t3 = theta_s * theta_s, theta_s * theta_s * theta_s
    xz = (t * t * (0.00166 * t3 - 0.00375 * t2 + 0.00209 * theta_s)
          + t * (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * theta_s + 0.00394)
          + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25886))
    yz = (t * t * (0.00275 * t3 - 0.00610 * t2 + 0.00317 * theta_s)
          + t * (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s + 0.00516)
          + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * theta_s + 0.26688))
    return xz, yz


def luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


class SunSky:
    def __init__(self, *, device, num, sun_direction, sun_intensity,
                 sun_angular_radius, turbidity, ground_color, sky_tint,
                 saturation, redblueshift, night_color, sun_glow_intensity):
        self.num = num

        def held(x):
            return num(torch.as_tensor(x, dtype=torch.float64,
                                       device=device))

        self.sun = num(unit(held(sun_direction)))
        self.turbidity = num(torch.clamp(held(turbidity), min=2.0))
        self.radius = held(sun_angular_radius)
        self.intensity = held(sun_intensity)
        self.ground_color = held(ground_color)
        self.sky_tint = held(sky_tint)
        self.saturation = held(saturation)
        self.redblueshift = held(redblueshift)
        self.night_color = held(night_color)
        self.glow_intensity = held(sun_glow_intensity)
        self.xyz_to_rgb = held(XYZ_TO_RGB)
        sun = self.sun
        # the sky model's sun, held just above the horizon
        self.sun_sky = num(unit(torch.stack(
            [sun[0], torch.clamp(sun[1], min=0.001), sun[2]])))
        self.night = num(self.night_factor(sun[1]))
        self.sun_color = self.transmittance(sun[1])
        self.cos_max = num(torch.cos(self.radius))
        self.solid_angle = num(2.0 * math.pi * (1.0 - self.cos_max))
        self.cone_pdf = num(1.0 / torch.clamp(self.solid_angle, min=1e-9))
        self.ground_irradiance = self.sky_irradiance()
        disk = (self.sun_color * (25.0 / torch.clamp(self.solid_angle,
                                                     min=1e-12))
                * self.night)
        self.disk = num(self.tweak(disk) * self.intensity * self.sky_tint)

    @staticmethod
    def night_factor(elevation):
        f = torch.clamp((elevation + NIGHT_ELEVATION) / NIGHT_ELEVATION,
                        0.0, 1.0)
        f2 = f * f
        return torch.where(elevation >= 0.0, torch.ones_like(f), f2 * f2)

    def transmittance(self, elevation):
        """The colour of direct sunlight after aerosol, ozone and Rayleigh
        attenuation along the air mass at `elevation` (sin of it)."""
        num, t = self.num, self.turbidity
        dev = elevation.device
        f64 = dict(dtype=torch.float64, device=dev)
        wavelength = num(torch.tensor([0.610, 0.550, 0.470], **f64))
        ozone = num(torch.tensor([12.0, 8.5, 0.9], **f64))
        solar = num(torch.tensor([1.0, 0.992, 0.911], **f64))
        z = torch.clamp(elevation, min=1e-4)
        ang_deg = torch.rad2deg(torch.arccos(torch.clamp(z, 0.0, 1.0)))
        m = 1.0 / (z + 0.15 * torch.pow(torch.clamp(93.885 - ang_deg,
                                                     min=1.0), -1.253))
        beta = 0.04608 * t - 0.04586
        ta = torch.exp(-m * beta * torch.pow(wavelength, -1.3))
        to = torch.exp(-m * ozone * 0.0035)
        tr = torch.exp(-m * 0.008735 * torch.pow(wavelength, -4.08))
        c = ta * to * tr * solar
        return num(torch.where(elevation > 0.0, c, torch.zeros_like(c)))

    def sky_color(self, d):
        """The Perez sky's linear RGB along unit directions d, for the sky
        model's sun."""
        num, t, sun = self.num, self.turbidity, self.sun_sky
        cos_theta = torch.clamp(d[..., 1], -1.0, 1.0)
        cos_gamma = torch.clamp(dot(d, sun), -1.0, 1.0)
        gamma = torch.arccos(cos_gamma)
        theta_s = torch.arccos(torch.clamp(sun[1], -1.0, 1.0))
        coef_y, coef_x, coef_yc = perez_coefficients(t)
        chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
        yz_lum = torch.clamp((4.0453 * t - 4.9710) * torch.tan(chi)
                             - 0.2155 * t + 2.4192, min=0.0)
        xz, yz = zenith_chromaticity(t, theta_s)
        cos_ts = torch.cos(theta_s)
        one = torch.ones_like(theta_s)
        ct = torch.clamp(cos_theta, min=0.01)
        lum = yz_lum * (perez(ct, gamma, cos_gamma, coef_y)
                        / perez(one, theta_s, cos_ts, coef_y))
        x = xz * (perez(ct, gamma, cos_gamma, coef_x)
                  / perez(one, theta_s, cos_ts, coef_x))
        y = yz * (perez(ct, gamma, cos_gamma, coef_yc)
                  / perez(one, theta_s, cos_ts, coef_yc))
        y = torch.clamp(y, min=1e-4)
        xyz = torch.stack([x / y * lum, lum, (1.0 - x - y) / y * lum],
                          dim=-1)
        return num(torch.clamp(xyz @ self.xyz_to_rgb.T, min=0.0))

    def sky_irradiance(self):
        """The sky's irradiance on the ground: the mean of its colour over
        25 cosine-distributed directions of the upper hemisphere."""
        us = (torch.arange(5, dtype=torch.float64,
                           device=self.sun.device) + 0.5) / 5.0
        u, v = torch.meshgrid(us, us, indexing="ij")
        st, phi = torch.sqrt(u), 2.0 * math.pi * v
        dirs = torch.stack([st * torch.cos(phi),
                            torch.sqrt(torch.clamp(1.0 - u, min=0.0)),
                            st * torch.sin(phi)], dim=-1).reshape(-1, 3)
        return self.num(self.sky_color(self.num(dirs)).mean(dim=0))

    def tweak(self, rgb):
        """Saturation, then the red-blue shift."""
        inten = luminance(rgb)[..., None]
        sat = torch.clamp(self.saturation, min=0.0)
        out = torch.clamp(rgb * sat + inten * (1.0 - sat), min=0.0)
        red = self.redblueshift
        return out * torch.stack([1.0 + red, torch.ones_like(red),
                                  1.0 - red])

    def radiance(self, d):
        num, sun = self.num, self.sun
        d = num(d)
        gamma = torch.arccos(torch.clamp(dot(d, sun), -1.0, 1.0))
        d_sky = num(unit(torch.stack(
            [d[..., 0], torch.clamp(d[..., 1], min=0.001), d[..., 2]],
            dim=-1)))
        tint = self.sky_color(d_sky) * self.night
        core = 25.0 / torch.clamp(self.solid_angle * RADIANCE_SCALE,
                                  min=1e-12)
        glow = (torch.clamp(1.0 - gamma / (self.radius * GLOW_RADII),
                            0.0, 1.0) ** 3 * 50.0 * self.glow_intensity)
        disk = torch.where(gamma < self.radius, core, glow)
        tint = num(tint + self.sun_color * (disk * self.night)[..., None])
        ground = num(self.ground_color * (
            self.ground_irradiance
            + self.sun_color * torch.clamp(sun[1], min=0.0)) * self.night)
        down = torch.clamp(-d[..., 1] / HORIZON_BLUR, 0.0, 1.0)
        down = (down * down * (3.0 - 2.0 * down))[..., None]
        rgb = tint * (1.0 - down) + ground * down
        rgb = (self.tweak(rgb) * (RADIANCE_SCALE * self.intensity)
               * self.sky_tint)
        return num(torch.maximum(rgb, self.night_color * (1.0 - down)))

    def sample(self, u1, u2, u3, u4):
        """A direction uniform in the sun's cone from u1 (its cosine) and
        u2 (its turn); u3 and u4 are not read."""
        num, sun = self.num, self.sun
        u1, u2 = num(u1), num(u2)
        cz = 1.0 - u1 * (1.0 - self.cos_max)
        sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
        phi = 2.0 * math.pi * u2
        t, b = make_frame(sun)
        wi = num((sz * torch.cos(phi))[..., None] * t
                 + (sz * torch.sin(phi))[..., None] * b
                 + cz[..., None] * sun)
        return (wi, self.cone_pdf.expand(u1.shape),
                self.disk.expand(wi.shape))

    def pdf(self, d):
        inside = dot(self.num(d), self.sun) > self.cos_max
        return torch.where(inside, self.cone_pdf,
                           torch.zeros_like(self.cone_pdf))


def make(*, device, num, **light_args) -> SunSky:
    return SunSky(device=device, num=num, **light_args)
