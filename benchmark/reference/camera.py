"""The camera path and the primary rays, from the scene's view and the
traffic mix, in the reference's precision.

Conventions (the reference renderer's src/scene.cpp:777-826 and
shaders/pathtrace.glsl:260-270): a right-handed look-at view, a
perspective whose depth maps to [0, 1], and one ray a pixel through the
pixel's corner plus a jitter of two draws from the pixel's seed.  The
scene's own camera has the aspect 1; an orbiting camera is rebuilt each
frame with the image's aspect and a 60 degree field of view, 3 units
before the first eye, as the viewer's orbit control does.
"""
from __future__ import annotations

import math

import torch

from . import rng


def look_at(eye, center, up=(0.0, 1.0, 0.0)):
    f = center - eye
    f = f / torch.linalg.norm(f)
    s = torch.linalg.cross(f, torch.as_tensor(up, dtype=f.dtype,
                                              device=f.device))
    s = s / torch.linalg.norm(s)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=f.dtype, device=f.device)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -(s @ eye), -(u @ eye), f @ eye
    return m


def perspective(fovy_deg: float, aspect: float, like, znear=0.01,
                zfar=1000.0):
    f = 1.0 / math.tan(math.radians(fovy_deg) / 2.0)
    m = torch.zeros((4, 4), dtype=like.dtype, device=like.device)
    m[0, 0], m[1, 1] = f / aspect, f
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m


class CameraPath:
    """The camera of each frame of a traffic mix: held, or orbiting
    `orbit_rad` radians a frame about a pivot after the first frame."""

    def __init__(self, view, orbit_rad: float, width: int, height: int,
                 device):
        f64 = dict(dtype=torch.float64, device=device)
        eye, center, fovy = view
        self.eye0 = torch.as_tensor(eye, **f64)
        self.center0 = torch.as_tensor(center, **f64)
        self.fovy = float(fovy)
        self.orbit = float(orbit_rad)
        self.aspect = width / height
        fwd = self.center0 - self.eye0
        self.pivot = self.eye0 + fwd / torch.linalg.norm(fwd) * 3.0

    def moved(self, index: int) -> bool:
        """Whether frame `index`'s camera differs from the one before."""
        return bool(self.orbit) and index > 0

    def matrices(self, index: int):
        """(eye, view, projection) of frame `index`, float64."""
        if not (self.orbit and index):
            eye, center = self.eye0, self.center0
            proj = perspective(self.fovy, 1.0, eye)
        else:
            off = self.eye0 - self.pivot
            r = float(torch.linalg.norm(off))
            az = math.atan2(float(off[0]), float(off[2])) + self.orbit * index
            el = math.asin(min(max(float(off[1]) / max(r, 1e-9), -1.0), 1.0))
            el = min(max(el, -1.55), 1.55)
            center = self.pivot
            eye = center + r * torch.tensor(
                [math.cos(el) * math.sin(az), math.sin(el),
                 math.cos(el) * math.cos(az)], dtype=torch.float64,
                device=center.device)
            proj = perspective(60.0, self.aspect, eye)
        return eye, look_at(eye, center), proj


def primary_rays(path: CameraPath, index: int, frame_word: int, height: int,
                 width: int, num):
    """(origins, directions), each (height, width, 3), of frame `index`
    in the precision `num` (precision.Precision)."""
    eye, view, proj = path.matrices(index)
    dev = eye.device
    state = rng.seed_pixels(height, width, frame_word, dev)
    state, jx = rng.rand(state)
    state, jy = rng.rand(state)
    ys = torch.arange(height, dtype=torch.float64, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float64, device=dev)[None, :]
    px, py = num(xs + jx), num(ys + jy)
    one = torch.ones_like(px)
    clip = torch.stack([num(px / width * 2.0 - 1.0),
                        num(1.0 - py / height * 2.0), one, one], dim=-1)
    cam = num.mm(clip, torch.linalg.inv(proj).T)
    w = cam[..., 3:4]
    cam = cam[..., :3] / torch.where(w.abs() > 1e-20, w, torch.ones_like(w))
    world = num.mm(cam, torch.linalg.inv(view)[:3, :3].T)
    d = num(world / torch.linalg.norm(world, dim=-1, keepdim=True))
    return num(eye).expand_as(d), d
