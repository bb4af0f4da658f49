"""Camera state + jittered pinhole ray generation (port of
eidola_tpu/scene/camera.py; ref src/scene.cpp:777-826,
shaders/pathtrace.glsl:260-270)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import rng as erng
from ..ops.math import normalize


class Camera(NamedTuple):
    view: torch.Tensor        # (4,4) f32 world -> camera
    proj: torch.Tensor        # (4,4) f32 camera -> clip
    view_inv: torch.Tensor
    proj_inv: torch.Tensor
    pos: torch.Tensor         # (3,) eye
    last_view: torch.Tensor
    last_proj_view: torch.Tensor
    last_pos: torch.Tensor


def look_at(eye, center, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m.astype(np.float32)


def perspective(fovy_deg: float, aspect: float, znear: float = 0.01,
                zfar: float = 1000.0) -> np.ndarray:
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def make_camera(eye, center, up=(0.0, 1.0, 0.0), fovy_deg: float = 60.0,
                aspect: float = 1.0, last: "Camera | None" = None, *,
                device) -> Camera:
    view = look_at(eye, center, up)
    proj = perspective(fovy_deg, aspect)
    view_inv = np.linalg.inv(view.astype(np.float64)).astype(np.float32)
    proj_inv = np.linalg.inv(proj.astype(np.float64)).astype(np.float32)
    pos = np.asarray(eye, np.float32)
    if last is None:
        last_view, last_pv, last_pos = view, proj @ view, pos
    else:
        last_view = last.view.cpu().numpy()
        last_pv = last.proj.cpu().numpy() @ last.view.cpu().numpy()
        last_pos = last.pos.cpu().numpy()
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return Camera(view=t(view), proj=t(proj), view_inv=t(view_inv),
                  proj_inv=t(proj_inv), pos=t(pos), last_view=t(last_view),
                  last_proj_view=t(last_pv), last_pos=t(last_pos))


def advance(cam: Camera) -> Camera:
    """Roll this frame's matrices into the last-frame slots."""
    return cam._replace(last_view=cam.view,
                        last_proj_view=cam.proj @ cam.view,
                        last_pos=cam.pos)


def spawn_rays(cam: Camera, height: int, width: int, seed_state,
               row0: int = 0):
    """Jittered pinhole rays for every pixel of a height x width image.
    seed_state: (h, W) RNG state of the h rows from global row `row0` (the
    whole image by default); returns (state, origins (h,W,3), dirs
    (h,W,3))."""
    dev = seed_state.device
    ys = torch.arange(row0, row0 + seed_state.shape[0], dtype=torch.float32,
                      device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    seed_state, jx = erng.rand(seed_state)
    seed_state, jy = erng.rand(seed_state)
    px = xs + jx
    py = ys + jy
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = 1.0 - py / height * 2.0
    target = torch.stack(
        [ndc_x * torch.ones_like(py), ndc_y * torch.ones_like(px),
         torch.ones_like(px * py)], dim=-1)
    t4 = torch.cat([target, torch.ones_like(target[..., :1])], dim=-1)
    cam_dir = t4 @ cam.proj_inv.T
    cam_dir = cam_dir[..., :3] / torch.where(
        torch.abs(cam_dir[..., 3:4]) > 1e-20, cam_dir[..., 3:4], 1.0)
    world_dir = cam_dir @ cam.view_inv[:3, :3].T
    d = normalize(world_dir)
    o = torch.broadcast_to(cam.pos, d.shape)
    return seed_state, o, d


def project_to_pixel(proj_view, p, height: int, width: int):
    """World position -> (pixel_y, pixel_x, valid) under proj*view."""
    p4 = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    clip = p4 @ proj_view.T
    w = clip[..., 3]
    valid = w > 1e-6
    inv_w = torch.where(valid, 1.0 / torch.clamp(w, min=1e-6), 0.0)
    ndc_x = clip[..., 0] * inv_w
    ndc_y = clip[..., 1] * inv_w
    px = (ndc_x * 0.5 + 0.5) * width
    py = (0.5 - ndc_y * 0.5) * height
    inside = valid & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    return py, px, inside


class CameraManipulator:
    """Orbit/dolly/pan camera controller (port of the JAX package's; ref
    main.cpp:66-68 setLookat, the GUI's orbit interaction).  Eye, pivot
    and up stay float64 numpy; each change builds a new Camera on
    `device` with the previous matrices in its last* slots, so motion
    vectors stay correct."""

    def __init__(self, eye, center, up=(0.0, 1.0, 0.0), fovy_deg=60.0,
                 aspect=1.0, *, device):
        self.eye = np.asarray(eye, np.float64)
        self.center = np.asarray(center, np.float64)
        self.up = np.asarray(up, np.float64)
        self.fovy_deg = float(fovy_deg)
        self.aspect = float(aspect)
        self.device = torch.device(device)
        self._cam = make_camera(self.eye, self.center, self.up,
                                self.fovy_deg, self.aspect,
                                device=self.device)

    @property
    def camera(self) -> Camera:
        return self._cam

    def _refresh(self) -> Camera:
        self._cam = make_camera(self.eye, self.center, self.up,
                                self.fovy_deg, self.aspect, last=self._cam,
                                device=self.device)
        return self._cam

    def orbit(self, d_azimuth_rad: float, d_elevation_rad: float) -> Camera:
        """Rotate the eye around the pivot (center)."""
        off = self.eye - self.center
        r = np.linalg.norm(off)
        az = np.arctan2(off[0], off[2]) + d_azimuth_rad
        el = np.arcsin(np.clip(off[1] / max(r, 1e-9), -1, 1)) + d_elevation_rad
        el = np.clip(el, -1.55, 1.55)
        self.eye = self.center + r * np.asarray(
            [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
        return self._refresh()

    def dolly(self, factor: float) -> Camera:
        """Move the eye toward (factor < 1) or away from the pivot."""
        self.eye = self.center + (self.eye - self.center) * factor
        return self._refresh()

    def pan(self, dx: float, dy: float) -> Camera:
        """Translate eye and pivot in the view plane."""
        f = self.center - self.eye
        f /= np.linalg.norm(f)
        s = np.cross(f, self.up)
        s /= np.linalg.norm(s)
        u = np.cross(s, f)
        delta = s * dx + u * dy
        self.eye = self.eye + delta
        self.center = self.center + delta
        return self._refresh()

    def recenter(self, center) -> Camera:
        """Move the orbit pivot to a picked world position, keeping the eye
        (ref sample_example.cpp:456-497 screen picking)."""
        self.center = np.asarray(center, np.float64)
        return self._refresh()

    def hold(self) -> Camera:
        """No movement this frame: roll the matrices forward."""
        self._cam = advance(self._cam)
        return self._cam
