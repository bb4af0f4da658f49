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


def spawn_rays(cam: Camera, height: int, width: int, seed_state):
    """Jittered pinhole rays for every pixel.  seed_state: (H, W) RNG state;
    returns (state, origins (H,W,3), dirs (H,W,3))."""
    dev = seed_state.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
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
