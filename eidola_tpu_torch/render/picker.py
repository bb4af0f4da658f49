"""Pixel picking: cast one ray under a pixel and report what it hit (port
of eidola_tpu/render/picker.py; ref SampleExample::screenPicking,
sample_example.cpp:456-497, which logs the hit and re-centres the camera
on it: scene/camera.py CameraManipulator.recenter)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.packets import closest_hit
from ..scene.camera import Camera
from ..scene.data import SceneData, shade_row
from .tracer import _merge_closest


@dataclass
class PickResult:
    hit: bool
    tri_id: int = -1
    material_id: int = -1
    t: float = 0.0
    world_pos: tuple = (0.0, 0.0, 0.0)
    barycentrics: tuple = (0.0, 0.0)


def pick(scene: SceneData, cam: Camera, height: int, width: int,
         pixel_y: float, pixel_x: float) -> PickResult:
    """Trace the centre ray of (pixel_y, pixel_x) and decode the hit."""
    dev = cam.pos.device
    ndc_x = (pixel_x + 0.5) / width * 2.0 - 1.0
    ndc_y = 1.0 - (pixel_y + 0.5) / height * 2.0
    t4 = torch.tensor([ndc_x, ndc_y, 1.0, 1.0], dtype=torch.float32,
                      device=dev)
    cam_dir = cam.proj_inv @ t4
    cam_dir = cam_dir[:3] / torch.where(torch.abs(cam_dir[3]) > 1e-20,
                                        cam_dir[3], 1.0)
    world_dir = cam.view_inv[:3, :3] @ cam_dir
    d = world_dir / torch.linalg.norm(world_dir)

    o1, d1 = cam.pos[None], d[None]
    tn = torch.full((1,), 1e-4, device=dev)
    tx = torch.full((1,), 1e8, device=dev)
    rec = closest_hit(scene.bvh, o1, d1, tn, tx)
    if scene.bvh_alpha is not None:
        # split scenes keep alpha-tested geometry (foliage) in a second
        # BVH: without it a pick on foliage reports a miss or the surface
        # behind it
        rec = _merge_closest(rec, closest_hit(scene.bvh_alpha, o1, d1, tn,
                                              tx))
    tri = int(rec.tri[0])
    if tri < 0:
        return PickResult(hit=False)
    t = float(rec.t[0])
    pos = cam.pos.cpu().numpy() + d.cpu().numpy() * t
    # instanced scenes report virtual global triangle ids; tri_mat is
    # indexed by the shared pool row
    pool_row, _ = shade_row(scene, rec.tri[:1])
    return PickResult(
        hit=True, tri_id=tri,
        material_id=int(scene.tri_mat[pool_row][0]), t=t,
        world_pos=tuple(float(x) for x in np.asarray(pos)),
        barycentrics=(float(rec.u[0]), float(rec.v[0])))
