"""Compressed screen-space G-buffer (port of eidola_tpu/render/gbuffer.py;
ref shaders/direct_stage.comp:37-45).  Words are uint32 values held in
int64 planes, bit-exact with the JAX packing."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import octahedral as octa
from ..ops.math import hash8bit, normalize
from ..scene.camera import Camera
from .shade_state import State

MISS_DEPTH = 1e30
MAX_IOR_MINUS_ONE = 3.0


class GBuffer(NamedTuple):
    depth: torch.Tensor    # (H, W) f32
    nrm: torch.Tensor      # (H, W) uint32-in-int64
    mat: torch.Tensor
    albedo: torch.Tensor
    tri: torch.Tensor      # (H, W) int64 primary hit triangle (-1 miss)


def empty_gbuffer(h: int, w: int, *, device) -> GBuffer:
    z = lambda: torch.zeros((h, w), dtype=torch.int64, device=device)
    return GBuffer(
        depth=torch.full((h, w), MISS_DEPTH, dtype=torch.float32,
                         device=device),
        nrm=z(), mat=z(), albedo=z(),
        tri=torch.full((h, w), -1, dtype=torch.int64, device=device),
    )


def pack_gbuffer(state: State, t, tri=None) -> GBuffer:
    mat_hash = hash8bit(state.mat_id)
    mat_pack = octa.pack_unorm4x8(torch.stack(
        [state.metallic, state.roughness,
         (state.ior - 1.0) / MAX_IOR_MINUS_ONE, state.transmission], dim=-1))
    zero = torch.zeros((), dtype=torch.int64, device=t.device)
    return GBuffer(
        depth=torch.where(state.valid, t, MISS_DEPTH),
        nrm=torch.where(state.valid, octa.encode_unit_u32(state.nrm), zero),
        mat=torch.where(state.valid, mat_pack, zero),
        albedo=torch.where(state.valid,
                           octa.pack_albedo_hash(state.albedo, mat_hash), zero),
        tri=(torch.full(t.shape, -1, dtype=torch.int64, device=t.device)
             if tri is None else torch.where(state.valid, tri.long(), -1)),
    )


class GBufferView(NamedTuple):
    valid: torch.Tensor
    depth: torch.Tensor
    pos: torch.Tensor
    nrm: torch.Tensor
    albedo: torch.Tensor
    mat_hash: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor


def center_rays(cam: Camera, h: int, w: int, rows=None):
    """Unjittered pixel-center rays for position reconstruction, for every
    row of the h x w image or for the global rows `rows` (an int tensor)."""
    dev = cam.pos.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) if rows is None
          else rows.to(torch.float32))
    ys = (ys + 0.5)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    ndc_x = xs / w * 2.0 - 1.0
    ndc_y = 1.0 - ys / h * 2.0
    ones = torch.ones((ys.shape[0], w), dtype=torch.float32, device=dev)
    t4 = torch.stack([ndc_x * ones, ndc_y * ones, ones, ones], dim=-1)
    cam_dir = t4 @ cam.proj_inv.T
    cam_dir = cam_dir[..., :3] / torch.where(
        torch.abs(cam_dir[..., 3:4]) > 1e-20, cam_dir[..., 3:4], 1.0)
    return normalize(cam_dir @ cam.view_inv[:3, :3].T)


def decode_gbuffer(gbuf: GBuffer, cam_pos, ray_dirs) -> GBufferView:
    valid = gbuf.depth < MISS_DEPTH * 0.5
    pos = cam_pos + ray_dirs * gbuf.depth[..., None]
    nrm = octa.decode_unit_u32(gbuf.nrm)
    albedo, mat_hash = octa.unpack_albedo_hash(gbuf.albedo)
    mr = octa.unpack_unorm4x8(gbuf.mat)
    z3 = torch.zeros_like(pos)
    v3 = valid[..., None]
    return GBufferView(
        valid=valid,
        depth=torch.where(valid, gbuf.depth, MISS_DEPTH),
        pos=torch.where(v3, pos, z3),
        nrm=torch.where(v3, nrm, z3),
        albedo=torch.where(v3, albedo, z3),
        mat_hash=mat_hash,
        metallic=torch.where(valid, mr[..., 0], 0.0),
        roughness=torch.where(valid, mr[..., 1], 1.0),
        ior=torch.where(valid, mr[..., 2] * MAX_IOR_MINUS_ONE + 1.0, 1.5),
        transmission=torch.where(valid, mr[..., 3], 0.0),
    )
