"""Hit record -> shading state (port of eidola_tpu/render/shade_state.py,
flattened scenes; ref shaders/shade_state.glsl:63-221)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import octahedral as octa
from ..ops.math import cross, dot3, normalize
from ..scene.data import SceneData
from ..scene.textures import sample_bilinear
from .bsdf import BsdfParams


class State(NamedTuple):
    pos: torch.Tensor
    nrm: torch.Tensor
    geo_nrm: torch.Tensor
    uv: torch.Tensor
    albedo: torch.Tensor
    opacity: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    emission: torch.Tensor
    mat_id: torch.Tensor
    valid: torch.Tensor

    def bsdf(self) -> BsdfParams:
        return BsdfParams(albedo=self.albedo, metallic=self.metallic,
                          roughness=self.roughness)


def _bary_mix(attr3, u, v):
    w = (1.0 - u - v)[..., None]
    return (attr3[..., 0, :] * w + attr3[..., 1, :] * u[..., None]
            + attr3[..., 2, :] * v[..., None])


def get_state(scene: SceneData, o, d, tri, t, u, v, cone_angle=None) -> State:
    """Shading state per lane from a closest-hit record; lanes with
    tri < 0 get a zeroed state with valid=False."""
    if scene.inst is not None:
        raise NotImplementedError("instanced scenes come with ROADMAP A10")
    valid = tri >= 0
    tid = torch.clamp(tri, min=0)
    fp = None
    if cone_angle is not None:
        fp = t * cone_angle * scene.tri_uv_density[tid]

    pos = o + d * t[..., None]
    nrm = _bary_mix(octa.decode_unit_u32(scene.tri_nrm[tid]), u, v)
    uv_interp = _bary_mix(scene.tri_uv[tid], u, v)
    geo = octa.decode_unit_u32(scene.tri_gn[tid])
    nrm = normalize(nrm)
    flip = dot3(geo, d) > 0.0
    geo_n = torch.where(flip[..., None], -geo, geo)
    shade_n = torch.where(flip[..., None], -nrm, nrm)
    shade_n = torch.where(dot3(shade_n, geo_n)[..., None] < 0.0, geo_n,
                          shade_n)

    mat_id = scene.tri_mat[tid]
    m = scene.materials
    base = m.base_color[mat_id]
    base_tex = sample_bilinear(scene.textures, m.base_tex[mat_id], uv_interp,
                               footprint=fp)
    vcol = _bary_mix(octa.unpack_unorm4x8(scene.tri_color[tid]), u, v)
    albedo = base[..., :3] * base_tex[..., :3] * vcol[..., :3]
    opacity = base[..., 3] * base_tex[..., 3] * vcol[..., 3]

    mr_tex = sample_bilinear(scene.textures, m.mr_tex[mat_id], uv_interp,
                             footprint=fp)
    metallic = torch.clamp(m.metallic[mat_id] * mr_tex[..., 2], 0.0, 1.0)
    roughness = torch.clamp(m.roughness[mat_id] * mr_tex[..., 1], 0.02, 1.0)
    em_tex = sample_bilinear(scene.textures, m.emissive_tex[mat_id],
                             uv_interp, footprint=fp)
    emission = m.emissive[mat_id] * em_tex[..., :3]

    has_nm = m.normal_tex[mat_id] >= 0
    tangent = normalize(_bary_mix(
        octa.decode_unit_u32(scene.tri_tangent[tid]), u, v))
    hand = _bary_mix(scene.tri_hand[tid][..., None], u, v)[..., 0]
    tangent = normalize(tangent - shade_n * dot3(tangent, shade_n)[..., None])
    bitan = cross(shade_n, tangent) * torch.sign(hand)[..., None]
    nm = sample_bilinear(scene.textures, m.normal_tex[mat_id], uv_interp,
                         footprint=fp)
    nm_vec = nm[..., :3] * 2.0 - 1.0
    mapped = normalize(tangent * nm_vec[..., 0:1] + bitan * nm_vec[..., 1:2]
                       + shade_n * nm_vec[..., 2:3])
    shade_n = torch.where(has_nm[..., None], mapped, shade_n)

    def z(x):
        return torch.where(
            valid.reshape(tuple(valid.shape) + (1,) * (x.dim() - valid.dim())),
            x, 0.0)

    return State(
        pos=z(pos),
        nrm=z(shade_n),
        geo_nrm=z(geo_n),
        uv=z(uv_interp),
        albedo=z(albedo),
        opacity=torch.where(valid, opacity, 0.0),
        metallic=torch.where(valid, metallic, 0.0),
        roughness=torch.where(valid, roughness, 1.0),
        ior=torch.where(valid, m.ior[mat_id], 1.5),
        transmission=torch.where(valid, m.transmission[mat_id], 0.0),
        emission=z(emission),
        mat_id=torch.where(valid, mat_id, -1),
        valid=valid,
    )
