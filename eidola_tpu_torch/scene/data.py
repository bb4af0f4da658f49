"""Device-side scene representation + host->device upload (port of
eidola_tpu/scene/data.py:upload_scene, opaque non-instanced soups).

Everything is built on the host in numpy, exactly as the JAX package
builds it, then moved to the device once.  Integer arrays become int64
tensors (uint32 words keep their value), float arrays f32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import octahedral as octa
from ..ops.alias_table import AliasTable, make_alias_table
from ..ops.bvh import BVH, build_bvh_np, bvh_to_device, leaf_size_for
from ..utils.transfer import to_device

ALPHA_OPAQUE = 0

LIGHT_DIRECTIONAL = 1
LIGHT_SPOT = 2

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2


class Materials(NamedTuple):
    base_color: torch.Tensor      # (M, 4) f32
    emissive: torch.Tensor        # (M, 3) f32
    metallic: torch.Tensor        # (M,) f32
    roughness: torch.Tensor       # (M,) f32
    ior: torch.Tensor             # (M,) f32
    transmission: torch.Tensor    # (M,) f32
    base_tex: torch.Tensor        # (M,) int texture id or -1
    mr_tex: torch.Tensor
    normal_tex: torch.Tensor
    emissive_tex: torch.Tensor
    alpha_mode: torch.Tensor
    alpha_cutoff: torch.Tensor    # (M,) f32
    double_sided: torch.Tensor


class TexStack(NamedTuple):
    data: torch.Tensor   # (NT, TH, 2*TW, 4) f32 linear RGBA + mip atlas
    size: torch.Tensor   # (NT, 2) int (h, w) level-0 extent
    wrap: torch.Tensor   # (NT, 2) int WRAP_*


class Lights(NamedTuple):
    punc_pos: torch.Tensor
    punc_color: torch.Tensor
    punc_dir: torch.Tensor
    punc_type: torch.Tensor
    punc_range: torch.Tensor
    punc_cos_inner: torch.Tensor
    punc_cos_outer: torch.Tensor
    punc_table: AliasTable
    num_punc: torch.Tensor
    trig_v0: torch.Tensor
    trig_v1: torch.Tensor
    trig_v2: torch.Tensor
    trig_emission: torch.Tensor
    trig_table: AliasTable
    num_trig: torch.Tensor
    trig_samp_prob: torch.Tensor


class EnvMap(NamedTuple):
    """HDR environment + solid-angle-weighted alias map
    (ref src/hdr_sampling.cpp:107-242)."""
    image: torch.Tensor     # (He, We, 3) f32 linear radiance
    table: AliasTable       # over He*We texels
    integral: torch.Tensor  # () f32 luminance integral over the sphere
    average: torch.Tensor   # () f32 average luminance


class SunSkyParams(NamedTuple):
    sun_direction: torch.Tensor
    sun_intensity: torch.Tensor
    sun_angular_radius: torch.Tensor
    turbidity: torch.Tensor
    ground_color: torch.Tensor
    sky_tint: torch.Tensor
    enabled: torch.Tensor
    saturation: torch.Tensor
    redblueshift: torch.Tensor
    night_color: torch.Tensor
    sun_glow_intensity: torch.Tensor
    ground_irradiance: torch.Tensor


class SceneData(NamedTuple):
    """Everything a frame needs (field-for-field the JAX SceneData)."""
    bvh: BVH
    tri_gn: torch.Tensor
    tri_nrm: torch.Tensor
    tri_uv: torch.Tensor
    tri_tangent: torch.Tensor
    tri_hand: torch.Tensor
    tri_color: torch.Tensor
    tri_mat: torch.Tensor
    tri_light_pmf: torch.Tensor
    tri_light_area: torch.Tensor
    tri_uv_density: torch.Tensor
    materials: Materials
    textures: TexStack
    lights: Lights
    env: Optional[EnvMap]
    sunsky: SunSkyParams
    inst: Optional[object] = None
    bvh_alpha: Optional[BVH] = None


def default_sunsky() -> SunSkyParams:
    """Host (numpy) defaults, as eidola_tpu/scene/data.py:default_sunsky."""
    d = np.asarray([0.45, 0.78, 0.45], np.float32)
    d = d / np.linalg.norm(d)
    return SunSkyParams(
        sun_direction=d,
        sun_intensity=np.float32(1.0),
        sun_angular_radius=np.float32(0.00465),
        turbidity=np.float32(3.0),
        ground_color=np.asarray([0.4, 0.35, 0.3], np.float32),
        sky_tint=np.asarray([1.0, 1.0, 1.0], np.float32),
        enabled=np.int32(1),
        saturation=np.float32(1.0),
        redblueshift=np.float32(0.0),
        night_color=np.asarray([0.0, 0.0, 0.01], np.float32),
        sun_glow_intensity=np.float32(1.0),
        ground_irradiance=np.zeros(3, np.float32),
    )


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def build_lights(punc, trig_v0, trig_v1, trig_v2, trig_emission) -> Lights:
    """Punctual + triangle light tables with alias sampling (host numpy)."""
    if punc is None:
        punc = {}
    ppos = np.asarray(punc.get("pos", np.zeros((0, 3))), np.float32)
    L = ppos.shape[0]
    pcol = np.asarray(punc.get("color", np.ones((L, 3))), np.float32)
    pdir = np.asarray(punc.get("dir", np.tile([0, -1, 0], (L, 1))), np.float32)
    ptype = np.asarray(punc.get("type", np.zeros(L)), np.int32)
    prange = np.asarray(punc.get("range", np.zeros(L)), np.float32)
    pci = np.asarray(punc.get("cos_inner", np.ones(L)), np.float32)
    pco = np.asarray(punc.get("cos_outer", np.full(L, 0.7)), np.float32)

    lum = np.array([0.2126, 0.7152, 0.0722])
    punc_w = (pcol * lum).sum(-1) if L else np.zeros(0)
    punc_table, punc_power = make_alias_table(punc_w if L else np.asarray([0.0]))

    TL = trig_v0.shape[0]
    if TL:
        e1 = trig_v1 - trig_v0
        e2 = trig_v2 - trig_v0
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        trig_w = (trig_emission * lum).sum(-1) * area
    else:
        trig_w = np.asarray([0.0])
    trig_table, trig_power = make_alias_table(trig_w)

    total = punc_power + trig_power
    trig_prob = trig_power / total if total > 0 else 0.0
    Lp, TLp = max(L, 1), max(TL, 1)
    return Lights(
        punc_pos=_pad_rows(ppos, Lp),
        punc_color=_pad_rows(pcol, Lp),
        punc_dir=_pad_rows(pdir, Lp),
        punc_type=_pad_rows(ptype, Lp),
        punc_range=_pad_rows(prange, Lp),
        punc_cos_inner=_pad_rows(pci, Lp),
        punc_cos_outer=_pad_rows(pco, Lp),
        punc_table=punc_table,
        num_punc=np.int32(L),
        trig_v0=_pad_rows(np.asarray(trig_v0, np.float32), TLp),
        trig_v1=_pad_rows(np.asarray(trig_v1, np.float32), TLp),
        trig_v2=_pad_rows(np.asarray(trig_v2, np.float32), TLp),
        trig_emission=_pad_rows(np.asarray(trig_emission, np.float32), TLp),
        trig_table=trig_table,
        num_trig=np.int32(TL),
        trig_samp_prob=np.float32(trig_prob),
    )


def make_materials(mats: list[dict]) -> Materials:
    """SoA material table from a list of dicts (glTF-shaped keys)."""
    M = max(len(mats), 1)

    def col(key, default, shape=()):
        out = np.zeros((M,) + shape, np.float32)
        for i in range(M):
            src = mats[i] if i < len(mats) else {}
            out[i] = np.asarray(src.get(key, default), np.float32)
        return out

    def icol(key, default):
        out = np.full(M, default, np.int32)
        for i in range(M):
            src = mats[i] if i < len(mats) else {}
            out[i] = int(src.get(key, default))
        return out

    return Materials(
        base_color=col("base_color", [1, 1, 1, 1], (4,)),
        emissive=col("emissive", [0, 0, 0], (3,)),
        metallic=col("metallic", 0.0),
        roughness=col("roughness", 0.5),
        ior=col("ior", 1.5),
        transmission=col("transmission", 0.0),
        base_tex=icol("base_tex", -1),
        mr_tex=icol("mr_tex", -1),
        normal_tex=icol("normal_tex", -1),
        emissive_tex=icol("emissive_tex", -1),
        alpha_mode=icol("alpha_mode", ALPHA_OPAQUE),
        alpha_cutoff=col("alpha_cutoff", 0.5),
        double_sided=icol("double_sided", 0),
    )


def _mip_down(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
        w += 1
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    out = img
    if h > 1:
        out = out.reshape(nh, 2, out.shape[1], 4).mean(axis=1)
    if w > 1:
        out = out.reshape(out.shape[0], nw, 2, 4).mean(axis=2)
    return out


def make_tex_stack(textures: list | None) -> TexStack:
    """Uniform (NT, TH, 2*TW, 4) stack with a box-filter mip atlas; an
    untextured scene gets the 1x1 white texel."""
    if not textures:
        return TexStack(data=np.ones((1, 1, 2, 4), np.float32),
                        size=np.ones((1, 2), np.int32),
                        wrap=np.zeros((1, 2), np.int32))
    entries = []
    for t in textures:
        if isinstance(t, dict):
            entries.append((np.asarray(t["image"], np.float32),
                            int(t.get("wrap_s", WRAP_REPEAT)),
                            int(t.get("wrap_t", WRAP_REPEAT))))
        else:
            entries.append((np.asarray(t, np.float32), WRAP_REPEAT,
                            WRAP_REPEAT))
    th = max(2, max(t[0].shape[0] for t in entries))
    tw = max(2, max(t[0].shape[1] for t in entries))
    nt = len(entries)
    data = np.zeros((nt, th, 2 * tw, 4), np.float32)
    size = np.zeros((nt, 2), np.int32)
    wrap = np.zeros((nt, 2), np.int32)
    for i, (t, ws, wt) in enumerate(entries):
        if t.ndim == 2:
            t = t[..., None].repeat(3, -1)
        if t.shape[-1] == 3:
            t = np.concatenate([t, np.ones(t.shape[:-1] + (1,), np.float32)],
                               -1)
        data[i, : t.shape[0], : t.shape[1]] = t
        size[i] = (t.shape[0], t.shape[1])
        wrap[i] = (ws, wt)
        level = t
        l = 1
        while (level.shape[0] > 1 or level.shape[1] > 1) and (
                tw >> (l - 1)) >= 1:
            level = _mip_down(level)
            xoff = 2 * tw - (tw >> (l - 1))
            data[i, : level.shape[0], xoff: xoff + level.shape[1]] = level
            l += 1
    return TexStack(data=data, size=size, wrap=wrap)


def _prep_attrs(v0, v1, v2, normals, uvs, tangents, colors, mat_ids):
    """Default + pack the per-triangle attribute arrays (host numpy)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]

    gn = np.cross(v1 - v0, v2 - v0)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    if normals is None:
        normals = np.repeat(gn[:, None, :], 3, axis=1)
    if uvs is None:
        uvs = np.zeros((T, 3, 2), np.float32)
    if tangents is None:
        n = normals[:, 0]
        a = np.where(np.abs(n[:, 0:1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
        t = np.cross(a, n)
        t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-20)
        tangents = np.concatenate(
            [np.repeat(t[:, None], 3, axis=1), np.ones((T, 3, 1), np.float32)],
            -1)
    if colors is None:
        colors = np.ones((T, 3, 4), np.float32)
    if mat_ids is None:
        mat_ids = np.zeros(T, np.int32)

    area = (0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
            ).astype(np.float32)
    uv_e1 = uvs[:, 1] - uvs[:, 0]
    uv_e2 = uvs[:, 2] - uvs[:, 0]
    uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1]
                           - uv_e1[:, 1] * uv_e2[:, 0])
    uvd = np.sqrt(uv_area / np.maximum(area, 1e-20)).astype(np.float32)
    return v0, v1, v2, {
        "gn": octa.encode_unit_u32_np(gn),
        "nrm": octa.encode_unit_u32_np(np.asarray(normals, np.float32)),
        "uv": np.asarray(uvs, np.float32),
        "tangent": octa.encode_unit_u32_np(
            np.asarray(tangents, np.float32)[..., :3]),
        "hand": np.asarray(tangents, np.float32)[..., 3],
        "color": octa.pack_unorm4x8_np(np.asarray(colors, np.float32)),
        "mat": np.asarray(mat_ids, np.int32),
        "area": area,
        "uvd": uvd,
    }


def upload_scene(v0, v1, v2, *, device, normals=None, uvs=None,
                 tangents=None, colors=None, mat_ids=None, materials=None,
                 textures=None, punctual=None, sunsky=None,
                 leaf_size: int | None = None) -> SceneData:
    """Flatten a world-space opaque triangle soup into SceneData + BVH on
    `device`.  Emissive triangles become the triangle-light set.
    Alpha-tested materials (the opaque/alpha split) come with a later
    slice; an HDR environment is attached with `attach_env`."""
    v0, v1, v2, prep = _prep_attrs(v0, v1, v2, normals, uvs, tangents,
                                   colors, mat_ids)
    mat_ids = prep["mat"]
    if materials is None:
        materials = [{}]
    mat_table = make_materials(materials)
    if (np.asarray(mat_table.alpha_mode)[mat_ids] != ALPHA_OPAQUE).any():
        raise NotImplementedError(
            "alpha-tested geometry (the opaque/alpha BVH split) is ported "
            "with the alpha HitTest item (ROADMAP A9)")

    em = np.zeros((len(materials), 3), np.float32)
    for i, m in enumerate(materials):
        em[i] = np.asarray(m.get("emissive", [0, 0, 0]), np.float32)
    lum = (em * [0.2126, 0.7152, 0.0722]).sum(-1)
    emissive_mask = lum[mat_ids] > 0.0
    lights = build_lights(punctual, v0[emissive_mask], v1[emissive_mask],
                          v2[emissive_mask], em[mat_ids][emissive_mask])
    tri_light_pmf = np.zeros(v0.shape[0], np.float32)
    if emissive_mask.any():
        tri_light_pmf[emissive_mask] = np.asarray(lights.trig_table.pdf)[
            : int(emissive_mask.sum())]

    from .sunsky import finalize_sunsky

    sunsky = finalize_sunsky(sunsky if sunsky is not None
                             else default_sunsky())
    if leaf_size is None:
        leaf_size = leaf_size_for(device)
    bvh = bvh_to_device(build_bvh_np(v0, v1, v2, leaf_size), device)
    host = SceneData(
        bvh=bvh,
        tri_gn=prep["gn"],
        tri_nrm=prep["nrm"],
        tri_uv=prep["uv"],
        tri_tangent=prep["tangent"],
        tri_hand=prep["hand"],
        tri_color=prep["color"],
        tri_mat=prep["mat"],
        tri_light_pmf=tri_light_pmf,
        tri_light_area=prep["area"],
        tri_uv_density=prep["uvd"],
        materials=mat_table,
        textures=make_tex_stack(textures),
        lights=lights,
        env=None,
        sunsky=sunsky,
    )
    return to_device(host, device)


def attach_env(scene: SceneData, env: EnvMap) -> SceneData:
    """Swap the HDR environment on a loaded scene (as the JAX package's
    attach_env; ref sample_example.cpp:97-106)."""
    return scene._replace(env=env)
