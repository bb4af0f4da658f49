"""Shared path-tracing library: environment radiance, alias-table light
sampling, NEE and emitter-hit pdfs (port of
eidola_tpu/render/pathtrace.py; ref shaders/pathtrace.glsl:40-232,
env_sampling.glsl, punctual.glsl).  `cfg` only selects static structure
(env mode), never per-lane branches."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import rng as erng
from ..ops.alias_table import sample_alias
from ..ops.math import cross, dot3, length, normalize
from ..scene import hdr as ehdr
from ..scene import sunsky as esky
from ..scene.data import LIGHT_DIRECTIONAL, LIGHT_SPOT, SceneData, shade_row
from .config import RenderConfig, RenderParams

_FAR = 1e7


class LightSample(NamedTuple):
    li: torch.Tensor
    wi: torch.Tensor
    dist: torch.Tensor
    pdf: torch.Tensor
    delta: torch.Tensor


def _hdr(cfg: RenderConfig, scene: SceneData) -> bool:
    return cfg.env_mode == "hdr" and scene.env is not None


def env_enabled(cfg: RenderConfig, scene: SceneData):
    """Dynamic 0/1: is there an environment light at all?"""
    if _hdr(cfg, scene):
        return torch.ones((), dtype=torch.float32,
                          device=scene.sunsky.enabled.device)
    return scene.sunsky.enabled.to(torch.float32)


def env_selection_prob(cfg: RenderConfig, scene: SceneData,
                       params: RenderParams):
    has_any_light = (scene.lights.num_trig + scene.lights.num_punc) > 0
    env_p = torch.where(has_any_light, params.environment_prob, 1.0)
    return env_p * env_enabled(cfg, scene)


def env_radiance(cfg: RenderConfig, scene: SceneData, params: RenderParams, d):
    """Radiance from the environment along miss direction d."""
    if _hdr(cfg, scene):
        return ehdr.env_eval(scene.env, d, params.hdr_multiplier)
    return esky.sky_radiance(scene.sunsky, d) * env_enabled(cfg, scene)


def env_pdf_dir(cfg: RenderConfig, scene: SceneData, d):
    """Solid-angle pdf of the env light sampler for direction d (MIS of an
    escaped BSDF ray; ref pathtrace.glsl:49-72)."""
    if _hdr(cfg, scene):
        return ehdr.env_pdf(scene.env, d)
    return esky.sun_pdf(scene.sunsky, d)


def sample_env(cfg: RenderConfig, scene: SceneData, params: RenderParams,
               u1, u2, u3, u4):
    """Draw an env direction.  Returns (wi, pdf, li)."""
    if _hdr(cfg, scene):
        return ehdr.env_sample(scene.env, u1, u2, u3, u4,
                               params.hdr_multiplier)
    wi, pdf, li = esky.sample_sun(scene.sunsky, u1, u2)
    return wi, pdf, li * env_enabled(cfg, scene)


def sample_triangle_light(scene: SceneData, pos, u1, u2, u3, u4):
    """Alias-table triangle-light sample.  Returns (wi, dist, pdf, li)."""
    lights = scene.lights
    idx, pmf = sample_alias(lights.trig_table, u1, u2)
    v0 = lights.trig_v0[idx]
    v1 = lights.trig_v1[idx]
    v2 = lights.trig_v2[idx]
    su = torch.sqrt(torch.clamp(u3, min=0.0))
    b1 = 1.0 - su
    b2 = u4 * su
    p = (v0 * (1.0 - b1 - b2)[..., None] + v1 * b1[..., None]
         + v2 * b2[..., None])
    n = cross(v1 - v0, v2 - v0)
    area2 = length(n)
    area = 0.5 * area2
    n = n / torch.clamp(area2, min=1e-20)[..., None]
    to_l = p - pos
    dist = torch.clamp(length(to_l), min=1e-6)
    wi = to_l / dist[..., None]
    cos_l = torch.abs(dot3(n, -wi))
    pdf = pmf * dist * dist / torch.clamp(area * cos_l, min=1e-9)
    li = lights.trig_emission[idx]
    ok = (cos_l > 1e-6) & (area > 1e-12) & (lights.num_trig > 0)
    return wi, dist, torch.where(ok, pdf, 0.0), torch.where(ok[..., None], li,
                                                            0.0)


def sample_punctual(scene: SceneData, pos, u1, u2):
    """Alias-table punctual light sample.  Returns (wi, dist, pmf, li)."""
    lights = scene.lights
    idx, pmf = sample_alias(lights.punc_table, u1, u2)
    lpos = lights.punc_pos[idx]
    lcol = lights.punc_color[idx]
    ltype = lights.punc_type[idx]
    ldir = normalize(lights.punc_dir[idx])
    lrange = lights.punc_range[idx]

    to_l = lpos - pos
    dist_p = torch.clamp(length(to_l), min=1e-6)
    wi_p = to_l / dist_p[..., None]
    directional = ltype == LIGHT_DIRECTIONAL
    wi = torch.where(directional[..., None], -ldir, wi_p)
    dist = torch.where(directional, _FAR, dist_p)

    atten = 1.0 / (dist_p * dist_p)
    rng_t = torch.where(lrange > 0.0, torch.clamp(
        dist_p / torch.clamp(lrange, min=1e-6), 0.0, 1.0), 0.0)
    atten = atten * torch.clamp(1.0 - rng_t ** 4, 0.0, 1.0)
    atten = torch.where(directional, 1.0, atten)

    cd = dot3(-wi, ldir)
    spot_t = torch.clamp(
        (cd - lights.punc_cos_outer[idx])
        / torch.clamp(lights.punc_cos_inner[idx] - lights.punc_cos_outer[idx],
                      min=1e-4), 0.0, 1.0)
    spot = spot_t * spot_t * (3.0 - 2.0 * spot_t)
    atten = torch.where(ltype == LIGHT_SPOT, atten * spot, atten)

    li = lcol * atten[..., None]
    ok = lights.num_punc > 0
    return wi, dist, torch.where(ok, pmf, 0.0), torch.where(
        ok, li, torch.zeros_like(li))


def sample_direct_light(cfg: RenderConfig, scene: SceneData,
                        params: RenderParams, pos, rng_state):
    """Three-way env / triangle / punctual selection (ref
    pathtrace.glsl:161-183).  Returns (rng_state, LightSample)."""
    rng_state, r_sel = erng.rand(rng_state)
    rng_state, u1 = erng.rand(rng_state)
    rng_state, u2 = erng.rand(rng_state)
    rng_state, u3 = erng.rand(rng_state)
    rng_state, u4 = erng.rand(rng_state)

    env_p = env_selection_prob(cfg, scene, params)
    trig_p = scene.lights.trig_samp_prob
    pick_env = r_sel < env_p
    r2 = torch.clamp((r_sel - env_p) / torch.clamp(1.0 - env_p, min=1e-6),
                     0.0, 1.0)
    pick_trig = (~pick_env) & (r2 < trig_p)
    pick_punc = (~pick_env) & (~pick_trig)

    e_wi, e_pdf, e_li = sample_env(cfg, scene, params, u1, u2, u3, u4)
    t_wi, t_dist, t_pdf, t_li = sample_triangle_light(scene, pos, u1, u2,
                                                      u3, u4)
    p_wi, p_dist, p_pmf, p_li = sample_punctual(scene, pos, u1, u2)

    pe, pt = pick_env[..., None], pick_trig[..., None]
    wi = torch.where(pe, e_wi, torch.where(pt, t_wi, p_wi))
    dist = torch.where(pick_env, _FAR, torch.where(pick_trig, t_dist, p_dist))
    li = torch.where(pe, e_li, torch.where(pt, t_li, p_li))
    pdf = torch.where(
        pick_env, e_pdf * env_p,
        torch.where(pick_trig, t_pdf * (1.0 - env_p) * trig_p,
                    p_pmf * (1.0 - env_p)
                    * torch.clamp(1.0 - trig_p, min=1e-6)))
    return rng_state, LightSample(li=li, wi=wi, dist=dist, pdf=pdf,
                                  delta=pick_punc)


def light_pdf_for_bsdf_dir(cfg: RenderConfig, scene: SceneData,
                           params: RenderParams, d, hit_tri, hit_dist,
                           hit_cos):
    """pdf of sample_direct_light producing direction d: the light half of
    the MIS weight of a BSDF-sampled ray (ref indirect_stage.comp:143-216).
    hit_tri < 0 means the ray escaped to the environment; hit_dist and
    hit_cos describe the emitter hit otherwise."""
    env_p = env_selection_prob(cfg, scene, params)
    trig_p = scene.lights.trig_samp_prob
    escaped = hit_tri < 0
    pdf_env = env_pdf_dir(cfg, scene, d) * env_p
    tid, inst_id = shade_row(scene, torch.clamp(hit_tri, min=0))
    pmf = scene.tri_light_pmf[tid]
    area = scene.tri_light_area[tid]
    if inst_id is not None:
        # instanced pools hold the unnormalized mesh weight and object area
        pmf = pmf * scene.inst.pmf_scale[inst_id]
        area = area * scene.inst.area_scale[inst_id]
    pdf_trig = (pmf * hit_dist * hit_dist
                / torch.clamp(area * torch.abs(hit_cos), min=1e-9)
                * (1.0 - env_p) * trig_p)
    pdf_trig = torch.where((pmf > 0) & ~escaped, pdf_trig, 0.0)
    return torch.where(escaped, pdf_env, pdf_trig)
