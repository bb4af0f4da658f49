"""Wavefront unidirectional path tracer: NEE + MIS power heuristic +
Russian roulette, and the alpha HitTest (port of
eidola_tpu/render/tracer.py; ref shaders/indirect_stage.comp:129-226,
traceray_rq.glsl:32-185).

`trace_closest` / `trace_occlusion` are the ray front doors: image-tile
packets for coherent (H, W, 3) raster fields, sorted wavefronts for
everything else.  Under `cfg.alpha_geometry` a hit on an alpha-tested
material (MASK below its cutoff, BLEND stochastically) is passed through
and the ray re-traced from just past it, up to `cfg.alpha_hops` times;
on a split scene (`scene.bvh_alpha`) the opaque bulk is traversed once
and the hops run in the alpha BVH only.  The hop loop runs on a
compacted queue of the rays that still need a test (`_alpha_march`, the
default on the card) or in lockstep over all rays (the default on the
CPU, as in the JAX package); on MASK materials both give the same hits.
A lap of the queue (`_march_lap`) is the kernels of ops/alpha_lap.py
around the sort and the walk on the card, their plain versions here
(`_lap_prep_ref`, `_lap_merge_ref`) on the CPU.
`trace_radiance` is the estimator core the GI stage drives from
G-buffer surfaces; its bounce loop is the JAX package's scanned body as
a Python loop.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..ops import alpha_lap
from ..ops import rng as erng
from ..ops.alpha_lap import AlphaTables, Band, Lap
from ..ops.bvh import HitRecord
from ..ops.halo import get_bands
from ..ops.math import (dot3, make_frame, offset_ray, power_heuristic,
                        to_local, to_world)
from ..ops.packets import (any_hit_img, any_hit_sorted, closest_hit_img,
                           closest_hit_sorted, make_ray_order, ray_sort_keys,
                           sort_order)
from ..scene.data import ALPHA_BLEND, ALPHA_MASK, SceneData, shade_row
from ..scene.textures import sample_bilinear
from ..utils import profiler
from .bsdf import eval_bsdf, pdf_bsdf, sample_bsdf
from .config import RenderConfig, RenderParams
from .pathtrace import (env_pdf_dir, env_radiance, env_selection_prob,
                        light_pdf_for_bsdf_dir, sample_direct_light)
from .shade_state import State, get_state

_TMIN = 1e-4
_TMAX = 1e8


def _surface_opacity(scene: SceneData, tri, u, v):
    """Opacity at a hit: base-colour alpha x base texture alpha (the part
    of GetMaterials the alpha test needs, ref traceray_rq.glsl:58-80)."""
    t, _ = shade_row(scene, torch.clamp(tri, min=0))
    uvs = scene.tri_uv[t]
    w0 = (1.0 - u - v)[..., None]
    uv = (uvs[..., 0, :] * w0 + uvs[..., 1, :] * u[..., None]
          + uvs[..., 2, :] * v[..., None])
    mat = scene.tri_mat[t]
    base_a = scene.materials.base_color[mat][..., 3]
    tex_a = sample_bilinear(scene.textures, scene.materials.base_tex[mat],
                            uv)[..., 3]
    return base_a * tex_a


def _alpha_passthrough(scene: SceneData, rec, rng_state):
    """Which hits the alpha test rejects (the ray continues past them):
    MASK -> opacity < cutoff; BLEND -> rand >= opacity (ref
    traceray_rq.glsl:87-101).  Consumes one rng draw per lane."""
    mat = scene.tri_mat[shade_row(scene, torch.clamp(rec.tri, min=0))[0]]
    am = scene.materials.alpha_mode[mat]
    opac = _surface_opacity(scene, rec.tri, rec.u, rec.v)
    rng_state, uu = erng.rand(rng_state)
    cutoff = scene.materials.alpha_cutoff[mat]
    passthrough = (rec.tri >= 0) & (((am == ALPHA_MASK) & (opac < cutoff))
                                    | ((am == ALPHA_BLEND) & (uu >= opac)))
    return rng_state, passthrough


def _merge_closest(a, b):
    """The nearer of two hit records (a miss has t = 1e30)."""
    take_b = (b.tri >= 0) & ((a.tri < 0) | (b.t < a.t))
    return type(a)(*[torch.where(take_b, y, x) for x, y in zip(a, b)])


def _march_caps(R: int, B: int = 1) -> list[int]:
    """Lap capacities of the queue march over one band of R rays when a
    band context splits the rays into B bands (tracer.py:138-187): about
    R/EIDOLA_MARCH_DIV rounded to packets, but at least 32768/B, then a
    quarter of that while the pending count falls, down to
    EIDOLA_MARCH_MIN/B (at least 2048)."""
    div = int(os.environ.get("EIDOLA_MARCH_DIV", "16"))
    frac = -(-R // div)
    caps = [int(min(R, max(32768 // B, -(-frac // 128) * 128)))]
    cmin = min(caps[0], max(2048, int(os.environ.get("EIDOLA_MARCH_MIN",
                                                     "8192")) // B))
    while caps[-1] > cmin and len(caps) < 3:
        caps.append(max(-(-(caps[-1] // 4) // 128) * 128, cmin))
    return caps


def _alpha_march(scene: SceneData, hop_bvh, o, d, a_tmax, rec0, rng_state,
                 budget: int, max_steps: int, occl: bool):
    """The HitTest hop loop on a compacted queue (tracer.py:95-257): each
    lap takes up to `cap` rays whose record is an untested alpha hit
    (`torch.nonzero`, in index order), runs the alpha test and the
    re-trace at that width, and scatters the results back (`_march_lap`).
    Per ray the same tests and re-traces as the lockstep loop; only the
    BLEND rng stream differs (one draw per queued test, not per lane per
    hop).  occl=True counts `budget` tests (a solid hit occludes);
    occl=False counts `budget` re-traces, whose last hit may stand
    untested.  Under a band context that splits the rays into whole
    packets the march runs band by band, each band with its own queue (the
    JAX package's vmap over bands): per ray the hops and the BLEND draws do
    not change.  Returns (rng_state, rec, occluded) shaped like rec0."""
    shape = tuple(rec0.t.shape)
    R = rec0.t.numel()
    dev = rec0.t.device
    tmax_f = torch.broadcast_to(torch.as_tensor(a_tmax, dtype=torch.float32,
                                                device=dev), shape
                                ).reshape(R).contiguous()
    o_f, d_f = o.reshape(R, 3).contiguous(), d.reshape(R, 3).contiguous()
    rec = [x.reshape(R).clone() for x in rec0]
    rng_f = rng_state.reshape(R).clone()
    B = get_bands()
    if not (B > 1 and R % B == 0 and (R // B) % 128 == 0):
        B = 1
    Rl = R // B
    occluded = torch.zeros(R, dtype=torch.bool, device=dev)
    for b in range(B):      # views: each band's march writes in place
        s = slice(b * Rl, (b + 1) * Rl)
        _march_band(scene, hop_bvh, o_f[s], d_f[s], tmax_f[s],
                    [x[s] for x in rec], rng_f[s], occluded[s], budget,
                    max_steps, occl, _march_caps(Rl, B))
    rec = type(rec0)(*[x.reshape(shape) for x in rec])
    return rng_f.reshape(shape), rec, occluded.reshape(shape)


def _pending_count(pending) -> int:
    with profiler.sync("march.count"):
        return int(pending.sum())


def _march_band(scene, hop_bvh, o_f, d_f, tmax_f, rec, rng_f, occluded,
                budget, max_steps, occl, caps):
    """The hop loop over one band of flat rays; updates rec (a list of
    flat planes), rng_f and occluded in place."""
    pending = rec[0] >= 0
    if not occl and budget <= 0:
        pending = torch.zeros_like(pending)
    band = Band(o_f, d_f, tmax_f, *rec, rng_f, pending, occluded,
                torch.where(pending, budget, 0))
    for k, cap in enumerate(caps):
        nxt = caps[k + 1] if k + 1 < len(caps) else 0
        while _pending_count(pending) > nxt:
            with profiler.sync("march.select"):
                sel = torch.nonzero(pending)[:cap, 0]
            _march_lap(scene, hop_bvh, sel, band, max_steps, occl)


def _alpha_tables(scene: SceneData) -> AlphaTables:
    """The scene arrays `alpha_lap.lap_prep`'s alpha test reads."""
    m, tex, inst = scene.materials, scene.textures, scene.inst
    return AlphaTables(
        scene.tri_mat, scene.tri_uv, m.base_color, m.base_tex, m.alpha_mode,
        m.alpha_cutoff, tex.data, tex.size, tex.wrap,
        *(() if inst is None else (inst.tri_base, inst.attr_base)))


def _march_lap(scene, hop_bvh, sel, band: Band, max_steps: int,
               occl: bool) -> None:
    """One lap over the queued band indices `sel`: the alpha test and the
    compaction (`_lap_prep`), the re-trace of the rays it passed through in
    the hop BVH (a sorted wavefront), the scatter back (`_lap_merge`)."""
    lap = _lap_prep(scene, hop_bvh, sel, band, occl)
    rec2 = closest_hit_sorted(hop_bvh, lap.o, lap.d, lap.tn, lap.tx,
                              max_steps=max_steps, order=sort_order(lap.keys))
    _lap_merge(sel, band, rec2, lap, occl)


def _lap_prep(scene, hop_bvh, sel, band: Band, occl: bool) -> Lap:
    """The kernel (ops/alpha_lap.py) on the card, the plain lap on the
    CPU; any other device raises."""
    if sel.device.type == "cpu":
        return _lap_prep_ref(scene, hop_bvh, sel, band, occl)
    return alpha_lap.lap_prep(sel, band, _alpha_tables(scene), hop_bvh.walk,
                              occl)


def _lap_merge(sel, band: Band, rec2, lap: Lap, occl: bool) -> None:
    if sel.device.type == "cpu":
        return _lap_merge_ref(sel, band, rec2, lap, occl)
    return alpha_lap.lap_merge(sel, band, rec2, lap, occl)


def _lap_prep_ref(scene, hop_bvh, sel, band: Band, occl: bool) -> Lap:
    """The plain version of `alpha_lap.lap_prep`: the alpha test of the
    queued records, each lane's budget and re-trace segment, the compact
    rays and their sort keys."""
    rec_sel = HitRecord(band.tri[sel], band.t[sel], band.u[sel],
                        band.v[sel])
    rng_new, pt = _alpha_passthrough(scene, rec_sel, band.rng[sel])
    b_sel = band.bleft[sel]
    if occl:
        b_sel = b_sel - 1                  # a test consumed
        occ_new = ~pt                      # a solid hit occludes
        go = pt & (b_sel > 0)
    else:
        occ_new = torch.zeros_like(pt)
        go = pt                            # pending => b_sel > 0
        b_sel = b_sel - go.long()          # a re-trace consumed
    tn = torch.where(go, rec_sel.t * (1.0 + 1e-4) + 1e-5, 1.0)
    tx = torch.where(go, band.tmax[sel], -1.0)
    o, d = band.o[sel], band.d[sel]
    return Lap(o, d, tn, tx, ray_sort_keys(hop_bvh, o, d, tx < tn), go,
               occ_new, b_sel, rng_new)


def _lap_merge_ref(sel, band: Band, rec2, lap: Lap, occl: bool) -> None:
    """The plain version of `alpha_lap.lap_merge` (no count)."""
    for x, b in zip(band[3:7], rec2):
        x[sel] = torch.where(lap.go, b, x[sel])
    band.rng[sel] = lap.rng
    band.pending[sel] = lap.go & (rec2.tri >= 0) & (occl | (lap.bleft > 0))
    band.occluded[sel] |= lap.occ
    band.bleft[sel] = lap.bleft


def _march_mode(device) -> str:
    """EIDOLA_ALPHA_MARCH: auto (queue on the card, lockstep on the CPU,
    as the JAX package picks by backend) | queue | lockstep."""
    mode = os.environ.get("EIDOLA_ALPHA_MARCH", "auto")
    if mode == "auto":
        return "queue" if torch.device(device).type != "cpu" else "lockstep"
    return mode


def trace_closest(cfg: RenderConfig, scene: SceneData, o, d, t_min, t_max,
                  rng_state, coherent: bool = False, order=None):
    """Closest hit with the HitTest alpha loop (ref traceray_rq.glsl
    ClosestHit): image tiles for coherent (H, W, 3) fields, else a sorted
    wavefront (`order` from make_ray_order skips the sort).  Returns
    (rng_state, HitRecord)."""
    def closest(bvh, tn, tx):
        if coherent and o.dim() == 3:
            return closest_hit_img(bvh, o, d, tn, tx,
                                   max_steps=cfg.traversal_max_steps)
        return closest_hit_sorted(bvh, o, d, tn, tx,
                                  max_steps=cfg.traversal_max_steps,
                                  order=order)

    rec = closest(scene.bvh, t_min, t_max)
    if not cfg.alpha_geometry:
        if scene.bvh_alpha is not None:
            # alpha geometry counts as opaque with the HitTest loop off
            rec = _merge_closest(rec, closest(scene.bvh_alpha, t_min, t_max))
        return rng_state, rec
    split = scene.bvh_alpha is not None
    hop_bvh = scene.bvh_alpha if split else scene.bvh
    if split:
        # the alpha closest hit, bounded by the opaque one
        a_tmax = torch.minimum(torch.broadcast_to(torch.as_tensor(
            t_max, dtype=torch.float32, device=rec.t.device), rec.t.shape),
            rec.t)
        rec_a = closest(hop_bvh, t_min, a_tmax)
    else:
        a_tmax = t_max
        rec_a = rec
    if _march_mode(o.device) == "queue":
        rng_state, rec_a, _ = _alpha_march(
            scene, hop_bvh, o, d, a_tmax, rec_a, rng_state,
            budget=cfg.alpha_hops, max_steps=cfg.traversal_max_steps,
            occl=False)
    else:
        for _ in range(cfg.alpha_hops):
            rng_state, passthrough = _alpha_passthrough(scene, rec_a,
                                                        rng_state)
            rec2 = closest_hit_sorted(
                hop_bvh, o, d,
                torch.where(passthrough, rec_a.t * (1.0 + 1e-4) + 1e-5,
                            t_min),
                torch.where(passthrough, a_tmax, -1.0),
                max_steps=cfg.traversal_max_steps, order=order)
            rec_a = type(rec_a)(*[torch.where(passthrough, b, a)
                                  for a, b in zip(rec_a, rec2)])
    if split:
        rec_a = _merge_closest(rec, rec_a)
    return rng_state, rec_a


def trace_occlusion(cfg: RenderConfig, scene: SceneData, o, d, t_min, t_max,
                    rng_state, order=None, coherent: bool = False):
    """Occlusion with the alpha test (ref traceray_rq.glsl:153-185
    AnyHit): alpha-rejected hits do not occlude and the ray marches past
    them.  A split scene pays one any-hit over the opaque bulk, then the
    march through the alpha BVH only.  Returns (rng_state, occluded)."""
    def anyhit(bvh, tx):
        if coherent and o.dim() == 3:
            return any_hit_img(bvh, o, d, t_min, tx,
                               max_steps=cfg.traversal_max_steps)
        return any_hit_sorted(bvh, o, d, t_min, tx,
                              max_steps=cfg.traversal_max_steps, order=order)

    if not cfg.alpha_geometry:
        occ = anyhit(scene.bvh, t_max)
        if scene.bvh_alpha is not None:
            occ = occ | anyhit(scene.bvh_alpha, t_max)
        return rng_state, occ
    f32 = dict(dtype=torch.float32, device=o.device)
    shape = tuple(t_max.shape) if torch.is_tensor(t_max) else \
        tuple(o.shape[:-1])
    if scene.bvh_alpha is not None:
        occluded = anyhit(scene.bvh, t_max)
        hop_bvh = scene.bvh_alpha
    else:
        occluded = torch.zeros(shape, dtype=torch.bool, device=o.device)
        hop_bvh = scene.bvh
    hops = cfg.alpha_hops + 1
    cur_tmin = torch.broadcast_to(torch.as_tensor(t_min, **f32), shape)
    cur_tmax = torch.where(occluded, -1.0, torch.broadcast_to(
        torch.as_tensor(t_max, **f32), shape))
    if _march_mode(o.device) == "queue":
        # one full-width closest hit (every unoccluded ray must consult
        # the alpha set), then the test/re-trace march on the queue
        rec0 = closest_hit_sorted(hop_bvh, o, d, cur_tmin, cur_tmax,
                                  max_steps=cfg.traversal_max_steps,
                                  order=order)
        rng_state, _, occ_a = _alpha_march(
            scene, hop_bvh, o, d, cur_tmax, rec0, rng_state, budget=hops,
            max_steps=cfg.traversal_max_steps, occl=True)
        return rng_state, occluded | occ_a
    for _ in range(hops):
        rec = closest_hit_sorted(hop_bvh, o, d, cur_tmin, cur_tmax,
                                 max_steps=cfg.traversal_max_steps,
                                 order=order)
        rng_state, passthrough = _alpha_passthrough(scene, rec, rng_state)
        occluded = occluded | ((rec.tri >= 0) & ~passthrough)
        cur_tmin = torch.where(passthrough, rec.t * (1.0 + 1e-4) + 1e-5,
                               cur_tmin)
        cur_tmax = torch.where(passthrough & ~occluded, cur_tmax, -1.0)
    return rng_state, occluded


class PathVertex(NamedTuple):
    """First-bounce record the ReSTIR GI stage needs (ref GISample
    host_device.h:260-284)."""
    xs: torch.Tensor     # (..., 3) first secondary hit position
    ns: torch.Tensor     # (..., 3) its normal
    valid: torch.Tensor  # (...,) bool


def _flip_to(geo_nrm, w):
    """The geometric normal on the side of direction w."""
    return torch.where(dot3(geo_nrm, w)[..., None] >= 0, geo_nrm, -geo_nrm)


def nee_contribution(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                     state: State, wo, rng_state, active=None,
                     want_order: bool = False):
    """One next-event-estimation sample at `state` with a shadow ray and
    MIS (ref pathtrace.glsl:185-220).  Returns (rng, contribution (..., 3))
    or, with want_order, also the wavefront order of the shadow rays,
    which the next bounce from the same surface reuses.  `active` masks
    lanes whose shadow rays need not be traced at all."""
    rng_state, ls = sample_direct_light(cfg, scene, params, state.pos,
                                        rng_state)
    t, b = make_frame(state.nrm)
    wo_l = to_local(t, b, state.nrm, wo)
    wi_l = to_local(t, b, state.nrm, ls.wi)
    f = eval_bsdf(state.bsdf(), wo_l, wi_l)
    cos_i = torch.clamp(wi_l[..., 2], min=0.0)

    contrib_ok = state.valid & (ls.pdf > 1e-12) & (cos_i > 0.0)
    if active is not None:
        contrib_ok = contrib_ok & active
    origin = offset_ray(state.pos, _flip_to(state.geo_nrm, ls.wi))
    # dead lanes get t_max < t_min so their packets retire in one step
    shadow_tmax = torch.where(contrib_ok, ls.dist * 0.999, -1.0)
    order = make_ray_order(scene.bvh, origin, ls.wi, dead=~contrib_ok)
    rng_state, occluded = trace_occlusion(
        cfg, scene, origin, ls.wi, torch.full_like(shadow_tmax, _TMIN),
        shadow_tmax, rng_state, order=order)

    if cfg.use_mis:
        bsdf_pdf_wi = pdf_bsdf(state.bsdf(), wo_l, wi_l)
        w = torch.where(ls.delta, 1.0, power_heuristic(ls.pdf, bsdf_pdf_wi))
    else:
        w = torch.ones_like(ls.pdf)
    contrib = ls.li * f * (cos_i * w / torch.clamp(ls.pdf, min=1e-12)
                           )[..., None]
    contrib = torch.where((contrib_ok & ~occluded)[..., None], contrib, 0.0)
    if want_order:
        return rng_state, contrib, order
    return rng_state, contrib


def trace_radiance(cfg: RenderConfig, scene: SceneData, params: RenderParams,
                   o, d, rng_state, num_bounces: int | None = None,
                   collect_first_vertex: bool = False,
                   start_state: State | None = None, start_wo=None,
                   nee_start_depth: int = 0,
                   snapshot_after_depth: int | None = None,
                   kill_after_snapshot=None):
    """Trace radiance along rays (o, d), flat or image-shaped.

    With `start_state` the path starts AT that surface (the GI stage's
    G-buffer reconstruction) and (o, d) are ignored; `start_wo` points
    back toward the camera.  With `snapshot_after_depth` = k, also return
    the radiance accumulated through segment k: what a separate
    num_bounces=k run with the same RNG prefix would give.

    Returns (rng_state, radiance, PathVertex|None[, radiance_snapshot])."""
    depth_total = num_bounces if num_bounces is not None else cfg.max_depth
    lanes = (start_state.valid.shape if start_state is not None
             else d.shape[:-1])
    dev = rng_state.device
    f32 = dict(dtype=torch.float32, device=dev)

    radiance = torch.zeros(lanes + (3,), **f32)
    throughput = torch.ones(lanes + (3,), **f32)
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    last_bsdf_pdf = torch.zeros(lanes, **f32)
    first_xs = torch.zeros(lanes + (3,), **f32)
    first_ns = torch.zeros(lanes + (3,), **f32)
    first_ok = torch.zeros(lanes, dtype=torch.bool, device=dev)

    def accumulate(depth_gt_nee: bool, radiance, throughput, alive,
                   last_bsdf_pdf, cur_d, state, wo, tri, rec_t):
        """Add the env/emitter contribution of the vertex just reached;
        `depth_gt_nee`: does NEE at earlier vertices already account for
        light found by this BSDF segment (-> MIS-weight or drop it)?"""
        escaped = alive & ~state.valid
        env = env_radiance(cfg, scene, params, cur_d)
        ones = torch.ones(lanes, **f32)
        if cfg.use_nee and cfg.use_mis:
            lp = env_pdf_dir(cfg, scene, cur_d) * env_selection_prob(
                cfg, scene, params)
            w_env = power_heuristic(last_bsdf_pdf, lp) if depth_gt_nee \
                else ones
        elif cfg.use_nee:
            w_env = ones * (0.0 if depth_gt_nee else 1.0)
        else:
            w_env = ones
        radiance = radiance + torch.where(
            escaped[..., None], throughput * env * w_env[..., None], 0.0)

        hit_em = alive & state.valid
        if cfg.use_nee and cfg.use_mis:
            cos_l = torch.abs(dot3(state.geo_nrm, wo))
            lp = light_pdf_for_bsdf_dir(cfg, scene, params, cur_d, tri, rec_t,
                                        cos_l)
            w_em = power_heuristic(last_bsdf_pdf, lp) if depth_gt_nee \
                else ones
        elif cfg.use_nee:
            # NEE-only: count emitter hits only for lights NEE can't find
            row, _ = shade_row(scene, torch.clamp(tri, min=0))
            not_nee_light = torch.where(scene.tri_light_pmf[row] > 0.0,
                                        0.0, 1.0)
            w_em = not_nee_light if depth_gt_nee else ones
        else:
            w_em = ones
        return radiance + torch.where(
            hit_em[..., None], throughput * state.emission * w_em[..., None],
            0.0)

    # ---- depth 0: coherent primaries, or the provided surface ----
    if start_state is not None:
        state, wo = start_state, start_wo
    else:
        rng_state, rec = trace_closest(
            cfg, scene, o, d, torch.full(lanes, _TMIN, **f32),
            torch.full(lanes, _TMAX, **f32), rng_state, coherent=True)
        state = get_state(scene, o, d, rec.tri, rec.t, rec.u, rec.v)
        wo = -d
        radiance = accumulate(0 > nee_start_depth, radiance, throughput,
                              alive, last_bsdf_pdf, d, state, wo, rec.tri,
                              rec.t)
        alive = alive & state.valid
    radiance_snap = radiance
    if snapshot_after_depth == 0 and kill_after_snapshot is not None:
        alive = alive & kill_after_snapshot

    # ---- bounces 1..depth_total (the JAX package's scanned body) ----
    for k in range(1, depth_total + 1):
        # NEE at the current vertex, depth k-1 (ref indirect_stage.comp:143)
        order = None
        if cfg.use_nee:
            nee_on = alive if nee_start_depth <= 0 else \
                alive & (k - 1 >= nee_start_depth)
            rng_state, contrib, order = nee_contribution(
                cfg, scene, params, state, wo, rng_state, active=nee_on,
                want_order=True)
            radiance = radiance + torch.where(nee_on[..., None],
                                              throughput * contrib, 0.0)

        # BSDF sample to continue
        rng_state, u1 = erng.rand(rng_state)
        rng_state, u2 = erng.rand(rng_state)
        rng_state, u3 = erng.rand(rng_state)
        t, b = make_frame(state.nrm)
        wo_l = to_local(t, b, state.nrm, wo)
        wi_l, pdf, f = sample_bsdf(state.bsdf(), wo_l, u1, u2, u3)
        wi = to_world(t, b, state.nrm, wi_l)
        cos_i = torch.clamp(wi_l[..., 2], min=0.0)
        ok = alive & (pdf > 1e-9) & (cos_i > 0.0)
        throughput = torch.where(
            ok[..., None],
            throughput * f * (cos_i / torch.clamp(pdf, min=1e-9))[..., None],
            throughput)
        alive = ok
        last_bsdf_pdf = pdf

        # Russian roulette from rr_depth (ref indirect_stage.comp:218-224)
        if cfg.russian_roulette:
            rng_state, u_rr = erng.rand(rng_state)
            if k - 1 >= cfg.rr_depth:
                p_cont = torch.clamp(torch.amax(throughput, dim=-1), 0.05,
                                     1.0)
            else:
                p_cont = torch.ones_like(u_rr)
            survive = u_rr < p_cont
            throughput = torch.where((alive & survive)[..., None],
                                     throughput / p_cont[..., None],
                                     throughput)
            alive = alive & survive

        # segment k: a sorted wavefront reusing the NEE shadow order (same
        # origins); terminated lanes are dead rays that retire at once
        cur_o = offset_ray(state.pos, _flip_to(state.geo_nrm, wi))
        cur_d = wi
        rng_state, rec = trace_closest(
            cfg, scene, cur_o, cur_d, torch.full(lanes, _TMIN, **f32),
            torch.where(alive, _TMAX, -1.0), rng_state, order=order)
        state = get_state(scene, cur_o, cur_d, rec.tri, rec.t, rec.u, rec.v)
        wo = -cur_d
        radiance = accumulate(
            k > nee_start_depth if nee_start_depth > 0 else True,
            radiance, throughput, alive, last_bsdf_pdf, cur_d, state, wo,
            rec.tri, rec.t)

        if collect_first_vertex and k == 1:
            first_ok = state.valid & alive
            first_xs = torch.where(first_ok[..., None], state.pos, 0.0)
            first_ns = torch.where(first_ok[..., None], state.nrm, 0.0)

        if snapshot_after_depth is not None and \
                k == snapshot_after_depth >= 1:
            radiance_snap = radiance
            if kill_after_snapshot is not None:
                # tiled multi-bounce: lanes whose deep contribution is
                # scaled to zero stop tracing here
                alive = alive & kill_after_snapshot

        alive = alive & state.valid

    vert = (PathVertex(xs=first_xs, ns=first_ns, valid=first_ok)
            if collect_first_vertex else None)
    if snapshot_after_depth is not None:
        return rng_state, radiance, vert, radiance_snap
    return rng_state, radiance, vert
