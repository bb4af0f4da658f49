"""The port's interactive frame against the JAX package's, at small sizes.

What the moving camera and the non-default RenderConfig options bring in:
`ops/intersect`, `CameraManipulator`, `reset_accumulation`, spatial ReSTIR
(`_spatial_gates`, `_spatial_reuse`), visibility reuse (the tile mask and
what it decides), `primary_seed`'s t_max on a flat BVH, `bilateral_denoise`,
`pick`, the headless flags with the JAX-matching bilinear upscale, and one
whole frame configuration with every option on, held against JAX
`render_frame` over three orbiting frames.

Tolerances:
- integer work bitwise: rng words, the tile mask, pick's triangle;
- f32 elementwise work within 1e-6 relative (intersection, camera
  matrices, t_max seeds) or 1e-5 (the bilateral filter, the upscale,
  pick's t and reservoir samples);
- spatial reuse: sin and cos of f32 may differ by an ulp between XLA
  and torch, which can move a rounded neighbour offset, so offsets,
  `num` and `weight` agree on >= 99.9% of pixels;
- the whole frame at tests/test_torch_frame.py's tolerances (the port's
  drains and the JAX CPU oracle's differ at exact MT edge verdicts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.ops.intersect as JX
import eidola_tpu.ops.rng as jrng
import eidola_tpu.render.direct as JD
from eidola_tpu.models.scenes import cornell_box
from eidola_tpu.ops.halo import halo_gather as j_halo_gather
from eidola_tpu.ops.packets import TILE_H, TILE_W
from eidola_tpu.render import config as jcfg
from eidola_tpu.render.denoise import bilateral_denoise as j_bilateral
from eidola_tpu.render.frame import init_frame_state as j_init
from eidola_tpu.render.frame import make_step as j_make_step
from eidola_tpu.render.frame import reset_accumulation as j_reset
from eidola_tpu.render.gbuffer import GBufferView as JView
from eidola_tpu.render.picker import pick as j_pick
from eidola_tpu.scene.camera import CameraManipulator as JManip
from eidola_tpu_torch import interop
from eidola_tpu_torch.app import headless
from eidola_tpu_torch.ops import intersect as TX
from eidola_tpu_torch.ops import rng as trng
from eidola_tpu_torch.render import direct as TD
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.render.config import (RESTIR_SPATIAL,
                                            RESTIR_SPATIOTEMPORAL,
                                            RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render.denoise import bilateral_denoise
from eidola_tpu_torch.render.frame import init_frame_state, make_step
from eidola_tpu_torch.render.frame import reset_accumulation
from eidola_tpu_torch.render.picker import pick
from eidola_tpu_torch.scene.camera import CameraManipulator
from test_torch_gi import _random_view

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _t(x):
    return interop.to_torch(x, CPU)


# ---- ops/intersect ------------------------------------------------------

N_ISECT = 4096


def _isect_case(seed=11):
    """4,096 rays against as many triangles, with the edges: rays
    parallel to their triangle (det 0), degenerate triangles, hits at
    t just above t_min and at t_max itself."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    n = N_ISECT
    v0, e1, e2 = f(n, 3), f(n, 3), f(n, 3)
    w = r.random((n, 2)).astype(np.float32) * 0.5
    tgt = v0 + e1 * w[:, :1] + e2 * w[:, 1:]
    o = tgt + 3 * f(n, 3)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    q = n // 8
    d[:q] = np.cross(e1[:q], e2[:q])              # parallel to the plane:
    d[:q] = np.cross(d[:q], e1[:q])               # in it, det = 0
    d[:q] /= np.linalg.norm(d[:q], axis=-1, keepdims=True)
    e2[q:2 * q] = 0.0                             # degenerate triangles
    t_true = np.linalg.norm(tgt - o, axis=-1)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e8, np.float32)
    t_min[2 * q:3 * q] = t_true[2 * q:3 * q] * 0.99999   # t just past t_min
    t_max[3 * q:4 * q] = t_true[3 * q:4 * q]             # t at t_max
    return o, d.astype(np.float32), v0, e1, e2, t_min, t_max


def test_ray_triangle_matches_jax():
    o, d, v0, e1, e2, tn, tx = _isect_case()
    j = [np.asarray(a) for a in JX.ray_triangle(o, d, v0, e1, e2, tn, tx)]
    t = [a.numpy() for a in TX.ray_triangle(*map(torch.from_numpy,
                                                  (o, d, v0, e1, e2, tn,
                                                   tx)))]
    np.testing.assert_array_equal(t[0], j[0])
    assert 0.2 < j[0].mean() < 0.8
    hit = j[0]
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-6, atol=1e-7)
    assert (t[1][~hit] == 1e30).all()


def test_ray_aabb_and_safe_inv_dir_match_jax():
    r = np.random.default_rng(12)
    n = N_ISECT
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    lo = r.uniform(-2, 1, (n, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 2, (n, 3)).astype(np.float32)
    d = ((lo + hi) / 2 + r.normal(0, 0.3, (n, 3)) - o).astype(np.float32)
    d[: n // 8, r.integers(0, 3)] = 0.0           # axis-parallel rays
    d[n // 8: n // 4, :2] = 0.0
    tn = np.full(n, 1e-4, np.float32)
    tx = r.uniform(2, 16, n).astype(np.float32)
    j_inv = np.array(JX.safe_inv_dir(d))
    t_inv = TX.safe_inv_dir(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(t_inv, j_inv, rtol=1e-6)
    jh, jt = JX.ray_aabb(o, j_inv, tn, tx, lo, hi)
    th, tt = TX.ray_aabb(*map(torch.from_numpy, (o, j_inv, tn, tx, lo, hi)))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 0.1 < np.asarray(jh).mean() < 0.9
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)


def test_brute_force_closest_matches_jax():
    r = np.random.default_rng(13)
    nt, nr = 64, N_ISECT
    c = r.uniform(-1, 1, (nt, 3)).astype(np.float32)
    v0 = c + r.normal(0, 0.3, (nt, 3)).astype(np.float32)
    e1 = r.normal(0, 0.4, (nt, 3)).astype(np.float32)
    e2 = r.normal(0, 0.4, (nt, 3)).astype(np.float32)
    o = r.uniform(-4, 4, (nr, 3)).astype(np.float32)
    d = (r.uniform(-1, 1, (nr, 3)) - o / 4).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(nr, 1e-4, np.float32)
    tx = np.full(nr, 1e8, np.float32)
    tx[::7] = 2.0                                 # bounded rays
    j = [np.asarray(a) for a in JX.brute_force_closest(o, d, v0, e1, e2, tn,
                                                        tx)]
    t = [a.numpy() for a in TX.brute_force_closest(
        *map(torch.from_numpy, (o, d, v0, e1, e2, tn, tx)))]
    np.testing.assert_array_equal(t[0], j[0])
    hit = j[0] >= 0
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6)
    for a, b in zip(t[2:], j[2:]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-6, atol=1e-6)


# ---- CameraManipulator --------------------------------------------------

CAM_FIELDS = ("view", "proj", "view_inv", "proj_inv", "pos", "last_view",
              "last_proj_view", "last_pos")


def test_camera_manipulator_matches_jax():
    """A seeded sequence of every move; every matrix of every camera."""
    r = np.random.default_rng(21)
    kw = dict(eye=[0.3, 1.2, 4.0], center=[0.0, 0.8, 0.0], fovy_deg=50.0,
              aspect=1.5)
    jm, tm = JManip(**kw), CameraManipulator(**kw, device=CPU)
    for step in range(12):
        move = ["orbit", "dolly", "pan", "recenter", "hold"][step % 5]
        a = r.uniform(-0.4, 0.4, 3)
        args = {"orbit": (a[0], a[1]), "dolly": (1.0 + a[2],),
                "pan": (a[0], a[1]), "recenter": (a.tolist(),),
                "hold": ()}[move]
        jc, tc = getattr(jm, move)(*args), getattr(tm, move)(*args)
        np.testing.assert_array_equal(tm.eye, jm.eye)
        np.testing.assert_array_equal(tm.center, jm.center)
        for k in CAM_FIELDS:
            np.testing.assert_allclose(getattr(tc, k).numpy(),
                                       np.asarray(getattr(jc, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert tm.camera is tc


def test_camera_manipulator_properties():
    """tests/test_aux.py's three: orbit keeps the distance and threads
    the last matrices, dolly and pan move as asked, hold rolls history."""
    m = CameraManipulator(eye=[0, 0, 5], center=[0, 0, 0], device=CPU)
    before = m.camera.view.numpy()
    cam = m.orbit(0.3, 0.1)
    assert np.linalg.norm(m.eye) == pytest.approx(5.0, rel=1e-5)
    np.testing.assert_allclose(cam.last_view.numpy(), before)
    m = CameraManipulator(eye=[0, 0, 4], center=[0, 0, 0], device=CPU)
    m.dolly(0.5)
    assert np.linalg.norm(m.eye - m.center) == pytest.approx(2.0)
    m.pan(1.0, 0.0)
    assert np.linalg.norm(m.center) > 0.5
    m = CameraManipulator(eye=[0, 1, 5], center=[0, 0, 0], device=CPU)
    cam0 = m.orbit(0.2, 0.0)
    cam1 = m.hold()
    np.testing.assert_allclose(cam1.last_view.numpy(), cam0.view.numpy())


# ---- reset_accumulation -------------------------------------------------

def test_reset_accumulation_matches_jax():
    _, cam = cornell_box()
    cfg = jcfg.RenderConfig(width=16, height=16)
    js = j_init(cfg, cam)._replace(
        accum=jnp.full((16, 16, 3), 0.5, jnp.float32),
        accum_count=jnp.asarray(7.0, jnp.float32),
        frame_idx=jnp.asarray(9, jnp.int32))
    ts = reset_accumulation(_t(js))
    jr = j_reset(js)
    np.testing.assert_array_equal(ts.accum.numpy(), np.asarray(jr.accum))
    assert float(ts.accum_count) == float(jr.accum_count) == 0.0
    assert int(ts.frame_idx) == int(jr.frame_idx) == 9     # the rest stays


# ---- spatial reuse ------------------------------------------------------

SP = 32


def _smooth_view(seed):
    """A G-buffer view whose neighbours often pass the spatial gates:
    normals near +z, depths within a few percent."""
    v = _random_view(SP, SP, seed)
    r = np.random.default_rng(seed + 1)
    nrm = np.array([0, 0, 1.0]) + 0.4 * r.normal(size=(SP, SP, 3))
    v["nrm"] = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
                ).astype(np.float32)
    v["depth"] = (2.0 + 0.15 * r.random((SP, SP))).astype(np.float32)
    return v


def _reservoir(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.random(s).astype(np.float32)
    return {"sample": {"li": 3 * f(SP, SP, 3), "wi": f(SP, SP, 3) - 0.5,
                       "dist": 1 + 5 * f(SP, SP)},
            "num": r.integers(0, 20, (SP, SP)).astype(np.float32),
            "weight": np.where(f(SP, SP) < 0.2, 0.0, 4 * f(SP, SP)
                               ).astype(np.float32)}


def _cfg_pair(**kw):
    return jcfg.RenderConfig(**kw), RenderConfig(**kw)


def test_disk_offsets_match_jax():
    """_spatial_reuse's neighbour pick: the JAX package's expression
    (render/direct.py:376-381) against the port's _disk_offset, on the
    same rng words, over 20 draws."""
    jc, tc = _cfg_pair(spatial_radius=30.0)
    rj = jrng.seed_pixels(SP, SP, jnp.uint32(77))
    rt = trng.seed_pixels(SP, SP, 77, device=CPU)
    same = []
    for _ in range(20):
        rj, a1 = jrng.rand(rj)
        rj, a2 = jrng.rand(rj)
        ang = 2.0 * jnp.pi * a1
        rad = jc.spatial_radius * jnp.sqrt(a2)
        oy = np.asarray(jnp.round(rad * jnp.sin(ang)).astype(jnp.int32))
        ox = np.asarray(jnp.round(rad * jnp.cos(ang)).astype(jnp.int32))
        rt, ty, tx = TD._disk_offset(tc, rt)
        np.testing.assert_array_equal(rt.numpy(),
                                      np.asarray(rj).astype(np.int64))
        same.append((ty.numpy() == oy) & (tx.numpy() == ox))
        assert np.abs(oy).max() <= 30 and np.abs(ox).max() <= 30
    assert np.mean(same) >= 0.999


def test_spatial_gates_match_jax():
    va, vb = _smooth_view(5), _smooth_view(6)
    j = JD._spatial_gates(JView(**va), JView(**vb))
    t = TD._spatial_gates(_t(JView(**va)), _t(JView(**vb)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert 0.1 < np.asarray(j).mean() < 0.9


@pytest.mark.parametrize("rounds,radius", [(2, 30.0), (1, 4.0)])
def test_spatial_reuse_matches_jax(rounds, radius):
    jc, tc = _cfg_pair(spatial_rounds=rounds, spatial_radius=radius)
    v, res = _smooth_view(7), _reservoir(8)
    rj, mj = JD._spatial_reuse(jc, JView(**v), jax.tree.map(jnp.asarray, res),
                               jrng.seed_pixels(SP, SP, jnp.uint32(5)))
    rt, mt = TD._spatial_reuse(tc, _t(JView(**v)), _t(res),
                               trng.seed_pixels(SP, SP, 5, device=CPU))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    mj = jax.tree.map(np.asarray, mj)
    assert (mt["num"].numpy() == mj["num"]).mean() >= 0.999
    assert np.isclose(mt["weight"].numpy(), mj["weight"], rtol=1e-5,
                      atol=1e-6).mean() >= 0.999
    for k in ("li", "wi", "dist"):
        close = np.isclose(mt["sample"][k].numpy(), mj["sample"][k],
                           rtol=1e-5, atol=1e-5)
        assert close.reshape(SP * SP, -1).all(-1).mean() >= 0.999, k
    # it merged neighbours: counts grew well past the pixel's own
    assert (mj["num"] > res["num"]).mean() > 0.5


# ---- visibility reuse ---------------------------------------------------

def _j_tile_active(h, w, frame_idx, cadence):
    """render/direct.py:263-269 of the JAX package."""
    fi = jnp.asarray(frame_idx, jnp.int32).astype(jnp.uint32)
    ty = jnp.arange(h, dtype=jnp.uint32)[:, None] // TILE_H
    tx = jnp.arange(w, dtype=jnp.uint32)[None, :] // TILE_W
    tile_id = ty * jnp.uint32(-(-w // TILE_W)) + tx
    tile_rand = jrng.tea(tile_id, jnp.broadcast_to(fi, tile_id.shape))
    return np.asarray((tile_rand % jnp.uint32(cadence)) == 0)


@pytest.mark.parametrize("cadence", [2, 4])
def test_tile_mask_matches_jax(cadence):
    h, w = 40, 72                      # a ragged last tile column
    share = []
    for fi in range(8):
        j = _j_tile_active(h, w, fi, cadence)
        t = TD._tile_active(h, w, torch.tensor(fi), cadence, CPU).numpy()
        np.testing.assert_array_equal(t, j)
        share.append(j.mean())
        # constant over each 8x16 tile
        assert (j[::TILE_H, ::TILE_W].repeat(TILE_H, 0).repeat(TILE_W, 1)
                [:h, :w] == j).all()
    assert 0.5 / cadence < np.mean(share) < 2.0 / cadence


def test_visibility_reuse_matches_jax():
    """must, shadow_tmax and vis_out (render/direct.py:255-293 of the
    JAX package) on a constructed prev_vis, reprojection and gates."""
    h = w = 32
    r = np.random.default_rng(31)
    prev_vis = r.choice([-1.0, 0.0, 1.0], (h, w)).astype(np.float32)
    mot_y = np.clip(np.arange(h)[:, None] + r.integers(-3, 4, (h, w)), 0,
                    h - 1).astype(np.int32)
    mot_x = np.clip(np.arange(w)[None, :] + r.integers(-3, 4, (h, w)), 0,
                    w - 1).astype(np.int32)
    need = r.random((h, w)) < 0.8
    gates = r.random((h, w)) < 0.7
    dist = (1 + 4 * r.random((h, w))).astype(np.float32)
    traced = r.random((h, w)) < 0.3             # the shadow trace's verdicts
    jc, tc = _cfg_pair(shadow_cadence=4, temporal_halo=2)
    for fi in (0, 5):
        active = _j_tile_active(h, w, fi, 4)
        vis_prev, _ = j_halo_gather(jnp.asarray(prev_vis), jnp.asarray(mot_y),
                                    jnp.asarray(mot_x), jc.temporal_halo)
        must = need & (active | ~(gates & (np.asarray(vis_prev) >= 0.0)))
        tmax = np.where(must, dist * np.float32(0.999), -1.0)
        occ = np.where(must, traced, np.asarray(vis_prev) < 0.5)
        vis_out = np.where(need, np.where(occ, 0.0, 1.0), -1.0)

        t_must, t_vp = TD._reuse_visibility(
            tc, torch.from_numpy(need), torch.from_numpy(gates),
            torch.from_numpy(prev_vis), torch.from_numpy(mot_y).long(),
            torch.from_numpy(mot_x).long(), torch.tensor(fi))
        np.testing.assert_array_equal(t_must.numpy(), must)
        np.testing.assert_array_equal(t_vp.numpy(), np.asarray(vis_prev))
        t_tmax = torch.where(t_must, torch.from_numpy(dist) * 0.999, -1.0)
        np.testing.assert_array_equal(t_tmax.numpy(), tmax)
        t_occ = torch.where(t_must, torch.from_numpy(traced), t_vp < 0.5)
        t_out = torch.where(torch.from_numpy(need),
                            torch.where(t_occ, 0.0, 1.0), -1.0)
        np.testing.assert_array_equal(t_out.numpy(), vis_out)
        assert 0.2 < must.mean() < need.mean()    # some shadow rays saved


# ---- primary_seed on a flat BVH -----------------------------------------

def _j_seed_tmax(cfg, scene, o, d, pt):
    """render/direct.py:147-179 of the JAX package (a flat scene)."""
    ptc = jnp.maximum(pt, 0)
    slot = scene.bvh.slot_of_tri[ptc]
    row = scene.bvh.leaf_blocks.reshape(-1, 12)[slot]
    p_hit, p_t, _, _ = JX.ray_triangle(o, d, row[..., 0:3], row[..., 3:6],
                                       row[..., 6:9], 1e-4, 1e8)
    ok = (pt >= 0) & (slot >= 0) & p_hit
    return np.asarray(jnp.where(ok, p_t * (1.0 + 1e-4) + 1e-6, 1e8))


def test_primary_seed_tmax_matches_jax_flat():
    """Last frame's triangles from a trace of a nearby camera, this
    frame's jittered rays: the seeded t_max of both packages."""
    from eidola_tpu.ops.packets import closest_hit_img
    from eidola_tpu.scene.camera import make_camera, spawn_rays

    scene, _ = cornell_box()
    h = w = 32
    prev = make_camera([0.05, 1.0, 3.6], [0, 1.0, 0], fovy_deg=45.0)
    cam = make_camera([0.0, 1.02, 3.6], [0, 1.0, 0], fovy_deg=45.0,
                      last=prev)
    _, po, pd = spawn_rays(prev, h, w, jrng.seed_pixels(h, w, jnp.uint32(1)))
    pt = closest_hit_img(scene.bvh, po, pd, jnp.full((h, w), 1e-4),
                         jnp.full((h, w), 1e8)).tri
    pt = jnp.where(jnp.arange(w)[None, :] < 3, -1, pt)   # some misses
    _, o, d = spawn_rays(cam, h, w, jrng.seed_pixels(h, w, jnp.uint32(2)))
    j = _j_seed_tmax(jcfg.RenderConfig(width=w, height=h), scene, o, d, pt)
    t = TD._seed_tmax(RenderConfig(width=w, height=h, primary_seed=True),
                      _t(scene), _t(o), _t(d), _t(pt)).numpy()
    np.testing.assert_array_equal(t == 1e8, j == 1e8)
    np.testing.assert_allclose(t, j, rtol=1e-6)
    seeded = j < 1e8
    assert 0.5 < seeded.mean() < 1.0
    # a seed bounds the true hit from above: the real closest hit of this
    # frame's ray is never cut off
    t_hit = np.asarray(closest_hit_img(scene.bvh, o, d, jnp.full((h, w), 1e-4),
                                       jnp.full((h, w), 1e8)).t)
    assert (t_hit[seeded] <= t[seeded]).all()


# ---- bilateral_denoise --------------------------------------------------

def test_bilateral_denoise_matches_jax():
    v = _random_view(32, 32, seed=41)
    img = np.random.default_rng(42).random((32, 32, 3)).astype(np.float32)
    sig = [np.float32(x) for x in (4.0, 128.0, 2.0)]
    j = np.asarray(j_bilateral(jnp.asarray(img),
                               JView(**{k: jnp.asarray(x)
                                        for k, x in v.items()}), 2, *sig))
    t = bilateral_denoise(torch.from_numpy(img), _t(JView(**v)), 2,
                          *(torch.tensor(s) for s in sig)).numpy()
    assert np.abs(j - img).mean() > 1e-3               # it did filter
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


# ---- pick ---------------------------------------------------------------

@pytest.mark.parametrize("py,px,hit", [(32, 32, True), (20, 40, True),
                                       (0, 0, False)])
def test_pick_matches_jax(py, px, hit):
    """Cornell's centre (the back wall), a wall off centre, and the top
    left corner, which looks past the open front of the box."""
    scene, cam = cornell_box()
    j = j_pick(scene, cam, 64, 64, py, px)
    t = pick(_t(scene), _t(cam), 64, 64, py, px)
    assert j.hit == t.hit == hit
    assert t.tri_id == j.tri_id and t.material_id == j.material_id
    assert t.t == pytest.approx(j.t, rel=1e-5)
    np.testing.assert_allclose(t.world_pos, j.world_pos, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t.barycentrics, j.barycentrics, atol=1e-5)
    if hit and (py, px) == (32, 32):
        assert t.world_pos[2] == pytest.approx(-1.0, abs=0.2)


# ---- the headless app ---------------------------------------------------

def _headless(*flags, size=16, frames=2):
    return headless.run(["--scene", "cornell", "--size", str(size),
                         str(size), "--frames", str(frames), "--device",
                         "cpu", "--quiet", *flags])


@pytest.mark.parametrize("flags", [
    ("--max-depth", "2"), ("--debug", "normal"), ("--debug", "depth"),
    ("--orbit", "0.1"), ("--shadow-cadence", "4"), ("--primary-seed",),
    ("--orbit", "0.05", "--restir", "spatiotemporal", "--shadow-cadence",
     "4", "--primary-seed", "--no-denoise")], ids=" ".join)
def test_headless_new_flags_render(flags):
    out = _headless(*flags)
    img = out["image"]
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() < 1.0
    # a moving camera resets the accumulation every frame
    moving = "--orbit" in flags
    assert float(out["state"].accum_count) == (1.0 if moving else 2.0)


@pytest.mark.parametrize("mode", sorted(headless.RESTIR_MODES))
def test_headless_restir_modes(mode):
    out = _headless("--restir", mode, "--no-indirect")
    assert np.isfinite(out["image"]).all() and out["image"].mean() > 0.0


@pytest.mark.parametrize("size,descale", [(64, 2), (16, 2), (96, 3)])
def test_headless_descale_gives_requested_extent(size, descale):
    out = _headless("--descale", str(descale), "--no-indirect", size=size,
                    frames=1)
    assert out["image"].shape == (size, size, 3)
    assert out["width"] == max(size // descale // 32 * 32, 32)
    assert np.isfinite(out["image"]).all() and out["image"].mean() > 0.0


@pytest.mark.parametrize("src,dst", [((32, 32), (64, 64)), ((32, 64),
                                     (96, 80)), ((32, 32), (16, 16)),
                                     ((64, 32), (20, 50))])
def test_upscale_matches_jax_resize(src, dst):
    """The --descale upscale against jax.image.resize(method="bilinear")
    on up- and downscales, border pixels included."""
    img = np.random.default_rng(sum(src)).random(src + (3,)).astype(
        np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(img), dst + (3,),
                                    method="bilinear"))
    t = headless.resize_bilinear(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


# ---- the whole interactive frame against JAX render_frame ---------------

W = H = 32
FRAMES = 3
CFG = dict(width=W, height=H, max_depth=1, env_mode="sunsky", denoise=False,
           indirect_enabled=False, traversal_max_steps=1024,
           restir_mode=RESTIR_SPATIOTEMPORAL, spatial_rounds=2,
           shadow_cadence=2, primary_seed=True)
ORBIT = 0.02


def _manip(cls, cam, **kw):
    """The headless app's manipulator set-up, on the scene's camera."""
    view_inv = np.asarray(cam.view_inv)
    pos = np.asarray(cam.pos)
    m = cls(pos, pos - view_inv[:3, 2] * 3.0, aspect=W / H, **kw)
    m._cam = cam
    return m


def _record(state, o, conv):
    g, r = state.gbuf, state.di_resv
    rec = {"tri": g.tri, "nrm": g.nrm, "mat": g.mat, "depth": g.depth,
           "vis": state.di_vis, "num": r["num"], "weight": r["weight"],
           "accum_count": state.accum_count, "image": o["image"],
           "hdr": o["hdr"], "direct_ldr": o["direct_ldr"],
           "motion": o["motion"]}
    return {k: conv(v) for k, v in rec.items()}


@pytest.fixture(scope="module")
def interactive_frames():
    scene, cam = cornell_box()
    jm = _manip(JManip, cam)
    cfg = jcfg.RenderConfig(**CFG)
    params, tm = jcfg.default_params(), jcfg.default_tonemap()
    state, step = j_init(cfg, cam), j_make_step(cfg)
    jax_out = []
    for i in range(FRAMES):
        c = jm.orbit(ORBIT, 0.0) if i else cam
        p = params._replace(time_word=jnp.asarray(100 + i, jnp.uint32))
        state, o = step(scene, c, p, tm, state)
        jax_out.append(_record(state, o, np.asarray))

    tscene, tcam = _t(scene), _t(cam)
    tparams = _t(jcfg.default_params())
    ttm = _t(jcfg.default_tonemap())
    tmn = _manip(CameraManipulator, tcam, device=CPU)
    tcfg = RenderConfig(**CFG)
    state, step = init_frame_state(tcfg, tcam), make_step(tcfg)
    port_out = []
    for i in range(FRAMES):
        c = tmn.orbit(ORBIT, 0.0) if i else tcam
        p = tparams._replace(time_word=torch.tensor(100 + i))
        state, o = step(tscene, c, p, ttm, state)
        port_out.append(_record(state, o, lambda a: a.numpy()))
    return jax_out, port_out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_interactive_gbuffer_and_motion_match(interactive_frames, frame):
    j, p = interactive_frames[0][frame], interactive_frames[1][frame]
    for k in ("tri", "nrm", "mat"):
        same = (j[k].astype(np.int64) == p[k].astype(np.int64)).mean()
        assert same >= 0.999, (k, same)
    hit = j["tri"] >= 0
    np.testing.assert_allclose(p["depth"][hit], j["depth"][hit], rtol=1e-4)
    assert (j["motion"].astype(np.int64) == p["motion"]).mean() >= 0.999
    if frame:                          # the camera moved: not the identity
        own = np.stack(np.meshgrid(np.arange(H), np.arange(W),
                                   indexing="ij"), -1)
        ok = p["motion"][..., 0] >= 0
        assert (p["motion"][ok] != own[ok]).any(-1).mean() > 0.1


@pytest.mark.parametrize("frame", range(FRAMES))
def test_interactive_reservoirs_and_visibility_match(interactive_frames,
                                                     frame):
    j, p = interactive_frames[0][frame], interactive_frames[1][frame]
    assert (j["vis"] == p["vis"]).mean() >= 0.99
    assert (j["num"] == p["num"]).mean() >= 0.99
    close = np.isclose(p["weight"], j["weight"], rtol=1e-3, atol=1e-6)
    assert close.mean() >= 0.99


@pytest.mark.parametrize("frame", range(FRAMES))
def test_interactive_image_matches(interactive_frames, frame):
    j, p = interactive_frames[0][frame], interactive_frames[1][frame]
    # the camera moves every frame, so the accumulation restarts each time
    assert float(p["accum_count"]) == float(j["accum_count"]) == 1.0
    assert np.isfinite(p["image"]).all()
    assert np.abs(p["image"] - j["image"]).mean() <= 2e-3
    assert np.abs(p["direct_ldr"] - j["direct_ldr"]).mean() <= 2e-3
    assert np.abs(p["hdr"] - j["hdr"]).mean() <= 2e-3 * max(
        1.0, float(np.abs(j["hdr"]).mean()))


# ---- every RenderConfig option renders ----------------------------------

def _render(**opt):
    scene, cam = load_scene("cornell", device=CPU)
    cfg = RenderConfig(width=16, height=16, max_depth=1, **opt)
    state = init_frame_state(cfg, cam)
    step = make_step(cfg)
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    for _ in range(2):
        state, out = step(scene, cam, params, tm, state)
    return out["hdr"]


@pytest.mark.parametrize("opt", [dict(primary_seed=True),
                                 dict(shadow_cadence=2),
                                 dict(restir_mode=RESTIR_SPATIAL),
                                 dict(spatial_rounds=2)],
                         ids=lambda o: ",".join(o))
def test_former_unported_options_render(opt):
    """The options the port refused before the interactive slice render.
    spatial_rounds is read only in the spatial modes, as in the JAX
    package (render/direct.py:316-317): under the default temporal mode
    it changes nothing."""
    hdr = _render(**opt)
    assert np.isfinite(hdr.numpy()).all() and float(hdr.mean()) > 0.0
    if opt == dict(spatial_rounds=2):
        assert torch.equal(hdr, _render())
