"""The port's alpha HitTest (render/tracer.py) and the opaque/alpha BVH
split (scene/data.py) against the JAX package's.

- The scenes `alpha` (a flat scene whose MASK screen splits off) and
  `mini_grove` (instanced trees whose MASK leaf cards split into a flat
  world-space alpha BVH) equal the JAX-built arrays bit for bit, the port
  on the host builder the JAX side took (`host_builders_like_jax`), and
  again with the JAX package's native library forced off.
- `_surface_opacity` and `_alpha_passthrough` on the same hit records and
  rng words in both packages.
- Alpha `trace_closest` and `trace_occlusion` against JAX's on both
  scenes, with the lockstep hop loop both packages run on the CPU.
- The queue march equals the lockstep loop on MASK materials, where the
  alpha test draws no rng that matters (tests/test_alpha.py:178-234):
  stacked MASK quads, with 64 rays and with 36,864 rays (enough for the
  staged capacities 32768 -> 8192 to run several laps), and mini_grove.
- In both march modes, rays that miss the alpha set or pass through it
  get the opaque half's hits and occlusion.
- The queue march through `_march_lap` (the plain lap the CPU runs)
  against the march as it was before its lap was factored out, kept
  verbatim here: each lap's re-traced rays and order, then records, rng
  words and occlusion, bit for bit; the lap kernels' wrappers refuse
  what the kernels do not take.
- The headless entry point turns the HitTest on from the scene and
  renders `alpha` and `mini_grove` on the CPU; its device defaults to
  cuda.

Tolerances: scene arrays bitwise; opacity within 1e-6 (bilinear texture
taps in f32), passthrough verdicts and rng words equal.  Traced records:
triangle ids equal on >= 0.999 of rays (a different winner only at an
exact-t tie, ROADMAP C item 1), t within 1e-4 relative; occlusion equal.
Queue vs lockstep, and HitTest vs the opaque half, on one package: ids,
t and occlusion equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.models.scenes as JS
import eidola_tpu.ops.rng as jrng
import eidola_tpu.render.tracer as JT
from eidola_tpu.render.config import RenderConfig as JConfig
from eidola_tpu_torch import interop
from eidola_tpu_torch.models import scenes as TS
from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import rng as trng
from eidola_tpu_torch.render import tracer as TT
from eidola_tpu_torch.render.config import RenderConfig
from eidola_tpu_torch.scene import data as TD
from test_torch_foundations import host_builders_like_jax, jax_native_off
from test_torch_instanced import _compare_tree

torch.set_num_threads(2)
CPU = torch.device("cpu")
SCENES = {"alpha": ("alpha_demo", [0.0, 1.2, 0.0], 1.6),
          "mini_grove": ("mini_grove", [0.0, 1.8, 0.0], 3.0)}


def _build_both(key):
    """(JAX scene, port scene) of SCENES[key], each built by its package
    (the port on the builder the JAX side took)."""
    name = SCENES[key][0]
    js, _ = getattr(JS, name)()
    with host_builders_like_jax():
        ts, _ = getattr(TS, name)(device=CPU)
    return js, ts


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    _, center, spread = SCENES[request.param]
    return request.param, *_build_both(request.param), center, spread


def _rays(center, spread, n=256, seed=3):
    """Rays from a ring around the scene aimed at its alpha geometry."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([6 * np.sin(ang), rng.uniform(0.5, 4, n), 6 * np.cos(ang)],
                 -1).astype(np.float32)
    tgt = (np.asarray(center) + rng.uniform(-spread, spread, (n, 3))
           ).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_split_scene_matches_jax(pair):
    _check_split(*pair[:3])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_split_scene_matches_jax_native_off(name, monkeypatch):
    """The JAX side on its numpy builders (its library forced off), as
    when its g++ build races another test worker: the port follows it."""
    jax_native_off(monkeypatch)
    _check_split(name, *_build_both(name))


def _check_split(name, js, ts):
    assert ts.bvh_alpha is not None and js.bvh_alpha is not None
    assert isinstance(ts.bvh_alpha, TB.BVH)           # the flat alpha BVH
    assert (ts.inst is not None) == (name == "mini_grove")
    _compare_tree(interop.to_numpy(ts), js)
    # each triangle belongs to exactly one half, by its material
    op = ts.bvh.slot_of_tri >= 0
    al = ts.bvh_alpha.slot_of_tri >= 0
    assert bool((op ^ al).all()) and al.any()


def _records(ts, o, d):
    """Closest hits on the alpha half: records of alpha-tested hits."""
    n = o.shape[0]
    return TB.closest_hit(ts.bvh_alpha, torch.from_numpy(o),
                          torch.from_numpy(d), torch.full((n,), 1e-4),
                          torch.full((n,), 1e8))


def test_opacity_and_passthrough_match_jax(pair):
    _, js, ts, center, spread = pair
    o, d = _rays(center, spread)
    rec = _records(ts, o, d)
    hit = rec.tri >= 0
    assert hit.float().mean() > 0.2
    jrec = [jnp.asarray(a.numpy()) for a in rec]
    top = TT._surface_opacity(ts, rec.tri, rec.u, rec.v)
    jop = JT._surface_opacity(js, jrec[0], jrec[2], jrec[3])
    np.testing.assert_allclose(top.numpy(), np.asarray(jop), atol=1e-6)
    rng_t = trng.seed_pixels(1, o.shape[0], 7, device=CPU)[0]
    rng_j = jrng.seed_pixels(1, o.shape[0], jnp.uint32(7))[0]
    r_t, pt = TT._alpha_passthrough(ts, rec, rng_t)
    r_j, pj = JT._alpha_passthrough(js, type(rec)(*jrec), rng_j)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j).astype(
        np.int64))
    # some hits pass through the MASK, some are solid
    assert pt[hit].any() and (~pt[hit]).any()


def _cfgs(**kw):
    return (RenderConfig(width=8, height=8, alpha_geometry=True, **kw),
            JConfig(width=8, height=8, alpha_geometry=True, **kw))


def test_alpha_traces_match_jax(pair, monkeypatch):
    _, js, ts, center, spread = pair
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "lockstep")
    o, d = _rays(center, spread, seed=4)
    n = o.shape[0]
    cfg, jcfg = _cfgs(traversal_max_steps=2048)
    tmin, tmax = np.full(n, 1e-4, np.float32), np.full(n, 1e8, np.float32)
    smax = np.where(np.arange(n) % 2, 1e8, 5.0).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a)
    rng_t = trng.seed_pixels(1, n, 3, device=CPU)[0]
    rng_j = jrng.seed_pixels(1, n, jnp.uint32(3))[0]

    rt, rec = TT.trace_closest(cfg, ts, t(o), t(d), t(tmin), t(tmax), rng_t)
    rj, jrec = JT.trace_closest(jcfg, js, j(o), j(d), j(tmin), j(tmax),
                                rng_j)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    jtri, ttri = np.asarray(jrec.tri), rec.tri.numpy()
    hits = jtri >= 0
    np.testing.assert_array_equal(ttri >= 0, hits)
    assert (ttri == jtri).mean() >= 0.999
    np.testing.assert_allclose(rec.t.numpy()[hits], np.asarray(jrec.t)[hits],
                               rtol=1e-4)
    # the march passed through leaves/cut-outs: some final hits are opaque
    # geometry behind an alpha-tested hit of the plain split closest hit
    first = TB.closest_hit(ts.bvh_alpha, t(o), t(d), t(tmin), t(tmax))
    assert ((first.tri >= 0) & (rec.t > first.t + 1e-3)).any()

    ot, occ = TT.trace_occlusion(cfg, ts, t(o), t(d), t(tmin), t(smax),
                                 rng_t)
    oj, jocc = JT.trace_occlusion(jcfg, js, j(o), j(d), j(tmin), j(smax),
                                  rng_j)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj).astype(np.int64))
    assert 0 < int(occ.sum()) < n


def _stacked_quads(alpha):
    """Three stacked MASK quads in front of a box (tests/test_alpha.py)."""
    quads = [TS.quad_tris([-2, -2, z], [2, -2, z], [2, 2, z], [-2, 2, z])
             for z in (1.0, 1.3, 1.6)]
    box = TS.box_tris([0, 0, -1.0], [0.5, 0.5, 0.5])
    tris = np.concatenate(quads + [box])
    nq = sum(q.shape[0] for q in quads)
    mats = np.concatenate([np.zeros(nq, np.int32),
                           np.ones(box.shape[0], np.int32)])
    return TD.upload_scene(
        tris[:, 0], tris[:, 1], tris[:, 2], device=CPU, mat_ids=mats,
        materials=[{"base_color": [1, 1, 1, alpha],
                    "alpha_mode": TD.ALPHA_MASK, "alpha_cutoff": 0.5},
                   {"base_color": [0.5, 0.2, 0.2, 1.0]}])


def _march_both(scene, o, d, monkeypatch, smax=6.0, **kw):
    n = o.shape[0]
    cfg = RenderConfig(width=8, height=8, alpha_geometry=True, **kw)
    rng = trng.seed_pixels(1, n, 5, device=CPU)[0]
    out = {}
    for mode in ("queue", "lockstep"):
        monkeypatch.setenv("EIDOLA_ALPHA_MARCH", mode)
        _, rec = TT.trace_closest(cfg, scene, o, d, torch.full((n,), 1e-4),
                                  torch.full((n,), 1e8), rng)
        _, occ = TT.trace_occlusion(cfg, scene, o, d, torch.full((n,), 1e-4),
                                    torch.full((n,), smax), rng)
        out[mode] = (rec, occ)
    (rq, oq), (rl, ol) = out["queue"], out["lockstep"]
    assert torch.equal(rq.tri, rl.tri)
    assert torch.equal(rq.t, rl.t)
    assert torch.equal(oq, ol)
    return rl, ol


@pytest.mark.parametrize("n", [64, 36864])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_queue_matches_lockstep_mask(alpha, n, monkeypatch):
    scene = _stacked_quads(alpha)
    rng = np.random.default_rng(n)
    o = torch.from_numpy(np.concatenate(
        [rng.uniform(-1.5, 1.5, (n, 2)), np.full((n, 1), 4.0)], 1
    ).astype(np.float32))
    d = torch.tensor([0.0, 0.0, -1.0]).expand(n, 3).contiguous()
    if n > 64:
        assert TT._march_caps(n) == [32768, 8192]
    rec, occ = _march_both(scene, o, d, monkeypatch, alpha_hops=4,
                           traversal_max_steps=512)
    box_hit = (rec.t - 4.5).abs() < 1e-3
    if alpha == 0.0:            # every quad passed: only the box counts
        assert bool(box_hit[o[:, :2].abs().amax(1) < 0.5].all())
        assert torch.equal(occ, box_hit) and bool(occ.any())
    else:                       # the nearest quad (z = 1.6) is solid
        assert bool(((rec.t - 2.4).abs() < 1e-3).all()) and bool(occ.all())


def test_queue_matches_lockstep_mini_grove(monkeypatch):
    scene, _ = TS.mini_grove(device=CPU)
    o, d = _rays([0.0, 1.8, 0.0], 3.0, n=512, seed=9)
    rec, occ = _march_both(scene, torch.from_numpy(o), torch.from_numpy(d),
                           monkeypatch, smax=5.0, traversal_max_steps=2048)
    assert (rec.tri >= 0).float().mean() > 0.3 and 0 < int(occ.sum()) < 512


@pytest.mark.parametrize("scene", ["alpha", "mini_grove"])
def test_headless_turns_the_hittest_on(scene):
    """The entry point sets alpha_geometry from the scene's materials and
    renders the default frame on the CPU when asked to."""
    from eidola_tpu_torch.app import headless

    out = headless.run(["--scene", scene, "--size", "32", "32", "--frames",
                        "2", "--device", "cpu", "--quiet"])
    img = out["image"]
    assert out["alpha_geometry"] is True
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.02 < img.mean() < 1.0 and img.min() >= 0.0 and img.max() <= 1.0
    assert headless.build_argparser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("march", ["queue", "lockstep"])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_hittest_against_opaque_half(alpha, march, monkeypatch):
    """Rays through the stacked quads and beside them, in each march
    mode: with every quad cut out (alpha 0) the HitTest gives the opaque
    half's closest hit and occlusion on every ray; with solid quads
    (alpha 1) the rays inside their footprint stop on the nearest quad
    (t = 2.4) and the rays beside it still get the opaque half's."""
    scene = _stacked_quads(alpha)
    rng_np = np.random.default_rng(3)
    o = np.tile([0.0, 0.0, 4.0], (128, 1)).astype(np.float32)
    o[:, 0:2] += rng_np.uniform(-6, 6, (128, 2)).astype(np.float32)
    o = torch.from_numpy(o)
    d = torch.tensor([0.0, 0.0, -1.0]).expand(128, 3).contiguous()
    tmin, tmax = torch.full((128,), 1e-4), torch.full((128,), 1e8)
    smax = torch.full((128,), 6.0)
    inside = o[:, :2].abs().amax(1) < 2.0
    assert bool(inside.any()) and not bool(inside.all())
    cfg = RenderConfig(width=8, height=16, alpha_geometry=True,
                       alpha_hops=4, traversal_max_steps=512)
    rng = trng.seed_pixels(1, 128, 5, device=CPU)[0]
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", march)
    _, rec = TT.trace_closest(cfg, scene, o, d, tmin, tmax, rng)
    _, occ = TT.trace_occlusion(cfg, scene, o, d, tmin, smax, rng)
    opaque = TB.closest_hit(scene.bvh, o, d, tmin, tmax)
    opaque_occ = TB.any_hit(scene.bvh, o, d, tmin, smax)
    assert bool((opaque.tri >= 0).any()) and bool((opaque.tri < 0).any())
    beside = ~inside if alpha == 1.0 else torch.ones_like(inside)
    assert torch.equal(rec.tri[beside], opaque.tri[beside])
    assert torch.equal(rec.t[beside], opaque.t[beside])
    assert torch.equal(occ[beside], opaque_occ[beside])
    if alpha == 1.0:
        assert bool(((rec.t[inside] - 2.4).abs() < 1e-3).all())
        assert bool(occ[inside].all())


def _j_seed_tmax(js, o, d, pt):
    """primary_seed's t_max0 in the JAX package (render/direct.py:147-179)
    with the HitTest on."""
    from eidola_tpu.ops.intersect import ray_triangle
    from eidola_tpu.scene.data import shade_row

    bvh = js.bvh
    ptc = jnp.maximum(pt, 0)
    slot = bvh.slot_of_tri[ptc]
    row = bvh.leaf_blocks.reshape(-1, 12)[slot]
    if js.inst is None:
        o_t, d_t = o, d
    else:
        r = bvh.inst_inv[bvh.inst_of_tri[ptc]].reshape(ptc.shape + (3, 4))
        o_t = jnp.einsum("...ij,...j->...i", r[..., :3], o) + r[..., 3]
        d_t = jnp.einsum("...ij,...j->...i", r[..., :3], d)
    p_hit, p_t, _, _ = ray_triangle(o_t, d_t, row[..., 0:3], row[..., 3:6],
                                    row[..., 6:9], 1e-4, 1e8)
    ok = (pt >= 0) & (slot >= 0) & p_hit
    arow, _ = shade_row(js, ptc)
    ok &= js.materials.alpha_mode[js.tri_mat[arow]] == 0
    return np.asarray(jnp.where(ok, p_t * (1.0 + 1e-4) + 1e-6, 1e8))


def test_primary_seed_tmax_matches_jax_split(pair):
    """primary_seed on the split scenes with the HitTest on: last frame's
    triangles (opaque and alpha) from rays a little off this frame's;
    t_max0 within 1e-6 relative of the JAX expression (the instanced
    re-test runs through einsum in both, in other orders); only opaque
    triangles of the BVH's own half seed; the seeded trace gives the
    unseeded trace's hits."""
    from eidola_tpu_torch.render.direct import _seed_tmax

    _, js, ts, center, spread = pair
    o, d = _rays(center, spread, n=512, seed=6)
    n = o.shape[0]
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tn, tx = torch.full((n,), 1e-4), torch.full((n,), 1e8)
    prev = TT._merge_closest(
        TB.closest_hit(ts.bvh, to + 0.01, td, tn, tx) if ts.inst is None
        else TT.closest_hit_img(ts.bvh, (to + 0.01)[None], td[None],
                                tn[None], tx[None]),
        TB.closest_hit(ts.bvh_alpha, to + 0.01, td, tn, tx))
    pt = prev.tri.reshape(n)
    assert bool((ts.bvh.slot_of_tri[pt.clamp(min=0)] < 0).any())  # alpha ids
    cfg, _ = _cfgs(primary_seed=True)
    t = _seed_tmax(cfg, ts, to, td, pt).numpy()
    j = _j_seed_tmax(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(pt))
    np.testing.assert_array_equal(t == 1e8, j == 1e8)
    np.testing.assert_allclose(t, j, rtol=1e-6)
    seeded = t < 1e8
    assert 0.2 < seeded.mean() < 0.95
    rng = trng.seed_pixels(1, n, 3, device=CPU)[0]
    _, rec0 = TT.trace_closest(cfg, ts, to, td, tn, tx, rng)
    _, rec1 = TT.trace_closest(cfg, ts, to, td, tn, torch.from_numpy(t), rng)
    assert torch.equal(rec0.tri, rec1.tri) and torch.equal(rec0.t, rec1.t)


def test_blend_queue_march_matches_jax(monkeypatch):
    """ROADMAP C2: a BLEND material through the queue march, the port's
    against the JAX package's, EIDOLA_ALPHA_MARCH=queue on both sides:
    both draw one rng number per queued test, so the rng words (one
    advance per test), the hits after the re-traces and the occlusion
    verdicts are equal per ray."""
    import eidola_tpu.models.scenes as JSC
    from eidola_tpu.scene.data import ALPHA_BLEND, upload_scene

    quads = [JSC.quad_tris([-2, -2, z], [2, -2, z], [2, 2, z], [-2, 2, z])
             for z in (1.0, 1.3, 1.6)]
    box = JSC.box_tris([0, 0, -1.0], [0.5, 0.5, 0.5])
    tris = np.concatenate(quads + [box])
    nq = sum(q.shape[0] for q in quads)
    mats = np.concatenate([np.zeros(nq, np.int32),
                           np.ones(box.shape[0], np.int32)])
    js = upload_scene(tris[:, 0], tris[:, 1], tris[:, 2], mat_ids=mats,
                      materials=[{"base_color": [1, 1, 1, 0.5],
                                  "alpha_mode": ALPHA_BLEND},
                                 {"base_color": [0.5, 0.2, 0.2, 1.0]}])
    ts = interop.to_torch(js, CPU)
    n = 384
    r = np.random.default_rng(17)
    o = np.concatenate([r.uniform(-2.5, 2.5, (n, 2)), np.full((n, 1), 4.0)],
                       1).astype(np.float32)
    o[: n // 2, :2] *= 0.2                  # half of them at the box
    d = np.tile([0.0, 0.0, -1.0], (n, 1)).astype(np.float32)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 1e8, np.float32)
    smax = np.full(n, 6.0, np.float32)
    cfg, jcfg = _cfgs(alpha_hops=4, traversal_max_steps=512)
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "queue")
    t = lambda a: torch.from_numpy(a)
    rng_t = trng.seed_pixels(1, n, 9, device=CPU)[0]
    rng_j = jrng.seed_pixels(1, n, jnp.uint32(9))[0]

    rt, rec = TT.trace_closest(cfg, ts, t(o), t(d), t(tmin), t(tmax), rng_t)
    j = lambda a: jnp.asarray(a)
    rj, jrec = JT.trace_closest(jcfg, js, j(o), j(d), j(tmin), j(tmax), rng_j)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    np.testing.assert_array_equal(rec.tri.numpy(), np.asarray(jrec.tri))
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(jrec.t), rtol=1e-6)
    # BLEND at opacity 0.5: rays stop on every layer and on the box
    depth = np.round(rec.t.numpy(), 1)
    for z in (2.4, 2.7, 3.0, 4.5):
        assert (depth == z).any(), z

    ot, occ = TT.trace_occlusion(cfg, ts, t(o), t(d), t(tmin), t(smax),
                                 rng_t)
    oj, jocc = JT.trace_occlusion(jcfg, js, j(o), j(d), j(tmin), j(smax),
                                  rng_j)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj).astype(np.int64))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    inside = (np.abs(o[:, :2]) < 2.0).all(1)
    assert occ.numpy()[inside].any() and not occ.numpy()[inside].all()


def _march_before(scene, hop_bvh, o, d, a_tmax, rec0, rng_state, budget,
                  max_steps, occl, closest_hit_sorted):
    """render/tracer.py's `_alpha_march` and `_march_band` as they were
    before a lap became `_march_lap` (one lap = the alpha test, the
    re-trace and the scatter inline), verbatim but for the module prefix
    and the re-trace, passed in: the reference the plain lap is held to."""
    from eidola_tpu_torch.ops.halo import get_bands
    from eidola_tpu_torch.utils import profiler

    def _march_band(scene, hop_bvh, o_f, d_f, tmax_f, rec, rng_f, occluded,
                    rec_type, budget, max_steps, occl, caps):
        pending = rec[0] >= 0
        if not occl and budget <= 0:
            pending = torch.zeros_like(pending)
        bleft = torch.where(pending, budget, 0)
        for k, cap in enumerate(caps):
            nxt = caps[k + 1] if k + 1 < len(caps) else 0
            while TT._pending_count(pending) > nxt:
                with profiler.sync("march.select"):
                    sel = torch.nonzero(pending)[:cap, 0]
                rec_sel = rec_type(*[x[sel] for x in rec])
                rng_new, pt = TT._alpha_passthrough(scene, rec_sel,
                                                    rng_f[sel])
                b_sel = bleft[sel]
                if occl:
                    b_sel = b_sel - 1                  # a test consumed
                    occ_new = ~pt                      # a solid hit occludes
                    go = pt & (b_sel > 0)
                else:
                    occ_new = torch.zeros_like(pt)
                    go = pt                            # pending => b_sel > 0
                    b_sel = b_sel - go.long()          # a re-trace consumed
                tn = torch.where(go, rec_sel.t * (1.0 + 1e-4) + 1e-5, 1.0)
                tx = torch.where(go, tmax_f[sel], -1.0)
                rec2 = closest_hit_sorted(hop_bvh, o_f[sel], d_f[sel], tn,
                                          tx, max_steps=max_steps)
                for x, a, b in zip(rec, rec_sel, rec2):
                    x[sel] = torch.where(go, b, a)
                rng_f[sel] = rng_new
                pending[sel] = go & (rec2.tri >= 0) & (occl | (b_sel > 0))
                occluded[sel] |= occ_new
                bleft[sel] = b_sel

    shape = tuple(rec0.t.shape)
    R = rec0.t.numel()
    dev = rec0.t.device
    tmax_f = torch.broadcast_to(torch.as_tensor(a_tmax, dtype=torch.float32,
                                                device=dev), shape).reshape(R)
    rec = [x.reshape(R).clone() for x in rec0]
    rng_f = rng_state.reshape(R).clone()
    B = get_bands()
    if not (B > 1 and R % B == 0 and (R // B) % 128 == 0):
        B = 1
    Rl = R // B
    occluded = torch.zeros(R, dtype=torch.bool, device=dev)
    for b in range(B):      # views: each band's march writes in place
        s = slice(b * Rl, (b + 1) * Rl)
        _march_band(scene, hop_bvh, o.reshape(R, 3)[s], d.reshape(R, 3)[s],
                    tmax_f[s], [x[s] for x in rec], rng_f[s], occluded[s],
                    type(rec0), budget, max_steps, occl,
                    TT._march_caps(Rl, B))
    rec = type(rec0)(*[x.reshape(shape) for x in rec])
    return rng_f.reshape(shape), rec, occluded.reshape(shape)


def _lap_scene(kind):
    """(scene, o, d) for the lap cases: `flat` the alpha screen (textured
    MASK), `instanced` mini_grove (instanced trees, textured MASK leaf
    cards in a flat alpha BVH), `untextured` the stacked quads at base
    alpha 0.4 (the 1x1 texture stack; MASK passes every hit)."""
    if kind == "untextured":
        n = 512
        r = np.random.default_rng(11)
        o = np.concatenate([r.uniform(-2.5, 2.5, (n, 2)),
                            np.full((n, 1), 4.0)], 1).astype(np.float32)
        d = np.tile([0.0, 0.0, -1.0], (n, 1)).astype(np.float32)
        return _stacked_quads(0.4), torch.from_numpy(o), torch.from_numpy(d)
    name, center, spread = {"flat": SCENES["alpha"],
                            "instanced": SCENES["mini_grove"]}[kind]
    scene, _ = getattr(TS, name)(device=CPU)
    o, d = _rays(center, spread, n=512, seed=8)
    return scene, torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module")
def lap_scenes():
    return {k: _lap_scene(k) for k in ("flat", "instanced", "untextured")}


def _as_blend(scene):
    am = scene.materials.alpha_mode
    return scene._replace(materials=scene.materials._replace(
        alpha_mode=torch.where(am == TD.ALPHA_MASK, TD.ALPHA_BLEND, am)))


@pytest.mark.parametrize("bands", [1, 2])
@pytest.mark.parametrize("kind", ["flat", "instanced", "untextured"])
@pytest.mark.parametrize("mode", ["mask", "blend"])
@pytest.mark.parametrize("budget", [0, 1, 4])
@pytest.mark.parametrize("occl", [False, True], ids=["closest", "occl"])
def test_plain_lap_matches_march_before(lap_scenes, occl, budget, mode, kind,
                                        bands, monkeypatch):
    """The queue march through `_march_lap` (the plain lap the CPU runs:
    `_lap_prep_ref`, the sort of its keys, the sorted walk,
    `_lap_merge_ref`) equals the march as it was before, bit for bit:
    each lap's re-traced rays (o, d, t_min, t_max) and their wavefront
    order, then the records, rng words and occlusion.  Budgets 0, 1 and
    alpha_hops (4), occlusion and closest hit, MASK and BLEND, on a flat,
    an instanced and an untextured scene, unbanded and in 2 bands; the lap
    capacities cut to [128, 64] so a band takes several partial laps."""
    from eidola_tpu_torch.ops.halo import band_context
    from eidola_tpu_torch.ops.packets import (closest_hit_sorted,
                                              make_ray_order)

    def recorded(calls, ordered):
        def trace(bvh, o, d, tn, tx, max_steps, order=None):
            if ordered:             # the lap's order is the door's own
                want = make_ray_order(bvh, o, d, tx < tn)
                assert all(torch.equal(a, b) for a, b in zip(order, want))
            calls.append((o, d, tn, tx))
            return closest_hit_sorted(bvh, o, d, tn, tx, max_steps=max_steps,
                                      order=order)
        return trace

    assert RenderConfig().alpha_hops == 4
    scene, o, d = lap_scenes[kind]
    if mode == "blend":
        scene = _as_blend(scene)
    hop = scene.bvh_alpha
    n = o.shape[0]
    tmin = torch.full((n,), 1e-4)
    tmax = torch.full((n,), 5.0 if occl else 1e8)
    rec0 = closest_hit_sorted(hop, o, d, tmin, tmax, max_steps=2048)
    rng = trng.seed_pixels(1, n, 13, device=CPU)[0]
    monkeypatch.setattr(TT, "_march_caps", lambda R, B=1: [128, 64])
    laps, got_calls, want_calls = [], [], []
    lap = TT._march_lap
    monkeypatch.setattr(TT, "_march_lap",
                        lambda *a: laps.append(a[2].numel()) or lap(*a))
    monkeypatch.setattr(TT, "closest_hit_sorted", recorded(got_calls, True))
    with band_context(bands):
        got = TT._alpha_march(scene, hop, o, d, tmax, rec0, rng, budget,
                              2048, occl)
        want = _march_before(scene, hop, o, d, tmax, rec0, rng, budget,
                             2048, occl, recorded(want_calls, False))
    assert len(got_calls) == len(want_calls) == len(laps)
    for a, b in zip(got_calls, want_calls):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if budget > 0 or occl:
        assert laps and max(laps) <= 128, laps
        assert bool((rec0.tri >= 0).any())
    else:                       # no re-trace budget: nothing is queued
        assert laps == []


def _lap_args(dev=CPU):
    """Valid arguments of ops/alpha_lap.lap_prep and lap_merge on `dev`: a
    band of 256 rays, 128 queued, a one-triangle table."""
    from eidola_tpu_torch.ops import alpha_lap as AL

    R, n = 256, 128
    f = lambda *s: torch.zeros(s, device=dev)
    i = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
    b = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    band = AL.Band(f(R, 3), f(R, 3), f(R), i(R), f(R), f(R), f(R), i(R),
                   b(R), b(R), i(R))
    tables = AL.AlphaTables(i(1), f(1, 3, 2), f(1, 4), i(1), i(1), f(1),
                            f(1, 1, 2, 4), i(1, 2), i(1, 2))
    lap = AL.Lap(f(n, 3), f(n, 3), f(n), f(n), i(n), b(n), b(n), i(n), i(n))
    rec2 = TB.HitRecord(i(n), f(n), f(n), f(n))
    return AL, i(n), band, tables, f(3, 8), lap, rec2


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "devices",
                                   "instances", "cpu"])
def test_alpha_lap_wrappers_check_their_arguments(fault):
    """The kernels' wrappers raise before any launch: a wrong dtype, a
    non-contiguous plane, tensors on two devices, a tri_base without its
    attr_base, and (all else right) CPU tensors, which the plain lap
    takes."""
    AL, sel, band, tables, walk, lap, rec2 = _lap_args()
    msg = {"dtype": "must be torch.int64", "contiguous": "contiguous",
           "devices": "all inputs must be on", "instances": "come together",
           "cpu": "takes CUDA tensors"}[fault]
    if fault == "dtype":
        sel = sel.to(torch.int32)
    elif fault == "contiguous":
        band = band._replace(t=torch.zeros(512)[::2])
    elif fault == "devices":
        band = band._replace(rng=band.rng.to("meta"))
    elif fault == "instances":
        tables = tables._replace(tri_base=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match=msg):
        AL.lap_prep(sel, band, tables, walk, occl=False)
    if fault != "instances":
        with pytest.raises(ValueError, match=msg):
            AL.lap_merge(sel, band, rec2, lap, occl=True)
    assert AL.LAUNCHES == 0
