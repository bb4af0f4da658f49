"""The port's multi-device path (eidola_tpu_torch/parallel/, the band and
shard contexts of ops/halo.py) on the CPU over gloo.

- The single-process banded layout against the JAX package's banded
  functions: `halo_gather` on the cases of tests/test_halo.py:20-104
  (bitwise), the band-local sort's (B, R/B) orders (bitwise) and its
  traversals (bitwise against the port's unbanded traversal; against
  JAX's banded one, hits and occlusion equal, t within 1e-4 relative,
  the drains' formulations differing as tests/test_torch_gi.py records),
  and the band-local queue march of tests/test_alpha.py:315-360 with
  EIDOLA_ALPHA_MARCH=queue in both packages (MASK and BLEND: triangles,
  t, rng words and occlusion bitwise; bitwise against the port's
  unbanded march too).
- The rank-local frame (parallel/sharding.py) in processes started by
  `run_ranks` (spawn, one torch thread each, each run under its own time
  limit): the golden config (cornell 64x64, depth 2, 4 frames) at 2 and
  4 ranks against the port's single-process frame, within the bounds the
  JAX package holds its sharded step to (tests/test_parallel.py:45-46:
  max < 5e-2, mean < 2e-3; measured on this CPU: 0, bitwise), and against
  tests/golden/cornell_64_d2_f4.npy (mean < 0.02); 8 ranks at 64x128 with
  temporal_halo 64 (halos taller than the 16-row bands) and an orbiting
  camera; spatiotemporal ReSTIR with shadow cadence 2; each rank's
  carried state holds its rows; the collective audit within
  tests/test_parallel.py:84-108's bounds.
- The row exchange, gather and reduction against slices of the whole
  plane, and the local exposure pyramid's band against the whole
  image's rows.

No JAX frame is compiled; JAX is imported only inside the tests that
hold a banded function against JAX's (the rank processes import this
module and must not import JAX).
"""
import os
import types

import numpy as np
import pytest
import torch

from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.ops import halo as TH
from eidola_tpu_torch.ops import packets as TP
from eidola_tpu_torch.parallel import exchange as X
from eidola_tpu_torch.parallel.sharding import (check_heights,
                                                make_sharded_step,
                                                orbit_cameras, padded_height,
                                                render_rank, run_ranks,
                                                shard_state)
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render.frame import init_frame_state, make_step

torch.set_num_threads(2)
CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RUN_S = 180.0            # each multi-rank run's time limit
# the JAX package's bounds on its sharded step (tests/test_parallel.py)
MAX_ERR, MEAN_ERR = 5e-2, 2e-3
GOLDEN_CFG = dict(width=64, height=64, max_depth=2, traversal_max_steps=1024,
                  env_mode="sunsky")


# ----------------------------------------------------- band context, halo

def test_band_and_shard_contexts_nest():
    assert TH.get_bands() == 1 and TH.get_shard() is None
    with TH.band_context(8):
        assert TH.get_bands() == 8
        with TH.band_context(2):
            assert TH.get_bands() == 2
        assert TH.get_bands() == 8
    assert TH.get_bands() == 1
    grp = types.SimpleNamespace(rank=1, world=4,
                                rows=lambda h: (h // 4, h // 4))
    with TH.shard_context(grp):
        assert TH.get_shard() is grp and TH.image_rows(64) == (16, 16)
    assert TH.get_shard() is None and TH.image_rows(64) == (0, 64)


def _gather_both(a, ry, rx, halo, stride=1, bands=None):
    import jax.numpy as jnp

    from eidola_tpu.ops import halo as JH

    tp, tm = TH.halo_gather(torch.from_numpy(a), torch.from_numpy(ry),
                            torch.from_numpy(rx), halo, stride, bands)
    jp, jm = JH.halo_gather(jnp.asarray(a), jnp.asarray(ry), jnp.asarray(rx),
                            halo=halo, stride=stride, bands=bands)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    return tp.numpy(), tm.numpy()


@pytest.mark.parametrize("bands", [1, 2, 4, 8])
def test_banded_halo_gather_in_halo_matches_jax(bands):
    rng = np.random.default_rng(0)
    h, w = 32, 16
    a = rng.standard_normal((h, w, 3)).astype(np.float32)
    own = np.arange(h)[:, None]
    ry = np.clip(own + rng.integers(-4, 5, (h, w)), 0, h - 1).astype(np.int64)
    rx = rng.integers(0, w, (h, w)).astype(np.int64)
    out, mask = _gather_both(a, ry, rx, 4, bands=bands)
    assert mask.all()
    np.testing.assert_array_equal(out, a[ry, rx])


def test_banded_halo_gather_clamps_out_of_halo_like_jax():
    h, w = 16, 8
    a = np.arange(h * w, dtype=np.float32).reshape(h, w)
    ry = np.zeros((h, w), np.int64)                  # all ask for row 0
    rx = np.broadcast_to(np.arange(w), (h, w)).astype(np.int64)
    out, mask = _gather_both(a, ry, rx, 2, bands=4)
    own = np.arange(h)[:, None]
    np.testing.assert_array_equal(mask, np.broadcast_to(own <= 2, (h, w)))
    np.testing.assert_array_equal(out, a[np.maximum(own - 2, 0), rx])


@pytest.mark.parametrize("bands", [1, 4])
def test_banded_halo_gather_strided_matches_jax(bands):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((32, 8)).astype(np.float32)
    own = np.arange(16)[:, None] * 2
    ry = np.clip(own + rng.integers(-3, 4, (16, 4)), 0, 31).astype(np.int64)
    rx = rng.integers(0, 8, (16, 4)).astype(np.int64)
    out, mask = _gather_both(a, ry, rx, 3, stride=2, bands=bands)
    assert mask.all()
    np.testing.assert_array_equal(out, a[ry, rx])


def test_banded_halo_gather_non_divisible_falls_back_like_jax():
    rng = np.random.default_rng(2)
    h, w = 30, 4                                     # 30 % 8 != 0
    a = rng.standard_normal((h, w)).astype(np.float32)
    ry = np.broadcast_to(np.clip(np.arange(h)[:, None] + 1, 0, h - 1),
                         (h, w)).astype(np.int64)
    rx = np.broadcast_to(np.arange(w), (h, w)).astype(np.int64)
    out, _ = _gather_both(a, ry, rx, 2, bands=8)
    np.testing.assert_array_equal(out, a[ry, rx])


def test_banded_halo_gather_tree_under_band_context():
    h, w = 16, 4
    tree = {"a": torch.arange(h * w, dtype=torch.float32).reshape(h, w),
            "b": (torch.arange(h * w * 3).reshape(h, w, 3),)}
    ry = torch.clamp(torch.arange(h)[:, None] + 3, max=h - 1).expand(h, w)
    rx = torch.zeros((h, w), dtype=torch.int64)
    flat, m1 = TH.halo_gather_tree(tree, ry, rx, halo=4)
    with TH.band_context(4):
        banded, m4 = TH.halo_gather_tree(tree, ry, rx, halo=4)
    assert torch.equal(m1, m4)
    assert torch.equal(flat["a"], banded["a"])
    assert torch.equal(flat["b"][0], banded["b"][0])


# ------------------------------------------------- band-local sort, walk

def _sort_case():
    import eidola_tpu.models.scenes as JS

    from eidola_tpu_torch.models import scenes as TS
    from test_torch_foundations import host_builders_like_jax

    js, _ = JS.stress_grid(2)
    with host_builders_like_jax():
        ts, _ = TS.stress_grid(n=2, device=CPU)
    rng = np.random.default_rng(3)
    R = 512                                          # 4 bands x 128 rays
    o = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(R) % 5, 1e8, -1.0).astype(np.float32)
    return js, ts, o, d, np.full(R, 1e-4, np.float32), tmax


def test_band_local_sort_matches_jax():
    import jax.numpy as jnp

    from eidola_tpu.ops import halo as JH
    from eidola_tpu.ops import packets as JP

    js, ts, o, d, _, tmax = _sort_case()
    dead = tmax < 0
    with JH.band_context(4):
        jperm, jinv = JP.make_ray_order(js.bvh, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(dead))
    with TH.band_context(4):
        tperm, tinv = TP.make_ray_order(ts.bvh, torch.from_numpy(o),
                                        torch.from_numpy(d),
                                        torch.from_numpy(dead))
    assert tuple(tperm.shape) == (4, 128)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    # a band does not sort past R % B != 0 or R / B off whole packets
    with TH.band_context(3):
        assert TP.make_ray_order(ts.bvh, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 torch.from_numpy(dead))[0].dim() == 1


@pytest.mark.parametrize("trav", ["xla", "pallas"])
def test_band_local_sorted_traversal_matches(trav, monkeypatch):
    import jax.numpy as jnp

    from eidola_tpu.ops import halo as JH
    from eidola_tpu.ops import packets as JP

    monkeypatch.setattr(TP, "TRAV", trav)
    js, ts, o, d, tmin, tmax = _sort_case()
    targs = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    base = TP.closest_hit_sorted(ts.bvh, *targs)
    base_occ = TP.any_hit_sorted(ts.bvh, *targs)
    with TH.band_context(4):
        rec = TP.closest_hit_sorted(ts.bvh, *targs)
        occ = TP.any_hit_sorted(ts.bvh, *targs)
    for a, b in zip(rec, base):                     # bitwise, one package
        assert torch.equal(a, b)
    assert torch.equal(occ, base_occ)
    jargs = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    with JH.band_context(4):
        jrec = JP.closest_hit_sorted(js.bvh, *jargs)
        jocc = JP.any_hit_sorted(js.bvh, *jargs)
    tri, jtri = rec.tri.numpy(), np.asarray(jrec.tri)
    hits = jtri >= 0
    assert 50 < hits.sum() < hits.size
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_allclose(rec.t.numpy()[hits], np.asarray(jrec.t)[hits],
                               rtol=1e-4)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_banded_image_traversal_is_exact():
    """Tile-major order keeps each band of h/B rows one run of whole
    packets, so the banded layout changes nothing for image tiles."""
    from eidola_tpu_torch.ops import rng as trng
    from eidola_tpu_torch.scene.camera import spawn_rays

    scene, cam = load_scene("cornell", device=CPU)
    h, w = 32, 16
    _, o, d = spawn_rays(cam, h, w, trng.seed_pixels(h, w, 7))
    args = (o, d, torch.full((h, w), 1e-4), torch.full((h, w), 1e8))
    base = TP.closest_hit_img(scene.bvh, *args)
    with TH.band_context(4):
        banded = TP.closest_hit_img(scene.bvh, *args)
    for a, b in zip(base, banded):
        assert torch.equal(a, b)


# ------------------------------------------------ band-local queue march

@pytest.mark.parametrize("mode", ["mask", "blend"])
def test_banded_queue_march_matches_jax(mode, monkeypatch):
    import jax.numpy as jnp

    import eidola_tpu.models.scenes as JSC
    import eidola_tpu.ops.rng as jrng
    import eidola_tpu.render.tracer as JT
    from eidola_tpu.ops.halo import band_context as j_band_context
    from eidola_tpu.render.config import RenderConfig as JConfig
    from eidola_tpu.scene.data import ALPHA_BLEND, ALPHA_MASK, upload_scene
    from eidola_tpu_torch import interop
    from eidola_tpu_torch.ops import rng as trng
    from eidola_tpu_torch.render import tracer as TT

    quads = [JSC.quad_tris([-2, -2, z], [2, -2, z], [2, 2, z], [-2, 2, z])
             for z in (1.0, 1.3, 1.6)]
    box = JSC.box_tris([0, 0, -1.0], [4.5, 4.5, 0.5])
    tris = np.concatenate(quads + [box])
    nq = sum(q.shape[0] for q in quads)
    leaf = ({"base_color": [1, 1, 1, 0.0], "alpha_mode": ALPHA_MASK,
             "alpha_cutoff": 0.5} if mode == "mask" else
            {"base_color": [1, 1, 1, 0.5], "alpha_mode": ALPHA_BLEND})
    js = upload_scene(tris[:, 0], tris[:, 1], tris[:, 2],
                      mat_ids=np.concatenate([np.zeros(nq, np.int32),
                                              np.ones(box.shape[0],
                                                      np.int32)]),
                      materials=[leaf, {"base_color": [0.5, 0.2, 0.2, 1.0]}])
    ts = interop.to_torch(js, CPU)
    R = 1024                   # (R / B) % 128 == 0 at B = 4: banded march
    r = np.random.default_rng(3)
    o = np.tile([0.0, 0.0, 4.0], (R, 1)).astype(np.float32)
    o[:, :2] += r.uniform(-4, 4, (R, 2)).astype(np.float32)
    d = np.tile([0.0, 0.0, -1.0], (R, 1)).astype(np.float32)
    tmin, tmax, smax = (np.full(R, v, np.float32) for v in (1e-4, 1e8, 6.0))
    kw = dict(width=8, height=16, alpha_geometry=True, alpha_hops=4,
              traversal_max_steps=512)
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "queue")
    t, j = torch.from_numpy, jnp.asarray
    rng_t = trng.seed_pixels(1, R, 5, device=CPU)[0]
    rng_j = jrng.seed_pixels(1, R, jnp.uint32(5))[0]

    def port():
        rt, rec = TT.trace_closest(cfg, ts, t(o), t(d), t(tmin), t(tmax),
                                   rng_t)
        ot, occ = TT.trace_occlusion(cfg, ts, t(o), t(d), t(tmin), t(smax),
                                     rng_t)
        return rt, rec, ot, occ

    flat = port()
    with TH.band_context(4):
        banded = port()
    for a, b in zip(flat, banded):                  # bitwise, one package
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(x, y)
    with j_band_context(4):
        rj, jrec = JT.trace_closest(jcfg, js, j(o), j(d), j(tmin), j(tmax),
                                    rng_j)
        oj, jocc = JT.trace_occlusion(jcfg, js, j(o), j(d), j(tmin), j(smax),
                                      rng_j)
    rt, rec, ot, occ = banded
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj).astype(np.int64))
    np.testing.assert_array_equal(rec.tri.numpy(), np.asarray(jrec.tri))
    np.testing.assert_array_equal(rec.t.numpy(), np.asarray(jrec.t))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_march_caps_divide_by_bands():
    """eidola_tpu/render/tracer.py:145-146, 184-185: the first capacity is
    at least 32768 / B, the floor 8192 / B but not under 2048."""
    from eidola_tpu_torch.render.tracer import _march_caps

    assert _march_caps(40960) == [32768, 8192]
    assert _march_caps(32768) == [32768, 8192]
    assert _march_caps(32768, 4) == [8192, 2048]
    assert _march_caps(1 << 21, 8) == [131072, 32768, 8192]
    assert _march_caps(262144, 8) == [16384, 4096, 2048]
    assert _march_caps(256, 4) == [256]


# ------------------------------------------------------- sharding rules

def test_non_divisible_height_raises_and_padded_height():
    cfg = RenderConfig(width=64, height=1080 // 8, max_depth=1)  # 135, 67
    eight = types.SimpleNamespace(world=8)
    with pytest.raises(ValueError, match="padded_height"):
        check_heights(cfg, 8)
    with pytest.raises(ValueError, match="padded_height"):
        make_sharded_step(cfg, eight)
    _, cam = load_scene("cornell", device=CPU)
    with pytest.raises(ValueError, match="padded_height"):
        shard_state(init_frame_state(cfg, cam), cfg, eight)
    assert padded_height(1080, 8) == 1088
    assert padded_height(1080, 8, half_res=False) == 1080
    assert padded_height(1088, 8) == 1088
    assert padded_height(1080, 2) == padded_height(1080, 4) == 1080


# ------------------------------------------- the exchange, on 4 ranks

def _plane(h, w, seed):
    """A tree of whole-image planes of three dtypes, the same on every
    rank."""
    r = np.random.default_rng(seed)
    return {"f": torch.from_numpy(r.standard_normal((h, w, 3))
                                  .astype(np.float32)),
            "i": torch.from_numpy(r.integers(0, 1 << 32, (h, w))),
            "b": torch.from_numpy(r.uniform(size=(h, w)) < 0.5)}


def _exchange_worker(group, h, w, halo):
    from eidola_tpu_torch.render import post

    row0, n = group.rows(h)
    whole = _plane(h, w, 11)
    mine = {k: v[row0:row0 + n] for k, v in whole.items()}
    ext = X.exchange_rows(group, mine, halo, "test")
    summed = X.all_reduce_sum(group, torch.tensor([float(group.rank), 1.0]),
                              "test")
    gathered = X.all_gather_rows(group, mine["f"], "test")
    lum = whole["f"][..., 0].abs() + 0.1
    with TH.shard_context(group):
        pyr = post._lum_pyramid(lum[row0:row0 + n], n, w)
    return {"ext": ext, "sum": summed, "gathered": gathered, "pyr": pyr,
            "log": list(group.log.records)}


def test_row_exchange_gather_reduce_and_pyramid_on_four_ranks():
    h, w, halo = 32, 24, 20                 # the halo spans three bands
    out = run_ranks(4, "gloo", _exchange_worker, (h, w, halo), RUN_S, 1)
    whole = _plane(h, w, 11)
    lum = whole["f"][..., 0].abs() + 0.1
    from eidola_tpu_torch.render import post

    pyr = post._lum_pyramid(lum, h, w)
    for rank, res in enumerate(out):
        rows = torch.clamp(torch.arange(rank * 8 - halo, rank * 8 + 8 + halo),
                           0, h - 1)
        for k, v in whole.items():
            assert torch.equal(res["ext"][k], v[rows]), (rank, k)
        assert res["sum"].tolist() == [6.0, 4.0]
        assert torch.equal(res["gathered"], whole["f"])
        for a, b in zip(res["pyr"], pyr):   # bitwise, level by level
            assert torch.equal(a, b[rank * 8:rank * 8 + 8])
        kinds = [k for k, _, _ in res["log"]]
        assert kinds[:3] == ["collective-permute", "all-reduce",
                             "all-gather"] and kinds[3:] == ["all-gather"]
        # the payload: the other ranks' rows received, 24 pixels of
        # 12 + 8 + 1 bytes each
        others = {int(x) for x in rows if x // 8 != rank}
        assert res["log"][0][1] == len(others) * w * (12 + 8 + 1)


# ---------------------------------------------------- the sharded frame

def _single(job):
    """The port's single-process frames of a render_rank job."""
    cfg = job["cfg"]
    scene, cam = load_scene(job["scene"], device=CPU)
    params = default_params(device=CPU)
    tm = default_tonemap(device=CPU)._replace(
        auto_exposure=torch.tensor(job.get("auto_exposure", 0)))
    state, step, imgs = init_frame_state(cfg, cam), make_step(cfg), []
    trav, TP.TRAV = TP.TRAV, job.get("trav", TP.TRAV)
    try:
        for c in orbit_cameras(cam, job["frames"], job.get("orbit", 0.0),
                               cfg.width / cfg.height):
            state, out = step(scene, c, params, tm, state)
            imgs.append(out[job.get("output", "image")].numpy())
    finally:
        TP.TRAV = trav
    return imgs


def _ranks(world, job):
    return run_ranks(world, "gloo", render_rank, (job,), RUN_S, 1)


def _diff(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(d.max()), float(d.mean())


@pytest.mark.parametrize("world,trav", [(2, "xla"), (4, "pallas")])
def test_sharded_golden_frame(world, trav):
    job = dict(scene="cornell", cfg=RenderConfig(**GOLDEN_CFG), frames=4,
               device="cpu", output="hdr", trav=trav)
    ranks = _ranks(world, job)
    ref = _single(job)
    assert len(ranks[0]["images"]) == 4
    for got, want in zip(ranks[0]["images"], ref):
        mx, mean = _diff(got, want)
        assert mx < MAX_ERR and mean < MEAN_ERR, (mx, mean)
    gold = np.load(os.path.join(GOLDEN, "cornell_64_d2_f4.npy"))
    assert ranks[0]["images"][-1].shape == gold.shape
    assert np.abs(ranks[0]["images"][-1] - gold).mean() < 0.02
    for r in ranks:
        assert r["rows"] == {"gbuf": 64 // world, "di_resv": 64 // world,
                             "di_vis": 64 // world, "accum": 64 // world,
                             "gi_resv": 32 // world}
        assert r["images"] == [] or r["rank"] == 0


@pytest.fixture(scope="module")
def eight_ranks():
    """64x128 on 8 ranks: 16-row bands under a 64-row temporal halo, the
    camera orbiting so that reprojections cross bands."""
    job = dict(scene="cornell", cfg=RenderConfig(
        width=64, height=128, max_depth=2, env_mode="sunsky",
        traversal_max_steps=128, denoise_direct_levels=2,
        denoise_indirect_levels=2), frames=3, device="cpu", orbit=0.05)
    return job, _ranks(8, job)


def test_eight_ranks_halo_taller_than_band(eight_ranks):
    job, ranks = eight_ranks
    assert job["cfg"].temporal_halo > job["cfg"].height // 8
    for got, want in zip(ranks[0]["images"], _single(job)):
        mx, mean = _diff(got, want)
        assert mx < MAX_ERR and mean < MEAN_ERR, (mx, mean)


def test_each_rank_carries_its_rows(eight_ranks):
    _, ranks = eight_ranks
    assert [r["rank"] for r in ranks] == list(range(8))
    for r in ranks:      # render_rank also ran assert_row_sharded
        assert r["rows"] == {"gbuf": 16, "di_resv": 16, "di_vis": 16,
                             "accum": 16, "gi_resv": 8}


def test_collective_audit_bounded(eight_ranks):
    """tests/test_parallel.py:84-108's bounds on one rank's frame."""
    _, ranks = eight_ranks
    for r in ranks:
        cs = r["audit"]
        assert cs["largest"] < 1.0e6, cs
        assert cs.get("all-reduce", 0) < 1.0e6, cs
        assert cs["total"] < 16.0e6, cs
        assert cs["collective-permute"] > 0 and cs["all-gather"] > 0, cs


def test_sharded_interactive_options():
    """Spatiotemporal ReSTIR (2 spatial rounds), shadow cadence 2 and the
    seeded primary walk, orbiting, on 4 ranks: spatial taps and tile ids
    across bands."""
    job = dict(scene="cornell", cfg=RenderConfig(
        width=64, height=64, max_depth=2, traversal_max_steps=1024,
        restir_mode=4, spatial_rounds=2, shadow_cadence=2,
        primary_seed=True), frames=3, device="cpu", orbit=0.05)
    ranks = _ranks(4, job)
    for got, want in zip(ranks[0]["images"], _single(job)):
        mx, mean = _diff(got, want)
        assert mx < MAX_ERR and mean < MEAN_ERR, (mx, mean)


def test_sharded_local_auto_exposure():
    """Local auto exposure: the log-average is an all_reduce (its sum
    rounds differently), the pyramid's coarse levels an all_gather."""
    job = dict(scene="cornell", cfg=RenderConfig(**GOLDEN_CFG), frames=2,
               device="cpu", auto_exposure=3)
    ranks = _ranks(2, job)
    for got, want in zip(ranks[0]["images"], _single(job)):
        mx, mean = _diff(got, want)
        assert mx < 1e-5 and mean < 1e-6, (mx, mean)
    assert ranks[0]["audit"]["all-reduce"] == 16        # sum and count
