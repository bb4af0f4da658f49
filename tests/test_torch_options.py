"""The JAX package's build and trace options in the port, against JAX.

- SBVH (`EIDOLA_SBVH`, `spatial=`): `build_sbvh_topology` and the whole
  `build_bvh_np(spatial=True)` bit for bit equal to JAX's, on the soups
  of tests/test_bvh.py's TestSBVH and on overlapping leaf cards, where
  spatial splits duplicate references; its hits through the torch walk
  and `walk_ref` against JAX's and the port's SAH BVH.
- The instanced alpha BVH (`EIDOLA_ALPHA_FLAT=0`, `EIDOLA_ALPHA_LEAF`)
  and the SBVH scene build: mini_grove's arrays bit for bit against JAX's
  under the same switches, the HitTest's hits and occlusion against JAX's
  lockstep march, and an SBVH leaf's repeated triangle still resolving
  (slot_of_tri, mesh_prim, the seeded primary's re-test).
- The alpha pre-cull (`EIDOLA_ALPHA_CULL`): `_reach_boxes` bit for bit
  against JAX's, the frontier conservative, cull on and off the same hits
  in the port and the same as JAX's with the cull on.
- Staged live-packet compaction (`EIDOLA_COMPACT=1`, `COMPACT_MIN`):
  the compacted torch walk bit for bit equal to the uncompacted one, hits
  and counts, flat and instanced, closest and any hit.
- The counters: `closest_hit_stats` / `any_hit_stats` against JAX's, and
  `RAY_LEDGER` (`EIDOLA_COUNT_RAYS`) per door against JAX's ledger.
- `EIDOLA_DI_SHADOW=sorted`, `EIDOLA_LEAF`, `EIDOLA_OCT=0`, `EIDOLA_CULL_K`
  and `EIDOLA_NO_NATIVE` change the port as they change JAX.

Tolerances: builds, scene arrays, reach, counts and the ledger bitwise;
traversal as tests/test_torch_bvh.py (hit masks equal, winners equal on
>= 0.999 of hits, t within 1e-4 relative against JAX's cols drain; the
port against itself bitwise); the sorted-shadow frame as
tests/test_torch_frame.py (image mean abs 2e-3, visibility on >= 0.99).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.models.scenes as JS
import eidola_tpu.ops.bvh as JB
import eidola_tpu.ops.bvh_build as JBB
import eidola_tpu.ops.bvh_instanced as JI
import eidola_tpu.ops.packets as JPK
import eidola_tpu.ops.rng as jrng
import eidola_tpu.render.tracer as JT
from eidola_tpu.render.config import RenderConfig as JConfig
from eidola_tpu_torch import interop
from eidola_tpu_torch import native as t_native
from eidola_tpu_torch.models import scenes as TS
from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import bvh_build as TBB
from eidola_tpu_torch.ops import bvh_instanced as TI
from eidola_tpu_torch.ops import bvh_walk as TW
from eidola_tpu_torch.ops import packets as TPK
from eidola_tpu_torch.ops import rng as trng
from eidola_tpu_torch.render import tracer as TT
from eidola_tpu_torch.render.config import RenderConfig
from eidola_tpu_torch.scene import data as TD
from test_torch_foundations import jax_native_off, same_host_builders
from test_torch_instanced import INSTANCES, MESHES, _compare_tree

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_tris(n, seed):
    """tests/test_bvh.py's soup."""
    r = np.random.default_rng(seed)
    base = r.uniform(-4.0, 4.0, size=(n, 1, 3))
    tris = (base + r.uniform(-0.5, 0.5, size=(n, 3, 3))).astype(np.float32)
    return tris[:, 0], tris[:, 1], tris[:, 2]


def _random_rays(n, seed, spread=6.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _leaf_cards(seed=1):
    """Foliage: the leaf cards of three of the scenes' procedural tree
    canopies (models/scenes._tree_mesh, 256 randomly oriented quads each)
    3 units apart, so the canopies' boxes overlap and spatial splits
    duplicate references."""
    tree = TS._tree_mesh(np.random.default_rng(seed), 256)
    leaf = tree["mat_ids"] == 4
    return tuple(np.concatenate([tree[k][leaf] + np.float32([3.0 * i, 0, 0])
                                 for i in range(3)]).astype(np.float32)
                 for k in ("v0", "v1", "v2"))


SOUPS = {"random_600": lambda: _random_tris(600, 31),
         "random_400": lambda: _random_tris(400, 33),
         "random_300": lambda: _random_tris(300, 35),
         "leaf_cards": _leaf_cards}


@pytest.mark.parametrize("soup", sorted(SOUPS))
def test_sbvh_topology_bitwise(soup):
    v0, v1, v2 = SOUPS[soup]()
    for leaf in (8, 64):
        want = JBB.build_sbvh_topology(v0, v1, v2, leaf)
        got = TBB.build_sbvh_topology(v0, v1, v2, leaf)
        for k, (a, b) in enumerate(zip(got[:4], want[:4])):
            np.testing.assert_array_equal(a, b, err_msg=f"{soup} field {k}")
            assert a.dtype == b.dtype
        assert len(got[4]) == len(want[4])
        for a, b in zip(got[4], want[4]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    refs = sum(x.size for x in got[4] if x is not None)
    if soup == "leaf_cards":
        # the spatial splits really happened: references were duplicated
        assert refs > v0.shape[0]


@pytest.mark.parametrize("soup", ["random_600", "leaf_cards"])
def test_build_bvh_spatial_bitwise(soup, monkeypatch):
    v0, v1, v2 = SOUPS[soup]()
    want = JB.build_bvh(v0, v1, v2, leaf_size=8, as_numpy=True, spatial=True)
    got = TB.build_bvh_np(v0, v1, v2, 8, spatial=True)
    for k in ("walk", "leaf_blocks", "prim_id", "n_tris", "walk_oct",
              "slot_of_tri", "cull_boxes"):
        _compare_tree(got[k], getattr(want, k), k)
    # the module switch is the default, read at each build
    monkeypatch.setattr(TB, "SBVH", True)
    again = TB.build_bvh_np(v0, v1, v2, 8)
    np.testing.assert_array_equal(again["walk"].view(np.int32),
                                  got["walk"].view(np.int32))
    occupied = got["prim_id"] >= 0
    if soup == "leaf_cards":
        assert occupied.sum() > v0.shape[0]
    # every slot_of_tri names a slot holding that triangle
    ids = np.nonzero(got["slot_of_tri"] >= 0)[0]
    np.testing.assert_array_equal(got["prim_id"][got["slot_of_tri"][ids]],
                                  ids)


def _hits(bvh, o, d, tmin, tmax):
    """Closest and any hits through the torch walk and walk_ref."""
    t = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    return {"torch": (TB.closest_hit(bvh, *t), TB.any_hit(bvh, *t)),
            "walk_ref": (TW.closest_hit_walk(bvh, *t),
                         TW.any_hit_walk(bvh, *t))}


@pytest.mark.parametrize("soup", ["random_600", "leaf_cards"])
def test_sbvh_hits_match_jax_and_sah(soup, monkeypatch):
    same_host_builders(monkeypatch)
    v0, v1, v2 = SOUPS[soup]()
    n = 1024
    o, d = _random_rays(n, 32)
    if soup == "leaf_cards":               # aim at the canopies
        tgt = np.random.default_rng(33).uniform([-1.5, 1.2, -1.5],
                                                [7.5, 3.8, 1.5], (n, 3))
        d = (tgt - o).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.where(np.arange(n) % 3, 1e9, 3.0).astype(np.float32)
    jb = JB.build_bvh(v0, v1, v2, leaf_size=8, spatial=True)
    jargs = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    jr = JB.closest_hit(jb, *jargs)
    jo = np.asarray(JB.any_hit(jb, *jargs))
    jtri, jt = np.asarray(jr.tri), np.asarray(jr.t)
    hits = jtri >= 0
    assert 0.1 < hits.mean() < 0.95 and 0 < jo.sum() < n
    sbvh = TB.build_bvh(v0, v1, v2, device=CPU, leaf_size=8, spatial=True)
    sah = TB.build_bvh(v0, v1, v2, device=CPU, leaf_size=8, spatial=False)
    got = {("sbvh", k): v for k, v in _hits(sbvh, o, d, tmin, tmax).items()}
    got.update({("sah", k): v for k, v in
                _hits(sah, o, d, tmin, tmax).items()})
    for name, (rec, occ) in got.items():
        tri = rec.tri.numpy()
        np.testing.assert_array_equal(tri >= 0, hits, err_msg=str(name))
        assert (tri[hits] == jtri[hits]).mean() >= 0.999, name
        np.testing.assert_allclose(rec.t.numpy()[hits], jt[hits], rtol=1e-4)
        np.testing.assert_array_equal(occ.numpy(), jo, err_msg=str(name))
    # SBVH against SAH in each of the port's walks: the same triangles
    for walk in ("torch", "walk_ref"):
        a, b = got[("sbvh", walk)][0], got[("sah", walk)][0]
        assert (a.tri == b.tri).numpy().mean() >= 0.999, walk
        np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=1e-5)


def _alpha_rays(n=256, seed=4):
    """tests/test_torch_alpha.py's rays at mini_grove's trees."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([6 * np.sin(ang), rng.uniform(0.5, 4, n), 6 * np.cos(ang)],
                 -1).astype(np.float32)
    tgt = (np.asarray([0.0, 1.8, 0.0]) + rng.uniform(-3.0, 3.0, (n, 3))
           ).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _grove(monkeypatch, option):
    """mini_grove built by both packages under one option ("default":
    none)."""
    same_host_builders(monkeypatch)
    if option == "alpha_instanced":
        monkeypatch.setenv("EIDOLA_ALPHA_FLAT", "0")
    elif option == "alpha_instanced_leaf4":
        monkeypatch.setenv("EIDOLA_ALPHA_FLAT", "0")
        monkeypatch.setenv("EIDOLA_ALPHA_LEAF", "4")
    elif option == "flat_leaf4":
        monkeypatch.setenv("EIDOLA_ALPHA_LEAF", "4")
    elif option == "sbvh":
        monkeypatch.setattr(JB, "SBVH", True)
        monkeypatch.setattr(TB, "SBVH", True)
    js, _ = JS.mini_grove()
    ts, _ = TS.mini_grove(device=CPU)
    return js, ts


GROVE = ["alpha_instanced", "alpha_instanced_leaf4", "flat_leaf4", "sbvh"]


@pytest.mark.parametrize("option", GROVE)
def test_grove_scene_bitwise(option, monkeypatch):
    js, ts = _grove(monkeypatch, option)
    _compare_tree(interop.to_numpy(ts), js)
    instanced = option.startswith("alpha_instanced")
    assert isinstance(ts.bvh_alpha, TI.InstancedBVH) == instanced
    assert ts.bvh_alpha.leaf_size == (4 if option.endswith("leaf4") else 8)
    # each triangle belongs to exactly one half, by its material
    op = ts.bvh.slot_of_tri >= 0
    al = ts.bvh_alpha.slot_of_tri >= 0
    assert bool((op ^ al).all()) and al.any()


def _cfgs(**kw):
    return (RenderConfig(width=8, height=8, alpha_geometry=True, **kw),
            JConfig(width=8, height=8, alpha_geometry=True, **kw))


def _trace_both(js, ts, o, d, n):
    """The HitTest's closest hits and occlusion in both packages."""
    cfg, jcfg = _cfgs(traversal_max_steps=2048)
    tmin, tmax = np.full(n, 1e-4, np.float32), np.full(n, 1e8, np.float32)
    smax = np.where(np.arange(n) % 2, 1e8, 5.0).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a)
    rng_t = trng.seed_pixels(1, n, 3, device=CPU)[0]
    rng_j = jrng.seed_pixels(1, n, jnp.uint32(3))[0]
    _, rec = TT.trace_closest(cfg, ts, t(o), t(d), t(tmin), t(tmax), rng_t)
    _, jrec = JT.trace_closest(jcfg, js, j(o), j(d), j(tmin), j(tmax), rng_j)
    _, occ = TT.trace_occlusion(cfg, ts, t(o), t(d), t(tmin), t(smax), rng_t)
    _, jocc = JT.trace_occlusion(jcfg, js, j(o), j(d), j(tmin), j(smax),
                                 rng_j)
    return rec, jrec, occ.numpy(), np.asarray(jocc)


def _held(rec, jrec, occ, jocc):
    jtri, ttri = np.asarray(jrec.tri), rec.tri.numpy()
    hits = jtri >= 0
    np.testing.assert_array_equal(ttri >= 0, hits)
    assert (ttri == jtri).mean() >= 0.999
    np.testing.assert_allclose(rec.t.numpy()[hits], np.asarray(jrec.t)[hits],
                               rtol=1e-4)
    np.testing.assert_array_equal(occ, jocc)
    assert 0 < int(occ.sum()) < occ.size


@pytest.mark.parametrize("option", ["alpha_instanced", "sbvh"])
def test_grove_hittest_matches_jax(option, monkeypatch):
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "lockstep")
    js, ts = _grove(monkeypatch, option)
    o, d = _alpha_rays()
    _held(*_trace_both(js, ts, o, d, o.shape[0]))


def _diagonal_rays(seed=7):
    """Rays from a ring around mini_grove at the centres of the eight
    texels on each leaf card's diagonal (the edge its two triangles share;
    the checkerboard's alpha is 1 there): the aim points rebuilt as
    models/scenes.mini_grove draws its trees and instances."""
    rng = np.random.default_rng(5)
    trees = [TS._tree_mesh(rng, n_leaves=24) for _ in range(2)]
    aims = []
    for k in range(4):
        shift = np.float32([-3.0 + 2.0 * k, 0.0, rng.uniform(-2, 2)])
        tree = trees[k % 2]
        leaf = tree["mat_ids"] == 4
        p00, p11 = tree["v0"][leaf][:24], tree["v2"][leaf][:24]
        for s in np.tile((np.arange(8) + 0.5) / 8, 5):
            aims.append(p00 + s * (p11 - p00) + shift)
    aim = np.concatenate(aims).astype(np.float32)
    n = aim.shape[0]
    r = np.random.default_rng(seed)
    ang = r.uniform(0, 2 * np.pi, n)
    o = np.stack([6 * np.sin(ang), r.uniform(0.5, 4, n), 6 * np.cos(ang)],
                 -1).astype(np.float32)
    d = aim - o
    t_aim = np.linalg.norm(d, axis=-1)
    return o, (d / t_aim[:, None]).astype(np.float32), t_aim


def _fell_through(flat, inst, t_aim):
    """Rays whose hit differs between the flat and the instanced alpha BVH
    at another depth; asserts that each one met the card at its aim point
    in one space and passed through it in the other."""
    (ftri, ft), (itri, it) = flat, inst
    other = ((ftri >= 0) != (itri >= 0)) | (
        (ftri >= 0) & (itri >= 0)
        & (np.abs(ft - it) > 1e-4 * np.maximum(ft, it)))
    near, far = np.minimum(ft, it)[other], np.maximum(ft, it)[other]
    np.testing.assert_allclose(near, t_aim[other], rtol=1e-3)
    assert (far > t_aim[other] * (1 + 1e-3)).all()
    return int(other.sum())


def test_alpha_instanced_falls_through_like_jax(monkeypatch):
    """The instanced alpha BVH (EIDOLA_ALPHA_FLAT=0) tests a card in
    object space, the flat one in world space, and f32 Moller-Trumbore
    leaves a crack along the edge two triangles share that falls
    elsewhere in each space: rays at the diagonals of mini_grove's leaf
    cards pass through the card under one BVH and hit it under the
    other.  The JAX package's HitTest does the same (on more of these
    rays than the port's: its drain is another f32 formulation), so an
    ALPHA_FLAT=0 frame differs from the flat one on such pixels in both
    packages."""
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "lockstep")
    o, d, t_aim = _diagonal_rays()
    n = o.shape[0]
    cfg, jcfg = _cfgs(traversal_max_steps=2048)
    tmin, tmax = np.full(n, 1e-4, np.float32), np.full(n, 1e8, np.float32)
    rng_t = trng.seed_pixels(1, n, 3, device=CPU)[0]
    rng_j = jrng.seed_pixels(1, n, jnp.uint32(3))[0]
    hits = {}
    for option in ("default", "alpha_instanced"):
        js, ts = _grove(monkeypatch, option)
        _, rec = TT.trace_closest(cfg, ts, *(torch.from_numpy(a) for a in
                                             (o, d, tmin, tmax)), rng_t)
        _, jrec = JT.trace_closest(jcfg, js, *(jnp.asarray(a) for a in
                                               (o, d, tmin, tmax)), rng_j)
        hits[option] = ((rec.tri.numpy(), rec.t.numpy()),
                        (np.asarray(jrec.tri), np.asarray(jrec.t)))
    (port_f, jax_f), (port_i, jax_i) = hits["default"], hits["alpha_instanced"]
    # the aim points lie on the cards: the rays that no nearer leaf
    # blocks hit there
    assert (np.abs(port_f[1] - t_aim) <= 1e-3 * t_aim).mean() > 0.5
    n_port = _fell_through(port_f, port_i, t_aim)
    n_jax = _fell_through(jax_f, jax_i, t_aim)
    assert 0 < n_port < 0.05 * n and 0 < n_jax < 0.2 * n


def _canopy_scene(monkeypatch):
    """The leaf cards as one opaque mesh under two instances, built by
    both packages under SBVH: the instanced BLAS repeats triangles."""
    from eidola_tpu.scene.data import upload_scene_instanced as j_upload

    same_host_builders(monkeypatch)
    monkeypatch.setattr(JB, "SBVH", True)
    monkeypatch.setattr(TB, "SBVH", True)
    v0, v1, v2 = _leaf_cards()
    mesh = {"v0": v0, "v1": v1, "v2": v2,
            "mat_ids": np.zeros(v0.shape[0], np.int32)}
    moved = np.eye(4)
    moved[:3, 3] = [0.5, 0.0, 4.0]
    instances = [(0, np.eye(4)), (0, moved)]
    mats = [{"base_color": [0.3, 0.6, 0.2, 1.0]}]
    js = j_upload([mesh], instances, materials=mats)
    ts = TD.upload_scene_instanced([mesh], instances, device=CPU,
                                   materials=mats)
    return js, ts


def test_sbvh_repeated_triangles_resolve(monkeypatch):
    """An SBVH leaf may repeat a triangle of another leaf: every slot of a
    repeated triangle holds its vertices, slot_of_tri and mesh_prim name
    it, and the seeded primary's re-test (primary_seed) finds it, as in
    JAX; on the leaf cards under two instances and on mini_grove."""
    from eidola_tpu_torch.render.direct import _seed_tmax
    from test_torch_alpha import _j_seed_tmax

    js, ts = _canopy_scene(monkeypatch)
    _compare_tree(interop.to_numpy(ts), js)
    bvh = ts.bvh
    occ = bvh.mesh_prim >= 0
    assert int(occ.sum()) > int(torch.unique(bvh.mesh_prim[occ]).numel())
    ids = torch.nonzero(bvh.slot_of_tri >= 0)[:, 0]
    assert ids.numel() == 2 * 3 * 512
    slot = bvh.slot_of_tri[ids]
    base = bvh.inst_tri_base[bvh.inst_of_tri[ids]]
    assert torch.equal(bvh.mesh_prim[slot] + base, ids)
    rows = bvh.leaf_blocks.reshape(-1, 12)
    first = torch.full((int(bvh.mesh_prim.max()) + 1,), -1, dtype=torch.long)
    first[bvh.mesh_prim[occ]] = torch.nonzero(occ)[:, 0]
    assert torch.equal(rows[occ], rows[first[bvh.mesh_prim[occ]]])
    # rays at the canopies: last frame's hits re-tested through the slots
    n = 512
    rng = np.random.default_rng(6)
    o = rng.uniform([-4, 0, 8], [10, 6, 10], (n, 3)).astype(np.float32)
    tgt = rng.uniform([-1.5, 1.2, -1.5], [7.5, 3.8, 5.5], (n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tn, tx = torch.full((n,), 1e-4), torch.full((n,), 1e8)
    for scene, jscene, shift in ((ts, js, 0.0), _grove(monkeypatch, "sbvh")[
            ::-1] + (0.01,)):
        if scene is not ts:
            o, d = _alpha_rays(n, 6)
            to, td = torch.from_numpy(o), torch.from_numpy(d)
        prev = TT.closest_hit_img(scene.bvh, (to + shift)[None], td[None],
                                  tn[None], tx[None])
        if scene.bvh_alpha is not None:
            prev = TT._merge_closest(prev, type(prev)(*[a[None] for a in
                                                        TB.closest_hit(
                scene.bvh_alpha, to + shift, td, tn, tx)]))
        pt = prev.tri.reshape(n)
        cfg, _ = _cfgs(primary_seed=True)
        t = _seed_tmax(cfg, scene, to, td, pt).numpy()
        j = _j_seed_tmax(jscene, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(pt))
        np.testing.assert_array_equal(t == 1e8, j == 1e8)
        np.testing.assert_allclose(t, j, rtol=1e-6)
        assert (t < 1e8).mean() > 0.1
        if shift == 0.0:
            # the same rays: the re-test finds each hit at its own t
            hit = pt >= 0
            want = prev.t.reshape(n)[hit].numpy() * (1.0 + 1e-4) + 1e-6
            # (ray_triangle against the drain's formulation: 1e-5)
            np.testing.assert_allclose(t[hit.numpy()], want, rtol=1e-5)


def _frontier_case(seed=11):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    v = [c + rng.normal(0, 0.3, (400, 3)).astype(np.float32)
         for _ in range(3)]
    o = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full(512, 1e-4, np.float32)
    tx = np.where(np.arange(512) % 4, 1e8,
                  rng.uniform(0.5, 4.0, 512)).astype(np.float32)
    tx[::9] = -1.0                                  # dead rays
    return v, o, d, tn, tx


@pytest.mark.parametrize("pairs", [1 << 24, 700])
def test_reach_boxes_bitwise_and_conservative(pairs, monkeypatch):
    """The batched reach test (one batch, and batches of 1 box at 512
    rays) against JAX's unrolled one, bit for bit; every ray with a hit is
    reached (the cover holds all geometry)."""
    monkeypatch.setattr(TT, "_REACH_PAIRS", pairs)
    v, o, d, tn, tx = _frontier_case()
    bvh = TB.build_bvh(*v, device=CPU, leaf_size=8)
    for k in (2, 8, 64):
        boxes = TBB.collect_frontier(bvh.walk.numpy(), k)
        got = TT._reach_boxes(torch.from_numpy(boxes), torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(tn),
                              torch.from_numpy(tx)).numpy()
        want = np.asarray(JT._reach_boxes(jnp.asarray(boxes),
                                          jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(tn), jnp.asarray(tx)))
        np.testing.assert_array_equal(got, want, err_msg=f"K={k}")
        # image-shaped rays and scalar bounds as the tracer passes them
        img = TT._reach_boxes(torch.from_numpy(boxes),
                              torch.from_numpy(o).reshape(16, 32, 3),
                              torch.from_numpy(d).reshape(16, 32, 3), 1e-4,
                              torch.from_numpy(tx).reshape(16, 32))
        np.testing.assert_array_equal(img.reshape(-1).numpy(), want)
        rec = TB.closest_hit(bvh, *(torch.from_numpy(a)
                                    for a in (o, d, tn, tx)))
        hit = rec.tri.numpy() >= 0
        assert hit.any() and got[hit].all(), f"false cull at K={k}"
        assert not got.all()


def test_alpha_cull_is_result_invisible(monkeypatch):
    """EIDOLA_ALPHA_CULL on mini_grove (lockstep march): the port's hits
    and occlusion with and without the cull equal, and with it equal to
    JAX's with it; the cull kills rays (its reach is not all True)."""
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "lockstep")
    js, ts = _grove(monkeypatch, "default")
    o, d = _alpha_rays(256, 9)
    o[::2, 1] += 6.0               # half the rays pass high over the trees
    runs = {}
    orig = TT._reach_boxes
    for cull in ("0", "1"):
        monkeypatch.setenv("EIDOLA_ALPHA_CULL", cull)
        reach = []
        monkeypatch.setattr(TT, "_reach_boxes",
                            lambda *a: reach.append(orig(*a)) or reach[-1])
        runs[cull] = _trace_both(js, ts, o, d, o.shape[0])
        assert len(reach) == (2 if cull == "1" else 0)
        if reach:
            assert not bool(reach[0].all()) and bool(reach[0].any())
    (r0, _, o0, _), (r1, jr1, o1, jo1) = runs["0"], runs["1"]
    assert torch.equal(r0.tri, r1.tri) and torch.equal(r0.t, r1.t)
    np.testing.assert_array_equal(o0, o1)
    _held(r1, jr1, o1, jo1)
    # under a band context (two bands of one packet): the same hits
    from eidola_tpu_torch.ops.halo import band_context

    cfg, _ = _cfgs(traversal_max_steps=2048)
    n = o.shape[0]
    t = lambda a: torch.from_numpy(a)
    rng_t = trng.seed_pixels(1, n, 3, device=CPU)[0]
    with band_context(2):
        _, rb = TT.trace_closest(cfg, ts, t(o), t(d), torch.full((n,), 1e-4),
                                 torch.full((n,), 1e8), rng_t)
        _, ob = TT.trace_occlusion(cfg, ts, t(o), t(d), torch.full((n,), 1e-4),
                                   t(np.where(np.arange(n) % 2, 1e8, 5.0)
                                     .astype(np.float32)), rng_t)
    assert torch.equal(rb.tri, r1.tri) and torch.equal(rb.t, r1.t)
    np.testing.assert_array_equal(ob.numpy(), o1)


def _compaction_rays(n_pkt=64, seed=21):
    """Packets of very different lengths: three in four dead, the rest
    half short (t_max 1.5) and half long, so the live count falls in
    steps."""
    o, d = _random_rays(n_pkt * 128, seed, spread=7.0)
    pk = np.arange(n_pkt * 128) // 128
    tmax = np.where(pk % 4, -1.0, np.where(pk % 8, 1e9, 1.5))
    return o, d, np.full(o.shape[0], 1e-4, np.float32), \
        tmax.astype(np.float32)


def _compacted_pair(monkeypatch, fn, *args, **kw):
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("EIDOLA_COMPACT", mode)
        monkeypatch.setattr(TB, "COMPACT_MIN", 2)
        out[mode] = fn(*args, **kw)
    return out["0"], out["1"]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_compaction_bitwise(kind, any_hit, monkeypatch):
    o, d, tn, tx = (torch.from_numpy(a) for a in _compaction_rays())
    if kind == "flat":
        bvh = TB.build_bvh(*_random_tris(600, 31), device=CPU, leaf_size=8)
        inst = None
    else:
        bvh = TI.build_instanced_bvh(MESHES, INSTANCES, device=CPU,
                                     leaf_size=8)
        inst = bvh.inst_index
    fn = TB.any_hit_stats if any_hit else TB.closest_hit_stats
    (r0, s0), (r1, s1) = _compacted_pair(monkeypatch, fn, bvh, o, d, tn, tx,
                                         inst=inst)
    if any_hit:
        assert torch.equal(r0, r1) and 0 < int(r0.sum()) < r0.numel()
    else:
        for a, b in zip(r0, r1):
            assert torch.equal(a, b)
        assert (r0.tri >= 0).any()
    for k in ("events", "steps", "rounds", "live_steps", "chunks"):
        assert s0[k] == s1[k], k
    # the stages really ran: 64 -> 16 -> 4 -> 2 packets, the first
    # compaction before the walk ended
    assert [c for c, _ in s1["stages"]][:2] == [64, 16]
    assert s1["stages"][1][1] < s1["steps"]
    assert s0["stages"] == [(64, 0)]
    assert s0["live_steps"] < s0["steps"] * 64


def test_compaction_auto_follows_the_device(monkeypatch):
    """EIDOLA_COMPACT=1 stages at JAX's capacities; "auto" (the default)
    and "0" walk in one stage, on the CPU as on the card (the port's
    auto: off until compaction wins on the card)."""
    monkeypatch.delenv("EIDOLA_COMPACT", raising=False)
    assert TB.COMPACT_MIN == 512
    assert TB._compact_caps(16200) == [16200]
    monkeypatch.setenv("EIDOLA_COMPACT", "1")
    assert TB._compact_caps(16200) == [16200, 4050, 1013, 512]
    assert TB._compact_caps(600) == [600, 512]
    assert TB._compact_caps(300) == [300]
    for mode in ("0", "auto"):
        monkeypatch.setenv("EIDOLA_COMPACT", mode)
        assert TB._compact_caps(16200) == [16200]


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_match_jax(any_hit):
    v0, v1, v2 = _random_tris(600, 31)
    o, d, tn, tx = _compaction_rays(16, 23)
    jb = JB.build_bvh(v0, v1, v2, leaf_size=8)
    tb = interop.to_torch(jb, CPU)
    jfn = JB.any_hit_stats if any_hit else JB.closest_hit_stats
    tfn = TB.any_hit_stats if any_hit else TB.closest_hit_stats
    jr, js = jfn(jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn),
                 jnp.asarray(tx))
    tr, ts = tfn(tb, *(torch.from_numpy(a) for a in (o, d, tn, tx)))
    for k in ("events", "steps", "rounds", "live_steps"):
        assert ts[k] == int(js[k]), k
    # the plain walk does not count live packets (three launches a step)
    plain = TB._traverse(tb, *(torch.from_numpy(a) for a in (o, d, tn, tx)),
                         any_hit, 100_000)[1]
    assert "live_steps" not in plain and plain["steps"] == ts["steps"]
    if any_hit:
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    else:
        np.testing.assert_array_equal(tr.tri.numpy() >= 0,
                                      np.asarray(jr.tri) >= 0)


def test_ray_ledger_matches_jax(monkeypatch):
    """EIDOLA_COUNT_RAYS=1 on cornell 32x32: the live rays each front door
    counts, in the port's RAY_LEDGER and JAX's, door call by door call."""
    monkeypatch.setenv("EIDOLA_COUNT_RAYS", "1")
    js, jcam = JS.cornell_box()
    ts = interop.to_torch(js, CPU)
    rng = np.random.default_rng(3)
    o = np.tile(np.asarray(jcam.pos, np.float32), (32, 32, 1))
    d = rng.normal(size=(32, 32, 3)).astype(np.float32)
    d[..., 2] = -np.abs(d[..., 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full((32, 32), 1e-4, np.float32)
    tx = np.where(rng.uniform(size=(32, 32)) < 0.3, -1.0, 1e8
                  ).astype(np.float32)
    sx = np.where(rng.uniform(size=(32, 32)) < 0.5, 2.0, -1.0
                  ).astype(np.float32)
    doors = (("closest_hit_img", tx), ("any_hit_img", sx),
             ("closest_hit_sorted", tx), ("any_hit_sorted", sx))
    JPK.RAY_LEDGER.clear()
    TPK.RAY_LEDGER.clear()
    TPK.RAY_DOORS.clear()
    for door, t_max in doors:
        getattr(JPK, door)(js.bvh, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tn), jnp.asarray(t_max))
        getattr(TPK, door)(ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tn), torch.from_numpy(t_max))
    assert TPK.RAY_LEDGER == [float(x) for x in JPK.RAY_LEDGER]
    assert TPK.RAY_DOORS == [d for d, _ in doors]
    assert TPK.RAY_LEDGER[0] == float((tx >= tn).sum()) > 0
    # off by default: no entry, no sync
    monkeypatch.delenv("EIDOLA_COUNT_RAYS")
    TPK.closest_hit_sorted(ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tn), torch.from_numpy(tx))
    assert len(TPK.RAY_LEDGER) == 4


def test_di_shadow_sorted_frame(monkeypatch):
    """EIDOLA_DI_SHADOW=sorted traces the DI winners' shadow rays as a
    sorted wavefront (coherent=False, as the JAX direct stage does): the
    cornell 32x32 DI frame of tests/test_torch_frame.py within that file's
    tolerance of the tiled one, and each sorted shadow trace's occlusion
    bitwise JAX's trace_occlusion(coherent=False) on the same inputs."""
    from eidola_tpu.render import config as jcfg
    from eidola_tpu_torch.render import direct
    from test_torch_frame import CFG, _frames_port

    js, jcam = JS.cornell_box()
    seen, calls = [], []
    orig = direct.trace_occlusion

    def watched(*a, **kw):
        out = orig(*a, **kw)
        seen.append(kw["coherent"])
        calls.append((a[2:], out[1]))
        return out
    monkeypatch.setattr(direct, "trace_occlusion", watched)
    runs = {}
    for mode in ("tiled", "sorted"):
        monkeypatch.setenv("EIDOLA_DI_SHADOW", mode)
        seen.clear()
        calls.clear()
        runs[mode] = _frames_port(js, jcam)
        assert seen and all(c == (mode == "tiled") for c in seen)
    assert CFG["indirect_enabled"] is False
    for p, q in zip(runs["tiled"], runs["sorted"]):
        assert np.abs(p["image"] - q["image"]).mean() <= 2e-3
        assert (p["vis"] == q["vis"]).mean() >= 0.99
    cfg = jcfg.RenderConfig(**CFG)
    for args, occ in calls:
        o, d, tn, tx, rng = (jnp.asarray(a.numpy()) if torch.is_tensor(a)
                             else a for a in args)
        _, jocc = JT.trace_occlusion(cfg, js, o, d, tn, tx, rng,
                                     coherent=False)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        assert 0 < int(occ.sum()) < occ.numel()


def _constants(pkg: str, env: dict) -> list:
    code = {"port": "from eidola_tpu_torch.ops import bvh as b; "
                    "print(b.LEAF_SIZE_CUDA, b.OCT, b.SBVH, b.CULL_K)",
            "jax": "from eidola_tpu.ops import bvh as b; "
                   "print(b.LEAF_SIZE_TPU, b.OCT_ORDER, b.SBVH, b.CULL_K)"}
    out = subprocess.run([sys.executable, "-c", code[pkg]], cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", **env},
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_import_switches_match_jax():
    """EIDOLA_LEAF, EIDOLA_OCT, EIDOLA_SBVH and EIDOLA_CULL_K, read at
    import in both packages, give the same constants."""
    for env in ({}, {"EIDOLA_LEAF": "32", "EIDOLA_OCT": "0",
                     "EIDOLA_SBVH": "1", "EIDOLA_CULL_K": "16"}):
        assert _constants("port", env) == _constants("jax", env), env


def test_octant_off_builds_like_jax(monkeypatch):
    same_host_builders(monkeypatch)
    v0, v1, v2 = _random_tris(300, 35)
    want = JB.build_bvh(v0, v1, v2, leaf_size=8, as_numpy=True,
                        octant=False)
    got = TB.build_bvh_np(v0, v1, v2, 8, octant=False)
    assert want.walk_oct is None and got["walk_oct"] is None
    _compare_tree(got["walk"], want.walk, "walk")
    # EIDOLA_OCT=0 (the module switch): flat and instanced builds
    monkeypatch.setattr(TB, "OCT", False)
    monkeypatch.setattr(JB, "OCT_ORDER", False)
    assert TB.build_bvh(v0, v1, v2, device=CPU, leaf_size=8).walk_oct is None
    ti = TI.build_instanced_bvh(MESHES, INSTANCES, device=CPU, leaf_size=8)
    ji = JI.build_instanced_bvh(MESHES, INSTANCES, leaf_size=8)
    assert ti.walk_oct is None and ji.walk_oct is None
    _compare_tree(interop.to_numpy(ti), ji)
    # the walks take a table without octants
    o, d, tn, tx = (torch.from_numpy(a) for a in _compaction_rays(8, 5))
    occ = TPK.any_hit(ti, o, d, tn, tx)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        JI.any_hit_instanced(ji, *(jnp.asarray(a.numpy())
                                   for a in (o, d, tn, tx)))))


def test_no_native_builds_in_numpy(monkeypatch):
    """EIDOLA_NO_NATIVE: the port's native library is off (read at each
    call), so its builds are the numpy ones, bit for bit JAX's with its
    library off."""
    v0, v1, v2 = _random_tris(600, 31)
    monkeypatch.setenv("EIDOLA_NO_NATIVE", "1")
    assert t_native.get_lib() is None
    tb_min = np.minimum(np.minimum(v0, v1), v2)
    tb_max = np.maximum(np.maximum(v0, v1), v2)
    assert t_native.build_bvh_native(tb_min, tb_max, (tb_min + tb_max) / 2,
                                     8) is None
    assert t_native.build_alias_native(np.ones(4)) is None
    jax_native_off(monkeypatch)
    want = JB.build_bvh(v0, v1, v2, leaf_size=8, as_numpy=True)
    got = TB.build_bvh_np(v0, v1, v2, 8)
    for k in ("walk", "leaf_blocks", "prim_id", "slot_of_tri", "walk_oct"):
        _compare_tree(got[k], getattr(want, k), k)
