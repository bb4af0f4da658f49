"""The JAX package's build and trace options in the port, against JAX.

- The default build on the soups of tests/test_bvh.py and on
  overlapping leaf cards: `build_sah_topology` and the whole
  `build_bvh_np` bit for bit equal to JAX's, and its hits through the
  torch walk and `walk_ref` against JAX's.
- The instanced alpha BVH (`EIDOLA_ALPHA_FLAT=0`, `EIDOLA_ALPHA_LEAF`):
  mini_grove's arrays bit for bit against JAX's under the same
  switches, and the HitTest's hits and occlusion against JAX's lockstep
  march.
- The torch walk on packets that retire in steps, flat and instanced,
  closest and any hit, against JAX's walk.
- The counters: `closest_hit_stats` / `any_hit_stats` against JAX's, and
  `RAY_LEDGER` (`EIDOLA_COUNT_RAYS`) per door against JAX's ledger.
- `EIDOLA_LEAF`, `EIDOLA_OCT=0` and `EIDOLA_NO_NATIVE` change the port as
  they change JAX.

Tolerances: builds, scene arrays, counts and the ledger bitwise;
traversal as tests/test_torch_bvh.py (hit masks equal, winners equal on
>= 0.999 of hits, t within 1e-4 relative against JAX's cols drain).
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
    3 units apart, so the canopies' boxes overlap."""
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
def test_sah_topology_bitwise(soup):
    v0, v1, v2 = SOUPS[soup]()
    tb_min = np.minimum(np.minimum(v0, v1), v2)
    tb_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tb_min + tb_max) * 0.5
    for leaf in (8, 64):
        want = JBB.build_sah_topology(tb_min, tb_max, centroid, leaf)
        got = TBB.build_sah_topology(tb_min, tb_max, centroid, leaf)
        for k, (a, b) in enumerate(zip(got[:4], want[:4])):
            np.testing.assert_array_equal(a, b, err_msg=f"{soup} field {k}")
            assert a.dtype == b.dtype
        assert len(got[4]) == len(want[4])
        for a, b in zip(got[4], want[4]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    # each triangle sits in exactly one leaf
    refs = np.concatenate([x for x in got[4] if x is not None])
    np.testing.assert_array_equal(np.sort(refs), np.arange(v0.shape[0]))


@pytest.mark.parametrize("soup", sorted(SOUPS))
def test_build_bvh_bitwise(soup, monkeypatch):
    same_host_builders(monkeypatch)
    v0, v1, v2 = SOUPS[soup]()
    want = JB.build_bvh(v0, v1, v2, leaf_size=8, as_numpy=True)
    got = TB.build_bvh_np(v0, v1, v2, 8)
    for k in ("walk", "leaf_blocks", "prim_id", "n_tris", "walk_oct",
              "slot_of_tri"):
        _compare_tree(got[k], getattr(want, k), k)
    # every triangle has one slot, and slot_of_tri names it
    occupied = got["prim_id"] >= 0
    assert occupied.sum() == v0.shape[0]
    ids = np.nonzero(got["slot_of_tri"] >= 0)[0]
    assert ids.size == v0.shape[0]
    np.testing.assert_array_equal(got["prim_id"][got["slot_of_tri"][ids]],
                                  ids)


def _hits(bvh, o, d, tmin, tmax):
    """Closest and any hits through the torch walk and walk_ref."""
    t = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    return {"torch": (TB.closest_hit(bvh, *t), TB.any_hit(bvh, *t)),
            "walk_ref": (TW.closest_hit_walk(bvh, *t),
                         TW.any_hit_walk(bvh, *t))}


@pytest.mark.parametrize("soup", sorted(SOUPS))
def test_soup_hits_match_jax(soup, monkeypatch):
    same_host_builders(monkeypatch)
    v0, v1, v2 = SOUPS[soup]()
    n = 1024
    o, _ = _random_rays(n, 32)
    # aimed at the canopies, or into the random soups' box
    lo, hi = ([-1.5, 1.2, -1.5], [7.5, 3.8, 1.5]) if soup == "leaf_cards" \
        else ([-4.0] * 3, [4.0] * 3)
    d = (np.random.default_rng(33).uniform(lo, hi, (n, 3)) - o
         ).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.where(np.arange(n) % 3, 1e9, 3.0).astype(np.float32)
    jb = JB.build_bvh(v0, v1, v2, leaf_size=8)
    jargs = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    jr = JB.closest_hit(jb, *jargs)
    jo = np.asarray(JB.any_hit(jb, *jargs))
    jtri, jt = np.asarray(jr.tri), np.asarray(jr.t)
    hits = jtri >= 0
    assert 0.1 < hits.mean() < 0.95 and 0 < jo.sum() < n
    bvh = TB.build_bvh(v0, v1, v2, device=CPU, leaf_size=8)
    for walk, (rec, occ) in _hits(bvh, o, d, tmin, tmax).items():
        tri = rec.tri.numpy()
        np.testing.assert_array_equal(tri >= 0, hits, err_msg=walk)
        assert (tri[hits] == jtri[hits]).mean() >= 0.999, walk
        np.testing.assert_allclose(rec.t.numpy()[hits], jt[hits], rtol=1e-4)
        np.testing.assert_array_equal(occ.numpy(), jo, err_msg=walk)


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
    js, _ = JS.mini_grove()
    ts, _ = TS.mini_grove(device=CPU)
    return js, ts


GROVE = ["alpha_instanced", "alpha_instanced_leaf4", "flat_leaf4"]


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


@pytest.mark.parametrize("option", ["alpha_instanced"])
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


def _retiring_rays(n_pkt=64, seed=21):
    """Packets of very different lengths: three in four dead, the rest
    half short (t_max 1.5) and half long, so the live count falls in
    steps."""
    o, d = _random_rays(n_pkt * 128, seed, spread=7.0)
    pk = np.arange(n_pkt * 128) // 128
    tmax = np.where(pk % 4, -1.0, np.where(pk % 8, 1e9, 1.5))
    return o, d, np.full(o.shape[0], 1e-4, np.float32), \
        tmax.astype(np.float32)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_retiring_packets_match_jax(kind, any_hit):
    """The torch walk on packets that retire at very different steps
    against JAX's walk on the same BVH (built by JAX, carried over by
    interop) and rays."""
    o, d, tn, tx = _retiring_rays()
    if kind == "flat":
        jb = JB.build_bvh(*_random_tris(600, 31), leaf_size=8)
        jfn = JB.any_hit if any_hit else JB.closest_hit
    else:
        jb = JI.build_instanced_bvh(MESHES, INSTANCES, leaf_size=8)
        jfn = JI.any_hit_instanced if any_hit else JI.closest_hit_instanced
    tb = interop.to_torch(jb, CPU)
    inst = tb.inst_index if kind == "instanced" else None
    fn = TB.any_hit_stats if any_hit else TB.closest_hit_stats
    got, stats = fn(tb, *(torch.from_numpy(a) for a in (o, d, tn, tx)),
                    inst=inst)
    want = jfn(jb, *(jnp.asarray(a) for a in (o, d, tn, tx)))
    # the packets retired in steps: far fewer live packet-steps than steps
    # over all 64 packets
    assert stats["live_steps"] < stats["steps"] * 64
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < got.numel()
        return
    jtri, ttri = np.asarray(want.tri), got.tri.numpy()
    hits = jtri >= 0
    assert hits.any()
    np.testing.assert_array_equal(ttri >= 0, hits)
    assert (ttri[hits] == jtri[hits]).mean() >= 0.999
    np.testing.assert_allclose(got.t.numpy()[hits], np.asarray(want.t)[hits],
                               rtol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_match_jax(any_hit):
    v0, v1, v2 = _random_tris(600, 31)
    o, d, tn, tx = _retiring_rays(16, 23)
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


def _constants(pkg: str, env: dict) -> list:
    code = {"port": "from eidola_tpu_torch.ops import bvh as b; "
                    "print(b.LEAF_SIZE_CUDA, b.OCT)",
            "jax": "from eidola_tpu.ops import bvh as b; "
                   "print(b.LEAF_SIZE_TPU, b.OCT_ORDER)"}
    out = subprocess.run([sys.executable, "-c", code[pkg]], cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", **env},
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_import_switches_match_jax():
    """EIDOLA_LEAF and EIDOLA_OCT, read at import in both packages, give
    the same constants."""
    for env in ({}, {"EIDOLA_LEAF": "32", "EIDOLA_OCT": "0"}):
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
    o, d, tn, tx = (torch.from_numpy(a) for a in _retiring_rays(8, 5))
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
