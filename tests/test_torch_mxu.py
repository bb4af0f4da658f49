"""The port's per-event leaf drain (ops/bvh_mxu.py) and the EIDOLA_MT=mxu
traversal against the JAX package's.

- `build_cmat` / `build_feats` against eidola_tpu's, on random leaf rows.
- `mt_mxu` (on the CPU its plain version, `mt_mxu_ref`) against the
  Pallas kernel in interpret mode, at leaf size 8 on 48 events (a
  multiple of the kernel's 16-event grid step), with misses, degenerate
  triangles (det = 0), exact-t ties and t_lim cuts; and at leaf size 64
  with drain_case's edges: det one ulp below, at and one ulp above the
  1e-12 threshold, det 2^126 (the CUDA kernel's division branch), dead
  warps and dead events.
- `mt_mxu_ref` sums only the 19 nonzero coefficient products (as the
  CUDA kernel does); the dense sum over all ten features (the Pallas
  kernel's product, kept here in `_dense_ref`) gives the same values
  (`==`, so +0 and -0 are equal) and the same k.
- A whole closest hit and any hit on `stress` (n=2) with the port's
  `bvh.MT = "mxu"` against JAX `closest_hit` / `any_hit` with
  `eidola_tpu.ops.bvh.MT_MODE = "mxu"` (read at trace time: patched before
  the call), where JAX drains closest hits with `mt_mxu` and occlusion
  with `_mt_any_cols`.
- The torch fold keeps the later event at an exact-t tie, as JAX's
  doubling scan does (strict < against the shifted value).

Tolerances: coefficients and features within 1e-6 relative (the same
products; XLA may contract or reorder the three-term sums).  Per lane t
within 2e-5 relative and u, v within 1e-5 absolute: the port sums the
ten feature products in a fixed order 0..9, XLA's dot in its own, and
t = t_num / det amplifies the difference by cancellation (the bound
tests/test_torch_bvh_fused.py measured for the same dot).  The winning
slot k equal except where two triangles give t within 1e-5 relative (a
near-tie that a last-bit difference can flip); misses equal exactly.
Whole traversals: hit masks equal, winners equal on >= 0.999 of hits,
t within 1e-4 relative, the bounds tests/test_torch_bvh.py uses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.models.scenes as JS
import eidola_tpu.ops.bvh as JB
import eidola_tpu.ops.bvh_mxu as JM
from eidola_tpu_torch import interop
from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import bvh_mxu as TM
from eidola_tpu_torch.ops.bvh_fused import NFEAT, _features
from eidola_tpu_torch.utils.drain_case import make_case, mxu_args

torch.set_num_threads(2)


def _rows(ce, n, seed):
    """Random (ce, 12n) leaf rows and rays aimed at each row's leaf."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (ce, 1, 3)).astype(np.float32)
    tri = np.zeros((ce, n, 12), np.float32)
    tri[..., 0:3] = c + rng.uniform(-1, 1, (ce, n, 3))
    tri[..., 3:9] = rng.normal(0, 0.6, (ce, n, 6))
    o = (c + rng.uniform(-3, 3, (ce, 128, 3))).astype(np.float32)
    tgt = (c + rng.uniform(-0.8, 0.8, (ce, 128, 3))).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tri, o, d


def _case(n, seed, edge=False):
    """48 events of random leaves with the drain_case ties (triangle 1 of
    each leaf duplicates triangle 0), plus degenerate triangles (e2 = 0,
    and e2 = e1: det = 0 exactly), rays cut at a random t_lim on 30% of
    lanes, and a dead tail; edge=True adds drain_case's edges."""
    c = make_case(n, n_leaves=6, runs=[3, 14, 1, 9, 2, 5], ce=48, seed=seed,
                  edge=edge)
    rows = c["blocks"][c["leaf"]].reshape(48, n, 12).copy()
    rows[:, 2, 6:9] = 0.0
    rows[:, 3, 6:9] = rows[:, 3, 3:6]
    c["blocks_rows"] = rows.reshape(48, n * 12)
    args = mxu_args(c, torch.device("cpu"))
    args[0] = torch.from_numpy(c["blocks_rows"])
    return c, args


def test_build_cmat_and_feats_match_jax():
    tri, o, d = _rows(32, 8, seed=1)
    row = tri.reshape(32, 96)
    jc, ja = JM.build_cmat(jnp.asarray(row), 8)
    tc, ta = TM.build_cmat(torch.from_numpy(row), 8)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    planes = [o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1],
              d[..., 2]]
    jf = JM.build_feats(ja, *[jnp.asarray(p) for p in planes])
    tf = TM.build_feats(ta, *[torch.from_numpy(p) for p in planes])
    assert tuple(tf.shape) == (32, TM.KDIM, 128)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_mt_mxu_matches_pallas(seed):
    c, args = _case(8, seed)
    jt, jk, ju, jv = [np.asarray(a) for a in JM.mt_mxu(
        jnp.asarray(c["blocks_rows"]), 8,
        *[jnp.asarray(a.numpy()) for a in args[1:]])]
    before = TM.LAUNCHES["mt_mxu"]
    pt, pk, pu, pv = [a.numpy() for a in TM.mt_mxu(args[0], 8, *args[1:])]
    assert TM.LAUNCHES["mt_mxu"] == before       # no kernel on the CPU
    assert pk.dtype == np.int32 and pt.dtype == np.float32
    hit = jt < 1e30
    assert 0.05 < hit.mean() < 0.9, "degenerate case"
    np.testing.assert_array_equal(pt < 1e30, hit)
    assert not hit[34:].any()                    # the dead tail
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=2e-5)
    # misses: t = 1e30, k = u = v = 0 on both sides
    for a, b in ((pt, jt), (pk, jk), (pu, ju), (pv, jv)):
        np.testing.assert_array_equal(a[~hit], b[~hit])
    # degenerate triangles 2 and 3 never win; the tie 0/1 goes to 0
    assert not np.isin(pk[hit], [1, 2, 3]).any()
    same = hit & (pk == jk)
    assert same.sum() >= 0.999 * hit.sum()
    # a different slot only at a near-tie: both t agree
    np.testing.assert_allclose(pt[hit & ~same], jt[hit & ~same], rtol=1e-5)
    np.testing.assert_allclose(pu[same], ju[same], atol=1e-5)
    np.testing.assert_allclose(pv[same], jv[same], atol=1e-5)


@pytest.mark.parametrize("seed", [13, 14])
def test_mt_mxu_edge_dets_match_pallas(seed):
    """Leaf size 64 with drain_case's edges.  Lanes 0-31 of leaves 2-5 run
    through triangle 0, whose det is one ulp below, at, one ulp above and
    well above 1e-12: it wins (t = 1) only where det passes the
    threshold, and triangle 1 (det 2^126, t = 1.5) wins elsewhere; lanes
    32-63 of those events and every 11th event are dead."""
    c, args = _case(64, seed, edge=True)
    jt, jk, ju, jv = [np.asarray(a) for a in JM.mt_mxu(
        jnp.asarray(c["blocks_rows"]), 64,
        *[jnp.asarray(a.numpy()) for a in args[1:]])]
    pt, pk, pu, pv = [a.numpy() for a in TM.mt_mxu(args[0], 64, *args[1:])]
    hit = jt < 1e30
    np.testing.assert_array_equal(pt < 1e30, hit)
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=2e-5)
    for a, b in ((pt, jt), (pk, jk), (pu, ju), (pv, jv)):
        np.testing.assert_array_equal(a[~hit], b[~hit])
    same = hit & (pk == jk)
    assert same.sum() >= 0.999 * hit.sum()
    np.testing.assert_allclose(pu[same], ju[same], atol=1e-5)
    np.testing.assert_allclose(pv[same], jv[same], atol=1e-5)
    live = (c["valid"] == 1) & (np.arange(48) % 11 != 5)
    for leaf, want_k, want_t in zip(range(2, 6), (1, 1, 0, 0),
                                    (1.5, 1.5, 1.0, 1.0)):
        rows = np.flatnonzero(live & (c["leaf"] == leaf))
        assert rows.size, f"no live event of leaf {leaf}"
        for k, t in ((pk, pt), (jk, jt)):
            assert (k[rows, :32] == want_k).all()
            np.testing.assert_allclose(t[rows, :32], want_t, rtol=1e-6)
        assert not hit[rows, 32:64].any()            # the dead warp
    assert not hit[5::11].any()                      # the dead events


def _dense_ref(row, n, ox, oy, oz, dx, dy, dz, t_min, t_lim):
    """`mt_mxu_ref` with the dense dot: build_cmat's ten coefficients of
    each form times the ten features, zeros included, summed in order
    0..9."""
    cm, anchor = TM.build_cmat(row, n)
    f = _features(anchor, ox, oy, oz, dx, dy, dz)
    acc = cm[:, :, 0, None] * f[:, None, 0, :]
    for j in range(1, NFEAT):
        acc = acc + cm[:, :, j, None] * f[:, None, j, :]
    det, tn, un, vn = acc[:, :n], acc[:, n:2 * n], acc[:, 2 * n:3 * n], \
        acc[:, 3 * n:]
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / det, 0.0)
    t, u, v = tn * inv, un * inv, vn * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[:, None]) & (t < t_lim[:, None]))
    tm = torch.where(hit, t, 1e30)
    tb = torch.amin(tm, dim=1)
    kb = torch.amin(torch.where(tm <= tb[:, None],
                                torch.arange(n)[None, :, None], n), dim=1)
    miss = tb >= 1e30
    ub = torch.gather(u, 1, kb[:, None]).squeeze(1)
    vb = torch.gather(v, 1, kb[:, None]).squeeze(1)
    return (torch.where(miss, 1e30, tb), torch.where(miss, 0, kb),
            torch.where(miss, 0.0, ub), torch.where(miss, 0.0, vb))


@pytest.mark.parametrize("n,seed,edge", [(8, 15, False), (64, 16, False),
                                         (64, 17, True)],
                         ids=["leaf8", "leaf64", "leaf64-edges"])
def test_sparse_ref_equals_dense_sum(n, seed, edge):
    """Leaving the zero products out changes at most the sign of an
    exact zero: values equal under ==, k exactly."""
    _, args = _case(n, seed, edge)
    st, sk, su, sv = TM.mt_mxu_ref(args[0], n, *args[1:])
    dt, dk, du, dv = _dense_ref(args[0], n, *args[1:])
    assert (st < 1e30).any()
    assert torch.equal(sk, dk.to(torch.int32))
    for a, b in ((st, dt), (su, du), (sv, dv)):
        assert bool((a == b).all())


def test_mt_mxu_plain_chunks_agree():
    """The plain version gives the same bits whatever its slice size."""
    _, args = _case(8, 5)
    a = TM.mt_mxu_ref(args[0], 8, *args[1:])
    b = TM.mt_mxu_ref(args[0], 8, *args[1:], chunk=7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_mt_mxu_rejects_bad_inputs():
    _, args = _case(8, 6)
    with pytest.raises(ValueError):
        TM.mt_mxu(args[0], 64, *args[1:])           # rows are for n = 8
    with pytest.raises(ValueError):
        TM.mt_mxu(args[0], 8, *args[1:7], args[7][:, :64], args[8])
    with pytest.raises(ValueError):
        TM.mt_mxu(args[0].double(), 8, *args[1:])


def test_fold_keeps_later_event_at_exact_tie():
    """Three events of sub-packet 0 and one of sub-packet 1: events 0 and
    1 tie exactly, event 2 misses; the fold carries event 1's slot."""
    sp = torch.tensor([0, 0, 0, 1])
    t = torch.tensor([[2.0], [2.0], [1e30], [3.0]])
    slot = torch.tensor([[5], [9], [0], [4]], dtype=torch.int32)
    u = torch.tensor([[0.1], [0.2], [0.0], [0.3]])
    v = torch.tensor([[0.4], [0.5], [0.0], [0.6]])
    ft, fs, fu, fv = TB._segment_scan(sp, (t, slot, u, v), TB._fold_min)
    assert fs[:, 0].tolist() == [5, 9, 9, 4]
    assert ft[:, 0].tolist() == [2.0, 2.0, 2.0, 3.0]
    assert fu[2, 0].item() == pytest.approx(0.2)
    hit = TB._segment_scan(sp, torch.tensor([[True], [False], [False],
                                             [False]]), TB._fold_or)
    assert hit[:, 0].tolist() == [True, True, True, False]


@pytest.fixture(scope="module")
def stress():
    js, jcam = JS.stress_grid(n=2)
    return js.bvh, interop.to_torch(js.bvh, torch.device("cpu"))


def _stress_rays(n=640, seed=21):
    """Rays from around the grid aimed into it, a third shadow-length."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 2.0
    tgt = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(np.arange(n) % 3, 1e9, 6.0).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), tmax


def test_closest_hit_mxu_matches_jax(stress, monkeypatch):
    jbvh, tbvh = stress
    o, d, tmin, tmax = _stress_rays()
    monkeypatch.setattr(JB, "MT_MODE", "mxu")
    monkeypatch.setattr(TB, "MT", "mxu")
    jr = JB.closest_hit(jbvh, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(tmin), jnp.asarray(tmax))
    tr = TB.closest_hit(tbvh, *[torch.from_numpy(a) for a in (o, d, tmin,
                                                              tmax)])
    jtri, ttri = np.asarray(jr.tri), tr.tri.numpy()
    hits = jtri >= 0
    assert 0.1 < hits.mean() < 0.95, "degenerate rays"
    np.testing.assert_array_equal(ttri >= 0, hits)
    assert (ttri[hits] == jtri[hits]).mean() >= 0.999
    np.testing.assert_allclose(tr.t.numpy()[hits], np.asarray(jr.t)[hits],
                               rtol=1e-4)
    same = hits & (ttri == jtri)
    np.testing.assert_allclose(tr.u.numpy()[same], np.asarray(jr.u)[same],
                               atol=1e-4)
    # the fused drain finds the same hits
    monkeypatch.setattr(TB, "MT", "fused")
    fr = TB.closest_hit(tbvh, *[torch.from_numpy(a) for a in (o, d, tmin,
                                                              tmax)])
    assert (fr.tri.numpy() == ttri).mean() >= 0.999


def test_any_hit_mxu_matches_jax(stress, monkeypatch):
    jbvh, tbvh = stress
    o, d, tmin, tmax = _stress_rays(seed=22)
    monkeypatch.setattr(JB, "MT_MODE", "mxu")
    monkeypatch.setattr(TB, "MT", "mxu")
    jo = np.asarray(JB.any_hit(jbvh, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmin), jnp.asarray(tmax)))
    to = TB.any_hit(tbvh, *[torch.from_numpy(a) for a in (o, d, tmin,
                                                          tmax)]).numpy()
    assert 0 < jo.sum() < jo.size
    np.testing.assert_array_equal(to, jo)


def test_unknown_mt_mode_raises(stress, monkeypatch):
    _, tbvh = stress
    o, d, tmin, tmax = _stress_rays(n=128)
    monkeypatch.setattr(TB, "MT", "cols")
    with pytest.raises(ValueError):
        TB.closest_hit(tbvh, *[torch.from_numpy(a) for a in (o, d, tmin,
                                                              tmax)])
