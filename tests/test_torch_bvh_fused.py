"""The port's fused leaf drains against the JAX Pallas kernels.

`mt_fused_ref` / `mt_any_fused_ref` (plain torch, what the CPU wrappers
run) are held against eidola_tpu's `mt_fused` / `mt_any_fused` in Pallas
interpret mode, on the same f32 coefficient table and event lists:
segments that cross the kernel's 16-event grid step, invalid tail rows,
exact-t ties inside an event (duplicate triangles) and across events
(two leaves holding the same triangles), for leaf sizes 8 and 64.

The occlusion drain's two halves on their own: `any_flags_ref` (each
event's flags) against the Pallas kernel on one-event segments, where
its prefix OR is the identity; `segment_or_ref` against a loop over the
rows with the Pallas kernel's carry rules, on random flags, runs and
invalid rows; and the whole drain on drain_case's edges (dead lanes,
warps and events; a warp whose lanes all hit triangle 0; det at the
1e-12 threshold and 2^126).

Tolerances: any-hit flags equal; closest-hit slots equal on valid rows;
t, u, v within 1e-4 relative, the bound tests/test_bvh_fused.py holds the
fused drain to against the cols oracle.  XLA's dot sums the features in
another order than the port's fixed 0..9 order, and t = t_num / det
amplifies that through cancellation: measured up to 2.0e-5 relative at
leaf size 64 (2 of 4352 lanes above 1e-5).

The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py, on the card.
"""
import numpy as np
import pytest
import torch

import eidola_tpu.ops.bvh_fused as JF
from eidola_tpu_torch.ops import bvh_fused as TF
from eidola_tpu_torch.utils.drain_case import (make_case, random_runs,
                                               torch_args)

torch.set_num_threads(2)


def _case(n, seed):
    """Six overlapping leaves; runs that cross the 16-event grid step; an
    invalid tail after 34 valid events."""
    return make_case(n, n_leaves=6, runs=[3, 14, 1, 9, 2, 5], ce=48,
                     seed=seed)


def _torch_args(c, closest):
    return torch_args(c, torch.device("cpu"), closest)


@pytest.mark.parametrize("n,seed", [(8, 1), (8, 2), (64, 3)])
def test_closest_drain_matches_pallas(n, seed):
    c = _case(n, seed)
    jt, js, ju, jv = [np.asarray(a) for a in JF.mt_fused(
        c["cm"], c["anchor"], c["leaf"], c["leaf"], c["sp"], c["valid"],
        *c["rays"], n)]
    pt, ps, pu, pv = [a.numpy() for a in TF.mt_fused(
        *_torch_args(c, True), n)]
    v = c["n_valid"]
    hits = jt[:v] < c["rays"][7][:v]
    assert hits.mean() > 0.1, "degenerate case: too few hits"
    np.testing.assert_array_equal(ps[:v], js[:v])
    np.testing.assert_allclose(pt[:v], jt[:v], rtol=1e-4)
    real = jt[:v] < 1e29                     # u, v of a miss are unused
    np.testing.assert_allclose(pu[:v][real], ju[:v][real], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pv[:v][real], jv[:v][real], rtol=1e-4,
                               atol=1e-5)


def test_tie_rules_match_pallas():
    """First minimum inside an event, later event across events."""
    c = _case(8, 1)
    pt, ps, _, _ = TF.mt_fused(*_torch_args(c, True), 8)
    js = np.asarray(JF.mt_fused(
        c["cm"], c["anchor"], c["leaf"], c["leaf"], c["sp"], c["valid"],
        *c["rays"], 8)[1])
    won = pt[1].numpy() < c["rays"][7][1]
    k = ps[1].numpy() % 8
    assert won.any()
    # duplicate triangles 0/1 never let slot k=1 win, and row 1 (leaf 1,
    # a copy of leaf 0) takes every tie from row 0
    assert not (k == 1).any()
    assert (ps[1].numpy()[won] // 8 == 1).all()
    np.testing.assert_array_equal(ps[1].numpy(), js[1])


@pytest.mark.parametrize("n,seed", [(8, 4), (64, 5)])
def test_any_drain_matches_pallas(n, seed):
    c = _case(n, seed)
    jh = np.asarray(JF.mt_any_fused(
        c["cm"], c["anchor"], c["leaf"], c["sp"], c["valid"], *c["rays"], n,
        prec=None))
    ph = TF.mt_any_fused(*_torch_args(c, False), n).numpy()
    v = c["n_valid"]
    assert 0.05 < jh[:v].mean() < 0.95
    np.testing.assert_array_equal(ph[:v], jh[:v])


def _pallas_any(c, n):
    return np.asarray(JF.mt_any_fused(
        c["cm"], c["anchor"], c["leaf"], c["sp"], c["valid"], *c["rays"], n,
        prec=None))


@pytest.mark.parametrize("n,seed", [(8, 21), (64, 22)])
def test_any_flags_match_pallas_on_one_event_segments(n, seed):
    """Every event its own segment: the Pallas kernel's output is each
    event's own flags on the valid rows; invalid rows never hit."""
    c = make_case(n, n_leaves=6, runs=[1] * 40, ce=48, seed=seed)
    jh = _pallas_any(c, n)
    cm, anchor, leaf, _, valid, *planes = _torch_args(c, False)
    ph = TF.any_flags_ref(cm, anchor, leaf, valid, *planes, n).numpy()
    v = c["n_valid"]
    assert 0.05 < jh[:v].mean() < 0.95
    np.testing.assert_array_equal(ph[:v], jh[:v])
    assert not ph[v:].any()


def _or_loop(h, sp, valid):
    """The Pallas kernel's carry, row by row: a valid row whose sub-packet
    differs from the last valid row's starts from 0, as does row 0."""
    out = np.zeros_like(h)
    carry = np.zeros(h.shape[1], h.dtype)
    prev = -1
    for r in range(h.shape[0]):
        if r == 0 or (valid[r] and sp[r] != prev):
            carry = np.zeros_like(carry)
        carry = carry | h[r]
        out[r] = carry
        if valid[r]:
            prev = sp[r]
    return out


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_segment_or_matches_loop(seed):
    """Runs of 1-32 rows, a fifth of the rows invalid (the first row too
    for one seed) with random sub-packets of their own, sparse flags."""
    rng = np.random.default_rng(seed)
    ce = 400
    runs = random_runs(ce, 32, seed)
    sp = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    valid = (rng.random(ce) > 0.2).astype(np.int32)
    valid[0] = seed % 2
    sp = np.where(valid == 1, sp, rng.integers(0, len(runs), ce)).astype(
        np.int32)
    h = (rng.random((ce, 128)) < 0.05).astype(np.int32)
    got = TF.segment_or_ref(torch.from_numpy(h), torch.from_numpy(sp),
                            torch.from_numpy(valid)).numpy()
    want = _or_loop(h, sp, valid)
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(8, 41), (64, 42)])
def test_any_drain_edges_match_pallas(n, seed):
    """drain_case's edges through the whole plain occlusion drain: lanes
    0-31 of the events of leaves 4-5 all hit triangle 0 (det above
    1e-12), of leaves 2-3 none (det at or below it; triangle 1's det^2
    overflows to inf, so no t passes), lanes 32-63 and every 11th event
    are dead."""
    c = make_case(n, n_leaves=6, runs=[3, 14, 1, 9, 2, 5], ce=48, seed=seed,
                  edge=True)
    jh = _pallas_any(c, n)
    args = _torch_args(c, False)
    ph = TF.mt_any_fused(*args, n).numpy()
    v = c["n_valid"]
    np.testing.assert_array_equal(ph[:v], jh[:v])
    cm, anchor, leaf, _, valid, *planes = args
    flags = TF.any_flags_ref(cm, anchor, leaf, valid, *planes, n).numpy()
    live = (c["valid"] == 1) & (np.arange(48) % 11 != 5)
    for lf, want in zip(range(2, 6), (0, 0, 1, 1)):
        rows = np.flatnonzero(live & (c["leaf"] == lf))
        assert rows.size, f"no live event of leaf {lf}"
        assert (flags[rows, :32] == want).all()
        assert not flags[rows, 32:64].any()
    assert not flags[5::11].any()


def test_wrappers_reject_bad_inputs():
    c = _case(8, 6)
    args = _torch_args(c, True)
    with pytest.raises(ValueError):
        TF.mt_fused(*args, 64)                        # table is for n=8
    bad = list(args)
    bad[-1] = bad[-1][:, :64]
    with pytest.raises(ValueError):
        TF.mt_fused(*bad, 8)
