"""Seeded inputs for the leaf drains (ops/bvh_fused.py, ops/bvh_mxu.py),
shared by the tests and chip_smoke.py.

A case is a table of random leaves and a compacted event list shaped
like a traversal drain: runs of events per sub-packet (segments), an
invalid tail, and the tie patterns the drains must resolve exactly —
triangle 1 of every leaf duplicates triangle 0 (an exact-t tie inside an
event) and leaf 1 duplicates leaf 0 (a tie across the first two events).
Each sub-packet's 128 rays are aimed at the leaf of its first event.

`edge=True` adds the cases the kernels' fast paths must leave unchanged
(`add_edges`): determinants at the 1e-12 threshold and one at 2^126 (the
reciprocal's range check falls back to the division), a warp whose lanes
all hit triangle 0, dead warps and dead events.
"""
from __future__ import annotations

import numpy as np

from ..ops.bvh_fused import build_leaf_tables_np


# det = b of triangle 0 of leaves 2-5 (add_edges) for rays along -z: one
# ulp below the drains' 1e-12 threshold, at it (not above), one ulp above,
# and well above it
THR = np.float32(1e-12)
EDGE_DETS = (np.nextafter(THR, np.float32(0)), THR,
             np.nextafter(THR, np.float32(1)), np.float32(1e-6))
HUGE = np.float32(2.0 ** 63)   # edges of a triangle whose det is 2^126


def make_case(n: int, n_leaves: int, runs, ce: int, seed: int,
              spread: float = 0.0, edge: bool = False) -> dict:
    """numpy arrays: cm (L,16,4n), blocks (L,12n), anchor (ce,3),
    leaf/sp/valid (ce,) int32, rays: 8 planes (ce,128) f32
    [ox,oy,oz,dx,dy,dz,tmin,tlim]; edge=True: add_edges (n_leaves >= 6)."""
    rng = np.random.default_rng(seed)
    L = n_leaves
    centers = rng.uniform(-spread, spread, (L, 1, 3)).astype(np.float32)
    v0 = (centers + rng.uniform(-1, 1, (L, n, 3))).astype(np.float32)
    e1 = rng.normal(0, 0.6, (L, n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (L, n, 3)).astype(np.float32)
    v0[:, 1], e1[:, 1], e2[:, 1] = v0[:, 0], e1[:, 0], e2[:, 0]
    v0[1], e1[1], e2[1] = v0[0], e1[0], e2[0]
    blocks = np.zeros((L, n, 12), np.float32)
    blocks[..., 0:3], blocks[..., 3:6], blocks[..., 6:9] = v0, e1, e2

    runs = list(runs)
    sp = np.concatenate([np.full(r, i, np.int32) for i, r in enumerate(runs)])
    n_valid = sp.size
    if n_valid > ce:
        raise ValueError(f"runs hold {n_valid} events > ce={ce}")
    leaf = rng.integers(0, L, ce).astype(np.int32)
    leaf[0:2] = [0, 1]
    valid = (np.arange(ce) < n_valid).astype(np.int32)
    sp = np.concatenate([sp, np.full(ce - n_valid, sp[-1], np.int32)])

    n_sp = len(runs)
    first = np.searchsorted(sp[:n_valid], np.arange(n_sp))
    aim = centers[leaf[first], 0][:, None, :]              # (n_sp, 1, 3)
    o = (aim + rng.uniform(-3, 3, (n_sp, 128, 3))).astype(np.float32)
    tgt = (aim + rng.uniform(-0.8, 0.8, (n_sp, 128, 3))).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full((n_sp, 128), 1e-4, np.float32)
    tlim = np.where(rng.random((n_sp, 128)) < 0.3, 1e30,
                    rng.uniform(2.0, 6.0, (n_sp, 128))).astype(np.float32)
    g = lambda a: np.ascontiguousarray(a[sp])
    rays = [g(o[..., 0]), g(o[..., 1]), g(o[..., 2]), g(d[..., 0]),
            g(d[..., 1]), g(d[..., 2]), g(tmin), g(tlim)]
    if edge:
        add_edges(blocks, leaf, rays, rng)
    cm, anchor = build_leaf_tables_np(blocks.reshape(L, n * 12), n)
    return dict(cm=cm, blocks=blocks.reshape(L, n * 12),
                anchor=np.ascontiguousarray(anchor[leaf]), leaf=leaf,
                sp=sp, valid=valid, rays=rays, n=n, n_valid=n_valid)


def add_edges(blocks, leaf, rays, rng) -> None:
    """In place, on make_case's (L, n, 12) leaves and (ce, 128) ray planes.

    Leaves 2-5: triangle 0 is (0, e1 = x, e2 = b y) at the origin (the
    leaf's anchor), b from EDGE_DETS; triangle 1 spans the plane z = -0.5
    with edges of 2^63 (det 2^126 for rays along -z: the reciprocal's
    range check falls back to the division, for the whole warp); the
    other triangles move 10 away in x and y.  In each event of those
    leaves, lanes 0-31 run along -z from z = 1 through triangle 0 at
    (u, v) in [0.05, 0.45]^2: one warp whose lanes all hit triangle 0
    (t = 1) where b passes the threshold, triangle 1 (t = 1.5) where it
    does not; lanes 32-63 are dead (t_lim = -1 < t_min): a dead warp.
    Every 11th event is dead on all lanes."""
    ox, oy, oz, dx, dy, dz, tmin, tlim = rays
    for L, b in zip(range(2, 6), EDGE_DETS):
        blocks[L, 2:, 0:2] += 10.0
        blocks[L, 0] = 0.0
        blocks[L, 0, 3], blocks[L, 0, 7] = 1.0, b
        blocks[L, 1] = 0.0
        blocks[L, 1, 0:3] = (-HUGE / 4, -HUGE / 4, -0.5)
        blocks[L, 1, 3], blocks[L, 1, 7] = HUGE, HUGE
        rows = np.flatnonzero(leaf == L)
        uv = rng.uniform(0.05, 0.45, (rows.size, 32, 2)).astype(np.float32)
        ox[rows, :32] = uv[..., 0]
        oy[rows, :32] = b * uv[..., 1]
        oz[rows, :32] = 1.0
        dx[rows, :32], dy[rows, :32], dz[rows, :32] = 0.0, 0.0, -1.0
        tlim[rows, 32:64] = -1.0
    tlim[5::11] = -1.0


def random_runs(total: int, max_run: int, seed: int) -> list[int]:
    """Run lengths in [1, max_run] summing to `total`."""
    rng = np.random.default_rng(seed)
    runs = []
    while sum(runs) < total:
        runs.append(int(min(rng.integers(1, max_run + 1), total - sum(runs))))
    return runs


def torch_args(case: dict, device, closest: bool) -> list:
    """The wrapper arguments (without n_tris) as tensors on `device`;
    closest=True adds the gleaf column mt_fused takes."""
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ints = [case["leaf"]] + ([case["leaf"]] if closest else []) + [
        case["sp"], case["valid"]]
    return ([t(case["cm"]), t(case["anchor"])] + [t(a) for a in ints]
            + [t(r) for r in case["rays"]])


def mxu_args(case: dict, device) -> list:
    """The arguments of ops/bvh_mxu.mt_mxu (without n_tris) as tensors on
    `device`: each event's gathered leaf row, then the 8 ray planes; the
    rays of the invalid tail are dead (t_lim = -1 < t_min)."""
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rays = [np.array(r) for r in case["rays"]]
    rays[7][case["valid"] == 0] = -1.0
    return [t(case["blocks"][case["leaf"]])] + [t(r) for r in rays]
