"""Seeded inputs for the leaf drains (ops/bvh_fused.py, ops/bvh_mxu.py),
shared by the tests and chip_smoke.py.

A case is a table of random leaves and a compacted event list shaped
like a traversal drain: runs of events per sub-packet (segments), an
invalid tail, and the tie patterns the drains must resolve exactly —
triangle 1 of every leaf duplicates triangle 0 (an exact-t tie inside an
event) and leaf 1 duplicates leaf 0 (a tie across the first two events).
Each sub-packet's 128 rays are aimed at the leaf of its first event.
"""
from __future__ import annotations

import numpy as np

from ..ops.bvh_fused import build_leaf_tables_np


def make_case(n: int, n_leaves: int, runs, ce: int, seed: int,
              spread: float = 0.0) -> dict:
    """numpy arrays: cm (L,16,4n), blocks (L,12n), anchor (ce,3),
    leaf/sp/valid (ce,) int32, rays: 8 planes (ce,128) f32
    [ox,oy,oz,dx,dy,dz,tmin,tlim]."""
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
    cm, anchor = build_leaf_tables_np(blocks.reshape(L, n * 12), n)

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
    return dict(cm=cm, blocks=blocks.reshape(L, n * 12),
                anchor=np.ascontiguousarray(anchor[leaf]), leaf=leaf,
                sp=sp, valid=valid, rays=rays, n=n, n_valid=n_valid)


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
