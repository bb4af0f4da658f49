"""Row-bounded image gathers (port of the single-band path of
eidola_tpu/ops/halo.py:64-129).

`halo_gather` clamps the requested row to r*stride +- halo and reports
which pixels asked for a row inside that window; the caller ANDs the mask
into its accept gates, so a clamped reprojection is rejected like a failed
gate.  The banded multi-device layout comes with the multi-device slice.
"""
from __future__ import annotations

import torch


def _flat_gather(a, ry, rx):
    ha, wa = a.shape[:2]
    flat = a.reshape((ha * wa,) + tuple(a.shape[2:]))
    idx = (ry * wa + rx).reshape(-1)
    return flat[idx].reshape(tuple(ry.shape) + tuple(a.shape[2:]))


def halo_gather(a, ry, rx, halo: int, stride: int = 1):
    """out[r, c] = a[ry', rx[r, c]] with ry' = ry clamped to r*stride +- halo.
    Returns (out, in_halo)."""
    return halo_gather_tree(a, ry, rx, halo, stride)


def halo_gather_tree(tree, ry, rx, halo: int, stride: int = 1):
    """halo_gather every tensor of a tensor, NamedTuple or (nested) dict
    with one shared (ry, rx); returns (gathered tree, in_halo mask)."""
    ho = ry.shape[0]
    own = torch.arange(ho, dtype=ry.dtype, device=ry.device)[:, None] * stride
    dy = ry - own
    in_halo = (dy >= -halo) & (dy <= halo)

    def g(a):
        if isinstance(a, dict):
            return {k: g(v) for k, v in a.items()}
        if isinstance(a, tuple):
            return type(a)(*[g(v) for v in a])
        ry_c = torch.clamp(torch.clamp(dy, -halo, halo) + own, 0,
                           a.shape[0] - 1)
        return _flat_gather(a, ry_c, rx)

    return g(tree), in_halo
