"""O(1) discrete sampling via alias tables (port of
eidola_tpu/ops/alias_table.py; ref src/alias_table.hpp:21-126).

The table is built on the host in numpy (or by the port's C++ in native/);
`sample_alias` is two gathers per candidate on the device."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AliasTable(NamedTuple):
    alias: torch.Tensor      # (N,) int64 redirect index
    q: torch.Tensor          # (N,) f32 acceptance threshold
    pdf: torch.Tensor        # (N,) f32 normalized pmf of bin i
    alias_pdf: torch.Tensor  # (N,) f32 normalized pmf of alias[i]


def build_alias_table_np(weights: np.ndarray):
    """Walker/Vose two-stack construction (ref alias_table.hpp:21-63).
    Returns (alias i32, q f32, pdf f32, alias_pdf f32, total)."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    total = float(w.sum())
    if n == 0 or total <= 0.0:
        z = np.zeros(max(n, 1), np.float32)
        return (np.zeros(max(n, 1), np.int32), np.ones(max(n, 1), np.float32),
                z, z, 0.0)
    pdf = (w / total).astype(np.float64)
    scaled = pdf * n
    alias = np.arange(n, dtype=np.int32)
    q = np.ones(n, np.float64)

    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        q[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        q[i] = 1.0
        alias[i] = i

    alias_pdf = pdf[alias]
    return (alias.astype(np.int32), q.astype(np.float32),
            pdf.astype(np.float32), alias_pdf.astype(np.float32), total)


def make_alias_table(weights: np.ndarray):
    """Host build -> (AliasTable of numpy arrays, total weight).  Uses the
    C++ construction in native/ when it is available, like the JAX
    package."""
    from ..native import build_alias_native

    w = np.asarray(weights, np.float64).ravel()
    out = build_alias_native(w) if w.size else None
    if out is None or w.size == 0 or out[4] <= 0.0:
        out = build_alias_table_np(weights)
    alias, q, pdf, alias_pdf, total = out
    return AliasTable(alias, q, pdf, alias_pdf), total


def sample_alias(table: AliasTable, u1, u2):
    """Uniform bin pick + alias redirect (ref alias_table.hpp:70-74).
    Returns (index int64, pmf f32)."""
    n = table.alias.shape[0]
    idx = torch.clamp((u1 * n).to(torch.int64), max=n - 1)
    take = u2 < table.q[idx]
    out_idx = torch.where(take, idx, table.alias[idx])
    out_pmf = torch.where(take, table.pdf[idx], table.alias_pdf[idx])
    return out_idx, out_pmf
