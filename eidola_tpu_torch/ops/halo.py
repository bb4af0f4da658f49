"""Row-band locality: row-bounded image gathers, the band context and the
shard context (port of eidola_tpu/ops/halo.py).

`halo_gather` clamps the requested row to r*stride +- halo and reports
which pixels asked for a row inside that window; the caller ANDs the mask
into its accept gates, so a clamped reprojection is rejected like a failed
gate.  The clamp is what bounds the rows a multi-device frame exchanges.

Two contexts make the frame's row-aware points split along row bands:

* `band_context(n)` (and EIDOLA_BANDS): the single-process banded layout
  of the JAX package, where one program holds the whole image split into
  `n` bands.  The gathers run per band against an edge-padded band
  extension (the same values as the flat gather), the wavefront sort is
  band-local (ops/packets.py) and so is the alpha queue march
  (render/tracer.py).  Default 1: the single-band code is untouched.
* `shard_context(group)`: the rank-local frame of parallel/sharding.py.
  The process holds only its rank's rows of every image plane
  (`group.rows(h)`), and the frame's row-aware points read the group:
  global pixel rows for seeds, rays and tiles, and explicit row exchanges
  (parallel/exchange.py) where the JAX package's SPMD partitioner put its
  collectives.  Under it `halo_gather` takes an operand that already
  carries `halo` rows above and below the rank's rows (`group.halo_rows`)
  and measures `own` from the rank's global row.
"""
from __future__ import annotations

import contextlib
import os

import torch

_BANDS = [int(os.environ.get("EIDOLA_BANDS", "1"))]
_SHARD = [None]


def get_bands() -> int:
    """The row-band count of the single-process banded layout (1 =
    unbanded)."""
    return _BANDS[-1]


@contextlib.contextmanager
def band_context(n: int):
    """Run band-aware ops split into `n` row bands."""
    _BANDS.append(max(int(n), 1))
    try:
        yield
    finally:
        _BANDS.pop()


def get_shard():
    """The row group (parallel/exchange.RowGroup) of the rank-local frame,
    or None when the whole image stands on this process."""
    return _SHARD[-1]


@contextlib.contextmanager
def shard_context(group):
    """Run the frame's row-aware points for `group`'s rank: every image
    plane holds only the rank's rows."""
    _SHARD.append(group)
    try:
        yield
    finally:
        _SHARD.pop()


def image_rows(h: int):
    """(global row of the first local row, local row count) of an image of
    full height `h`: (0, h) without a shard context."""
    sh = get_shard()
    return (0, h) if sh is None else sh.rows(h)


def _flat_gather(a, ry, rx):
    ha, wa = a.shape[:2]
    flat = a.reshape((ha * wa,) + tuple(a.shape[2:]))
    idx = (ry * wa + rx).reshape(-1)
    return flat[idx].reshape(tuple(ry.shape) + tuple(a.shape[2:]))


def _banded_gather(a, ry_c, rx, halo: int, stride: int, b: int):
    """The gather of rows `ry_c` run per band against a (Hab + 2 halo)-row
    edge-padded extension of each band (eidola_tpu/ops/halo.py:100-115):
    the index arithmetic stays inside the band, which is what keeps a
    banded program's gathers shard-local.  Same values as the flat
    gather."""
    ha, wa = a.shape[:2]
    ho, wo = ry_c.shape
    hab, hob = ha // b, ho // b
    rows = torch.clamp(torch.arange(-halo, ha + halo, device=a.device), 0,
                       ha - 1)
    padded = a[rows]
    band_start = (torch.arange(ho, dtype=ry_c.dtype, device=ry_c.device)
                  [:, None] // hob) * hab
    j = ry_c - band_start + halo              # in [0, Hab + 2 halo)
    out = []
    for k in range(b):
        ext = padded[k * hab:k * hab + hab + 2 * halo]
        flat = ext.reshape((-1,) + tuple(a.shape[2:]))
        jk, xk = j[k * hob:(k + 1) * hob], rx[k * hob:(k + 1) * hob]
        out.append(flat[(jk * wa + xk).reshape(-1)])
    return torch.cat(out).reshape((ho, wo) + tuple(a.shape[2:]))


def halo_gather(a, ry, rx, halo: int, stride: int = 1,
                bands: int | None = None):
    """out[r, c] = a[ry', rx[r, c]] with ry' = ry clamped to r*stride +- halo.
    Returns (out, in_halo)."""
    return halo_gather_tree(a, ry, rx, halo, stride, bands)


def halo_gather_tree(tree, ry, rx, halo: int, stride: int = 1,
                     bands: int | None = None):
    """halo_gather every tensor of a tensor, NamedTuple or (nested) dict
    with one shared (ry, rx); returns (gathered tree, in_halo mask).

    ry, rx are source coordinates already clipped to the source image;
    `stride` maps an output row to its source row (2 when a half-res
    output reads a full-res source).  With bands=B > 1 (or under
    band_context) and divisible shapes the gather runs per band; under a
    shard context every leaf must carry `halo` rows above and below the
    rank's source rows (`RowGroup.halo_rows`), and ry is global."""
    ho = ry.shape[0]
    sh = get_shard()
    row0 = 0 if sh is None else sh.rank * ho
    own = (torch.arange(row0, row0 + ho, dtype=ry.dtype, device=ry.device)
           [:, None] * stride)
    dy = ry - own
    in_halo = (dy >= -halo) & (dy <= halo)
    b = get_bands() if bands is None else bands

    def g(a):
        if isinstance(a, dict):
            return {k: g(v) for k, v in a.items()}
        if isinstance(a, tuple):
            return type(a)(*[g(v) for v in a])
        if sh is not None:
            hs = a.shape[0] - 2 * halo         # the rank's source rows
            ry_c = torch.clamp(torch.clamp(dy, -halo, halo) + own, 0,
                               hs * sh.world - 1)
            return _flat_gather(a, ry_c - (sh.rank * hs - halo), rx)
        ha = a.shape[0]
        ry_c = torch.clamp(torch.clamp(dy, -halo, halo) + own, 0, ha - 1)
        if b <= 1 or ha % b or ho % b or ha // b != (ho // b) * stride:
            return _flat_gather(a, ry_c, rx)
        return _banded_gather(a, ry_c, rx, halo, stride, b)

    return g(tree), in_halo
