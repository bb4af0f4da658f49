"""The row group's collectives: the only module of the port that calls
torch.distributed.

A rank holds equal bands of rows of every image plane
(`RowGroup.rows`).  The frame communicates at the places where the JAX
package's SPMD partitioner inserts its collectives:

* `exchange_rows(group, tree, halo)`: the rank's rows extended by `halo`
  rows above and below, fetched from as many neighbouring ranks as the
  halo spans, with edge rows at the image border (what `mode="edge"`
  padding gives).  Every leaf of a tree is packed into one byte plane, so
  a tree costs one message per peer.  Point-to-point sends and receives
  ("collective-permute" in the audit).
* `all_reduce_sum`: a sum over the ranks.
* `all_gather_rows`: the full image on every rank.

The backend is the caller's choice at `init_group`: NCCL on cards, one
rank per card; gloo on the CPU; gloo for ranks that share one card.
gloo moves CUDA tensors only for broadcast and all_reduce, so under gloo
every collective stages its tensors through host memory (a copy to the
host before, a copy back after).  Nothing switches backend by itself, and
a collective that fails raises.  Each call is recorded in the group's
`CollectiveLog` (parallel/comm_audit.py).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.checkpoint import tree_leaves, tree_unflatten
from .comm_audit import CollectiveLog


class RowGroup:
    """One rank's place in a row-sharded image over the default process
    group: rank, world size, whether collectives stage through the host
    (gloo), and the log of the collectives it issued."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world
        self.host_staged = dist.get_backend() == "gloo"
        self.log = CollectiveLog()

    def rows(self, h: int):
        """(global row of the rank's first row, rows per rank) of an image
        of full height h."""
        if h % self.world:
            raise ValueError(f"image height {h} does not split into "
                             f"{self.world} row bands")
        n = h // self.world
        return self.rank * n, n


def init_group(rank: int, world: int, backend: str, init_method: str,
               timeout_s: float = 300.0) -> RowGroup:
    """Join the default process group as `rank` of `world` over `backend`
    ("nccl" or "gloo") at `init_method` (tcp://localhost:<port>)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return RowGroup(rank, world)


def close_group():
    dist.destroy_process_group()


def _staged(group: RowGroup, x):
    return x.cpu() if group.host_staged and x.is_cuda else x


def _exchange_plane(group: RowGroup, x, halo: int):
    """(n + 2 halo, C) rows around the rank's (n, C) plane; returns it and
    the bytes received from other ranks."""
    n = x.shape[0]
    r, world = group.rank, group.world
    h, row0 = n * world, r * n
    lo, hi = max(0, row0 - halo), min(h, row0 + n + halo)
    ops, pieces, received = [], [], 0
    for s in range(world):                      # the rows this rank needs
        a, b = max(lo, s * n), min(hi, (s + 1) * n)
        if a >= b:
            continue
        if s == r:
            pieces.append(x[a - row0:b - row0])
            continue
        buf = torch.empty((b - a,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        ops.append(dist.P2POp(dist.irecv, buf, s))
        pieces.append(buf)
        received += buf.numel() * buf.element_size()
    for d in range(world):                      # the rows others need
        a = max(max(0, d * n - halo), row0)
        b = min(min(h, (d + 1) * n + halo), row0 + n)
        if d != r and a < b:
            ops.append(dist.P2POp(dist.isend,
                                  x[a - row0:b - row0].contiguous(), d))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    span = torch.cat(pieces)                    # global rows [lo, hi)
    idx = torch.clamp(torch.arange(row0 - halo, row0 + n + halo,
                                   device=x.device), 0, h - 1) - lo
    return span[idx], received


def exchange_rows(group: RowGroup, tree, halo: int, site: str):
    """Every leaf of `tree` (a tensor, NamedTuple or dict of (n, ...)
    planes holding the rank's rows; None leaves stay None) extended to
    (n + 2 halo, ...): global rows clamp(row0 - halo ... row0 + n + halo -
    1, 0, H - 1)."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    if any(a.shape[0] != n for a in leaves):
        raise ValueError("exchange_rows: leaves of different row counts")
    dev = leaves[0].device
    flat = [_staged(group, a).contiguous().reshape(n, -1) for a in leaves]
    plane = torch.cat([a.view(torch.uint8) for a in flat], dim=1)
    ext, received = _exchange_plane(group, plane, halo)
    group.log.record("collective-permute", received, site)
    out, col = [], 0
    for a, src in zip(flat, leaves):
        nb = a.shape[1] * a.element_size()
        piece = ext[:, col:col + nb].contiguous().view(a.dtype)
        out.append(piece.reshape((n + 2 * halo,) + tuple(src.shape[1:]))
                   .to(dev))
        col += nb
    return tree_unflatten(tree, iter(out))


def all_reduce_sum(group: RowGroup, x, site: str):
    """The sum of `x` over the ranks."""
    y = _staged(group, x).clone()
    dist.all_reduce(y)
    group.log.record("all-reduce", y.numel() * y.element_size(), site)
    return y.to(x.device)


def all_gather_rows(group: RowGroup, x, site: str):
    """The ranks' row bands of `x`, stacked in rank order: the full
    image on every rank."""
    y = _staged(group, x).contiguous()
    bufs = [torch.empty_like(y) for _ in range(group.world)]
    dist.all_gather(bufs, y)
    out = torch.cat(bufs)
    group.log.record("all-gather", out.numel() * out.element_size(), site)
    return out.to(x.device)
