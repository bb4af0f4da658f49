"""Collective inventory of the rank-local frame (counterpart of
eidola_tpu/parallel/hlo_audit.py).

The JAX package audits the compiled SPMD module: XLA inserts the
collectives, so the only place to find them is the HLO text, which
hlo_audit.py parses.  The port has no compiled module and no partitioner:
every collective of the frame is an explicit call of
parallel/exchange.py, so the inventory is taken where the calls are
issued, as (kind, payload bytes, site).  No profiler trace is read: a
trace of gloo or NCCL work lists kernels and host spans without the
payload of each message, needs the profiler on, and the frame's own calls
already know their sizes exactly.

The payload of a collective is the size of the tensor the rank receives,
the JAX convention (the result shape of the HLO instruction): the rows
that arrive from the other ranks for a row exchange
("collective-permute"), the whole gathered tensor for "all-gather", the
reduced tensor for "all-reduce".
"""
from __future__ import annotations

KINDS = ("all-gather", "all-reduce", "collective-permute")


class CollectiveLog:
    """The collectives one rank issued, in order: (kind, bytes, site)."""

    def __init__(self):
        self.records: list[tuple[str, int, str]] = []

    def record(self, kind: str, nbytes: int, site: str):
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        self.records.append((kind, int(nbytes), site))

    def clear(self):
        self.records.clear()


def collective_summary(log: CollectiveLog) -> dict:
    """{kind: total bytes} + "total" + "largest" over the log's records
    (clear the log before the frame to audit one frame)."""
    out: dict = {}
    for kind, nbytes, _ in log.records:
        out[kind] = out.get(kind, 0) + nbytes
    out["total"] = sum(b for _, b, _ in log.records)
    out["largest"] = max((b for _, b, _ in log.records), default=0)
    return out
