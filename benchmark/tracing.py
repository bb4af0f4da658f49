"""What a traced run (--trace 1) reads, taken from the benchmark's own
files around the program's calls; nothing inside the program changes.

- After the window and its check, run.STAGE_S seconds of frames run with
  a StageTimer (the program's CUDA events at its stage boundaries, passed
  as the step's `timer=`) and no profiler: each stage's milliseconds.
- Then run.TRACE_S seconds of frames (the traced window) run under
  torch.profiler with CUDA activity only (no CPU tracing, so the host's
  dispatch is slowed by the tracer as little as it can be): every device
  operation with its interval.
- Two walk frames after those pass a `stats` buffer to each walk
  launch (ops/bvh_walk._walk) under the same CUDA-only profile: each
  launch's counted steps and leaf events, beside its kernel's time.
- Two host frames after those run under a CPU + CUDA profile: the longest
  idle gaps of the device and the host operation under each.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import stats
from .roofline import Launch

WALK_KERNEL = "walk_kernel"
EXTRA_FRAMES = 2
TOP = 10


class Trace(NamedTuple):
    frames: int              # frames of the traced window
    window_s: float          # its host-clock length
    events: list             # (name, start_us, end_us) of its device ops
    busy_s: float            # the union of those intervals
    stages: dict             # StageTimer ms summed over the stage frames
    stage_frames: int        # frames with the StageTimer
    frame_s: float           # the untraced window's seconds a frame
    walks: list              # (Launch, kernel ms) of the walk frames
    peak_bytes: int


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _spans(prof):
    """(is a device op, name, start_us, end_us) of every event a profile
    saw, read from its raw kineto events: building torch's FunctionEvent
    tree over a window's ~2M device operations takes minutes."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    for e in events:
        start = e.start_ns() - base     # exact in integer ns
        yield (e.device_type() == cuda, e.name(), start / 1e3,
               (start + e.duration_ns()) / 1e3)


def device_events(prof) -> list:
    """(name, start_us, end_us) of every device operation a profile saw."""
    return [(name, s, e) for dev, name, s, e in _spans(prof) if dev]


@contextlib.contextmanager
def device_profile(cpu: bool = False):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        yield prof


def walk_launches(frames, n: int) -> list:
    """(Launch, kernel ms) of every walk launch of `n` frames, each given
    a stats buffer; [] when the kernels and the launches do not pair."""
    from eidola_tpu_torch.ops import bvh_walk

    orig = bvh_walk._walk
    rec = []

    def counted(name, walk, leaf_blocks, rays, max_steps, st, inst):
        if st is None:
            st = torch.empty((rays.shape[1], 2), dtype=torch.int32,
                             device=walk.device)
        out = orig(name, walk, leaf_blocks, rays, max_steps, st, inst)
        rec.append((st, walk.shape[0], leaf_blocks.shape[0],
                    leaf_blocks.shape[1] // 12, rays.numel(),
                    rays[0].numel(),
                    0 if inst is None else inst[0].shape[0],
                    0 if inst is None else inst[2].shape[0]))
        return out

    bvh_walk._walk = counted
    try:
        with device_profile() as prof:
            for _ in range(n):
                frames.frame()
            frames.sync()
    finally:
        bvh_walk._walk = orig
    kernels = [e for e in device_events(prof) if WALK_KERNEL in e[0]]
    if len(kernels) != len(rec):
        return []
    out = []
    for (st, *sizes), (_, s, e) in zip(rec, sorted(kernels,
                                                   key=lambda k: k[1])):
        tot = st.to(torch.int64).sum(0).tolist()
        out.append((Launch(tot[0], tot[1], *sizes), (e - s) / 1e3))
    return out


def host_gaps(frames, n: int) -> list:
    """[[host op, seconds]] of the TOP longest device idle gaps of `n`
    frames under a CPU + CUDA profile: the innermost host operation that
    spans the gap's middle."""
    with device_profile(cpu=True) as prof:
        for _ in range(n):
            frames.frame()
        frames.sync()
    dev, host = [], []
    for is_dev, name, s, e in _spans(prof):
        if is_dev:
            dev.append((s, e))
        else:
            host.append(((s, e), name))
    out = []
    for start, length in stats.gaps(dev, TOP):
        mid = start + length / 2
        under = [(b - a, name) for (a, b), name in host if a <= mid <= b]
        out.append([min(under)[1] if under else "(no host op)",
                    length / 1e6])
    return out


def top_ops(events: list) -> list:
    """[[device op, seconds]] of the TOP operations by summed time."""
    tot: dict = {}
    for name, s, e in events:
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[k[:120], v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


def busy_s(events: list) -> float:
    return stats.union_s([(s, e) for _, s, e in events]) / 1e6


def kernel_count(events: list) -> int:
    return sum(_is_kernel(name) for name, _, _ in events)
