"""The host's account of a cell's frames, from the program's StageTimer
(eidola_tpu_torch/utils/profiler.py): its spans, on the host's
perf_counter clock, are (kind, name, parent, frame, start_ns, end_ns)
tuples, a "frame" span a frame, a "stage" span a mark, a "sync" span a
blocking read (name its site, parent its stage).

A traced run reads the stage frames' spans through the StageTimer's
summary (`trace.stages.timer`, on a card; a program whose summary carries
no timer gives none, and the metrics read from them are left out):
host_syncs_per_frame, sync_wait_ms and dispatch_ms.

    python3 benchmark/host_spans.py --workload <cell> --seed <n> \
        [--frames 2] [--out spans.json]

runs a cell's warm-up, then `--frames` span frames under a CUDA-only
profile with a StageTimer that records no CUDA event, and prints the
device's idle split by the host span each gap begins in (sync_idle_share:
the idle in gaps that begin while the host waits in a sync span, over
all idle between the first and the last device operation), the same by
stage, and a check of the clocks: kineto stamps device operations on
CLOCK_REALTIME (torch 2.11 on an H100), moved onto the spans' clock by
the timer's anchor, and a sync returns only once the stream has drained,
so at a sync span's end no device operation should be running.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def stage_spans(trace) -> list | None:
    """The stage frames' host spans, from a StageTimer that ran on a card;
    None otherwise (on the CPU the host runs the frame's operations
    itself: there is no device's dispatch and sync to split)."""
    timer = getattr(trace.stages, "timer", None)
    if timer is None or timer.device.type != "cuda":
        return None
    return timer.spans()


def frame_split(spans) -> dict | None:
    """{"frames", "frame_ns", "syncs", "sync_ns", "sites": {site: [syncs,
    ns]}}: each sync's ns is the part of it inside its frame span; None
    without frame spans."""
    frame = {f: (a, b) for kind, _, _, f, a, b in spans or ()
             if kind == "frame"}
    if not frame:
        return None
    out = {"frames": len(frame), "syncs": 0, "sync_ns": 0, "sites": {},
           "frame_ns": sum(b - a for a, b in frame.values())}
    for kind, site, _, f, a, b in spans:
        if kind != "sync":
            continue
        lo, hi = frame.get(f, (a, a))
        ns = max(0, min(b, hi) - max(a, lo))
        out["syncs"] += 1
        out["sync_ns"] += ns
        row = out["sites"].setdefault(site, [0, 0])
        row[0] += 1
        row[1] += ns
    return out


def to_span_clock(events, anchor) -> list:
    """(name, start_ns, end_ns) on CLOCK_REALTIME -> the spans' clock, by
    the anchor (time.time_ns(), time.perf_counter_ns()) read together."""
    offset = anchor[0] - anchor[1]
    return [(name, s - offset, e - offset) for name, s, e in events]


def _pieces(events) -> list:
    """The union of the events' intervals, as sorted [start, end] pieces."""
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _holder(spans, starts, t):
    """The span of `spans` (sorted by start, none overlapping; `starts`
    their starts) that holds the instant t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    return spans[i] if i >= 0 and t <= spans[i][5] else None


def idle_split(events, spans) -> dict | None:
    """The device's idle gaps between its first and its last operation,
    by the host span each begins in: {"idle_ns", "sync_ns" (in gaps that
    begin while the host is inside a sync span), "stages": {stage: [idle
    ns, of it behind a sync]}}; None without events or sync spans."""
    syncs = sorted((x for x in spans if x[0] == "sync"), key=lambda x: x[4])
    if not events or not syncs:
        return None
    stages = sorted((x for x in spans if x[0] == "stage"),
                    key=lambda x: x[4])
    sync_at, stage_at = [x[4] for x in syncs], [x[4] for x in stages]
    out = {"idle_ns": 0, "sync_ns": 0, "stages": {}}
    pieces = _pieces(events)
    for (_, g0), (g1, _) in zip(pieces, pieces[1:]):
        stage = _holder(stages, stage_at, g0)
        row = out["stages"].setdefault(
            "(between frames)" if stage is None else stage[1], [0, 0])
        row[0] += g1 - g0
        out["idle_ns"] += g1 - g0
        if _holder(syncs, sync_at, g0) is not None:
            row[1] += g1 - g0
            out["sync_ns"] += g1 - g0
    return out


def sync_idle_share(events, spans) -> float | None:
    split = idle_split(events, spans)
    if split is None or split["idle_ns"] <= 0:
        return None
    return 100.0 * split["sync_ns"] / split["idle_ns"]


def clock_check(events, spans) -> dict:
    """{site: [syncs, ends with no device operation running, median us
    from such an end back to the last operation's end]}."""
    pieces = _pieces(events)
    starts = [p[0] for p in pieces]
    got: dict = {}
    for kind, site, _, _, _, t in spans:
        if kind != "sync":
            continue
        row = got.setdefault(site, [0, 0, []])
        row[0] += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t >= pieces[i][1]:
            row[1] += 1
            row[2].append((t - pieces[i][1]) / 1e3)
    return {site: [n, idle, statistics.median(d) if d else None]
            for site, (n, idle, d) in got.items()}


def span_frames(frames, n: int) -> tuple:
    """(host spans, device operations on the spans' clock) of `n` frames
    under a CUDA-only profile with a StageTimer that records no CUDA
    event."""
    import torch

    from benchmark import tracing
    from eidola_tpu_torch.utils.profiler import StageTimer

    frames.timer = timer = StageTimer(frames.device, events=False)
    try:
        with tracing.device_profile() as prof:
            frames.sync()
            for _ in range(n):
                frames.frame()
            frames.sync()
    finally:
        frames.timer = None
    cuda = torch.autograd.DeviceType.CUDA
    raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    return timer.spans(), to_span_clock(raw, timer.anchor)


def report(spans, events) -> dict:
    n = sum(x[0] == "frame" for x in spans)
    split = idle_split(events, spans) or {"idle_ns": 0, "sync_ns": 0,
                                          "stages": {}}
    host = frame_split(spans)
    ms = lambda ns: ns / 1e6 / n  # noqa: E731
    return {
        "frames": n,
        "host_syncs_per_frame": host["syncs"] / n,
        "sync_wait_ms": ms(host["sync_ns"]),
        "dispatch_ms": ms(host["frame_ns"] - host["sync_ns"]),
        "host_frame_ms": ms(host["frame_ns"]),
        "sites": {k: [c / n, ms(ns)] for k, (c, ns) in host["sites"].items()},
        "sync_idle_share": sync_idle_share(events, spans),
        "idle_ms": ms(split["idle_ns"]),
        "idle_behind_sync_ms": ms(split["sync_ns"]),
        "idle_by_stage_ms": {k: [ms(a), ms(b)]
                             for k, (a, b) in split["stages"].items()},
        "device_ops": len(events),
        "device_span_ms": ms(max(e for _, _, e in events)
                             - min(s for _, s, _ in events)) if events
        else None,
        "clock_check": clock_check(events, spans),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/host_spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--out", default=None,
                   help="write the spans and device operations as JSON")
    args = p.parse_args(argv)
    from benchmark import manifest
    from benchmark.frames import Frames
    from benchmark.run import set_caches

    cell = manifest.load_cell(args.workload)
    set_caches()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    frames = Frames(cell.config, cell.traffic, args.seed,
                    torch.device("cuda", 0))
    frames.warm(int(cell.traffic["warmup_frames"]))
    print(f"load and warm-up {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    spans, events = span_frames(frames, args.frames)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"spans": spans, "events": events}, f)
    print(json.dumps(dict(report(spans, events), workload=cell.name,
                          device=torch.cuda.get_device_name(0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
