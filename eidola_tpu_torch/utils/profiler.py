"""Frame timing (the port's counterpart of eidola_tpu/utils/profiler.py).

- `Profiler` keeps named recurring scopes (`scope`, `timeit`), each
  averaged over its last 64 samples, and `summary()` prints them as the
  JAX package's does; `MilliTimer` times the load phase.  A scope reads
  the host clock, so it waits for its `block_on` tensors first: it
  synchronises each CUDA device they live on (the counterpart of
  `jax.block_until_ready`; CPU tensors are ready when the call
  returns), and only when the profiler is enabled.
- `StageTimer.mark(name)` closes the stage `name` at the current point of
  the stream: on a CUDA device it records a CUDA event (device time, no
  sync), on the CPU, or with `events=False`, it reads the host clock.
  `summary()` returns the milliseconds of each stage, summed over every
  frame that marked it (a dict whose `timer` is the StageTimer, so a
  reader of the summary also reaches its host account).  A frame marks
  primary_trace, shading_ris, shadow_trace, di_temporal_shade and, in
  the spatial ReSTIR modes, di_spatial (render/direct.py), gi_trace and
  gi_resample (render/indirect.py), denoise and compose_post
  (render/frame.py), so the stages cover the whole frame.
- The same timer keeps the host's account of its frames on
  `time.perf_counter_ns()`: every `start`/`mark` stamps the host clock,
  and `sync(site)` spans each blocking read (a device-to-host copy, a
  host-to-device copy from pageable memory, `torch.nonzero`) with its
  site.  `spans()` returns (kind, name, parent, frame, start_ns, end_ns)
  tuples: a "frame" span per `start` (name "frame", no parent), a
  "stage" span per mark (parent "frame") and a "sync" span per blocking
  read (name its site, parent the stage it falls in); `host_summary()`
  gives the host ms, syncs and sync ms of each stage.  `anchor` is
  (time.time_ns(), time.perf_counter_ns()) read back to back at
  construction, to map a profiler's CLOCK_REALTIME stamps onto the
  spans.  Nothing is written out.
- The frame sets its timer as the module's active timer for its
  duration (`set_active`; render/frame.py), so the sync sites, deep in
  the stages, reach it without a parameter: module-level `sync(site)`
  is the active timer's span, or one shared no-op context when no timer
  is active.  The sites of a bistro_standin frame on the card are
  march.count and march.select (render/tracer.py), sunsky.upload
  (scene/sunsky.py), bsdf.upload (render/bsdf.py) and tonemap.upload
  (ops/tonemap.py): every synchronizing call that
  `torch.cuda.set_sync_debug_mode("warn")` reports in its frame.
- `trace(fn, out_dir, device)` runs `fn` once under torch.profiler, writes
  a Chrome trace into `out_dir` (none when it is None) and returns the wall time, the summed kernel time and
  the kernels that took the most device time.  On a card it records the
  device's activity alone, as the benchmark's device profile does (the
  host's account of a frame is the StageTimer's).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from dataclasses import dataclass, field

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait for the work that makes the tensors of `tree` (nested tuples,
    lists, dicts): one synchronize per CUDA device among them."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


@dataclass
class _Scope:
    samples: deque = field(default_factory=lambda: deque(maxlen=64))
    total: float = 0.0
    count: int = 0

    def add(self, dt: float):
        self.samples.append(dt)
        self.total += dt
        self.count += 1

    @property
    def avg_ms(self) -> float:
        if not self.samples:
            return 0.0
        return sum(self.samples) / len(self.samples) * 1e3


class Profiler:
    """Wall-clock profiler with named recurring scopes.

    >>> prof = Profiler(enabled=True)
    >>> with prof.scope("Render", block_on=outputs["image"]):
    ...     state, outputs = step(...)
    >>> print(prof.summary())
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.scopes: dict[str, _Scope] = {}

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.scopes.setdefault(name, _Scope()).add(time.perf_counter() - t0)

    def timeit(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its result, record under `name`, return it."""
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self.scopes.setdefault(name, _Scope()).add(time.perf_counter() - t0)
        return out

    def summary(self) -> str:
        lines = [f"{'scope':<24} {'avg ms':>9} {'calls':>7} {'total s':>9}"]
        for name, s in self.scopes.items():
            lines.append(
                f"{name:<24} {s.avg_ms:>9.2f} {s.count:>7} {s.total:>9.2f}")
        return "\n".join(lines)


class MilliTimer:
    """Load-phase wall timer, as the JAX package's."""

    def __init__(self, label: str = ""):
        self.label = label
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def print(self, what: str = ""):
        dt = self.ms()
        print(f"{self.label}{what}: {dt:.1f} ms")
        return dt


class StageTimer:
    def __init__(self, device, events: bool = True):
        self.device = torch.device(device)
        # CUDA events at the marks on a card unless events=False (then,
        # as on the CPU, the host clock alone: nothing in a device trace)
        self.events = events and self.device.type == "cuda"
        self._marks: list = []       # (stage or None at start, CUDA event)
        self._host: list = []        # (stage or None at start, frame, ns)
        self._syncs: list = []       # (site, frame, closing mark, t0, t1)
        self.frames = 0
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def _stamp(self, name) -> None:
        if self.events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((name, ev))
        self._host.append((name, self.frames - 1, time.perf_counter_ns()))

    def start(self) -> None:
        self.frames += 1
        self._stamp(None)

    def mark(self, name: str) -> None:
        self._stamp(name)

    def sync(self, site: str) -> "_SyncSpan":
        return _SyncSpan(self, site)

    def _synced(self, site: str, t0: int, t1: int) -> None:
        self._syncs.append((site, self.frames - 1, len(self._host), t0, t1))

    def summary(self) -> "StageSummary":
        if self.events:
            torch.cuda.synchronize()
            pairs = [(name, a.elapsed_time(b)) for (_, a), (name, b)
                     in zip(self._marks, self._marks[1:])]
        else:
            pairs = [(name, (b - a) / 1e6) for (_, _, a), (name, _, b)
                     in zip(self._host, self._host[1:])]
        out = StageSummary(self)
        for name, ms in pairs:
            if name is not None:
                out[name] = out.get(name, 0.0) + ms
        return out

    def spans(self) -> list:
        out = []
        frame = None
        for i, (name, f, t) in enumerate(self._host):
            if name is None:
                frame = ["frame", "frame", None, f, t, t]
                out.append(frame)
            else:
                out.append(("stage", name, "frame", f, self._host[i - 1][2],
                            t))
                frame[5] = t
        for site, f, k, t0, t1 in self._syncs:
            # the mark that closed the stage it fell in (none after a
            # frame's last mark: then the frame is its parent)
            closing = self._host[k][0] if k < len(self._host) else None
            out.append(("sync", site, closing or "frame", f, t0, t1))
        return [tuple(x) for x in out]

    def host_summary(self) -> dict:
        """{stage: {"host_ms", "syncs", "sync_ms"}} summed over frames."""
        out: dict = {}
        for kind, name, parent, _, a, b in self.spans():
            if kind == "frame":
                continue
            row = out.setdefault(name if kind == "stage" else parent,
                                 {"host_ms": 0.0, "syncs": 0,
                                  "sync_ms": 0.0})
            if kind == "stage":
                row["host_ms"] += (b - a) / 1e6
            else:
                row["syncs"] += 1
                row["sync_ms"] += (b - a) / 1e6
        return out


class StageSummary(dict):
    """{stage: ms} of StageTimer.summary(); `timer` is that StageTimer."""

    def __init__(self, timer: StageTimer):
        super().__init__()
        self.timer = timer


class _SyncSpan:
    __slots__ = ("timer", "site", "t0")

    def __init__(self, timer: StageTimer, site: str):
        self.timer, self.site = timer, site

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.timer._synced(self.site, self.t0, time.perf_counter_ns())
        return False


_active: StageTimer | None = None
_NO_SPAN = contextlib.nullcontext()


def set_active(timer: StageTimer | None) -> None:
    """The timer whose frame is being rendered (render/frame.py), or None."""
    global _active
    _active = timer


def sync(site: str):
    """A span of the active timer around a blocking read at `site`; with no
    timer active, one shared no-op context (a global read a site)."""
    t = _active
    return _NO_SPAN if t is None else t.sync(site)


def trace(fn, out_dir: str, device, top: int = 12) -> dict:
    """Profile one call of `fn`; the device's busy share is the summed
    kernel time over the wall time (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    # kernels only: an op's device time repeats the time of its kernels
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall_ms if wall_ms else 0.0,
            "top": [{"ms": ms, "calls": n, "name": k[:90]}
                    for ms, n, k in rows[:top]]}
