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
  sync), on the CPU it reads the host clock.  `summary()` returns the
  milliseconds of each stage, summed over every frame that marked it.
  A frame marks primary_trace, shading_ris, shadow_trace,
  di_temporal_shade and, in the spatial ReSTIR modes, di_spatial
  (render/direct.py), gi_trace and gi_resample
  (render/indirect.py), denoise and compose_post (render/frame.py), so
  the stages cover the whole frame.
- `trace(fn, out_dir, device)` runs `fn` once under torch.profiler, writes
  a Chrome trace into `out_dir` (none when it is None) and returns the wall time, the summed kernel time and
  the kernels that took the most device time.
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
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: list = []

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self._marks.append((None, self._stamp()))

    def mark(self, name: str) -> None:
        self._marks.append((name, self._stamp()))

    def summary(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out: dict = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            if name is None:
                continue
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def trace(fn, out_dir: str, device, top: int = 12) -> dict:
    """Profile one call of `fn`; the device's busy share is the summed
    kernel time over the wall time (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
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
