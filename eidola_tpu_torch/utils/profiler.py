"""Frame timing (the port's counterpart of eidola_tpu/utils/profiler.py).

- `StageTimer.mark(name)` closes the stage `name` at the current point of
  the stream: on a CUDA device it records a CUDA event (device time, no
  sync), on the CPU it reads the host clock.  `summary()` returns the
  milliseconds of each stage, summed over every frame that marked it.
  A frame marks primary_trace, shading_ris, shadow_trace and
  di_temporal_shade (render/direct.py), gi_trace and gi_resample
  (render/indirect.py), denoise and compose_post (render/frame.py), so
  the stages cover the whole frame.
- `trace(fn, out_dir, device)` runs `fn` once under torch.profiler, writes
  a Chrome trace and returns the wall time, the summed kernel time and
  the kernels that took the most device time.
"""
from __future__ import annotations

import os
import time

import torch


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
