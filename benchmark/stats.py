"""The yardstick's arithmetic, frozen here so that no later change of the
program moves it.

- `percentile` is the linear interpolation of `eidola_tpu_torch/bench.py`'s
  `summarize` (numpy's default), taken at a fixed percentile.
- `frame_ms` is the window's wall time over the frames it completed.
- `spread` is the distance between the first and the third quartile as
  `statistics.quantiles(values, n=4)` gives them, over the median: the
  measure the bounds of BENCHMARK.json were set from.
- `union_s` is the length of the union of [start, end) intervals: the
  time in which some operation ran on the device.
"""
from __future__ import annotations

import statistics

import numpy as np

P90 = 90.0


def percentile(values, q: float) -> float:
    x = np.asarray(values, dtype=np.float64)
    if x.size == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(x, q))


def frame_ms(window_s: float, frames: int) -> float:
    if frames < 1:
        raise ValueError("the window completed no frame")
    return window_s * 1e3 / frames


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2


def union_s(intervals) -> float:
    """Summed length of the union of (start, end) pairs, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, top: int):
    """The `top` longest idle gaps between the union's pieces, as
    (start, length) pairs, longest first."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s - cur_e))
        cur_e = e if cur_e is None else max(cur_e, e)
    out.sort(key=lambda g: -g[1])
    return out[:top]
