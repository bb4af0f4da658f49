"""host_spans.py and the readers of the program's host spans, on
synthetic spans and device operations: the frame's split into dispatch
and sync wait, the idle split behind syncs, the clock conversion, the
clock check, and None where there is nothing to read."""
import time

import pytest
import torch

from benchmark import host_spans as H
from benchmark import tracing
from benchmark.metrics import dispatch_ms, host_syncs_per_frame, sync_wait_ms

READERS = (host_syncs_per_frame, sync_wait_ms, dispatch_ms)
MS = 1_000_000

# two frames of 100 ms: stages a (0-40) and b (40-100); frame 0 syncs at
# 10-20 and 50-80 ms, frame 1 at 130-135
SPANS = [("frame", "frame", None, 0, 0, 100 * MS),
         ("stage", "a", "frame", 0, 0, 40 * MS),
         ("stage", "b", "frame", 0, 40 * MS, 100 * MS),
         ("frame", "frame", None, 1, 100 * MS, 200 * MS),
         ("stage", "a", "frame", 1, 100 * MS, 200 * MS),
         ("sync", "march.count", "a", 0, 10 * MS, 20 * MS),
         ("sync", "march.select", "b", 0, 50 * MS, 80 * MS),
         ("sync", "march.count", "a", 1, 130 * MS, 135 * MS)]


class FakeTimer:
    def __init__(self, device, spans):
        self.device = torch.device(device)
        self._spans = spans

    def spans(self):
        return list(self._spans)


class Stages(dict):
    pass


def _trace(stages):
    return tracing.Trace(frames=1, window_s=1.0, events=[], busy_s=0.0,
                         stages=stages, stage_frames=2, frame_s=0.1,
                         walks=[], peak_bytes=0)


def _stages(device, spans):
    s = Stages(a=1.0)
    s.timer = FakeTimer(device, spans)
    return s


def test_frame_split_and_readers():
    split = H.frame_split(SPANS)
    assert split["frames"] == 2 and split["syncs"] == 3
    assert split["frame_ns"] == 200 * MS and split["sync_ns"] == 45 * MS
    assert split["sites"] == {"march.count": [2, 15 * MS],
                              "march.select": [1, 30 * MS]}
    t = _trace(_stages("cuda", SPANS))
    assert host_syncs_per_frame.read(t) == 1.5
    assert sync_wait_ms.read(t) == pytest.approx(22.5)
    assert dispatch_ms.read(t) == pytest.approx(77.5)
    # dispatch and sync wait make up the frame
    assert sync_wait_ms.read(t) + dispatch_ms.read(t) == pytest.approx(100)


def test_a_sync_counts_only_its_part_inside_its_frame():
    spans = SPANS[:5] + [("sync", "x", "frame", 0, 90 * MS, 110 * MS)]
    split = H.frame_split(spans)
    assert split["sync_ns"] == 10 * MS and split["sites"]["x"] == [1, 10 * MS]


def test_readers_return_none_without_spans():
    for stages in (Stages(a=1.0), {"a": 1.0},          # no timer
                   _stages("cpu", SPANS),              # not a card's
                   _stages("cuda", [])):               # no frame
        t = _trace(stages)
        assert [r.read(t) for r in READERS] == [None] * 3
    assert H.frame_split(()) is None and H.frame_split(None) is None


def test_gap_beginning_inside_a_sync_counts_toward_the_share():
    events = [("k1", 0, 12 * MS),         # idle 12-30: begins in the sync
              ("k2", 30 * MS, 35 * MS),   # idle 35-45: begins outside
              ("k3", 45 * MS, 47 * MS),
              ("k4", 46 * MS, 60 * MS)]   # overlaps k3: no gap
    split = H.idle_split(events, SPANS)
    assert split["idle_ns"] == 28 * MS and split["sync_ns"] == 18 * MS
    assert split["stages"] == {"a": [28 * MS, 18 * MS]}
    assert H.sync_idle_share(events, SPANS) == pytest.approx(100 * 18 / 28)
    # the same gaps with the sync gone: none behind a sync
    no_sync = [s for s in SPANS if s[1] != "march.count"]
    assert H.sync_idle_share(events, no_sync) == 0.0
    # a gap between frames is named so
    split = H.idle_split([("k", 205 * MS, 206 * MS),
                          ("k", 210 * MS, 220 * MS)], SPANS)
    assert split["stages"] == {"(between frames)": [4 * MS, 0]}


def test_idle_split_needs_events_and_syncs():
    assert H.idle_split([], SPANS) is None
    assert H.idle_split([("k", 0, 1)], SPANS[:5]) is None
    assert H.sync_idle_share([("k", 0, 1)], SPANS) is None   # no gap


def test_clock_conversion_holds():
    anchor = (time.time_ns(), time.perf_counter_ns())
    rt = time.time_ns()
    pc = time.perf_counter_ns()
    (_, s, e), = H.to_span_clock([("k", rt, rt + 5000)], anchor)
    assert e - s == 5000
    assert abs(s - pc) < 50 * MS      # read together, so near each other
    anchor = (1_700_000_000_000_000_000, 5_000)
    assert H.to_span_clock([("k", 1_700_000_000_000_001_000,
                             1_700_000_000_000_002_000)], anchor) == \
        [("k", 6_000, 7_000)]


def test_clock_check_finds_operations_running_at_a_sync_end():
    events = [("k", 0, 19 * MS),          # ends 1 ms before 20
              ("k", 70 * MS, 90 * MS),    # runs at 80
              ("k", 100 * MS, 134 * MS)]  # ends 1 ms before 135
    got = H.clock_check(events, SPANS)
    assert got == {"march.count": [2, 2, pytest.approx(1000.0)],
                   "march.select": [1, 0, None]}
