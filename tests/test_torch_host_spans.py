"""The StageTimer's host account of a frame (utils/profiler.py): the frame
and stage spans its marks stamp on the host clock, the sync spans around
each blocking read, and the active timer the frame sets for its sites.

On a tiny bistro_standin (2 x 2 lots) at 32x32 on the CPU, under the
card's queue march (EIDOLA_ALPHA_MARCH=queue), two frames with a timer
and the same two frames without; no JAX.
"""
import time

import pytest
import torch

from eidola_tpu_torch.app.headless import alpha_geometry, set_numerics
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.render import frame as F
from eidola_tpu_torch.render import tracer as T
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.utils import profiler
from eidola_tpu_torch.utils.profiler import StageTimer

torch.set_num_threads(2)

FRAMES = 2
STAGES = ["primary_trace", "shading_ris", "shadow_trace", "di_temporal_shade",
          "gi_trace", "gi_resample", "denoise", "compose_post"]
SITES = {"march.count", "march.select", "sunsky.upload", "bsdf.upload",
         "tonemap.upload"}


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


@pytest.fixture(scope="module")
def frames():
    """Both runs of FRAMES frames from one state: with a timer (the laps
    and lap capacities of every _march_band call counted beside it) and
    without (the active timer read at every sync site)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EIDOLA_ALPHA_MARCH", "queue")
        return _render(mp)


def _render(mp):
    dev = torch.device("cpu")
    set_numerics()
    scene, cam = load_scene("bistro_standin", device=dev, target_mtris=0.004)
    cfg = RenderConfig(width=32, height=32, max_depth=2,
                       alpha_geometry=alpha_geometry(scene))
    step = F.make_step(cfg)
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    state0 = F.init_frame_state(cfg, cam)

    laps, caps = [0], []
    band, passthrough = T._march_band, T._alpha_passthrough

    def counted_band(*a):
        caps.append(len(a[-1]))
        return band(*a)

    def counted_passthrough(*a):
        laps[0] += 1
        return passthrough(*a)

    mp.setattr(T, "_march_band", counted_band)
    mp.setattr(T, "_alpha_passthrough", counted_passthrough)
    timer = StageTimer(dev)
    state, timed = state0, []
    for _ in range(FRAMES):
        state, out = step(scene, cam, params, tm, state, timer=timer)
        timed.append((state, out))
    mp.setattr(T, "_march_band", band)
    mp.setattr(T, "_alpha_passthrough", passthrough)

    seen, sync = [], profiler.sync

    def watched(site):
        seen.append((site, profiler._active))
        return sync(site)

    mp.setattr(profiler, "sync", watched)
    idle = StageTimer(dev)          # made, never passed
    state, plain = state0, []
    for _ in range(FRAMES):
        state, out = step(scene, cam, params, tm, state)
        plain.append((state, out))
    return dict(timer=timer, timed=timed, plain=plain, laps=laps[0],
                caps=caps, seen=seen, idle=idle, step=step, scene=scene,
                cam=cam, params=params, tm=tm, state0=state0)


def test_no_timer_records_nothing(frames):
    # every site ran, each with no active timer, and nothing reached a
    # timer that was not passed
    assert {site for site, _ in frames["seen"]} == SITES
    assert all(t is None for _, t in frames["seen"])
    assert profiler._active is None
    idle = frames["idle"]
    assert idle.spans() == [] and idle.frames == 0
    assert profiler.sync("march.count") is profiler.sync("march.select")


def test_active_timer_cleared_after_a_frame_that_raises(frames, monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("direct stage failed")

    monkeypatch.setattr(F, "direct_stage", fail)
    timer = StageTimer("cpu")
    with pytest.raises(RuntimeError, match="direct stage failed"):
        frames["step"](frames["scene"], frames["cam"], frames["params"],
                       frames["tm"], frames["state0"], timer=timer)
    assert profiler._active is None
    with pytest.raises(RuntimeError):
        frames["step"](frames["scene"], frames["cam"], frames["params"],
                       frames["tm"], frames["state0"])
    assert profiler._active is None


def test_summary_keeps_its_keys_and_values(frames):
    timer = frames["timer"]
    got = timer.summary()
    assert isinstance(got, dict) and list(got) == STAGES
    assert got.timer is timer
    # on the CPU a stage's ms is its host span's, summed over the frames
    want = dict.fromkeys(STAGES, 0.0)
    for kind, name, _, _, a, b in timer.spans():
        if kind == "stage":
            want[name] += (b - a) / 1e6
    assert got == pytest.approx(want, rel=1e-12)
    assert all(v > 0 for v in got.values())


def test_stage_spans_nest_in_their_frame_in_mark_order(frames):
    spans = frames["timer"].spans()
    assert all(len(s) == 6 for s in spans)
    frame = [s for s in spans if s[0] == "frame"]
    assert [(s[1], s[2], s[3]) for s in frame] == \
        [("frame", None, f) for f in range(FRAMES)]
    for _, _, _, f, a, b in frame:
        stages = [s for s in spans if s[0] == "stage" and s[3] == f]
        assert [s[1] for s in stages] == STAGES
        assert all(s[2] == "frame" for s in stages)
        assert stages[0][4] == a and stages[-1][5] == b
        for x, y in zip(stages, stages[1:]):
            assert x[4] <= x[5] == y[4] <= y[5]
    assert frame[0][5] <= frame[1][4]


def test_every_sync_span_lies_in_one_stage_span(frames):
    timer = frames["timer"]
    spans = timer.spans()
    stages = [s for s in spans if s[0] == "stage"]
    syncs = [s for s in spans if s[0] == "sync"]
    assert {s[1] for s in syncs} == SITES
    for _, site, parent, f, a, b in syncs:
        holders = [s for s in stages if s[4] <= a <= b <= s[5]]
        assert len(holders) == 1, (site, a, b)
        assert (holders[0][1], holders[0][3]) == (parent, f)
    host = timer.host_summary()
    assert sum(r["syncs"] for r in host.values()) == len(syncs)
    assert {k: r["host_ms"] for k, r in host.items()} == \
        pytest.approx(dict(timer.summary()), rel=1e-12)


def test_march_sync_counts_are_its_laps(frames):
    # one count a lap and one at each capacity's exit; one select a lap
    sites = [s[1] for s in frames["timer"].spans() if s[0] == "sync"]
    assert frames["laps"] > 0 and len(frames["caps"]) > 0
    assert sites.count("march.select") == frames["laps"]
    assert sites.count("march.count") == frames["laps"] + sum(frames["caps"])


def test_timer_leaves_the_frame_bitwise_the_same(frames):
    for (st_t, out_t), (st_p, out_p) in zip(frames["timed"],
                                            frames["plain"]):
        a = list(_leaves((st_t, out_t)))
        b = list(_leaves((st_p, out_p)))
        assert len(a) == len(b) > 10
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_host_only_timer_and_anchor():
    timer = StageTimer("cpu", events=False)
    assert timer.events is False and timer._marks == []
    rt, pc = timer.anchor       # the two clocks, read together
    assert abs(time.time_ns() - rt - (time.perf_counter_ns() - pc)) < 10**8
    timer.start()
    with timer.sync("x"):
        pass
    timer.mark("a")
    kinds = [(s[0], s[1], s[2]) for s in timer.spans()]
    assert kinds == [("frame", "frame", None), ("stage", "a", "frame"),
                     ("sync", "x", "a")]
    assert timer._marks == []
