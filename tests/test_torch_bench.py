"""The port's headline bench (eidola_tpu_torch/bench.py) on the CPU.

`python -m eidola_tpu_torch.bench` is the counterpart of the repo's
bench.py; on the CPU (`--device cpu`, which only the tests use) it runs
at cornell 32x32 with 1 warm-up and 3 timed frames:

- it prints exactly one JSON line, last, with bench.py's fields
  (metric, value, unit "ms/frame", vs_baseline against 18.2 ms,
  mrays_per_s, mrays_method) and the port's (scene, n_tris, size,
  device, trav, load, first frame, the frames' summary, peak memory,
  launches a frame, the stage split, the busy share, the golden check);
  on the CPU no device metric carries a number;
- its measured rays are sum(ops/packets.RAY_LEDGER) of the counted frame
  (the ledger itself is held against JAX's in
  test_torch_options.py::test_ray_ledger_matches_jax), and
  EIDOLA_BENCH_RAYCOUNT=0 gives bench.py's modeled count (6,480,000 at
  1920x1080, depth 4: bench.py:133-137); EIDOLA_BENCH_BREAKDOWN adds
  bench.py's ablation, whose parts sum to `value`, each config timed as
  a window;
- `value` is the timed window's ms over its frames, as bench.py takes
  it: one host sync before the window, none inside it, one after it;
  `frames["window_ms"]` is the window, and Mrays/s and vs_baseline
  divide by `value`;
- the golden check passes on tests/golden/cornell_64_d2_f4.npy and fails,
  exit 1, nothing timed, against a copy shifted by 0.05;
- the frames' summary: median, p25, p75 and the tail (the highest
  percentile with ten samples beyond it: p75 at 40, null at 10);
- with no card, `--device cuda` prints "value": -1 and an "error", exits
  1 and renders nothing (skipped where a card is present);
- a failure of nvidia-smi fails the card readout, a counted frame with
  no rays fails the ray count, and the launch check refuses a walk
  traversal that launched a drain or no walk.
"""
import contextlib
import io
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from eidola_tpu_torch import bench
from eidola_tpu_torch.ops import packets as P

torch.set_num_threads(2)

SMALL = ["--device", "cpu", "--scene", "cornell", "--size", "32", "32",
         "--warmup", "1", "--iters", "3"]
STAGES = {"primary_trace", "shading_ris", "shadow_trace", "di_temporal_shade",
          "gi_trace", "gi_resample", "denoise", "compose_post"}
FIELDS = {"metric", "value", "unit", "vs_baseline", "mrays_per_s",
          "mrays_method", "rays_per_frame", "scene", "n_tris", "width",
          "height", "device", "trav", "load_s", "first_frame_ms", "frames",
          "peak_mem_gib", "launches_per_frame", "stage_ms",
          "golden_s", "golden_mean_abs", "correct"}
FRAME_FIELDS = {"n", "median", "mean", "min", "max", "p25", "p75",
                "tail_pct", "tail_ms", "frame_ms", "window_ms"}


def _run(argv):
    """(exit code, stdout lines, the JSON objects among them)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    lines = buf.getvalue().splitlines()
    objs = []
    for line in lines:
        with contextlib.suppress(ValueError):
            obj = json.loads(line)
            if isinstance(obj, dict):
                objs.append(obj)
    return rc, lines, objs


@pytest.fixture(scope="module")
def small():
    rc, lines, objs = _run(SMALL)
    return rc, lines, objs, list(P.RAY_LEDGER)


def test_bench_prints_one_json_line_last(small):
    rc, lines, objs, _ = small
    assert rc == 0
    assert len(objs) == 1 and json.loads(lines[-1]) == objs[0]
    out = objs[0]
    assert FIELDS <= set(out), FIELDS - set(out)
    assert out["metric"] == "restir_di_gi_denoise_32p_ms"
    assert out["unit"] == "ms/frame"
    assert (out["scene"], out["width"], out["height"]) == ("cornell", 32, 32)
    assert out["n_tris"] > 0 and out["trav"] == "xla"
    assert out["device"] == {"platform": "cpu", "name": "cpu",
                             "power_limit_w": None, "count": 0}
    frames = out["frames"]
    assert set(frames) == FRAME_FIELDS and frames["n"] == 3
    assert len(frames["frame_ms"]) == 3 and frames["tail_pct"] is None
    assert out["value"] == frames["window_ms"] / frames["n"] > 0
    assert out["vs_baseline"] == pytest.approx(18.2 / out["value"])
    assert out["first_frame_ms"] > 0 and out["load_s"] > 0
    # no device metric from a CPU run
    assert out["peak_mem_gib"] is None
    assert set(out["stage_ms"]) == STAGES
    assert all(v >= 0 for v in out["stage_ms"].values())
    # the CPU traces with the torch walk: no kernel launched
    assert set(out["launches_per_frame"].values()) == {0.0}
    assert out["correct"] is True and out["image_finite"] is True


def test_bench_measured_rays_are_the_ledger(small):
    _, _, objs, ledger = small
    out = objs[0]
    assert out["mrays_method"] == "measured: live-lane traversal counters"
    assert out["rays_per_frame"] == sum(ledger) > 0
    assert out["mrays_per_s"] == pytest.approx(
        sum(ledger) / out["value"] / 1e3)


def test_bench_rates_divide_by_the_window(small):
    """Mrays/s and vs_baseline come from `value`, the window's ms/frame."""
    out = small[2][0]
    assert out["mrays_per_s"] * out["value"] == pytest.approx(
        out["rays_per_frame"] / 1e3)
    assert out["vs_baseline"] * out["value"] == pytest.approx(18.2)
    assert out["value"] * out["frames"]["n"] == pytest.approx(
        out["frames"]["window_ms"])


def test_time_frames_syncs_once_around_the_window(monkeypatch):
    """The first warm-up frame is synced alone; the window has one sync
    before it and one after it, none between its frames."""
    events = []
    real_step = bench.make_step

    def make_step(cfg):
        step = real_step(cfg)

        def counted(*args, **kw):
            events.append("frame")
            return step(*args, **kw)
        return counted

    monkeypatch.setattr(bench, "make_step", make_step)
    monkeypatch.setattr(bench, "_sync", lambda device: events.append("sync"))
    scene, cam = bench.load_scene("cornell", device="cpu")
    cfg = bench.frame_cfg(scene, 16, 16)
    params = bench.default_params(device="cpu")
    tm = bench.default_tonemap(device="cpu")
    _, _, first, window, frame_ms, _ = bench.time_frames(
        cfg, scene, cam, params, tm, torch.device("cpu"), 2, 4)
    assert events == ["frame", "sync", "frame", "sync"] + ["frame"] * 4 + [
        "sync"]
    assert first > 0 and len(frame_ms) == 4 and min(frame_ms) > 0
    assert sum(frame_ms) <= window


def test_bench_modeled_count():
    assert bench.modeled_rays(1920, 1080, 4) == 6_480_000
    assert bench.metric_name(1080) == "restir_di_gi_denoise_1080p_ms"


def test_bench_raycount_off_is_modeled(monkeypatch):
    monkeypatch.setenv("EIDOLA_BENCH_RAYCOUNT", "0")
    rc, _, objs = _run(SMALL[:-1] + ["1"])
    assert rc == 0 and len(objs) == 1
    out = objs[0]
    assert out["mrays_method"] == "modeled"
    assert out["rays_per_frame"] == bench.modeled_rays(32, 32, 4)


def test_bench_breakdown_by_ablation(monkeypatch):
    """EIDOLA_BENCH_BREAKDOWN: bench.py's ablation, its three parts summing
    to the headline `value`."""
    monkeypatch.setenv("EIDOLA_BENCH_BREAKDOWN", "1")
    rc, _, objs = _run(SMALL[:-1] + ["1"])
    assert rc == 0 and len(objs) == 1
    out = objs[0]
    parts = out["breakdown_ms"]
    assert set(parts) == {"direct", "indirect", "denoise_compose"}
    assert parts["direct"] > 0
    assert sum(parts.values()) == pytest.approx(out["value"])


def test_bench_breakdown_parts_are_windows(monkeypatch):
    """Each ablated config is timed as a window, as the headline is: its
    part is a window's ms over its frames, not a median of frames."""
    windows = []
    real = bench.time_frames

    def spy(cfg, *args):
        got = real(cfg, *args)
        windows.append((cfg, got[3], got[4]))
        return got

    monkeypatch.setattr(bench, "time_frames", spy)
    monkeypatch.setenv("EIDOLA_BENCH_BREAKDOWN", "1")
    iters = 3
    rc, _, objs = _run(SMALL)
    assert rc == 0 and len(objs) == 1
    out, parts = objs[0], objs[0]["breakdown_ms"]
    (full, w_full, f_full), (no_dn, w_no_dn, _), (di, w_di, _) = windows
    assert (full.denoise, no_dn.denoise, no_dn.indirect_enabled) == (
        True, False, True)
    assert (di.denoise, di.indirect_enabled) == (False, False)
    assert out["value"] == w_full / iters
    assert out["frames"]["frame_ms"] == f_full
    assert parts["direct"] == w_di / iters
    assert parts["indirect"] == w_no_dn / iters - w_di / iters
    assert parts["denoise_compose"] == w_full / iters - w_no_dn / iters


def test_bench_golden_check(small, tmp_path, monkeypatch):
    out = small[2][0]
    assert out["golden_mean_abs"] < 0.02 and out["correct"] is True
    shifted = tmp_path / "shifted.npy"
    np.save(shifted, np.load(bench.GOLDEN) + np.float32(0.05))
    monkeypatch.setattr(bench, "GOLDEN", str(shifted))
    rc, lines, objs = _run(SMALL)
    assert rc == 1 and len(objs) == 1 and json.loads(lines[-1]) == objs[0]
    bad = objs[0]
    assert bad["correct"] is False and bad["value"] == -1
    assert bad["golden_mean_abs"] == pytest.approx(0.05, abs=0.02)
    assert "frames" not in bad and "error" in bad


def test_bench_frame_summary():
    samples = np.random.default_rng(3).permutation(np.arange(1.0, 41.0))
    s = bench.summarize(samples)
    assert s["n"] == 40 and s["median"] == 20.5
    assert s["tail_pct"] == 75.0
    assert s["tail_ms"] == s["p75"] == np.percentile(np.arange(1.0, 41.0), 75)
    assert (s["min"], s["max"], s["mean"]) == (1.0, 40.0, 20.5)
    ten = bench.summarize(samples[:10])
    assert ten["n"] == 10 and ten["tail_pct"] is None and \
        ten["tail_ms"] is None
    eleven = bench.summarize(samples[:11])
    assert eleven["tail_pct"] == pytest.approx(100.0 / 11)


def test_bench_without_a_card_renders_nothing(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def no_render(*args, **kw):
        raise AssertionError("the bench rendered without a card")

    monkeypatch.setattr(bench, "load_scene", no_render)
    monkeypatch.setattr(bench, "measure", no_render)
    rc, lines, objs = _run(["--device", "cuda"])
    assert rc == 1 and len(objs) == 1 and json.loads(lines[-1]) == objs[0]
    assert objs[0]["value"] == -1 and objs[0]["error"]
    assert objs[0]["metric"] == "restir_di_gi_denoise_1080p_ms"


def test_bench_card_readout_needs_nvidia_smi(monkeypatch):
    assert bench.parse_power_limit("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0

    def smi_fails(*args, **kw):
        raise subprocess.CalledProcessError(9, args[0])

    monkeypatch.setattr(bench.subprocess, "run", smi_fails)
    with pytest.raises(subprocess.CalledProcessError):
        bench.card(torch.device("cuda:0"))


def test_bench_launch_check():
    walk = {"walk_closest": 75.0, "walk_any": 5.0, "mt_fused": 0.0,
            "mt_any_fused": 0.0, "mt_mxu": 0.0}
    bench._check_launches("pallas", walk)
    for drain in bench.DRAINS + bench.MXU:
        with pytest.raises(RuntimeError):
            bench._check_launches("pallas", dict(walk, **{drain: 1.0}))
    with pytest.raises(RuntimeError):
        bench._check_launches("pallas", dict(walk, walk_closest=0.0,
                                             walk_any=0.0))
    with pytest.raises(RuntimeError):
        bench._check_launches("xla", walk)


def test_bench_ray_count_failure_raises():
    """A counted frame whose ledger stays empty ends the bench: no
    fallback to the modeled count."""
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="counted no rays"):
        bench.count_rays(lambda *a: None, None, None, None, None, None, cpu)
    assert os.path.isabs(bench.GOLDEN) and os.path.isfile(bench.GOLDEN)
