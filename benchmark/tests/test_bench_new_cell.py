"""A cell, a configuration, a per-layer metric and a scene of the
reference added as files only, in a copy of the benchmark, run with no
edit of its code: the orbit mix (the viewer's traffic, with a closed
loop) on a 2 x 2 lot standin and on the `alpha` scene at 32x32 on the
CPU, through the harness's own measure() and calibrate.py."""
import json
import os
import subprocess
import sys

from benchmark import manifest
from benchmark.check import NUMBERS

from .conftest import REPO, run_copy


def test_new_cell_runs_from_files_only(bench_copy):
    got = run_copy(bench_copy, "standin_orbit_tiny", trace=False)
    r = got["result"]
    assert r["correct"] is True, r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["check"]) == set(NUMBERS)
    # on the CPU no metric read from the device: frame_ms_p90 (CUDA
    # events) and the peak memory are left out
    assert set(r["metrics"]) == {"frame_ms", "setup_s"}
    assert r["peak"] is None


def test_new_metric_is_read_in_a_traced_run(bench_copy):
    r = run_copy(bench_copy, "standin_orbit_tiny", trace=True)["result"]
    assert r["correct"] is True, r["check"]
    # program spans are read on any device, device-trace metrics only on
    # a card
    assert set(r["metrics"]) == {"compose_ms", "direct_ms", "indirect_ms",
                                 "denoise_ms"}
    assert r["metrics"]["compose_ms"]["value"] > 0


def test_new_scene_of_the_reference_runs_from_files_only(bench_copy):
    # reference/scenes/alpha.py and a configuration naming `alpha`: no
    # file of the harness's code changed
    r = run_copy(bench_copy, "alpha_orbit_tiny")["result"]
    assert r["correct"] is True, r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["check"]) == set(NUMBERS)


def test_orbit_mix_calibrates_on_cpu(bench_copy):
    """calibrate.py of the orbit mix: its readings line, every program
    reading under the tiny cell's limits and under those of the orbit
    cell at full size, every control reading over the tiny cell's."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    done = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload",
         "standin_orbit_tiny", "--seeds", f"{2**31 + 11},{2**31 + 12}",
         "--control-seeds", f"{2**31 + 11}", "--frames", "5",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=str(bench_copy),
        env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = [json.loads(x) for x in done.stdout.strip().splitlines()]
    programs = [x for x in lines if x.get("kind") == "program"]
    assert [x["frame"] for x in programs] == [6, 6]
    summary = lines[-1]
    assert summary["workload"] == "standin_orbit_tiny"
    assert set(summary["lower"]) == set(summary["upper"]) == set(NUMBERS)
    tiny = manifest.load_cell("standin_orbit_tiny", root=str(bench_copy))
    full = manifest.load_cell("standin_orbit_1080p")
    for name in NUMBERS:
        for x in programs:
            assert x[name] <= tiny.workload["limits"][name], (name, x)
            assert x[name] <= full.workload["limits"][name], (name, x)
        assert summary["upper"][name] > tiny.workload["limits"][name], name
