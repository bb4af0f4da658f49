"""A cell, a traffic mix and a per-layer metric added as files only, in a
copy of the benchmark, run with no edit of its code: the orbit mix (the
viewer's traffic, with a closed loop) on a 2 x 2 lot standin at 32x32 on
the CPU, through the harness's own measure()."""
from benchmark.check import NUMBERS

from .conftest import run_copy


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
