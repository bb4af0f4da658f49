"""One run of one cell of BENCHMARK.json on the program eidola_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

loads the cell's scene through the program, warms up on the cell's own
frames, renders the traffic mix's frames for --seconds seconds (the
window), checks the window's last frame against the plain reference
(check.py) and prints, last on standard output, one JSON line: `correct`,
`attempted` (frames in the window), `failed`, `metrics` (the cell's
end-to-end metrics; with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `check`: each number compared with
its limit, also printed as the last lines of standard error.

End-to-end metrics: frame_ms (the window's host-clock length over its
frames, one synchronize on each side), frame_ms_p90 (the 90th percentile
of the frames' times between CUDA events at the frame boundaries) and
setup_s (process start to the window's start: imports, the kernels'
load from the build cache, the scene's load with its host BVH builds,
the warm-up frames).

It needs as many CUDA cards as the cell asks for: without them it prints
no result and exits 2.  It exits 3, with no result, when a module of JAX
or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, manifest, stats, tracing  # noqa: E402
from benchmark.frames import Frames  # noqa: E402

# top-level module names that no run may hold (the JAX package's name is
# a prefix of the program's: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "eidola_tpu")
# the build caches of torch and triton, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}
CACHE_ROOT = os.path.join(ROOT, "benchmark", "_cache")
END_TO_END = ("frame_ms", "frame_ms_p90", "setup_s")
STAGE_S = 10.0      # seconds of frames with the stage spans, after the check
TRACE_S = 8.0       # seconds of profiled frames after those


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_caches() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(CACHE_ROOT, sub)


def power_limit() -> str | None:
    """nvidia-smi's "name, power limit" of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def end_to_end(cell, window, setup_s: float, device) -> dict:
    """The cell's end-to-end metrics; a device-timed one only on a card."""
    values = {"frame_ms": stats.frame_ms(window.window_s, window.frames),
              "frame_ms_p90": stats.percentile(window.frame_ms, stats.P90),
              "setup_s": setup_s}
    out = {}
    for m in cell.end_to_end:
        if m["name"] not in values:
            raise KeyError(f"end-to-end metric {m['name']!r}: the harness "
                           f"takes only {END_TO_END}")
        if m["source"] == "device_trace" and device.type != "cuda":
            continue
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(cell, trace, device) -> dict:
    out = {}
    for m in cell.per_layer:
        if m["source"] == "device_trace" and device.type != "cuda":
            continue
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float | None = None) -> dict:
    """Run `cell` once on `device`; the result dict of the JSON line.
    On a device that is not CUDA (the tests) no device metric is given.

    The window and the check of its last frame run alike with and without
    `trace`.  A traced run then renders more frames for the per-layer
    metrics (traced()): profiling the window itself would slow its
    host-bound frames by a third, and its ~2M device operations take
    35-55 s to read."""
    import torch

    t_start = T_START if t_start is None else t_start
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_load = time.perf_counter()
    frames = Frames(cell.config, cell.traffic, seed, device)
    frames.sync()
    t_warm = time.perf_counter()
    frames.warm(int(cell.traffic["warmup_frames"]))
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.4f}: start to load {t_load - t_start:.2f} s, "
        f"load {t_warm - t_load:.2f} s, warm-up "
        f"{t_start + setup_s - t_warm:.2f} s")

    window = frames.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    log(f"window: {window.frames} frames in {window.window_s:.4f} s, "
        f"frame_ms {stats.frame_ms(window.window_s, window.frames):.4f}; "
        f"median ms of the first ten frames "
        f"{stats.percentile(window.frame_ms[:10], 50):.4f}, of the last ten "
        f"{stats.percentile(window.frame_ms[-10:], 50):.4f}")
    result = {"attempted": window.frames, "peak": peak,
              "metrics": end_to_end(cell, window, setup_s, device)}

    # the check, of the window's last frame; then the traced frames.  The
    # collector stays off: its full passes over the trace's records cost
    # seconds and free nothing (tensors go by reference count)
    with collector_paused():
        from benchmark.reference import Reference

        t0 = time.perf_counter()
        index = frames.index - 1
        rec = check.record(frames.step, frames.scene, frames.cam,
                           frames.params, frames.tm, frames.prev, seed,
                           int(cell.workload["check"]["rays_per_call"]))
        t1 = time.perf_counter()
        ref = Reference(cell.config, cell.traffic, seed, device)
        t2 = time.perf_counter()
        values = check.compare(ref, rec, frames.out, frames.state,
                               frames.prev, index)
        correct, rows = check.judge(values, cell.workload["limits"])
        del ref, rec
        log(f"check of frame {index}: the frame again {t1 - t0:.1f} s, "
            f"the reference's scene {t2 - t1:.1f} s, its answers "
            f"{time.perf_counter() - t2:.1f} s")
        result.update(correct=correct, failed=0 if correct else 1, check=rows)
        if trace:
            result.update(traced(cell, frames, device, peak,
                                 window.window_s / window.frames))
    log(f"run: {time.perf_counter() - t_start:.1f} s to the result")
    return result


def traced(cell, frames, device, peak, frame_s: float) -> dict:
    """The per-layer metrics, `trace` (busy_s, window_s) and `breakdown`:
    STAGE_S seconds of frames with the step's StageTimer and no profiler
    (the stage spans), then TRACE_S seconds under a CUDA-only profile
    (kernels, walk time, the idle share), then the walk and host frames
    of tracing.py.  Each stretch's frame time is logged beside the
    window's, so what the instruments cost shows."""
    from eidola_tpu_torch.utils.profiler import StageTimer

    cuda = device.type == "cuda"
    frames.timer = StageTimer(device)
    staged = frames.window(STAGE_S)
    stages = frames.timer.summary()
    frames.timer = None
    log(f"stage spans: {staged.frames} frames in {staged.window_s:.4f} s, "
        f"frame_ms {stats.frame_ms(staged.window_s, staged.frames):.4f}")
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(tracing.device_profile()) if cuda \
            else None
        frames.sync()             # the profiler's start stays outside
        window = frames.window(TRACE_S)
    log(f"profiled: {window.frames} frames in {window.window_s:.4f} s, "
        f"frame_ms {stats.frame_ms(window.window_s, window.frames):.4f}")
    events = [] if prof is None else tracing.device_events(prof)
    busy = tracing.busy_s(events)
    walks = tracing.walk_launches(frames, tracing.EXTRA_FRAMES) if cuda \
        else []
    if walks:
        log(f"walk frames (a stats buffer each launch): walk kernels "
            f"{sum(ms for _, ms in walks) / tracing.EXTRA_FRAMES:.4f} ms "
            f"a frame")
    gaps = tracing.host_gaps(frames, tracing.EXTRA_FRAMES) if cuda else []
    t = tracing.Trace(frames=window.frames, window_s=window.window_s,
                      events=events, busy_s=busy, stages=stages,
                      stage_frames=staged.frames, frame_s=frame_s,
                      walks=walks, peak_bytes=peak or 0)
    out = {"metrics": per_layer(cell, t, device),
           "trace": {"busy_s": busy, "window_s": window.window_s}}
    if cuda:
        out["breakdown"] = {"device_ops": tracing.top_ops(events),
                            "idle_gaps": gaps}
    return out


class ForbiddenModules(RuntimeError):
    pass


@contextlib.contextmanager
def collector_paused():
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="benchmark/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cell = manifest.load_cell(args.workload)
    set_caches()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is false): "
            "nothing run")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} found: nothing run")
        return 2
    device = torch.device("cuda", 0)
    try:
        result = measure(cell, args.seed, args.seconds, bool(args.trace),
                         device)
    except ForbiddenModules as e:
        log(f"modules of JAX or the JAX package are loaded: {e.args[0]}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    smi = power_limit()        # read after the window: not set-up
    log(f"card: {smi or torch.cuda.get_device_name(0)}")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": result["peak"]}
    if args.trace:
        dev.update(result["trace"])
    if smi:
        dev["nvidia_smi"] = smi
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": dev}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["check"] = result["check"]
    for name, row in result["check"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
