"""Headline benchmark of the port (counterpart of the repo's bench.py).

    python -m eidola_tpu_torch.bench
    EIDOLA_BENCH_SCENE=bistro_flat python -m eidola_tpu_torch.bench

renders the default frame (ReSTIR DI + GI, a-trous denoise; max_depth 4,
the alpha HitTest on when the scene has an alpha-tested material, the
.hdr environment when it has one) of EIDOLA_BENCH_SCENE (bistro_standin
by default; bistro_flat, bistro_hdr, stress with n=16, or any registry
name) at 1920x1080 on one CUDA card, and prints, last, one JSON line.
In order:

1. the card: its name and count from torch, its power limit from
   `nvidia-smi` (a failure of nvidia-smi fails the bench).  With no card
   the line has "value": -1 and an "error", nothing is rendered, and the
   exit code is 1; nothing falls back to the CPU.  `--device cpu` is for
   the tests: its line says "platform": "cpu" and holds no device metric
   (peak memory and power limit are null);
2. the scene load, synced, as `load_s` (it carries the g++ build of the
   port's native scene builders when `_build/` is empty);
3. correctness before timing: the golden config (cornell 64x64,
   max_depth 2, traversal_max_steps 1024, 4 frames) on the same device
   against tests/golden/cornell_64_d2_f4.npy, mean abs below 0.02
   (`golden_mean_abs`, `correct`); on a failure the line is printed and
   the exit code is 1.  Its seconds, `golden_s`, are setup: they carry
   the nvcc build of the kernels the frame launches when `_build/` is
   empty;
4. timing, tracing off: `--warmup` frames (the first, synced on its
   own as `first_frame_ms`, carries the CUDA context's and the
   allocator's first use at the frame's size and is setup, never in
   `value`); the last warm-up frame's linear HDR (frame 1 at the
   default `--warmup` 2) is then held, after the warm-up's sync and
   before the window, against the JAX package's frame of the same
   scene, config and frame index stored in tests/golden_torch/, rendered
   under the alpha march the frame runs (`alpha_march`: queue on the
   card, lockstep on the CPU, or EIDOLA_ALPHA_MARCH; null for a scene
   with no alpha-tested material, which runs no march)
   (utils/reference.py: mean abs on a stride-4 lattice and of the 8x8
   block means, each below 0.02; the max of the block means and its
   block are reported): `reference_file`, `reference_frame`,
   `reference_mean_abs`,
   `reference_block_mean_abs`, `reference_block_max` (and `_at`).  A
   miss prints the line with "value": -1 and an "error", times
   nothing and exits 1; a scene, size or warm-up with no stored
   reference gives null fields and nothing in its place.  Then
   `--iters` frames timed as one window, as bench.py
   times its frames: one torch.cuda.synchronize() and the host clock
   before the window, the frames enqueued with no host sync between
   them, one synchronize() after it.  `value` is the window's ms over
   its frames (`frames["window_ms"]` / `--iters`), so the host may
   dispatch frame k+1 while the card finishes frame k.  The queue
   march's syncs inside a frame (once a lap) stay: they are the frame's.
   After the window's closing sync, outside `value`, the window's last
   frame (frame warmup + iters - 1, 41 by default) is held against the
   JAX package's frame of the same index where one is stored (at
   1920x1080: bistro_flat and stress, `<scene>_1920x1080_d4_f41.npz`),
   at the same bound: `reference_last_frame`, `reference_last_file`,
   `reference_last_mean_abs`, `reference_last_block_mean_abs`,
   `reference_last_block_max` (and `_at`).  Not against frame 1's file:
   the accumulated frame's expectation, not only its noise, moves with
   the temporal history, in the JAX package as in the port (at 272x136
   JAX's frame 41 stands 0.023 mean abs from its frame 3, and the
   port's frame 41 2e-7 from JAX's), so on an H100 frame 41 stands
   0.02-0.05 from frame 1's file on all four scenes with no fault.
   The alpha scenes' frame 41 is not stored (~5 h of JAX on a CPU a
   scene); their fields are null.  A miss prints the line with
   "value": -1, the readings and an "error", and exits 1, as a frame-1
   miss does.
   The spread comes from a CUDA event recorded at each frame boundary
   inside the window, read after the final sync: device time between
   two boundaries, idle gaps included (on the CPU, which runs
   synchronously, the host clock at each boundary).  `frames` holds the
   window's ms and, over those per-frame times, n, median, mean, min,
   max, p25, p75, the tail (the highest percentile with at least ten
   frames beyond it, null under 11 frames) and every frame's ms.  Also
   the walk and drain kernels' launches per timed frame (ops/bvh_walk.py,
   bvh_fused.py, bvh_mxu.py counters, read before and after the window
   and never set to 0 here; on the card's default traversal, walks and
   no drain, else the bench fails) and the peak memory allocated since
   the load;
5. per layer, in frames of their own after the timed ones: the stage
   split (4 frames under utils/profiler.StageTimer), the rays
   (one steady frame under EIDOLA_COUNT_RAYS=1: sum(ops/packets.
   RAY_LEDGER), "measured"; EIDOLA_BENCH_RAYCOUNT=0 gives bench.py's
   modeled count instead; a count of 0 fails the bench) and, with
   EIDOLA_BENCH_BREAKDOWN set, `breakdown_ms` by ablation (direct,
   indirect, denoise_compose), each config timed as a window as in 4.

`metric` stays fixed (restir_di_gi_denoise_1080p_ms at 1920x1080, the
height in the name at another size); the triangle count and the card
are fields of their own.  `vs_baseline` is 18.2 ms (the reference's
frame on Bistro Exterior, BASELINE.md) over `value`, and `mrays_per_s`
the counted rays over `value`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .app.headless import _sync, alpha_geometry, set_numerics
from .models.scenes import load_scene
from .ops import bvh_fused, bvh_mxu, bvh_walk
from .ops import packets
from .ops.packets import resolve_trav
from .render.config import RenderConfig, default_params, default_tonemap
from .render.frame import init_frame_state, make_step
from .render.tracer import _march_mode
from .utils import reference
from .utils.profiler import MilliTimer, StageTimer

BASELINE_MS = 18.2
W, H = 1920, 1080
WARMUP = 2
ITERS = 40
STAGE_FRAMES = 4
UNIT = "ms/frame"
TAIL_BEYOND = 10          # frames a reported tail percentile leaves above it
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "cornell_64_d2_f4.npy")
GOLDEN_BOUND = 0.02       # mean abs, tests/test_golden.py's bound
WALKS = ("walk_closest", "walk_any")
READINGS = ("mean_abs", "block_mean_abs", "block_max", "block_max_at")
DRAINS = ("mt_fused", "mt_any_fused")
MXU = ("mt_mxu",)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eidola_tpu_torch.bench",
        description="the port's headline frame benchmark (one JSON line)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu only for the tests")
    p.add_argument("--scene", default=None,
                   help="overrides EIDOLA_BENCH_SCENE (default "
                        "bistro_standin)")
    p.add_argument("--size", type=int, nargs=2, default=[W, H],
                   metavar=("WIDTH", "HEIGHT"))
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--iters", type=int, default=ITERS)
    return p


def metric_name(height: int) -> str:
    return f"restir_di_gi_denoise_{height}p_ms"


def modeled_rays(width: int, height: int, max_depth: int) -> int:
    """bench.py's modeled rays a frame: 1 primary + 1 DI shadow a pixel;
    GI at a quarter of the pixels traces a bsdf ray, its NEE shadow and a
    continuation, plus the deep tiles' bounces."""
    n_pix = width * height
    n_half = n_pix // 4
    deep = (n_half // 4) * 2 * max(max_depth - 1, 0)
    return n_pix * 2 + n_half * 3 + deep


def summarize(ms) -> dict:
    """n, median, mean, min, max, p25, p75 and the tail: the highest
    percentile with TAIL_BEYOND samples beyond it (p75 at 40 samples),
    null under TAIL_BEYOND + 1 samples."""
    x = np.asarray(ms, dtype=np.float64)
    n = x.size
    tail = 100.0 * (n - TAIL_BEYOND) / n if n > TAIL_BEYOND else None
    return {"n": n, "median": float(np.median(x)), "mean": float(x.mean()),
            "min": float(x.min()), "max": float(x.max()),
            "p25": float(np.percentile(x, 25)),
            "p75": float(np.percentile(x, 75)),
            "tail_pct": tail,
            "tail_ms": None if tail is None else float(np.percentile(x, tail)),
            "frame_ms": [float(v) for v in x]}


def card(device: torch.device) -> dict:
    """{platform, name, power_limit_w, count} of `device`; on the card the
    power limit comes from nvidia-smi, whose failure raises."""
    if device.type != "cuda":
        return {"platform": device.type, "name": device.type,
                "power_limit_w": None, "count": 0}
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi = out.stdout.strip().splitlines()[idx]
    return {"platform": "gpu", "name": torch.cuda.get_device_name(idx),
            "power_limit_w": parse_power_limit(smi),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def parse_power_limit(smi_line: str) -> float:
    """"NVIDIA H100 80GB HBM3, 700.00 W" -> 700.0."""
    return float(smi_line.rsplit(",", 1)[1].strip().split()[0])


def reset_launches() -> None:
    for m in (bvh_fused, bvh_mxu, bvh_walk):
        m.reset_launches()


def read_launches() -> dict:
    out = {**bvh_walk.LAUNCHES, **bvh_fused.LAUNCHES, **bvh_mxu.LAUNCHES}
    out.update({f"{k}_instanced": v for k, v in bvh_walk.INST_LAUNCHES.items()})
    return out


def golden_error(device) -> float:
    """Mean abs of the golden config's linear HDR on `device` against the
    stored golden GOLDEN (inf on a shape mismatch or a non-finite
    image)."""
    cfg = RenderConfig(width=64, height=64, max_depth=2,
                       traversal_max_steps=1024, env_mode="sunsky")
    scene, cam = load_scene("cornell", device=device)
    params, tm = default_params(device=device), default_tonemap(device=device)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    for _ in range(4):
        state, out = step(scene, cam, params, tm, state)
    img = out["hdr"].cpu().numpy()
    ref = np.load(GOLDEN)
    if img.shape != ref.shape or not np.isfinite(img).all():
        return float("inf")
    return float(np.abs(img - ref).mean())


def frame_cfg(scene, width: int, height: int) -> RenderConfig:
    """bench.py's config: maxDepth 4, the .hdr env when the scene has one,
    the HitTest when it has an alpha-tested material."""
    return RenderConfig(width=width, height=height, max_depth=4,
                        env_mode="hdr" if scene.env is not None else "sunsky",
                        alpha_geometry=alpha_geometry(scene))


class ReferenceMiss(RuntimeError):
    """The last warm-up frame is past its reference's bound."""


def time_frames(cfg, scene, cam, params, tm, device, warmup: int,
                iters: int, check=None):
    """(state, outputs, first frame ms, window ms, the window's frames'
    ms, the window's launches by kernel): a fresh state, `warmup` frames
    (the first synced and timed alone), then `iters` frames timed as one
    window: a sync and the host clock before it, none inside it, a sync
    after it.  Each frame's ms is between two CUDA events recorded at the
    frame boundaries (on the CPU, two host clock readings).  `check`,
    when given, takes the last warm-up frame's outputs after the
    warm-up's sync and returns whether they hold; it is synced before
    the window, and a frame that does not hold raises ReferenceMiss
    with no frame timed."""
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    t0 = time.perf_counter()
    state, out = step(scene, cam, params, tm, state)
    _sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(warmup - 1):
        state, out = step(scene, cam, params, tm, state)
    _sync(device)
    if check is not None:
        held = check(out)
        _sync(device)
        if not held:
            raise ReferenceMiss("the last warm-up frame missed its "
                                "reference")
    before = read_launches()
    cuda = device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    t0 = time.perf_counter()
    marks = [mark()]
    for _ in range(iters):
        state, out = step(scene, cam, params, tm, state)
        marks.append(mark())
    _sync(device)
    window_ms = (time.perf_counter() - t0) * 1e3
    after = read_launches()
    frame_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
                for a, b in zip(marks, marks[1:])]
    return state, out, first_ms, window_ms, frame_ms, {
        k: after[k] - before[k] for k in after}


def _check_launches(trav: str, per_frame: dict) -> None:
    """On the card the default traversal launches the walk kernels and
    no drain; the torch walk (xla) launches drains and no walk."""
    walks = sum(per_frame[k] for k in WALKS)
    drains = sum(per_frame[k] for k in DRAINS + MXU)
    if trav == "pallas" and not (walks > 0 and drains == 0):
        raise RuntimeError(f"bench: the walk traversal launched {per_frame}")
    if trav == "xla" and not (walks == 0 and drains > 0):
        raise RuntimeError(f"bench: the torch walk launched {per_frame}")


def count_rays(step, scene, cam, params, tm, state, device) -> float:
    """Live rays of one steady frame by the ray ledger (its syncs stay
    out of the timed frames); raises when nothing was counted."""
    was = os.environ.get("EIDOLA_COUNT_RAYS")
    os.environ["EIDOLA_COUNT_RAYS"] = "1"
    try:
        packets.RAY_LEDGER.clear()
        packets.RAY_DOORS.clear()
        step(scene, cam, params, tm, state)
        _sync(device)
    finally:
        if was is None:
            os.environ.pop("EIDOLA_COUNT_RAYS")
        else:
            os.environ["EIDOLA_COUNT_RAYS"] = was
    rays = sum(packets.RAY_LEDGER)
    if not rays > 0:
        raise RuntimeError("bench: the ray ledger counted no rays")
    return rays


def measure(scene, cam, device, name: str, *, width: int = W,
            height: int = H, warmup: int = WARMUP, iters: int = ITERS,
            load_s=None) -> dict:
    """The bench on a loaded (scene, cam): the result dict of the JSON
    line.  Without `correct` the dict holds no timing."""
    device = torch.device(device)
    if iters < 1 or warmup < 1:
        raise ValueError("bench: warmup and iters must be >= 1")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = frame_cfg(scene, width, height)
    march = _march_mode(device)
    out = {"metric": metric_name(height), "unit": UNIT, "scene": name,
           "n_tris": int(scene.bvh.n_tris), "width": width, "height": height,
           "alpha_geometry": cfg.alpha_geometry,
           "alpha_march": march if cfg.alpha_geometry else None,
           "env_mode": cfg.env_mode,
           "device": card(device), "trav": resolve_trav(device),
           "load_s": load_s}
    t0 = time.perf_counter()
    err = golden_error(device)
    out.update(golden_s=time.perf_counter() - t0, golden_mean_abs=err,
               correct=err < GOLDEN_BOUND)
    if not out["correct"]:
        return dict(out, value=-1, vs_baseline=0.0,
                    error=f"golden mean abs {err} >= {GOLDEN_BOUND}: not "
                          f"timed")

    ref_frame, last_frame = warmup - 1, warmup + iters - 1
    path = reference.find(name, cfg, ref_frame, march)
    ref = None if path is None else reference.load(path)
    last_path = reference.find(name, cfg, last_frame, march)
    held, last = dict.fromkeys(READINGS), dict.fromkeys(READINGS)

    def check(outputs):
        held.update(reference.compare(outputs["hdr"], ref))
        return held["ok"]

    params, tm = default_params(device=device), default_tonemap(device=device)
    try:
        state, outputs, first_ms, window_ms, frame_ms, launches = \
            time_frames(cfg, scene, cam, params, tm, device, warmup, iters,
                        None if ref is None else check)
    except ReferenceMiss:
        out["correct"] = False
    else:
        if last_path is not None:   # after the window's sync: not in value
            last.update(reference.compare(outputs["hdr"],
                                          reference.load(last_path)))
    if "ok" not in last:
        last_path = None

    def rel(p):
        return None if p is None else os.path.relpath(p, reference.ROOT)

    out.update(reference_frame=None if ref is None else ref_frame,
               reference_file=rel(path),
               **{"reference_" + k: held[k] for k in READINGS},
               reference_last_frame=None if last_path is None else last_frame,
               reference_last_file=rel(last_path),
               **{"reference_last_" + k: last[k] for k in READINGS})
    if not out["correct"]:
        return dict(out, value=-1, vs_baseline=0.0,
                    error=f"frame {ref_frame} against {out['reference_file']}"
                          f": lattice mean abs {held['mean_abs']}, block "
                          f"means mean abs {held['block_mean_abs']} (bound "
                          f"{reference.BOUND}): not timed")
    if last.get("ok") is False:
        return dict(out, correct=False, value=-1, vs_baseline=0.0,
                    error=f"frame {last_frame}, the window's last, against "
                          f"{out['reference_last_file']}: lattice mean abs "
                          f"{last['mean_abs']}, block means mean abs "
                          f"{last['block_mean_abs']} (bound "
                          f"{reference.BOUND})")
    per_frame = {k: v / iters for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    finite = bool(torch.isfinite(outputs["image"]).all())
    frames = dict(summarize(frame_ms), window_ms=window_ms)
    ms = window_ms / iters
    if cuda:
        _check_launches(out["trav"], per_frame)

    step = make_step(cfg)
    timer = StageTimer(device)
    for _ in range(STAGE_FRAMES):
        state, _ = step(scene, cam, params, tm, state, timer=timer)
    stage_ms = {k: v / STAGE_FRAMES for k, v in timer.summary().items()}

    if os.environ.get("EIDOLA_BENCH_RAYCOUNT", "1") == "1":
        rays = count_rays(step, scene, cam, params, tm, state, device)
        method = "measured: live-lane traversal counters"
    else:
        rays = modeled_rays(width, height, cfg.max_depth)
        method = "modeled"

    out.update(
        value=ms, vs_baseline=BASELINE_MS / ms,
        mrays_per_s=rays / ms / 1e3, mrays_method=method,
        rays_per_frame=rays, correct=out["correct"] and finite,
        image_finite=finite, first_frame_ms=first_ms, frames=frames,
        peak_mem_gib=peak, launches_per_frame=per_frame,
        stage_frames=STAGE_FRAMES, stage_ms=stage_ms)
    if os.environ.get("EIDOLA_BENCH_BREAKDOWN"):
        def window(c):
            return time_frames(c, scene, cam, params, tm, device, warmup,
                               iters)[3] / iters

        no_dn = window(dataclasses.replace(cfg, denoise=False))
        di_only = window(dataclasses.replace(cfg, denoise=False,
                                             indirect_enabled=False))
        out["breakdown_ms"] = {"direct": di_only, "indirect": no_dn - di_only,
                               "denoise_compose": ms - no_dn}
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    width, height = args.size
    if device.type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({
            "metric": metric_name(height), "value": -1, "unit": UNIT,
            "vs_baseline": 0.0,
            "error": "no CUDA device (torch.cuda.is_available() is false): "
                     "nothing rendered, no measurement"}), flush=True)
        return 1
    name = args.scene or os.environ.get("EIDOLA_BENCH_SCENE",
                                        "bistro_standin")
    set_numerics()
    load = MilliTimer()
    scene, cam = load_scene(name, device=device, **(
        {"n": 16} if name == "stress" else {}))
    _sync(device)
    load_s = load.ms() / 1e3
    result = measure(scene, cam, device, name, width=width, height=height,
                     warmup=args.warmup, iters=args.iters, load_s=load_s)
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
