#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device.  It
imports nothing of JAX and nothing of the JAX package's device code, and
in order:

1. prints the card's name and power limit (nvidia-smi) and the torch and
   CUDA versions;
2. builds the CUDA source of the drains (csrc/bvh_fused.cu) with nvcc and
   prints the build seconds;
3. slice phase: renders 4 frames of bistro_flat at 1920x1080 through the
   port's headless entry point (direct lighting: --no-denoise
   --no-indirect), with every kernel's launch count set to 0 just before
   and read just after; checks the image, the accumulation count and
   that each kernel was launched, and keeps the arguments of each
   kernel's largest drain of the run;
4. kernel phase: each kernel on those arguments (the frame's own shapes:
   leaf 64, the full bistro table, one launch per drain) against its
   plain torch version on the card — bitwise — with both times from CUDA
   events; then the same on a synthetic 4096-event case with an invalid
   tail and exact-t ties, which the frame's drains do not hold;
5. holds small frames on the card against the same frames through the
   plain versions on the CPU (cornell 32x32, stress 64x64);
6. prints one JSON line of per-kernel launches, errors and times (those
   of the largest frame drain), then, last, {"ok": true, "device": {...}}.

Any failed phase exits non-zero before the last line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SLICE_ARGS = ["--scene", "bistro_flat", "--size", "1920", "1080",
              "--frames", "4", "--no-denoise", "--no-indirect",
              "--device", "cuda", "--quiet"]
KERNELS = {
    "mt_fused": "eidola_tpu/ops/bvh_fused.py:148",
    "mt_any_fused": "eidola_tpu/ops/bvh_fused.py:254",
}
SOURCE = "eidola_tpu_torch/csrc/bvh_fused.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


class DrainCapture:
    """While active, records the event count of every drain call and keeps
    the arguments of each kernel's largest call.  The wrapper itself still
    runs and counts its launch (ops/bvh.py looks the wrappers up on the
    module at each call); this only watches."""

    def __init__(self, module):
        self.module = module
        self.sizes = {k: [] for k in KERNELS}
        self.args = {}

    def __enter__(self):
        self.orig = {k: getattr(self.module, k) for k in KERNELS}
        for k, fn in self.orig.items():
            setattr(self.module, k, self._watch(k, fn))
        return self

    def _watch(self, name, fn):
        def call(*args):
            ce = args[-2].shape[0]             # gtb: (CE, 128)
            if ce > max(self.sizes[name], default=0):
                self.args[name] = args
            self.sizes[name].append(ce)
            return fn(*args)
        return call

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.module, k, fn)


def check_kernel(name: str, args: tuple, label: str) -> dict:
    """The CUDA kernel against its plain version on the same tensors:
    bitwise, then both times from CUDA events."""
    import torch

    from eidola_tpu_torch.ops import bvh_fused as F

    kern, ref = getattr(F, name), getattr(F, name + "_ref")
    got = kern(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                fin = torch.isfinite(g) & torch.isfinite(w)
                err = max(err, float((g - w)[fin].abs().max()), 1e-30)
        elif not torch.equal(g, w):
            err = max(err, float((g - w).abs().max()))
    if err != 0.0:
        fail(f"{name} ({label}): CUDA kernel differs from its plain version "
             f"(max abs err {err}); the tolerance is bitwise")
    gtb = args[-2]
    hits = float((got[0] < gtb).float().mean()) if name == "mt_fused" else \
        float(got[0].float().mean())
    ms = time_ms(lambda: kern(*args), 20)
    plain_ms = time_ms(lambda: ref(*args), 3)
    print(f"{name} ({label}): {gtb.shape[0]} events x 128 lanes, leaf "
          f"{args[-1]}, {args[0].shape[0]}-leaf table; bitwise equal to "
          f"plain; hit lanes {hits:.3f}; cuda {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(captured: dict) -> dict:
    """Each kernel on the arguments of the largest drain the frame gave it."""
    return {name: check_kernel(name, captured[name], "largest frame drain")
            for name in KERNELS}


def synthetic_phase(dev) -> None:
    """An extra case the frame does not give: runs of 1-32 events of random
    sub-packets with an invalid tail and exact-t ties (utils/drain_case)."""
    from eidola_tpu_torch.utils.drain_case import (make_case, random_runs,
                                                   torch_args)

    n, ce, leaves = 64, 4096, 45056
    case = make_case(n, leaves, random_runs(ce - 96, 32, 1), ce, seed=2,
                     spread=60.0)
    for name in KERNELS:
        args = (*torch_args(case, dev, name == "mt_fused"), n)
        check_kernel(name, args, f"synthetic, {ce - case['n_valid']} "
                                 "invalid tail rows")
        del args


def slice_phase() -> tuple[dict, dict]:
    import numpy as np
    import torch

    from eidola_tpu_torch.app import headless
    from eidola_tpu_torch.ops import bvh_fused as F

    with DrainCapture(F) as cap:
        F.reset_launches()
        res = headless.run(SLICE_ARGS)
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)

    bvh = res["scene"].bvh
    print(f"bistro_flat: {res['n_tris']} triangles, {res['n_leaves']} "
          f"leaves of {bvh.leaf_size}, coefficient table "
          f"{bvh.leaf_cmat.numel() * 4 / 2**20:.0f} MiB; scene+BVH built "
          f"in {res['load_s']:.1f}s", flush=True)
    img = res["image"]
    state = res["state"]
    if img.shape != (1080, 1920, 3):
        fail(f"image shape {img.shape}")
    if not np.isfinite(img).all() or img.min() < 0.0 or img.max() > 1.0:
        fail("image not finite in [0, 1]")
    if img.mean() < 0.02:
        fail(f"image is black (mean {img.mean():.4f})")
    if float(state.accum_count) != 4.0:
        fail(f"accum_count {float(state.accum_count)} != 4")
    for name, count in launches.items():
        if count <= 0 or name not in cap.args:
            fail(f"{name} was never launched on the main path")
    print(f"slice: {res['ms_per_frame']:.1f} ms/frame over frames 2-4 "
          "(frames "
          + ", ".join(f"{m:.1f}" for m in res["frame_ms"]) + " ms); stages "
          + json.dumps({k: round(v, 3)
                        for k, v in res["stage_ms_per_frame"].items()})
          + f"; image mean {img.mean():.4f}; launches {launches}",
          flush=True)
    for name, sizes in cap.sizes.items():
        print(f"{name} drains per launch (events): {sizes}", flush=True)
    del res
    return launches, cap.args


def reference_phase() -> None:
    """Small frames on the card (kernels, leaf 64) against the same frames
    on the CPU (plain versions, leaf 8): only exact-t ties may differ."""
    import numpy as np

    from eidola_tpu_torch.app import headless

    for scene, size in (("cornell", "32"), ("stress", "64")):
        common = ["--scene", scene, "--size", size, size, "--frames", "3",
                  "--no-denoise", "--no-indirect", "--quiet"]
        gpu = headless.run(common + ["--device", "cuda"])["image"]
        cpu = headless.run(common + ["--device", "cpu"])["image"]
        diff = float(np.abs(gpu - cpu).mean())
        print(f"reference: {scene} {size}x{size}, CUDA vs CPU mean abs diff "
              f"{diff:.2e}", flush=True)
        if not diff <= 2e-3:
            fail(f"{scene} CUDA vs CPU mean abs diff {diff} > 2e-3")


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "eidola_tpu_torch")):
        fail("run from the root of a checkout: eidola_tpu_torch/ is missing")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from eidola_tpu_torch.app.headless import set_numerics
    from eidola_tpu_torch.ops import bvh_fused

    set_numerics()
    t0 = time.perf_counter()
    bvh_fused._lib()
    print(f"build: csrc/bvh_fused.cu in {time.perf_counter() - t0:.1f}s",
          flush=True)

    launches, captured = slice_phase()
    times = kernel_phase(captured)
    del captured
    torch.cuda.empty_cache()
    synthetic_phase(torch.device("cuda"))
    reference_phase()

    line = {"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
         "launches": launches[k], **times[k]} for k in KERNELS]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
