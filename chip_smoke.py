#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device.  It
imports nothing of JAX and nothing of the JAX package, and in order:

1. prints the card's name and power limit (nvidia-smi) and the torch and
   CUDA versions;
2. builds every native source of the port at once, one compiler process
   each: csrc/bvh_fused.cu and csrc/bvh_walk.cu with nvcc, the C++ host
   builders (native/src/eidola_native.cpp) with g++;
3. DI phase: 2 frames of bistro_flat at 1920x1080 through the headless
   entry point with --no-denoise --no-indirect (the default traversal:
   torch walk + the fused drain kernels);
4. GI phase: the default frame (ReSTIR DI + GI, a-trous denoise) on
   bistro_flat at 1920x1080, 4 frames, with EIDOLA_TRAV=pallas: every
   ray goes through the one-kernel walk; prints ms/frame over frames 2-4
   and the stage split;
5. GI-xla phase: the same default frame under the default traversal at
   960x540, 2 frames, so the drain kernels run on sorted GI rays;
   each of phases 3-5 sets every launch count to 0 just before it and
   reads them just after, checks the image (shape, finite, in [0, 1],
   not black) and the accumulation count, that each kernel of its path
   was launched and that the kernels of the other traversal were not,
   and keeps the arguments of each kernel's largest call;
6. kernel phase: each kernel on those arguments (the frames' own shapes:
   leaf 64, the full bistro tables) against its plain torch version on
   the card, bitwise, with both times from CUDA events; the walk kernels
   also against walk_ref's per-packet step and event counts, which give
   their bound; plus the drain kernels on a synthetic case with an
   invalid tail and exact-t ties, which the frames do not hold;
7. goldens on the card: cornell, punctual, textured and hdr at 64x64,
   max_depth=2, traversal_max_steps=1024, 4 frames, through the walk
   kernel, each within 0.02 mean abs of tests/golden/*_64_d2_f4.npy;
8. holds small DI frames on the card against the same frames through
   the plain versions on the CPU (cornell 32x32, stress 64x64);
9. prints one JSON line of per-kernel launches, errors, times and
   bounds, then, last, {"ok": true, "device": {...}}.

Any failed phase exits non-zero before the last line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BISTRO = ["--scene", "bistro_flat", "--device", "cuda", "--quiet"]
DI_ARGS = BISTRO + ["--size", "1920", "1080", "--frames", "2",
                    "--no-denoise", "--no-indirect"]
GI_ARGS = BISTRO + ["--size", "1920", "1080", "--frames", "4"]
GI_XLA_ARGS = BISTRO + ["--size", "960", "540", "--frames", "2"]
FUSED_SRC = "eidola_tpu_torch/csrc/bvh_fused.cu"
WALK_SRC = "eidola_tpu_torch/csrc/bvh_walk.cu"
KERNELS = {   # name: (TPU kernel it replaces, source)
    "mt_fused": ("eidola_tpu/ops/bvh_fused.py:148", FUSED_SRC),
    "mt_any_fused": ("eidola_tpu/ops/bvh_fused.py:254", FUSED_SRC),
    "walk_closest": ("eidola_tpu/ops/bvh_pallas.py:43", WALK_SRC),
    "walk_any": ("eidola_tpu/ops/bvh_pallas.py:43", WALK_SRC),
}
DRAINS = ("mt_fused", "mt_any_fused")
WALKS = ("walk_closest", "walk_any")
# H100 SXM published peaks (dense f32 outside the tensor cores; HBM3)
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
GOLDENS = {"cornell": "sunsky", "hdr": "hdr", "punctual": "sunsky",
           "textured": "sunsky"}


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


def _launches() -> dict:
    from eidola_tpu_torch.ops import bvh_fused, bvh_walk

    return {**bvh_fused.LAUNCHES, **bvh_walk.LAUNCHES}


def _reset_launches() -> None:
    from eidola_tpu_torch.ops import bvh_fused, bvh_walk

    bvh_fused.reset_launches()
    bvh_walk.reset_launches()


class Capture:
    """While active, records the size of every call of the named wrappers
    of `module` and keeps the arguments of each one's largest call.  The
    wrapper itself still runs and counts its launch (its callers look it
    up on the module at each call); this only watches."""

    def __init__(self, module, names, size):
        self.module, self.names, self.size = module, names, size
        self.sizes = {k: [] for k in names}
        self.args = {}

    def __enter__(self):
        self.orig = {k: getattr(self.module, k) for k in self.names}
        for k, fn in self.orig.items():
            setattr(self.module, k, self._watch(k, fn))
        return self

    def _watch(self, name, fn):
        def call(*args, **kw):
            n = self.size(args)
            if n > max(self.sizes[name], default=0):
                self.args[name] = args
            self.sizes[name].append(n)
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.module, k, fn)


def drain_capture():
    from eidola_tpu_torch.ops import bvh_fused

    return Capture(bvh_fused, DRAINS, lambda a: a[-2].shape[0])  # gtb rows


def walk_capture():
    from eidola_tpu_torch.ops import bvh_walk

    return Capture(bvh_walk, WALKS, lambda a: a[2].shape[1])     # packets


def check_frame(res, shape, frames, label) -> None:
    import numpy as np

    img, state = res["image"], res["state"]
    if img.shape != shape:
        fail(f"{label}: image shape {img.shape} != {shape}")
    if not np.isfinite(img).all() or img.min() < 0.0 or img.max() > 1.0:
        fail(f"{label}: image not finite in [0, 1]")
    if img.mean() < 0.02:
        fail(f"{label}: image is black (mean {img.mean():.4f})")
    if float(state.accum_count) != float(frames):
        fail(f"{label}: accum_count {float(state.accum_count)} != {frames}")


def run_phase(label, argv, shape, frames, trav, capture, used, unused):
    """One main-path run through the headless entry point, its launch
    counts set to 0 just before and read just after; `capture` keeps the
    arguments of each watched kernel's largest call."""
    import torch

    from eidola_tpu_torch.app import headless
    from eidola_tpu_torch.ops import packets

    packets.TRAV = trav
    try:
        with capture:
            _reset_launches()
            res = headless.run(argv)
            torch.cuda.synchronize()
            launches = _launches()
    finally:
        packets.TRAV = "xla"
    check_frame(res, shape, frames, label)
    for name in used:
        if launches[name] <= 0 or name not in capture.args:
            fail(f"{label}: {name} was never launched on its path")
    for name in unused:
        if launches[name] != 0:
            fail(f"{label}: {name} was launched {launches[name]} times on "
                 f"a path that must not use it")
    print(f"{label}: {res['ms_per_frame']:.1f} ms/frame over frames 2-"
          f"{frames} (frames " + ", ".join(f"{m:.1f}" for m in
                                            res["frame_ms"])
          + " ms); stages " + json.dumps(
              {k: round(v, 3) for k, v in res["stage_ms_per_frame"].items()})
          + f"; image mean {res['image_mean']:.4f}; launches "
          + json.dumps({k: launches[k] for k in used})
          + f"; scene+BVH {res['load_s']:.1f}s", flush=True)
    for name, sizes in capture.sizes.items():
        print(f"{label}: {name} calls (size): {sizes}", flush=True)
    return launches


def _equal_bits(got, want) -> float:
    """0.0 when every output is bit-identical, else the max abs error."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                fin = torch.isfinite(g) & torch.isfinite(w)
                err = max(err, float((g - w)[fin].abs().max()), 1e-30)
        elif not torch.equal(g, w):
            err = max(err, float((g - w).abs().max()), 1e-30)
    return err


def drain_bound(name, args) -> tuple[float, str]:
    """Least time for one drain on these inputs: the distinct leaves' 10
    used table rows, the event rows' planes in and results out, against
    the per-lane dot of 10 features over 4n columns plus the MT epilogue
    (~10 flops a triangle)."""
    import torch

    from eidola_tpu_torch.ops.bvh_fused import NFEAT

    n = args[-1]
    ce = args[-2].shape[0]
    leaves = int(torch.unique(args[2]).numel())
    n_out = 4 if name == "mt_fused" else 1
    bytes_ = (leaves * NFEAT * 4 * n * 4 + ce * 128 * 4 * (8 + n_out)
              + ce * 4 * 8)
    flops = ce * 128 * n * (2 * NFEAT * 4 + 10)
    return _bound(bytes_, flops)


def walk_bound(walk, leaf_blocks, rays, stats) -> tuple[float, str]:
    """Least time for one traversal on these inputs, from this run's
    counted work: the walk rows and leaf rows it can have touched (at
    most one row per walk step and one leaf per drained event, each read
    once), rays in and results out, against walk steps x 128 lanes x one
    slab test plus drained events x 128 lanes x leaf_size triangle
    tests."""
    from eidola_tpu_torch.ops.bvh_walk import MT_FLOP, WALK_FLOP

    n = leaf_blocks.shape[1] // 12
    steps = int(stats[:, 0].sum())
    events = int(stats[:, 1].sum())
    bytes_ = (min(steps, walk.shape[0]) * 8 * 4
              + min(events, leaf_blocks.shape[0]) * n * 12 * 4
              + rays.numel() * 4 + rays[0].numel() * 4 * 4)
    flops = 128 * (steps * WALK_FLOP + events * n * MT_FLOP)
    return _bound(bytes_, flops)


def _bound(bytes_, flops):
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_drain(name, args, label) -> dict:
    import torch

    from eidola_tpu_torch.ops import bvh_fused as F

    kern, ref = getattr(F, name), getattr(F, name + "_ref")
    got = kern(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = _equal_bits(got, want)
    if err != 0.0:
        fail(f"{name} ({label}): CUDA kernel differs from its plain version "
             f"(max abs err {err}); the tolerance is bitwise")
    ms = time_ms(lambda: kern(*args), 20)
    plain_ms = time_ms(lambda: ref(*args), 3)
    bound_ms, bound_by = drain_bound(name, args)
    print(f"{name} ({label}): {args[-2].shape[0]} events x 128 lanes, leaf "
          f"{args[-1]}, {args[0].shape[0]}-leaf table; bitwise equal to "
          f"plain; cuda {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_walk(name, args, label) -> dict:
    """The walk kernel on a captured traversal against walk_ref(group=1):
    outputs and per-packet step/event counts bitwise."""
    import torch

    from eidola_tpu_torch.ops import bvh_walk as W

    walk, leaf_blocks, rays, max_steps = args
    P = rays.shape[1]
    kern = getattr(W, name)
    any_hit = name == "walk_any"
    stats = torch.zeros((P, 2), dtype=torch.int32, device=rays.device)
    ref_stats = torch.zeros_like(stats)
    got = kern(walk, leaf_blocks, rays, max_steps, stats=stats)
    t0 = time.perf_counter()
    want = W.walk_ref(walk, leaf_blocks, rays, any_hit, max_steps, group=1,
                      stats=ref_stats)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    err = _equal_bits(got, want)
    if err != 0.0 or not torch.equal(stats, ref_stats):
        fail(f"{name} ({label}): CUDA kernel differs from walk_ref(group=1) "
             f"(max abs err {err}, counts equal "
             f"{torch.equal(stats, ref_stats)}); the tolerance is bitwise")
    ms = time_ms(lambda: kern(walk, leaf_blocks, rays, max_steps), 5)
    plain_ms = time_ms(lambda: W.walk_ref(walk, leaf_blocks, rays, any_hit,
                                          max_steps, group=1), 1)
    bound_ms, bound_by = walk_bound(walk, leaf_blocks, rays, stats)
    s = stats.double()
    hit = float((got[1] >= 0).float().mean())
    print(f"{name} ({label}): {P} packets x 128 lanes, leaf "
          f"{leaf_blocks.shape[1] // 12}, {walk.shape[0]}-node walk table; "
          f"bitwise equal to walk_ref(group=1), counts equal; walk steps "
          f"{int(s[:, 0].sum())} (mean {float(s[:, 0].mean()):.1f}, max "
          f"{int(s[:, 0].max())} a packet), leaf events {int(s[:, 1].sum())}"
          f" (mean {float(s[:, 1].mean()):.1f}); hit lanes {hit:.3f}; cuda "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (first plain run "
          f"{ref_s:.1f} s), bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def synthetic_phase(dev) -> None:
    """An extra case the frames do not give: runs of 1-32 events of random
    sub-packets with an invalid tail and exact-t ties (utils/drain_case)."""
    from eidola_tpu_torch.utils.drain_case import (make_case, random_runs,
                                                   torch_args)

    n, ce, leaves = 64, 4096, 45056
    case = make_case(n, leaves, random_runs(ce - 96, 32, 1), ce, seed=2,
                     spread=60.0)
    for name in DRAINS:
        args = (*torch_args(case, dev, name == "mt_fused"), n)
        check_drain(name, args, f"synthetic, {ce - case['n_valid']} invalid "
                                "tail rows")
        del args


def golden_phase() -> None:
    """The golden config through the walk kernel on the card."""
    import numpy as np
    import torch

    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.ops import packets
    from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    dev = torch.device("cuda")
    packets.TRAV = "pallas"
    try:
        for key, env_mode in GOLDENS.items():
            cfg = RenderConfig(width=64, height=64, max_depth=2,
                               traversal_max_steps=1024, env_mode=env_mode)
            scene, cam = load_scene(key, device=dev)
            params = default_params(device=dev)
            tm = default_tonemap(device=dev)
            state = init_frame_state(cfg, cam)
            step = make_step(cfg)
            _reset_launches()
            for _ in range(4):
                state, out = step(scene, cam, params, tm, state)
            launches = _launches()
            img = out["hdr"].cpu().numpy()
            ref = np.load(os.path.join(ROOT, "tests", "golden",
                                       f"{key}_64_d2_f4.npy"))
            err = float(np.abs(img - ref).mean()) if img.shape == ref.shape \
                else float("inf")
            print(f"golden {key}: mean abs err {err:.6f} (bound 0.02); "
                  f"launches {json.dumps(launches)}", flush=True)
            if not err < 0.02:
                fail(f"golden {key}: mean abs err {err} >= 0.02")
            if min(launches[k] for k in WALKS) <= 0 or \
                    max(launches[k] for k in DRAINS) != 0:
                fail(f"golden {key}: not traced through the walk kernel "
                     f"({launches})")
    finally:
        packets.TRAV = "xla"


def reference_phase() -> None:
    """Small DI frames on the card (kernels, leaf 64) against the same
    frames on the CPU (plain versions, leaf 8): only exact-t ties may
    differ."""
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


def build_phase() -> None:
    from eidola_tpu_torch.native import native_build
    from eidola_tpu_torch.utils.cuda_build import (CUDA_SOURCES,
                                                   build_together, cuda_build)

    native = native_build()
    if native is None:
        fail("g++ not found: the port's C++ scene builders need it")
    builds = [cuda_build(n) for n in CUDA_SOURCES] + [native]
    t0 = time.perf_counter()
    build_together(builds)
    print(f"build: {', '.join(b.name for b in builds)} together in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


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

    set_numerics()
    build_phase()

    di_cap, gi_cap, gx_cap = drain_capture(), walk_capture(), drain_capture()
    di_launches = run_phase("DI", DI_ARGS, (1080, 1920, 3), 2, "xla",
                            di_cap, DRAINS, WALKS)
    gi_launches = run_phase("GI (pallas)", GI_ARGS, (1080, 1920, 3), 4,
                            "pallas", gi_cap, WALKS, DRAINS)
    run_phase("GI (xla, 960x540)", GI_XLA_ARGS, (540, 960, 3), 2, "xla",
              gx_cap, DRAINS, WALKS)
    torch.cuda.empty_cache()

    times = {}
    for name in DRAINS:
        times[name] = check_drain(name, di_cap.args[name],
                                  "largest DI frame drain")
        check_drain(name, gx_cap.args[name], "largest GI (xla) drain")
    del di_cap, gx_cap
    for name in WALKS:
        times[name] = check_walk(name, gi_cap.args[name],
                                 "largest GI-frame traversal")
    del gi_cap
    torch.cuda.empty_cache()
    synthetic_phase(torch.device("cuda"))
    golden_phase()
    reference_phase()

    launches = {**{k: di_launches[k] for k in DRAINS},
                **{k: gi_launches[k] for k in WALKS}}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][0], "launches": launches[k], **times[k],
         "library_ms": None} for k in KERNELS]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
