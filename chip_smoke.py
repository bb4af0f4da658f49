#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device, with
no EIDOLA_* variable set.  It imports nothing of JAX and nothing of the
JAX package.  On the card every traversal takes the one-kernel walk by
default (ops/packets.resolve_trav), so the phases that show the default
path set no traversal, and only the DI, GI-xla, standin DI and mxu
phases set EIDOLA_TRAV=xla (packets.TRAV) for the torch walk and its
drains.  In order:

1. prints the card's name and power limit (nvidia-smi) and the torch and
   CUDA versions;
2. builds every native source of the port at once, one compiler process
   each: every csrc/*.cu (utils/cuda_build.CUDA_SOURCES) with nvcc,
   the C++ host library (native/src/eidola_native.cpp) with g++,
   and prints each kernel's registers, spills and shared memory as
   ptxas reports them;
3. DI phase: 2 frames of bistro_flat at 1920x1080 through the headless
   entry point with --no-denoise --no-indirect under EIDOLA_TRAV=xla
   (torch walk + the fused drain kernels);
4. GI phase: the default frame (ReSTIR DI + GI, a-trous denoise) on
   bistro_flat at 1920x1080, 2 frames, no switch set: every ray goes
   through the one-kernel walk; prints ms/frame of frame 2 and the
   stage split; its last frame (frame 1) is held against the JAX
   package's frame 1 of bench.py's config on bistro_flat, stored in
   tests/golden_torch/ (utils/reference.py: mean abs on a stride-4
   lattice and of the 8x8 block means, each below 0.02; the max of the
   block means and its block are printed): the headless app's frames
   with no --orbit are the bench's (tests/test_torch_fullsize.py);
5. GI-xla phase: the same default frame under EIDOLA_TRAV=xla at
   960x540, 1 frame, so the drain kernels run on sorted GI rays;
6. standin phase: the JAX bench's headline frame, bistro_standin (2.89M
   instanced triangles, textures, alpha-MASK foliage split into a flat
   BVH) at 1920x1080 with the default RenderConfig and the alpha HitTest
   on (set by the app from the scene), no switch set, 2 frames: the
   walk kernels trace the instanced opaque bulk (closest and any hit)
   and the flat alpha BVH, and no drain kernel runs; prints the app's
   own readout (the MilliTimer load line and the Profiler's
   "Compile+first" and "Render" rows; fails without "Render") and the
   scene upload: the SceneData host tree onto the card through
   batched_device_put and through to_device, in turns, 3 each, with the
   host-to-device copies and ms of each (bitwise equal, every batched
   leaf at a 256-byte offset, at most one copy per dtype), and the
   pinned host memory torch's caching allocator holds after the load;
   its frame 1 is held against the stored JAX frame 1 of the standin
   under the queue march, the one the card runs with no switch set
   (`bistro_standin_1920x1080_d4_f1_queue.npz`), as the GI phase's is
   against bistro_flat's plain file (no alpha-tested material, no
   march);
   then the bench phase: the port's bench (eidola_tpu_torch/bench.py,
   `measure`, what `python -m eidola_tpu_torch.bench` runs) on the scene
   the standin phase loaded, 2 warm-up and 3 frames timed as one
   window, the stage split and the ray frame: its
   JSON has every field, `correct` true (the cornell golden on the
   card, its last warm-up frame held against the standin's stored JAX
   frame 1 under the queue march, the card's (`_queue.npz`), before the
   window: `reference_*`, and the window's last frame, frame 4, against
   JAX's frame 4 under the same march after it (`_f4_queue.npz`):
   `reference_last_*`, both of which it prints;
   a miss of any reference check fails the script after this phase;
   whether `hold()` leaves the standin's camera bitwise on the card is
   printed), `value` x 3 = the window's ms > 0, three per-frame event times
   > 0 (the window's ms/frame is printed beside their median), the ray
   count measured, walk launches and no drain, per frame and in the run;
   then the alpha march's laps (ops/alpha_lap.py): one standin frame
   with every lap counted, as many as its march.select spans and as
   alpha_lap.LAUNCHES, and on its largest lap lap_prep + lap_merge
   against the plain lap bitwise, both timed beside the kernels' bytes
   bound at 3.35 TB/s, and the device kernels a whole lap launches
   through the kernels and through the plain lap (profiler);
   then the denoiser's levels (ops/atrous.py): one standin frame with
   its two atrous_denoise calls kept and 4 + 5 level launches counted in
   atrous.LAUNCHES; on the direct call (1920x1080) and the indirect one
   (a [::2, ::2] view at 960x540), at level 0 and the call's last level,
   the kernel bitwise against the torch level, timed as the wrapper and
   as its bare launch beside the torch level and the level's bytes and
   operations bounds; each whole call bitwise against the torch levels,
   with its device kernels both ways (profiler);
   then the hit's shading state (ops/shade_state.py): one standin frame
   with its get_state calls kept and 6 launches counted in
   shade_state.LAUNCHES (2 with a ray cone); on the largest call with a
   cone and the largest without, the kernel bitwise against
   get_state_ref on every field, timed as the wrapper and as its bare
   launch (before the plain version) beside the torch body and the
   call's bytes bound, with its device kernels both ways (profiler);
7. options phase: the same frame under the JAX package's build option
   (f) EIDOLA_ALPHA_FLAT=0, the switch in the environment; it prints its
   build, frame 2 and stages beside the standin phase's, its walk
   launches and its image and primary hits against the standin frame
   (bounds: mean abs 2e-3, max abs 5e-2 on all but 100 pixels, under
   100 primary hits at another depth), the instanced alpha BVH's nodes
   and leaf pool, and its largest alpha walk against the default alpha
   BVH on the same rays (steps and leaf events a packet) and bitwise
   against walk_ref; then one more standin frame under
   EIDOLA_COUNT_RAYS=1: the live rays per front door and the Mrays/s
   they give at the standin frame's time;
8. interactive phase: bistro_standin at 1920x1080, no switch set, 4
   frames, with --orbit 0.01 --restir
   spatiotemporal --shadow-cadence 4 --primary-seed: the camera moves
   every frame, so after every frame the accumulation count is 1 and on
   frames 2-4 the motion vectors are not the identity; both walk kernels
   run and no drain; it keeps the direct stage's primary walk on the
   instanced bulk apart by frame, frame 0's (no seed yet) and the seeded
   ones of frames 2-4 (t_max bounded on some lanes by the last frame's
   triangle), and prints the share of lanes each seed bounds; frames 1
   (the first camera move, where the field of view changes) and 3 (the
   last) are held against the JAX package's headless app's frames of
   the same flags and index under the queue march
   (`bistro_standin_1920x1080_d4_f{1,3}_queue_interactive.npz`,
   utils/reference.find with the orbit; each reading printed, a missing
   file or a reading past 0.02 fails);
9. gltf phase: bistro_standin's parts written as a GLB (about 2.9M
   instanced triangles: one glTF mesh per part, one primitive per
   material, one node per instance, PNG textures, alpha-MASK leaf cards,
   the scene's camera) and a 2048x1024 equirect .hdr (a sun-like hot
   spot over a sky gradient, from a fixed seed), then the headless app
   on them at 1920x1080, no switch set: `--scene standin.glb
   -e env.hdr --frames 3 --save-state s.npz --out f.png`, then
   `--load-state s.npz --frames 2`; checks that the scene is instanced
   with the alpha HitTest on and >= 2.8M triangles, the env is the .hdr
   with the firefly clamp 4x its integral, the walk kernels ran on the
   instanced and the alpha BVH and no drain did, frame_idx goes 3 then
   5, the image is finite and the PNG decodes (utils/png.py) to
   1080x1920 RGB; the inputs (utils/reference.write_inputs) must have
   the sha256 that the stored JAX frames record, and the first run's
   last frame (2) and the resumed run's last (4) are held against JAX's
   headless app's frames 2 and 4 of the same run on the same files
   (`standin_glb_1920x1080_d4_f{2,4}_queue.npz`; a missing file, another
   sha256 or a reading past 0.02 fails);
10. viewer phase: the port's viewer in this process (app/viewer.start:
   its render and worker threads, the HTTP server on 127.0.0.1:0) on
   cornell at 1920x1080, no switch set; after a few frames
   POST /scene drops in the GLB and the .hdr; /stats is polled until it
   names the GLB with `busy` empty (a `busy` of "load failed",
   "compile failed" or "render failed" fails the phase, as does a time
   limit); then frames advance on the new scene, /frame.png decodes to
   1080x1920, POST /input orbits (the served image changes and the
   accumulation count goes back to 1), POST /pick hits a triangle of
   the scene, POST /config turns denoise off and on, POST /param sets
   the exposure, and /stats counts the loaded scene's triangles,
   textures and lights; prints the full frames' and the preview frames'
   times and counts, the PNG encode, the GLB's load on the worker, the
   warm-up frames, the fps, the walk launches and the device monitor;
11. standin DI phase: bistro_standin at 1920x1080 with --no-denoise
   --no-indirect under EIDOLA_TRAV=xla, 1 frame: the instanced
   torch walk with the fused drains on object-space rays;
12. mxu phase: the same DI frame under EIDOLA_TRAV=xla and
   EIDOLA_MT=mxu, 1 frame: every
   closest-hit drain goes through mt_mxu, and neither the fused drains
   nor the walk kernels run;
13. multidevice phase, the row-sharded frame (parallel/sharding.py) on
   bistro_standin at 1920 wide, the default RenderConfig with the HitTest,
   no switch set (the spawned ranks of (c) take the walk kernel by
   default too): (a) one process at 1920x1088 (padded_height(1080,
   8)) under band_context(8) against the same 2 frames unbanded, with the
   walk launches of each; (b) the sharded step at world size = the card
   count over NCCL (one rank in this process on a one-card machine) at
   1920x1080, 3 frames; (c) two ranks on the one card over gloo, spawned
   processes, every exchanged slab staged through host memory, 3 frames
   gathered to rank 0; (b) and (c) print each rank's ms per frame, its
   collective_summary() of frame 1, its walk launches and carried rows,
   and each frame's max and mean abs difference from the single-process
   frame (bound: max < 5e-2, mean < 2e-3, the JAX package's on its
   sharded step) and on how many pixels the last frame's primary hit
   differs; a failed rank, a difference past the bound or a walk
   kernel not launched on a rank fails the phase; then a probe of where
   (c) differs: each 540-row band's primary rays (8 frame seeds) through
   the HitTest alone and in the whole image, and for a ray whose hit
   differs its nearest alpha triangles, the opaque walk of the ray alone
   and every opaque triangle tested without the BVH; and the opaque
   walk's hits and packets at the step cap, as 8x16 tiles against the
   bands' scanline packets;
   each of phases 3-13 sets every launch count to 0 just before it and
   reads them just after, checks the image (shape, finite, in [0, 1],
   not black) and the accumulation count, that each kernel of its path
   was launched and that the kernels of the other paths were not, and
   keeps the arguments of each kernel's largest call (the walk kernels'
   largest instanced and largest flat call apart);
14. kernel phase: each kernel on those arguments (the frames' own shapes:
   leaf 64, the full bistro tables) against its plain torch version on
   the card, bitwise, with times from CUDA events: the whole wrapper
   call, the kernel alone (its bare launch on arguments already
   converted: `launcher` of its module) and the plain version; the walk
   kernels also against walk_ref's per-packet step and event counts,
   which give their bound (the interactive phase's seeded primary walk of
   frame 4 and, beside it, frame 0's unseeded one with their steps and
   leaf events per packet, and the seeded call's own rays with t_max
   unbounded again: the seed's effect on the same rays, whose hits must
   not change; the gltf phase's largest instanced, occlusion and alpha-BVH
   walks; the viewer phase's largest instanced and occlusion walks; the
   multidevice phase's (b) rank-0 largest instanced and occlusion walks);
   plus the drain kernels on a synthetic case
   with an invalid tail and exact-t ties, and on one with drain_case's
   edges (dets at the 1e-12 threshold and at 2^126, dead and all-hit
   warps), which the frames do not hold; for mt_any_fused and mt_mxu
   also what each call's data asks of the kernel (lanes alive, warp
   steps taken, triangles past the vote after the u test);
15. goldens on the card: cornell, punctual, textured, hdr and alpha (the
   HitTest on) at 64x64, max_depth=2, traversal_max_steps=1024, 4
   frames, through the walk kernel, each within 0.02 mean abs of
   tests/golden/*_64_d2_f4.npy; then one step of the entry point
   (eidola_tpu_torch/entry.py `entry("cuda")`, cornell 64x64 at the JAX
   entry's lean config): its image finite and within 0.02 mean abs of
   the same step on the CPU, through the walk kernels and no drain;
16. holds small DI frames on the card against the same frames through
   the plain versions on the CPU (cornell 32x32, stress 64x64);
17. fidelity phase, the port's root tools (eidola_tpu_torch/tools/):
   the per-stage fidelity table (fidelity_metrics: cornell and alpha
   at 32x32, 6 frames, 6 spp) and the ten captures of each scene
   (fidelity_captures, 32x32), no switch set, every image within 0.02
   mean abs of the JAX tool's stored output under the card's march
   (tests/golden_torch/, alpha's `_queue` files), the table's rows
   printed beside JAX's, walk launches and no drain; then perf_gather's
   gather, sort, argsort and cumsum rates at 2,073,600 rays;
18. prints one JSON line with an entry per kernel and path (the
   bistro_flat DI and GI frames, the standin frame, the interactive
   frame, the GLB frame, the viewer, the multidevice (b) rank, the
   standin DI frames with the fused and the mxu drains, the options
   phase's instanced alpha walk): that phase's launches and
   the kernel's error, times (`ms` the wrapper call, `kernel_ms` the
   kernel alone) and bound on the phase's largest call, after a line
   with the seconds of each phase and one with the script's seconds in
   all;
   then, last, {"ok": true, "device": {...}}.

Any failed phase exits non-zero before the last line.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BISTRO = ["--scene", "bistro_flat", "--device", "cuda", "--quiet"]
DI_ARGS = BISTRO + ["--size", "1920", "1080", "--frames", "2",
                    "--no-denoise", "--no-indirect"]
GI_ARGS = BISTRO + ["--size", "1920", "1080", "--frames", "2"]
GI_XLA_ARGS = BISTRO + ["--size", "960", "540", "--frames", "1"]
STANDIN = ["--scene", "bistro_standin", "--quiet", "--size", "1920", "1080",
           "--frames", "2"]
STANDIN_DI = STANDIN + ["--no-denoise", "--no-indirect", "--frames", "1"]
INTERACTIVE = ["--scene", "bistro_standin", "--quiet", "--size", "1920",
               "1080", "--frames", "4", "--orbit", "0.01", "--restir",
               "spatiotemporal", "--shadow-cadence", "4", "--primary-seed"]
_TMAX = 1e8      # an unbounded ray's t_max (render/direct.py)
# the direct stage's primary walk on the instanced bulk: frame 0's, which
# has no seed yet, and frame 4's, seeded from frame 3's triangles
PRIMARY0 = "walk_closest+inst+primary0"
SEEDED = "walk_closest+inst+seeded3"
FUSED_SRC = "eidola_tpu_torch/csrc/bvh_fused.cu"
WALK_SRC = "eidola_tpu_torch/csrc/bvh_walk.cu"
MXU_SRC = "eidola_tpu_torch/csrc/bvh_mxu.cu"
KERNELS = {   # name: (TPU kernel it replaces, source)
    "mt_fused": ("eidola_tpu/ops/bvh_fused.py:148", FUSED_SRC),
    "mt_any_fused": ("eidola_tpu/ops/bvh_fused.py:254", FUSED_SRC),
    "walk_closest": ("eidola_tpu/ops/bvh_pallas.py:43", WALK_SRC),
    "walk_any": ("eidola_tpu/ops/bvh_pallas.py:43", WALK_SRC),
    "mt_mxu": ("eidola_tpu/ops/bvh_mxu.py:83", MXU_SRC),
}
# KERNELS grouped as eidola_tpu_torch/bench.py groups them (checked in
# build_phase, once the package is importable)
DRAINS = ("mt_fused", "mt_any_fused")
WALKS = ("walk_closest", "walk_any")
MXU = ("mt_mxu",)
# H100 SXM published peaks (dense f32 outside the tensor cores; HBM3)
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
GOLDENS = {"alpha": "sunsky", "cornell": "sunsky", "hdr": "hdr",
           "punctual": "sunsky", "textured": "sunsky"}
STANDIN_TRIS = (2.8e6, 3.0e6)   # 729 lots x (1,728 + 4 x ~560)
GLTF = ["--size", "1920", "1080", "--quiet"]   # + the GLB, -e and frames
# the interactive phase's and the gltf phase's frames held against the
# JAX package's stored frames of their flags (tests/golden_torch/)
INTERACTIVE_FRAMES = (1, 3)
GLTF_FRAMES = (2, 4)
VIEWER_S = 600.0                 # the viewer phase's time limit
# the fidelity phase's size, frames and spp: those of the stored JAX files
FIDELITY_SIZE, FIDELITY_FRAMES, FIDELITY_SPP = ("32", "32"), "6", "6"
# Moller-Trumbore as a dot of coefficients and ray features (build_cmat):
# the products by the nonzero coefficients (det 3, t 4, u 6, v 6) and
# their sums, plus the epilogue: what the drain kernels compute.
MT_DOT_OPS = 19 + 15
MT_EPI_OPS = 10
# the multidevice phase: frames of its (a) runs and of (b), (c); each
# multi-process run's time limit; the JAX package's bounds on its sharded
# step against the single-device one (tests/test_parallel.py:45-46)
MD_FRAMES_A, MD_FRAMES, MD_RANKS_S, MD_PROBE_SEEDS = 2, 3, 300.0, 8
MD_MAX, MD_MEAN = 5e-2, 2e-3


class Laps:
    """Seconds of each phase: `lap(name)` closes the phase `name`."""

    def __init__(self):
        self.seconds, self.t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


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
    from eidola_tpu_torch.bench import read_launches

    return read_launches()


def _reset_launches() -> None:
    from eidola_tpu_torch.bench import reset_launches

    reset_launches()


class Capture:
    """While active, records the size of every call of the named wrappers
    of `module` and keeps the arguments (positional, keyword) of each
    one's largest call, under `key(name, args, kw)` (default: the name).  The
    wrapper itself still runs and counts its launch (its callers look it
    up on the module at each call); this only watches."""

    def __init__(self, module, names, size,
                 key=lambda name, args, kw: name):
        self.module, self.names, self.size = module, names, size
        self.key = key
        self.sizes = {}
        self.args = {}

    def __enter__(self):
        self.orig = {k: getattr(self.module, k) for k in self.names}
        for k, fn in self.orig.items():
            setattr(self.module, k, self._watch(k, fn))
        return self

    def _watch(self, name, fn):
        def call(*args, **kw):
            n, key = self.size(args), self.key(name, args, kw)
            sizes = self.sizes.setdefault(key, [])
            if n > max(sizes, default=0):
                self.args[key] = (args, kw)
            sizes.append(n)
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.module, k, fn)


class PrimaryWatch:
    """While active, tells the walk calls made inside the direct stage's
    primary trace apart, by frame: `key` gives a walk_closest call there
    the suffix "+primary0" on frame 0 (no seed yet) and "+seeded<i>" on
    frame i > 0; every other call keeps walk_capture's key."""

    def __init__(self):
        self.frame, self.inside = -1, False

    def __enter__(self):
        from eidola_tpu_torch.render import direct

        self.orig = direct.trace_closest

        def primary(*args, **kw):
            self.frame += 1
            self.inside = True
            try:
                return self.orig(*args, **kw)
            finally:
                self.inside = False

        direct.trace_closest = primary
        return self

    def __exit__(self, *exc):
        from eidola_tpu_torch.render import direct

        direct.trace_closest = self.orig

    def key(self, name, args, kw):
        key = name + ("+inst" if kw.get("inst") is not None else "")
        if self.inside and name == "walk_closest":
            key += f"+seeded{self.frame}" if self.frame else "+primary0"
        return key


class FrameWatch:
    """While active, keeps each frame's accumulation count, motion vectors
    and linear `hdr` (references only: no sync inside the timed
    frames)."""

    def __init__(self):
        self.frames = []

    def __enter__(self):
        from eidola_tpu_torch.app import headless

        self.orig = headless.make_step

        def make_step(cfg):
            step = self.orig(cfg)

            def watched(*args, **kw):
                state, out = step(*args, **kw)
                self.frames.append((state.accum_count, out["motion"],
                                    out["hdr"]))
                return state, out
            return watched

        headless.make_step = make_step
        return self

    def __exit__(self, *exc):
        from eidola_tpu_torch.app import headless

        headless.make_step = self.orig


def drain_capture():
    from eidola_tpu_torch.ops import bvh_fused

    return Capture(bvh_fused, DRAINS, lambda a: a[-2].shape[0])  # gtb rows


def walk_capture():
    """Instanced and flat calls apart: "walk_closest+inst" / "walk_closest"."""
    from eidola_tpu_torch.ops import bvh_walk

    return Capture(bvh_walk, WALKS, lambda a: a[2].shape[1],     # packets
                   lambda name, args, kw: name + ("+inst" if kw.get("inst")
                                                  is not None else ""))


def mxu_capture():
    from eidola_tpu_torch.ops import bvh_mxu

    return Capture(bvh_mxu, MXU, lambda a: a[0].shape[0])        # events


def check_frame(res, shape, frames, label, accum=None) -> None:
    import numpy as np

    img, state = res["image"], res["state"]
    if img.shape != shape:
        fail(f"{label}: image shape {img.shape} != {shape}")
    if not np.isfinite(img).all() or img.min() < 0.0 or img.max() > 1.0:
        fail(f"{label}: image not finite in [0, 1]")
    if img.mean() < 0.02:
        fail(f"{label}: image is black (mean {img.mean():.4f})")
    accum = frames if accum is None else accum
    if float(state.accum_count) != float(accum):
        fail(f"{label}: accum_count {float(state.accum_count)} != {accum}")


def run_phase(label, argv, shape, frames, trav, captures, used, unused,
              mt=None, accum=None, watch=()):
    """One main-path run through the headless entry point, its launch
    counts set to 0 just before and read just after; `trav` / `mt` set
    the traversal and the drain for the run (None: leave the default) and
    are restored to what they were; `captures` keep the arguments of each
    watched kernel's largest call; `watch`: other context managers active
    during the run."""
    import contextlib

    import torch

    from eidola_tpu_torch.app import headless
    from eidola_tpu_torch.ops import bvh, packets

    found = packets.TRAV, bvh.MT
    packets.TRAV, bvh.MT = trav or found[0], mt or found[1]
    try:
        with contextlib.ExitStack() as stack:
            for cap in (*watch, *captures):
                stack.enter_context(cap)
            _reset_launches()
            res = headless.run(argv)
            torch.cuda.synchronize()
            launches = _launches()
    finally:
        packets.TRAV, bvh.MT = found
    check_frame(res, shape, frames, label, accum)
    args = {k: v for cap in captures for k, v in cap.args.items()}
    for name in used:
        if launches[name.split("+")[0]] <= 0 or name not in args:
            fail(f"{label}: {name} was never launched on its path")
    for name in unused:
        if launches[name] != 0:
            fail(f"{label}: {name} was launched {launches[name]} times on "
                 f"a path that must not use it")
    print(f"{label}: {res['ms_per_frame']:.1f} ms/frame over frames "
          f"{min(2, frames)}-{frames} (frames " + ", ".join(f"{m:.1f}" for m in
                                            res["frame_ms"])
          + " ms); stages " + json.dumps(
              {k: round(v, 3) for k, v in res["stage_ms_per_frame"].items()})
          + f"; image mean {res['image_mean']:.4f}; launches "
          + json.dumps({k: launches[k] for k in
                        dict.fromkeys(n.split("+")[0] for n in used)})
          + f"; scene+BVH {res['load_s']:.1f}s; {res['n_tris']} triangles, "
          f"alpha_geometry {res['alpha_geometry']}, trav {res['trav']}",
          flush=True)
    for cap in captures:
        for name, sizes in cap.sizes.items():
            print(f"{label}: {name} calls (size): {sizes}", flush=True)
    return launches, res


def check_calls(label, launches, sizes) -> None:
    """Each walk launch of a phase came through a watched call."""
    for name in WALKS:
        calls = sum(len(v) for k, v in sizes.items()
                    if k.split("+")[0] == name)
        if calls != launches[name]:
            fail(f"{label}: {name} counted {launches[name]} launches in "
                 f"{calls} calls")


def check_standin(res) -> None:
    """The headline frame: alpha HitTest on, ~2.89M instanced triangles."""
    lo, hi = STANDIN_TRIS
    if not res["alpha_geometry"] or not lo <= res["n_tris"] <= hi:
        fail(f"standin: alpha_geometry {res['alpha_geometry']}, "
             f"{res['n_tris']} triangles (want True, {lo:.0f}-{hi:.0f})")


BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "mrays_per_s",
                "mrays_method", "rays_per_frame", "scene", "n_tris", "width",
                "height", "device", "trav", "load_s", "first_frame_ms",
                "frames", "peak_mem_gib", "launches_per_frame", "stage_ms",
                "golden_s", "golden_mean_abs",
                "reference_frame", "reference_file", "reference_mean_abs",
                "reference_block_mean_abs", "reference_block_max",
                "reference_block_max_at", "reference_last_frame",
                "reference_last_file", "reference_last_mean_abs",
                "reference_last_block_mean_abs", "reference_last_block_max",
                "reference_last_block_max_at",
                "alpha_march", "correct")
BENCH_STAGES = {"primary_trace", "shading_ris", "shadow_trace",
                "di_temporal_shade", "gi_trace", "gi_resample", "denoise",
                "compose_post"}


REFERENCE_MISSES = []     # labels of the frames past their reference
# the JAX standin frames under the queue march, the card's default: the
# bench phase's last warm-up frame (1) and last timed frame (4)
STANDIN_QUEUE_REF = "bistro_standin_1920x1080_d4_f{frame}_queue.npz"


def reference_check(label, name, res) -> None:
    """The last frame of a headless phase (`res`, headless.run's dict)
    against the JAX package's stored frame of bench.py's config for
    `name` at that frame, rendered under the alpha march the card runs
    (the `_queue` file for an alpha-tested scene); prints the readings
    and records a miss."""
    from eidola_tpu_torch import bench
    from eidola_tpu_torch.render.tracer import _march_mode
    from eidola_tpu_torch.utils import reference

    frame = res["frames"] - 1
    cfg = bench.frame_cfg(res["scene"], res["width"], res["height"])
    march = _march_mode("cuda")
    path = reference.find(name, cfg, frame, march)
    if path is None:
        fail(f"{label}: no stored reference for {name} frame {frame} "
             f"under the {march} march")
    got = reference.compare(res["hdr"], reference.load(path))
    print(reference.line(f"reference {label}: {name} {res['width']}x"
                         f"{res['height']} frame {frame} against "
                         f"{os.path.basename(path)}", got), flush=True)
    if not got["ok"]:
        REFERENCE_MISSES.append(label)


def bench_phase(loaded, load_s: float) -> None:
    """The port's bench on the standin phase's (scene, camera): 2 warm-up
    frames, the last held against its stored JAX frame, and 3 timed
    frames, then its stage split and ray frame, its
    launch counts set to 0 just before and read just after."""
    import torch

    from eidola_tpu_torch import bench
    from eidola_tpu_torch.scene.camera import advance
    from eidola_tpu_torch.utils import reference

    scene, cam = loaded
    print("bench: hold() leaves the standin camera bitwise on the card: "
          f"{all(torch.equal(a, b) for a, b in zip(advance(cam), cam))}",
          flush=True)
    _reset_launches()
    out = bench.measure(scene, cam, torch.device("cuda"), "bistro_standin",
                        warmup=2, iters=3, load_s=load_s)
    torch.cuda.synchronize()
    launches = _launches()
    print("bench: " + json.dumps(out), flush=True)
    if out.get("alpha_march") != "queue":
        fail(f"bench: the standin ran the {out.get('alpha_march')} march")
    for tag, frame in (("", 1), ("last_", 4)):
        want = STANDIN_QUEUE_REF.format(frame=frame)
        if out.get(f"reference_{tag}frame") != frame or not str(out.get(
                f"reference_{tag}file")).endswith(want):
            fail(f"bench: frame {frame} not held against {want} "
                 f"({out.get(f'reference_{tag}frame')}, "
                 f"{out.get(f'reference_{tag}file')})")
        got = {k: out[f"reference_{tag}" + k] for k in bench.READINGS}
        got.update(bound=reference.BOUND, ok=got["mean_abs"]
                   < reference.BOUND and got["block_mean_abs"]
                   < reference.BOUND)
        print(reference.line(f"reference bench: bistro_standin 1920x1080 "
                             f"frame {frame} against {want}", got),
              flush=True)
        if not got["ok"]:
            REFERENCE_MISSES.append(f"bench frame {frame}")
    if REFERENCE_MISSES:
        fail(f"frames past their stored JAX reference: {REFERENCE_MISSES}")
    missing = [k for k in BENCH_FIELDS if k not in out]
    if missing:
        fail(f"bench: the JSON lacks {missing}")
    frames = out["frames"]
    if out["correct"] is not True or frames["n"] != 3:
        fail(f"bench: correct {out['correct']}, {frames['n']} frames")
    if not frames["window_ms"] > 0 or \
            abs(out["value"] * 3 - frames["window_ms"]) > \
            1e-9 * frames["window_ms"]:
        fail(f"bench: value {out['value']} x 3 is not the window "
             f"{frames['window_ms']} ms")
    if len(frames["frame_ms"]) != 3 or min(frames["frame_ms"]) <= 0:
        fail(f"bench: per-frame event times {frames['frame_ms']}")
    print(f"bench: window {out['value']:.1f} ms/frame, the frames' events "
          f"median {frames['median']:.1f} ms ({frames['frame_ms']})",
          flush=True)
    if set(out["stage_ms"]) != BENCH_STAGES:
        fail(f"bench: stages {sorted(out['stage_ms'])}")
    if not out["mrays_method"].startswith("measured") or \
            not out["rays_per_frame"] > 0:
        fail(f"bench: rays {out['rays_per_frame']} ({out['mrays_method']})")
    if not out["peak_mem_gib"] > 0:
        fail("bench: no peak memory")
    per = out["launches_per_frame"]
    for got in (per, launches):
        if min(got[k] for k in WALKS) <= 0 or \
                max(got[k] for k in DRAINS + MXU) != 0:
            fail(f"bench: not traced through the walk kernels alone ({got})")
    print("bench: launches in the run (golden, warm-up, timed, stage "
          f"and ray frames) {json.dumps(launches)}", flush=True)
    lap_check(scene, cam)
    atrous_check(scene, cam)
    shade_check(scene, cam)


def _lap_bytes(n: int, n_inst: int, textured: bool) -> int:
    """Bytes a lap of n queued lanes moves through lap_prep and lap_merge
    (csrc/alpha_lap.cu), each row a lane gathers counted once: prep reads
    sel, the record, rng, budget, t_max and ray (72), the triangle's
    material and uv rows and the material's entries (56), the instance
    search (8 (log2 I + 1) + 16) and four texels with the texture's size
    and wrap (48), and writes the compact rays and scratch (58); merge
    reads sel, the re-trace's record and the scratch (46) and writes the
    record, rng, flags and budget (38)."""
    search = 8 * n_inst.bit_length() + 16 if n_inst else 0
    return n * (72 + 56 + search + (48 if textured else 0) + 58 + 46 + 38)


def _profiled_kernels(fn) -> int:
    """Device kernels (memcopies and memsets aside) `fn` launches, from the
    profiler's raw events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda
               and not e.name().startswith(("Memcpy", "Memset")))


def lap_check(scene, cam) -> None:
    """The alpha march's lap on the card (ops/alpha_lap.py): one standin
    frame at 1920x1080 with every lap's size and kind counted and its
    largest lap's state kept; on it lap_prep + lap_merge against the plain
    lap (render/tracer.py `_lap_prep_ref` / `_lap_merge_ref` on the same
    CUDA tensors) bitwise, the compact rays and scratch and the band after
    the whole lap alike; both timed (CUDA events), beside the kernels'
    bytes bound at 3.35 TB/s; the kernels a whole lap launches, through
    the kernels and through the plain lap, from the profiler; the laps
    counted in alpha_lap.LAUNCHES against the march's select spans."""
    import torch

    from eidola_tpu_torch import bench
    from eidola_tpu_torch.ops import alpha_lap
    from eidola_tpu_torch.ops.packets import closest_hit_sorted, sort_order
    from eidola_tpu_torch.render import tracer as TT
    from eidola_tpu_torch.render.config import default_params, default_tonemap
    from eidola_tpu_torch.render.frame import init_frame_state, make_step
    from eidola_tpu_torch.utils.profiler import StageTimer

    dev = torch.device("cuda")
    cfg = bench.frame_cfg(scene, 1920, 1080)
    sizes, big = [], {}
    lap = TT._march_lap

    def watched(sc, hop, sel, band, max_steps, occl):
        n = sel.numel()
        sizes.append((n, occl))
        if n > big.get("n", 0):
            big.update(n=n, args=(sc, hop, sel.clone(),
                                  type(band)(*[a.clone() for a in band]),
                                  max_steps, occl))
        return lap(sc, hop, sel, band, max_steps, occl)

    params, tm = default_params(device=dev), default_tonemap(device=dev)
    step, timer = make_step(cfg), StageTimer(dev)
    before = alpha_lap.LAUNCHES
    TT._march_lap = watched
    try:
        step(scene, cam, params, tm, init_frame_state(cfg, cam), timer=timer)
        torch.cuda.synchronize()
    finally:
        TT._march_lap = lap
    counted = alpha_lap.LAUNCHES - before
    selects = sum(1 for s in timer.spans() if s[:2] == ("sync",
                                                       "march.select"))
    if not sizes or counted != len(sizes) or counted != selects:
        fail(f"lap: {counted} laps through the kernels, {len(sizes)} laps, "
             f"{selects} march.select spans in the frame")
    sc, hop, sel, band0, max_steps, occl = big["args"]
    tables = TT._alpha_tables(sc)
    fresh = lambda: type(band0)(*[a.clone() for a in band0])
    got = alpha_lap.lap_prep(sel, band0, tables, hop.walk, occl)
    want = TT._lap_prep_ref(sc, hop, sel, band0, occl)
    prep_eq = [f for f, a, b in zip(type(got)._fields, got, want)
               if not torch.equal(a, b)]
    rec2 = closest_hit_sorted(hop, got.o, got.d, got.tn, got.tx,
                              max_steps=max_steps, order=sort_order(got.keys))
    b_k, b_p = fresh(), fresh()
    alpha_lap.lap_merge(sel, b_k, rec2, got, occl)
    TT._lap_merge_ref(sel, b_p, rec2, want, occl)
    merge_eq = [f for f, a, b in zip(type(b_k)._fields, b_k, b_p)
                if not torch.equal(a, b)]

    def plain_lap(band):
        lap = TT._lap_prep_ref(sc, hop, sel, band, occl)
        TT._lap_merge_ref(sel, band, closest_hit_sorted(
            hop, lap.o, lap.d, lap.tn, lap.tx, max_steps=max_steps,
            order=sort_order(lap.keys)), lap, occl)

    kern_lap = lambda band: TT._march_lap(sc, hop, sel, band, max_steps,
                                          occl)
    b_k, b_p = fresh(), fresh()
    kern_lap(b_k)
    plain_lap(b_p)
    lap_eq = [f for f, a, b in zip(type(b_k)._fields, b_k, b_p)
              if not torch.equal(a, b)]
    if prep_eq or merge_eq or lap_eq:
        fail(f"lap: kernels differ from the plain lap (prep {prep_eq}, "
             f"merge {merge_eq}, whole lap {lap_eq}); the tolerance is "
             "bitwise")
    # timed and profiled in place on one band each (the band changes from
    # one repetition to the next, the work a lane does not); prep + merge
    # alone on a fixed re-trace record
    kern_ms = time_ms(lambda: alpha_lap.lap_merge(
        sel, b_k, rec2, alpha_lap.lap_prep(sel, b_k, tables, hop.walk, occl),
        occl), 10)
    plain_ms = time_ms(lambda: TT._lap_merge_ref(
        sel, b_p, rec2, TT._lap_prep_ref(sc, hop, sel, b_p, occl), occl), 10)
    kern_lap_ms = time_ms(lambda: kern_lap(b_k), 5)
    plain_lap_ms = time_ms(lambda: plain_lap(b_p), 5)
    kern_kernels = _profiled_kernels(lambda: kern_lap(b_k))
    plain_kernels = _profiled_kernels(lambda: plain_lap(b_p))
    n = big["n"]
    n_inst = 0 if tables.tri_base is None else tables.tri_base.shape[0]
    tex = tables.tex_data
    nbytes = _lap_bytes(n, n_inst, not (tex.shape[0] == tex.shape[1] == 1))
    bound_ms = nbytes / PEAK_BYTES * 1e3
    closest = [m for m, o in sizes if not o]
    occlusion = [m for m, o in sizes if o]
    print(f"lap (standin 1920x1080 frame 0): {len(sizes)} laps, "
          f"{len(closest)} closest ({sum(closest)} lanes) and "
          f"{len(occlusion)} occlusion ({sum(occlusion)} lanes), as many "
          f"as the march.select spans and alpha_lap.LAUNCHES; largest lap "
          f"{n} lanes ({'occlusion' if occl else 'closest'}, {n_inst} "
          f"instances): prep + merge bitwise equal to the plain lap (the "
          f"compact rays, keys, scratch and the band), the whole lap too; "
          f"kernels {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s); the whole lap "
          f"{kern_lap_ms:.4f} ms through the kernels, {plain_lap_ms:.4f} ms "
          f"plain; device kernels a lap {kern_kernels} through the "
          f"kernels, {plain_kernels} plain (profiler)", flush=True)


def _atrous_bounds(h: int, w: int) -> tuple:
    """(bytes, operations) of one a-trous level over h x w pixels
    (csrc/atrous.cu): each pixel's planes read once (image 12, position
    12, normal 12, hash 8, valid 1) and its output written once (12); a
    tap's luminance (5), luminance stop (4 and an exp), normal and
    position stops (3 sub, 3 mul, 2 add, neg, mul and an exp each),
    weight (4), accumulation (7), an exp counted as one operation: 43 a
    tap, 25 taps, and the centre's luminance (5) and division (3)."""
    return h * w * (45 + 12), h * w * (43 * 25 + 8)


def atrous_check(scene, cam) -> None:
    """The denoiser's levels on the card (ops/atrous.py): one standin frame
    at 1920x1080 with its two atrous_denoise calls kept and the levels
    counted in atrous.LAUNCHES (4 + 5); on the direct call (1920x1080)
    and the indirect one (960x540, a [::2, ::2] view of the full-res
    planes), at level 0 and at the call's last level, the kernel against
    the torch level (render/denoise.py `atrous_level` on the same CUDA
    tensors) bitwise, timed (CUDA events) as the whole wrapper call and as
    its bare launch beside the plain level and the level's bounds (bytes
    at 3.35 TB/s, operations at 67 TFLOP/s); each whole call bitwise
    against the torch levels, with the device kernels it launches both
    ways (profiler)."""
    import torch

    from eidola_tpu_torch import bench
    from eidola_tpu_torch.ops import atrous
    from eidola_tpu_torch.render import denoise as D
    from eidola_tpu_torch.render import frame as RF
    from eidola_tpu_torch.render.config import default_params, default_tonemap
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    dev = torch.device("cuda")
    cfg = bench.frame_cfg(scene, 1920, 1080)
    calls = []
    denoise = RF.atrous_denoise

    def kept(img, view, levels, *sig):
        calls.append((img.clone(), view, levels, sig))
        return denoise(img, view, levels, *sig)

    params, tm = default_params(device=dev), default_tonemap(device=dev)
    before = atrous.LAUNCHES
    RF.atrous_denoise = kept
    try:
        make_step(cfg)(scene, cam, params, tm, init_frame_state(cfg, cam))
        torch.cuda.synchronize()
    finally:
        RF.atrous_denoise = denoise
    counted = atrous.LAUNCHES - before
    levels = [c[2] for c in calls]
    if levels != [cfg.denoise_direct_levels, cfg.denoise_indirect_levels] \
            or counted != sum(levels):
        fail(f"atrous: {counted} level launches for denoiser calls of "
             f"{levels} levels")
    print(f"atrous (standin 1920x1080 frame 0): {counted} level launches a "
          f"frame in atrous.LAUNCHES ({' + '.join(map(str, levels))})",
          flush=True)
    wholes = []
    for name, (img, view, n, sig) in zip(("direct", "indirect"), calls):
        h, w = img.shape[:2]
        planes = atrous.View(view.pos, view.nrm, view.mat_hash, view.valid)
        strided = view.pos.stride(1) != 3
        for level in (0, n - 1):
            got = atrous.run_level(img, planes, level, *sig)
            want = D.atrous_level(img, view, level, *sig)
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                fail(f"atrous: the {name} call's level {level} differs from "
                     f"the torch level at {int((got != want).sum())} values "
                     "(the tolerance is bitwise)")
            out = torch.empty_like(got)
            launch, _ = atrous.launcher(img, planes, level, *sig, out=out)
            wrap_ms = time_ms(lambda: atrous.run_level(
                img, planes, level, *sig, out=out), 20)
            kern_ms = time_ms(launch, 20)
            plain_ms = time_ms(lambda: D.atrous_level(
                img, view, level, *sig), 3)
            nbytes, ops = _atrous_bounds(h, w)
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
            print(f"atrous: {name} level {level} at {w}x{h}"
                  f"{' (a [::2, ::2] view)' if strided else ''}: bitwise "
                  f"equal to the torch level; wrapper {wrap_ms:.4f} ms "
                  f"(kernel {kern_ms:.4f}) vs plain {plain_ms:.4f} ms; bound "
                  f"{max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
                  f"{nbytes} bytes {t_bytes:.4f} ms, {ops} operations "
                  f"{t_ops:.4f} ms)", flush=True)

        def plain(img=img, view=view, n=n, sig=sig):
            for level in range(n):
                img = D.atrous_level(img, view, level, *sig)
            return img

        got = D.atrous_denoise(img, view, n, *sig)
        if not torch.equal(got.view(torch.int32), plain().view(torch.int32)):
            fail(f"atrous: the {name} call's {n} levels differ from the "
                 "torch levels (the tolerance is bitwise)")
        kern_calls = _profiled_kernels(lambda: D.atrous_denoise(img, view, n,
                                                                *sig))
        if kern_calls != n:
            fail(f"atrous: the {name} call launched {kern_calls} device "
                 f"kernels for {n} levels")
        call_ms = time_ms(lambda: D.atrous_denoise(img, view, n, *sig), 10)
        plain_call_ms = time_ms(plain, 2)
        wholes.append((name, n, w, h, call_ms, plain_call_ms, plain))
    # the plain calls' profiles last: a profile of thousands of kernels
    # has been seen to leave the next one a kernel short (a whole call:
    # 4 of 5 through the kernel, 4,374 of 4,375 plain)
    for name, n, w, h, call_ms, plain_call_ms, plain in wholes:
        print(f"atrous: the {name} call ({n} levels at {w}x{h}) bitwise "
              f"equal to the torch levels; {call_ms:.4f} ms vs plain "
              f"{plain_call_ms:.4f} ms; device kernels {n} through the "
              f"kernel, {_profiled_kernels(plain)} plain (profiler)",
              flush=True)


def _shade_bytes(args, state, cone: bool) -> int:
    """Bytes one get_state call must move through csrc/shade_state.cu,
    each byte it needs counted once: the lanes' own inputs (the record, 20
    bytes; the ray, 24, an origin broadcast over the lanes once) and the
    state written (97 a lane); of the scene's tables, the entries the hit
    lanes touch, each once: attribute rows (normals, geometric normal,
    uvs, colours, material: 88 bytes; the uv density with a cone, 4; a
    normal-mapped row's tangents and handedness, 36), instances (their
    tri_base and attr_base, 16; the normal rotation and sign, 40; the uv
    scale with a cone, 4; the rotation where a normal map is read, 36),
    materials (76) and the textures read (each one's size and wrap, 32,
    and its atlas slice, or 4 texels of 16 bytes a level a lane where
    that is less)."""
    import torch

    from eidola_tpu_torch.ops.shade_state import _lane_stride
    from eidola_tpu_torch.scene.data import shade_row

    scene, o, d, tri, t, u, v = args
    lead, n = tuple(tri.shape), tri.numel()
    total = 117 * n + sum(12 * (n if _lane_stride(k, a, lead) else 1)
                          for k, a in (("o", o), ("d", d)))
    row, inst = shade_row(scene, tri[state.valid])
    mat = state.mat_id[state.valid]
    m = scene.materials
    mapped = m.normal_tex[mat] >= 0
    uniq = lambda a: torch.unique(a).numel()
    total += uniq(row) * (88 + 4 * cone) + uniq(row[mapped]) * 36
    if inst is not None:
        total += uniq(inst) * (60 if cone else 56) + uniq(inst[mapped]) * 36
    total += uniq(mat) * 76
    tex = scene.textures.data
    if not tex.shape[0] == tex.shape[1] == 1:
        for ids in (m.base_tex, m.mr_tex, m.emissive_tex, m.normal_tex):
            used = ids[mat]
            for tid in torch.unique(used[used >= 0]).tolist():
                lanes = int((used == tid).sum())
                total += 32 + min(tex[0].numel() * 4,
                                  lanes * 64 * (2 if cone else 1))
    return total


def shade_check(scene, cam) -> None:
    """The hit's shading state on the card (ops/shade_state.py): one
    standin frame at 1920x1080 with every get_state call kept and counted
    in shade_state.LAUNCHES (6: 2 with a ray cone, 4 without); on the
    largest call with a cone and the largest without, the kernel against
    get_state_ref (the torch body, on the same CUDA tensors) bitwise, on
    every field; each timed (CUDA events) as the wrapper call and as its
    bare launch beside its bytes bound at 3.35 TB/s, and profiled, before
    any plain version runs; then the plain version timed and profiled."""
    import torch

    from eidola_tpu_torch import bench
    from eidola_tpu_torch.ops import shade_state as K
    from eidola_tpu_torch.render import direct, indirect, tracer
    from eidola_tpu_torch.render import shade_state as RS
    from eidola_tpu_torch.render.config import default_params, default_tonemap
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    dev = torch.device("cuda")
    cfg = bench.frame_cfg(scene, 1920, 1080)
    calls = []

    def kept(*args, cone_angle=None):
        calls.append((args, cone_angle))
        return RS.get_state(*args, cone_angle=cone_angle)

    mods = (direct, indirect, tracer)
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    before = K.LAUNCHES
    for m in mods:
        m.get_state = kept
    try:
        make_step(cfg)(scene, cam, params, tm, init_frame_state(cfg, cam))
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.get_state = RS.get_state
    counted = K.LAUNCHES - before
    coned = [c is not None for _, c in calls]
    if counted != len(calls) or counted != 6 or coned.count(True) != 2:
        fail(f"shade_state: {counted} launches for {len(calls)} get_state "
             f"calls, {coned.count(True)} with a cone (want 6 and 2)")
    sizes = [a[3].numel() for a, _ in calls]
    print(f"shade_state (standin 1920x1080 frame 0): {counted} launches a "
          f"frame in shade_state.LAUNCHES, lanes {sizes} (cone "
          f"{coned})", flush=True)
    picked = [max((i for i, c in enumerate(coned) if c == want),
                  key=lambda i: sizes[i]) for want in (True, False)]
    # the kernel's readings first: a profile taken after thousands of
    # plain kernels has been seen to miss launches
    rows = []
    for k in picked:
        args, cone = calls[k]
        launch, _ = K.launcher(*args, cone_angle=cone)
        wrap_ms = time_ms(lambda: K.shade(*args, cone_angle=cone), 20)
        kern_ms = time_ms(launch, 20)
        kern_calls = _profiled_kernels(lambda: RS.get_state(
            *args, cone_angle=cone))
        rows.append((k, wrap_ms, kern_ms, kern_calls))
    bits = lambda a: a.view(torch.int32) if a.dtype == torch.float32 else a
    for k, wrap_ms, kern_ms, kern_calls in rows:
        args, cone = calls[k]
        label = (f"call {k} ({sizes[k]} lanes, "
                 f"{'a' if cone is not None else 'no'} cone)")
        got = RS.get_state(*args, cone_angle=cone)
        want = RS.get_state_ref(*args, cone_angle=cone)
        bad = {f: int((a != b).sum()) for f, a, b in zip(
            RS.State._fields, got, want) if a.dtype != b.dtype
            or not torch.equal(bits(a), bits(b))}
        if bad:
            fail(f"shade_state: {label} differs from get_state_ref in "
                 f"{bad} values (the tolerance is bitwise)")
        plain = lambda: RS.get_state_ref(*args, cone_angle=cone)
        plain_ms = time_ms(plain, 3)
        nbytes = _shade_bytes(args, want, cone is not None)
        print(f"shade_state: {label}: bitwise equal to get_state_ref on "
              f"all 13 fields; wrapper {wrap_ms:.4f} ms (kernel "
              f"{kern_ms:.4f}) vs plain {plain_ms:.4f} ms; bound "
              f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes: {nbytes} at "
              f"3.35 TB/s); device kernels {kern_calls} through the "
              f"kernel, {_profiled_kernels(plain)} plain (profiler)",
              flush=True)


def entry_phase() -> None:
    """One step of eidola_tpu_torch/entry.py's entry() on the card, held
    to the same step on the CPU."""
    import torch

    from eidola_tpu_torch.entry import entry

    _reset_launches()
    fn, args = entry("cuda")
    _, img = fn(*args)
    torch.cuda.synchronize()
    launches = _launches()
    fn, args = entry("cpu")
    err = float((img.cpu() - fn(*args)[1]).abs().mean())
    print(f"entry: one step of cornell 64x64 on the card, mean abs {err:.6f}"
          f" from the CPU step (bound 0.02); launches {json.dumps(launches)}",
          flush=True)
    if tuple(img.shape) != (64, 64, 3) or not bool(torch.isfinite(img).all()):
        fail(f"entry: image {tuple(img.shape)} not finite")
    if not err < 0.02:
        fail(f"entry: mean abs {err} from the CPU step >= 0.02")
    if min(launches[k] for k in WALKS) <= 0 or \
            max(launches[k] for k in DRAINS + MXU) != 0:
        fail(f"entry: not traced through the walk kernels ({launches})")


def check_interactive(res, frames: FrameWatch, walks: Capture) -> None:
    """The moving camera resets the accumulation every frame, its motion
    vectors leave the identity on frames 2-4, and the seeded primary
    walk really starts bounded on some lanes."""
    import torch

    check_standin(res)
    if len(frames.frames) != 4:
        fail(f"interactive: {len(frames.frames)} frames watched, not 4")
    for i, (count, motion, _) in enumerate(frames.frames):
        if float(count) != 1.0:
            fail(f"interactive: accum_count {float(count)} after frame "
                 f"{i + 1}, not 1 (the camera moved)")
        if i:
            h, w = motion.shape[:2]
            own = torch.stack(torch.meshgrid(
                torch.arange(h, device=motion.device),
                torch.arange(w, device=motion.device), indexing="ij"), -1)
            moved = ((motion != own).any(-1) & (motion[..., 0] >= 0)).sum()
            if int(moved) == 0:
                fail(f"interactive: frame {i + 1}'s motion vectors are the "
                     f"identity")
            print(f"interactive: frame {i + 1}: {int(moved)} pixels "
                  f"reproject elsewhere", flush=True)
    shares = []
    for i in range(4):
        key = "walk_closest+inst+" + (f"seeded{i}" if i else "primary0")
        if key not in walks.args:
            fail(f"interactive: no {key} call captured")
        t_max = walks.args[key][0][2][7]
        shares.append(float(((t_max > 0.0) & (t_max < _TMAX)).float()
                            .mean()))
    print("interactive: the primary walk on the instanced bulk has t_max "
          "bounded by the seed on " + ", ".join(
              f"{x:.4f}" for x in shares) + " of its lanes on frames 1-4",
          flush=True)
    if shares[0] != 0.0 or min(shares[1:]) == 0.0:
        fail("interactive: frame 0's primary walk must have no seed and "
             "frames 2-4's a seed on some lanes")


def seed_effect(call, label) -> None:
    """What the seed does to one walk: the seeded call against the same
    rays with t_max unbounded again, through the kernel, with its step
    and leaf-event counts.  The hits must not change (the seed is a real
    intersection, so it bounds the closest hit from above)."""
    import torch

    from eidola_tpu_torch.ops import bvh_walk as W

    (walk, leaf_blocks, rays, max_steps), kw = call
    inst = kw.get("inst")
    twin = rays.clone()
    twin[7] = torch.where(twin[7] > 0.0, _TMAX, twin[7])
    P = rays.shape[1]
    stats = [torch.zeros((P, 2), dtype=torch.int32, device=rays.device)
             for _ in range(2)]
    got = [W.walk_closest(walk, leaf_blocks, r, max_steps, stats=st,
                          inst=inst) for r, st in zip((rays, twin), stats)]
    torch.cuda.synchronize()
    (t_s, k_s, _, _), (t_u, k_u, _, _) = got
    if not torch.equal(t_s.view(torch.int32), t_u.view(torch.int32)) or \
            not torch.equal(k_s >= 0, k_u >= 0):
        fail(f"seed ({label}): the seeded walk's hits differ from the "
             f"unseeded walk's on the same rays")
    ms = [time_ms(lambda r=r: W.walk_closest(walk, leaf_blocks, r, max_steps,
                                             inst=inst), 5)
          for r in (rays, twin)]
    (st_s, ev_s), (st_u, ev_u) = ((int(x[:, 0].sum()), int(x[:, 1].sum()))
                                  for x in stats)
    print(f"seed ({label}): seeded / unseeded on the same {P} packets: "
          f"walk steps {st_s} / {st_u} ({st_s / P:.1f} / {st_u / P:.1f} a "
          f"packet, {100.0 * (st_s / st_u - 1.0):+.1f}%), leaf events "
          f"{ev_s} / {ev_u} ({ev_s / P:.2f} / {ev_u / P:.2f} a packet, "
          f"{100.0 * (ev_s / ev_u - 1.0):+.1f}%); cuda {ms[0]:.4f} / "
          f"{ms[1]:.4f} ms; same winner on "
          f"{float((k_s == k_u).float().mean()):.6f} of the lanes",
          flush=True)


class SceneWatch:
    """While active, headless.load_scene returns `reuse` (a loaded (scene,
    camera)) when one is given, else loads as usual; either way it keeps
    what it returned in `loaded` and the alpha BVH's walk table, so that
    `key` can give that BVH's walk calls the suffix "+alpha"."""

    def __init__(self, reuse=None):
        self.reuse, self.loaded = reuse, None
        self.alpha_ptr = None

    def __enter__(self):
        from eidola_tpu_torch.app import headless

        self.orig = headless.load_scene

        def load(name, *, device):
            self.loaded = self.reuse or self.orig(name, device=device)
            alpha = self.loaded[0].bvh_alpha
            self.alpha_ptr = None if alpha is None else alpha.walk.data_ptr()
            return self.loaded

        headless.load_scene = load
        return self

    def __exit__(self, *exc):
        from eidola_tpu_torch.app import headless

        headless.load_scene = self.orig

    def key(self, name, args, kw):
        key = name + ("+inst" if kw.get("inst") is not None else "")
        return key + ("+alpha" if args[0].data_ptr() == self.alpha_ptr
                      else "")


class LedgerWatch:
    """While active, empties the ray ledger (ops/packets.RAY_LEDGER,
    RAY_DOORS) before each frame and keeps each frame's (door, live rays)
    entries."""

    def __enter__(self):
        from eidola_tpu_torch.app import headless
        from eidola_tpu_torch.ops import packets

        self.orig, self.frames = headless.make_step, []

        def make_step(cfg):
            step = self.orig(cfg)

            def counted(*args, **kw):
                packets.RAY_LEDGER.clear()
                packets.RAY_DOORS.clear()
                out = step(*args, **kw)
                self.frames.append(list(zip(packets.RAY_DOORS,
                                            packets.RAY_LEDGER)))
                return out
            return counted

        headless.make_step = make_step
        return self

    def __exit__(self, *exc):
        from eidola_tpu_torch.app import headless

        headless.make_step = self.orig


class Environ:
    """While active, sets the environment variables `env`, then restores
    them."""

    def __init__(self, env: dict):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _image_held(res, base, pixels: int = 0) -> tuple[str, bool]:
    """A variant's last frame against the default one: the max and mean
    abs difference over the image, the pixels at or past the max bound,
    and the pixels whose primary triangle differs (the G-buffer's), split
    into exact-t ties (the same depth) and hits at another depth (the
    variant's nearer or farther).  With no `pixels` the image must be
    bitwise the default's and a primary triangle may differ only at an
    exact-t tie.  With `pixels`: mean below MD_MEAN, and fewer than
    `pixels` past MD_MAX and fewer at another depth (a ray that meets an
    alpha card on the edge its two triangles share, tested in another
    space, may pass through it: tests/test_torch_options.py
    test_alpha_instanced_falls_through_like_jax)."""
    import numpy as np
    import torch

    img, ref = res["image"], base["image"]
    if img.shape != ref.shape or not np.isfinite(img).all():
        fail(f"image {img.shape} not finite or not {ref.shape}")
    d = np.abs(img - ref).max(-1)
    mean = float(np.abs(img - ref).mean())
    g, b = res["state"].gbuf, base["state"].gbuf
    other = g.tri != b.tri
    tie = other & (g.depth.view(torch.int32) == b.depth.view(torch.int32))
    nearer = other & ~tie & (g.depth < b.depth)
    n_other, n_tie, n = int(other.sum()), int(tie.sum()), other.numel()
    past = d >= MD_MAX
    n_past = int(past.sum())
    n_past_same = int((past & ~other.cpu().numpy()).sum())
    bounds = (f"mean {MD_MEAN}; under {pixels} pixels past {MD_MAX} and "
              f"under {pixels} at another depth" if pixels else
              "bitwise, another primary triangle only at an exact-t tie")
    text = (f"max abs diff {float(d.max()):.3e}, mean {mean:.3e}; "
            f"{n_past} pixels at or past {MD_MAX} ({n_past_same} of them "
            f"with the same primary triangle); primary triangle differs on "
            f"{n_other} of {n} pixels ({n_tie} exact-t ties, "
            f"{n_other - n_tie} at another depth, the variant's nearer on "
            f"{int(nearer.sum())}) (bounds: {bounds})")
    if pixels:
        ok = mean < MD_MEAN and max(n_past, n_other - n_tie) < pixels
    else:
        ok = float(d.max()) == 0.0 and n_other == n_tie
    return text, ok


def _walk_counts(walk, leaf_blocks, rays, max_steps, inst):
    """(steps, leaf events, hit lanes, ms) of walk_closest on these rays."""
    import torch

    from eidola_tpu_torch.ops import bvh_walk as W

    P = rays.shape[1]
    stats = torch.zeros((P, 2), dtype=torch.int32, device=rays.device)
    out = W.walk_closest(walk, leaf_blocks, rays, max_steps, stats=stats,
                         inst=inst)
    ms = time_ms(lambda: W.walk_closest(walk, leaf_blocks, rays, max_steps,
                                        inst=inst), 3)
    return (int(stats[:, 0].sum()), int(stats[:, 1].sum()), out, ms)


def alpha_walk_ab(label, call, base_alpha) -> None:
    """The variant's largest alpha-BVH walk against the default alpha BVH
    on the same rays: steps and leaf events a packet, hit lanes, time."""
    import torch

    (walk, leaf_blocks, rays, max_steps), kw = call
    P = rays.shape[1]
    st_v, ev_v, out_v, ms_v = _walk_counts(walk, leaf_blocks, rays,
                                           max_steps, kw.get("inst"))
    st_b, ev_b, out_b, ms_b = _walk_counts(base_alpha.walk,
                                           base_alpha.leaf_blocks, rays,
                                           max_steps, None)
    same_t = float((out_v[0].view(torch.int32) == out_b[0].view(torch.int32))
                   .float().mean())
    hv, hb = out_v[1] >= 0, out_b[1] >= 0
    depth = (hv != hb) | (hv & hb & ((out_v[0] - out_b[0]).abs()
                                     > 1e-4 * torch.maximum(out_v[0],
                                                            out_b[0])))
    print(f"{label}: largest alpha-BVH walk ({P} packets), this BVH / the "
          f"default flat SAH alpha BVH on the same rays: steps {st_v} / "
          f"{st_b} ({st_v / P:.2f} / {st_b / P:.2f} a packet, "
          f"{100.0 * (st_v / st_b - 1.0):+.1f}%), leaf events {ev_v} / {ev_b}"
          f" ({ev_v / P:.2f} / {ev_b / P:.2f} a packet, "
          f"{100.0 * (ev_v / ev_b - 1.0):+.1f}%); hit lanes "
          f"{float((out_v[1] >= 0).float().mean()):.4f} / "
          f"{float((out_b[1] >= 0).float().mean()):.4f}, t bitwise equal on "
          f"{same_t:.6f} of the lanes, another depth on "
          f"{int(depth.sum())}; cuda {ms_v:.4f} / {ms_b:.4f} ms",
          flush=True)


OPTIONS = (   # tag, environment, and the pixels that may be past the
    # max bound and at another depth than the default frame's; (f) read 2
    # and 18 of 2073600
    ("f", {"EIDOLA_ALPHA_FLAT": "0"}, 100),
)


def options_phase(base, base_loaded):
    """The JAX package's build option on the standin frame (bistro_standin
    1920x1080, default RenderConfig with the HitTest, the default
    traversal, 2 frames through the headless entry point, the switch set
    in the environment): (f) EIDOLA_ALPHA_FLAT=0, against `base`, the
    default standin frame of this call: frame 2's time and stages, the
    image (bound: the sharded frame's), the primary hits, the walk
    launches, the instanced alpha BVH and its largest alpha walk against
    the default alpha BVH on the same rays, checked bitwise against
    walk_ref.  Then the ray ledger (EIDOLA_COUNT_RAYS=1) on one more
    default frame.  Returns rows for the kernels line."""
    import torch

    from eidola_tpu_torch.ops import bvh_walk

    t_phase = time.perf_counter()
    base_ms = base["frame_ms"][1]
    print(f"options: the default standin frame 2 {base_ms:.1f} ms, stages "
          + json.dumps({k: round(v, 3) for k, v in
                        base["stage_ms_per_frame"].items()}), flush=True)
    rows = []
    alpha_key = "walk_closest+inst+alpha"
    for tag, env, pixels in OPTIONS:
        label = f"options ({tag}) " + " ".join(f"{k}={v}"
                                                 for k, v in env.items())
        watch = SceneWatch()
        walks = Capture(bvh_walk, WALKS, lambda a: a[2].shape[1], watch.key)
        with Environ(env):
            launches, res = run_phase(
                label, STANDIN, (1080, 1920, 3), 2, None, [walks],
                ("walk_closest+inst", "walk_any+inst", alpha_key),
                DRAINS + MXU, watch=(watch,))
        check_standin(res)
        check_calls(label, launches, walks.sizes)
        alpha = res["scene"].bvh_alpha
        ms2 = res["frame_ms"][1]
        print(f"{label}: scene build {res['load_s']:.1f}s; frame 2 "
              f"{ms2:.1f} ms against the default's {base_ms:.1f}"
              f" ({100.0 * (ms2 / base_ms - 1.0):+.1f}%); walk launches "
              + json.dumps({k: launches[k] for k in WALKS}), flush=True)
        print(f"{label}: the alpha BVH instanced: "
              f"{alpha.walk.shape[0]} nodes, a {alpha.leaf_blocks.shape[0]}"
              f"-leaf pool under {alpha.inst_inv.shape[0]} instances",
              flush=True)
        held, ok = _image_held(res, base, pixels)
        print(f"{label}: against the default frame: {held}", flush=True)
        if not ok:
            fail(f"{label}: the image is past the bounds of the default "
                 f"frame ({held})")
        alpha_walk_ab(label, walks.args[alpha_key], base_loaded[0].bvh_alpha)
        rows.append(("walk_closest", "options (" + tag + ") standin "
                     "1920x1080 default traversal, instanced alpha BVH",
                     len(walks.sizes[alpha_key]),
                     check_walk("walk_closest", walks.args[alpha_key],
                                f"largest options ({tag}) alpha-BVH "
                                f"traversal")))
        del res, alpha, walks, watch
        torch.cuda.empty_cache()
    # the default frame once more on its scene: how far frame 2 drifts
    # within the call
    _, again = run_phase("options: the default frame again", STANDIN,
                         (1080, 1920, 3), 2, None, [walk_capture()],
                         ("walk_closest+inst", "walk_any+inst",
                          "walk_closest"), DRAINS + MXU,
                         watch=(SceneWatch(base_loaded),))
    print(f"options: the default frame again: frame 2 "
          f"{again['frame_ms'][1]:.1f} ms (first run {base_ms:.1f}); "
          f"against the first run: " + _image_held(again, base)[0],
          flush=True)
    del again
    ledger_frame(base, base_loaded)
    print(f"options: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return rows


def ledger_frame(base, base_loaded) -> None:
    """The ray ledger (EIDOLA_COUNT_RAYS=1) on the default standin frame,
    in a run of its own so that its syncs stay out of the timed frames:
    frame 2's live rays per door, and the Mrays/s they give at the default
    frame 2's time."""
    ledger = LedgerWatch()
    with Environ({"EIDOLA_COUNT_RAYS": "1"}):
        _, res = run_phase("options: ray ledger", STANDIN, (1080, 1920, 3), 2,
                           None, [walk_capture()],
                           ("walk_closest+inst", "walk_any+inst",
                            "walk_closest"), DRAINS + MXU,
                           watch=(SceneWatch(base_loaded), ledger))
    doors = {}
    for door, n in ledger.frames[-1]:
        calls, rays = doors.get(door, (0, 0.0))
        doors[door] = (calls + 1, rays + n)
    total = sum(r for _, r in doors.values())
    if total <= 0:
        fail("options: the ray ledger counted no rays")
    base_ms = base["frame_ms"][1]
    print("options: ray ledger, frame 2: " + "; ".join(
        f"{d} {int(r)} rays in {c} calls" for d, (c, r) in doors.items())
        + f"; {int(total)} in all, {total / base_ms / 1e3:.3f} Mrays/s at "
        f"the default frame 2's {base_ms:.1f} ms; the counted frame against"
        f" the default: " + _image_held(res, base)[0], flush=True)


def write_inputs(tmp: str) -> tuple[str, str, dict]:
    """standin.glb from bistro_standin's parts and env.hdr, a 2048x1024
    equirect (utils/reference.write_inputs, what the stored JAX frames of
    the file scene were rendered from), and their sha256, which must be
    the ones the stored frames' `meta` records."""
    from eidola_tpu_torch.utils import reference

    files = reference.write_inputs(tmp)
    glb, hdr = files["glb"], files["hdr"]
    h, w = reference.ENV_SIZE
    print(f"gltf: wrote {glb['path']} ({glb['bytes']} bytes) in "
          f"{glb['seconds']:.2f}s and a {w}x{h} .hdr "
          f"({hdr['bytes']} bytes) in {hdr['seconds']:.2f}s; sha256 "
          f"{glb['sha256']} and {hdr['sha256']}", flush=True)
    shas = {k: v["sha256"] for k, v in files.items()}
    for frame in GLTF_FRAMES:
        path = os.path.join(reference.REF_DIR, reference.file_name(
            reference.GLTF_SCENE, 1920, 1080, 4, frame, "queue"))
        if not os.path.exists(path):
            fail(f"gltf: no stored JAX frame {frame} ({path})")
        stored = reference.load(path)["meta"].get("inputs")
        if stored != shas:
            fail(f"gltf: the written inputs' sha256 {shas} are not those "
                 f"that {os.path.basename(path)} was rendered from "
                 f"({stored})")
    return glb["path"], hdr["path"], shas


def held_frames(label, name, cfg, frames, argv, inputs=None) -> None:
    """`frames` ({frame index: linear hdr}) of a headless phase against
    the JAX package's stored frames of its flags (`argv`'s --orbit, and
    `inputs`' sha256 for a scene read from files) under the march the
    card runs; prints each reading and fails on a missing file or a
    miss."""
    from eidola_tpu_torch.render.tracer import _march_mode
    from eidola_tpu_torch.utils import reference

    march = _march_mode("cuda")
    orbit = float(argv[argv.index("--orbit") + 1]) if "--orbit" in argv \
        else 0.0
    misses = []
    for frame, hdr in frames.items():
        path = reference.find(name, cfg, frame, march, orbit, inputs)
        if path is None:
            fail(f"{label}: no stored reference for {name} frame {frame} "
                 f"under the {march} march, orbit {orbit}, inputs {inputs}")
        got = reference.compare(hdr, reference.load(path))
        print(reference.line(
            f"reference {label}: {name} {cfg.width}x{cfg.height} frame "
            f"{frame} against {os.path.basename(path)}", got), flush=True)
        if not got["ok"]:
            misses.append(frame)
    if misses:
        fail(f"{label}: frames {misses} past their stored JAX reference")


def gltf_phase(glb: str, hdr: str, tmp: str, shas: dict):
    """The headless app on the GLB and the .hdr, 3 frames with a saved
    state, then 2 more from it; the last frame of each run held against
    the JAX package's frame of the same index on the same files
    (`shas`)."""
    import numpy as np

    from eidola_tpu_torch.utils import reference
    from eidola_tpu_torch.utils.png import decode_png

    ckpt, png = os.path.join(tmp, "s.npz"), os.path.join(tmp, "f.png")
    args = ["--scene", glb, "-e", hdr] + GLTF
    walks = walk_capture()
    launches, res = run_phase(
        "gltf", args + ["--frames", "3", "--save-state", ckpt,
                        "--out", png],
        (1080, 1920, 3), 3, None, [walks],
        ("walk_closest+inst", "walk_any+inst", "walk_closest"), DRAINS + MXU)
    check_standin(res)
    scene = res["scene"]
    clamp = np.float32(4.0 * float(scene.env.integral))
    if scene.inst is None or res["env_mode"] != "hdr" or \
            np.float32(res["firefly_clamp"]) != clamp:
        fail(f"gltf: instanced {scene.inst is not None}, env_mode "
             f"{res['env_mode']}, firefly clamp {res['firefly_clamp']} (want "
             f"instanced, hdr, {clamp})")
    if scene.env.image.shape[:2] != reference.ENV_SIZE or \
            res["frame_idx"] != 3:
        fail(f"gltf: env {tuple(scene.env.image.shape)}, frame_idx "
             f"{res['frame_idx']} (want {reference.ENV_SIZE}, 3)")
    with open(png, "rb") as f:
        rgba = decode_png(f.read())
    if rgba.shape != (1080, 1920, 4) or (rgba[..., 3] != 255).any():
        fail(f"gltf: --out decodes to {rgba.shape}, not 1080x1920 RGB")
    check_calls("gltf", launches, walks.sizes)
    ms = res["ms_per_frame"]
    cfg, held = res["cfg"], {GLTF_FRAMES[0]: res["hdr"]}
    del res, scene
    again = walk_capture()
    _, res = run_phase(
        "gltf (--load-state)", args + ["--frames", "2",
                                       "--load-state", ckpt],
        (1080, 1920, 3), 2, None, [again],
        ("walk_closest+inst", "walk_any+inst", "walk_closest"), DRAINS + MXU,
        accum=5)
    if res["frame_idx"] != 5:
        fail(f"gltf: frame_idx {res['frame_idx']} after --load-state and 2 "
             f"frames, not 5")
    held[GLTF_FRAMES[1]] = res["hdr"]
    held_frames("gltf", reference.GLTF_SCENE, cfg, held, args, shas)
    print(f"gltf: frame_idx 3 after the first run, 5 after the reload; "
          f"the PNG of the last frame decodes to {rgba.shape[:2]}; firefly "
          f"clamp {clamp} = 4 x the env integral", flush=True)
    return walks, launches, ms


class ViewerWatch:
    """While active, records each frame the viewer's render thread renders
    (its config, camera and accumulation count: references, no sync);
    the worker's warm-up frames are left out."""

    def __init__(self):
        self.frames = []
        self.render_thread = None

    def __enter__(self):
        import threading

        from eidola_tpu_torch.app import viewer

        self.orig = viewer.make_step

        def make_step(cfg):
            step = self.orig(cfg)

            def watched(scene, cam, params, tm, state, timer=None):
                state, out = step(scene, cam, params, tm, state, timer)
                if threading.current_thread() is self.render_thread:
                    self.frames.append((cfg, cam, state.accum_count))
                return state, out
            return watched

        viewer.make_step = make_step
        return self

    def __exit__(self, *exc):
        from eidola_tpu_torch.app import viewer

        viewer.make_step = self.orig

    def full_with(self, cfg, cam=None) -> list:
        return [a for c, k, a in list(self.frames)
                if c == cfg and (cam is None or k is cam)]


class ViewerClient:
    """HTTP requests to a running viewer, and waits bounded by the phase's
    time limit that fail on a `busy` reporting a failure."""

    def __init__(self, vs, port: int):
        self.vs, self.base = vs, f"http://127.0.0.1:{port}"
        self.t_end = time.monotonic() + VIEWER_S

    def wait(self, cond, what) -> None:
        vs = self.vs
        while not cond():
            if vs.busy.startswith(("load failed", "compile failed",
                                   "render failed")):
                fail(f"viewer: {vs.busy}")
            if time.monotonic() > self.t_end:
                fail(f"viewer: no {what} within {VIEWER_S:.0f} s (busy "
                     f"{vs.busy!r}, frame {vs.frame})")
            time.sleep(0.02)

    def get(self, path) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.read()

    def post(self, path, body) -> bytes:
        import urllib.request

        req = urllib.request.Request(self.base + path, method="POST",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.status != 200:
                fail(f"viewer: POST {path} answered {r.status}")
            return r.read()

    def full_png(self):
        """The served image once it is a full frame (a preview is a
        quarter of the extent, upscaled by 4)."""
        from eidola_tpu_torch.utils.png import decode_png

        img = []

        def full():
            img[:] = [decode_png(self.get("/frame.png"))]
            return img[0].shape[:2] == (1080, 1920)

        self.wait(full, "full frame served")
        return img[0]


def viewer_phase(glb: str, hdr: str, headless_ms: float):
    """The viewer, in this process, takes the GLB and the .hdr through
    POST /scene and answers every endpoint on it."""
    import threading

    import numpy as np
    import torch

    from eidola_tpu_torch.app import viewer as V

    walks, watch = walk_capture(), ViewerWatch()
    report = {}
    with walks, watch:
        _reset_launches()
        vs, srv, threads = V.start(["--scene", "cornell", "--size", "1920",
                                    "1080", "--max-depth", "4", "--device",
                                    "cuda", "--port", "0"])
        watch.render_thread = threads[0]
        threads.append(threading.Thread(target=srv.serve_forever,
                                        daemon=True))
        threads[-1].start()
        try:
            report = viewer_steps(ViewerClient(vs, srv.server_address[1]),
                                  watch, glb, hdr)
        finally:
            vs.stop = True
            srv.shutdown()
            srv.server_close()
            for t in threads:
                t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            fail("viewer: a thread did not stop")
        torch.cuda.synchronize()
        launches = _launches()
    sv = report["serving"]
    full, prev = sv["full"], sv["preview"]
    print(f"viewer: the GLB loaded on the worker in {vs.load_s:.2f}s, "
          f"swapped (loaded and warmed up) {report['swap_s']:.2f}s after "
          f"POST /scene; the worker's warm-up frames since (ms): "
          + ", ".join(f"{x:.1f}" for x in report["warm"]), flush=True)
    print(f"viewer: while serving {json.dumps(sv['served'])} requests: "
          f"{sv['frames']} full frames and {sv['previews']} preview frames "
          f"({report['preview_size']}); full frame (step + copy to the "
          f"host) median {np.median(full):.1f} ms, mean {np.mean(full):.1f} "
          f"(" + ", ".join(f"{x:.1f}" for x in full) + f") against the "
          f"headless gltf phase's {headless_ms:.1f} ms; preview (step, "
          f"copy, encode) median {np.median(prev) if prev else 0.0:.1f} ms ("
          + ", ".join(f"{x:.1f}" for x in prev) + f"); the full frame's "
          f"PNG encode in the loop median {np.median(sv['png']):.1f} ms ("
          + ", ".join(f"{x:.1f}" for x in sv["png"]) + ")", flush=True)
    print(f"viewer: on the GLB in all {report['frames']} full frames and "
          f"{report['previews']} preview frames; a served 1920x1080 frame "
          f"({report['png_bytes']} bytes) encoded again outside the loop: "
          f"the codec {report['enc_ms']['codec']:.1f} ms, with the [0, 1] "
          f"to uint8 step as in the loop {report['enc_ms']['frame']:.1f} "
          f"ms; /stats fps {report['fps']:.3f}; "
          f"pick {report['pick']}; walk launches "
          + json.dumps({k: launches[k] for k in WALKS}), flush=True)
    print(f"viewer: {report['monitor']}", flush=True)
    for name in WALKS:
        if launches[name] <= 0 or name + "+inst" not in walks.args:
            fail(f"viewer: {name} was never launched on the instanced BVH")
    if max(launches[k] for k in DRAINS + MXU) != 0:
        fail(f"viewer: a drain kernel ran under the default traversal "
             f"({launches})")
    check_calls("viewer", launches, walks.sizes)
    return walks


def viewer_steps(client: ViewerClient, watch: ViewerWatch, glb: str,
                 hdr: str) -> dict:
    """The viewer phase's requests and checks, on a running viewer."""
    import dataclasses
    import threading

    import numpy as np

    from eidola_tpu_torch.app import viewer as V
    from eidola_tpu_torch.utils.monitor import DeviceMonitor
    from eidola_tpu_torch.utils.png import decode_png, encode_png

    vs, wait, get, post = client.vs, client.wait, client.get, client.post
    wait(lambda: vs.frame >= 3, "first 3 frames")
    if decode_png(get("/frame.png")).shape[:2] != (1080, 1920):
        fail("viewer: cornell's frame is not 1080x1920")
    n_warm = len(vs.times["warm"])
    post("/scene", {"scene": glb, "hdr": hdr})
    t0 = time.perf_counter()
    # swapped: the GLB is the scene and its config is warmed up
    wait(lambda: json.loads(get("/stats"))["scene"] == glb
         and vs.desired_cfg() in vs.ready_cfgs, "scene swap")
    swap_s = time.perf_counter() - t0
    n0, p0 = vs.frame, vs.preview_frames
    # settled: 3 frames on the GLB, the preview variant warmed up if the
    # frames engaged it, the worker idle
    wait(lambda: vs.frame >= n0 + 3 and not vs.busy
         and not vs.want_cfgs - vs.ready_cfgs, "3 frames on the GLB")
    scene, cfg = vs.scene, vs.base_cfg
    if not cfg.alpha_geometry or cfg.env_mode != "hdr" or scene.inst is None:
        fail(f"viewer: alpha_geometry {cfg.alpha_geometry}, env_mode "
             f"{cfg.env_mode}, instanced {scene.inst is not None} on the GLB")
    # serving: 6 full frames while a client fetches /frame.png as the
    # page does (again 60 ms after one arrives) and /stats every second
    for k in ("full", "preview", "png"):
        vs.times[k].clear()
    n1, p1 = vs.frame, vs.preview_frames
    served = {"frame.png": 0, "stats": 0}
    done = threading.Event()

    def client_loop():
        t_stats = 0.0
        while not done.is_set():
            get("/frame.png")
            served["frame.png"] += 1
            time.sleep(0.06)
            if time.monotonic() - t_stats > 1.0:
                get("/stats")
                served["stats"] += 1
                t_stats = time.monotonic()

    browser = threading.Thread(target=client_loop, daemon=True)
    browser.start()
    try:
        wait(lambda: vs.frame >= n1 + 6, "6 frames while serving")
    finally:
        done.set()
        browser.join(timeout=120)
    serving = {"full": list(vs.times["full"]),
               "preview": list(vs.times["preview"]),
               "png": list(vs.times["png"]), "frames": vs.frame - n1,
               "previews": vs.preview_frames - p1, "served": dict(served)}
    # orbit: a new camera, the image changes, the accumulation restarts
    wait(lambda: vs.accum >= 2.0, "accumulation")
    before = client.full_png()
    post("/input", {"type": "orbit", "dx": 40})
    cam = vs.cam
    wait(lambda: watch.full_with(cfg, cam), "a frame after the orbit")
    accum = float(watch.full_with(cfg, cam)[0])
    n1 = vs.frame
    wait(lambda: vs.frame >= n1 + 1, "the frame after the orbit served")
    after = client.full_png()
    if accum != 1.0 or np.array_equal(before, after):
        fail(f"viewer: after the orbit the accumulation count is {accum} "
             f"(want 1); image changed: {not np.array_equal(before, after)}")
    pick = json.loads(post("/pick", {"fy": 0.5, "fx": 0.5}))
    n_tris = int(scene.bvh.n_tris)
    if not pick["hit"] or not 0 <= pick["tri_id"] < n_tris:
        fail(f"viewer: pick at the centre {pick}")
    for on in (False, True):
        post("/config", {"denoise": on})
        want = dataclasses.replace(cfg, denoise=on)
        seen = len(watch.full_with(want))
        wait(lambda: len(watch.full_with(want)) > seen,
             f"a frame with denoise {on}")
    post("/param", {"name": "exposure", "value": 1.5})
    if float(vs.tm.exposure) != 1.5:
        fail("viewer: POST /param did not set the exposure")
    stats = json.loads(get("/stats"))
    want = {"triangles": n_tris,
            "textures": int(scene.textures.data.shape[0]),
            "punctual_lights": int(scene.lights.num_punc),
            "emissive_triangles": int(scene.lights.num_trig)}
    got = {k: stats[k] for k in want}
    if got != want or want["textures"] != 6:
        fail(f"viewer: /stats {got}, the scene {want} (6 textures)")
    png = get("/frame.png")
    u8 = np.ascontiguousarray(decode_png(png)[..., :3])
    img01 = u8.astype(np.float32) / 255.0
    enc_ms = {"codec": [], "frame": []}
    for _ in range(5):
        for key, fn in (("codec", lambda: encode_png(u8)),
                        ("frame", lambda: V._encode_png(img01))):
            t1 = time.perf_counter()
            fn()
            enc_ms[key].append((time.perf_counter() - t1) * 1e3)
    mon = DeviceMonitor("cuda", interval_s=0.0)
    mon.refresh()
    pcfg = V._descaled(cfg, 4)
    return {"swap_s": swap_s, "warm": list(vs.times["warm"])[n_warm:],
            "frames": vs.frame - n0, "previews": vs.preview_frames - p0,
            "preview_size": f"{pcfg.width}x{pcfg.height}",
            "serving": serving,
            "enc_ms": {k: float(np.median(v)) for k, v in enc_ms.items()},
            "png_bytes": len(png), "fps": stats["fps"], "pick": pick,
            "monitor": mon.summary()}


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
    each lane's Moller-Trumbore test of every triangle of its event's
    leaf (MT_DOT_OPS + MT_EPI_OPS)."""
    import torch

    from eidola_tpu_torch.ops.bvh_fused import NFEAT

    n = args[-1]
    ce = args[-2].shape[0]
    leaves = int(torch.unique(args[2]).numel())
    n_out = 4 if name == "mt_fused" else 1
    bytes_ = (leaves * NFEAT * 4 * n * 4 + ce * 128 * 4 * (8 + n_out)
              + ce * 4 * 8)
    flops = ce * 128 * n * (MT_DOT_OPS + MT_EPI_OPS)
    return _bound(bytes_, flops)


def walk_bound(walk, leaf_blocks, rays, stats, inst) -> tuple[float, str]:
    """Least time for one traversal on these inputs, from this run's
    counted work: the walk rows and leaf rows it can have touched (at
    most one row per walk step and one leaf per drained event, each read
    once), rays in and results out, against walk steps x 128 lanes x one
    slab test plus drained events x 128 lanes x leaf_size triangle
    tests.  An instanced event also reads its two indices and its
    instance's 12-float transform (at most every leaf's indices and every
    instance's transform once) and moves 128 rays to object space."""
    from eidola_tpu_torch.ops.bvh_walk import MT_FLOP, WALK_FLOP, XFORM_FLOP

    n = leaf_blocks.shape[1] // 12
    steps = int(stats[:, 0].sum())
    events = int(stats[:, 1].sum())
    bytes_ = (min(steps, walk.shape[0]) * 8 * 4
              + min(events, leaf_blocks.shape[0]) * n * 12 * 4
              + rays.numel() * 4 + rays[0].numel() * 4 * 4)
    flops = 128 * (steps * WALK_FLOP + events * n * MT_FLOP)
    if inst is not None:
        bytes_ += (min(events, inst[0].shape[0]) * 2 * 4
                   + min(events, inst[2].shape[0]) * 12 * 4)
        flops += 128 * events * XFORM_FLOP
    return _bound(bytes_, flops)


def mxu_bound(args) -> tuple[float, str]:
    """Least time for one mt_mxu call on these inputs: each event's leaf
    row and ray planes read once and its 4 result planes written once,
    against each lane's Moller-Trumbore test of every triangle of every
    event (the count drain_bound uses; the function tests all n
    triangles whatever the data)."""
    row, n = args[0], args[1]
    ce = row.shape[0]
    bytes_ = row.numel() * 4 + ce * 128 * 4 * (8 + 4)
    flops = ce * 128 * n * (MT_DOT_OPS + MT_EPI_OPS)
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
    kernel_ms = time_ms(F.launcher(name, *args)[0], 20)
    plain_ms = time_ms(lambda: ref(*args), 3)
    bound_ms, bound_by = drain_bound(name, args)
    if name == "mt_any_fused":
        any_work(args, label)
    print(f"{name} ({label}): {args[-2].shape[0]} events x 128 lanes, leaf "
          f"{args[-1]}, {args[0].shape[0]}-leaf table; bitwise equal to "
          f"plain; cuda {ms:.4f} ms (kernel alone {kernel_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def check_mxu(args, label) -> dict:
    """mt_mxu on a captured drain against mt_mxu_ref on the card."""
    import torch

    from eidola_tpu_torch.ops import bvh_mxu as M

    got = M.mt_mxu(*args)
    want = M.mt_mxu_ref(*args)
    torch.cuda.synchronize()
    err = _equal_bits(got, want)
    if err != 0.0:
        fail(f"mt_mxu ({label}): CUDA kernel differs from its plain version "
             f"(max abs err {err}); the tolerance is bitwise")
    ms = time_ms(lambda: M.mt_mxu(*args), 20)
    kernel_ms = time_ms(M.launcher(*args)[0], 20)
    plain_ms = time_ms(lambda: M.mt_mxu_ref(*args), 3)
    bound_ms, bound_by = mxu_bound(args)
    mxu_work(args, label)
    hit = float((got[0] < 1e30).float().mean())
    print(f"mt_mxu ({label}): {args[0].shape[0]} events x 128 lanes, leaf "
          f"{args[1]}; hit lanes {hit:.3f}; bitwise equal to plain; cuda "
          f"{ms:.4f} ms (kernel alone {kernel_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def any_work(args, label) -> None:
    """What this call's data asks of mt_any_fused's flags launch
    (csrc/bvh_fused.cu: any_flags_kernel with mt_tri4.cuh's any4), from
    the plain arithmetic: the lanes alive at an event's start (t_lim >
    t_min) and the warps they fill when packed; the (event, warp, group of
    four triangles) steps a warp takes before all its lanes have hit or
    are dead, and of the triangles those steps test, the share that some
    lane passes the u test for (the rest stop at the vote)."""
    import torch

    from eidola_tpu_torch.ops import bvh_fused as F

    cm_tab, anchor, dma_row, sp, valid, *planes = args[:-1]
    n = args[-1]
    ce, q = planes[0].shape[0], n // 4
    steps = past_vote = alive = warps = 0
    for s in range(0, ce, 512):
        e = slice(s, min(s + 512, ce))
        ox, oy, oz, dx, dy, dz, tmin, tlim = (p[e] for p in planes)
        ok = (valid[e] != 0)[:, None]
        feats = F._features(anchor[e], ox, oy, oz, dx, dy, dz)
        det, tn, un, vn = F._dots_sparse(cm_tab[dma_row[e].long()], feats, n)
        det2 = det * det
        ud, vd, td = un * det, vn * det, tn * det
        pre = (torch.abs(det) > 1e-12) & (ud >= 0.0) & (ud <= det2)
        hit = (pre & (vd >= 0.0) & (ud + vd <= det2)
               & (td > tmin[:, None] * det2) & (td < tlim[:, None] * det2)
               & ok[:, :, None])
        dead = ~(tlim > tmin) | ~ok                               # (E, 128)
        # a lane is done after group g when it hit in a group <= g
        done = (hit.reshape(-1, q, 4, 128).any(2).cumsum(1) > 0) | dead[:, None]
        live = ~torch.cat([dead[:, None], done[:, :-1]], 1)     # at g's start
        tested = live.reshape(-1, q, 4, 32).any(-1) & ok[:, :, None]
        pre_w = (pre.reshape(-1, q, 4, 128)
                 & live[:, :, None]).reshape(-1, q, 4, 4, 32).any(-1)
        steps += int(tested.sum())
        past_vote += int((pre_w & tested[:, :, None]).sum())
        n_alive = (~dead).sum(1)
        alive += int(n_alive.sum())
        warps += int(((n_alive + 31) // 32).sum())
    print(f"work mt_any_fused ({label}): {ce} events; {alive} of {ce * 128} "
          f"lanes alive at an event's start ({alive / (ce * 128):.4f}), "
          f"{warps} of {ce * 4} warps when packed ({warps / (ce * 4):.4f}); "
          f"{steps} of {ce * 4 * q} (event, warp, group of four) steps taken "
          f"({steps / (ce * 4 * q):.4f}); of the {4 * steps} triangles they "
          f"test, {past_vote} ({past_vote / max(4 * steps, 1):.4f}) pass a "
          f"lane's u test", flush=True)


def mxu_work(args, label) -> None:
    """The share of (event, warp, triangle) that pass mt_mxu's vote after
    the u test (a live lane with |det| > 1e-12 and 0 <= u <= 1)."""
    import torch

    from eidola_tpu_torch.ops import bvh_fused as F, bvh_mxu as M

    row, n, *planes = args
    ce = row.shape[0]
    past_vote = 0
    for s in range(0, ce, 2048):
        e = slice(s, min(s + 2048, ce))
        ox, oy, oz, dx, dy, dz, tmin, tlim = (p[e] for p in planes)
        cm, anchor = M.build_cmat(row[e], n)
        feats = F._features(anchor, ox, oy, oz, dx, dy, dz)
        det, _, un, _ = F._dots_sparse(cm.transpose(1, 2), feats, n)
        ok = torch.abs(det) > 1e-12
        u = un * torch.where(ok, 1.0 / det, 0.0)
        pre = ok & (u >= 0.0) & (u <= 1.0) & (tlim > tmin)[:, None]
        past_vote += int(pre.reshape(pre.shape[0], n, 4, 32).any(-1).sum())
    total = ce * n * 4
    print(f"work mt_mxu ({label}): {ce} events; {past_vote} of {total} "
          f"(event, warp, triangle) pass the vote ({past_vote / total:.4f})",
          flush=True)


def check_walk(name, call, label) -> dict:
    """The walk kernel on a captured traversal (flat, or instanced with
    its `inst` tables) against walk_ref(group=1): outputs and per-packet
    step/event counts bitwise."""
    import torch

    from eidola_tpu_torch.ops import bvh_walk as W

    (walk, leaf_blocks, rays, max_steps), kw = call
    inst = kw.get("inst")
    P = rays.shape[1]
    kern = getattr(W, name)
    any_hit = name == "walk_any"
    stats = torch.zeros((P, 2), dtype=torch.int32, device=rays.device)
    ref_stats = torch.zeros_like(stats)
    got = kern(walk, leaf_blocks, rays, max_steps, stats=stats, inst=inst)
    # the plain version runs once, timed by CUDA events: its check run is
    # its timed run (it takes seconds a call)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    want = W.walk_ref(walk, leaf_blocks, rays, any_hit, max_steps, group=1,
                      stats=ref_stats, inst=inst)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err = _equal_bits(got, want)
    if err != 0.0 or not torch.equal(stats, ref_stats):
        fail(f"{name} ({label}): CUDA kernel differs from walk_ref(group=1) "
             f"(max abs err {err}, counts equal "
             f"{torch.equal(stats, ref_stats)}); the tolerance is bitwise")
    ms = time_ms(lambda: kern(walk, leaf_blocks, rays, max_steps,
                              inst=inst), 5)
    kernel_ms = time_ms(W.launcher(name, walk, leaf_blocks, rays, max_steps,
                                   inst=inst)[0], 5)
    bound_ms, bound_by = walk_bound(walk, leaf_blocks, rays, stats, inst)
    s = stats.double()
    hit = float((got[1] >= 0).float().mean())
    shape = "flat" if inst is None else (
        f"instanced, {leaf_blocks.shape[0]}-leaf pool under "
        f"{inst[2].shape[0]} instances")
    print(f"{name} ({label}): {P} packets x 128 lanes, leaf "
          f"{leaf_blocks.shape[1] // 12}, {walk.shape[0]}-node walk table "
          f"({shape}); "
          f"bitwise equal to walk_ref(group=1), counts equal; walk steps "
          f"{int(s[:, 0].sum())} (mean {float(s[:, 0].mean()):.1f}, max "
          f"{int(s[:, 0].max())} a packet), leaf events {int(s[:, 1].sum())}"
          f" (mean {float(s[:, 1].mean()):.1f}); hit lanes {hit:.3f}; cuda "
          f"{ms:.4f} ms (kernel alone {kernel_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms (its one run, the check's), bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def synthetic_phase(dev) -> None:
    """Extra cases the frames do not give (utils/drain_case): runs of 1-32
    events of random sub-packets with an invalid tail and exact-t ties;
    then the same shape of runs with the edges (dets at the 1e-12
    threshold and 2^126, dead and all-hit warps, dead events)."""
    from eidola_tpu_torch.utils.drain_case import (make_case, mxu_args,
                                                   random_runs, torch_args)

    n, ce = 64, 4096
    for leaves, edge, seed in ((45056, False, 2), (4096, True, 3)):
        case = make_case(n, leaves, random_runs(ce - 96, 32, seed - 1), ce,
                         seed=seed, spread=0.0 if edge else 60.0, edge=edge)
        label = (f"synthetic{', edges' if edge else ''}, "
                 f"{ce - case['n_valid']} invalid tail rows")
        for name in DRAINS:
            args = (*torch_args(case, dev, name == "mt_fused"), n)
            check_drain(name, args, label)
            del args
        row, *planes = mxu_args(case, dev)
        check_mxu((row, n, *planes), label + " (dead rays)")


def single_frames(scene, cam, cfg, frames: int):
    """The single-process frames of `cfg` under the default traversal:
    (numpy images, ms per frame on a synchronised host clock, the last
    carried state)."""
    import torch

    from eidola_tpu_torch.render.config import default_params, default_tonemap
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    dev = cam.pos.device
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    state, step, out, ms = init_frame_state(cfg, cam), make_step(cfg), [], []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, o = step(scene, cam, params, tm, state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(o["image"].cpu().numpy())
    return out, ms, state


def _held(label, got, want) -> str:
    """Max and mean abs difference of each frame against the
    single-process one; fails past the JAX package's bounds on its
    sharded step (tests/test_parallel.py:45-46)."""
    import numpy as np

    parts = []
    for k, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"{label}: frame {k} shape {a.shape} != {b.shape} or "
                 f"not finite")
        d = np.abs(a - b)
        mx, mean = float(d.max()), float(d.mean())
        parts.append(f"frame {k} max {mx:.3e} mean {mean:.3e}")
        if not (mx < MD_MAX and mean < MD_MEAN):
            fail(f"{label}: frame {k} max abs diff {mx} / mean {mean} past "
                 f"{MD_MAX} / {MD_MEAN}")
    if len(got) != len(want):
        fail(f"{label}: {len(got)} frames, want {len(want)}")
    return "; ".join(parts)


def _primary_ties(label, got, tri, depth) -> None:
    """Where the last frame's primary triangles differ from the
    reference's, whether their depths do too (an exact-t tie is won by
    whichever leaf a packet visited first, and packets depend on the
    band)."""
    other = got[0] != tri
    dz = abs(got[1] - depth)[other]
    print(f"{label}: the last frame's primary triangle differs on "
          f"{int(other.sum())} of {other.size} pixels, the depth there by "
          f"at most {float(dz.max()) if dz.size else 0.0:.3e}", flush=True)


def _rank_lines(label, ranks) -> None:
    for r in ranks:
        walks = {k: r["launches"][k] for k in WALKS}
        print(f"{label}: rank {r['rank']}: ms/frame " + ", ".join(
            f"{m:.1f}" for m in r["ms"]) + f"; collective_summary of frame "
            f"1 {json.dumps(r['audit'])}; walk launches {json.dumps(walks)}"
            f"; rows {json.dumps(r['rows'])}", flush=True)
        if min(walks.values()) <= 0:
            fail(f"{label}: a walk kernel was not launched on rank "
                 f"{r['rank']} ({walks})")
        if max(r["launches"][k] for k in DRAINS + MXU) != 0:
            fail(f"{label}: a drain ran on rank {r['rank']} under the "
                 f"default traversal")


def _brute_instanced(bvh, o, d) -> str:
    """The nearest hit of one ray over every triangle of an instanced BVH
    (each global leaf's pool row tested in its instance's object space,
    ray_triangle, no BVH), and the walk-table nodes on the path to that
    leaf whose slab test (walk_ref's, without the t_best bound) rejects
    the ray: each with its entry and exit t and how far outside the box
    the hit point lies."""
    import torch

    from eidola_tpu_torch.ops.bvh_walk import _inv
    from eidola_tpu_torch.ops.intersect import ray_triangle

    n = bvh.leaf_size
    e = bvh.leaf_blocks.reshape(-1, n, 12)[bvh.leaf_mesh_row]
    xf = bvh.inst_inv[bvh.leaf_inst].reshape(-1, 3, 4)
    ot = (xf[:, :, :3] @ o + xf[:, :, 3])[:, None].expand(-1, n, 3)
    dt = (xf[:, :, :3] @ d)[:, None].expand(-1, n, 3)
    _, t, _, _ = ray_triangle(ot, dt, e[..., 0:3], e[..., 3:6], e[..., 6:9],
                              1e-4, 1e8)
    best = float(t.min())
    leaf = int(torch.argmin(t.min(dim=1).values))
    links = bvh.walk[:, 6:8].contiguous().view(torch.int32).long()
    node = int(torch.nonzero(links[:, 1] == leaf)[0, 0])
    miss = torch.where(links[:, 0] < 0, links.shape[0], links[:, 0])
    idx = torch.arange(links.shape[0], device=links.device)
    path = torch.nonzero((idx <= node) & (miss > node))[:, 0]
    box = bvh.walk[path, 0:6]
    lo = (box[:, 0:3] - o) * _inv(d)
    hi = (box[:, 3:6] - o) * _inv(d)
    tn = torch.minimum(lo, hi).max(dim=1).values
    tf = torch.maximum(lo, hi).min(dim=1).values
    bad = ~((tn <= tf) & (tf >= 1e-4))
    p = o + best * d
    out = torch.maximum(box[:, 0:3] - p, p - box[:, 3:6]).max(dim=1).values
    fails = [f"node {int(path[k])} (tn {float(tn[k]):.7g}, tf "
             f"{float(tf[k]):.7g}, hit point {float(out[k]):.3e} outside)"
             for k in torch.nonzero(bad)[:, 0].tolist()]
    return (f"{best:.4f} in global leaf {leaf}, {path.numel()} nodes on its "
            f"path, rejected by " + ("; ".join(fails) or "none"))


def band_packets_probe(scene, cam, cfg) -> None:
    """Where (c)'s primary hits can differ: a 540-row band is not whole
    8-row tiles, so a rank traces its primary rays as scanline packets
    (the single frame: 8x16 tiles), and its alpha queue march holds only
    its rays.  For each band's primary rays of a few frame seeds (salt k
    is frame k's), the HitTest closest hit (trace_closest, coherent, the
    card's queue march) of the band alone against the same rays in the
    whole image: the hits that differ, and for each such ray the two
    nearest alpha-BVH triangles it crosses, the opaque walk of the ray
    alone and _brute_instanced.  Then the opaque instanced walk alone,
    at the frame's step cap and at an unbounded one: the rays whose hit
    differs and the packets that reached the cap."""
    import torch

    from eidola_tpu_torch.ops import bvh_walk as W
    from eidola_tpu_torch.ops import packets
    from eidola_tpu_torch.ops import rng as erng
    from eidola_tpu_torch.ops.intersect import ray_triangle
    from eidola_tpu_torch.render.tracer import trace_closest
    from eidola_tpu_torch.scene.camera import spawn_rays

    h, w, n = cfg.height, cfg.width, cfg.height // 2
    full = lambda rows, v: torch.full((rows, w), v, device="cuda")
    tris = scene.bvh_alpha.leaf_blocks.reshape(-1, 12)
    differ, ties = 0, []   # (seed, row, column, t whole, t band)
    for salt in range(MD_PROBE_SEEDS):
        rng, o, d = spawn_rays(cam, h, w, erng.seed_pixels(
            h, w, salt, device="cuda"))
        whole = trace_closest(cfg, scene, o, d, full(h, 1e-4),
                              full(h, 1e8), rng, coherent=True)[1]
        for b in (slice(0, n), slice(n, h)):
            band = trace_closest(cfg, scene, o[b], d[b], full(n, 1e-4),
                                 full(n, 1e8), rng[b], coherent=True)[1]
            other = torch.nonzero(whole.tri[b] != band.tri)
            differ += other.shape[0]
            ties += [(salt, b.start + y, x, float(whole.t[b][y, x]),
                      float(band.t[y, x])) for y, x in other.tolist()]
    lines = []
    for salt, y, x, t_whole, t_band in ties[:4]:
        _, o, d = spawn_rays(cam, h, w, erng.seed_pixels(
            h, w, salt, device="cuda"))
        ray = lambda a: a[y, x].expand(tris.shape[0], 3)
        _, t, _, _ = ray_triangle(ray(o), ray(d), tris[:, 0:3],
                                  tris[:, 3:6], tris[:, 6:9], 1e-4, 1e8)
        t2 = torch.topk(t, 2, largest=False).values.tolist()
        one = lambda v: torch.full((1,), v, device="cuda")
        alone = packets.closest_hit(scene.bvh, o[y, x][None],
                                    d[y, x][None], one(1e-4), one(1e8))
        brute = _brute_instanced(scene.bvh, o[y, x], d[y, x])
        lines.append(f"seed {salt} ray ({y}, {x}): depth {t_whole:.4f}"
                     f" / {t_band:.4f}, nearest alpha t {t2[0]:.7g}, "
                     f"{t2[1]:.7g}; the opaque walk of the ray alone "
                     f"{float(alone.t[0]):.4f}, every opaque triangle "
                     f"tested: {brute}")
    print(f"multidevice: band probe, HitTest primary of each {n}-row "
          f"band alone vs in the whole image, {MD_PROBE_SEEDS} seeds: "
          f"hits differ on {differ} of {MD_PROBE_SEEDS * h * w} rays; "
          + ("; ".join(lines) or "none"), flush=True)
    for cap in (cfg.traversal_max_steps, 1 << 24):
        differ, at_cap = 0, [0, 0]
        for salt in range(MD_PROBE_SEEDS):
            _, o, d = spawn_rays(cam, h, w, erng.seed_pixels(
                h, w, salt, device="cuda"))
            for k, b in enumerate((slice(0, h), slice(0, n),
                                   slice(n, h))):
                with walk_capture() as calls:
                    rec = packets.closest_hit_img(
                        scene.bvh, o[b], d[b], full(b.stop - b.start,
                                                    1e-4),
                        full(b.stop - b.start, 1e8), max_steps=cap)
                (walk, leaf, rays, steps), kw = calls.args[
                    "walk_closest+inst"]
                stats = torch.zeros((rays.shape[1], 2),
                                    dtype=torch.int32, device="cuda")
                W.walk_closest(walk, leaf, rays, steps, stats=stats,
                               inst=kw["inst"])
                at_cap[min(k, 1)] += int((stats[:, 0] >= cap).sum())
                if k == 0:
                    whole = rec
                else:
                    differ += int((whole.tri[b] != rec.tri).sum())
        print(f"multidevice: band probe, opaque instanced primary walk, "
              f"step cap {cap}, {MD_PROBE_SEEDS} seeds: each band's "
              f"scanline packets against the whole image's 8x16 tiles:"
              f" hits differ on {differ} rays; packets at the cap: "
              f"{at_cap[0]} of the tiles', {at_cap[1]} of the bands'",
              flush=True)


def multidevice_phase():
    """The row-sharded frame (parallel/sharding.py) on bistro_standin at
    the headline frame's width, the default RenderConfig with the HitTest,
    the default traversal (no switch set, in this process and in the
    spawned ranks): (a) the single-process banded layout at 1920x1088 under
    band_context(8) against the same frames unbanded; (b) the sharded step
    at world size = the card count over NCCL at 1920x1080 (one rank per
    card; in this process when there is one card), its walks captured;
    (c) two ranks on one card over gloo (spawned processes), the only run
    in which rows cross between processes on the card.  Returns (b)'s walk
    capture and rank 0's launches."""
    import numpy as np
    import torch

    from eidola_tpu_torch.app.headless import alpha_geometry
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.ops.halo import band_context
    from eidola_tpu_torch.parallel import exchange as X
    from eidola_tpu_torch.parallel.sharding import (free_port, padded_height,
                                                    render_rank, run_ranks)
    from eidola_tpu_torch.render.config import RenderConfig

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scene, cam = load_scene("bistro_standin", device=dev)
    print(f"multidevice: bistro_standin loaded in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    alpha = alpha_geometry(scene)
    # (a) one process, 8 row bands (1088 = padded_height(1080, 8))
    cfg_a = RenderConfig(width=1920, height=padded_height(1080, 8),
                         alpha_geometry=alpha)
    runs = {}
    for name, bands in (("unbanded", 1), ("banded", 8)):
        _reset_launches()
        with band_context(bands):
            runs[name] = single_frames(scene, cam, cfg_a, MD_FRAMES_A)
        walks = {k: _launches()[k] for k in WALKS}
        print(f"multidevice (a) {name} 1920x1088: ms/frame " + ", ".join(
            f"{m:.1f}" for m in runs[name][1]) + f"; walk launches "
            f"{json.dumps(walks)}", flush=True)
        if min(walks.values()) <= 0:
            fail(f"multidevice (a) {name}: walk kernels not launched")
    print("multidevice (a) banded(8) against unbanded: "
          + _held("multidevice (a)", runs["banded"][0], runs["unbanded"][0]),
          flush=True)
    ga, gb = runs["banded"][2].gbuf, runs["unbanded"][2].gbuf
    _primary_ties("multidevice (a)", (ga.tri.cpu().numpy(),
                                      ga.depth.cpu().numpy()),
                  gb.tri.cpu().numpy(), gb.depth.cpu().numpy())
    del runs, ga, gb
    # the single-process frames (b) and (c) are held against
    cfg = RenderConfig(width=1920, height=1080, alpha_geometry=alpha)
    ref, ref_ms, ref_state = single_frames(scene, cam, cfg, MD_FRAMES)
    ref_gbuf = (ref_state.gbuf.tri.cpu().numpy(),
                ref_state.gbuf.depth.cpu().numpy())
    del ref_state
    print("multidevice: the single-process 1920x1080 frames, ms/frame "
          + ", ".join(f"{m:.1f}" for m in ref_ms), flush=True)
    job = dict(scene="bistro_standin", cfg=cfg, frames=MD_FRAMES,
               device="cuda", gbuf=True)
    # (b) world size = card count over NCCL
    world = torch.cuda.device_count()
    walks = walk_capture()
    if world == 1:
        group = X.init_group(0, 1, "nccl", f"tcp://localhost:{free_port()}")
        try:
            with walks:
                ranks = [render_rank(group, job, scene, cam)]
        finally:
            X.close_group()
    else:
        ranks = run_ranks(world, "nccl", render_rank, (job,), MD_RANKS_S)
    _rank_lines(f"multidevice (b) nccl x{world}", ranks)
    print(f"multidevice (b) nccl x{world} 1920x1080 against the "
          f"single-process frame: " + _held("multidevice (b)",
                                            ranks[0]["images"], ref),
          flush=True)
    _primary_ties("multidevice (b)", ranks[0]["gbuf"], *ref_gbuf)
    b_launches = ranks[0]["launches"]
    del ranks
    torch.cuda.empty_cache()
    # (c) two ranks on the one card over gloo: slabs staged through the host
    t0 = time.perf_counter()
    ranks = run_ranks(2, "gloo", render_rank, (job,), MD_RANKS_S)
    print(f"multidevice (c) gloo x2 on one card (every exchanged slab "
          f"staged through host memory): {time.perf_counter() - t0:.1f}s "
          f"with the processes' start and scene loads", flush=True)
    _rank_lines("multidevice (c) gloo x2, one card", ranks)
    print("multidevice (c) gloo x2 1920x1080 against the single-process "
          "frame: " + _held("multidevice (c)", ranks[0]["images"], ref),
          flush=True)
    _primary_ties("multidevice (c)", ranks[0]["gbuf"], *ref_gbuf)
    band_packets_probe(scene, cam, cfg)
    if not np.isfinite(ranks[0]["images"][-1]).all():
        fail("multidevice (c): image not finite")
    return (walks if world == 1 else None), b_launches


def golden_phase() -> None:
    """The golden config through the walk kernel on the card."""
    import numpy as np
    import torch

    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    dev = torch.device("cuda")
    for key, env_mode in GOLDENS.items():
        cfg = RenderConfig(width=64, height=64, max_depth=2,
                           traversal_max_steps=1024, env_mode=env_mode,
                           alpha_geometry=key == "alpha")
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
                max(launches[k] for k in DRAINS + MXU) != 0:
            fail(f"golden {key}: not traced through the walk kernel "
                 f"({launches})")


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


def fidelity_phase() -> None:
    """The port's root tools (eidola_tpu_torch/tools/) on the card: the
    per-stage fidelity table and the ten captures of cornell and alpha at
    the stored small size, each image within 0.02 mean abs of JAX's file
    of the card's march (alpha's `_queue` files), with the table's rows
    beside JAX's, every ray through the walk kernels and no drain; then
    torch's gather / sort / argsort / cumsum rates at a 1080p frame's
    rays."""
    import torch

    from eidola_tpu_torch.tools import (fidelity_captures, fidelity_metrics,
                                        perf_gather)

    def tool(fn, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = fn(argv)
        for line in out.getvalue().splitlines():
            if not line.startswith("{"):
                print(f"fidelity: {line}", flush=True)
        return res

    dev = ["--device", "cuda", "--size", *FIDELITY_SIZE]
    _reset_launches()
    table = tool(fidelity_metrics.run, dev + [
        "--frames", FIDELITY_FRAMES, "--spp", FIDELITY_SPP])
    with tempfile.TemporaryDirectory(prefix="eidola_caps_") as tmp:
        caps = {scene: tool(fidelity_captures.run, dev + [
            "--scene", scene, "--out", os.path.join(tmp, scene)])
            for scene in fidelity_metrics.SCENES}
    launches = _launches()
    print(f"fidelity: launches {json.dumps(launches)}", flush=True)
    if min(launches[k] for k in WALKS) <= 0 or \
            max(launches[k] for k in DRAINS + MXU) != 0:
        fail(f"fidelity: not traced through the walk kernels ({launches})")
    for scene in fidelity_metrics.SCENES:
        for what, held in (("table", table["jax"].get(scene)),
                           ("captures", caps[scene]["jax"])):
            if held is None or not held["ok"]:
                fail(f"fidelity: {scene}'s {what} against JAX's: {held}")
            if scene == "alpha" and not held["file"].endswith("_queue.npz"):
                fail(f"fidelity: alpha's {what} held against "
                     f"{held['file']}, not the queue march's file")
    rows = perf_gather.measure(perf_gather.RAYS, torch.device("cuda"))
    print(f"fidelity: perf_gather on {card_line()}, R = {perf_gather.RAYS}",
          flush=True)
    for r in rows:
        print(f"fidelity: {perf_gather.row_line(r, perf_gather.RAYS)}",
              flush=True)


class UploadWatch:
    """While active, keeps the host tree of each scene upload
    (scene/data.py's batched_device_put); the upload still runs."""

    def __init__(self):
        self.trees = []

    def __enter__(self):
        from eidola_tpu_torch.scene import data

        self.orig = data.batched_device_put

        def kept(tree, device):
            self.trees.append(tree)
            return self.orig(tree, device)

        data.batched_device_put = kept
        return self

    def __exit__(self, *exc):
        from eidola_tpu_torch.scene import data

        data.batched_device_put = self.orig


def _leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def upload_line(host, label: str) -> None:
    """A scene's host tree onto the card through batched_device_put and
    through to_device, in turns, 3 each: the host-to-device copies and the
    ms of each (synchronised host clock); the two results bitwise equal
    and every batched leaf at a 256-byte offset; and the pinned host
    memory torch's caching allocator held before them."""
    import numpy as np
    import torch

    from eidola_tpu_torch.utils import transfer as TT

    # page-locked memory that torch's caching host allocator holds after
    # the app's load (batched_device_put stages in pageable memory)
    held = torch.cuda.host_memory_stats().get("allocated_bytes.current", 0)
    names = ("batched_device_put", "to_device")
    runs = {k: [] for k in names}
    for turn in range(3):
        outs = {}
        for name in names:
            torch.cuda.synchronize()
            before = TT.COPIES[0]
            t0 = time.perf_counter()
            outs[name] = getattr(TT, name)(host, "cuda")
            torch.cuda.synchronize()
            runs[name].append((TT.COPIES[0] - before,
                               (time.perf_counter() - t0) * 1e3))
        if turn == 0:
            bits = lambda t: (t.view(torch.int32)
                              if t.dtype == torch.float32 else t)
            dtypes = set()
            for a, b in zip(_leaves(outs[names[0]]), _leaves(outs[names[1]]),
                            strict=True):
                if b is None:
                    continue
                dtypes.add(a.dtype)
                if a.data_ptr() % TT.ALIGN or not torch.equal(bits(a),
                                                              bits(b)):
                    fail(f"upload ({label}): a batched leaf is unaligned or "
                         f"differs from to_device's")
            if runs[names[0]][0][0] > len(dtypes):
                fail(f"upload ({label}): {runs[names[0]][0][0]} copies for "
                     f"{len(dtypes)} dtypes")
        del outs
    arrays = [np.asarray(x) for x in _leaves(host)
              if x is not None and not hasattr(x, "data_ptr")]
    mb = sum(a.size * (8 if a.dtype.kind in "iu" else 4 if a.dtype.kind
                       == "f" else a.itemsize) for a in arrays) / 2**20
    print(f"upload ({label}; {card_line()}): {len(arrays)} numpy leaves, "
          f"{mb:.1f} MiB on the card; " + "; ".join(
              f"{name} {runs[name][0][0]} host-to-device copies, ms "
              + ", ".join(f"{ms:.1f}" for _, ms in runs[name])
              for name in names)
          + f"; torch's pinned host memory after the app's load: {held} B",
          flush=True)
    torch.cuda.empty_cache()


def build_phase() -> None:
    from eidola_tpu_torch import bench
    from eidola_tpu_torch.native import native_build
    from eidola_tpu_torch.utils.cuda_build import (CUDA_SOURCES,
                                                   build_together, cuda_build,
                                                   ptxas_summary)

    if (bench.WALKS, bench.DRAINS, bench.MXU) != (WALKS, DRAINS, MXU):
        fail("the kernel groups differ from eidola_tpu_torch/bench.py's")
    native = native_build()
    if native is None:
        fail("g++ not found: the port's C++ scene builders need it")
    builds = [cuda_build(n) for n in CUDA_SOURCES] + [native]
    t0 = time.perf_counter()
    build_together(builds)
    print(f"build: {', '.join(b.name for b in builds)} together in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for b in builds:
        for k in ptxas_summary(b.log):
            print(f"build: {b.name}: {k['kernel']}: {k['registers']} "
                  f"registers, {k['spill_stores']} / {k['spill_loads']} bytes "
                  f"of spill stores / loads, {k['smem']} bytes of shared "
                  f"memory", flush=True)


def main() -> None:
    t_start = time.perf_counter()
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

    lap = Laps()
    set_numerics()
    build_phase()
    lap("build")

    di_cap, gi_cap, gx_cap = drain_capture(), walk_capture(), drain_capture()
    di_launches, _ = run_phase("DI (xla)", DI_ARGS, (1080, 1920, 3), 2, "xla",
                               [di_cap], DRAINS, WALKS + MXU)
    lap("DI (xla)")
    gi_launches, gi = run_phase("GI", GI_ARGS, (1080, 1920, 3), 2, None,
                                [gi_cap], WALKS, DRAINS + MXU)
    reference_check("GI", "bistro_flat", gi)
    del gi
    lap("GI")
    run_phase("GI (xla, 960x540)", GI_XLA_ARGS, (540, 960, 3), 1, "xla",
              [gx_cap], DRAINS, WALKS + MXU)
    torch.cuda.empty_cache()
    lap("GI (xla, 960x540)")

    times = {}
    for name in DRAINS:
        times[name] = check_drain(name, di_cap.args[name][0],
                                  "largest DI frame drain")
        check_drain(name, gx_cap.args[name][0], "largest GI (xla) drain")
    del di_cap, gx_cap
    for name in WALKS:
        times[name] = check_walk(name, gi_cap.args[name],
                                 "largest GI-frame traversal")
    del gi_cap
    torch.cuda.empty_cache()
    lap("kernels (DI, GI calls)")

    # the headline frame with no switch set: every traversal through the
    # walk kernels, the instanced bulk ("+inst") and the flat alpha BVH;
    # the app's own readout (not --quiet) kept apart
    st_walks, st_scene, st_up = walk_capture(), SceneWatch(), UploadWatch()
    app_out = io.StringIO()
    st_launches, st = run_phase(
        "standin", [a for a in STANDIN if a != "--quiet"], (1080, 1920, 3),
        2, None, [st_walks],
        ("walk_closest+inst", "walk_any+inst", "walk_closest"),
        DRAINS + MXU, watch=(st_scene, st_up,
                             contextlib.redirect_stdout(app_out)))
    check_standin(st)
    reference_check("standin", "bistro_standin", st)
    app_lines = app_out.getvalue().splitlines()
    for line in app_lines:
        if line.startswith("load ") or line in st["profiler"].splitlines():
            print(f"standin: the app's readout: {line}", flush=True)
    if not any(line.startswith("Render ") for line in app_lines):
        fail("standin: the app printed no \"Render\" scope")
    upload_line(st_up.trees[0], "bistro_standin SceneData")
    del st_up, app_out
    lap("standin")
    bench_phase(st_scene.loaded, st["load_s"])
    torch.cuda.empty_cache()
    lap("bench")
    # the options on the same frame, against it
    op_rows = options_phase(st, st_scene.loaded)
    del st, st_scene
    torch.cuda.empty_cache()
    lap("options")
    st_sizes = st_walks.sizes
    check_calls("standin", st_launches, st_sizes)
    # the interactive frame: moving camera, spatiotemporal ReSTIR,
    # visibility reuse and the seeded primary walk, every traversal
    # through the walk kernels
    from eidola_tpu_torch.ops import bvh_walk

    watch, frames = PrimaryWatch(), FrameWatch()
    it_walks = Capture(bvh_walk, WALKS, lambda a: a[2].shape[1], watch.key)
    it_launches, it = run_phase(
        "interactive", INTERACTIVE, (1080, 1920, 3), 4, None,
        [it_walks], (PRIMARY0, SEEDED, "walk_any+inst", "walk_closest"),
        DRAINS + MXU, accum=1, watch=(watch, frames))
    check_interactive(it, frames, it_walks)
    held_frames("interactive", "bistro_standin", it["cfg"],
                {i: frames.frames[i][2] for i in INTERACTIVE_FRAMES},
                INTERACTIVE)
    del it, frames
    check_calls("interactive", it_launches, it_walks.sizes)
    torch.cuda.empty_cache()
    lap("interactive")
    # the scene pipeline: a GLB and an .hdr through the headless app, then
    # dropped into the viewer
    with tempfile.TemporaryDirectory(prefix="eidola_smoke_") as tmp:
        glb, hdr, shas = write_inputs(tmp)
        gl_walks, _, gl_ms = gltf_phase(glb, hdr, tmp, shas)
        torch.cuda.empty_cache()
        lap("gltf")
        vw_walks = viewer_phase(glb, hdr, gl_ms)
    torch.cuda.empty_cache()
    lap("viewer")
    sd_cap = drain_capture()
    sd_launches, sd = run_phase(
        "standin DI (xla)", STANDIN_DI, (1080, 1920, 3), 1, "xla",
        [sd_cap], DRAINS, WALKS + MXU)
    check_standin(sd)
    del sd
    lap("standin DI (xla)")
    mx_cap = mxu_capture()
    mx_launches, mx = run_phase(
        "standin mxu (DI, xla)", STANDIN_DI, (1080, 1920, 3), 1, "xla",
        [mx_cap], MXU, DRAINS + WALKS, mt="mxu")
    check_standin(mx)
    del mx
    torch.cuda.empty_cache()
    lap("mxu (xla)")
    md_walks, md_launches = multidevice_phase()
    torch.cuda.empty_cache()
    lap("multidevice")
    st_times = {
        "walk_closest+inst": check_walk(
            "walk_closest", st_walks.args["walk_closest+inst"],
            "largest standin instanced traversal"),
        "walk_any+inst": check_walk(
            "walk_any", st_walks.args["walk_any+inst"],
            "largest standin instanced occlusion traversal"),
        "walk_closest": check_walk(
            "walk_closest", st_walks.args["walk_closest"],
            "largest standin alpha-BVH traversal")}
    del st_walks
    it_times = {
        "walk_closest": check_walk(
            "walk_closest", it_walks.args[SEEDED],
            "interactive frame-4 seeded primary, instanced"),
        "walk_any": check_walk(
            "walk_any", it_walks.args["walk_any+inst"],
            "largest interactive instanced occlusion traversal")}
    # beside it, printed and not held to anything: frame 0's primary,
    # which has no seed yet (another view: the first orbit also changes
    # the field of view), and the seeded call's own rays unseeded
    check_walk("walk_closest", it_walks.args[PRIMARY0],
               "interactive frame-0 primary (unseeded), instanced")
    seed_effect(it_walks.args[SEEDED], "interactive frame 4, instanced")
    del it_walks
    gl_times = {k: check_walk(k.split("+")[0], gl_walks.args[k], label)
                for k, label in (
                    ("walk_closest+inst", "largest GLB instanced traversal"),
                    ("walk_any+inst",
                     "largest GLB instanced occlusion traversal"),
                    ("walk_closest", "largest GLB alpha-BVH traversal"))}
    gl_sizes = gl_walks.sizes
    del gl_walks
    vw_times = {k: check_walk(k.split("+")[0], vw_walks.args[k], label)
                for k, label in (
                    ("walk_closest+inst",
                     "largest viewer instanced traversal"),
                    ("walk_any+inst",
                     "largest viewer instanced occlusion traversal"))}
    vw_sizes = vw_walks.sizes
    del vw_walks
    md_times = {} if md_walks is None else {
        k: check_walk(k.split("+")[0], md_walks.args[k], label)
        for k, label in (
            ("walk_closest+inst",
             "largest multidevice (b) rank-0 instanced traversal"),
            ("walk_any+inst",
             "largest multidevice (b) rank-0 instanced occlusion traversal"))}
    del md_walks
    torch.cuda.empty_cache()
    sd_times = {name: check_drain(
        name, sd_cap.args[name][0],
        "largest standin DI drain (instanced, object space)")
        for name in DRAINS}
    del sd_cap
    times["mt_mxu"] = check_mxu(mx_cap.args["mt_mxu"][0],
                                "largest standin mxu drain")
    del mx_cap
    torch.cuda.empty_cache()
    lap("kernels (the frames' largest calls)")
    synthetic_phase(torch.device("cuda"))
    lap("synthetic")
    golden_phase()
    lap("goldens")
    entry_phase()
    lap("entry")
    reference_phase()
    lap("reference")
    fidelity_phase()
    lap("fidelity")

    # (kernel, path, launches in that phase, times on its largest call)
    rows = ([(k, "DI bistro_flat 1920x1080", di_launches[k], times[k])
             for k in DRAINS]
            + [(k, "GI bistro_flat 1920x1080 default traversal",
                gi_launches[k],
                times[k]) for k in WALKS]
            + [(k.split("+")[0], "standin 1920x1080 default traversal, "
                + ("instanced BVH" if "+" in k else "alpha BVH"),
                len(st_sizes[k]), st_times[k]) for k in st_times]
            + [(k, "interactive standin 1920x1080 default traversal (orbit, "
                "spatiotemporal, shadow cadence 4, primary seed), "
                + ("seeded primary, instanced BVH" if k == "walk_closest"
                   else "instanced BVH"), it_launches[k], it_times[k])
               for k in WALKS]
            + [(k.split("+")[0], "GLB standin + .hdr 1920x1080 default "
                "traversal "
                "(headless), " + ("instanced BVH" if "+" in k
                                  else "alpha BVH"),
                len(gl_sizes[k]), gl_times[k]) for k in gl_times]
            + [(k.split("+")[0], "viewer: GLB standin + .hdr 1920x1080 "
                "default traversal, instanced BVH", len(vw_sizes[k]),
                vw_times[k])
               for k in vw_times]
            + [(k.split("+")[0], "multidevice (b): standin 1920x1080 "
                "default traversal, the sharded step at world size 1 over "
                "NCCL, rank 0,"
                " instanced BVH", md_launches[k.split("+")[0]], md_times[k])
               for k in md_times]
            + [(k, "standin DI 1920x1080 xla", sd_launches[k], sd_times[k])
               for k in DRAINS]
            + [(k, "standin DI 1920x1080 mxu", mx_launches[k], times[k])
               for k in MXU]
            + [(k, path, n, t) for k, path, n, t in op_rows])
    print("chip_smoke: seconds per phase " + json.dumps(
        {k: round(v, 1) for k, v in lap.seconds.items()}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"kernels' build included", flush=True)
    line = {"kernels": [
        {"name": k, "path": path, "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][0], "launches": n, **t, "library_ms": None}
        for k, path, n, t in rows]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
