"""Regenerate the JAX package's reference frames in tests/golden_torch/
(CPU, fixed seeds), against which the port's frames are held.

    JAX_PLATFORMS=cpu python tests/golden_torch/regen.py [NAME ...]

NAME is a key of FULL, SMALL, QUEUE, LONG, INTERACTIVE or FIDELITY
(default: DEFAULT, every frame file stored here; hours of JAX on a CPU).
FIDELITY names run by name, never beside a frame name in one process.

* FULL: bench.py's frame (bench.py:79-113): `load_scene(name)`, 1920x1080,
  max_depth 4, the .hdr environment when the scene has one, the alpha
  HitTest when it has an alpha-tested material, default params and
  tonemap, the scene's camera at every step.  Frames 0 and 1 are
  rendered; frame 1 (the port bench's last warm-up frame) is stored as
  two statistics of its linear `hdr`: the pixels on a stride-4 lattice
  (`lattice`, hdr[::4, ::4], float16) and the 8x8 block means
  (`blocks`, float32).  About 6 min a frame on 8 CPU cores and ~9 GiB of
  memory for bistro_standin: run it in the background.
* SMALL: 272x136, max_depth 4, traversal_max_steps 1024, 4 frames;
  frame 3's whole `hdr` (float32) is stored.  At this size the frame
  tiles (136 % 8 == 0, 272 % 16 == 0) and its half-resolution GI field
  (136x68) does not (68 % 8 == 4), as at 1920x1080 (540 % 8 == 4).
* QUEUE: a FULL or SMALL scene with an alpha-tested material under
  EIDOLA_ALPHA_MARCH=queue, the alpha HitTest's march on a compacted
  queue in staged capacities (the default on an accelerator; the CPU
  default runs the hops in lockstep and draws another rng stream, so the
  two frames differ by noise): `<scene>_<W>x<H>_d4_f<frame>_queue.npz`,
  the frame a card renders with no switch set.  `mini_grove_queue3`
  renders at 400x200 (the tiling pattern of 272x136) with
  EIDOLA_MARCH_MIN=2048: its primary march's lap capacities are then
  [32768, 8192, 2048], three stages as at 1920x1080, and each takes a
  lap (~16.7k rays start it, above the second capacity; at 272x136
  ~7.7k start it, below 8192, the least second capacity that any
  EIDOLA_MARCH_DIV / EIDOLA_MARCH_MIN pair gives, so the first stage
  never runs there): `mini_grove_400x200_d4_f3_queue_min2048.npz`.

* LONG: a FULL or SMALL scene's later frame, the last that a bench run
  times: frame 41 (2 warm-up + 40 timed frames) of cornell and
  mini_grove at 272x136 and of bistro_flat and stress at 1920x1080
  (42 JAX frames: ~80 min for bistro_flat), and frame 4 of
  bistro_standin under the queue march (chip_smoke.py's bench phase,
  2 + 3 frames).  The accumulated frame's expectation moves with the
  temporal history (JAX's frame 41 at 272x136 stands 0.02-0.05 mean
  abs from its frame 3), so an earlier frame cannot stand in for it.

* FIDELITY: the outputs of the JAX package's root fidelity tools, which
  eidola_tpu_torch/tools/ is held against, computed by the tools' own
  functions (loaded with importlib; their `main()`, which writes
  docs/fidelity/, is never called):
  - `fidelity_<scene>_<W>x<H>_f<frames>_s<spp>[_queue].npz`: the
    per-stage table of tools/fidelity_metrics.py (`_oracle`,
    `_pipeline`, `metrics`; the configs of its `main`, :92-119): the two
    oracles' and the three stages' images (float32) and, in `meta`, the
    rows.  Its import sets EIDOLA_CHUNK=256 (:31) before anything
    imports eidola_tpu.ops.bvh, which reads it once, so these names run
    in a process of their own;
  - `captures_<scene>_<W>x<H>_f<frames>[_queue].npz`: the ten captures
    of tools/fidelity_captures.py (its `render`, the capture list of its
    `main`, :80-102), each the frame's LDR `image` (float32).
  At 32x32 (6 frames, 6 spp; captures 1 frame) cornell and alpha under
  the CPU's lockstep march, alpha again under the queue march (the
  card's); at 96x96 the JAX tool's default table (48 frames, 96 spp) of
  cornell and of alpha under the queue march.  cornell has no
  alpha-tested material: one file serves both marches.

* INTERACTIVE: the JAX package's headless app itself
  (`eidola_tpu.app.headless.run`), run in this process on chip_smoke.py's
  argument lists, each frame's linear `hdr` taken by wrapping the
  module's `make_step` (`run` looks the name up at call time, as
  chip_smoke.py's FrameWatch wraps the port's):
  - `bistro_standin_interactive`: chip_smoke.py's INTERACTIVE (the
    standin at 1920x1080, 4 frames, the camera orbiting 0.01 rad a frame,
    ReSTIR DI spatiotemporal, shadow cadence 4, the seeded primary walk)
    under the queue march, the card's; frames 1 (the first camera move,
    where the field of view changes) and 3 (the last) stored as FULL
    files, `bistro_standin_1920x1080_d4_f{1,3}_queue_interactive.npz`;
  - `mini_grove_interactive`, `mini_grove_interactive_queue`: the same
    flags on mini_grove at 272x136 under the lockstep and the queue
    march, frame 3's whole `hdr`;
  - `standin_glb`: chip_smoke.py's GLTF run on the files that
    eidola_tpu_torch.utils.reference.write_inputs writes (the standin as
    a GLB and a 2048x1024 .hdr) under the queue march: `--frames 3
    --save-state`, then `--load-state --frames 2`; the first run's last
    frame (2) and the resumed run's last (4) stored as FULL files,
    `standin_glb_1920x1080_d4_f{2,4}_queue.npz`, their `meta` with the
    inputs' sha256 (`inputs`).
  Their `meta` also records the argument list (`argv`, the files by
  their names), the frame's flags (`restir_mode`, `shadow_cadence`,
  `primary_seed`, `orbit`), as RenderConfig fields of the config JAX's
  app built, and the seconds of every frame of the run.  The JAX
  package's native host builders must be loaded (else the run stops).

Each file `<scene>_<W>x<H>_d<depth>_f<frame>.npz` also holds `meta`, a
JSON string: the config fields, the frame index, the command, the JAX
version, whether the JAX native host builders were loaded, and the
seconds each frame took; a QUEUE file also the march switches it was
rendered under (`env`).
"""
import dataclasses
import importlib.util
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# the env var alone does not beat a registered TPU plugin (see
# tests/conftest.py) -- force it through jax.config too
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from eidola_tpu_torch.utils.reference import (  # noqa: E402
    BLOCK, CONFIG_FIELDS, FLAG_DEFAULTS, GLTF_SCENE, block_means, file_name,
    write_inputs)

HERE = os.path.dirname(os.path.abspath(__file__))
FULL = {"bistro_standin": {}, "bistro_flat": {}, "bistro_hdr": {},
        "stress": {"n": 16}}
SMALL = {"mini_grove": {}, "cornell": {}}
# name: (scene, the march switches, the file name's tag, a SMALL size)
QUEUE = {"mini_grove_queue": ("mini_grove", {}, "", None),
         "mini_grove_queue3": ("mini_grove", {"EIDOLA_MARCH_MIN": "2048"},
                               "min2048", (400, 200)),
         "bistro_standin_queue": ("bistro_standin", {}, "", None),
         "bistro_hdr_queue": ("bistro_hdr", {}, "", None)}
# name: (scene, march, frames rendered): the bench's last timed frame
# (2 warm-up frames + 40 timed: frame 41), and chip_smoke.py's bench
# phase's (2 + 3: frame 4)
LONG = {"cornell_f41": ("cornell", "auto", 42),
        "mini_grove_f41": ("mini_grove", "auto", 42),
        "bistro_flat_f41": ("bistro_flat", "auto", 42),
        "stress_f41": ("stress", "auto", 42),
        "bistro_standin_queue_f4": ("bistro_standin", "queue", 5)}
# name: (tool, scene, march, (W, H), frames[, spp])
FIDELITY = {
    "fidelity_cornell_small": ("metrics", "cornell", "auto", (32, 32), 6, 6),
    "fidelity_alpha_small": ("metrics", "alpha", "auto", (32, 32), 6, 6),
    "fidelity_alpha_small_queue": ("metrics", "alpha", "queue", (32, 32),
                                   6, 6),
    "fidelity_cornell": ("metrics", "cornell", "auto", (96, 96), 48, 96),
    "fidelity_alpha_queue": ("metrics", "alpha", "queue", (96, 96), 48, 96),
    "captures_cornell_small": ("captures", "cornell", "auto", (32, 32), 1),
    "captures_alpha_small": ("captures", "alpha", "auto", (32, 32), 1),
    "captures_alpha_small_queue": ("captures", "alpha", "queue", (32, 32),
                                   1),
}
# name: (scene, (W, H), march, frames rendered, frames stored)
INTERACTIVE = {
    "bistro_standin_interactive": ("bistro_standin", (1920, 1080), "queue",
                                   4, (1, 3)),
    "mini_grove_interactive": ("mini_grove", (272, 136), "auto", 4, (3,)),
    "mini_grove_interactive_queue": ("mini_grove", (272, 136), "queue", 4,
                                     (3,)),
    GLTF_SCENE: (None, (1920, 1080), "queue", 5, (2, 4)),
}
DEFAULT = [*SMALL, *QUEUE, *FULL, *LONG, *INTERACTIVE]
FULL_SIZE, FULL_FRAMES = (1920, 1080), 2
SMALL_SIZE, SMALL_FRAMES = (272, 136), 4
LATTICE = 4


def render(name: str, kwargs: dict, full: bool, march: str = "auto",
           env: dict | None = None, tag: str = "", key: str | None = None,
           size: tuple | None = None, frames: int | None = None):
    from eidola_tpu import native
    from eidola_tpu.models.scenes import load_scene
    from eidola_tpu.render.config import (RenderConfig, default_params,
                                          default_tonemap)
    from eidola_tpu.render.frame import init_frame_state, render_frame

    env = dict(env or {})
    os.environ["EIDOLA_ALPHA_MARCH"] = march
    os.environ.update(env)
    t = time.perf_counter()
    scene, cam = load_scene(name, **kwargs)
    load_s = time.perf_counter() - t
    has_alpha = bool((np.asarray(scene.materials.alpha_mode) != 0).any())
    env_mode = "hdr" if scene.env is not None else "sunsky"
    if full:
        (w, h), frames = FULL_SIZE, frames or FULL_FRAMES
        cfg = RenderConfig(width=w, height=h, max_depth=4, env_mode=env_mode,
                           alpha_geometry=has_alpha)
    else:
        (w, h), frames = size or SMALL_SIZE, frames or SMALL_FRAMES
        cfg = RenderConfig(width=w, height=h, max_depth=4,
                           traversal_max_steps=1024, env_mode=env_mode,
                           alpha_geometry=has_alpha)
    params, tm = default_params(), default_tonemap()
    state = init_frame_state(cfg, cam)
    step = jax.jit(lambda sc, c, p, t, st: render_frame(cfg, sc, c, p, t, st))
    frame_s = []
    for _ in range(frames):
        t = time.perf_counter()
        state, out = step(scene, cam, params, tm, state)
        jax.block_until_ready(out["hdr"])
        frame_s.append(time.perf_counter() - t)
    hdr = np.asarray(out["hdr"], dtype=np.float32)
    meta = {
        "scene": name, "scene_kwargs": kwargs, "width": w, "height": h,
        "max_depth": cfg.max_depth,
        "traversal_max_steps": cfg.traversal_max_steps,
        "env_mode": cfg.env_mode, "alpha_geometry": cfg.alpha_geometry,
        "alpha_march": march,
        "env": {"EIDOLA_ALPHA_MARCH": march, **env},
        "frame": frames - 1, "frames_rendered": frames,
        "stored": ("lattice (hdr[::4, ::4], float16), blocks (8x8 means, "
                   "float32)" if full else "hdr (float32)"),
        "lattice": LATTICE if full else None, "block": BLOCK,
        "command": "JAX_PLATFORMS=cpu python tests/golden_torch/regen.py "
                   + (key or name),
        "jax_version": jax.__version__,
        "jax_native_builders": native.get_lib() is not None,
        "load_s": load_s, "frame_s": frame_s,
        "hdr_mean": float(hdr.mean()), "hdr_finite": bool(
            np.isfinite(hdr).all()),
    }
    arrays = ({"lattice": hdr[::LATTICE, ::LATTICE].astype(np.float16),
               "blocks": block_means(hdr)} if full else {"hdr": hdr})
    path = os.path.join(HERE, file_name(name, w, h, cfg.max_depth,
                                        frames - 1, march, tag))
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)
    print(f"{name}: {w}x{h} frame {frames - 1} mean={meta['hdr_mean']:.4f} "
          f"frame_s={[round(s, 1) for s in frame_s]} -> {path}", flush=True)


def with_size(argv: list, scene: str, size: tuple) -> list:
    """`argv` with its --scene and --size values replaced."""
    out = list(argv)
    i = out.index("--scene")
    out[i + 1] = scene
    j = out.index("--size")
    out[j + 1:j + 3] = [str(size[0]), str(size[1])]
    return out


class Frames:
    """While active, the steps of the JAX app's `make_step` keep each
    frame's linear `hdr` (numpy, float32), its seconds and the configs
    the app built."""

    def __init__(self):
        self.hdr, self.seconds, self.cfgs = [], [], []

    def __enter__(self):
        from eidola_tpu.app import headless

        self.orig = headless.make_step

        def make_step(cfg):
            self.cfgs.append(cfg)
            step = self.orig(cfg)

            def watched(*args, **kw):
                t = time.perf_counter()
                state, out = step(*args, **kw)
                self.hdr.append(np.asarray(out["hdr"], dtype=np.float32))
                self.seconds.append(time.perf_counter() - t)
                return state, out
            return watched

        headless.make_step = make_step
        return self

    def __exit__(self, *exc):
        from eidola_tpu.app import headless

        headless.make_step = self.orig


def headless_frames(key: str):
    """One INTERACTIVE name through the JAX app's `run`: its stored
    frames, each a file."""
    import tempfile

    from eidola_tpu import native
    from eidola_tpu.app import headless

    scene, (w, h), march, frames, stored = INTERACTIVE[key]
    os.environ["EIDOLA_ALPHA_MARCH"] = march
    if not native.get_lib():
        raise SystemExit(f"{key}: the JAX package's native host builders "
                         "did not load (ROADMAP C): no reference")
    extra, runs = {}, []
    with tempfile.TemporaryDirectory() as tmp, Frames() as watch:
        png = os.path.join(tmp, "f.png")
        if scene is None:
            files = write_inputs(tmp)
            ckpt = os.path.join(tmp, "s.npz")
            base = ["--scene", files["glb"]["path"], "-e",
                    files["hdr"]["path"]] + chip_smoke.GLTF
            runs = [base + ["--frames", "3", "--save-state", ckpt],
                    base + ["--frames", "2", "--load-state", ckpt]]
            extra["inputs"] = {k: v["sha256"] for k, v in files.items()}
            extra["input_bytes"] = {k: v["bytes"] for k, v in files.items()}
        else:
            runs = [with_size(chip_smoke.INTERACTIVE, scene, (w, h))]
        for argv in runs:
            headless.run(argv + ["--out", png])
        # the files by their names: tmp differs from run to run
        argv_meta = [[os.path.basename(a) if a.startswith(tmp) else a
                      for a in argv] for argv in runs]
    if len(watch.hdr) != frames:
        raise SystemExit(f"{key}: {len(watch.hdr)} frames watched, not "
                         f"{frames}")
    cfg = watch.cfgs[0]
    if any(c != cfg for c in watch.cfgs) or (cfg.width, cfg.height) != (
            w, h):
        raise SystemExit(f"{key}: configs {watch.cfgs}")
    argv = runs[0]
    orbit = float(argv[argv.index("--orbit") + 1]) if "--orbit" in argv \
        else 0.0
    name = scene or GLTF_SCENE
    full = (w, h) == FULL_SIZE
    for frame in stored:
        hdr = watch.hdr[frame]
        meta = {
            "scene": name, "argv": argv_meta,
            **{k: getattr(cfg, k) for k in CONFIG_FIELDS},
            **{k: getattr(cfg, k) for k in FLAG_DEFAULTS},
            "orbit": orbit, **extra,
            "denoise": cfg.denoise, "indirect_enabled": cfg.indirect_enabled,
            "alpha_march": march, "env": {"EIDOLA_ALPHA_MARCH": march},
            "frame": frame, "frames_rendered": frames,
            "stored": ("lattice (hdr[::4, ::4], float16), blocks (8x8 "
                       "means, float32)" if full else "hdr (float32)"),
            "lattice": LATTICE if full else None, "block": BLOCK,
            "command": "JAX_PLATFORMS=cpu python tests/golden_torch/"
                       "regen.py " + key,
            "jax_version": jax.__version__,
            "jax_native_builders": native.get_lib() is not None,
            "frame_s": watch.seconds,
            "hdr_mean": float(hdr.mean()),
            "hdr_finite": bool(np.isfinite(hdr).all()),
        }
        arrays = ({"lattice": hdr[::LATTICE, ::LATTICE].astype(np.float16),
                   "blocks": block_means(hdr)} if full else {"hdr": hdr})
        path = os.path.join(HERE, file_name(
            name, w, h, cfg.max_depth, frame, march,
            "" if scene is None else "interactive"))
        np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)
        print(f"{key}: {w}x{h} frame {frame} mean={meta['hdr_mean']:.4f} "
              f"frame_s={[round(s, 1) for s in watch.seconds]} -> {path}",
              flush=True)


def load_tool(name: str):
    """The JAX package's root tool tools/<name>.py as a module (its import
    runs; its `main` does not)."""
    path = os.path.join(HERE, "..", "..", "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fidelity(key: str, tools: dict):
    """One FIDELITY file through the JAX tool's own functions."""
    from eidola_tpu import native
    from eidola_tpu.models.scenes import load_scene
    from eidola_tpu.render.config import (
        DEBUG_BASE_COLOR, DEBUG_DEPTH, DEBUG_DIRECT, DEBUG_INDIRECT,
        DEBUG_NORMAL, RenderConfig)

    kind, name, march, (w, h), frames, *spp = FIDELITY[key]
    os.environ["EIDOLA_ALPHA_MARCH"] = march
    scene, cam = load_scene(name)
    has_alpha = bool((np.asarray(scene.materials.alpha_mode) != 0).any())
    seconds, arrays = {}, {}
    if kind == "metrics":
        tool = tools["fidelity_metrics"]
        spp = spp[0]
        # tools/fidelity_metrics.py:92-119
        base = RenderConfig(width=w, height=h, max_depth=2,
                            env_mode="sunsky", traversal_max_steps=2048,
                            alpha_geometry=has_alpha, accumulate=False)
        for label, cfg in (("oracle_d1", dataclasses.replace(
                base, max_depth=1)), ("oracle", base)):
            t = time.perf_counter()
            arrays[label] = tool._oracle(scene, cam, cfg, spp)
            seconds[label] = time.perf_counter() - t
        cases = [("direct-only raw", "direct_raw", dataclasses.replace(
                      base, denoise=False, indirect_enabled=False),
                  "oracle_d1"),
                 ("composed raw", "composed_raw",
                  dataclasses.replace(base, denoise=False), "oracle"),
                 ("composed denoised", "composed_denoised", base, "oracle")]
        rows = []
        for stage, label, cfg, ref in cases:
            t = time.perf_counter()
            arrays[label] = tool._pipeline(scene, cam, cfg, frames)
            seconds[label] = time.perf_counter() - t
            rmse, mrel = tool.metrics(arrays[label], arrays[ref])
            rows.append({"stage": stage, "rmse": rmse, "mrel": mrel,
                         "oracle_mean": float(arrays[ref].mean())})
            print(f"{key}: {stage} RMSE {rmse:.4f} mean-rel "
                  f"{mrel * 100:.2f}% ({seconds[label]:.1f} s)", flush=True)
        extra = {"spp": spp, "rows": rows, "max_depth": base.max_depth,
                 "traversal_max_steps": base.traversal_max_steps,
                 "eidola_chunk": os.environ.get("EIDOLA_CHUNK")}
        tail = f"_s{spp}"
    else:
        tool = tools["fidelity_captures"]
        # tools/fidelity_captures.py:76-102
        base = RenderConfig(width=w, height=h, max_depth=4,
                            env_mode="sunsky", alpha_geometry=has_alpha)
        rep = dataclasses.replace
        caps = [
            ("dir_raw", rep(base, denoise=False, debug_mode=DEBUG_DIRECT),
             frames),
            ("ind_raw", rep(base, denoise=False, debug_mode=DEBUG_INDIRECT),
             frames),
            ("com_raw", rep(base, denoise=False), frames),
            ("dir_denoised", rep(base, debug_mode=DEBUG_DIRECT), frames),
            ("ind_denoised", rep(base, debug_mode=DEBUG_INDIRECT), frames),
            ("com_denoised", rep(base), frames),
            ("gbuf_basecolor", rep(base, debug_mode=DEBUG_BASE_COLOR,
                                   denoise=False), 1),
            ("gbuf_normal", rep(base, debug_mode=DEBUG_NORMAL,
                                denoise=False), 1),
            ("gbuf_depth", rep(base, debug_mode=DEBUG_DEPTH,
                               denoise=False), 1),
            ("com_accum64", rep(base), 64),
        ]
        for label, cfg, n in caps:
            t = time.perf_counter()
            arrays[label] = tool.render(cfg, scene, cam, n).astype(
                np.float32)
            seconds[label] = time.perf_counter() - t
            print(f"{key}: {label} mean {arrays[label].mean():.4f} "
                  f"({seconds[label]:.1f} s)", flush=True)
        extra = {"captures": [c[0] for c in caps],
                 "max_depth": base.max_depth,
                 "traversal_max_steps": base.traversal_max_steps}
        tail = ""
    meta = {"tool": f"tools/fidelity_{kind}.py", "scene": name, "width": w,
            "height": h, "frames": frames, "env_mode": base.env_mode,
            "alpha_geometry": has_alpha, "alpha_march": (
                march if has_alpha else None),
            "env": {"EIDOLA_ALPHA_MARCH": march},
            "command": "JAX_PLATFORMS=cpu python tests/golden_torch/regen.py "
                       + key,
            "jax_version": jax.__version__,
            "jax_native_builders": native.get_lib() is not None,
            "seconds": seconds, **extra}
    queue = "_queue" if has_alpha and march == "queue" else ""
    prefix = "fidelity" if kind == "metrics" else "captures"
    path = os.path.join(HERE, f"{prefix}_{name}_{w}x{h}_f{frames}{tail}"
                              f"{queue}.npz")
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)
    print(f"{key}: -> {path}", flush=True)


def main():
    which = sys.argv[1:] or DEFAULT
    fid = [n for n in which if n in FIDELITY]
    if fid and (len(fid) != len(which)
                or len({FIDELITY[n][0] for n in fid}) > 1):
        raise SystemExit("FIDELITY names run in a process of their own, "
                         "one tool's names a process: tools/fidelity_"
                         "metrics.py's import sets EIDOLA_CHUNK for every "
                         "JAX frame after it")
    # before anything imports eidola_tpu.ops.bvh, which reads EIDOLA_CHUNK
    # once: the tool's import sets it (tools/fidelity_metrics.py:31)
    tools = {t: load_tool(t) for t in sorted(
        {f"fidelity_{FIDELITY[n][0]}" for n in fid})}
    for name in which:
        if name in FIDELITY:
            fidelity(name, tools)
        elif name in QUEUE:
            scene, env, tag, size = QUEUE[name]
            render(scene, FULL.get(scene, SMALL.get(scene)), scene in FULL,
                   "queue", env, tag, name, size)
        elif name in INTERACTIVE:
            headless_frames(name)
        elif name in LONG:
            scene, march, frames = LONG[name]
            render(scene, FULL.get(scene, SMALL.get(scene)), scene in FULL,
                   march, key=name, frames=frames)
        elif name in FULL or name in SMALL:
            render(name, FULL.get(name, SMALL.get(name)), name in FULL)
        else:
            raise SystemExit(f"unknown reference {name!r}: have "
                             f"{sorted(FULL)}, {sorted(SMALL)}, "
                             f"{sorted(QUEUE)}, {sorted(LONG)}, "
                             f"{sorted(INTERACTIVE)} and "
                             f"{sorted(FIDELITY)}")


if __name__ == "__main__":
    main()
