"""Regenerate the JAX package's reference frames in tests/golden_torch/
(CPU, fixed seeds), against which the port's frames are held.

    JAX_PLATFORMS=cpu python tests/golden_torch/regen.py [NAME ...]

NAME is a key of FULL, SMALL, QUEUE or LONG (default: DEFAULT, every
file stored here; hours of JAX on a CPU).

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

Each file `<scene>_<W>x<H>_d<depth>_f<frame>.npz` also holds `meta`, a
JSON string: the config fields, the frame index, the command, the JAX
version, whether the JAX native host builders were loaded, and the
seconds each frame took; a QUEUE file also the march switches it was
rendered under (`env`).
"""
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

from eidola_tpu_torch.utils.reference import (  # noqa: E402
    BLOCK, block_means, file_name)

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
DEFAULT = [*SMALL, *QUEUE, *FULL, *LONG]
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


def main():
    which = sys.argv[1:] or DEFAULT
    for name in which:
        if name in QUEUE:
            scene, env, tag, size = QUEUE[name]
            render(scene, FULL.get(scene, SMALL.get(scene)), scene in FULL,
                   "queue", env, tag, name, size)
        elif name in LONG:
            scene, march, frames = LONG[name]
            render(scene, FULL.get(scene, SMALL.get(scene)), scene in FULL,
                   march, key=name, frames=frames)
        elif name in FULL or name in SMALL:
            render(name, FULL.get(name, SMALL.get(name)), name in FULL)
        else:
            raise SystemExit(f"unknown reference {name!r}: have "
                             f"{sorted(FULL)}, {sorted(SMALL)}, "
                             f"{sorted(QUEUE)} and {sorted(LONG)}")


if __name__ == "__main__":
    main()
