"""Regenerate the JAX package's reference frames in tests/golden_torch/
(CPU, fixed seeds), against which the port's frames are held.

    JAX_PLATFORMS=cpu python tests/golden_torch/regen.py [NAME ...]

NAME is a key of FULL, SMALL or QUEUE (default: DEFAULT, the files
stored here; `stress` is left out to keep the directory under 4 MB).

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
* QUEUE: a SMALL scene with EIDOLA_ALPHA_MARCH=queue, the alpha
  HitTest's march on a compacted queue in staged capacities (the
  default on an accelerator; the CPU default runs the hops in lockstep
  and draws another rng stream, so the two frames differ by noise):
  `<scene>_272x136_d4_f3_queue.npz`.

Each file `<scene>_<W>x<H>_d<depth>_f<frame>.npz` also holds `meta`, a
JSON string: the config fields, the frame index, the command, the JAX
version, whether the JAX native host builders were loaded, and the
seconds each frame took.
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
QUEUE = {"mini_grove_queue": "mini_grove"}
DEFAULT = [*SMALL, *QUEUE, "bistro_standin", "bistro_flat", "bistro_hdr"]
FULL_SIZE, FULL_FRAMES = (1920, 1080), 2
SMALL_SIZE, SMALL_FRAMES = (272, 136), 4
LATTICE = 4


def render(name: str, kwargs: dict, full: bool, march: str = "auto"):
    from eidola_tpu import native
    from eidola_tpu.models.scenes import load_scene
    from eidola_tpu.render.config import (RenderConfig, default_params,
                                          default_tonemap)
    from eidola_tpu.render.frame import init_frame_state, render_frame

    os.environ["EIDOLA_ALPHA_MARCH"] = march
    t = time.perf_counter()
    scene, cam = load_scene(name, **kwargs)
    load_s = time.perf_counter() - t
    has_alpha = bool((np.asarray(scene.materials.alpha_mode) != 0).any())
    env_mode = "hdr" if scene.env is not None else "sunsky"
    if full:
        (w, h), frames = FULL_SIZE, FULL_FRAMES
        cfg = RenderConfig(width=w, height=h, max_depth=4, env_mode=env_mode,
                           alpha_geometry=has_alpha)
    else:
        (w, h), frames = SMALL_SIZE, SMALL_FRAMES
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
        "alpha_march": march, "frame": frames - 1, "frames_rendered": frames,
        "stored": ("lattice (hdr[::4, ::4], float16), blocks (8x8 means, "
                   "float32)" if full else "hdr (float32)"),
        "lattice": LATTICE if full else None, "block": BLOCK,
        "command": "JAX_PLATFORMS=cpu python tests/golden_torch/regen.py "
                   + name + ("" if march == "auto" else "_" + march),
        "jax_version": jax.__version__,
        "jax_native_builders": native.get_lib() is not None,
        "load_s": load_s, "frame_s": frame_s,
        "hdr_mean": float(hdr.mean()), "hdr_finite": bool(
            np.isfinite(hdr).all()),
    }
    arrays = ({"lattice": hdr[::LATTICE, ::LATTICE].astype(np.float16),
               "blocks": block_means(hdr)} if full else {"hdr": hdr})
    path = os.path.join(HERE, file_name(name, w, h, cfg.max_depth,
                                        frames - 1, march))
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)
    print(f"{name}: {w}x{h} frame {frames - 1} mean={meta['hdr_mean']:.4f} "
          f"frame_s={[round(s, 1) for s in frame_s]} -> {path}", flush=True)


def main():
    which = sys.argv[1:] or DEFAULT
    for name in which:
        if name in QUEUE:
            render(QUEUE[name], SMALL[QUEUE[name]], False, "queue")
        elif name in FULL or name in SMALL:
            render(name, FULL.get(name, SMALL.get(name)), name in FULL)
        else:
            raise SystemExit(f"unknown reference {name!r}: have "
                             f"{sorted(FULL)}, {sorted(SMALL)} and "
                             f"{sorted(QUEUE)}")


if __name__ == "__main__":
    main()
