"""The per-stage fidelity captures of the port as PNG files (the
counterpart of tools/fidelity_captures.py).

    python -m eidola_tpu_torch.tools.fidelity_captures [--device cuda]
        [--scene bistro_standin] [--size 960 544] [--frames 1]
        [--out DIR]

The JAX tool's ten captures (:80-102), each one config of the scene's
frame (max_depth 4, sun & sky, the HitTest from the scene; :74-76)
rendered from `init_frame_state` with time_word i for frame i (:30-41),
its last frame's LDR `image` kept:

- raw (no denoise) and denoised direct, indirect and composed, after
  `--frames` frames: dir_raw, ind_raw, com_raw, dir_denoised,
  ind_denoised, com_denoised;
- the G-buffer's base colour, normal and depth after one frame:
  gbuf_basecolor, gbuf_normal, gbuf_depth;
- the composed frame accumulated over 64 frames: com_accum64.

Each goes to `<DIR>/<name>.png` through utils/png.encode_png, quantised
as the JAX tool's `save` does (clip to [0, 1], x 255, + 0.5); `--out`
defaults to `fidelity_captures/` at the root of the checkout, which git
ignores, never docs/.  It prints each capture's seconds and its image's
mean, min and max, then one JSON line.  Where tests/golden_torch/
holds the JAX tool's captures of the same scene, size, `--frames` and
alpha march (tests/golden_torch/regen.py, the FIDELITY group:
`captures_<scene>_<W>x<H>_f<frames>[_queue].npz`), each image is held
against JAX's: a mean abs at or past `BOUND` exits 1.  On the card every
ray goes through the walk kernel (walk launches, no drain, else it
fails).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .. import bench
from ..app.headless import _sync, alpha_geometry, set_numerics
from ..models.scenes import load_scene
from ..render.config import (DEBUG_BASE_COLOR, DEBUG_DEPTH, DEBUG_DIRECT,
                             DEBUG_INDIRECT, DEBUG_NORMAL, RenderConfig,
                             default_params, default_tonemap)
from ..render.frame import init_frame_state, make_step
from ..render.tracer import _march_mode
from ..utils.png import encode_png
from ..utils.reference import ROOT
from . import Launches, find_stored, load_stored, open_device

SIZE = (960, 544)
SCENE = "bistro_standin"
ACCUM_FRAMES = 64
OUT = os.path.join(ROOT, "fidelity_captures")
BOUND = 0.02              # mean abs against JAX's, tests/test_golden.py's


def base_config(scene, width: int, height: int) -> RenderConfig:
    """The tool's base config (:74-76)."""
    return RenderConfig(width=width, height=height, max_depth=4,
                        env_mode="sunsky",
                        alpha_geometry=alpha_geometry(scene))


def captures(base: RenderConfig, frames: int) -> list:
    """[(name, config, frames)] of :80-102, in its order."""
    rep = dataclasses.replace
    return [
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
        ("gbuf_normal", rep(base, debug_mode=DEBUG_NORMAL, denoise=False), 1),
        ("gbuf_depth", rep(base, debug_mode=DEBUG_DEPTH, denoise=False), 1),
        ("com_accum64", rep(base), ACCUM_FRAMES),
    ]


def render(cfg: RenderConfig, scene, cam, frames: int) -> np.ndarray:
    """The last frame's LDR image (h, w, 3) float32 after `frames` frames
    with time_word i (:30-41)."""
    dev = cam.pos.device
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    for i in range(frames):
        p = params._replace(time_word=torch.tensor(
            i, dtype=torch.int64, device=dev))
        state, out = step(scene, cam, p, tm, state)
    return out["image"].float().cpu().numpy()


def to_png(img01: np.ndarray) -> bytes:
    """The JAX tool's quantisation (:44-51), through the port's encoder."""
    return encode_png((np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eidola_tpu_torch.tools.fidelity_captures",
        description="the per-stage captures as PNG files")
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu for the tests")
    p.add_argument("--size", type=int, nargs=2, default=list(SIZE),
                   metavar=("WIDTH", "HEIGHT"))
    p.add_argument("--scene", default=SCENE)
    p.add_argument("--frames", type=int, default=1,
                   help="frames for the raw and denoised captures")
    p.add_argument("--out", default=OUT,
                   help="directory for the PNG files")
    return p


def find_ref(scene: str, base: RenderConfig, frames: int, march: str):
    """The path of JAX's stored captures for this scene, size and
    `--frames` under the alpha march `march`
    (`captures_<scene>_<W>x<H>_f<frames>[_queue].npz`), or None."""
    return find_stored(
        f"captures_{scene}_{base.width}x{base.height}_f{frames}",
        base.alpha_geometry, march,
        {"width": base.width, "height": base.height, "frames": frames,
         "max_depth": base.max_depth,
         "traversal_max_steps": base.traversal_max_steps})


def run(argv=None) -> dict:
    """The tool on `argv`: writes the PNG files, prints a line each, and
    returns the result of the JSON line plus, under "images", each
    capture's image as numpy."""
    args = build_argparser().parse_args(argv)
    device = open_device(args.device)
    if args.frames < 1:
        raise SystemExit("--frames must be >= 1")
    set_numerics()
    card = bench.card(device)
    t0 = time.perf_counter()
    scene, cam = load_scene(args.scene, device=device, **(
        {"n": 16} if args.scene == "stress" else {}))
    _sync(device)
    load_s = time.perf_counter() - t0
    print(f"device {card.get('nvidia_smi', card['name'])}; scene build "
          f"{load_s:.1f}s ({int(scene.bvh.n_tris)} tris)", flush=True)
    width, height = args.size
    base = base_config(scene, width, height)
    march = _march_mode(device)
    caps = captures(base, args.frames)
    path = find_ref(args.scene, base, args.frames, march)
    ref = None if path is None else load_stored(path, [c[0] for c in caps])
    os.makedirs(args.out, exist_ok=True)
    launches, rows, images = Launches(device), [], {}
    for name, cfg, frames in caps:
        t0 = time.perf_counter()
        with launches:
            img = render(cfg, scene, cam, frames)
        seconds = time.perf_counter() - t0
        png = os.path.join(args.out, f"{name}.png")
        with open(png, "wb") as f:
            f.write(to_png(img))
        images[name] = img
        row = {"name": name, "frames": frames, "seconds": seconds,
               "mean": float(img.mean()), "min": float(img.min()),
               "max": float(img.max()),
               "finite": bool(np.isfinite(img).all()), "png": png,
               "jax_mean_abs": None if ref is None else float(
                   np.abs(img - ref[name]).mean())}
        rows.append(row)
        print(f"  {name}: {seconds:.2f}s ({frames} frames) mean "
              f"{row['mean']:.4f} min {row['min']:.4f} max "
              f"{row['max']:.4f}" + ("" if ref is None else
                                    f"; against JAX's: mean abs "
                                    f"{row['jax_mean_abs']:.3g}")
              + f" -> {png}", flush=True)
    held = None if ref is None else {
        "file": os.path.relpath(path, ROOT), "bound": BOUND,
        "ok": all(r["jax_mean_abs"] < BOUND for r in rows)}
    if held:
        print(f"{args.scene}: captures against JAX's {held['file']}: bound "
              f"{BOUND} ({'ok' if held['ok'] else 'FAILED'})", flush=True)
    result = {"device": card, "trav": launches.trav, "alpha_march": march,
              "scene": args.scene, "width": width, "height": height,
              "frames": args.frames, "load_s": load_s, "captures": rows,
              "jax": held, "launches": launches.check()}
    print(json.dumps(result), flush=True)
    return dict(result, images=images)


def main(argv=None) -> int:
    """Exit code 1 on an image that is not finite or misses JAX's."""
    res = run(argv)
    ok = all(r["finite"] for r in res["captures"])
    return 0 if ok and (res["jax"] is None or res["jax"]["ok"]) else 1


if __name__ == "__main__":
    sys.exit(main())
