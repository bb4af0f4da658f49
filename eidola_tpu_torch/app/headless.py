"""Headless renderer (port of eidola_tpu/app/headless.py).

Usage:
    python -m eidola_tpu_torch.app.headless --scene bistro_flat \
        --size 1920 1080 --frames 4 --device cuda

renders the default frame (ReSTIR DI + GI, a-trous denoise);
`--no-indirect` / `--no-denoise` drop those stages.  EIDOLA_TRAV=pallas
traces every ray through the one-kernel walk (ops/bvh_walk.py).  The
device is explicit: nothing falls back from CUDA to the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.scenes import load_scene
from ..render.config import RenderConfig, default_params, default_tonemap
from ..render.frame import init_frame_state, make_step
from ..scene.camera import advance
from ..utils.profiler import StageTimer, trace

RESTIR_MODES = {"none": 0, "ris": 1, "temporal": 3}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eidola_tpu_torch.app.headless",
        description="EIDOLA headless path tracer on PyTorch + CUDA")
    p.add_argument("-f", "--scene", default="cornell",
                   help="registry scene name (cornell, punctual, textured, "
                        "hdr, stress, bistro_flat)")
    p.add_argument("--size", type=int, nargs="+", default=[512],
                   help="WIDTH [HEIGHT] render extent")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--device", required=True,
                   help="torch device to render on, e.g. cuda or cpu")
    p.add_argument("--out", default=None, help="PNG path for the last frame")
    p.add_argument("--hdr-out", default=None, help="also dump linear .npy")
    p.add_argument("--restir", choices=sorted(RESTIR_MODES),
                   default="temporal")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--no-indirect", action="store_true")
    p.add_argument("--tonemap", choices=["uncharted2", "hejl", "aces"],
                   default="uncharted2")
    p.add_argument("--auto-exposure", type=int, default=0)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--no-texture-mips", action="store_true")
    p.add_argument("--profile-trace", default=None,
                   help="directory for a torch.profiler trace of one extra "
                        "frame (its kernel summary joins the output)")
    p.add_argument("--quiet", action="store_true")
    return p


def set_numerics() -> None:
    """f32 everywhere: TF32 matmuls/convolutions are off (on the TPU,
    low-precision drains made cornell 67% darker, docs/PERF_NOTES.md)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> dict:
    """Render `--frames` frames; returns a summary dict (plus the last
    image, the final FrameState and the scene under "image", "state" and
    "scene" for callers in Python).  ms_per_frame and the stage split are
    the mean over the frames after the first (which carries the warm-up);
    frame_ms lists every frame."""
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    set_numerics()
    w = args.size[0]
    h = args.size[1] if len(args.size) > 1 else args.size[0]
    log = (lambda *a: None) if args.quiet else print

    t0 = time.perf_counter()
    scene, cam = load_scene(args.scene, device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    log(f"scene+BVH: {load_s:.1f}s")

    cfg = RenderConfig(
        width=w, height=h,
        env_mode="hdr" if scene.env is not None else "sunsky",
        restir_mode=RESTIR_MODES[args.restir],
        denoise=not args.no_denoise,
        indirect_enabled=not args.no_indirect,
        tonemap_kind={"uncharted2": 0, "hejl": 1, "aces": 2}[args.tonemap],
        texture_mips=not args.no_texture_mips,
    )
    params = default_params(device=device)
    if scene.env is not None:
        # firefly clamp = 4 x env integral (ref sample_example.cpp:104)
        params = params._replace(firefly_clamp=4.0 * scene.env.integral)
    tm = default_tonemap(device=device)._replace(
        auto_exposure=torch.tensor(args.auto_exposure, device=device),
        exposure=torch.tensor(args.exposure, dtype=torch.float32,
                              device=device))
    state = init_frame_state(cfg, cam)
    step = make_step(cfg)
    timer = StageTimer(device)

    frame_ms = []
    outputs = None
    for i in range(args.frames):
        if i:
            cam = advance(cam)       # static camera: roll last* matrices
        t1 = time.perf_counter()
        # stages are timed in steady state: frame 0 carries the warm-up
        state, outputs = step(scene, cam, params, tm, state,
                              timer=timer if i or args.frames == 1 else None)
        _sync(device)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        log(f"frame {i}: {frame_ms[-1]:.1f} ms")

    profile = None
    if args.profile_trace:
        profile = trace(lambda: step(scene, advance(cam), params, tm, state),
                        args.profile_trace, device)
        log(json.dumps(profile))

    img = outputs["image"].cpu().numpy()
    if args.out:
        from PIL import Image

        Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
                        ).save(args.out)
    if args.hdr_out:
        np.save(args.hdr_out, outputs["hdr"].cpu().numpy())
    steady = frame_ms[1:] or frame_ms
    stages = {k: v / len(steady) for k, v in timer.summary().items()}
    summary = {
        "scene": args.scene, "width": w, "height": h, "frames": args.frames,
        "device": str(device), "load_s": load_s,
        "ms_per_frame": float(np.mean(steady)), "frame_ms": frame_ms,
        "stage_ms_per_frame": stages, "image_mean": float(img.mean()),
        "n_tris": int(scene.bvh.n_tris),
        "n_leaves": int(scene.bvh.leaf_blocks.shape[0]),
        "profile": profile,
    }
    return dict(summary, image=img, state=state, scene=scene)


if __name__ == "__main__":
    out = run()
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("image", "state", "scene")}))
