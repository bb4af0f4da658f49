"""Headless renderer (port of eidola_tpu/app/headless.py).

Usage:
    python -m eidola_tpu_torch.app.headless --scene bistro_standin \
        --size 1920 1080 --frames 4

renders the default frame (ReSTIR DI + GI, a-trous denoise) on the card;
`--device cpu` renders on the CPU instead, and nothing falls back from
CUDA to the CPU.  `--no-indirect` / `--no-denoise` drop those stages.
The flags are the JAX app's: `--scene` takes a registry name or a
.gltf/.glb path, `-e/--env` an .hdr environment (the firefly clamp
becomes 4x its integral), `--save-state` / `--load-state` an npz of the
FrameState (utils/checkpoint.py; either package's file loads in the
other), `--out` a PNG of the last frame (utils/png.py, no PIL),
`--orbit RAD` moves the camera each frame after the first
(CameraManipulator, so temporal reuse reprojects and accumulation
resets), `--restir` takes all five modes, `--shadow-cadence N` and
`--primary-seed` turn on visibility reuse and the seeded primary walk,
`--descale N` renders at 1/N of the extent (rounded down to multiples of
32) and upscales the image back bilinearly, as jax.image.resize does.
As in the JAX app, the manipulator's first move rebuilds the projection
at its own 60 degree fovy and the render aspect, whatever the scene
camera's fovy.
The alpha HitTest is on exactly when the scene has an alpha-tested
material, as in the JAX app.  On the card every BVH, flat or instanced,
is traced through the one-kernel walk (ops/bvh_walk.py), and on the CPU
through the torch walk (ops/packets.resolve_trav); EIDOLA_TRAV=xla gives
the card the torch walk with its fused drain kernels, and EIDOLA_MT=mxu
then drains its leaves with ops/bvh_mxu.py instead.
The readout is the JAX app's beside the port's own: a MilliTimer line
for the scene, BVH and environment load, and the Profiler's scopes
"Compile+first" (frame 0) and "Render" (the frames after it); the JSON
summary adds the stage split (StageTimer), the frame times and the
traversal the frames took ("trav"), and from the same timer the host's
account of each stage a frame ("stage_host_per_frame": the host ms
between its marks, its blocking reads and the ms the host waited in
them).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.scenes import load_scene
from ..ops.packets import resolve_trav
from ..render.config import RenderConfig, default_params, default_tonemap
from ..render.frame import init_frame_state, make_step
from ..scene.camera import CameraManipulator, advance
from ..scene.data import ALPHA_OPAQUE, attach_env, env_params
from ..scene.hdr import build_env_map, load_hdr
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.monitor import DeviceMonitor
from ..utils.png import encode_png
from ..utils.profiler import MilliTimer, Profiler, StageTimer, trace

DEBUG_MODES = {
    "none": 0, "direct": 1, "indirect": 2, "basecolor": 3, "normal": 4,
    "depth": 5, "metallic": 6, "emissive": 7, "roughness": 8, "texcoord": 9,
}
RESTIR_MODES = {"none": 0, "ris": 1, "spatial": 2, "temporal": 3,
                "spatiotemporal": 4}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eidola_tpu_torch.app.headless",
        description="EIDOLA headless path tracer on PyTorch + CUDA")
    p.add_argument("-f", "--scene", default="cornell",
                   help="registry scene name (cornell, boxes, punctual, "
                        "textured, hdr, stress, alpha, mini_grove, "
                        "bistro_flat, bistro_standin, bistro_hdr) or a "
                        ".gltf/.glb path")
    p.add_argument("-e", "--env", default=None,
                   help=".hdr environment map (default: the scene's own)")
    p.add_argument("--size", type=int, nargs="+", default=[512],
                   help="WIDTH [HEIGHT] render extent")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu "
                        "renders on the CPU)")
    p.add_argument("--out", default=None, help="PNG path for the last frame")
    p.add_argument("--hdr-out", default=None, help="also dump linear .npy")
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--debug", choices=sorted(DEBUG_MODES), default="none")
    p.add_argument("--restir", choices=sorted(RESTIR_MODES),
                   default="temporal")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--no-indirect", action="store_true")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="radians/frame camera orbit (exercises temporal "
                        "reuse)")
    p.add_argument("--descale", type=int, default=1,
                   help="divide the render extent by N (ref "
                        "sample_example.cpp:396-399); the image is upscaled "
                        "back")
    p.add_argument("--tonemap", choices=["uncharted2", "hejl", "aces"],
                   default="uncharted2")
    p.add_argument("--auto-exposure", type=int, default=0)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--no-texture-mips", action="store_true")
    p.add_argument("--shadow-cadence", type=int, default=1,
                   help="DI shadow visibility-reuse cadence (1 = validate "
                        "every frame; N = 1/N of tiles per frame)")
    p.add_argument("--primary-seed", action="store_true",
                   help="seed the primary walk's t_max by re-testing last "
                        "frame's hit triangle per pixel")
    p.add_argument("--save-state", default=None,
                   help="write the FrameState checkpoint npz after the run")
    p.add_argument("--load-state", default=None,
                   help="resume the FrameState from a checkpoint npz")
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


def resize_bilinear(img, height: int, width: int):
    """(H, W, C) -> (height, width, C) as jax.image.resize(method=
    "bilinear") computes it: a triangle kernel widened by the scale when
    shrinking, weights renormalised over the taps inside the image (so a
    border pixel is not darkened), one weight matrix per axis."""
    def weights(n_in: int, n_out: int):
        inv = n_in / n_out
        f32 = dict(dtype=torch.float32, device=img.device)
        sample = (torch.arange(n_out, **f32) + 0.5) * inv - 0.5
        x = torch.abs(sample[None, :] - torch.arange(n_in, **f32)[:, None]
                      ) / max(inv, 1.0)
        w = torch.clamp(1.0 - x, min=0.0)
        tot = w.sum(0, keepdim=True)
        eps = torch.finfo(torch.float32).eps
        w = torch.where(torch.abs(tot) > 1000.0 * eps,
                        w / torch.where(tot != 0, tot, 1.0), 0.0)
        return torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None],
                           w, 0.0)

    wy = weights(img.shape[0], height)
    wx = weights(img.shape[1], width)
    return torch.einsum("hwc,hy,wx->yxc", img, wy, wx)


def _pivot_from_cam(cam) -> np.ndarray:
    """A look-at pivot 3 units along the view axis."""
    fwd = -cam.view_inv[:3, 2].cpu().numpy()
    return cam.pos.cpu().numpy() + fwd * 3.0


def alpha_geometry(scene) -> bool:
    """The alpha HitTest is on exactly when the scene has an alpha-tested
    material (a static switch, as in the JAX app)."""
    return bool((scene.materials.alpha_mode != ALPHA_OPAQUE).any())


def to_u8(img01: np.ndarray) -> np.ndarray:
    """[0, 1] image -> uint8, as the JAX app quantises its PNG."""
    return (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)


def frame_config(args, scene, w: int, h: int) -> RenderConfig:
    """The RenderConfig of the parsed flags `args` for `scene` (its
    environment and alpha-tested materials) at the extent w x h."""
    return RenderConfig(
        width=w, height=h,
        max_depth=args.max_depth,
        env_mode="hdr" if scene.env is not None else "sunsky",
        restir_mode=RESTIR_MODES[args.restir],
        denoise=not args.no_denoise,
        indirect_enabled=not args.no_indirect,
        debug_mode=DEBUG_MODES[args.debug],
        tonemap_kind={"uncharted2": 0, "hejl": 1, "aces": 2}[args.tonemap],
        texture_mips=not args.no_texture_mips,
        alpha_geometry=alpha_geometry(scene),
        shadow_cadence=args.shadow_cadence,
        primary_seed=args.primary_seed,
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> dict:
    """Render `--frames` frames; returns a summary dict (plus the last
    image, the final FrameState, the scene and the RenderConfig under
    "image", "state", "scene" and "cfg", and the last frame's linear HDR,
    a tensor on the device, under "hdr", for callers in Python).
    ms_per_frame and the stage split are the mean over the frames after
    the first (which carries the warm-up); frame_ms lists every frame."""
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    set_numerics()
    full_w = args.size[0]
    full_h = args.size[1] if len(args.size) > 1 else args.size[0]
    w, h = full_w, full_h
    if args.descale > 1:
        w = max(w // args.descale // 32 * 32, 32)
        h = max(h // args.descale // 32 * 32, 32)
    log = (lambda *a: None) if args.quiet else print

    load = MilliTimer("load ")
    scene, cam = load_scene(args.scene, device=device)
    if args.env:
        scene = attach_env(scene, build_env_map(load_hdr(args.env),
                                                device=device))
    _sync(device)
    load_ms = load.ms() if args.quiet else load.print("scene+BVH")

    cfg = frame_config(args, scene, w, h)
    params = default_params(device=device)
    if scene.env is not None:
        params = env_params(params, scene.env)
    tm = default_tonemap(device=device)._replace(
        auto_exposure=torch.tensor(args.auto_exposure, device=device),
        exposure=torch.tensor(args.exposure, dtype=torch.float32,
                              device=device))
    manip = CameraManipulator(cam.pos.cpu().numpy(), _pivot_from_cam(cam),
                              aspect=w / h, device=device)
    manip._cam = cam             # the scene's framing until the first move
    state = init_frame_state(cfg, cam)
    if args.load_state:
        state = load_pytree(args.load_state, state)
    step = make_step(cfg)
    timer = StageTimer(device)
    prof = Profiler(enabled=True)
    mon = DeviceMonitor(device)

    frame_ms = []
    outputs = None
    for i in range(args.frames):
        if i:
            cam = manip.orbit(args.orbit, 0.0) if args.orbit else manip.hold()
        t1 = time.perf_counter()
        # stages are timed in steady state: frame 0 carries the warm-up
        state, outputs = prof.timeit(
            "Render" if i else "Compile+first", step, scene, cam, params, tm,
            state, timer=timer if i or args.frames == 1 else None)
        _sync(device)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        mon.refresh()
        log(f"frame {i}: {frame_ms[-1]:.1f} ms")

    steady = frame_ms[1:] or frame_ms
    profile = None
    if args.profile_trace:
        profile = trace(lambda: step(scene, advance(cam), params, tm, state),
                        args.profile_trace, device)
        # the profiler slows the host side of the frame it traces, not its
        # kernels: the steady share is their time over an untraced frame's
        profile["steady_busy_share"] = profile["kernel_ms"] / float(
            np.mean(steady))
        log(json.dumps(profile))

    img = outputs["image"]
    if args.descale > 1:
        img = resize_bilinear(img, full_h, full_w)
    img = img.cpu().numpy()
    if args.out:
        with open(args.out, "wb") as f:
            f.write(encode_png(to_u8(img)))
    if args.hdr_out:
        np.save(args.hdr_out, outputs["hdr"].cpu().numpy())
    if args.save_state:
        save_pytree(args.save_state, state)
    log(prof.summary())
    log(mon.summary())
    stages = {k: v / len(steady) for k, v in timer.summary().items()}
    host = {k: {f: v / len(steady) for f, v in row.items()}
            for k, row in timer.host_summary().items()}
    summary = {
        "scene": args.scene, "width": w, "height": h, "frames": args.frames,
        "device": str(device), "trav": resolve_trav(device),
        "load_s": load_ms / 1e3,
        "ms_per_frame": float(np.mean(steady)), "frame_ms": frame_ms,
        "stage_ms_per_frame": stages, "stage_host_per_frame": host,
        "image_mean": float(img.mean()),
        "alpha_geometry": cfg.alpha_geometry, "env_mode": cfg.env_mode,
        "firefly_clamp": float(params.firefly_clamp),
        "frame_idx": int(state.frame_idx),
        "n_tris": int(scene.bvh.n_tris),
        "n_leaves": int(scene.bvh.leaf_blocks.shape[0]),
        "profile": profile, "profiler": prof.summary(),
    }
    return dict(summary, image=img, state=state, scene=scene, cfg=cfg,
                hdr=outputs["hdr"])


if __name__ == "__main__":
    out = run()
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("image", "state", "scene", "cfg", "hdr")}))
