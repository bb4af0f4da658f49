"""The JAX package's stored reference frames (tests/golden_torch/*.npz)
and the check of a port frame against one.

A reference is the JAX package's linear `hdr` of one frame of one
config, written by tests/golden_torch/regen.py (the only file that
imports JAX for it; this module reads numpy files only):

- at 1920x1080 (bench.py's frame: frame 1, the bench's last warm-up
  frame, and for some scenes a last timed frame) two statistics of it:
  the pixels on a stride-4 lattice (`lattice`, float16) and the 8x8
  block means (`blocks`, float32);
- at a small size (272x136, frame 3 or 41) the whole `hdr` (float32),
  from which both statistics are taken the same way (the lattice at
  stride 1).

A frame is held against the stored frame of its own index only: the
accumulated frame's expectation moves with the temporal history, so an
earlier frame is no reference for a later one.

A scene with an alpha-tested material renders another frame under each
of the HitTest's two marches (the queue march draws another BLEND rng
stream than the lockstep one): a frame under the queue march, the
card's default, is held against `<name>_queue.npz`, one under the
lockstep march, the CPU's, against the plain `<name>.npz` (`find`).

`compare` takes a port `hdr` tensor on any device and gives the mean abs
on the lattice, the mean abs and the max abs of the block means, and the
block where the max falls (row, column of 8x8 blocks).  A frame passes
when both means are below BOUND, tests/test_golden.py's 0.02; the max
and its block are reported so that a local fault shows where the means
pass.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_DIR = os.path.join(ROOT, "tests", "golden_torch")
BOUND = 0.02      # mean abs, tests/test_golden.py's bound
BLOCK = 8
# the config fields a reference's `meta` records, held against the
# RenderConfig of the frame it is compared with
CONFIG_FIELDS = ("width", "height", "max_depth", "traversal_max_steps",
                 "env_mode", "alpha_geometry")


def file_name(scene: str, width: int, height: int, depth: int,
              frame: int, march: str = "auto", tag: str = "") -> str:
    """`<scene>_<W>x<H>_d<depth>_f<frame>.npz`, `_<march>` before the
    extension for a frame under EIDOLA_ALPHA_MARCH=<march> and `_<tag>`
    after it for one under other march switches."""
    tail = ("" if march == "auto" else f"_{march}") + (f"_{tag}" if tag
                                                       else "")
    return f"{scene}_{width}x{height}_d{depth}_f{frame}{tail}.npz"


def march_of(meta: dict) -> str:
    """The alpha march a stored frame ran: its `meta["alpha_march"]`,
    where "auto" (regen.py's default, resolved on JAX's CPU) is
    lockstep."""
    march = meta.get("alpha_march", "auto")
    return "lockstep" if march == "auto" else march


def find(scene: str, cfg, frame: int, march: str):
    """The path of `scene`'s reference for `cfg` at frame index `frame`
    under the alpha march `march` (what render/tracer._march_mode
    resolves for the frame's device: queue or lockstep), or None where
    none is stored.  A frame of an alpha-tested scene
    (`cfg.alpha_geometry`) under the queue march reads the `_queue`
    file, any other frame the plain one; a file whose `meta` records
    another config, or for an alpha scene another march, is no
    reference for the frame.  A scene with no alpha-tested material runs
    no march and ignores `march`."""
    queue = bool(cfg.alpha_geometry) and march == "queue"
    path = os.path.join(REF_DIR, file_name(
        scene, cfg.width, cfg.height, cfg.max_depth, frame,
        "queue" if queue else "auto"))
    if not os.path.exists(path):
        return None
    meta = load(path)["meta"]
    held = all(meta[k] == getattr(cfg, k) for k in CONFIG_FIELDS)
    held = held and meta["frame"] == frame
    if cfg.alpha_geometry:
        held = held and march_of(meta) == march
    return path if held else None


def load(path: str) -> dict:
    """{"meta": dict, "lattice": (h', w', 3) f32, "stride": int,
    "blocks": (h/8, w/8, 3) f32} of a stored reference."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        if "hdr" in z:
            hdr = z["hdr"].astype(np.float32)
            return {"meta": meta, "lattice": hdr, "stride": 1,
                    "blocks": block_means(hdr)}
        return {"meta": meta, "lattice": z["lattice"].astype(np.float32),
                "stride": int(meta["lattice"]),
                "blocks": z["blocks"].astype(np.float32)}


def block_means(hdr: np.ndarray, block: int = BLOCK) -> np.ndarray:
    """(h/block, w/block, c) means, summed in float64 (regen.py's)."""
    h, w, c = hdr.shape
    x = np.asarray(hdr, np.float64)[: h - h % block, : w - w % block]
    return x.reshape(h // block, block, w // block, block, c).mean(
        axis=(1, 3)).astype(np.float32)


def compare(hdr: torch.Tensor, ref: dict) -> dict:
    """Readings of a port frame's linear `hdr` (h, w, 3) against `ref`
    (`load`'s dict): mean abs on the lattice, mean abs and max abs of
    the block means with the block of the max, the bound and `ok`."""
    dev = hdr.device
    s = ref["stride"]
    lat_ref = torch.from_numpy(ref["lattice"]).to(dev)
    blk_ref = torch.from_numpy(ref["blocks"]).to(dev)
    h, w, c = hdr.shape
    if (h // s if h % s == 0 else -1, w // s if w % s == 0 else -1,
            c) != tuple(lat_ref.shape) or (h // BLOCK, w // BLOCK,
                                           c) != tuple(blk_ref.shape):
        raise ValueError(f"frame {tuple(hdr.shape)} does not match the "
                         f"reference's lattice {tuple(lat_ref.shape)} at "
                         f"stride {s} and blocks {tuple(blk_ref.shape)}")
    x = hdr.detach().to(torch.float64)
    lat = (x[::s, ::s] - lat_ref.double()).abs().mean()
    blocks = x[: h - h % BLOCK, : w - w % BLOCK].reshape(
        h // BLOCK, BLOCK, w // BLOCK, BLOCK, c).mean(dim=(1, 3)).float()
    d = (blocks - blk_ref).abs()
    flat = int(d.amax(dim=2).argmax())
    lat, bmean, bmax = (float(v) for v in (lat, d.double().mean(), d.max()))
    finite = bool(torch.isfinite(hdr).all())
    return {"mean_abs": lat, "block_mean_abs": bmean, "block_max": bmax,
            "block_max_at": [flat // d.shape[1], flat % d.shape[1]],
            "bound": BOUND,
            "ok": finite and lat < BOUND and bmean < BOUND}


def line(label: str, readings: dict) -> str:
    """One printed line of a check: label, the three readings, the block
    of the max and the bound."""
    r = readings
    return (f"{label}: lattice mean abs {r['mean_abs']:.6g}, block means "
            f"mean abs {r['block_mean_abs']:.6g}, max {r['block_max']:.6g} "
            f"at block {tuple(r['block_max_at'])}; bound {r['bound']} "
            f"({'ok' if r['ok'] else 'FAILED'})")



def main(argv=None) -> int:
    """`python -m eidola_tpu_torch.utils.reference [--scene S] [--device
    D]`: bench.py's frames 0-1 of the scene at 1920x1080 (the scene's
    camera at every step) on the device, frame 1 held against its stored
    reference of the alpha march the device runs (EIDOLA_ALPHA_MARCH,
    else queue on the card and lockstep on the CPU); prints the
    readings' line and, last, one JSON line (null readings where none is
    stored).  Exits 1 on a miss or a missing reference."""
    import argparse
    import time

    from .. import bench
    from ..app.headless import _sync, set_numerics
    from ..models.scenes import load_scene
    from ..ops.packets import resolve_trav
    from ..render.config import default_params, default_tonemap
    from ..render.frame import init_frame_state, make_step
    from ..render.tracer import _march_mode

    p = argparse.ArgumentParser(prog="eidola_tpu_torch.utils.reference")
    p.add_argument("--scene", default="bistro_standin")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    set_numerics()
    t0 = time.perf_counter()
    scene, cam = load_scene(args.scene, device=device, **(
        {"n": 16} if args.scene == "stress" else {}))
    _sync(device)
    load_s = time.perf_counter() - t0
    cfg = bench.frame_cfg(scene, bench.W, bench.H)
    frame = bench.WARMUP - 1
    params = default_params(device=device)
    tm = default_tonemap(device=device)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    frame_s = []
    for _ in range(frame + 1):
        t0 = time.perf_counter()
        state, out = step(scene, cam, params, tm, state)
        _sync(device)
        frame_s.append(time.perf_counter() - t0)
    march = _march_mode(device)
    path = find(args.scene, cfg, frame, march)
    got = None if path is None else compare(out["hdr"], load(path))
    trav = resolve_trav(device)
    label = (f"{args.scene} {cfg.width}x{cfg.height} frame {frame} on "
             f"{device.type} (trav {trav}, march {march})")
    print(line(label, got) if got else f"{label}: no stored reference",
          flush=True)
    print(json.dumps({"scene": args.scene, "width": cfg.width,
                      "height": cfg.height, "frame": frame,
                      "device": str(device), "trav": trav,
                      "alpha_march": march,
                      "reference_file": path and os.path.relpath(path, ROOT),
                      "readings": got, "load_s": load_s,
                      "frame_s": frame_s}), flush=True)
    return 0 if got and got["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
