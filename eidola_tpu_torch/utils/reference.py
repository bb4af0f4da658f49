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

A frame is also held only against a frame of its own flags (`find`):
the bench's static frame (ReSTIR DI temporal, shadows every frame, no
seed, a still camera) and the interactive frame (chip_smoke.py's
INTERACTIVE flags: the camera orbiting, spatiotemporal reuse, the
shadow tiles at cadence 4, the seeded primary walk;
`<name>_interactive.npz`) are different frames,
and a frame of a scene read from files (the GLB and the .hdr that
`write_inputs` writes, `GLTF_SCENE`) is held only against a file that
records the same inputs' sha256.  A stored file that records none of
these reads as the static frame of a registry scene.

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

import hashlib
import json
import os
import time

import numpy as np
import torch

from ..render.config import RESTIR_TEMPORAL

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_DIR = os.path.join(ROOT, "tests", "golden_torch")
BOUND = 0.02      # mean abs, tests/test_golden.py's bound
BLOCK = 8
# the config fields a reference's `meta` records, held against the
# RenderConfig of the frame it is compared with
CONFIG_FIELDS = ("width", "height", "max_depth", "traversal_max_steps",
                 "env_mode", "alpha_geometry")
# the frame's flags a reference's `meta` records beside them, with the
# value a file that lacks the key (one stored before they were recorded:
# the bench's static frame) reads as
FLAG_DEFAULTS = {"restir_mode": RESTIR_TEMPORAL, "shadow_cadence": 1,
                 "primary_seed": False}
# the name the references of the scene that write_inputs writes are
# stored under (bistro_standin's parts as a GLB, under its .hdr)
GLTF_SCENE = "standin_glb"
ENV_SIZE = (1024, 2048)          # write_inputs' .hdr: height x width


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


def interactive(cfg, orbit: float = 0.0) -> bool:
    """Whether a frame of `cfg` with the camera orbiting `orbit` radians a
    frame is another than the static frame: any flag of FLAG_DEFAULTS
    off its default, or a moving camera."""
    return bool(orbit) or any(getattr(cfg, k) != v
                              for k, v in FLAG_DEFAULTS.items())


def find(scene: str, cfg, frame: int, march: str, orbit: float = 0.0,
         inputs: dict | None = None):
    """The path of `scene`'s reference for `cfg` at frame index `frame`
    under the alpha march `march` (what render/tracer._march_mode
    resolves for the frame's device: queue or lockstep), with the camera
    orbiting `orbit` radians a frame and, for a scene read from files,
    `inputs` the files' sha256 ({"glb": ..., "hdr": ...}), or None where
    none is stored.  A frame of an alpha-tested scene
    (`cfg.alpha_geometry`) under the queue march reads the `_queue`
    file, any other frame the plain one; an interactive frame reads the
    `_interactive` file.  A file whose `meta` records another config,
    other flags, another orbit or other inputs, or for an alpha scene
    another march, is no reference for the frame; a file that records no
    flags, orbit or inputs holds FLAG_DEFAULTS, a still camera and a
    registry scene.  A scene with no alpha-tested material runs no march
    and ignores `march`."""
    queue = bool(cfg.alpha_geometry) and march == "queue"
    path = os.path.join(REF_DIR, file_name(
        scene, cfg.width, cfg.height, cfg.max_depth, frame,
        "queue" if queue else "auto",
        "interactive" if interactive(cfg, orbit) else ""))
    if not os.path.exists(path):
        return None
    meta = load(path)["meta"]
    held = all(meta[k] == getattr(cfg, k) for k in CONFIG_FIELDS)
    held = held and all(meta.get(k, v) == getattr(cfg, k)
                        for k, v in FLAG_DEFAULTS.items())
    held = held and meta.get("orbit", 0.0) == orbit
    held = held and meta.get("inputs") == inputs
    held = held and meta["frame"] == frame
    if cfg.alpha_geometry:
        held = held and march_of(meta) == march
    return path if held else None


def sha256(path: str) -> str:
    """The hex sha256 of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def env_image() -> np.ndarray:
    """write_inputs' environment, (1024, 2048, 3) float32: a sun-like hot
    spot over a sky gradient with a +-3% grain from seed 11."""
    h, w = ENV_SIZE
    theta = (np.arange(h)[:, None] + 0.5) / h * np.pi     # from the zenith
    phi = (np.arange(w)[None, :] + 0.5) / w * 2.0 * np.pi
    sky = np.clip(np.cos(theta), 0.0, 1.0)[..., None]
    img = (np.asarray([0.25, 0.32, 0.45]) + sky * np.asarray([0.1, 0.2, 0.4])
           ) * np.ones((h, w, 1))
    ang = np.arccos(np.clip(np.sin(theta) * np.sin(0.9) * np.cos(phi - 2.0)
                            + np.cos(theta) * np.cos(0.9), -1.0, 1.0))
    img = img + (np.exp(-(ang / 0.02) ** 2)[..., None]
                 * np.asarray([9000.0, 7600.0, 5200.0]))
    img = img * np.random.default_rng(11).uniform(0.97, 1.03, (h, w, 1))
    return img.astype(np.float32)


def write_inputs(tmp: str) -> dict:
    """The file scene's inputs in the directory `tmp`: standin.glb,
    bistro_standin's parts as a GLB (models/scenes.write_standin_glb),
    and env.hdr, env_image as a flat Radiance .hdr.  Returns each file's
    path, size, seconds to write and sha256 under "glb" and "hdr"."""
    from ..models.scenes import write_standin_glb
    from ..scene.hdr import write_hdr

    out = {}
    for kind, write in (("glb", write_standin_glb),
                        ("hdr", lambda p: write_hdr(p, env_image()))):
        path = os.path.join(tmp, "standin.glb" if kind == "glb"
                            else "env.hdr")
        t0 = time.perf_counter()
        write(path)
        out[kind] = {"path": path, "bytes": os.path.getsize(path),
                     "seconds": time.perf_counter() - t0,
                     "sha256": sha256(path)}
    return out


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
