"""Per-stage fidelity table of the port against its path-traced oracle
(the counterpart of tools/fidelity_metrics.py).

    python -m eidola_tpu_torch.tools.fidelity_metrics [--device cuda]
        [--size W H] [--spp N] [--frames N[,N...]] [--scene NAME]
        [--out FILE]

Each stage's RMSE and mean-relative error against `trace_radiance`, the
unbiased estimator, at fixed seeds, as the JAX tool computes them
(tools/fidelity_metrics.py:50-89):

- the oracle (`oracle`, :50-68): the mean over `spp` samples of
  `trace_radiance` of the camera rays from `seed_pixels(h, w, 90001 +
  7919 s)`, default params;
- a stage (`pipeline`, :71-83): the mean of the frame's `hdr` over
  `frames` frames with time_word i * 677 from `init_frame_state`;
- `metrics` (:86-89): RMSE, and |mean(test) - mean(ref)| / mean(ref).

The stages (:105-119): direct-only raw (no denoise, no indirect) against
the oracle at max_depth 1, composed raw (no denoise) and composed
denoised against the full-depth oracle.  The default table is the JAX
tool's (:92-104): cornell and alpha at 96x96, max_depth 2, sun & sky,
traversal_max_steps 2048, the HitTest from the scene, accumulate off,
48 frames, 96 spp.  `--scene NAME` renders NAME's bench frame instead
(eidola_tpu_torch/bench.py:frame_cfg: depth 4, the scene's environment
and HitTest) with accumulate off, as the tool sets it.  `--frames
2,6,...` gives each count's rows from one run's running sums: the frame
sequence is fixed, so they are the rows of separate runs.

It prints one line per row and, last, one JSON line with every row; the
table goes to `--out FILE` too when given, never under docs/.  Where
tests/golden_torch/ holds the JAX tool's outputs for the same scene,
size, frame count, spp and alpha march (tests/golden_torch/regen.py,
the FIDELITY group: `fidelity_<scene>_<W>x<H>_f<N>_s<spp>[_queue].npz`),
JAX's row is printed beside each and every image is held against JAX's:
a mean abs at or past `BOUND` exits 1.  On the card every ray goes
through the walk kernel (walk launches, no drain, else it fails).
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
from ..ops import rng as erng
from ..render.config import RenderConfig, default_params, default_tonemap
from ..render.frame import init_frame_state, make_step
from ..render.tracer import _march_mode, trace_radiance
from ..scene.camera import spawn_rays
from ..utils.reference import ROOT
from . import Launches, find_stored, load_stored, open_device

W = H = 96
FRAMES = 48               # accumulated frames per stage
SPP = 96                  # oracle samples
SCENES = ("cornell", "alpha")
SEED0, SEED_STEP = 90001, 7919   # sample s's seed: SEED0 + SEED_STEP s
TIME_STEP = 677                  # frame i's time_word: i * TIME_STEP
BAND_PIXELS = 1 << 20     # the oracle traces at most this many pixels a call
BOUND = 0.02              # mean abs against JAX's, tests/test_golden.py's
STAGES = ("direct-only raw", "composed raw", "composed denoised")
# the arrays of a stored JAX file: the two oracles, then the stages
IMAGES = ("oracle_d1", "oracle", "direct_raw", "composed_raw",
          "composed_denoised")


def base_config(scene, width: int, height: int, bench_frame: bool = False
                ) -> RenderConfig:
    """The JAX tool's base config (:95-99), or with `bench_frame` the
    bench's frame config, both with accumulate off."""
    if bench_frame:
        return dataclasses.replace(bench.frame_cfg(scene, width, height),
                                   accumulate=False)
    return RenderConfig(width=width, height=height, max_depth=2,
                        env_mode="sunsky", traversal_max_steps=2048,
                        alpha_geometry=alpha_geometry(scene),
                        accumulate=False)


def stage_configs(base: RenderConfig) -> list:
    """[(stage, config, oracle depth)] of :105-119."""
    return [
        (STAGES[0], dataclasses.replace(base, denoise=False,
                                        indirect_enabled=False), 1),
        (STAGES[1], dataclasses.replace(base, denoise=False),
         base.max_depth),
        (STAGES[2], base, base.max_depth),
    ]


def oracle(scene, cam, cfg: RenderConfig, spp: int) -> torch.Tensor:
    """(h, w, 3) float32 on the scene's device: the mean over `spp`
    samples of trace_radiance of the camera rays (:50-68), summed in
    float32 in sample order.  Each sample traces the image in bands of
    whole rows (multiples of 8, at most BAND_PIXELS pixels) seeded by
    their global pixel index, so a band's rays are the whole image's."""
    dev = cam.pos.device
    params = default_params(device=dev)
    h, w = cfg.height, cfg.width
    rows = max(8, BAND_PIXELS // w // 8 * 8)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        word = (SEED0 + SEED_STEP * s) & 0xFFFFFFFF
        for r0 in range(0, h, rows):
            n = min(rows, h - r0)
            st = erng.seed_pixels(n, w, word, device=dev, row0=r0)
            st, o, d = spawn_rays(cam, h, w, st, row0=r0)
            _, rad, _ = trace_radiance(cfg, scene, params, o, d, st)
            acc[r0:r0 + n] += rad
    return acc / spp


def pipeline(scene, cam, cfg: RenderConfig, frames) -> dict:
    """{N: (h, w, 3) float32} for each N of `frames` (an int or a list):
    the mean of the frame's `hdr` over frames 0..N-1, time_word i * 677,
    from `init_frame_state` (:71-83), from one run's float32 running sum
    (frame order), so each N's image is a separate N-frame run's."""
    counts = sorted({frames} if isinstance(frames, int) else set(frames))
    dev = cam.pos.device
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    out = {}
    for i in range(counts[-1]):
        p = params._replace(time_word=torch.tensor(
            (i * TIME_STEP) & 0xFFFFFFFF, dtype=torch.int64, device=dev))
        state, o = step(scene, cam, p, tm, state)
        acc += o["hdr"]
        if i + 1 in counts:
            out[i + 1] = acc / (i + 1)
    return out


def metrics(test, ref) -> tuple[float, float]:
    """(RMSE, mean-relative error) of two images as numpy float32
    (:86-89)."""
    test, ref = np.asarray(test), np.asarray(ref)
    rmse = float(np.sqrt(np.mean((test - ref) ** 2)))
    mrel = float(abs(test.mean() - ref.mean()) / max(ref.mean(), 1e-9))
    return rmse, mrel


def find_ref(scene: str, cfg: RenderConfig, frames: int, spp: int,
             march: str):
    """The path of JAX's stored table for this scene, config, frame count
    and spp under the alpha march `march`
    (`fidelity_<scene>_<W>x<H>_f<N>_s<spp>[_queue].npz`), or None."""
    return find_stored(
        f"fidelity_{scene}_{cfg.width}x{cfg.height}_f{frames}_s{spp}",
        cfg.alpha_geometry, march,
        {"width": cfg.width, "height": cfg.height, "frames": frames,
         "spp": spp, "max_depth": cfg.max_depth,
         "traversal_max_steps": cfg.traversal_max_steps})


def table(scene, cam, name: str, base: RenderConfig, counts: list,
          spp: int) -> tuple[list, dict, dict]:
    """(rows, images, info) of one scene: a row {scene, stage, frames,
    rmse, mrel, oracle_mean} per stage and frame count of `counts`
    (ascending), the images as numpy by IMAGES' names (the pipeline's at
    the largest count), and {"seconds": of the oracles and of each
    stage, "oracle_peak_gib": the device's peak allocation by the end of
    the oracles (None on the CPU)}."""
    dev = cam.pos.device
    t0 = time.perf_counter()
    oracles = {d: oracle(scene, cam, dataclasses.replace(base, max_depth=d),
                         spp).cpu().numpy()
               for d in sorted({1, base.max_depth})}
    seconds = {"oracles": time.perf_counter() - t0}
    info = {"seconds": seconds, "oracle_peak_gib": (
        torch.cuda.max_memory_allocated(dev) / 2**30
        if dev.type == "cuda" else None)}
    images = {"oracle_d1": oracles[1], "oracle": oracles[base.max_depth]}
    rows = []
    for (stage, cfg, depth), key in zip(stage_configs(base), IMAGES[2:]):
        t0 = time.perf_counter()
        means = pipeline(scene, cam, cfg, counts)
        _sync(dev)
        seconds[stage] = time.perf_counter() - t0
        ref = oracles[depth]
        for n in counts:
            img = means[n].cpu().numpy()
            rmse, mrel = metrics(img, ref)
            rows.append({"scene": name, "stage": stage, "frames": n,
                         "rmse": rmse, "mrel": mrel,
                         "oracle_mean": float(ref.mean())})
        images[key] = img
    return rows, images, info


def row_line(r: dict) -> str:
    """A row as the JAX tool prints it (:121-123), the frame count added."""
    return (f"{r['scene']:8s} {r['stage']:20s} RMSE {r['rmse']:.4f}  "
            f"mean-rel {r['mrel'] * 100:.2f}%  (oracle mean "
            f"{r['oracle_mean']:.4f}; {r['frames']} frames)")


def hold(images: dict, ref: dict) -> dict:
    """{image: mean abs against JAX's} and whether each is below BOUND."""
    err = {k: float(np.abs(images[k] - ref[k]).mean()) for k in IMAGES}
    return {"mean_abs": err, "bound": BOUND,
            "ok": all(v < BOUND for v in err.values())}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eidola_tpu_torch.tools.fidelity_metrics",
        description="per-stage RMSE against the path-traced oracle")
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu for the tests")
    p.add_argument("--size", type=int, nargs=2, default=[W, H],
                   metavar=("WIDTH", "HEIGHT"))
    p.add_argument("--spp", type=int, default=SPP)
    p.add_argument("--frames", default=str(FRAMES),
                   help="a frame count, or a comma-separated list of them")
    p.add_argument("--scene", default=None,
                   help="render this scene's bench frame instead of the "
                        "default table's two scenes")
    p.add_argument("--out", default=None,
                   help="also write the table (JSON) to this file")
    return p


def run(argv=None) -> dict:
    """The tool on `argv`: prints the rows (JAX's beside them where
    stored) and returns the result of the JSON line plus, under
    "images", each scene's IMAGES as numpy (the stages' at the largest
    frame count)."""
    args = build_argparser().parse_args(argv)
    device = open_device(args.device)
    counts = sorted({int(n) for n in args.frames.split(",")})
    if counts[0] < 1 or args.spp < 1:
        raise SystemExit("--frames and --spp must be >= 1")
    set_numerics()
    width, height = args.size
    march = _march_mode(device)
    card = bench.card(device)
    launches = Launches(device)
    print(f"device {card.get('nvidia_smi', card['name'])}; trav "
          f"{launches.trav}; alpha march {march}", flush=True)
    t_start = time.perf_counter()
    rows, held, images, parts = [], {}, {}, {}
    for name in ([args.scene] if args.scene else SCENES):
        scene, cam = load_scene(name, device=device, **(
            {"n": 16} if name == "stress" else {}))
        base = base_config(scene, width, height, bench_frame=bool(args.scene))
        if device.type == "cuda":
            _sync(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with launches:
            got, images[name], parts[name] = table(scene, cam, name, base,
                                                   counts, args.spp)
        _sync(device)
        seconds = time.perf_counter() - t0
        parts[name]["peak_gib"] = (
            torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
        path = find_ref(name, base, counts[-1], args.spp, march)
        ref = None if path is None else load_stored(path, IMAGES)
        jax_rows = {} if ref is None else {
            r["stage"]: r for r in ref["meta"]["rows"]}
        for r in got:
            line = row_line(r)
            j = jax_rows.get(r["stage"]) if r["frames"] == counts[-1] else None
            if j:
                line += (f"  | JAX RMSE {j['rmse']:.4f}  mean-rel "
                         f"{j['mrel'] * 100:.2f}%  (oracle mean "
                         f"{j['oracle_mean']:.4f})")
            print(line, flush=True)
        if ref is not None:
            held[name] = dict(hold(images[name], ref), jax_rows=list(
                jax_rows.values()), file=os.path.relpath(path, ROOT))
            print(f"{name}: images against JAX's {held[name]['file']}: "
                  "mean abs " + ", ".join(
                      f"{k} {v:.3g}" for k, v in
                      held[name]["mean_abs"].items())
                  + f"; bound {BOUND} "
                  f"({'ok' if held[name]['ok'] else 'FAILED'})", flush=True)
        print(f"{name}: {width}x{height}, {counts[-1]} frames, {args.spp} "
              f"spp in {seconds:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s"
                          for k, v in parts[name]["seconds"].items())
              + "); peak memory " + (
                  f"{parts[name]['oracle_peak_gib']:.2f} GiB in the "
                  f"oracles, {parts[name]['peak_gib']:.2f} GiB in all"
                  if parts[name]["peak_gib"] is not None
                  else "not measured (cpu)"),
              flush=True)
        rows += got
    result = {"device": card, "trav": launches.trav, "alpha_march": march,
              "width": width, "height": height, "spp": args.spp,
              "frames": counts, "rows": rows, "jax": held,
              "launches": launches.check(), "parts": parts,
              "seconds": time.perf_counter() - t_start}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return dict(result, images=images)


def main(argv=None) -> int:
    """Exit code 1 when an image misses JAX's stored one."""
    return 0 if all(h["ok"] for h in run(argv)["jax"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
