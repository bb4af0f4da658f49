"""The port's entry points (counterpart of the repo's __graft_entry__.py):
one frame step, and the multi-device dry run.

    python -m eidola_tpu_torch.entry

runs `entry("cuda")`'s step once on the card, then
`dryrun_multichip(torch.cuda.device_count(), "nccl", "cuda")`.

- `entry(device)` -> (fn, args): one step of the default pipeline (ReSTIR
  DI + GI, a-trous denoise) on cornell at the JAX entry's lean config
  (64x64, max_depth 2, traversal_max_steps 512, one denoise level each);
  fn(*args) returns (new_state, image).
- `dryrun_multichip(n, backend, device)` runs the JAX dry run's three
  parts on n ranks (parallel/sharding.run_ranks, one process each, over
  `backend`), each rank in `dryrun_rank`:
  1. partition only, at the production height padded_height(1080, n):
     the rank's FrameState holds its rows of every image plane
     (shard_state, assert_row_sharded);
  2. two steps of the sharded frame at 64 x max(16n, 64) (max_depth 1,
     no tiled multi-bounce, one denoise level each): on every rank the
     largest collective of the second step, the first on carried state
     (parallel/comm_audit.collective_summary) under 16 image planes,
     the gathered images finite and of their shape, the carried state
     still row-sharded;
  3. mini_grove (instanced trees, alpha-MASK leaf cards, the HitTest on,
     2 alpha hops) at the same size, one step under
     EIDOLA_ALPHA_MARCH=queue (the band-local queue march), held to the
     same bounds.
  It raises on any failed check and returns each part's readout.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .models.scenes import load_scene
from .parallel.sharding import (assert_row_sharded, padded_height,
                                render_rank, run_ranks, shard_state)
from .render.config import RenderConfig, default_params, default_tonemap
from .render.frame import init_frame_state, render_frame

ENTRY_CFG = dict(width=64, height=64, max_depth=2, env_mode="sunsky",
                 traversal_max_steps=512, denoise_direct_levels=1,
                 denoise_indirect_levels=1)
PLANES = 16          # a collective past 16 image planes leaked a full state
RANK_S = 900.0       # the dry run's time limit


def entry(device="cuda"):
    """(fn, example_args): one frame step on cornell at the lean config."""
    device = torch.device(device)
    cfg = RenderConfig(**ENTRY_CFG)
    scene, cam = load_scene("cornell", device=device)
    params, tm = default_params(device=device), default_tonemap(device=device)
    state = init_frame_state(cfg, cam)

    def fn(scene, cam, params, tm, state):
        new_state, outputs = render_frame(cfg, scene, cam, params, tm, state)
        return new_state, outputs["image"]

    return fn, (scene, cam, params, tm, state)


def _small_cfgs(n: int):
    """The dry run's executed configs (parts 2 and 3) at 64 x max(16n, 64)."""
    lean = dict(width=64, height=max(16 * n, 64), max_depth=1,
                env_mode="sunsky", traversal_max_steps=128,
                tiled_multibounce=False, denoise_direct_levels=1,
                denoise_indirect_levels=1)
    return (RenderConfig(**lean),
            RenderConfig(**lean, alpha_geometry=True, alpha_hops=2))


def dryrun_rank(group, job: dict) -> dict:
    """One rank of the dry run (module level: spawn pickles it by name)."""
    dev = torch.device(job["device"])
    n = group.world
    scene, cam = load_scene("cornell", device=dev)
    h_prod = padded_height(1080, n)
    cfg_prod = RenderConfig(width=32, height=h_prod, max_depth=2,
                            env_mode="sunsky", traversal_max_steps=512,
                            denoise_direct_levels=2, denoise_indirect_levels=2)
    state = shard_state(init_frame_state(cfg_prod, cam), cfg_prod, group)
    assert_row_sharded(state, cfg_prod, group)
    rows = int(state.gbuf.tri.shape[0])
    del state
    cfg, cfg_g = _small_cfgs(n)
    steps = render_rank(group, dict(cfg=cfg, frames=2, device=job["device"]),
                        scene, cam)
    env = {"EIDOLA_ALPHA_MARCH": "queue"}
    was = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        grove = render_rank(group, dict(scene="mini_grove", cfg=cfg_g,
                                        frames=1, device=job["device"]))
    finally:
        for k, v in was.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return {"rank": group.rank, "prod_height": h_prod, "prod_rows": rows,
            "steps": steps, "grove": grove}


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _check_part(label: str, ranks: list, key: str, cfg, frames: int) -> dict:
    """The audit bound on every rank, rank 0's gathered images finite and
    of the config's shape; returns the readout."""
    plane = cfg.height * cfg.width * 4
    largest = max(r[key]["audit"]["largest"] for r in ranks)
    _require(largest < PLANES * plane,
             f"{label}: a collective moves {largest} B (>= {PLANES} image "
             f"planes of {plane} B): a full-state exchange leaked past the "
             f"banding")
    images = ranks[0][key]["images"]
    _require(len(images) == frames, f"{label}: {len(images)} images, "
                                    f"want {frames}")
    for img in images:
        _require(img.shape == (cfg.height, cfg.width, 3),
                 f"{label}: image shape {img.shape}")
        _require(bool(np.isfinite(img).all()), f"{label}: image not finite")
    return {"total": max(r[key]["audit"]["total"] for r in ranks),
            "largest": largest, "image_mean": float(images[-1].mean()),
            "ms": [r[key]["ms"] for r in ranks]}


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     device: str = "cuda", threads: int = 0) -> dict:
    """The JAX dry run's three parts on `n_devices` ranks over `backend`
    (`threads` > 0: each rank's torch threads); raises on a failed check,
    returns each part's readout."""
    ranks = run_ranks(n_devices, backend, dryrun_rank,
                      (dict(device=device),), RANK_S, threads)
    h_prod = ranks[0]["prod_height"]
    for r in ranks:
        _require(r["prod_rows"] * n_devices == h_prod,
                 f"rank {r['rank']} holds {r['prod_rows']} of {h_prod} rows")
    print(f"dryrun_multichip({n_devices}) 32x{h_prod}: sharding OK "
          "(partition-only)", flush=True)
    cfg, cfg_g = _small_cfgs(n_devices)
    h = cfg.height
    steps = _check_part(f"dryrun_multichip({n_devices}) 64x{h}", ranks,
                        "steps", cfg, 2)
    print(f"dryrun_multichip({n_devices}) collective audit at 64x{h}: total "
          f"{steps['total'] / 1e6:.2f} MB, largest "
          f"{steps['largest'] / 1e6:.2f} MB; image mean "
          f"{steps['image_mean']:.4f}", flush=True)
    grove = _check_part(f"dryrun_multichip({n_devices}) alpha+instanced",
                        ranks, "grove", cfg_g, 1)
    print(f"dryrun_multichip({n_devices}) alpha+instanced 64x{h}: total "
          f"{grove['total'] / 1e6:.2f} MB, largest "
          f"{grove['largest'] / 1e6:.2f} MB; image mean "
          f"{grove['image_mean']:.4f}", flush=True)
    return {"world": n_devices, "backend": backend, "prod_height": h_prod,
            "steps": steps, "grove": grove}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("eidola_tpu_torch.entry: no CUDA device")
    fn, args = entry("cuda")
    _, image = fn(*args)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(image).all()), "entry: image not finite")
    print("entry OK", flush=True)
    dryrun_multichip(torch.cuda.device_count(), "nccl", "cuda")


if __name__ == "__main__":
    main()
