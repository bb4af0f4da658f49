"""Gather, sort, argsort and cumsum rates of torch on a device (the
counterpart of tools/perf_gather.py).

    python -m eidola_tpu_torch.tools.perf_gather [--device cuda] [--rays R]

At R = 2,073,600 (a 1920x1080 frame's rays) by default, with a numpy
generator seeded 0 (:25-27):

- a gather-and-sum, `table[idx].sum(-1)`, from each of the six float32
  tables of :28-29 (rows x width) by R int64 row indices drawn below
  the row count; its line gives ms, Grows/s and GB/s (rows x width x 4
  bytes);
- on R keys drawn below 2^30 (:44) in the dtype of the port's own sort
  keys (int64: ops/packets.py:ray_sort_keys, render/indirect.py:87): a
  stable key/value sort (the keys sorted, int32 values 0..R-1 carried
  by the permutation), a stable argsort, and an int32 cumsum of the
  keys (wrapping, as the JAX tool's does).

Each is timed as 3 warm-up calls, then 10 calls between two CUDA events
(the host clock on the CPU), synced on the device, over 10 (:12-20).
The first line names the card and its power limit (nvidia-smi); then a
line per primitive, then one JSON line.  These are measurements of
torch calls, not of a kernel of the port.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import bench
from ..app.headless import _sync
from . import open_device

RAYS = 2_073_600
TABLES = ((2048, 8), (2048, 1), (65536, 8), (65536, 1), (1 << 20, 8),
          (2048, 32))
KEY_BITS = 30
KEY_DTYPE = torch.int64   # the port's ray and tile sort keys
WARMUP, ITERS = 3, 10


def timeit(fn, device: torch.device, iters: int = ITERS,
           warmup: int = WARMUP) -> float:
    """ms per call of `fn`: `warmup` calls, then `iters` calls between two
    synced CUDA events (on the CPU the host clock), over `iters`."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        _sync(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def inputs(rays: int, device: torch.device, seed: int = 0) -> dict:
    """The tables and their indices, then the keys and values, in the JAX
    tool's draw order."""
    rng = np.random.default_rng(seed)
    out = {"gathers": []}
    for n_rows, width in TABLES:
        table = rng.standard_normal((n_rows, width)).astype(np.float32)
        idx = rng.integers(0, n_rows, rays).astype(np.int64)
        out["gathers"].append((torch.from_numpy(table).to(device),
                               torch.from_numpy(idx).to(device)))
    keys = rng.integers(0, 1 << KEY_BITS, rays).astype(np.int64)
    out["keys"] = torch.from_numpy(keys).to(device=device, dtype=KEY_DTYPE)
    out["vals"] = torch.arange(rays, dtype=torch.int32, device=device)
    return out


def gather_sum(table, idx):
    return table[idx].sum(-1)


def sort_kv(keys, vals):
    sk, perm = torch.sort(keys, stable=True)
    return sk, vals[perm]


def argsort(keys):
    return torch.argsort(keys, stable=True)


def cumsum(keys):
    return torch.cumsum(keys.to(torch.int32), 0, dtype=torch.int32)


def measure(rays: int, device: torch.device) -> list:
    """[{name, shape, dtype, ms, ...}] for every primitive, in order."""
    x = inputs(rays, device)
    rows = []
    for table, idx in x["gathers"]:
        n_rows, width = table.shape
        ms = timeit(lambda: gather_sum(table, idx), device)
        rows_per_s = rays / (ms * 1e-3)
        rows.append({"name": "gather", "table": [n_rows, width],
                     "dtype": "float32", "ms": ms,
                     "grows_per_s": rows_per_s / 1e9,
                     "gb_per_s": rows_per_s * width * 4 / 1e9})
    keys, vals = x["keys"], x["vals"]
    dt = str(keys.dtype).replace("torch.", "")
    rows += [
        {"name": "sort_kv", "dtype": f"{dt} keys, int32 values",
         "ms": timeit(lambda: sort_kv(keys, vals), device)},
        {"name": "argsort", "dtype": dt,
         "ms": timeit(lambda: argsort(keys), device)},
        {"name": "cumsum", "dtype": "int32",
         "ms": timeit(lambda: cumsum(keys), device)},
    ]
    return rows


def row_line(r: dict, rays: int) -> str:
    if r["name"] == "gather":
        n_rows, width = r["table"]
        return (f"gather table=({n_rows:7d},{width:2d})  {r['ms']:7.3f} ms  "
                f"{r['grows_per_s']:.2f} Grows/s  {r['gb_per_s']:.0f} GB/s")
    return f"{r['name']} {rays} {r['dtype']}: {r['ms']:7.3f} ms"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="eidola_tpu_torch.tools.perf_gather",
        description="gather / sort / argsort / cumsum rates")
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu for the tests")
    p.add_argument("--rays", type=int, default=RAYS)
    args = p.parse_args(argv)
    device = open_device(args.device)
    if args.rays < 1:
        raise SystemExit("--rays must be >= 1")
    card = bench.card(device)
    print(f"device {card.get('nvidia_smi', card['name'])}; R = {args.rays}",
          flush=True)
    rows = measure(args.rays, device)
    for r in rows:
        print(row_line(r, args.rays), flush=True)
    print(json.dumps({"device": card, "rays": args.rays, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
