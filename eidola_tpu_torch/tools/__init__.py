"""The port's counterparts of the repo's root `tools/` scripts, each under
the root tool's own name:

- `fidelity_metrics`: the per-stage RMSE / mean-relative-error table
  against the path-traced oracle (`tools/fidelity_metrics.py`);
- `fidelity_captures`: the per-stage captures as PNG files
  (`tools/fidelity_captures.py`);
- `perf_gather`: gather, sort, argsort and cumsum rates at a frame's ray
  count (`tools/perf_gather.py`).

Each runs as `python -m eidola_tpu_torch.tools.<name>` on the device its
`--device` names (default cuda; cpu for the tests) and nowhere else.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import bench
from ..ops.packets import resolve_trav
from ..utils.reference import REF_DIR, march_of


def open_device(name: str) -> torch.device:
    """The device `name` names, refused with SystemExit (exit code 1)
    when it is not there: nothing falls back to another device."""
    try:
        device = torch.device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}") from None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device "
                             "(torch.cuda.is_available() is false); "
                             "nothing run")
        if device.index is not None and \
                device.index >= torch.cuda.device_count():
            raise SystemExit(f"--device {name}: only "
                             f"{torch.cuda.device_count()} CUDA devices; "
                             "nothing run")
    elif device.type != "cpu":
        raise SystemExit(f"--device {name}: this tool runs on cuda or cpu")
    return device


class Launches:
    """The walk and drain kernels' launches while the block runs (the
    counters of ops/bvh_walk.py, bvh_fused.py and bvh_mxu.py, read before
    and after it, never set to 0).  `check()` holds them to the traversal
    the device resolves, as the bench does: on the card's default, walk
    launches and no drain, so nothing fell back to the torch walk."""

    def __init__(self, device: torch.device):
        self.device, self.trav, self.counts = device, resolve_trav(device), {}

    def __enter__(self):
        self._before = bench.read_launches()
        return self

    def __exit__(self, *exc):
        after = bench.read_launches()
        for k, v in after.items():
            self.counts[k] = self.counts.get(k, 0) + v - self._before[k]
        return False

    def check(self) -> dict:
        if self.device.type == "cuda":
            bench._check_launches(self.trav, self.counts)
        return self.counts


def find_stored(stem: str, alpha_geometry: bool, march: str,
                expect: dict):
    """The path of JAX's stored outputs `tests/golden_torch/<stem>.npz`
    (tests/golden_torch/regen.py, the FIDELITY group) for a run under the
    alpha march `march`, or None.  An alpha-tested scene under the queue
    march reads `<stem>_queue.npz`, as utils/reference.find names a
    frame; a scene with no alpha-tested material has one file for both
    marches.  A file whose meta differs from `expect` on any of its keys,
    or records another march, is no reference."""
    queue = alpha_geometry and march == "queue"
    path = os.path.join(REF_DIR, stem + ("_queue" if queue else "")
                        + ".npz")
    if not os.path.exists(path):
        return None
    meta = load_stored(path, ())["meta"]
    held = all(meta.get(k) == v for k, v in expect.items())
    if alpha_geometry:
        held = held and march_of(meta) == march
    return path if held else None


def load_stored(path: str, names) -> dict:
    """{"meta": dict, name: float32 array for each of `names`}."""
    with np.load(path) as z:
        out = {k: z[k].astype(np.float32) for k in names}
        out["meta"] = json.loads(str(z["meta"]))
    return out
