"""The readings that the limits of `correct` (workloads/<cell>.json) are
set from, on the card, at the cell's own size:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --frames 5

In one process (the program's scene and the reference's are made once):
for each seed, the program renders the traffic's warm-up frames and
`--frames` more from a fresh state, and its last frame is held to the
reference as a run holds its window's last frame (the lower readings);
for each control seed, the control, the reference in TF32
(reference.Reference(control=True)), is put in the program's place on
the same frame's inputs (the upper readings).  Prints one JSON line a
reading, with every number of check.NUMBERS (light_mismatch among them),
and a summary line: the largest program reading and the smallest control
reading of each number.  The benchmark's runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, manifest  # noqa: E402
from benchmark.frames import Frames  # noqa: E402
from benchmark.run import set_caches  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    set_caches()
    import torch

    from benchmark.reference import Reference

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    frames = Frames(cell.config, cell.traffic, args.seeds[0], device)
    t0 = time.perf_counter()
    ref = Reference(cell.config, cell.traffic, args.seeds[0], device)
    ctl = Reference(cell.config, cell.traffic, args.seeds[0], device,
                    control=True, scene=ref.scene)
    print(json.dumps({"reference_load_s": time.perf_counter() - t0}),
          flush=True)
    per_call = int(cell.workload["check"]["rays_per_call"])
    lower, upper = {}, {}
    for seed in args.seeds:
        frames.restart(seed)
        frames.warm(int(cell.traffic["warmup_frames"]) + args.frames)
        index = frames.index - 1
        rec = check.record(frames.step, frames.scene, frames.cam,
                           frames.params, frames.tm, frames.prev, seed,
                           per_call)
        ref.reseed(seed)
        t0 = time.perf_counter()
        want = check.reference_answers(ref, rec, frames.out, frames.prev,
                                       index)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        got = check.compare(ref, rec, frames.out, frames.state, frames.prev,
                            index, want=want)
        for k, v in got.items():
            lower[k] = max(lower.get(k, 0.0), v)
        print(json.dumps({"seed": seed, "kind": "program", "frame": index,
                          "reference_s": ref_s, **got}), flush=True)
        if seed in args.control_seeds:
            ctl.reseed(seed)
            got = check.control_readings(ctl, want, rec, frames.out,
                                         frames.prev, index)
            for k, v in got.items():
                upper[k] = min(upper.get(k, float("inf")), v)
            print(json.dumps({"seed": seed, "kind": "control",
                              "frame": index, **got}), flush=True)
        del rec, want
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
