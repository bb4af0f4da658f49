"""BENCHMARK.json and the files of one cell, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Its files: `configs/<config>.json` (the `file` of the configuration's
entry), `traffic/<traffic>.json` and `workloads/<cell>.json` (the cell's
configuration, mix and chips, as BENCHMARK.json has them, and the limits
that decide `correct`).  Its metrics: the end-to-end and per-layer
entries of BENCHMARK.json that take this cell (all cells when an entry
has no `workloads` key); each per-layer metric is read by
`metrics/<name>.py`.  The scene that the plain reference traces is
`reference/scenes/<scene>.py`, found by the configuration's `scene`, and
the light it samples `reference/lights/<kind>.py`, found by the kind the
scene names.  A new cell, mix, configuration, metric, or scene or light
of the reference is a new file: nothing here names one.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    workload: dict      # workloads/<cell>.json
    end_to_end: list    # BENCHMARK.json entries that take this cell
    per_layer: list


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def _takes(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, manifest: dict | None = None
              ) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files; a
    KeyError names what is missing, a ValueError what disagrees."""
    m = load_manifest(root) if manifest is None else manifest
    entry = {w["name"]: w for w in m["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(w['name'] for w in m['workloads'])}")
    conf = {c["name"]: c for c in m["configs"]}.get(entry["config"])
    if conf is None:
        raise KeyError(f"workload {name!r} names config "
                       f"{entry['config']!r}, which BENCHMARK.json lacks")
    config = _read(os.path.join(root, conf["file"]))
    here = os.path.join(root, os.path.basename(HERE))
    traffic = _read(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    workload = _read(os.path.join(here, "workloads", name + ".json"))
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, workload=workload,
                end_to_end=[x for x in m["end_to_end"] if _takes(x, name)],
                per_layer=[x for x in m["per_layer"] if _takes(x, name)])
