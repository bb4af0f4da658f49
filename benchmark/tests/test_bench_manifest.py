"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
files load by name."""
import json
import os
import re

import pytest

from benchmark import manifest
from benchmark.check import NUMBERS

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    m = _manifest()
    assert set(m) == KEYS
    assert 1 <= len(m["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    for word in m["command"][1:]:
        if os.path.exists(os.path.join(REPO, word)):
            assert any(word.startswith(p + "/") for p in m["paths"]), word
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s at this length
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536


def test_entries():
    m = _manifest()
    names = {}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        assert len(c["reduced"]) <= 16
        names.setdefault("configs", set()).add(c["name"])
    used = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        assert _line(w["why"])
        used.add(w["config"])
    assert used == names["configs"]
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["moves"] in e2e and _line(x["layer"])
        assert set(x.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           x["name"] + ".py"))
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        if x["unit"] == "%" and "roofline" in x["name"]:
            assert x["name"].endswith("_roofline")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  _manifest()["workloads"]])
def test_cell_files_load_by_name(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    assert c.config["reduced"] == []
    assert set(c.workload["limits"]) == set(NUMBERS)
    assert c.workload["check"]["rays_per_call"] >= 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "frame_ms"}
    assert c.per_layer


def test_unknown_cell_is_named():
    with pytest.raises(KeyError, match="no workload"):
        manifest.load_cell("no_such_cell")
