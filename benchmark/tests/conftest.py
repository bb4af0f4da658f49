"""Fixtures of the benchmark's own tests (python -m pytest
benchmark/tests; the repo's tests/ never collects them).

`bench_copy` copies BENCHMARK.json and benchmark/ into a temporary
directory and adds cells there as files only: the configuration
`standin_tiny` (bistro_standin at 2 x 2 lots, at 32x32, depth 2) under
the orbit mix (`traffic/orbit.json`: 0.01 rad a frame at the renderer's
default settings, a closed loop) as the cell `standin_orbit_tiny`, with a
per-layer metric of its own (`compose_ms`, read by a new file under
metrics/); and a scene of the reference's own,
`reference/scenes/alpha.py` (the program's `alpha` scene: an alpha-MASK
screen before a box) lit by a light of its own,
`reference/lights/alpha_sky.py` (the default sun and sky), with the
configuration `alpha_tiny` and the cell `alpha_orbit_tiny`.  The stage
metrics take the new cells too.  `run_copy` runs the harness's measure()
of one of the copy's cells in a subprocess whose `benchmark` package is
the copy's.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the tiny cell's limits, set between the program's readings over 12
# seeds on the CPU and the control's over 3 (benchmark/calibrate.py
# --device cpu; PERF.md); light_mismatch: at most 0.00625 under either
# alpha march against 1.0
TINY_LIMITS = {"ray_max_abs": 1e-5, "closest_mismatch": 0.02,
               "occluded_mismatch": 0.02, "denoise_max_abs": 1e-5,
               "image_max_abs": 1e-5, "state_max_rel": 1e-5,
               "light_mismatch": 0.05}
TINY_SCENE = {"target_mtris": 0.004}     # 2 x 2 lots, 15,874 triangles
NEW_CELLS = ("standin_orbit_tiny", "alpha_orbit_tiny")
COMPOSE_MS = '''"""compose and post a frame: StageTimer's compose_post."""


def read(trace):
    ms = trace.stages.get("compose_post")
    return None if ms is None else ms / trace.stage_frames
'''
ALPHA_SCENE = '''"""The `alpha` scene: an alpha-MASK cut-out screen before a
box on a floor, written from the JAX package's models/scenes.py:
alpha_demo (a 32x32 checker of 4x4-texel squares, alpha 0 or 1, cutoff
0.5)."""
import numpy as np
import torch

from ..scene import Standin

CORNERS = [(-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
           (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1)]
FACES = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
         (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]


def quad(p0, p1, p2, p3):
    return np.asarray([[p0, p1, p2], [p0, p2, p3]], np.float32)


def make(*, device):
    corners = (np.asarray(CORNERS, np.float32) * np.float32(0.6)
               + np.asarray([0, 0.6, -0.6], np.float32))
    box = corners[np.asarray(FACES)]
    floor = quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6])
    screen = quad([-1.5, 0, 1.2], [1.5, 0, 1.2], [1.5, 2.4, 1.2],
                  [-1.5, 2.4, 1.2])
    yy, xx = np.mgrid[0:32, 0:32]
    f64 = dict(dtype=torch.float64, device=device)
    return Standin(
        opaque=torch.as_tensor(np.concatenate([box, floor]), **f64),
        alpha=torch.as_tensor(screen, **f64),
        alpha_uv=torch.as_tensor((screen[..., :2] + 1.5) / 3.0, **f64),
        leaf_alpha=torch.as_tensor((yy // 4 + xx // 4) % 2, **f64),
        cutoff=0.5, view=([0.0, 1.4, 4.6], [0.0, 0.9, 0.0], 45.0),
        light=("alpha_sky", {}), emitters=0)
'''
ALPHA_LIGHT = '''"""The `alpha` scene's light: the renderer's default sun and
sky, written from the JAX package's scene/data.py:default_sunsky
(lights/sunsky.py at the numbers scenes/bistro_standin.py freezes)."""
from ..scenes.bistro_standin import SUNSKY
from . import sunsky


def make(*, device, num):
    return sunsky.make(device=device, num=num, **SUNSKY)
'''


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench_copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    b = root / "benchmark"
    with open(b / "configs" / "bistro_standin.json") as f:
        conf = json.load(f)
    conf.update(name="standin_tiny", scene_args=TINY_SCENE, width=32,
                height=32)
    conf["render"] = dict(conf["render"], max_depth=2)
    _dump(b / "configs" / "standin_tiny.json", conf)
    _dump(b / "configs" / "alpha_tiny.json",
          dict(conf, name="alpha_tiny", scene="alpha", scene_args={}))
    for cell, config in zip(NEW_CELLS, ("standin_tiny", "alpha_tiny")):
        _dump(b / "workloads" / f"{cell}.json",
              {"config": config, "traffic": "orbit", "chips": 1,
               "check": {"rays_per_call": 64}, "limits": TINY_LIMITS})
    (b / "metrics" / "compose_ms.py").write_text(COMPOSE_MS)
    (b / "reference" / "scenes" / "alpha.py").write_text(ALPHA_SCENE)
    (b / "reference" / "lights" / "alpha_sky.py").write_text(ALPHA_LIGHT)
    with open(root / "BENCHMARK.json") as f:
        m = json.load(f)
    for cell, config in zip(NEW_CELLS, ("standin_tiny", "alpha_tiny")):
        m["configs"].append({"name": config, "source": "test",
                             "file": f"benchmark/configs/{config}.json",
                             "reduced": [], "why": "a cell added as files"})
        m["workloads"].append({"name": cell, "config": config,
                               "traffic": "orbit", "chips": 1,
                               "why": "a cell added as files"})
    for x in m["per_layer"]:       # the new cells also take the stages
        if x["source"] == "program_span":
            x["workloads"].extend(NEW_CELLS)
    m["per_layer"].append({"name": "compose_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "compose and post: render/compose.py, "
                                    "render/post.py",
                           "moves": "frame_ms",
                           "workloads": ["standin_orbit_tiny"]})
    _dump(root / "BENCHMARK.json", m)
    return root


RUNNER = """
import json, sys
sys.path[:0] = [{root!r}, {repo!r}]
import torch
torch.set_num_threads(2)
{prelude}
from benchmark import manifest, run
from benchmark.run import measure
run.STAGE_S = run.TRACE_S = {seconds}
cell = manifest.load_cell({cell!r})
out = measure(cell, {seed}, {seconds}, {trace}, torch.device("cpu"))
out.pop("breakdown", None)
print(json.dumps({{"result": out, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def run_copy(root, cell, seed=2**31 + 7, seconds=0.5, trace=False,
             prelude=""):
    """measure() of `cell` of the copy at `root` in a subprocess, after
    the code `prelude` (which may break the program underneath)."""
    code = RUNNER.format(root=str(root), repo=REPO, cell=cell, seed=seed,
                         seconds=seconds, trace=trace, prelude=prelude)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(root))
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
