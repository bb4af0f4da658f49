"""The port stands alone: no module of eidola_tpu_torch/ and not
chip_smoke.py imports JAX, the JAX package or the repo's root tools/
scripts, and none needs PIL.

An `ast` scan of every source catches any import statement, at any depth;
a subprocess in which `eidola_tpu` and `jax` cannot be imported then
imports every port module, which catches imports made by other means.
PIL appears only in the glTF loader's decode of a non-PNG image; a
subprocess in which PIL, `jax` and `eidola_tpu` cannot be imported
drives the scene pipeline the card phases drive: a GLB and an .hdr
written by the port, the headless app with -e, --out, --save-state and
--load-state, and the viewer through POST /scene.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "eidola_tpu_torch")
# the JAX package, JAX, and the repo's root tools/ scripts (JAX code)
FORBIDDEN = ("eidola_tpu", "jax", "jaxlib", "tools")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


# the one lazy PIL import: glTF images that are not PNG, as in JAX
PIL_ALLOWED = ("eidola_tpu_torch/scene/gltf.py",)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_pil(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported(tree) if m.split(".")[0] == "PIL"]
    assert not bad or os.path.relpath(path, ROOT) in PIL_ALLOWED, \
        f"{path} imports {bad}"


def test_scene_pipeline_runs_without_pil(tmp_path):
    code = f"""
import json, sys, threading, time, urllib.request
for m in ("eidola_tpu", "jax", "jaxlib", "PIL"):
    sys.modules[m] = None
import numpy as np, torch
torch.set_num_threads(2)
from eidola_tpu_torch.app import headless, viewer
from eidola_tpu_torch.models.scenes import write_standin_glb
from eidola_tpu_torch.scene.hdr import write_hdr
from eidola_tpu_torch.utils.png import decode_png
d = {str(tmp_path)!r}
write_standin_glb(d + "/s.glb", target_mtris=0.001)
write_hdr(d + "/e.hdr", np.full((8, 16, 3), 0.5, np.float32))
args = ["--scene", d + "/s.glb", "-e", d + "/e.hdr", "--size", "16", "16",
        "--device", "cpu", "--quiet", "--max-depth", "1"]
a = headless.run(args + ["--frames", "1", "--out", d + "/o.png",
                         "--save-state", d + "/s.npz"])
b = headless.run(args + ["--frames", "1", "--load-state", d + "/s.npz"])
assert a["env_mode"] == "hdr" and a["alpha_geometry"], a
assert b["frame_idx"] == 2, b["frame_idx"]
assert decode_png(open(d + "/o.png", "rb").read()).shape == (16, 16, 4)
vs, srv, threads = viewer.start(["--scene", "cornell", "--size", "16",
                                 "--max-depth", "1", "--device", "cpu",
                                 "--port", "0"])
threading.Thread(target=srv.serve_forever, daemon=True).start()
try:
    req = urllib.request.Request(
        "http://127.0.0.1:%d/scene" % srv.server_address[1],
        data=json.dumps({{"hdr": d + "/e.hdr"}}).encode(), method="POST")
    assert urllib.request.urlopen(req, timeout=60).status == 200
    t_end = time.monotonic() + 120
    while vs.base_cfg.env_mode != "hdr" or vs.busy or vs.frame < 2:
        assert time.monotonic() < t_end and "failed" not in vs.busy, vs.busy
        time.sleep(0.05)
finally:
    vs.stop = True
    srv.shutdown()
    for t in threads:
        t.join(timeout=60)
assert not any(m == "PIL" or m.startswith("PIL.") for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {FORBIDDEN!r}:\n"
            "    sys.modules[m] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
