"""The port stands alone: no module of eidola_tpu_torch/ and not
chip_smoke.py imports JAX or the JAX package.

An `ast` scan of every source catches any import statement, at any depth;
a subprocess in which `eidola_tpu` and `jax` cannot be imported then
imports every port module, which catches imports made by other means.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "eidola_tpu_torch")
FORBIDDEN = ("eidola_tpu", "jax", "jaxlib")


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


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            "for m in ('eidola_tpu', 'jax', 'jaxlib'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
