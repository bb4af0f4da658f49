"""No module that a run loads is JAX's or the JAX package's (top-level
names compared whole: eidola_tpu_torch is the program); the reference
reaches nothing of the program and reads no environment variable."""
import ast
import json
import os
import subprocess
import sys

from .conftest import REPO, run_copy

FORBIDDEN = {"jax", "jaxlib", "flax", "eidola_tpu"}
REF = os.path.join(REPO, "benchmark", "reference")


def test_a_run_loads_no_jax(bench_copy):
    mods = set(run_copy(bench_copy, "standin_orbit_tiny")["modules"])
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "eidola_tpu_torch" in mods     # the program, by its whole name


def _ref_sources():
    for d, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_reference_imports_are_relative_or_libraries():
    allowed = {"torch", "numpy", "__future__", "typing", "math"}
    for path in _ref_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path, n)


def test_reference_reads_no_environment():
    # one fixed meaning: no switch of the program's, or any other, moves it
    for path in _ref_sources():
        with open(path) as f:
            text = f.read()
        assert "environ" not in text and "getenv" not in text, path


def test_reference_reaches_nothing_of_the_program():
    code = (
        "import json, os, sys, importlib\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "mods = []\n"
        f"for d, _, fs in os.walk({REF!r}):\n"
        "    for f in fs:\n"
        "        if f.endswith('.py'):\n"
        f"            rel = os.path.relpath(os.path.join(d, f), {REPO!r})\n"
        "            m = rel[:-3].replace(os.sep, '.')\n"
        "            m = m[:-len('.__init__')] if m.endswith('__init__') "
        "else m\n"
        "            importlib.import_module(m)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    mods = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert "eidola_tpu_torch" not in mods
    assert not mods & FORBIDDEN
