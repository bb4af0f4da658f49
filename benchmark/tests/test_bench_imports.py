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
# the modules that import by name: scene.py finds a scene's module under
# reference/scenes/, light.py a light's under reference/lights/
# (test_bench_scenes.py)
LOOKUP = os.path.join(REF, "scene.py")
LIGHT_LOOKUP = os.path.join(REF, "light.py")
# each scene of the reference at a size a test holds; a scene not named
# here is made at its own defaults
TINY = {"bistro_standin": {"target_mtris": 0.004}}


def test_a_run_loads_no_jax(bench_copy):
    mods = set(run_copy(bench_copy, "standin_orbit_tiny")["modules"])
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "eidola_tpu_torch" in mods     # the program, by its whole name


def _ref_sources():
    for d, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def test_reference_imports_are_relative_or_libraries():
    allowed = {"torch", "numpy", "__future__", "typing", "math"}
    for path in _ref_sources():
        tree = _tree(path)
        ok = allowed | ({"importlib", "pkgutil"}
                        if path in (LOOKUP, LIGHT_LOOKUP) else set())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ok, (path, n)


def _one_import_under(path, package: str, name: str):
    """`path` has one importlib.import_module, of
    f"{<package>.__name__}.{<name>}"."""
    calls = [n for n in ast.walk(_tree(path)) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "importlib.import_module"]
    assert len(calls) == 1
    call = calls[0]
    assert len(call.args) == 1 and not call.keywords
    arg = call.args[0]
    assert isinstance(arg, ast.JoinedStr) and len(arg.values) == 3
    head, dot, tail = arg.values
    assert ast.unparse(head.value) == f"{package}.__name__"
    assert isinstance(dot, ast.Constant) and dot.value == "."
    assert ast.unparse(tail.value) == name


def test_only_the_scene_lookup_imports_by_name_and_under_scenes():
    """No reference module but the two lookups (scene.py, light.py)
    imports a module by a name it computes, and scene.py only
    `scenes.<name>`."""
    for path in _ref_sources():
        for node in ast.walk(_tree(path)):
            name = node.id if isinstance(node, ast.Name) else \
                node.attr if isinstance(node, ast.Attribute) else None
            assert name != "__import__", path
            if name == "import_module":
                assert path in (LOOKUP, LIGHT_LOOKUP), path
    _one_import_under(LOOKUP, "scenes", "name")


def test_the_light_lookup_imports_by_name_only_under_lights():
    _one_import_under(LIGHT_LOOKUP, "lights", "kind")


def test_reference_reads_no_environment():
    # one fixed meaning: no switch of the program's, or any other, moves it
    for path in _ref_sources():
        with open(path) as f:
            text = f.read()
        assert "environ" not in text and "getenv" not in text, path


def test_making_every_scene_reaches_nothing_of_the_program():
    """scene.make of every scene the reference has, and light.make of its
    light, run: a scene or light module that imported the program inside
    a function would show here."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark.reference import light, scene\n"
        "from benchmark.reference.precision import Precision\n"
        "made = []\n"
        "for name in scene.names():\n"
        f"    s = scene.make(name, device=torch.device('cpu'), "
        f"**{TINY!r}.get(name, {{}}))\n"
        "    assert isinstance(s, scene.Standin), name\n"
        "    kind, args = s.light\n"
        "    lit = light.make(kind, device=torch.device('cpu'), "
        "num=Precision(), **args)\n"
        "    lit.radiance(torch.tensor([[0.0, 1.0, 0.0]]))\n"
        "    made.append(name)\n"
        "print(json.dumps([made, sorted({m.split('.')[0] "
        "for m in sys.modules})]))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    made, mods = json.loads(done.stdout.strip().splitlines()[-1])
    assert "bistro_standin" in made
    assert "eidola_tpu_torch" not in mods
    assert not set(mods) & FORBIDDEN


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
