"""The reference's scenes are found by file: `reference/scenes/<name>.py`
for a configuration's `scene`, and their lights so too:
`reference/lights/<kind>.py` for the kind a scene names.  The stand-in
moved there is the generator it was, bit for bit."""
import hashlib
import importlib
import json
import subprocess
import sys

import pytest
import torch

from benchmark import manifest
from benchmark.reference import Reference, light, scene
from benchmark.reference.precision import Precision

# each scene of the reference at a size a test holds
TINY = {"bistro_standin": {"target_mtris": 0.004}}

# sha256 of the 2 x 2 lot stand-in's float64 triangles, uvs, leaf alpha,
# cutoff and view, as the generator gave them before it moved into
# reference/scenes/bistro_standin.py
STANDIN_TINY_SHA256 = ("ff526f2abb1c1f632b4189d825053512505945b4056c14cf"
                       "6c86b4b792cd1c3d")


def digest(s) -> str:
    h = hashlib.sha256()
    for t in (s.opaque, s.alpha, s.alpha_uv, s.leaf_alpha):
        h.update(repr((str(t.dtype), tuple(t.shape))).encode())
        h.update(t.contiguous().numpy().tobytes())
    h.update(repr((s.cutoff, s.view)).encode())
    return h.hexdigest()


def test_moved_standin_is_bitwise_the_old_generator():
    s = scene.make("bistro_standin", device=torch.device("cpu"),
                   target_mtris=0.004)
    assert s.opaque.shape == (7682, 3, 3) and s.alpha.shape == (8192, 3, 3)
    assert digest(s) == STANDIN_TINY_SHA256


def test_unknown_scene_names_the_scenes():
    with pytest.raises(KeyError, match="no scene 'no_such_scene'.*"
                                       "bistro_standin"):
        scene.make("no_such_scene", device=torch.device("cpu"))


def test_reference_takes_the_configurations_scene_by_name():
    cell = manifest.load_cell("standin_static_1080p")
    config = dict(cell.config, scene_args={"target_mtris": 0.004},
                  width=32, height=32)
    ref = Reference(config, cell.traffic, 1, torch.device("cpu"))
    assert digest(ref.scene) == STANDIN_TINY_SHA256
    with pytest.raises(KeyError, match="bistro_standin"):
        Reference(dict(config, scene="no_such_scene"), cell.traffic, 1,
                  torch.device("cpu"))


@pytest.mark.parametrize("name", scene.names())
def test_scene_module_says_its_source_and_makes(name):
    mod = importlib.import_module(f"benchmark.reference.scenes.{name}")
    doc = " ".join((mod.__doc__ or "").lower().split())
    assert "written from" in doc
    assert callable(mod.make)


def test_every_configuration_names_a_scene_of_the_reference():
    m = manifest.load_manifest()
    for w in m["workloads"]:
        assert manifest.load_cell(w["name"]).config["scene"] in scene.names()


@pytest.mark.parametrize("name", scene.names())
def test_every_scene_names_a_light_of_the_reference(name):
    s = scene.make(name, device=torch.device("cpu"), **TINY.get(name, {}))
    kind, args = s.light
    assert kind in light.names()
    assert s.emitters == 0
    lit = light.make(kind, device=torch.device("cpu"), num=Precision(),
                     **args)
    d = torch.tensor([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8]], dtype=torch.float64)
    assert lit.radiance(d).shape == (2, 3) and lit.pdf(d).shape == (2,)


@pytest.mark.parametrize("kind", light.names())
def test_light_module_says_its_source_and_makes(kind):
    mod = importlib.import_module(f"benchmark.reference.lights.{kind}")
    doc = " ".join((mod.__doc__ or "").lower().split())
    assert "written from" in doc
    assert callable(mod.make)


def test_unknown_light_names_the_lights():
    with pytest.raises(KeyError, match="no light 'no_such_light'.*sunsky"):
        light.make("no_such_light", device=torch.device("cpu"),
                   num=Precision())


def test_a_scene_with_emitters_is_refused():
    cell = manifest.load_cell("standin_static_1080p")
    config = dict(cell.config, scene_args=TINY["bistro_standin"], width=32,
                  height=32)
    s = scene.make("bistro_standin", device=torch.device("cpu"),
                   **TINY["bistro_standin"])
    with pytest.raises(ValueError, match="3 triangle or punctual emitters"):
        Reference(config, cell.traffic, 1, torch.device("cpu"),
                  scene=s._replace(emitters=3))


def test_a_lights_file_dropped_into_a_copy_is_found(bench_copy):
    """conftest's copy adds reference/lights/alpha_sky.py and a scene that
    names it, and edits no file that was there: the lookup finds it and
    the copy's Reference of `alpha_tiny` is lit by it."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(bench_copy)!r})\n"
        "import torch\n"
        "from benchmark import manifest\n"
        "from benchmark.reference import Reference, light\n"
        "cell = manifest.load_cell('alpha_orbit_tiny')\n"
        "ref = Reference(cell.config, cell.traffic, 1, torch.device('cpu'))\n"
        "up = torch.tensor([[0.0, 1.0, 0.0]])\n"
        "print(json.dumps([light.names(), ref.scene.light[0], "
        "light.__file__, float(ref.light.radiance(up)[0, 2])]))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(bench_copy))
    assert done.returncode == 0, done.stderr[-2000:]
    names, kind, path, blue = json.loads(done.stdout.strip().splitlines()[-1])
    assert names == ["alpha_sky", "sunsky"] and kind == "alpha_sky"
    assert path.startswith(str(bench_copy))
    assert blue > 0.0
