"""The reference's scenes are found by file: `reference/scenes/<name>.py`
for a configuration's `scene`.  The stand-in moved there is the
generator it was, bit for bit."""
import hashlib
import importlib

import pytest
import torch

from benchmark import manifest
from benchmark.reference import Reference, scene

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
