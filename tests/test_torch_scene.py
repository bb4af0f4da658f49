"""The port's scene pipeline against the JAX package's, and the port's
independence from JAX.

- The port's own `cornell_box()`, `boxes_sunsky()`, `stress_grid(n=2)`,
  `bistro_standin(target_mtris=0.02)` (instanced, textured, alpha-MASK
  foliage split off into a flat BVH) and `bistro_hdr(0.02)` (the same
  under an HDR environment; built on the CPU: 8-triangle leaves)
  produce the same arrays as the JAX package's, bit for bit, field by
  field: attributes, materials, lights and their
  alias tables, textures, sun & sky parameters and the whole BVH (the
  JAX CPU build carries no coefficient table; the port's is held against
  the JAX `build_leaf_tables_np` of the same leaves).  The one exception
  is the sky's ground irradiance, a quadrature of transcendentals that
  XLA and torch round differently: within 1e-5 relative.
- In a subprocess where `import jax` fails, every module of the port
  imports and a 16x16 cornell frame renders on the CPU.
"""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import eidola_tpu.models.scenes as JS
import eidola_tpu.ops.bvh_fused as JF
import eidola_tpu_torch
from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch import interop
from eidola_tpu_torch.models import scenes as TS
from test_torch_foundations import jax_native_off, same_host_builders

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compare(port, ref, path=""):
    if ref is None:
        assert port is None, path
        return
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        for name in ref._fields:
            if name == "cull_boxes":   # JAX's pre-cull table, not ported
                continue
            _compare(getattr(port, name), getattr(ref, name),
                     f"{path}.{name}")
        return
    a, b = np.asarray(port), np.asarray(ref)
    assert a.shape == b.shape, path
    if path.endswith("ground_irradiance"):
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=path)
    elif b.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.astype(np.float32).view(np.int32),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=path)


def _with_table(jbvh):
    """A JAX CPU-built BVH with the coefficient table the port carries."""
    if jbvh is None:
        return None
    cm, anchor = JF.build_leaf_tables_np(np.asarray(jbvh.leaf_blocks), 8)
    return jbvh._replace(leaf_cmat=cm, leaf_anchor=anchor)


@pytest.mark.parametrize("name,kwargs", [
    ("cornell_box", {}), ("boxes_sunsky", {}), ("stress_grid", {"n": 2}),
    ("bistro_standin", {"target_mtris": 0.02}),
    ("bistro_hdr", {"target_mtris": 0.02})])
def test_scene_arrays_equal_jax(name, kwargs, monkeypatch):
    same_host_builders(monkeypatch)
    _check_scene(name, kwargs)


@pytest.mark.parametrize("name,kwargs", [
    ("cornell_box", {}), ("bistro_standin", {"target_mtris": 0.02})])
def test_scene_arrays_equal_jax_native_off(name, kwargs, monkeypatch):
    """The JAX side on its numpy builders (its library forced off): the
    port follows it onto its own numpy builders and stays bitwise."""
    jax_native_off(monkeypatch)
    same_host_builders(monkeypatch)
    _check_scene(name, kwargs)


def _check_scene(name, kwargs):
    js, jcam = getattr(JS, name)(**kwargs)
    ts, tcam = getattr(TS, name)(device="cpu", **kwargs)
    assert ts.bvh.leaf_size == js.bvh.leaf_size == 8
    if name == "bistro_standin":
        # instanced, textured (base colour + normal maps), MASK foliage
        assert ts.inst is not None and isinstance(ts.bvh_alpha, TB.BVH)
        assert int(ts.bvh.n_tris) >= 20_000
        assert int((ts.materials.normal_tex >= 0).sum()) > 0
        assert ts.textures.data.shape[0] > 1
    _compare(interop.to_numpy(ts), js._replace(
        bvh=_with_table(js.bvh), bvh_alpha=_with_table(js.bvh_alpha)))
    _compare(interop.to_numpy(tcam), jcam)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        eidola_tpu_torch.__path__, "eidola_tpu_torch."))


def test_port_runs_without_jax():
    script = f"""
import importlib, sys
sys.modules["jax"] = None          # any `import jax` now raises
import torch
torch.set_num_threads(2)
for name in {_port_modules()!r}:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
from eidola_tpu_torch.app import headless
out = headless.run(["--scene", "cornell", "--size", "16", "16", "--frames",
                    "1", "--no-denoise", "--no-indirect", "--device", "cpu",
                    "--quiet"])
img = out["image"]
assert img.shape == (16, 16, 3) and 0.0 < img.mean() < 1.0
print("ok", img.mean())
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_unported_options_raise():
    """The port lacks no registry scene now: it has every name of the JAX
    registry (`boxes` came last, held bitwise above), and only a name
    neither has raises.  Every RenderConfig option renders since the
    interactive slice (tests/test_torch_interactive.py)."""
    assert sorted(TS._REGISTRY) == sorted(JS._REGISTRY)
    with pytest.raises(KeyError, match="unknown scene"):
        TS.load_scene("no_such_scene", device="cpu")


def test_profile_reports_steady_busy_share(tmp_path):
    """--profile-trace traces one extra frame and holds its kernel time
    against both the traced frame's wall time and the steady frames'
    mean (the tracer slows the host side of the frame it traces)."""
    from eidola_tpu_torch.app import headless

    out = headless.run(["--scene", "cornell", "--size", "16", "16",
                        "--frames", "2", "--no-denoise", "--no-indirect",
                        "--device", "cpu", "--quiet", "--profile-trace",
                        str(tmp_path)])
    prof = out["profile"]
    assert (tmp_path / "trace.json").is_file()
    assert prof["wall_ms"] > 0.0
    assert prof["busy_share"] == prof["kernel_ms"] / prof["wall_ms"]
    assert prof["steady_busy_share"] == (prof["kernel_ms"]
                                         / out["ms_per_frame"])
