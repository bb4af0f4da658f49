"""The port's scene pipeline against the JAX package's, and the port's
independence from JAX.

- The port's own `cornell_box()` and `stress_grid(n=2)` (built on the
  CPU: 8-triangle leaves) produce the same arrays as the JAX package's,
  bit for bit, field by field: attributes, materials, lights and their
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
from eidola_tpu_torch import interop
from eidola_tpu_torch.models import scenes as TS

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compare(port, ref, path=""):
    if ref is None:
        assert port is None, path
        return
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        for name in ref._fields:
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


@pytest.mark.parametrize("name,kwargs", [("cornell_box", {}),
                                         ("stress_grid", {"n": 2})])
def test_scene_arrays_equal_jax(name, kwargs):
    js, jcam = getattr(JS, name)(**kwargs)
    ts, tcam = getattr(TS, name)(device="cpu", **kwargs)
    assert ts.bvh.leaf_size == js.bvh.leaf_size == 8
    cm, anchor = JF.build_leaf_tables_np(np.asarray(js.bvh.leaf_blocks), 8)
    jbvh = js.bvh._replace(leaf_cmat=cm, leaf_anchor=anchor)
    _compare(interop.to_numpy(ts), js._replace(bvh=jbvh))
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
    from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, render_frame

    scene, cam = TS.load_scene("cornell", device="cpu")
    for opt in (dict(primary_seed=True), dict(shadow_cadence=2),
                dict(spatial_rounds=1), dict(alpha_geometry=True)):
        cfg = RenderConfig(width=16, height=16, **opt)
        with pytest.raises(NotImplementedError):
            render_frame(cfg, scene, cam, default_params(device="cpu"),
                         default_tonemap(device="cpu"),
                         init_frame_state(cfg, cam))
    with pytest.raises(KeyError):
        TS.load_scene("bistro_standin", device="cpu")
