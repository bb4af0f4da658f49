"""The port's default frame against the JAX package's stored goldens.

Cornell, punctual, textured and hdr at 64x64, max_depth=2,
traversal_max_steps=1024, 4 frames, every other RenderConfig field at its
default (ReSTIR DI + GI, a-trous denoise): the config of
tests/test_golden.py, whose CPU renders are `tests/golden/*_64_d2_f4.npy`.
The port renders on the CPU through both traversals (the default torch
walk, and the one-kernel walk's plain version under EIDOLA_TRAV=pallas);
each linear HDR output must be within 0.02 mean absolute error of the
golden, the bound tests/test_golden.py holds the JAX package to.  These
tests read the stored arrays and compile no JAX.
"""
import os

import numpy as np
import pytest
import torch

from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.ops import packets as P
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render.frame import init_frame_state, make_step

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = {"cornell": "sunsky", "hdr": "hdr", "punctual": "sunsky",
         "textured": "sunsky"}


def render_golden_case(scene_key: str, device) -> np.ndarray:
    cfg = RenderConfig(width=64, height=64, max_depth=2,
                       traversal_max_steps=1024, env_mode=CASES[scene_key])
    scene, cam = load_scene(scene_key, device=device)
    params, tm = default_params(device=device), default_tonemap(device=device)
    state = init_frame_state(cfg, cam)
    step = make_step(cfg)
    for _ in range(4):
        state, out = step(scene, cam, params, tm, state)
    return out["hdr"].cpu().numpy()


@pytest.mark.parametrize("trav", ["xla", "pallas"])
@pytest.mark.parametrize("scene_key", sorted(CASES))
def test_golden(scene_key, trav, monkeypatch):
    monkeypatch.setattr(P, "TRAV", trav)
    img = render_golden_case(scene_key, torch.device("cpu"))
    ref = np.load(os.path.join(GOLDEN, f"{scene_key}_64_d2_f4.npy"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    err = np.abs(img - ref).mean()
    assert err < 0.02, f"golden drift ({scene_key}, {trav}): {err:.4f}"


def test_cornell_structure():
    """Colour bleeding: red left wall, green right wall."""
    img = render_golden_case("cornell", torch.device("cpu"))
    left = img[28:36, 2:8]
    right = img[28:36, 56:62]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()
