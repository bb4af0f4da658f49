"""The port's direct-lighting frame against the JAX package's render_frame.

Cornell at 32x32 on the config of tests/test_pipeline.py's camera test
(max_depth=1, denoise and GI off, traversal_max_steps=1024), so the JAX
step comes from the suite's compile cache.  The JAX scene, camera and
parameters go to the port through `eidola_tpu_torch.interop`, and both
render three frames with the same time words.

Tolerances: the port's drains use the coefficient-table formulation
while the JAX CPU oracle intersects with the unrolled `cols` Moller-
Trumbore, so hit distances differ in the last bits and a few RIS or
temporal choices may flip at exact comparisons.  Integer words must
agree on >= 99.9% of pixels and the displayed image within a mean
absolute difference of 2e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eidola_tpu.models.scenes import cornell_box
from eidola_tpu.render import config as jcfg
from eidola_tpu.render.frame import init_frame_state as j_init
from eidola_tpu.render.frame import make_step as j_make_step
from eidola_tpu_torch import interop
from eidola_tpu_torch.render.config import RenderConfig
from eidola_tpu_torch.render.frame import init_frame_state, make_step

torch.set_num_threads(2)

W = H = 32
FRAMES = 3
CFG = dict(width=W, height=H, max_depth=1, env_mode="sunsky", denoise=False,
           indirect_enabled=False, traversal_max_steps=1024)


def _frames_jax(scene, cam):
    cfg = jcfg.RenderConfig(**CFG)
    params, tm = jcfg.default_params(), jcfg.default_tonemap()
    state = j_init(cfg, cam)
    step = j_make_step(cfg)
    out, states = [], [state]
    for i in range(FRAMES):
        p = params._replace(time_word=jnp.asarray(100 + i, jnp.uint32))
        state, o = step(scene, cam, p, tm, state)
        states.append(state)
        out.append(_record(state, o, lambda a: np.asarray(a)))
    return out, states


def _frames_port(scene, cam, state=None, first=0):
    """Port frames `first`..FRAMES-1, from `state` (a JAX FrameState
    carried over by interop) or from a fresh state."""
    dev = torch.device("cpu")
    tscene = interop.to_torch(scene, dev)
    tcam = interop.to_torch(cam, dev)
    params = interop.to_torch(jcfg.default_params(), dev)
    tm = interop.to_torch(jcfg.default_tonemap(), dev)
    cfg = RenderConfig(**CFG)
    state = (init_frame_state(cfg, tcam) if state is None
             else interop.to_torch(state, dev))
    step = make_step(cfg)
    out = []
    for i in range(first, FRAMES):
        p = params._replace(time_word=torch.tensor(100 + i))
        state, o = step(tscene, tcam, p, tm, state)
        out.append(_record(state, o, lambda a: a.numpy()))
    return out


def _record(state, o, conv):
    g = state.gbuf
    r = state.di_resv
    rec = {
        "depth": g.depth, "nrm": g.nrm, "mat": g.mat, "albedo": g.albedo,
        "tri": g.tri, "vis": state.di_vis, "num": r["num"],
        "weight": r["weight"], "li": r["sample"]["li"],
        "wi": r["sample"]["wi"], "dist": r["sample"]["dist"],
        "accum_count": state.accum_count,
        "image": o["image"], "hdr": o["hdr"], "direct_ldr": o["direct_ldr"],
        "motion": o["motion"],
    }
    return {k: conv(v) for k, v in rec.items()}


@pytest.fixture(scope="module")
def cornell():
    scene, cam = cornell_box()
    jax_frames, jax_states = _frames_jax(scene, cam)
    return scene, cam, jax_frames, jax_states


@pytest.fixture(scope="module")
def frames(cornell):
    scene, cam, jax_frames, _ = cornell
    return jax_frames, _frames_port(scene, cam)


WORDS = ("tri", "nrm", "mat", "albedo")


@pytest.mark.parametrize("frame", range(FRAMES))
def test_gbuffer_words_match(frames, frame):
    j, p = frames[0][frame], frames[1][frame]
    for k in WORDS:
        same = (j[k].astype(np.int64) == p[k].astype(np.int64)).mean()
        assert same >= 0.999, (k, same)
    hit = j["tri"] >= 0
    np.testing.assert_allclose(p["depth"][hit], j["depth"][hit], rtol=1e-4)
    assert (j["motion"].astype(np.int64) == p["motion"]).mean() >= 0.999


@pytest.mark.parametrize("frame", range(FRAMES))
def test_reservoirs_and_visibility_match(frames, frame):
    j, p = frames[0][frame], frames[1][frame]
    assert (j["vis"] == p["vis"]).mean() >= 0.99
    assert (j["num"] == p["num"]).mean() >= 0.99
    close = np.isclose(p["weight"], j["weight"], rtol=1e-3, atol=1e-6)
    assert close.mean() >= 0.99
    for k in ("li", "wi", "dist"):
        close = np.isclose(p[k], j[k], rtol=1e-3, atol=1e-5)
        assert close.reshape(W * H, -1).all(-1).mean() >= 0.99, k


@pytest.mark.parametrize("frame", range(FRAMES))
def test_image_matches(frames, frame):
    j, p = frames[0][frame], frames[1][frame]
    assert float(p["accum_count"]) == float(j["accum_count"]) == frame + 1
    assert np.isfinite(p["image"]).all()
    assert np.abs(p["image"] - j["image"]).mean() <= 2e-3
    assert np.abs(p["direct_ldr"] - j["direct_ldr"]).mean() <= 2e-3
    assert np.abs(p["hdr"] - j["hdr"]).mean() <= 2e-3 * max(
        1.0, float(np.abs(j["hdr"]).mean()))


def test_frame_state_carried_from_jax(cornell):
    """JAX's FrameState after frame 1, carried over by interop, continues
    in the port: frame 2 matches JAX's frame 2."""
    scene, cam, jax_frames, jax_states = cornell
    p = _frames_port(scene, cam, state=jax_states[2], first=2)[0]
    j = jax_frames[2]
    assert float(p["accum_count"]) == 3.0
    for k in WORDS:
        assert (j[k].astype(np.int64) == p[k].astype(np.int64)).mean() >= 0.999
    assert np.abs(p["image"] - j["image"]).mean() <= 2e-3
