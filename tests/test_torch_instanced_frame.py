"""The port's default frame on an instanced, split scene under both
traversals, against each other and against the JAX package's frame.

`mini_grove` (instanced trees whose alpha-MASK leaf cards split into a
flat alpha BVH; the smallest scene with an instanced BVH, the split and
the HitTest at once) at 64x64, max_depth=2, traversal_max_steps=1024, 4
frames, every other RenderConfig field at its default with the HitTest
on: the config of tests/test_torch_golden.py, which has no stored golden
for this scene.

- Under `TRAV="pallas"` every traversal of both halves (the instanced
  opaque BVH and the flat alpha BVH) goes through the walk kernel's
  wrapper, here its plain version `walk_ref`, and none through the
  instanced torch walk.
- The linear HDR output under `pallas` is within 0.02 mean abs of the
  same frames under `xla`, and both within 0.02 of the JAX package's
  `render_frame` on the same scene (the bound the goldens are held to).
  The traversals differ only at exact-t ties and the drains' edge
  verdicts; JAX's frame draws other BLEND rng words nowhere (MASK only).
"""
import numpy as np
import pytest
import torch

from eidola_tpu.models.scenes import load_scene as j_load_scene
from eidola_tpu.render import config as jcfg
from eidola_tpu.render.frame import init_frame_state as j_init
from eidola_tpu.render.frame import make_step as j_make_step
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import bvh_walk as W
from eidola_tpu_torch.ops import packets as P
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render.frame import init_frame_state, make_step
from test_torch_foundations import host_builders_like_jax

torch.set_num_threads(2)

CFG = dict(width=64, height=64, max_depth=2, traversal_max_steps=1024,
           env_mode="sunsky", alpha_geometry=True)
FRAMES = 4


def _render_port():
    dev = torch.device("cpu")
    with host_builders_like_jax():
        scene, cam = load_scene("mini_grove", device=dev)
    cfg = RenderConfig(**CFG)
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    state = init_frame_state(cfg, cam)
    step = make_step(cfg)
    for _ in range(FRAMES):
        state, out = step(scene, cam, params, tm, state)
    return out["hdr"].numpy()


@pytest.fixture(scope="module")
def jax_frame():
    scene, cam = j_load_scene("mini_grove")
    cfg = jcfg.RenderConfig(**CFG)
    params, tm = jcfg.default_params(), jcfg.default_tonemap()
    state = j_init(cfg, cam)
    step = j_make_step(cfg)
    for _ in range(FRAMES):
        state, out = step(scene, cam, params, tm, state)
    return np.asarray(out["hdr"])


@pytest.fixture(scope="module")
def port_frames():
    """{trav: (hdr, walk_ref calls by (instanced, any_hit), instanced
    torch walks)} for both traversals."""
    out = {}
    real_ref, real_trav = W.walk_ref, TB._traverse
    for trav in ("xla", "pallas"):
        walks, torch_inst = {}, []

        def ref(*a, inst=None, **k):
            key = (inst is not None, bool(a[3]))
            walks[key] = walks.get(key, 0) + 1
            return real_ref(*a, inst=inst, **k)

        def trav_fn(*a, inst=None, **k):
            if inst is not None:
                torch_inst.append(1)
            return real_trav(*a, inst=inst, **k)

        W.walk_ref, TB._traverse, P.TRAV = ref, trav_fn, trav
        try:
            img = _render_port()
        finally:
            W.walk_ref, TB._traverse, P.TRAV = real_ref, real_trav, "xla"
        out[trav] = (img, walks, len(torch_inst))
    return out


def test_pallas_frame_goes_through_walk_ref_on_both_halves(port_frames):
    _, walks, torch_inst = port_frames["pallas"]
    assert torch_inst == 0, "an instanced traversal took the torch walk"
    # instanced opaque half: closest and any hit; flat alpha half: the
    # HitTest's closest hits
    assert walks.get((True, False), 0) > 0
    assert walks.get((True, True), 0) > 0
    assert walks.get((False, False), 0) > 0
    _, walks_x, torch_inst_x = port_frames["xla"]
    assert not walks_x and torch_inst_x > 0


@pytest.mark.parametrize("trav", ["xla", "pallas"])
def test_frame_matches_jax(port_frames, jax_frame, trav):
    img = port_frames[trav][0]
    assert img.shape == jax_frame.shape and np.isfinite(img).all()
    assert img.mean() > 0.02
    err = np.abs(img - jax_frame).mean()
    assert err < 0.02, f"mini_grove ({trav}) vs JAX: {err:.4f}"


def test_pallas_frame_matches_xla_frame(port_frames):
    a, b = port_frames["pallas"][0], port_frames["xla"][0]
    err = np.abs(a - b).mean()
    assert err < 0.02, f"mini_grove pallas vs xla: {err:.4f}"


# ---- C1: the GI frame on a camera that orbits every frame ------------------

ORBIT = 0.03


def _orbit(manip_cls, scene, cam, step, params, tm, state, conv, **kw):
    """FRAMES frames on the headless app's set-up: the scene camera first,
    then a manipulator orbit before each later frame.  Returns per frame
    (hdr, motion, accum_count)."""
    view_inv = np.asarray(conv(cam.view_inv))
    pos = np.asarray(conv(cam.pos))
    m = manip_cls(pos, pos - view_inv[:3, 2] * 3.0, aspect=1.0, **kw)
    m._cam = cam
    out = []
    for i in range(FRAMES):
        c = m.orbit(ORBIT, 0.0) if i else cam
        state, o = step(scene, c, params, tm, state)
        out.append((conv(o["hdr"]), conv(o["motion"]),
                    float(conv(state.accum_count))))
    return out


@pytest.fixture(scope="module")
def orbit_frames():
    """{"jax": frames, "xla": frames, "pallas": frames}."""
    from eidola_tpu.scene.camera import CameraManipulator as JManip
    from eidola_tpu_torch.scene.camera import CameraManipulator

    scene, cam = j_load_scene("mini_grove")
    cfg = jcfg.RenderConfig(**CFG)
    out = {"jax": _orbit(JManip, scene, cam, j_make_step(cfg),
                         jcfg.default_params(), jcfg.default_tonemap(),
                         j_init(cfg, cam), np.asarray)}
    dev = torch.device("cpu")
    with host_builders_like_jax():
        tscene, tcam = load_scene("mini_grove", device=dev)
    tcfg = RenderConfig(**CFG)
    for trav in ("xla", "pallas"):
        P.TRAV = trav
        try:
            out[trav] = _orbit(CameraManipulator, tscene, tcam,
                               make_step(tcfg), default_params(device=dev),
                               default_tonemap(device=dev),
                               init_frame_state(tcfg, tcam),
                               lambda a: a.numpy(), device=dev)
        finally:
            P.TRAV = "xla"
    return out


@pytest.mark.parametrize("trav", ["xla", "pallas"])
def test_orbit_frame_matches_jax(orbit_frames, trav):
    """Motion words on >= 99.9% of pixels every frame, the accumulation
    restarting on every frame, and each frame's HDR within the goldens'
    0.02 mean abs of JAX's."""
    for f, ((jh, jm, jc), (ph, pm, pc)) in enumerate(
            zip(orbit_frames["jax"], orbit_frames[trav])):
        assert (jm.astype(np.int64) == pm).mean() >= 0.999, f
        assert pc == jc == 1.0, f
        assert np.isfinite(ph).all() and ph.mean() > 0.02
        err = np.abs(ph - jh).mean()
        assert err < 0.02, f"mini_grove orbit ({trav}) frame {f}: {err:.4f}"
    own = np.stack(np.meshgrid(np.arange(64), np.arange(64), indexing="ij"),
                   -1)
    pm = orbit_frames[trav][-1][1]
    ok = pm[..., 0] >= 0
    assert (pm[ok] != own[ok]).any(-1).mean() > 0.1
