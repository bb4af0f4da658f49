"""The port's entry points (eidola_tpu_torch/entry.py, the counterpart of
the repo's __graft_entry__.py) on the CPU.

- `entry("cpu")`'s step gives the image `render_frame` gives under the
  same config (bitwise: the same function), and is within 2e-3 mean
  abs (tests/test_torch_frame.py's bound on the displayed image; read
  here: 2.8e-8, max 8e-7) of the JAX package's frame at the JAX entry's
  config (cornell 64x64, max_depth 2, traversal_max_steps 512, one
  denoise level each; one JAX frame compile);
- `dryrun_multichip(2, "gloo", "cpu")` runs the JAX dry run's three
  parts on two spawned ranks: the partition-only check at
  padded_height(1080, 2), two sharded steps at 64x64 under the audit's
  16-plane bound, and mini_grove under the queue march, each image
  finite.

JAX is imported only inside the JAX test: the rank processes import
eidola_tpu_torch.entry, never this module.
"""
import numpy as np
import torch

from eidola_tpu_torch.entry import (ENTRY_CFG, PLANES, dryrun_multichip,
                                    entry)
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render.frame import init_frame_state, render_frame

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_entry_step_is_render_frame():
    fn, args = entry("cpu")
    state, image = fn(*args)
    assert image.shape == (64, 64, 3) and int(state.frame_idx) == 1
    cfg = RenderConfig(**ENTRY_CFG)
    scene, cam = load_scene("cornell", device=CPU)
    _, out = render_frame(cfg, scene, cam, default_params(device=CPU),
                          default_tonemap(device=CPU),
                          init_frame_state(cfg, cam))
    assert torch.equal(image, out["image"])
    assert bool(torch.isfinite(image).all())


def test_entry_step_matches_jax(monkeypatch):
    import jax

    from eidola_tpu.models.scenes import cornell_box
    from eidola_tpu.render import config as jcfg
    from eidola_tpu.render.frame import init_frame_state as j_init
    from eidola_tpu.render.frame import make_step as j_make_step
    from test_torch_foundations import same_host_builders

    same_host_builders(monkeypatch)
    cfg = jcfg.RenderConfig(**ENTRY_CFG)
    scene, cam = cornell_box()
    _, out = j_make_step(cfg)(scene, cam, jcfg.default_params(),
                              jcfg.default_tonemap(), j_init(cfg, cam))
    want = np.asarray(jax.block_until_ready(out["image"]))
    fn, args = entry("cpu")
    got = fn(*args)[1].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).mean() < 2e-3


def test_dryrun_multichip_two_ranks_gloo():
    out = dryrun_multichip(2, "gloo", "cpu", threads=1)
    assert out["world"] == 2 and out["prod_height"] == 1080
    plane = 64 * 64 * 4
    for part in ("steps", "grove"):
        assert 0 < out[part]["largest"] < PLANES * plane
        assert 0.0 < out[part]["image_mean"] < 1.0
        assert len(out[part]["ms"]) == 2
    assert [len(ms) for ms in out["steps"]["ms"]] == [2, 2]
