"""The port's frame held against the JAX package's stored reference frames
(tests/golden_torch/, written by tests/golden_torch/regen.py), and the
check that the bench and chip_smoke.py make with them
(eidola_tpu_torch/utils/reference.py).

- At 272x136, depth 4, traversal_max_steps 1024, frame 3: the frame
  tiles (136 % 8 == 0, 272 % 16 == 0) and its half-resolution GI field
  (136x68) does not (68 % 8 == 4, so `to_tiles` takes its row-major
  branch and 8.5 multibounce tiles leave a partial edge tile), the
  shape pattern of 1920x1080 (540 % 8 == 4); mini_grove (instancing,
  the alpha HitTest, textures: the standin's small counterpart) and
  cornell (opaque, flat: bistro_flat's) render under both CPU
  traversals (the torch walk, and the walk kernel's plain version under
  EIDOLA_TRAV=pallas) within 0.02 mean abs of JAX's frame, the bound of
  tests/test_golden.py.  mini_grove also renders under
  EIDOLA_ALPHA_MARCH=queue, the card's default march (staged capacities
  [32768, 8192] at this size), against JAX's frame under the same
  march: the CPU's lockstep hops draw another rng stream, so the two
  JAX frames differ from each other by more than the port differs from
  either.
- The comparison fails a copy shifted in value, shifted by a block and
  corrupted in one block, and names the corrupted block.
- Each full-size reference records bench.py's config for its scene
  (`bench.frame_cfg`) and the bench's last warm-up frame, so the two
  cannot drift apart.
- The bench holds its last warm-up frame against the reference before
  its window; a miss exits 1 with "value": -1 and nothing timed, and a
  size with no reference gives null fields.
- The headless app's frames 0-1 (no --orbit) are the bench's frames 0-1
  bit for bit, so chip_smoke.py's headless phases may be held against
  the bench's references.

The reference files were rendered by the JAX package's native (C++) host
builders; the port builds with the builder the file records.  No JAX is
imported or compiled here.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import eidola_tpu_torch.native as t_native
from eidola_tpu_torch import bench
from eidola_tpu_torch.app import headless
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.ops import packets as P
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render import tracer as TT
from eidola_tpu_torch.render.frame import init_frame_state, make_step
from eidola_tpu_torch.utils import reference as R

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL_W, SMALL_H, SMALL_FRAME = 272, 136, 3
FULL = ("bistro_standin", "bistro_flat")


def builders_like(monkeypatch, meta) -> None:
    """The port builds with the host builder the reference's JAX side
    took (C++ when the file says so, else numpy)."""
    if not meta["jax_native_builders"]:
        monkeypatch.setattr(t_native, "_lib", None)
        monkeypatch.setattr(t_native, "_tried", True)


def small_cfg(scene) -> RenderConfig:
    return RenderConfig(width=SMALL_W, height=SMALL_H, max_depth=4,
                        traversal_max_steps=1024,
                        env_mode="hdr" if scene.env is not None else "sunsky",
                        alpha_geometry=headless.alpha_geometry(scene))


def small_ref(name, march="auto"):
    path = os.path.join(R.REF_DIR, R.file_name(name, SMALL_W, SMALL_H, 4,
                                               SMALL_FRAME, march))
    return path, R.load(path)


@pytest.mark.parametrize("trav", ["xla", "pallas"])
@pytest.mark.parametrize("name,march", [("cornell", "auto"),
                                        ("mini_grove", "auto"),
                                        ("mini_grove", "queue")])
def test_small_frame_matches_jax(name, march, trav, monkeypatch):
    path, ref = small_ref(name, march)
    assert ref["meta"].get("alpha_march", "auto") == march
    builders_like(monkeypatch, ref["meta"])
    monkeypatch.setattr(P, "TRAV", trav)
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", march)
    scene, cam = load_scene(name, device=CPU)
    cfg = small_cfg(scene)
    if march == "auto":
        assert R.find(name, cfg, SMALL_FRAME) == path
    else:
        assert TT._march_caps(SMALL_W * SMALL_H) == [32768, 8192]
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    for _ in range(SMALL_FRAME + 1):
        state, out = step(scene, cam, params, tm, state)
    got = R.compare(out["hdr"], ref)
    err = float(np.abs(out["hdr"].numpy() - ref["lattice"]).mean())
    assert got["mean_abs"] == pytest.approx(err, rel=1e-6, abs=1e-12)
    assert got["ok"], R.line(f"{name} {march} {trav}", got)


def test_jax_march_modes_differ():
    """JAX's mini_grove frame under the queue march and under the CPU's
    lockstep march differ (another rng stream after the alpha test) by
    more than the port's frames differ from JAX's under one march
    (1e-5 to 1.5e-5 mean abs), yet within the bound."""
    _, lock = small_ref("mini_grove")
    _, queue = small_ref("mini_grove", "queue")
    got = R.compare(torch.from_numpy(queue["lattice"]), lock)
    assert 1e-3 < got["mean_abs"] < R.BOUND and got["ok"]


def _corrupt_block(img, by, bx, value=1e3):
    img = img.copy()
    img[by * R.BLOCK:(by + 1) * R.BLOCK, bx * R.BLOCK:(bx + 1) * R.BLOCK] \
        += value
    return img


@pytest.mark.parametrize("change", ["none", "offset", "roll", "block"])
def test_compare_fails_changed_copies(change):
    """The stored cornell frame against itself passes with zeros; shifted
    by 0.05 in value, rolled by one block, or one block corrupted, it
    fails, and the corruption's block is where the max falls."""
    _, ref = small_ref("cornell")
    img = ref["lattice"]
    frame = {"none": img, "offset": img + 0.05,
             "roll": np.roll(img, R.BLOCK, axis=1),
             "block": _corrupt_block(img, 11, 5)}[change]
    got = R.compare(torch.from_numpy(frame), ref)
    if change == "none":
        assert got["ok"] and got["mean_abs"] == got["block_max"] == 0.0
        return
    assert not got["ok"], got
    if change == "block":
        assert got["block_max_at"] == [11, 5]
        assert got["block_max"] == pytest.approx(1e3, rel=1e-4)


def test_compare_lattice_at_stride_4():
    """A full-size file's form (a float16 stride-4 lattice and 8x8 block
    means, regen.py's) at a small size: the frame it came from passes,
    one corrupted block fails and is named."""
    rng = np.random.default_rng(7)
    hdr = rng.exponential(0.5, (136, 272, 3)).astype(np.float32)
    ref = {"lattice": hdr[::4, ::4].astype(np.float16).astype(np.float32),
           "stride": 4, "blocks": R.block_means(hdr)}
    got = R.compare(torch.from_numpy(hdr), ref)
    assert got["ok"] and got["block_max"] < 1e-6
    assert 0 < got["mean_abs"] < 1e-3       # float16 rounding alone
    bad = R.compare(torch.from_numpy(_corrupt_block(hdr, 16, 33)), ref)
    assert not bad["ok"] and bad["block_max_at"] == [16, 33]
    with pytest.raises(ValueError, match="does not match"):
        R.compare(torch.from_numpy(hdr[:128]), ref)


@pytest.mark.parametrize("name", FULL)
def test_full_reference_is_the_bench_frame(name):
    """The stored full-size frame is bench.frame_cfg's config for the
    scene at the bench's size, and the bench's last warm-up frame; its
    arrays have the lattice's and the blocks' shapes and are finite."""
    scene, _ = load_scene(name, device=CPU, target_mtris=0.002)
    cfg_ref = bench.frame_cfg(scene, bench.W, bench.H)
    path = R.find(name, cfg_ref, bench.WARMUP - 1)
    assert path is not None and os.path.basename(path) == (
        f"{name}_1920x1080_d4_f1.npz")
    ref = R.load(path)
    meta = ref["meta"]
    assert {k: meta[k] for k in R.CONFIG_FIELDS} == {
        k: getattr(cfg_ref, k) for k in R.CONFIG_FIELDS}
    assert meta["frame"] == bench.WARMUP - 1 and meta["scene"] == name
    assert meta["jax_version"] and meta["command"].endswith(name)
    assert ref["stride"] == 4 and ref["lattice"].shape == (270, 480, 3)
    assert ref["blocks"].shape == (135, 240, 3)
    assert np.isfinite(ref["lattice"]).all()
    assert np.isfinite(ref["blocks"]).all()
    assert ref["blocks"].mean() > 0.01


# ------------------------------------------------------------- the bench

SMALL = ["--device", "cpu", "--scene", "cornell", "--size", "32", "32",
         "--warmup", "2", "--iters", "1"]


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def _frame1_reference(tmp_path, monkeypatch, shift: float):
    """The bench's own frame 1 at cornell 32x32, stored in a reference
    directory of its own as regen.py stores a small frame, plus `shift`."""
    scene, cam = load_scene("cornell", device=CPU)
    cfg = bench.frame_cfg(scene, 32, 32)
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    got = []
    bench.time_frames(cfg, scene, cam, params, tm, CPU, 2, 1,
                      lambda out: got.append(out["hdr"].clone()) or True)
    meta = {k: getattr(cfg, k) for k in R.CONFIG_FIELDS}
    meta.update(frame=1, jax_native_builders=True)
    np.savez_compressed(tmp_path / R.file_name("cornell", 32, 32, 4, 1),
                        meta=np.array(json.dumps(meta)),
                        hdr=got[0].numpy() + np.float32(shift))
    monkeypatch.setattr(R, "REF_DIR", str(tmp_path))


def test_bench_reference_miss_exits_1(tmp_path, monkeypatch):
    """A reference shifted by 0.05: the bench prints its line with value
    -1, correct false and an error, exits 1, and times nothing."""
    _frame1_reference(tmp_path, monkeypatch, 0.05)
    calls = []
    real = bench.summarize
    monkeypatch.setattr(bench, "summarize",
                        lambda ms: calls.append(ms) or real(ms))
    rc, out = _run(SMALL)
    assert rc == 1 and out["value"] == -1 and out["correct"] is False
    assert "lattice mean abs" in out["error"] and "not timed" in out["error"]
    assert out["reference_frame"] == 1
    assert out["reference_mean_abs"] == pytest.approx(0.05, rel=1e-4)
    assert out["reference_block_mean_abs"] == pytest.approx(0.05, rel=1e-4)
    assert "frames" not in out and calls == []


def test_bench_reference_held(tmp_path, monkeypatch):
    """The bench's own frame 1 as the reference: readings of 0, correct."""
    _frame1_reference(tmp_path, monkeypatch, 0.0)
    rc, out = _run(SMALL)
    assert rc == 0 and out["correct"] is True and out["value"] > 0
    assert out["reference_frame"] == 1
    assert out["reference_file"].endswith("cornell_32x32_d4_f1.npz")
    assert out["reference_mean_abs"] == out["reference_block_max"] == 0.0
    assert out["reference_block_max_at"] == [0, 0]


def test_bench_without_reference_is_null():
    """No reference at this size: the fields are null, nothing else is
    taken in its place, and `correct` is the golden and the image's."""
    rc, out = _run(SMALL)
    assert rc == 0 and out["correct"] is True
    assert out["reference_frame"] is None and out["reference_file"] is None
    assert out["reference_mean_abs"] is None
    assert out["reference_block_mean_abs"] is None
    assert out["reference_block_max"] is None


@pytest.mark.parametrize("frames", [1, 2])
def test_headless_frames_are_the_bench_frames(frames, monkeypatch):
    """The headless app's frames with no --orbit (the scene's camera,
    then `manip.hold()`, which rolls it forward) are the bench's frames
    (the scene's camera at every step), bit for bit, at cornell 32x32."""
    monkeypatch.setattr(P, "TRAV", "auto")
    scene, cam = load_scene("cornell", device=CPU)
    cfg = bench.frame_cfg(scene, 32, 32)
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    got = []
    bench.time_frames(cfg, scene, cam, params, tm, CPU, frames, 1,
                      lambda out: got.append(out) or True)
    res = headless.run(["--scene", "cornell", "--size", "32", "32",
                        "--frames", str(frames), "--device", "cpu",
                        "--quiet"])
    assert torch.equal(res["hdr"], got[0]["hdr"])
    assert np.array_equal(res["image"], got[0]["image"].numpy())
    held = headless.advance(cam)
    assert all(torch.equal(a, b) for a, b in zip(held, cam))
