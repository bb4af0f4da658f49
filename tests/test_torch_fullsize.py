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
  either, and every case is held within 1e-3 (the same stream) besides
  the bound.  mini_grove-queue3 renders at 400x200 under
  EIDOLA_MARCH_MIN=2048: its primary march runs the three lap
  capacities of 1920x1080, [32768, 8192, 2048], each for a lap at least
  (counted), against JAX's frame under the same switches; and the
  port's queue march gives the same frame bit for bit under other caps.
- Frame 41, the bench's last timed frame, of cornell and mini_grove at
  272x136 against JAX's frame 41: the temporal state carries through 42
  frames as in JAX.  JAX's own frame 41 stands past the bound from its
  earlier stored frame (at 272x136 and at 1920x1080), so a later frame
  is held against the frame of its own index only.
- `reference.find` takes the march the frame runs: the `_queue` file for
  a queue frame of an alpha-tested scene, the plain file for a lockstep
  frame and for a scene with no alpha-tested material; a file whose
  meta records another march is never taken.
- The comparison fails a copy shifted in value, shifted by a block and
  corrupted in one block, and names the corrupted block.
- Each full-size reference (the lockstep and the queue frames of the
  alpha scenes, bistro_flat's and stress's) records bench.py's config
  for its scene (`bench.frame_cfg`), the bench's last warm-up frame and
  its march, so they cannot drift apart.
- The bench holds its last warm-up frame against the reference before
  its window; a miss exits 1 with "value": -1 and nothing timed, and a
  size with no reference gives null fields.  After the window it holds
  the window's last frame against the stored frame of its own index: a
  miss exits 1 with the readings.
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
LAST_FRAME = 41           # the bench's last timed frame (2 + 40 frames)
FULL = ("bistro_standin", "bistro_flat")


def builders_like(monkeypatch, meta) -> None:
    """The port builds with the host builder the reference's JAX side
    took (C++ when the file says so, else numpy)."""
    if not meta["jax_native_builders"]:
        monkeypatch.setattr(t_native, "_lib", None)
        monkeypatch.setattr(t_native, "_tried", True)


def small_cfg(scene, width=SMALL_W, height=SMALL_H) -> RenderConfig:
    return RenderConfig(width=width, height=height, max_depth=4,
                        traversal_max_steps=1024,
                        env_mode="hdr" if scene.env is not None else "sunsky",
                        alpha_geometry=headless.alpha_geometry(scene))


def small_ref(name, march="auto", tag="", size=(SMALL_W, SMALL_H),
              frame=SMALL_FRAME):
    path = os.path.join(R.REF_DIR, R.file_name(name, *size, 4, frame,
                                               march, tag))
    return path, R.load(path)


# below the ~1e-3 by which JAX's frames under the two marches differ
# (test_jax_march_modes_differ): a frame within it ran the reference's
# rng stream
SAME_STREAM = 1e-3
QUEUE3 = {"EIDOLA_MARCH_MIN": "2048"}
QUEUE3_SIZE = (400, 200)
QUEUE3_CAPS = [32768, 8192, 2048]


def count_laps(monkeypatch) -> list:
    """Records, for every queue march band, (its lap capacities, the rays
    each lap took).  A lap at stage k takes min(pending, caps[k]) rays
    while more than caps[k + 1] are pending, so its size names its
    stage."""
    laps, sizes = [], []
    band, lap = TT._march_band, TT._march_lap

    def counted_band(*args):
        n0 = len(sizes)
        band(*args)
        laps.append((list(args[-1]), sizes[n0:]))

    def counted_lap(scene, hop_bvh, sel, *args):
        sizes.append(sel.numel())
        return lap(scene, hop_bvh, sel, *args)

    monkeypatch.setattr(TT, "_march_band", counted_band)
    monkeypatch.setattr(TT, "_march_lap", counted_lap)
    return laps


def laps_per_stage(laps, caps) -> list:
    """Laps at each stage of the marches that ran under `caps`."""
    per = [0] * len(caps)
    for got, sizes in laps:
        if got != caps:
            continue
        for n in sizes:
            k = next(k for k in range(len(caps)) if n > (
                caps[k + 1] if k + 1 < len(caps) else 0))
            assert n <= caps[k]
            per[k] += 1
    return per


@pytest.mark.parametrize("trav", ["xla", "pallas"])
@pytest.mark.parametrize("name,march,env,size", [
    pytest.param("cornell", "auto", {}, None, id="cornell-auto"),
    pytest.param("mini_grove", "auto", {}, None, id="mini_grove-auto"),
    pytest.param("mini_grove", "queue", {}, None, id="mini_grove-queue"),
    pytest.param("mini_grove", "queue", QUEUE3, QUEUE3_SIZE,
                 id="mini_grove-queue3")])
def test_small_frame_matches_jax(name, march, env, size, trav, monkeypatch):
    """mini_grove-queue3 is the queue march in the three stages of
    1920x1080 (caps [32768, 8192, 2048] under EIDOLA_MARCH_MIN=2048, at
    400x200, where ~16.7k rays start the primary march), each of which
    takes a lap."""
    tag = "min2048" if env else ""
    path, ref = small_ref(name, march, tag, size or (SMALL_W, SMALL_H))
    assert ref["meta"].get("alpha_march", "auto") == march
    if env:
        assert ref["meta"]["env"] == {"EIDOLA_ALPHA_MARCH": march, **env}
    builders_like(monkeypatch, ref["meta"])
    monkeypatch.setattr(P, "TRAV", trav)
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", march)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    laps = count_laps(monkeypatch)
    scene, cam = load_scene(name, device=CPU)
    cfg = small_cfg(scene, *(size or (SMALL_W, SMALL_H)))
    if not env:
        assert R.find(name, cfg, SMALL_FRAME, TT._march_mode(CPU)) == path
    caps = TT._march_caps(cfg.width * cfg.height)
    if march == "queue":
        assert caps == (QUEUE3_CAPS if env else [32768, 8192])
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    for _ in range(SMALL_FRAME + 1):
        state, out = step(scene, cam, params, tm, state)
    if env:
        assert min(laps_per_stage(laps, caps)) >= 1, laps
    elif march == "queue":      # ~7.7k rays start it: the second stage
        assert laps_per_stage(laps, caps)[1] >= 1, laps
    else:
        assert laps == []
    got = R.compare(out["hdr"], ref)
    err = float(np.abs(out["hdr"].numpy() - ref["lattice"]).mean())
    assert got["mean_abs"] == pytest.approx(err, rel=1e-6, abs=1e-12)
    assert got["ok"], R.line(f"{name} {march} {trav}", got)
    assert got["mean_abs"] < SAME_STREAM, R.line(f"{name} {march}", got)


@pytest.mark.parametrize("name", ["cornell", "mini_grove"])
def test_last_timed_frame_matches_jax(name, monkeypatch):
    """Frame 41 (the bench's last timed frame: 2 warm-up + 40) at 272x136
    under the torch walk and the CPU's lockstep march against JAX's frame
    41: the temporal state, the reservoirs and the accumulation carry
    through 42 frames as in JAX, within the bound and on JAX's stream."""
    path, ref = small_ref(name, frame=LAST_FRAME)
    assert ref["meta"]["frame"] == LAST_FRAME
    builders_like(monkeypatch, ref["meta"])
    monkeypatch.setattr(P, "TRAV", "xla")
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "auto")
    scene, cam = load_scene(name, device=CPU)
    cfg = small_cfg(scene)
    assert R.find(name, cfg, LAST_FRAME, TT._march_mode(CPU)) == path
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    for _ in range(LAST_FRAME + 1):
        state, out = step(scene, cam, params, tm, state)
    got = R.compare(out["hdr"], ref)
    assert got["ok"] and got["mean_abs"] < SAME_STREAM, R.line(name, got)


@pytest.mark.parametrize("name,size,early", [
    ("cornell", (SMALL_W, SMALL_H), SMALL_FRAME),
    ("mini_grove", (SMALL_W, SMALL_H), SMALL_FRAME),
    ("bistro_flat", (1920, 1080), 1), ("stress", (1920, 1080), 1)])
def test_jax_accumulated_frame_drifts(name, size, early):
    """JAX's own frame 41 stands past the bound from its earlier stored
    frame in the block means as well as on the lattice: the accumulated
    frame's expectation moves with the temporal history, not only its
    noise, so a later frame is held against the stored frame of its own
    index, never an earlier one."""
    _, first = small_ref(name, size=size, frame=early)
    _, last = small_ref(name, size=size, frame=LAST_FRAME)
    assert np.abs(last["lattice"] - first["lattice"]).mean() > R.BOUND
    assert np.abs(last["blocks"] - first["blocks"]).mean() > 1e-2


def test_jax_march_modes_differ():
    """JAX's mini_grove frame under the queue march and under the CPU's
    lockstep march differ (another rng stream after the alpha test) by
    more than the port's frames differ from JAX's under one march
    (1e-5 to 1.5e-5 mean abs), yet within the bound."""
    _, lock = small_ref("mini_grove")
    _, queue = small_ref("mini_grove", "queue")
    got = R.compare(torch.from_numpy(queue["lattice"]), lock)
    assert 1e-3 < got["mean_abs"] < R.BOUND and got["ok"]


@pytest.mark.parametrize("name", ["bistro_standin", "bistro_hdr"])
def test_jax_full_size_march_modes_differ(name):
    """At 1920x1080 too, JAX's frame 1 under the queue march and under the
    lockstep march are two noise realisations: their block means differ
    by more than 3e-4 mean abs (a frame on the other march's stream
    reads this against a file), within the bound."""
    lock = R.load(os.path.join(R.REF_DIR, f"{name}_1920x1080_d4_f1.npz"))
    queue = R.load(os.path.join(R.REF_DIR,
                                f"{name}_1920x1080_d4_f1_queue.npz"))
    d = np.abs(queue["blocks"] - lock["blocks"]).mean()
    assert 3e-4 < d < R.BOUND
    assert np.abs(queue["lattice"] - lock["lattice"]).mean() < R.BOUND


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


def full_cfg(name):
    """bench.frame_cfg of `name` at the bench's size, from the scene at a
    small triangle count (the config depends on its materials and
    environment, not its size)."""
    kwargs = {"n": 16} if name == "stress" else {"target_mtris": 0.002}
    scene, _ = load_scene(name, device=CPU, **kwargs)
    return bench.frame_cfg(scene, bench.W, bench.H), kwargs


@pytest.mark.parametrize("name,march,frame", [
    pytest.param("bistro_standin", "lockstep", 1, id="bistro_standin"),
    pytest.param("bistro_flat", "lockstep", 1, id="bistro_flat"),
    pytest.param("bistro_standin", "queue", 1, id="bistro_standin-queue"),
    pytest.param("bistro_hdr", "queue", 1, id="bistro_hdr-queue"),
    pytest.param("bistro_hdr", "lockstep", 1, id="bistro_hdr"),
    pytest.param("stress", "queue", 1, id="stress"),
    pytest.param("bistro_flat", "queue", 41, id="bistro_flat-f41"),
    pytest.param("stress", "lockstep", 41, id="stress-f41"),
    pytest.param("bistro_standin", "queue", 4, id="bistro_standin-queue-f4")])
def test_full_reference_is_the_bench_frame(name, march, frame):
    """The stored full-size frame is bench.frame_cfg's config for the
    scene at the bench's size, and the bench's last warm-up frame (1) or
    a last timed frame (41, the default window's; 4, chip_smoke.py's
    bench phase's) under the march it names; its arrays have the
    lattice's and the blocks' shapes and are finite."""
    cfg_ref, kwargs = full_cfg(name)
    path = R.find(name, cfg_ref, frame, march)
    queue = march == "queue" and cfg_ref.alpha_geometry
    tail = ("_queue" if queue else "") + (f"_f{frame}" if frame != 1
                                          else "")
    assert path is not None and os.path.basename(path) == (
        f"{name}_1920x1080_d4_f{frame}{'_queue' if queue else ''}.npz")
    ref = R.load(path)
    meta = ref["meta"]
    assert {k: meta[k] for k in R.CONFIG_FIELDS} == {
        k: getattr(cfg_ref, k) for k in R.CONFIG_FIELDS}
    assert meta["frame"] == frame and meta["scene"] == name
    assert meta["jax_version"] and meta["command"].endswith(name + tail)
    assert R.march_of(meta) == ("queue" if queue else "lockstep")
    if "env" in meta:           # the files of PR 15 on
        assert meta["env"] == {"EIDOLA_ALPHA_MARCH": meta["alpha_march"]}
        assert meta["scene_kwargs"] == (kwargs if name == "stress" else {})
        assert len(meta["frame_s"]) == frame + 1
        assert min(meta["frame_s"]) > 0
    assert "env" in meta or (name != "stress" and not queue and frame == 1)
    assert ref["stride"] == 4 and ref["lattice"].shape == (270, 480, 3)
    assert ref["blocks"].shape == (135, 240, 3)
    assert np.isfinite(ref["lattice"]).all()
    assert np.isfinite(ref["blocks"]).all()
    assert ref["blocks"].mean() > 0.01


@pytest.mark.parametrize("name,march,want", [
    ("mini_grove", "queue", "mini_grove_272x136_d4_f3_queue.npz"),
    ("mini_grove", "lockstep", "mini_grove_272x136_d4_f3.npz"),
    ("cornell", "queue", "cornell_272x136_d4_f3.npz"),
    ("cornell", "lockstep", "cornell_272x136_d4_f3.npz")])
def test_find_picks_the_march_file(name, march, want):
    """A queue frame of an alpha-tested scene reads the `_queue` file, a
    lockstep frame the plain one; a scene with no alpha-tested material
    runs no march and reads the plain file under either."""
    scene, _ = load_scene(name, device=CPU)
    assert os.path.basename(R.find(name, small_cfg(scene), SMALL_FRAME,
                                   march)) == want


@pytest.mark.parametrize("stored,march", [("queue", "lockstep"),
                                          ("auto", "queue")])
def test_find_refuses_another_march(stored, march, tmp_path, monkeypatch):
    """A file under the name of `march` whose meta records the other
    march (mini_grove's stored frame of `stored` copied under the other
    name) is no reference: find returns None.  The stored lockstep file
    records "auto", regen.py's default, which JAX's CPU resolves to
    lockstep."""
    src, ref = small_ref("mini_grove", stored)
    assert R.march_of(ref["meta"]) == ("lockstep" if stored == "auto"
                                       else stored)
    dst = R.file_name("mini_grove", SMALL_W, SMALL_H, 4, SMALL_FRAME,
                      "queue" if march == "queue" else "auto")
    (tmp_path / dst).write_bytes(open(src, "rb").read())
    monkeypatch.setattr(R, "REF_DIR", str(tmp_path))
    scene, _ = load_scene("mini_grove", device=CPU)
    cfg = small_cfg(scene)
    assert R.find("mini_grove", cfg, SMALL_FRAME, march) is None
    assert R.find("mini_grove", cfg, SMALL_FRAME, stored.replace(
        "auto", "lockstep")) is None        # no file under its own name


def test_queue_march_frame_does_not_depend_on_caps(monkeypatch):
    """The queue march's lap capacities change how many rays ride a lap,
    not a ray's hops or BLEND draws: mini_grove's frame at 400x200 under
    the three stages of EIDOLA_MARCH_MIN=2048 and under the default two
    is the same bit for bit (a change to the march that keeps its
    stream must keep this)."""
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "queue")
    scene, cam = load_scene("mini_grove", device=CPU)
    cfg = small_cfg(scene, *QUEUE3_SIZE)
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    hdr = {}
    for cmin in ("2048", "8192"):
        monkeypatch.setenv("EIDOLA_MARCH_MIN", cmin)
        state, step = init_frame_state(cfg, cam), make_step(cfg)
        for _ in range(2):
            state, out = step(scene, cam, params, tm, state)
        hdr[cmin] = out["hdr"]
    assert TT._march_caps(cfg.width * cfg.height) == [32768, 8192]
    assert torch.equal(hdr["2048"], hdr["8192"])


# ------------------------------------------------------------- the bench

SMALL = ["--device", "cpu", "--scene", "cornell", "--size", "32", "32",
         "--warmup", "2", "--iters", "1"]


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def _frame1_reference(tmp_path, monkeypatch, shift: float,
                      last_shift=None):
    """The bench's own frame 1 at cornell 32x32, stored in a reference
    directory of its own as regen.py stores a small frame, plus `shift`;
    with `last_shift`, its frame 2 (SMALL's last timed frame) too, plus
    `last_shift`."""
    scene, cam = load_scene("cornell", device=CPU)
    cfg = bench.frame_cfg(scene, 32, 32)
    params, tm = default_params(device=CPU), default_tonemap(device=CPU)
    got = []
    _, out, *_ = bench.time_frames(
        cfg, scene, cam, params, tm, CPU, 2, 1,
        lambda out: got.append(out["hdr"].clone()) or True)
    frames = {1: (got[0], shift)}
    if last_shift is not None:
        frames[2] = (out["hdr"], last_shift)
    for frame, (hdr, add) in frames.items():
        meta = {k: getattr(cfg, k) for k in R.CONFIG_FIELDS}
        meta.update(frame=frame, jax_native_builders=True)
        np.savez_compressed(
            tmp_path / R.file_name("cornell", 32, 32, 4, frame),
            meta=np.array(json.dumps(meta)),
            hdr=hdr.numpy() + np.float32(add))
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
    assert out["reference_last_frame"] is None
    assert out["reference_last_mean_abs"] is None


def test_bench_reference_held(tmp_path, monkeypatch):
    """The bench's own frame 1 as the reference: readings of 0, correct;
    no file of frame 2, the window's last: its fields are null."""
    _frame1_reference(tmp_path, monkeypatch, 0.0)
    rc, out = _run(SMALL)
    assert rc == 0 and out["correct"] is True and out["value"] > 0
    assert out["reference_frame"] == 1
    assert out["reference_file"].endswith("cornell_32x32_d4_f1.npz")
    assert out["reference_mean_abs"] == out["reference_block_max"] == 0.0
    assert out["reference_block_max_at"] == [0, 0]
    assert out["reference_last_frame"] is None
    assert out["reference_last_file"] is None
    assert out["reference_last_mean_abs"] is None


def test_bench_without_reference_is_null():
    """No reference at this size: the fields are null, nothing else is
    taken in its place, and `correct` is the golden and the image's."""
    rc, out = _run(SMALL)
    assert rc == 0 and out["correct"] is True
    assert out["reference_frame"] is None and out["reference_file"] is None
    assert out["reference_mean_abs"] is None
    assert out["reference_block_mean_abs"] is None
    assert out["reference_block_max"] is None
    assert out["reference_last_frame"] is None
    assert all(out["reference_last_" + k] is None for k in bench.READINGS)


@pytest.mark.parametrize("shift", [0.0, 0.05])
def test_bench_last_frame_check(shift, tmp_path, monkeypatch):
    """Frame 1 holds; the window's last frame (2) is held against the
    stored frame 2, after the window: shifted by 0.05 it misses, and the
    bench prints its line with correct false, value -1, the last frame's
    readings and an error, and exits 1; unshifted it holds with readings
    of 0."""
    _frame1_reference(tmp_path, monkeypatch, 0.0, shift)
    real_compare, real_time = R.compare, bench.time_frames
    done, calls = [False], []

    def compare(hdr, ref):
        calls.append(done[0])
        return real_compare(hdr, ref)

    def time_frames(*args, **kwargs):
        got = real_time(*args, **kwargs)
        done[0] = True
        return got

    monkeypatch.setattr(R, "compare", compare)
    monkeypatch.setattr(bench, "time_frames", time_frames)
    rc, out = _run(SMALL)
    assert calls == [False, True]           # frame 1 before, frame 2 after
    assert out["reference_mean_abs"] == 0.0
    assert out["reference_last_frame"] == 2
    assert out["reference_last_file"].endswith("cornell_32x32_d4_f2.npz")
    last = out["reference_last_mean_abs"]
    if shift:
        assert rc == 1 and out["correct"] is False and out["value"] == -1
        assert "frame 2, the window's last" in out["error"]
        assert last == pytest.approx(0.05, rel=1e-4)
        assert out["reference_last_block_mean_abs"] == pytest.approx(
            0.05, rel=1e-4)
    else:
        assert rc == 0 and out["correct"] is True and out["value"] > 0
        assert last == out["reference_last_block_max"] == 0.0
        assert "error" not in out


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
