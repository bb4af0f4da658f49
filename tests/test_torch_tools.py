"""The port's counterparts of the root tools (eidola_tpu_torch/tools/) held
on the CPU against the JAX tools' stored outputs (tests/golden_torch/,
the FIDELITY group of tests/golden_torch/regen.py, written through the
JAX tools' own functions).  No JAX is imported or compiled here.

- fidelity_metrics at 32x32, 6 frames, 6 spp (`--frames 2,6`), cornell
  and alpha under the CPU's lockstep march: each of the five images (the
  two oracles, the three stages at 6 frames) within 1e-5 (cornell) and
  1e-3 (alpha) mean abs of JAX's, each RMSE within 1e-3 of JAX's and each
  mean-relative error within 0.1 percentage point; the run holds its
  images against the plain (lockstep) file and prints JAX's rows beside
  its own; the 2- and 6-frame means of one run are those of two
  separate runs, bit for bit; the lookup takes the alpha scene's
  `_queue` file under the queue march and cornell's one file under
  both.
- fidelity_captures at 32x32, 1 frame, cornell and alpha: each of the
  ten captures within the same bounds of JAX's `render` of the same
  config; each PNG decodes to the image quantised as the JAX tool's
  `save` does, and each printed line carries its seconds, mean, min and
  max.
- perf_gather at a small R: the gather sums, the sorted keys and carried
  values, the argsort and the wrapping int32 cumsum equal numpy's, and
  the printed lines parse.
- Each entry point refuses a CUDA device that is not there and prints
  nothing: no fallback to the CPU.

The stored files were rendered by the JAX package's native (C++) host
builders where their `meta` says so; the port builds with the builder
the file records.
"""
import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import eidola_tpu_torch.native as t_native
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.render.config import RenderConfig
from eidola_tpu_torch.tools import fidelity_captures as FC
from eidola_tpu_torch.tools import fidelity_metrics as FM
from eidola_tpu_torch.tools import load_stored
from eidola_tpu_torch.tools import perf_gather as PG
from eidola_tpu_torch.utils.png import decode_png
from eidola_tpu_torch.utils.reference import REF_DIR

torch.set_num_threads(2)

CPU = torch.device("cpu")
SIZE = ("32", "32")
FRAMES, SPP = 6, 6
# mean abs against JAX's image: cornell runs the same arithmetic, alpha's
# HitTest drains differ in the last bits (tests/test_torch_alpha.py)
IMAGE_TOL = {"cornell": 1e-5, "alpha": 1e-3}
RMSE_TOL, MREL_TOL = 1e-3, 1e-3      # absolute; MREL_TOL = 0.1 point
SCENES = FM.SCENES


def stored(prefix: str, scene: str) -> str:
    """The lockstep (plain) file of `scene` at the test size."""
    tail = f"_s{SPP}" if prefix == "fidelity" else ""
    frames = FRAMES if prefix == "fidelity" else 1
    return os.path.join(REF_DIR, f"{prefix}_{scene}_{SIZE[0]}x{SIZE[1]}_"
                                 f"f{frames}{tail}.npz")


@contextlib.contextmanager
def builders_like(*paths):
    """The port builds with the host builder the JAX side took (C++ when
    the files say so, else numpy)."""
    native = {load_stored(p, ())["meta"]["jax_native_builders"]
              for p in paths}
    assert len(native) == 1, f"{paths} record different builders"
    with pytest.MonkeyPatch.context() as mp:
        if not native.pop():
            mp.setattr(t_native, "_lib", None)
            mp.setattr(t_native, "_tried", True)
        yield


def run_tool(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    out = tmp_path_factory.mktemp("fidelity") / "table.json"
    with builders_like(*(stored("fidelity", s) for s in SCENES)):
        res, lines = run_tool(FM.run, [
            "--device", "cpu", "--size", *SIZE, "--frames", f"2,{FRAMES}",
            "--spp", str(SPP), "--out", str(out)])
    return res, lines, out


@pytest.fixture(scope="module", params=SCENES)
def caps(request, tmp_path_factory):
    scene = request.param
    out = tmp_path_factory.mktemp(f"captures_{scene}")
    with builders_like(stored("captures", scene)):
        res, lines = run_tool(FC.run, ["--device", "cpu", "--size", *SIZE,
                                       "--scene", scene, "--out", str(out)])
    return scene, res, lines


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("image", FM.IMAGES)
def test_fidelity_image_matches_jax(table, scene, image):
    res, _, _ = table
    got = res["images"][scene][image]
    want = load_stored(stored("fidelity", scene), [image])[image]
    assert got.shape == want.shape == (32, 32, 3)
    err = float(np.abs(got - want).mean())
    assert err < IMAGE_TOL[scene], f"{scene} {image}: mean abs {err}"


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("stage", FM.STAGES)
def test_fidelity_row_matches_jax(table, scene, stage):
    res, _, _ = table
    got = {(r["scene"], r["stage"], r["frames"]): r for r in res["rows"]}
    mine = got[(scene, stage, FRAMES)]
    meta = load_stored(stored("fidelity", scene), ())["meta"]
    jax = {r["stage"]: r for r in meta["rows"]}[stage]
    assert abs(mine["rmse"] - jax["rmse"]) < RMSE_TOL, (mine, jax)
    assert abs(mine["mrel"] - jax["mrel"]) < MREL_TOL, (mine, jax)
    assert abs(mine["oracle_mean"] - jax["oracle_mean"]) < RMSE_TOL


def test_fidelity_run_holds_and_prints(table):
    res, lines, out = table
    assert res["device"]["platform"] == "cpu"
    assert res["alpha_march"] == "lockstep" and res["frames"] == [2, FRAMES]
    for scene in SCENES:
        held = res["jax"][scene]
        assert held["ok"] and held["file"] == os.path.relpath(
            stored("fidelity", scene), FM.ROOT)
    rows = [ln for ln in lines if re.match(
        r"^\w+ +[\w -]+ RMSE \d+\.\d{4}  mean-rel \d+\.\d{2}%", ln)]
    assert len(rows) == len(SCENES) * len(FM.STAGES) * 2
    assert sum("| JAX RMSE" in ln for ln in rows) == len(SCENES) * len(
        FM.STAGES)
    last = json.loads(lines[-1])
    assert last["rows"] == res["rows"] == json.loads(out.read_text())["rows"]
    assert "images" not in last


def test_frames_list_equals_separate_runs():
    scene, cam = load_scene("cornell", device=CPU)
    base = FM.base_config(scene, 32, 32)
    _, cfg, _ = FM.stage_configs(base)[0]
    both = FM.pipeline(scene, cam, cfg, [2, 6])
    for n in (2, 6):
        alone = FM.pipeline(scene, cam, cfg, n)
        assert list(alone) == [n]
        assert torch.equal(both[n], alone[n]), n


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("march", ("queue", "lockstep"))
def test_fidelity_find_ref_takes_the_march(scene, march):
    alpha = scene == "alpha"
    cfg = RenderConfig(width=32, height=32, max_depth=2,
                       traversal_max_steps=2048, alpha_geometry=alpha,
                       accumulate=False)
    path = FM.find_ref(scene, cfg, FRAMES, SPP, march)
    queue = alpha and march == "queue"
    assert path == stored("fidelity", scene).replace(
        ".npz", "_queue.npz" if queue else ".npz")
    meta = load_stored(path, ())["meta"]
    assert meta["alpha_march"] == ("queue" if queue else
                                   "auto" if alpha else None)
    assert FM.find_ref(scene, cfg, FRAMES, SPP + 1, march) is None
    assert FC.find_ref(scene, FC.base_config(
        load_scene(scene, device=CPU)[0], 32, 32), 1, march).endswith(
        f"captures_{scene}_32x32_f1{'_queue' if queue else ''}.npz")


@pytest.mark.parametrize("name", [c[0] for c in FC.captures(
    RenderConfig(), 1)])
def test_capture_matches_jax(caps, name):
    scene, res, _ = caps
    got = res["images"][name]
    want = load_stored(stored("captures", scene), [name])[name]
    assert got.shape == want.shape == (32, 32, 3)
    err = float(np.abs(got - want).mean())
    assert err < IMAGE_TOL[scene], f"{scene} {name}: mean abs {err}"


def test_capture_pngs_and_lines(caps):
    scene, res, lines = caps
    assert res["jax"]["ok"] and res["jax"]["file"].endswith(
        f"captures_{scene}_32x32_f1.npz")
    assert [r["name"] for r in res["captures"]] == [
        c[0] for c in FC.captures(RenderConfig(), 1)]
    for r in res["captures"]:
        img = res["images"][r["name"]]
        with open(r["png"], "rb") as f:
            png = decode_png(f.read())
        want = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        # decode_png gives RGBA; an RGB file decodes opaque
        assert png.dtype == np.uint8 and png.shape == (32, 32, 4)
        assert np.array_equal(png[..., :3], want) and (png[..., 3] == 255
                                                       ).all()
        assert (r["mean"], r["min"], r["max"]) == (
            float(img.mean()), float(img.min()), float(img.max()))
        assert r["frames"] == (64 if r["name"] == "com_accum64" else 1)
    caps_lines = [ln for ln in lines if re.match(
        r"^  \w+: \d+\.\d+s \(\d+ frames\) mean \d+\.\d{4} min -?\d+\.\d{4} "
        r"max \d+\.\d{4}; against JAX's: mean abs \S+ -> \S+\.png$", ln)]
    assert len(caps_lines) == 10
    assert json.loads(lines[-1])["captures"] == res["captures"]


R_SMALL = 4096


@pytest.fixture(scope="module")
def gather_inputs():
    return PG.inputs(R_SMALL, CPU)


@pytest.mark.parametrize("k", range(len(PG.TABLES)))
def test_perf_gather_sums_like_numpy(gather_inputs, k):
    table, idx = gather_inputs["gathers"][k]
    assert tuple(table.shape) == PG.TABLES[k] and idx.shape == (R_SMALL,)
    got = PG.gather_sum(table, idx).numpy()
    want = table.numpy()[idx.numpy()].sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_perf_gather_sorts_like_numpy(gather_inputs):
    keys, vals = gather_inputs["keys"], gather_inputs["vals"]
    assert keys.dtype == torch.int64 and int(keys.max()) < 1 << 30
    k, v = keys.numpy(), vals.numpy()
    order = np.argsort(k, kind="stable")
    sk, sv = PG.sort_kv(keys, vals)
    assert np.array_equal(sk.numpy(), k[order])
    assert sv.dtype == torch.int32 and np.array_equal(sv.numpy(), v[order])
    assert np.array_equal(PG.argsort(keys).numpy(), order)
    cs = PG.cumsum(keys)
    assert cs.dtype == torch.int32
    assert np.array_equal(cs.numpy(),
                          np.cumsum(k.astype(np.int32), dtype=np.int32))


def test_perf_gather_lines_parse():
    rc, lines = None, None
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = PG.main(["--device", "cpu", "--rays", "2048"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and lines[0] == "device cpu; R = 2048"
    gathers = [re.match(r"^gather table=\( *(\d+), *(\d+)\)  +(\d+\.\d+) ms"
                        r"  (\d+\.\d+) Grows/s  (\d+) GB/s$", ln)
               for ln in lines[1:7]]
    assert [tuple(int(g[i]) for i in (1, 2)) for g in gathers] == list(
        PG.TABLES)
    assert re.match(r"^sort_kv 2048 int64 keys, int32 values: +\d+\.\d+ ms$",
                    lines[7])
    assert re.match(r"^argsort 2048 int64: +\d+\.\d+ ms$", lines[8])
    assert re.match(r"^cumsum 2048 int32: +\d+\.\d+ ms$", lines[9])
    res = json.loads(lines[10])
    assert len(lines) == 11 and res["rays"] == 2048
    assert [r["name"] for r in res["rows"]] == ["gather"] * 6 + [
        "sort_kv", "argsort", "cumsum"]
    assert all(r["ms"] > 0 for r in res["rows"])


TOOLS = {"fidelity_metrics": FM.main, "fidelity_captures": FC.main,
         "perf_gather": PG.main}


@pytest.mark.parametrize("tool", sorted(TOOLS))
@pytest.mark.parametrize("device", ("cuda", "cuda:64"))
def test_tool_refuses_a_missing_device(monkeypatch, capsys, tool, device):
    if device == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        TOOLS[tool](["--device", device])
    assert "nothing run" in str(e.value.code)
    assert capsys.readouterr().out == ""
