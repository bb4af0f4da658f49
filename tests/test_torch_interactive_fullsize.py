"""The port's interactive frame and its scene-pipeline (GLB + .hdr) frame
held against the JAX package's headless app (tests/golden_torch/, the
INTERACTIVE names of tests/golden_torch/regen.py: JAX's
`eidola_tpu.app.headless.run` on chip_smoke.py's argument lists).

- At 272x136 the port's headless app renders mini_grove (instancing,
  the alpha HitTest, textures) with chip_smoke.py's interactive flags
  (the camera orbiting 0.01 rad a frame, ReSTIR DI spatiotemporal,
  shadow cadence 4, the seeded primary walk; indirect and denoise on),
  4 frames, under the lockstep and the queue march and both CPU
  traversals; frame 3 stands within 0.02 mean abs of JAX's and within
  1e-3, the same rng stream's bound.
- `reference.find` tells the interactive frame from the static one and
  a file scene from a registry scene: a file of the other kind copied
  under the frame's name is refused, and a stored file that records no
  flags reads as the static frame of a registry scene.
- Each stored full-size frame of chip_smoke.py's interactive and gltf
  phases records the RenderConfig that the port's headless app builds
  from the same argument list, its orbit and its frame, and `find`
  returns it for that config; the inputs that `write_inputs` writes
  here have the sha256 that the gltf frames record.

No JAX is imported or compiled here.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import eidola_tpu_torch.native as t_native
from eidola_tpu_torch.app import headless
from eidola_tpu_torch.models.scenes import load_scene, write_standin_glb
from eidola_tpu_torch.ops import packets as P
from eidola_tpu_torch.render import tracer as TT
from eidola_tpu_torch.scene.data import attach_env
from eidola_tpu_torch.scene.hdr import build_env_map, load_hdr
from eidola_tpu_torch.utils import reference as R

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL_SIZE, SMALL_FRAME = (272, 136), 3
SAME_STREAM = 1e-3        # tests/test_torch_fullsize.py's
FULL = {  # stored name: (scene, frame)
    "bistro_standin_1920x1080_d4_f1_queue_interactive.npz":
        ("bistro_standin", 1),
    "bistro_standin_1920x1080_d4_f3_queue_interactive.npz":
        ("bistro_standin", 3),
    "standin_glb_1920x1080_d4_f2_queue.npz": (R.GLTF_SCENE, 2),
    "standin_glb_1920x1080_d4_f4_queue.npz": (R.GLTF_SCENE, 4),
}
STATIC_F1 = "bistro_standin_1920x1080_d4_f1_queue.npz"


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(R.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_size(argv, scene, size):
    out = list(argv)
    out[out.index("--scene") + 1] = scene
    i = out.index("--size")
    out[i + 1:i + 3] = [str(size[0]), str(size[1])]
    return out


def builders_like(monkeypatch, meta) -> None:
    if not meta["jax_native_builders"]:
        monkeypatch.setattr(t_native, "_lib", None)
        monkeypatch.setattr(t_native, "_tried", True)


def copy_as(tmp_path, monkeypatch, src: str, dst: str) -> None:
    """The stored file `src` under the name `dst` in a reference
    directory of its own."""
    (tmp_path / dst).write_bytes(open(os.path.join(R.REF_DIR, src),
                                      "rb").read())
    monkeypatch.setattr(R, "REF_DIR", str(tmp_path))


def cfg_of(argv, scene):
    args = headless.build_argparser().parse_args(argv)
    return headless.frame_config(args, scene, *args.size[:2]), args


@pytest.fixture(scope="module")
def standin():
    """bistro_standin at a small triangle count: the config depends on
    its materials and environment, not its size."""
    return load_scene("bistro_standin", device=CPU, target_mtris=0.002)[0]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """write_inputs' files here, and the GLB's scene (the standin's parts
    at a small triangle count under the .hdr) for its config."""
    tmp = tmp_path_factory.mktemp("inputs")
    files = R.write_inputs(str(tmp))
    small = str(tmp / "small.glb")
    write_standin_glb(small, 0.002)
    scene, _ = load_scene(small, device=CPU)
    scene = attach_env(scene, build_env_map(load_hdr(files["hdr"]["path"]),
                                            device=CPU))
    return files, scene


@pytest.mark.parametrize("trav", ["xla", "pallas"])
@pytest.mark.parametrize("march", ["auto", "queue"])
def test_interactive_small_frame_matches_jax(march, trav, monkeypatch):
    """Frame 3 of mini_grove at 272x136 with the interactive flags: the
    camera's first move (a new field of view), temporal and spatial
    reuse under motion, the shadow tile mask's cadence, the seeded
    primary walk on the instanced and alpha BVHs, ReSTIR GI and the
    a-trous history reprojected, against JAX's headless app."""
    cs = chip_smoke()
    argv = with_size(cs.INTERACTIVE, "mini_grove", SMALL_SIZE)
    path = os.path.join(R.REF_DIR, R.file_name(
        "mini_grove", *SMALL_SIZE, 4, SMALL_FRAME, march, "interactive"))
    ref = R.load(path)
    meta = ref["meta"]
    assert meta["argv"] == [argv] and meta["alpha_march"] == march
    builders_like(monkeypatch, meta)
    monkeypatch.setattr(P, "TRAV", trav)
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", march)
    res = headless.run(argv + ["--device", "cpu"])
    cfg = res["cfg"]
    assert R.find("mini_grove", cfg, SMALL_FRAME, TT._march_mode(CPU),
                  0.01) == path
    assert res["frames"] == SMALL_FRAME + 1
    got = R.compare(res["hdr"], ref)
    label = f"mini_grove interactive 272x136 frame 3 {march} {trav}"
    other = "queue" if march == "auto" else "auto"
    print(R.line(label, got))     # pytest -rP prints the readings
    print(R.line(f"{label} against the {other} march's file", R.compare(
        res["hdr"], R.load(os.path.join(R.REF_DIR, R.file_name(
            "mini_grove", *SMALL_SIZE, 4, SMALL_FRAME, other,
            "interactive"))))))
    assert got["ok"], R.line(label, got)
    assert got["mean_abs"] < SAME_STREAM, R.line(label, got)


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_reference_is_the_phase_frame(name, standin, inputs):
    """The stored frame records the config that the port's headless app
    builds from chip_smoke.py's argument list, the flags, the orbit, the
    frame, the queue march and, for the GLB, the inputs' sha256 written
    here; `find` returns it for that config."""
    scene_name, frame = FULL[name]
    cs = chip_smoke()
    files, glb_scene = inputs
    path = os.path.join(R.REF_DIR, name)
    ref = R.load(path)
    meta = ref["meta"]
    if scene_name == R.GLTF_SCENE:
        base = ["--scene", "standin.glb", "-e", "env.hdr"] + cs.GLTF
        assert meta["argv"] == [
            base + ["--frames", "3", "--save-state", "s.npz"],
            base + ["--frames", "2", "--load-state", "s.npz"]]
        inp = {k: v["sha256"] for k, v in files.items()}
        assert meta["inputs"] == inp
        assert meta["input_bytes"] == {k: v["bytes"]
                                       for k, v in files.items()}
        scene, frames_rendered = glb_scene, 5
    else:
        assert meta["argv"] == [cs.INTERACTIVE] and "inputs" not in meta
        inp, scene, frames_rendered = None, standin, 4
    cfg, args = cfg_of(meta["argv"][0], scene)
    fields = (*R.CONFIG_FIELDS, *R.FLAG_DEFAULTS, "denoise",
              "indirect_enabled")
    assert {k: meta[k] for k in fields} == {k: getattr(cfg, k)
                                           for k in fields}
    assert meta["orbit"] == args.orbit
    assert meta["frame"] == frame and meta["scene"] == scene_name
    assert meta["frames_rendered"] == frames_rendered
    assert len(meta["frame_s"]) == frames_rendered
    assert meta["jax_native_builders"] is True
    assert meta["env"] == {"EIDOLA_ALPHA_MARCH": "queue"}
    assert R.march_of(meta) == "queue"
    assert R.find(scene_name, cfg, frame, "queue", args.orbit, inp) == path
    assert ref["stride"] == 4 and ref["lattice"].shape == (270, 480, 3)
    assert ref["blocks"].shape == (135, 240, 3)
    assert np.isfinite(ref["lattice"]).all()
    assert ref["blocks"].mean() > 0.01


def test_interactive_and_static_frames_differ():
    """JAX's interactive frame 1 stands far past the bound from its static
    frame 1 of the same scene and march: neither is a reference for the
    other."""
    inter = R.load(os.path.join(
        R.REF_DIR, "bistro_standin_1920x1080_d4_f1_queue_interactive.npz"))
    static = R.load(os.path.join(R.REF_DIR, STATIC_F1))
    for k in ("lattice", "blocks"):
        d = float(np.abs(inter[k] - static[k]).mean())
        print(f"JAX's interactive frame 1 against its static frame 1: {k} "
              f"mean abs {d:.6g}")     # pytest -rP prints it
        assert d > R.BOUND, k


@pytest.mark.parametrize("src,dst,interactive", [
    pytest.param(STATIC_F1,
                 "bistro_standin_1920x1080_d4_f1_queue_interactive.npz",
                 True, id="static-as-interactive"),
    pytest.param("bistro_standin_1920x1080_d4_f1_queue_interactive.npz",
                 STATIC_F1, False, id="interactive-as-static")])
def test_find_refuses_the_other_frame(src, dst, interactive, standin,
                                      tmp_path, monkeypatch):
    """The static bench frame's file copied under the interactive name is
    no reference for the interactive frame, and the interactive file
    under the static name none for the bench frame."""
    cs = chip_smoke()
    argv = cs.INTERACTIVE if interactive else cs.STANDIN
    cfg, args = cfg_of(argv, standin)
    assert R.interactive(cfg, args.orbit) == interactive
    assert R.find("bistro_standin", cfg, 1, "queue", args.orbit) == (
        os.path.join(R.REF_DIR, dst))
    copy_as(tmp_path, monkeypatch, src, dst)
    assert R.find("bistro_standin", cfg, 1, "queue", args.orbit) is None


@pytest.mark.parametrize("flag,value", [
    ("restir_mode", 4), ("shadow_cadence", 4), ("primary_seed", True),
    ("orbit", 0.01)])
def test_each_flag_makes_another_frame(flag, value, standin):
    """Each interactive flag alone makes the frame another than the
    static one: `find` then looks for the interactive file, which holds
    all four, and refuses it."""
    import dataclasses

    from eidola_tpu_torch import bench

    cfg = bench.frame_cfg(standin, 1920, 1080)
    orbit = value if flag == "orbit" else 0.0
    if flag != "orbit":
        cfg = dataclasses.replace(cfg, **{flag: value})
    assert R.interactive(cfg, orbit)
    assert R.find("bistro_standin", cfg, 1, "queue", orbit) is None


def test_old_files_read_as_the_static_frame(standin):
    """A file stored before the flags were recorded holds the defaults:
    the bench's frame finds it, with no orbit and no inputs."""
    from eidola_tpu_torch import bench

    meta = R.load(os.path.join(R.REF_DIR, STATIC_F1))["meta"]
    assert not {*R.FLAG_DEFAULTS, "orbit", "inputs"} & set(meta)
    cfg = bench.frame_cfg(standin, 1920, 1080)
    assert {k: getattr(cfg, k) for k in R.FLAG_DEFAULTS} == R.FLAG_DEFAULTS
    assert not R.interactive(cfg)
    assert R.find("bistro_standin", cfg, 1, "queue") == os.path.join(
        R.REF_DIR, STATIC_F1)
    assert R.find("bistro_standin", cfg, 1, "queue",
                  inputs={"glb": "0", "hdr": "0"}) is None


@pytest.mark.parametrize("change", ["glb", "hdr", "none", "registry"])
def test_find_holds_the_inputs(change, inputs, tmp_path, monkeypatch):
    """The GLB frame finds its file only with the inputs' sha256 it was
    rendered from: another GLB or .hdr, or no inputs, is refused, and a
    registry scene's file of the same config (bistro_hdr's frame 1 under
    the queue march) under the GLB's name is no reference for it."""
    files, scene = inputs
    cs = chip_smoke()
    cfg, _ = cfg_of(["--scene", "standin.glb", "-e", "env.hdr"] + cs.GLTF,
                    scene)
    inp = {k: v["sha256"] for k, v in files.items()}
    assert R.find(R.GLTF_SCENE, cfg, 2, "queue", 0.0, inp) == os.path.join(
        R.REF_DIR, "standin_glb_1920x1080_d4_f2_queue.npz")
    frame = 2
    if change == "registry":
        frame = 1
        copy_as(tmp_path, monkeypatch, "bistro_hdr_1920x1080_d4_f1_queue.npz",
                "standin_glb_1920x1080_d4_f1_queue.npz")
        meta = R.load(os.path.join(
            R.REF_DIR, "standin_glb_1920x1080_d4_f1_queue.npz"))["meta"]
        assert all(meta[k] == getattr(cfg, k) for k in R.CONFIG_FIELDS)
    elif change == "none":
        inp = None
    else:
        inp = dict(inp, **{change: "0" * 64})
    assert R.find(R.GLTF_SCENE, cfg, frame, "queue", 0.0, inp) is None


def test_write_inputs_reproduces_the_stored_sha256(inputs):
    """The shared writer gives the bytes the JAX frames were rendered
    from: the GLB (written in under a second here) and the 2048x1024
    .hdr."""
    files, _ = inputs
    metas = [R.load(os.path.join(R.REF_DIR, n))["meta"] for n in FULL
             if FULL[n][0] == R.GLTF_SCENE]
    assert len(metas) == 2
    for meta in metas:
        assert meta["inputs"] == {"glb": files["glb"]["sha256"],
                                  "hdr": files["hdr"]["sha256"]}
    for v in files.values():
        assert v["bytes"] == os.path.getsize(v["path"])
        assert v["sha256"] == R.sha256(v["path"])
    assert load_hdr(files["hdr"]["path"]).shape == (*R.ENV_SIZE, 3)
