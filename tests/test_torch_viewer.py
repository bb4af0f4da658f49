"""The port's viewer, checkpoints and device monitor, on the CPU.

- Every behaviour tests/test_viewer.py holds of the JAX viewer, on the
  port's `ViewerState` (cornell 32x32, device "cpu"): orbit, dolly,
  reset, pick recentres the pivot, params (tonemap and render), unknown
  param ignored, handler builds, config toggle, scene request queued,
  drag descale, worker scene swap, worker warms the preview variant up,
  endpoints over a real ThreadingHTTPServer.  Then the whole viewer
  (`start`: render and worker threads, the HTTP server on a free port)
  at 32x32: frames, /frame.png, a scene swap to a .glb with an .hdr
  through POST /scene, pick, config, param.
- `save_pytree` / `load_pytree`: a round trip, a shape mismatch
  rejected, a port FrameState after two frames loaded by the JAX
  package into its own `init_frame_state` template and saved back by it
  into the port's (every leaf equal, the JAX side's uint32 words
  included), and two frames + save + load + one frame equal to three
  frames straight, bitwise.  No JAX frame is rendered here.
- `DeviceMonitor` on the CPU: host RSS only.
"""
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import eidola_tpu.models.scenes as JS
import eidola_tpu.render.config as JC
import eidola_tpu.render.frame as JF
import eidola_tpu.utils.checkpoint as JK
from eidola_tpu_torch import interop
from eidola_tpu_torch.app import viewer as V
from eidola_tpu_torch.models.scenes import cornell_box
from eidola_tpu_torch.render.config import (RenderConfig, default_params,
                                            default_tonemap)
from eidola_tpu_torch.render.frame import init_frame_state, make_step
from eidola_tpu_torch.scene.camera import CameraManipulator
from eidola_tpu_torch.scene.hdr import write_hdr
from eidola_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from eidola_tpu_torch.utils.monitor import DeviceMonitor
from eidola_tpu_torch.utils.png import decode_png

from test_torch_scene_io import _make_test_glb

torch.set_num_threads(2)
DI = dict(width=32, height=32, denoise=False, indirect_enabled=False)


def _vs():
    scene, cam = cornell_box(device="cpu")
    cfg = RenderConfig(width=32, height=32)
    manip = CameraManipulator(cam.pos.numpy(), np.asarray([0.0, 1.0, 0.0]),
                              aspect=1.0, device="cpu")
    manip._cam = cam
    vs = V.ViewerState(scene, cam, cfg, default_params(device="cpu"),
                       default_tonemap(device="cpu"), manip)
    vs.scene_name = "cornell"
    return vs


class TestViewerState:
    def test_orbit_moves_camera(self):
        vs = _vs()
        before = vs.cam.pos.numpy().copy()
        vs.apply_input({"type": "orbit", "dx": 50, "dy": 10})
        assert np.abs(vs.cam.pos.numpy() - before).max() > 1e-3

    def test_dolly_changes_distance(self):
        vs = _vs()
        pivot = np.asarray([0.0, 1.0, 0.0])
        d0 = np.linalg.norm(vs.cam.pos.numpy() - pivot)
        vs.apply_input({"type": "dolly", "f": 0.5})
        assert np.linalg.norm(vs.cam.pos.numpy() - pivot) < d0

    def test_reset_flag(self):
        vs = _vs()
        vs.apply_input({"type": "reset"})
        assert vs.reset_requested

    def test_pick_recenters_orbit_pivot(self):
        vs = _vs()
        out = vs.apply_pick({"fy": 0.5, "fx": 0.5})
        assert out["hit"] is True
        assert out["tri_id"] >= 0 and out["material_id"] >= 0
        assert out["t"] > 0.0
        np.testing.assert_allclose(vs.manip.center, out["world_pos"],
                                   atol=1e-5)
        assert vs.reset_requested
        center_before = vs.manip.center.copy()
        out2 = vs.apply_pick({"fy": 0.0, "fx": 0.0})
        if not out2["hit"]:
            np.testing.assert_array_equal(vs.manip.center, center_before)

    def test_param_updates_tonemap_and_params(self):
        vs = _vs()
        vs.apply_param({"name": "exposure", "value": 2.0})
        assert float(vs.tm.exposure) == 2.0
        vs.apply_param({"name": "firefly_clamp", "value": 10.0})
        assert float(vs.params.firefly_clamp) == 10.0
        assert vs.params.firefly_clamp.dtype == torch.float32
        vs.apply_param({"name": "dither", "value": 0})
        assert vs.tm.dither.dtype == torch.int64 and int(vs.tm.dither) == 0

    def test_unknown_param_ignored(self):
        vs = _vs()
        before = vs.tm
        vs.apply_param({"name": "nope", "value": 1.0})
        vs.apply_param({"name": "count", "value": 1.0})   # a tuple method
        assert vs.tm is before

    def test_handler_class_builds(self):
        assert callable(V.make_handler(_vs()))

    def test_config_toggle_updates_base_cfg(self):
        vs = _vs()
        assert vs.apply_config({"denoise": False, "max_depth": 1,
                                "debug_mode": 4})
        assert vs.base_cfg.denoise is False
        assert vs.base_cfg.max_depth == 1
        assert vs.base_cfg.debug_mode == 4
        assert vs.reset_requested
        before = vs.base_cfg
        assert not vs.apply_config({"width": 8, "nope": 1})
        assert vs.base_cfg == before

    def test_scene_request_queued(self):
        vs = _vs()
        assert vs.apply_scene({"scene": "cornell"})
        assert vs.pending_scene == {"scene": "cornell"}
        assert not vs.apply_scene({})

    def test_drag_descale(self):
        vs = _vs()
        vs.descale = 2
        assert vs.desired_cfg() == vs.base_cfg
        vs.apply_input({"type": "orbit", "dx": 3, "dy": 0})
        low = vs.desired_cfg()
        assert low.width == 16 and low.height == 16
        assert low.max_depth == vs.base_cfg.max_depth
        vs.apply_input({"type": "end"})
        assert vs.desired_cfg() == vs.base_cfg

    def test_worker_scene_swap(self):
        vs = _vs()
        vs.ready_cfgs.add(vs.base_cfg)
        V._load_scene_request(vs, {"scene": "boxes"})
        assert vs.scene_name == "boxes"
        assert len(vs.ready_cfgs) == 0
        assert vs.reset_requested
        assert vs.counts["triangles"] == int(vs.scene.bvh.n_tris) > 24
        assert vs.base_cfg.env_mode == "sunsky"

    def test_worker_compiles_preview_variant(self, monkeypatch):
        vs = _vs()
        compiled = []

        def fake_compile(vs2, cfg):
            compiled.append(cfg)
            vs2.ready_cfgs.add(cfg)

        monkeypatch.setattr(V, "_compile_step", fake_compile)
        assert V._worker_tick(vs)          # desired config first
        assert vs.desired_cfg() in vs.ready_cfgs
        pcfg = V._descaled(vs.base_cfg, 4)
        vs.want_cfgs.add(pcfg)
        assert V._worker_tick(vs)          # then the queued preview
        assert pcfg in vs.ready_cfgs
        assert not V._worker_tick(vs)      # nothing left to warm up
        assert compiled == [vs.desired_cfg(), pcfg]

    def test_endpoints_drive_state(self):
        vs = _vs()
        srv = ThreadingHTTPServer(("127.0.0.1", 0), V.make_handler(vs))
        port = srv.server_address[1]
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            assert _post(port, "/config", {"denoise": False}) == 200
            assert vs.base_cfg.denoise is False
            assert _post(port, "/scene", {"scene": "cornell"}) == 200
            assert vs.pending_scene == {"scene": "cornell"}
            assert _post(port, "/input", {"type": "orbit", "dx": 2,
                                          "dy": 1}) == 200
            stats = _get_json(port, "/stats")
            assert stats["config"]["denoise"] is False
        finally:
            srv.shutdown()
            srv.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def _post(port, path, body, read=False):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read()) if read else r.status


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _wait(cond, seconds, what):
    t_end = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_viewer_serves_frames_and_swaps_scene(tmp_path):
    """The whole viewer on the CPU: render and worker threads, the HTTP
    server, a .glb + .hdr dropped in through POST /scene."""
    glb = str(tmp_path / "t.glb")
    _make_test_glb()(glb)
    hdr = str(tmp_path / "env.hdr")
    write_hdr(hdr, np.full((8, 16, 3), 0.7, np.float32))
    vs, srv, threads = V.start(["--scene", "cornell", "--size", "32", "32",
                                "--max-depth", "1", "--device", "cpu",
                                "--port", "0"])
    port = srv.server_address[1]
    ts = threading.Thread(target=srv.serve_forever, daemon=True)
    ts.start()
    try:
        _wait(lambda: vs.frame >= 2, 120, "two frames")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png",
                                    timeout=60) as r:
            assert decode_png(r.read()).shape == (32, 32, 4)
        assert _post(port, "/scene", {"scene": glb, "hdr": hdr}) == 200
        _wait(lambda: _get_json(port, "/stats")["scene"] == glb
              and vs.desired_cfg() in vs.ready_cfgs, 120, "the scene swap")
        n = vs.frame
        _wait(lambda: vs.frame >= n + 2, 120, "frames on the new scene")
        stats = _get_json(port, "/stats")
        assert stats["triangles"] == 3 and stats["textures"] == 1
        assert stats["punctual_lights"] == 1
        assert stats["emissive_triangles"] == 1
        assert vs.base_cfg.env_mode == "hdr"
        assert float(vs.params.firefly_clamp) == pytest.approx(
            4.0 * float(vs.scene.env.integral))
        # the emissive triangle, a little below and right of the centre
        pick = _post(port, "/pick", {"fy": 0.59, "fx": 0.53}, read=True)
        assert pick["hit"] and pick["tri_id"] == 2
        assert _post(port, "/config", {"max_depth": 2}) == 200
        _wait(lambda: vs.desired_cfg() in vs.ready_cfgs, 120,
              "the new config warmed up")
        assert _post(port, "/param", {"name": "exposure", "value": 1.5}) \
            == 200
        assert float(vs.tm.exposure) == 1.5
        assert not vs.busy
    finally:
        vs.stop = True
        srv.shutdown()
        srv.server_close()
        for t in threads + [ts]:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads + [ts])


# ---- checkpoints ------------------------------------------------------

def _frames(cfg, n, state=None):
    scene, cam = cornell_box(device="cpu")
    params, tm = default_params(device="cpu"), default_tonemap(device="cpu")
    state = init_frame_state(cfg, cam) if state is None else state
    step = make_step(cfg)
    out = None
    for _ in range(n):
        state, out = step(scene, cam, params, tm, state)
    return state, out


def _leaves_equal(port, ref, path=""):
    if ref is None:
        assert port is None, path
        return
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _leaves_equal(port[k], ref[k], f"{path}.{k}")
        return
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        for name in ref._fields:
            _leaves_equal(getattr(port, name), getattr(ref, name),
                          f"{path}.{name}")
        return
    a, b = np.asarray(port), np.asarray(ref)
    assert a.shape == b.shape, path
    if b.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.astype(np.float32).view(np.int32),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=path)


def test_checkpoint_roundtrip(tmp_path):
    _, cam = cornell_box(device="cpu")
    cfg = RenderConfig(width=32, height=32)
    st = init_frame_state(cfg, cam)._replace(
        frame_idx=torch.tensor(7), accum_count=torch.tensor(3.0))
    p = str(tmp_path / "ckpt.npz")
    save_pytree(p, st)
    back = load_pytree(p, init_frame_state(cfg, cam))
    assert int(back.frame_idx) == 7 and back.frame_idx.dtype == torch.int64
    assert float(back.accum_count) == 3.0
    assert back.gbuf.depth.shape == st.gbuf.depth.shape
    _leaves_equal(interop.to_numpy(back), interop.to_numpy(st))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    _, cam = cornell_box(device="cpu")
    p = str(tmp_path / "ckpt.npz")
    save_pytree(p, init_frame_state(RenderConfig(width=32, height=32), cam))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(p, init_frame_state(RenderConfig(width=64, height=64),
                                        cam))
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(p, {"a": torch.zeros(2)})


def test_checkpoint_crosses_packages(tmp_path):
    """Port state (two frames) -> npz -> JAX load_pytree into JAX's own
    template -> JAX save_pytree -> port load_pytree: equal at every step."""
    cfg = RenderConfig(**DI)
    state, _ = _frames(cfg, 2)
    assert int(state.frame_idx) == 2
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_pytree(p1, state)
    _, jcam = JS.cornell_box()
    jstate = JK.load_pytree(p1, JF.init_frame_state(JC.RenderConfig(**DI),
                                                    jcam))
    assert int(jstate.frame_idx) == 2
    _leaves_equal(interop.to_numpy(state), jstate)
    JK.save_pytree(p2, jstate)
    _, cam = cornell_box(device="cpu")
    back = load_pytree(p2, init_frame_state(cfg, cam))
    _leaves_equal(interop.to_numpy(back), interop.to_numpy(state))


def test_checkpoint_resume_equals_straight_run(tmp_path):
    cfg = RenderConfig(**DI)
    state2, _ = _frames(cfg, 2)
    p = str(tmp_path / "s.npz")
    save_pytree(p, state2)
    _, cam = cornell_box(device="cpu")
    resumed, out_r = _frames(cfg, 1, load_pytree(p, init_frame_state(cfg,
                                                                      cam)))
    straight, out_s = _frames(cfg, 3)
    assert int(resumed.frame_idx) == 3
    for k in ("image", "hdr"):
        assert torch.equal(out_r[k], out_s[k]), k
    _leaves_equal(interop.to_numpy(resumed), interop.to_numpy(straight))


def test_device_monitor_cpu():
    mon = DeviceMonitor("cpu", interval_s=0.0)
    mon.refresh()
    mon.refresh()
    assert len(mon.host_rss) == 2 and mon.host_rss[-1] > 0
    assert not mon.bytes_in_use and mon.bytes_limit is None
    assert mon.summary().startswith("device cpu: host RSS ")
