"""Interactive viewer: live camera, pipeline toggles, scene hot-swap
(port of eidola_tpu/app/viewer.py).

The reference's interactive surface (GLFW window + ImGui panels + camera
manipulator, ref src/main.cpp:200-264 per-frame input poll,
src/sample_gui.cpp:119-206 live RtxState toggles,
src/sample_example.cpp:114-158 file-drop loader thread + m_busy gate) as
a render thread that steps frames continuously, a worker thread that
loads scenes and warms up configs, and a stdlib HTTP server that streams
the latest frame and feeds input back.

Three tiers of mutability (SURVEY §5.6):
- RenderParams / TonemapParams fields: POST /param, taken by the next
  frame (push-constant analog).
- RenderConfig fields (ReSTIR mode, denoise, max depth, debug channel,
  ...): POST /config.  Where the JAX viewer compiled the new step on the
  worker, the worker here renders one warm-up frame of it (on the first
  use of a kernel that builds it); the render thread switches only to a
  config that is ready, so a config that fails is reported on `busy`
  ("compile failed: ...") and never shown.
- scene / HDR environment: POST /scene, loaded and warmed up on the
  worker, swapped atomically (ref sample_example.cpp:114-158 onFileDrop).

The warm-up runs on the worker, not as the render thread's first frame
on the new scene: the render thread keeps serving the old scene while
the new one loads and warms up, and a scene or config that fails leaves
it untouched.  It costs one extra frame per swap, with two frames' state
on the device while it runs.  Both threads launch on the thread's
current stream, the device's default stream, so their kernels run in
order on the device.

Interactive descaling: while the mouse drags, frames render at
extent/descale and upscale for display; releasing restores full extent
(ref sample_example.cpp:396-399).  When a full frame takes longer than
EIDOLA_VIEW_PREVIEW_MS (500), a frame at a quarter of the extent is
served before each full one (the progressive preview).

    python -m eidola_tpu_torch.app.viewer --scene x.glb -e env.hdr \
        --size 1920 1080 --port 8812

Endpoints: GET / (canvas UI), GET /frame.png, GET /stats,
POST /input (orbit/pan/dolly/reset/end), POST /param, POST /config,
POST /scene, POST /pick (double-click: trace the pixel ray, report the
hit, recenter the orbit pivot, ref sample_example.cpp:456-497).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
import traceback
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..models.scenes import load_scene
from ..render.config import RenderConfig, default_params, default_tonemap
from ..render.frame import init_frame_state, make_step, reset_accumulation
from ..render.picker import pick
from ..scene.camera import CameraManipulator
from ..scene.data import attach_env, env_params
from ..scene.hdr import build_env_map, load_hdr
from ..utils.png import encode_png
from .headless import _pivot_from_cam, alpha_geometry, set_numerics, to_u8

# RenderConfig fields the GUI may flip live (ref sample_gui.cpp:119-206)
_CONFIG_FIELDS = {
    "max_depth": int,
    "restir_mode": int,
    "denoise": bool,
    "denoise_direct_levels": int,
    "denoise_indirect_levels": int,
    "indirect_enabled": bool,
    "debug_mode": int,
    "accumulate": bool,
    "spatial_rounds": int,
    "tonemap_kind": int,
    "primary_seed": bool,
}

_PAGE = """<!doctype html>
<html><head><title>eidola_tpu_torch viewer</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:16px }
#frame { image-rendering:pixelated; border:1px solid #444; cursor:grab }
#bar { margin:8px 0 } button,input,select { background:#222; color:#ddd;
border:1px solid #555; margin-right:6px }
#busy { color:#fa0 }
</style></head><body>
<div id="bar">
 <b>eidola_tpu_torch</b> <span id="stats"></span> <span id="busy"></span><br>
 drag = orbit &middot; shift-drag = pan &middot; wheel = dolly &middot;
 <button onclick="post('/input',{type:'reset'})">reset accum</button>
 exposure <input id="expo" type="range" min="-3" max="3" step="0.1"
  value="0" oninput="post('/param',{name:'exposure',
  value:Math.pow(2,this.value)})">
 <br>
 <label><input type="checkbox" id="denoise" checked
  onchange="post('/config',{denoise:this.checked})">denoise</label>
 <label><input type="checkbox" id="pseed"
  onchange="post('/config',{primary_seed:this.checked})">seed</label>
 restir <select id="restir"
  onchange="post('/config',{restir_mode:+this.value})">
  <option value="0">off</option><option value="1">RIS</option>
  <option value="2">spatial</option>
  <option value="3" selected>temporal</option>
  <option value="4">spatiotemporal</option></select>
 debug <select id="debug" onchange="post('/config',{debug_mode:+this.value})">
  <option value="0" selected>none</option><option value="1">direct</option>
  <option value="2">indirect</option><option value="3">baseColor</option>
  <option value="4">normal</option><option value="5">depth</option>
  <option value="6">metallic</option><option value="7">emissive</option>
  <option value="8">roughness</option><option value="9">texcoord</option>
 </select>
 depth <input id="depth" type="number" min="1" max="8" value="3"
  style="width:3em" onchange="post('/config',{max_depth:+this.value})">
 <br>
 scene <input id="scene" size="28" placeholder="name or /path/to.glb">
 <button onclick="post('/scene',{scene:
  document.getElementById('scene').value})">load</button>
 hdr <input id="hdr" size="20" placeholder="/path/to.hdr">
 <button onclick="post('/scene',{hdr:
  document.getElementById('hdr').value})">set env</button>
</div>
<img id="frame" draggable="false">
<script>
const img = document.getElementById('frame');
function refresh(){ img.src = '/frame.png?' + Date.now(); }
img.onload = () => setTimeout(refresh, 60);
img.onerror = () => setTimeout(refresh, 400);
refresh();
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('stats').textContent =
    ` ${s.scene} ${s.width}x${s.height} frame ${s.frame} ` +
    `${s.fps.toFixed(1)} fps`;
  document.getElementById('busy').textContent = s.busy ? '[' + s.busy + ']' : '';
}, 1000);
function post(u, body){ fetch(u, {method:'POST', body:JSON.stringify(body)}); }
let drag = null;
img.onmousedown = e => { drag = [e.clientX, e.clientY, e.shiftKey]; };
window.onmouseup = () => {
  if (drag) post('/input', {type:'end'});
  drag = null;
};
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY, drag[2]];
  post('/input', drag[2] ? {type:'pan', dx:dx, dy:dy}
                         : {type:'orbit', dx:dx, dy:dy});
};
img.onwheel = e => { e.preventDefault();
  post('/input', {type:'dolly', f: e.deltaY > 0 ? 1.1 : 0.9}); };
img.ondblclick = async e => {
  const r = img.getBoundingClientRect();
  const res = await fetch('/pick', {method:'POST', body:JSON.stringify(
    {fy:(e.clientY - r.top) / r.height, fx:(e.clientX - r.left) / r.width})});
  const p = await res.json();
  document.getElementById('busy').textContent = p.hit
    ? `picked tri ${p.tri_id} mat ${p.material_id} t=${p.t.toFixed(3)}`
    : 'pick: miss';
};
</script></body></html>"""


def _descaled(cfg, d: int):
    """Config at extent/d (multiples of the 8x16 packet tile so the ray
    packets stay dense), ref sample_example.cpp:396-399."""
    if d <= 1:
        return cfg
    w = max((cfg.width // d) // 16 * 16, 16)
    h = max((cfg.height // d) // 16 * 16, 16)
    return dataclasses.replace(cfg, width=w, height=h)


def _scene_counts(scene) -> dict:
    """The /stats scene panel (ref sample_gui.cpp:350-383), read from the
    device once per scene, so that no request waits on a frame."""
    return {
        "triangles": int(scene.bvh.n_tris),
        "materials": int(scene.materials.base_color.shape[0]),
        "textures": int(scene.textures.data.shape[0]),
        "punctual_lights": int(scene.lights.num_punc),
        "emissive_triangles": int(scene.lights.num_trig),
    }


class ViewerState:
    """Shared state between the render thread, the worker thread (scene
    loads + warm-up frames) and the HTTP handlers."""

    def __init__(self, scene, cam, cfg, params, tm, manip, descale: int = 1):
        self.scene = scene
        self.device = cam.pos.device
        self.base_cfg = cfg          # user-selected config
        self.params = params
        self.tm = tm
        self.manip = manip
        self.cam = cam
        self.descale = descale       # interaction descale factor (1 = off)
        self.interacting = False
        self.last_input_t = 0.0
        self.lock = threading.Lock()
        self.png: bytes = b""
        self.frame = 0               # full frames served
        self.accum = 0.0             # accumulation count of the last one
        self.preview_frames = 0
        self.fps = 0.0
        self.reset_requested = False
        self.stop = False
        self.scene_name = ""
        self.counts = _scene_counts(scene)
        # worker plumbing
        self.busy: str = ""          # m_busy analog ("" = idle)
        self.ready_cfgs: set = set()  # configs warmed up on this scene
        self.pending_scene: dict | None = None
        # progressive preview: the render loop asks the worker to warm up
        # the descaled variant, and serves it when a full frame takes
        # longer than preview_ms
        self.want_cfgs: set = set()
        self.preview_ms = float(os.environ.get("EIDOLA_VIEW_PREVIEW_MS", "500"))
        # recent timings on the host clock (ms): full frames (the step and
        # the image's copy to the host), their PNG encode, preview frames
        # (step, copy and encode), warm-ups; and the last load (s)
        self.times = {k: deque(maxlen=64)
                      for k in ("full", "preview", "png", "warm")}
        self.load_s = 0.0

    # -- desired active config ---------------------------------------------
    def desired_cfg(self):
        with self.lock:
            base = self.base_cfg
            inter = self.interacting
            if inter and time.time() - self.last_input_t > 0.5:
                self.interacting = inter = False  # missed mouse-up safety
        return _descaled(base, self.descale) if inter else base

    # -- HTTP-facing mutations ----------------------------------------------
    def apply_input(self, msg: dict):
        with self.lock:
            t = msg.get("type")
            if t == "orbit":
                self.cam = self.manip.orbit(-float(msg.get("dx", 0)) * 0.008,
                                            float(msg.get("dy", 0)) * 0.008)
            elif t == "pan":
                self.cam = self.manip.pan(-float(msg.get("dx", 0)) * 0.002,
                                          float(msg.get("dy", 0)) * 0.002)
            elif t == "dolly":
                self.cam = self.manip.dolly(float(msg.get("f", 1.0)))
            elif t == "reset":
                self.reset_requested = True
            if t in ("orbit", "pan", "dolly") and self.descale > 1:
                self.interacting = True
                self.last_input_t = time.time()
            elif t == "end":
                self.interacting = False

    def apply_pick(self, msg: dict) -> dict:
        """Double-click pick: trace the ray under fractional image coords
        (fy, fx in 0..1), report the hit, and recenter the orbit pivot on
        the picked world position (ref sample_example.cpp:456-497)."""
        fy = min(max(float(msg.get("fy", 0.5)), 0.0), 1.0)
        fx = min(max(float(msg.get("fx", 0.5)), 0.0), 1.0)
        with self.lock:
            scene, cam = self.scene, self.cam
            h, w = self.base_cfg.height, self.base_cfg.width
        res = pick(scene, cam, h, w, fy * (h - 1), fx * (w - 1))
        out = {
            "hit": bool(res.hit),
            "tri_id": int(res.tri_id),
            "material_id": int(res.material_id),
            "t": float(res.t),
            "world_pos": [float(v) for v in res.world_pos],
        }
        if res.hit:
            with self.lock:
                self.cam = self.manip.recenter(res.world_pos)
                self.reset_requested = True
        return out

    def apply_param(self, msg: dict):
        """Dynamic parameter update, the push-constant analog of the
        reference's GUI sliders (sample_gui.cpp:119-206); unknown names
        are ignored."""
        name = msg.get("name")
        with self.lock:
            for attr in ("tm", "params"):
                tree = getattr(self, attr)
                if name in tree._fields:
                    old = getattr(tree, name)
                    setattr(self, attr, tree._replace(**{name: torch.tensor(
                        msg.get("value"), dtype=old.dtype,
                        device=old.device)}))
                    return

    def apply_config(self, msg: dict) -> bool:
        """Static-config change: swap base_cfg; the worker warms the new
        variant up and the render thread switches once it is ready
        (reference pipeline rebuild analog, sample_gui.cpp:119-206)."""
        fields = {k: _CONFIG_FIELDS[k](v) for k, v in msg.items()
                  if k in _CONFIG_FIELDS}
        if not fields:
            return False
        with self.lock:
            self.base_cfg = dataclasses.replace(self.base_cfg, **fields)
            self.reset_requested = True
        return True

    def apply_scene(self, msg: dict) -> bool:
        """Queue a scene (.glb/.gltf or registry name) or HDR environment
        swap for the worker thread (ref sample_example.cpp:114-158)."""
        if not (msg.get("scene") or msg.get("hdr")):
            return False
        with self.lock:
            self.pending_scene = dict(msg)
        return True


def _load_scene_request(vs: ViewerState, req: dict):
    """Worker-side scene/HDR load and swap (the detached loader thread
    analog); the render thread keeps the old scene until the new one's
    config is warmed up."""
    t0 = time.perf_counter()
    name = req.get("scene")
    hdr = req.get("hdr")
    env = build_env_map(load_hdr(hdr), device=vs.device) if hdr else None
    if name:
        scene, cam = load_scene(name, device=vs.device)
        if env is not None:
            scene = attach_env(scene, env)
        counts = _scene_counts(scene)
        with vs.lock:
            if env is not None:
                vs.params = env_params(vs.params, env)
            vs.scene = scene
            vs.counts = counts
            vs.cam = cam
            vs.manip.eye = cam.pos.cpu().numpy().astype(np.float64)
            vs.manip.center = np.asarray(_pivot_from_cam(cam), np.float64)
            vs.manip._cam = cam
            vs.scene_name = name
            vs.base_cfg = dataclasses.replace(
                vs.base_cfg,
                env_mode="hdr" if scene.env is not None else "sunsky",
                alpha_geometry=alpha_geometry(scene))
            vs.reset_requested = True
            vs.ready_cfgs.clear()   # a new scene: configs warm up again
            vs.want_cfgs.clear()    # (the render loop asks for its preview)
    elif env is not None:
        with vs.lock:
            scene = attach_env(vs.scene, env)
            vs.scene = scene
            vs.params = env_params(vs.params, env)
            vs.base_cfg = dataclasses.replace(vs.base_cfg, env_mode="hdr")
            vs.reset_requested = True
            vs.ready_cfgs.clear()
            vs.want_cfgs.clear()
    if vs.device.type == "cuda":
        torch.cuda.synchronize(vs.device)
    vs.load_s = time.perf_counter() - t0


def _compile_step(vs: ViewerState, cfg):
    """Worker-side warm-up of a config: one throwaway frame on the current
    scene (the JAX viewer's compile), so the render thread switches only
    to a config that renders."""
    t0 = time.perf_counter()
    with vs.lock:
        scene, cam, params, tm = vs.scene, vs.cam, vs.params, vs.tm
    _, out = make_step(cfg)(scene, cam, params, tm,
                            init_frame_state(cfg, cam))
    out["image"].cpu()
    with vs.lock:
        if vs.scene is scene:
            vs.ready_cfgs.add(cfg)
    vs.times["warm"].append((time.perf_counter() - t0) * 1e3)


def _worker_tick(vs: ViewerState) -> bool:
    """Run one pending worker job (scene load or warm-up).  Returns True
    if something was done."""
    with vs.lock:
        req = vs.pending_scene
        vs.pending_scene = None
    if req is not None:
        vs.busy = "loading scene"
        try:
            _load_scene_request(vs, req)
        except Exception as e:  # surface the error, keep rendering
            traceback.print_exc()
            vs.busy = f"load failed: {e}"
            time.sleep(1.0)
        else:
            vs.busy = ""
        return True
    desired = vs.desired_cfg()
    with vs.lock:
        needs = desired not in vs.ready_cfgs
        extra = next(iter(vs.want_cfgs - vs.ready_cfgs), None)
    if needs or extra is not None:
        vs.busy = "compiling"
        try:
            _compile_step(vs, desired if needs else extra)
        except Exception as e:
            traceback.print_exc()
            vs.busy = f"compile failed: {e}"
            time.sleep(1.0)
        else:
            vs.busy = ""
        return True
    return False


def worker_loop(vs: ViewerState):
    while not vs.stop:
        # the render thread warms its first config up itself (and builds
        # the kernels); the worker starts after that first frame
        if vs.frame == 0 or not _worker_tick(vs):
            time.sleep(0.05)


def _encode_png(img01: np.ndarray, upscale: int = 1) -> bytes:
    a = to_u8(img01)
    if upscale > 1:
        a = np.repeat(np.repeat(a, upscale, axis=0), upscale, axis=1)
    return encode_png(a)


def render_loop(vs: ViewerState):
    """Continuous frame stepping (the while(!glfwWindowShouldClose) loop,
    ref main.cpp:200-264) on whichever ready config matches the desired
    one; keeps stepping the old one while the worker warms up the new."""
    active = vs.desired_cfg()
    _compile_step(vs, active)
    step = make_step(active)
    with vs.lock:
        state = init_frame_state(active, vs.cam)
        scene_obj = vs.scene
    t_last = time.perf_counter()
    last_full_ms = 0.0
    while not vs.stop:
        desired = vs.desired_cfg()
        with vs.lock:
            ready = desired in vs.ready_cfgs
            cam, params, tm = vs.cam, vs.params, vs.tm
            scene_now = vs.scene
            if vs.reset_requested:
                vs.reset_requested = False
                state = reset_accumulation(state)
        if ready and (desired != active or scene_now is not scene_obj):
            active = desired
            step = make_step(active)
            state = init_frame_state(active, cam)
            scene_obj = scene_now

        # progressive preview: when the full frame costs more than the
        # threshold, serve a fresh descaled frame (1/16 of the rays)
        # first, so the display follows the camera and the params while
        # the full frame computes (ref interactive descaling,
        # sample_example.cpp:396-399, extended to static views)
        if last_full_ms > vs.preview_ms and active == vs.base_cfg:
            pcfg = _descaled(active, 4)
            with vs.lock:
                p_ready = pcfg in vs.ready_cfgs
                if not p_ready:
                    vs.want_cfgs.add(pcfg)
            if p_ready and pcfg != active:
                t0 = time.perf_counter()
                _, pout = make_step(pcfg)(scene_obj, cam, params, tm,
                                          init_frame_state(pcfg, cam))
                ppng = _encode_png(pout["image"].cpu().numpy(),
                                   max(vs.base_cfg.width // pcfg.width, 1))
                with vs.lock:
                    vs.png = ppng
                    vs.preview_frames += 1
                vs.times["preview"].append((time.perf_counter() - t0) * 1e3)
        t_full0 = time.perf_counter()
        state, out = step(scene_obj, cam, params, tm, state)
        img = out["image"].cpu().numpy()
        accum = float(state.accum_count)
        last_full_ms = (time.perf_counter() - t_full0) * 1e3
        up = vs.base_cfg.width // active.width if active != vs.base_cfg else 1
        t_png0 = time.perf_counter()
        png = _encode_png(img, max(up, 1))
        now = time.perf_counter()
        with vs.lock:
            vs.png = png
            vs.frame += 1
            vs.accum = accum
            dt = now - t_last
            vs.fps = 0.9 * vs.fps + 0.1 * (1.0 / max(dt, 1e-6))
        vs.times["full"].append(last_full_ms)
        vs.times["png"].append((now - t_png0) * 1e3)
        t_last = now


def _render_thread(vs: ViewerState):
    """The render thread's boundary: a frame that raises stops the loop
    and is reported on `busy`."""
    try:
        render_loop(vs)
    except Exception as e:
        traceback.print_exc()
        vs.busy = f"render failed: {e}"


def make_handler(vs: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, _PAGE.encode())
            elif path == "/frame.png":
                with vs.lock:
                    png = vs.png
                if png:
                    self._send(200, png, "image/png")
                else:
                    self._send(503, b"rendering first frame")
            elif path == "/stats":
                # scene statistics panel analog (ref sample_gui.cpp:350-383)
                with vs.lock:
                    cfg = vs.base_cfg
                    body = json.dumps({
                        "scene": vs.scene_name,
                        "width": cfg.width,
                        "height": cfg.height,
                        "frame": vs.frame,
                        "accum_frames": vs.accum,
                        "fps": vs.fps,
                        "busy": vs.busy,
                        "config": {k: getattr(cfg, k) for k in _CONFIG_FIELDS},
                        **vs.counts,
                    }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._send(400, b"bad json")
                return
            if self.path == "/pick":
                self._send(200, json.dumps(vs.apply_pick(msg)).encode(),
                           "application/json")
                return
            if self.path == "/input":
                vs.apply_input(msg)
            elif self.path == "/param":
                vs.apply_param(msg)
            elif self.path == "/config":
                if not vs.apply_config(msg):
                    self._send(400, b"no known config field")
                    return
            elif self.path == "/scene":
                if not vs.apply_scene(msg):
                    self._send(400, b"need scene or hdr")
                    return
            else:
                self._send(404, b"not found")
                return
            self._send(200, b"ok", "text/plain")

    return Handler


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eidola_tpu_torch.app.viewer")
    p.add_argument("-f", "--scene", default="cornell",
                   help="registry scene name or .gltf/.glb path")
    p.add_argument("-e", "--env", default=None,
                   help=".hdr environment map (default: the scene's own)")
    p.add_argument("--size", type=int, nargs="+", default=[256])
    p.add_argument("--port", type=int, default=8812)
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--descale", type=int, default=2,
                   help="render-extent divisor while dragging (1 = off)")
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = run until killed)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def start(argv=None):
    """Load the scene, start the render and worker threads, and bind the
    HTTP server on 127.0.0.1:--port (0 picks a free port) without serving
    yet.  Returns (ViewerState, server, threads); the caller serves, then
    sets `vs.stop`, shuts the server down and joins the threads."""
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    set_numerics()
    w = args.size[0]
    h = args.size[1] if len(args.size) > 1 else args.size[0]
    scene, cam = load_scene(args.scene, device=device)
    if args.env:
        scene = attach_env(scene, build_env_map(load_hdr(args.env),
                                                device=device))
    cfg = RenderConfig(
        width=w, height=h, max_depth=args.max_depth,
        env_mode="hdr" if scene.env is not None else "sunsky",
        traversal_max_steps=2048, alpha_geometry=alpha_geometry(scene))
    manip = CameraManipulator(cam.pos.cpu().numpy(), _pivot_from_cam(cam),
                              aspect=w / h, device=device)
    manip._cam = cam
    params = default_params(device=device)
    if scene.env is not None:
        params = env_params(params, scene.env)
    vs = ViewerState(scene, cam, cfg, params, default_tonemap(device=device),
                     manip, descale=args.descale)
    vs.scene_name = args.scene
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(vs))
    threads = [threading.Thread(target=_render_thread, args=(vs,),
                                daemon=True),
               threading.Thread(target=worker_loop, args=(vs,), daemon=True)]
    for t in threads:
        t.start()
    return vs, srv, threads


def serve(argv=None):
    vs, srv, threads = start(argv)
    frames = build_argparser().parse_args(argv).frames
    host, port = srv.server_address[:2]
    cfg = vs.base_cfg
    print(f"viewer: http://{host}:{port}/  ({vs.scene_name} "
          f"{cfg.width}x{cfg.height} on {vs.device})")
    try:
        if frames:
            # bounded mode for tests/CI: serve until N frames rendered
            srv.timeout = 0.2
            while vs.frame < frames and not vs.busy.startswith("render"):
                srv.handle_request()
            return vs
        srv.serve_forever()
    finally:
        vs.stop = True
        srv.server_close()
        for t in threads:
            t.join(timeout=60)


if __name__ == "__main__":
    serve()
