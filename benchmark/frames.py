"""The cell's frames on the program under test (eidola_tpu_torch): its
scene, its RenderConfig, the camera path and the loop of the traffic mix,
and the timed window (after eidola_tpu_torch/bench.py:249-296: one
synchronize and the host clock on each side of the window, no sync
inside it in a pipelined mix, a CUDA event at every frame boundary).

The traffic mix (traffic/<mix>.json) sets:
  warmup_frames       frames rendered before the window (set-up)
  orbit_rad           0: the camera held; else it orbits this many
                      radians a frame after the first, as
                      app/headless.py:run moves it
  restir_mode         "none" | "ris" | "spatial" | "temporal" |
                      "spatiotemporal"
  shadow_cadence      RenderConfig.shadow_cadence
  primary_seed        RenderConfig.primary_seed
  loop                "pipelined": frames enqueued back to back;
                      "closed": each frame's LDR image is copied to the
                      host before the next frame starts (a viewer's loop)
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

RESTIR = {"none": 0, "ris": 1, "spatial": 2, "temporal": 3,
          "spatiotemporal": 4}
LOOPS = ("pipelined", "closed")


def config_fields(config: dict, traffic: dict) -> dict:
    """RenderConfig fields of a configuration under a traffic mix, but for
    the two that the loaded scene decides (alpha_geometry, env_mode)."""
    if traffic["loop"] not in LOOPS:
        raise ValueError(f"traffic loop {traffic['loop']!r}: want one of "
                         f"{LOOPS}")
    return dict(config["render"], width=int(config["width"]),
                height=int(config["height"]),
                restir_mode=RESTIR[traffic["restir_mode"]],
                shadow_cadence=int(traffic["shadow_cadence"]),
                primary_seed=bool(traffic["primary_seed"]))


class Window(NamedTuple):
    frames: int
    window_s: float          # host clock, synchronize to synchronize
    frame_ms: list           # each frame's ms between frame boundaries


class Frames:
    """One cell's frame loop on the program.  `frame()` renders the next
    frame of the camera path and keeps its camera (`cam`), the state it
    started from (`prev`) and its outputs (`out`): what the correctness
    check reads of the window's last frame."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from eidola_tpu_torch.app.headless import (alpha_geometry,
                                                   set_numerics)
        from eidola_tpu_torch.models.scenes import load_scene
        from eidola_tpu_torch.render.config import (RenderConfig,
                                                    default_tonemap)
        from eidola_tpu_torch.render.frame import (init_frame_state,
                                                   make_step)

        self.device = torch.device(device)
        set_numerics()
        self.scene, self.cam0 = load_scene(config["scene"],
                                           device=self.device,
                                           **config.get("scene_args", {}))
        self.cfg = RenderConfig(
            **config_fields(config, traffic),
            alpha_geometry=alpha_geometry(self.scene),
            env_mode="hdr" if self.scene.env is not None else "sunsky")
        self.tm = default_tonemap(device=self.device)
        self.orbit = float(traffic["orbit_rad"])
        if self.orbit:
            from eidola_tpu_torch.app.headless import _pivot_from_cam
            self.pivot = _pivot_from_cam(self.cam0)
        self.closed = traffic["loop"] == "closed"
        self.step = make_step(self.cfg)
        self.init_state = lambda: init_frame_state(self.cfg, self.cam0)
        self.timer = None           # a StageTimer in a traced window
        self.restart(seed)

    def restart(self, seed: int) -> None:
        """Back to frame 0 of the camera path under `seed`, from a fresh
        state (the calibration renders several seeds on one load)."""
        from eidola_tpu_torch.render.config import default_params

        self.params = default_params(seed, device=self.device)
        self.state = self.init_state()
        self.index = 0
        self.prev = self.out = self.cam = None
        if self.orbit:
            from eidola_tpu_torch.scene.camera import CameraManipulator

            self.manip = CameraManipulator(
                self.cam0.pos.cpu().numpy(), self.pivot,
                aspect=self.cfg.width / self.cfg.height, device=self.device)
            self.manip._cam = self.cam0   # the scene's framing until a move

    def camera(self, i: int):
        if i and self.orbit:
            return self.manip.orbit(self.orbit, 0.0)
        return self.cam0

    def frame(self):
        cam = self.cam = self.camera(self.index)
        self.prev = self.state
        self.state, self.out = self.step(self.scene, cam, self.params,
                                         self.tm, self.state,
                                         timer=self.timer)
        self.index += 1
        if self.closed:
            self.out["image"].cpu()   # app/viewer.py's read-back, synced
        return self.out

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, frames: int):
        for _ in range(frames):
            self.frame()
            self.sync()

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def window(self, seconds: float) -> Window:
        """Frames for `seconds` of the host clock: the window closes at
        the first frame boundary past it, then waits for the device."""
        cuda = self.device.type == "cuda"
        self.sync()
        t0 = time.perf_counter()
        marks = [self._mark()]
        n = 0
        while True:
            self.frame()
            marks.append(self._mark())
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        window_s = time.perf_counter() - t0
        frame_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
                    for a, b in zip(marks, marks[1:])]
        return Window(frames=n, window_s=window_s, frame_ms=frame_ms)
