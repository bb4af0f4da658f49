"""The plain reference the benchmark holds the program's frame to.

It is written apart from the program, in plain PyTorch, and imports
nothing of it: each module says what it was written from.

  scene.py      the cell's input, made by the benchmark: world-space
                triangles of the scene scenes/<name>.py, found by the
                configuration's `scene` (a new scene of the reference is
                a new file); scenes/bistro_standin.py, the procedural
                stand-in from its fixed seeds
  light.py      the scene's light, lights/<kind>.py, found by the kind
                the scene names (a new light is a new file):
                lights/sunsky.py, the sun's cone and the sky's radiance
  camera.py     the camera path and the primary rays (rng.py: the
                frame's seeds and draws)
  trace.py      every ray against every triangle, with the leaf cards'
                alpha test and the HitTest march: no BVH
  image.py      the a-trous denoiser, compose and post
  precision.py  float64, or TF32 for the check's control

`Reference` answers, for a frame of the cell, what the program's frame
must give: the primary rays; the nearest hit of any ray, however far,
or its occlusion within its span; the light sample that a lane's random
words draw (its direction, pdf and radiance), and the light's radiance
and pdf along any direction; the denoised image of a noisy one;
the accumulated HDR and the LDR image of the denoised light.  It does
not re-render the frame's shading: the check hands it the rays, the
random words of each light draw, the noisy light and the accumulation
history that the program's frame had (check.py says which), so K1's and
K2's shading and resampling, and a shadow ray's far end, are still the
program's.
"""
from __future__ import annotations

import torch

from . import camera, image, rng
from .light import make as make_light
from .precision import Precision
from .scene import make as make_scene
from .trace import INF, Tracer

ALPHA_HOPS = 4          # RenderConfig.alpha_hops, the renderer's default


class Reference:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False, scene=None):
        render = config["render"]
        for key, want in (("denoise", True), ("tonemap_kind", 0),
                          ("accumulate", True), ("modulate_albedo", True),
                          ("debug_mode", 0)):
            if render.get(key, want) != want:
                raise ValueError(f"the reference renders {key}={want!r}, "
                                 f"the configuration {render[key]!r}")
        self.device = torch.device(device)
        self.num = Precision(control)
        self.width, self.height = int(config["width"]), int(config["height"])
        self.levels = (int(render["denoise_direct_levels"]),
                       int(render["denoise_indirect_levels"]))
        self.scene = scene if scene is not None else make_scene(
            config["scene"], device=self.device,
            **config.get("scene_args", {}))
        if self.scene.emitters:
            raise ValueError(
                f"the scene has {self.scene.emitters} triangle or punctual "
                f"emitters; the reference samples only its light, "
                f"{self.scene.light[0]!r}, until a file of lights/ brings "
                f"them")
        kind, light_args = self.scene.light
        self.light = make_light(kind, device=self.device, num=self.num,
                                **light_args)
        self.path = camera.CameraPath(self.scene.view,
                                      float(traffic["orbit_rad"]),
                                      self.width, self.height, self.device)
        self.tracer = Tracer(self.scene, render.get("alpha_hops", ALPHA_HOPS),
                             self.num)
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        self.time_word = int(seed) & rng.M32

    def frame_word(self, index: int) -> int:
        """The salt of frame `index`'s seeds."""
        return (self.time_word + index) & rng.M32

    def rays(self, index: int):
        return camera.primary_rays(self.path, index, self.frame_word(index),
                                   self.height, self.width, self.num)

    def closest(self, o, d, t_min, t_max):
        """The nearest hit beyond `t_min`, with no far end: a closest-hit
        ray of the frame reaches past the scene, so a far end that the
        program set short of the true hit (a seeded t_max) shows as a hit
        missed.  `t_max` is the program's, and is not used."""
        return self.tracer.closest(o, d, t_min, torch.full_like(t_max, INF))

    def occluded(self, o, d, t_min, t_max):
        return self.tracer.occluded(o, d, t_min, t_max)

    def draw(self, state):
        """(wi, pdf, li) of the light sample that the words after `state`
        draw: the selection word, then four for the light, which is
        chosen with probability 1 (the scene has no other emitter)."""
        state, _ = rng.rand(state)
        u = []
        for _ in range(4):
            state, x = rng.rand(state)
            u.append(x)
        return self.light.sample(*u)

    def denoise(self, img, pos, nrm, mat, valid, indirect: bool):
        return image.denoise(img, pos, nrm, mat, valid,
                             self.levels[indirect],
                             image.INDIRECT if indirect else image.DIRECT,
                             self.num)

    def finish(self, direct_ldr, indirect_ldr, emission, albedo,
               prev_accum, prev_count, index: int):
        """(accumulated HDR, its count, LDR image) of frame `index` from
        its denoised light and the accumulation before it, which a camera
        move resets."""
        num = self.num
        hdr = image.compose(direct_ldr, indirect_ldr, emission, albedo, num)
        if self.path.moved(index):
            prev_accum, prev_count = torch.zeros_like(hdr), 0.0
        accum = num(num(prev_accum) + hdr)
        count = float(prev_count) + 1.0
        shown = num(accum / max(count, 1.0))
        return accum, count, image.post(shown, self.frame_word(index), num)
