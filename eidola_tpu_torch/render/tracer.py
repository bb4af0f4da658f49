"""Ray tracing front doors of the direct stage (port of
eidola_tpu/render/tracer.py:trace_closest / trace_occlusion on the
opaque branch, alpha_geometry=False, with image-tile packets).

The alpha HitTest march, the opaque/alpha BVH split and the sorted
wavefront doors (coherent=False) come with later slices."""
from __future__ import annotations

from ..ops.packets import any_hit_img, closest_hit_img
from ..scene.data import SceneData
from .config import RenderConfig


def _check(cfg: RenderConfig, scene: SceneData, o, coherent: bool):
    if cfg.alpha_geometry or scene.bvh_alpha is not None:
        raise NotImplementedError(
            "alpha-tested tracing is ported with ROADMAP A9")
    if not (coherent and o.dim() == 3):
        raise NotImplementedError(
            "sorted wavefront tracing (coherent=False) is ported with the "
            "GI slice (ROADMAP A6)")


def trace_closest(cfg: RenderConfig, scene: SceneData, o, d, t_min, t_max,
                  rng_state, coherent: bool = False):
    """Closest hit of (H, W, 3) ray fields.  Returns (rng_state, HitRecord)."""
    _check(cfg, scene, o, coherent)
    rec = closest_hit_img(scene.bvh, o, d, t_min, t_max,
                          max_steps=cfg.traversal_max_steps)
    return rng_state, rec


def trace_occlusion(cfg: RenderConfig, scene: SceneData, o, d, t_min, t_max,
                    rng_state, coherent: bool = False):
    """Occlusion of (H, W, 3) ray fields.  Returns (rng_state, occluded)."""
    _check(cfg, scene, o, coherent)
    occ = any_hit_img(scene.bvh, o, d, t_min, t_max,
                      max_steps=cfg.traversal_max_steps)
    return rng_state, occ
