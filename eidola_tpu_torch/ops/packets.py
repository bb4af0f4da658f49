"""Packet-coherent ray ordering by image tiles (port of the single-band
image-tile front doors of eidola_tpu/ops/packets.py:107-179).

An 8x16 pixel tile is exactly one 128-lane packet, with a far tighter
frustum than a 128-pixel scanline run.  The sorted wavefront front doors
(`closest_hit_sorted`/`any_hit_sorted`) come with the GI slice.
"""
from __future__ import annotations

from .bvh import BVH, HitRecord, any_hit, closest_hit

TILE_H = 8
TILE_W = 16


def _tileable(h: int, w: int) -> bool:
    return h % TILE_H == 0 and w % TILE_W == 0


def to_tiles(a, h: int, w: int):
    """(h, w, ...) -> (h*w, ...) in tile-major order."""
    if not _tileable(h, w):
        return a.reshape((h * w,) + tuple(a.shape[2:]))
    x = a.reshape((h // TILE_H, TILE_H, w // TILE_W, TILE_W)
                  + tuple(a.shape[2:]))
    return x.transpose(1, 2).reshape((h * w,) + tuple(a.shape[2:]))


def from_tiles(a, h: int, w: int):
    """Inverse of to_tiles: (h*w, ...) tile-major -> (h, w, ...)."""
    if not _tileable(h, w):
        return a.reshape((h, w) + tuple(a.shape[1:]))
    x = a.reshape((h // TILE_H, w // TILE_W, TILE_H, TILE_W)
                  + tuple(a.shape[1:]))
    return x.transpose(1, 2).reshape((h, w) + tuple(a.shape[1:]))


def _img_args(o, d, t_min, t_max):
    h, w = o.shape[:2]
    return h, w, [to_tiles(o, h, w), to_tiles(d, h, w),
                  to_tiles(t_min, h, w), to_tiles(t_max, h, w)]


def closest_hit_img(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000):
    """Closest hit for (H, W, 3) ray fields with tile-packet ordering;
    t_min/t_max are (H, W).  Returns a HitRecord of (H, W) tensors."""
    h, w, args = _img_args(o, d, t_min, t_max)
    rec = closest_hit(bvh, *args, max_steps=max_steps)
    return HitRecord(*[from_tiles(a, h, w) for a in rec])


def any_hit_img(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000):
    """Occlusion query for (H, W, 3) ray fields with tile-packet ordering."""
    h, w, args = _img_args(o, d, t_min, t_max)
    return from_tiles(any_hit(bvh, *args, max_steps=max_steps), h, w)
