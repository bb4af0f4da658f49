"""Packet-coherent ray ordering: image tiles + sorted wavefronts (port of
the single-band front doors of eidola_tpu/ops/packets.py).

The traversals give every 128 consecutive rays one shared cursor, so
consecutive rays should be spatially coherent.

1. Image tiles (`closest_hit_img`/`any_hit_img`): an 8x16 pixel tile is
   exactly one 128-lane packet, with a far tighter frustum than a
   128-pixel scanline run.
2. Sorted wavefronts (`closest_hit_sorted`/`any_hit_sorted`): bounce and
   shadow rays have no raster coherence, so they are sorted by (dead,
   origin Morton cell, direction) before traversal and restored after.
   Dead rays (t_max < t_min) cluster into packets that retire at once.

Under a band context (ops/halo.py) the sort is band-local: rays permute
only within their own row band, as the JAX package's banded sort
(packets.py:236-280) keeps the wavefront shard-local.  The banded order
is traversed in one call: each band is a whole number of 128-ray
packets, so no packet mixes bands, which is what the JAX package's vmap
over bands gives.  Image tiles need nothing for bands: in tile-major
order each band of h/B rows (h divisible by 8 B) is already one
contiguous run of whole packets.  The rank-local frame
(parallel/sharding.py) holds only its rank's rays, so there the sort
covers those, with no communication.

`TRAV` selects the traversal every door uses, from EIDOLA_TRAV as in the
JAX package: "pallas" is the one-kernel walk of ops/bvh_walk.py, which
takes flat and instanced BVHs alike (the JAX package's kernel reads flat
leaf rows only and leaves an instanced BVH on its XLA walk,
packets.py:72-79), "xla" the torch walk of ops/bvh.py with its drain
kernels, and "auto" (the default) resolves per call by the rays' device
(`resolve_trav`): the walk kernel on CUDA, the torch walk on the CPU, as
the JAX package resolves its own traversal by backend (packets.py:72-78).
A build or launch failure of the walk kernel is an error: nothing falls
back to the torch walk.

Under EIDOLA_COUNT_RAYS=1 (read at each call) every front door appends
its live ray count (t_max >= t_min lanes) to `RAY_LEDGER` and its name
to `RAY_DOORS`, as the JAX package's `_count_rays` does at the same
doors (packets.py:51-69): one device sum read per door call, so the
switch costs a sync per traversal and is off by default.
"""
from __future__ import annotations

import os

import torch

from . import bvh as _bvh
from . import bvh_instanced as _inst
from . import bvh_walk as _walk
from .bvh import BVH, PACKET, HitRecord
from .halo import get_bands

TILE_H = 8
TILE_W = 16

TRAV = os.environ.get("EIDOLA_TRAV", "auto")
TRAVS = ("auto", "xla", "pallas")
# wavefront sort-key layout (see ray_sort_keys): o21d3 | d3o21 | o15d6
KEY = os.environ.get("EIDOLA_KEY", "o15d6")


# the measured ray ledger (EIDOLA_COUNT_RAYS=1): live rays per door call,
# and the door that counted them
RAY_LEDGER: list = []
RAY_DOORS: list = []


def _count_rays(door: str, t_min, t_max, shape) -> None:
    if os.environ.get("EIDOLA_COUNT_RAYS") != "1":
        return
    dev = next((a.device for a in (t_max, t_min) if torch.is_tensor(a)),
               torch.device("cpu"))
    f32 = dict(dtype=torch.float32, device=dev)
    live = (torch.broadcast_to(torch.as_tensor(t_max, **f32), shape)
            >= torch.broadcast_to(torch.as_tensor(t_min, **f32), shape))
    RAY_LEDGER.append(float(live.sum()))
    RAY_DOORS.append(door)


def _is_inst(bvh) -> bool:
    return hasattr(bvh, "leaf_mesh_row")


def resolve_trav(device) -> str:
    """The traversal TRAV gives rays on `device`: "auto" is "pallas" on
    CUDA and "xla" elsewhere; "xla" and "pallas" stand as they are."""
    if TRAV == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if TRAV not in TRAVS:
        raise ValueError(f"EIDOLA_TRAV={TRAV!r}: want one of {TRAVS}")
    return TRAV


def closest_hit(bvh, o, d, t_min, t_max, max_steps: int = 100_000):
    if resolve_trav(o.device) == "pallas":
        return _walk.closest_hit_walk(bvh, o, d, t_min, t_max, max_steps)
    if _is_inst(bvh):
        return _inst.closest_hit_instanced(bvh, o, d, t_min, t_max,
                                           max_steps)
    return _bvh.closest_hit(bvh, o, d, t_min, t_max, max_steps=max_steps)


def any_hit(bvh, o, d, t_min, t_max, max_steps: int = 100_000):
    if resolve_trav(o.device) == "pallas":
        return _walk.any_hit_walk(bvh, o, d, t_min, t_max, max_steps)
    if _is_inst(bvh):
        return _inst.any_hit_instanced(bvh, o, d, t_min, t_max, max_steps)
    return _bvh.any_hit(bvh, o, d, t_min, t_max, max_steps=max_steps)


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


def _img_args(door, o, d, t_min, t_max):
    h, w = o.shape[:2]
    _count_rays(door, t_min, t_max, (h, w))
    return h, w, [to_tiles(o, h, w), to_tiles(d, h, w),
                  to_tiles(t_min, h, w), to_tiles(t_max, h, w)]


def closest_hit_img(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000):
    """Closest hit for (H, W, 3) ray fields with tile-packet ordering;
    t_min/t_max are (H, W).  Returns a HitRecord of (H, W) tensors."""
    h, w, args = _img_args("closest_hit_img", o, d, t_min, t_max)
    rec = closest_hit(bvh, *args, max_steps=max_steps)
    return HitRecord(*[from_tiles(a, h, w) for a in rec])


def any_hit_img(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000):
    """Occlusion query for (H, W, 3) ray fields with tile-packet ordering."""
    h, w, args = _img_args("any_hit_img", o, d, t_min, t_max)
    return from_tiles(any_hit(bvh, *args, max_steps=max_steps), h, w)


def _expand_bits_u32(v):
    """Spread the low 10 bits of v so they occupy every 3rd bit (uint32
    values in int64; each product stays below 2**63)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def ray_sort_keys(bvh: BVH, o, d, dead):
    """uint32 sort key (in int64) ordering rays into coherent 128-lane
    packets: dead(1) above an origin Morton code over the root box
    (bvh.walk row 0) and direction bits, laid out by KEY:
      o21d3  21 origin bits above the 3 octant bits
      d3o21  octant above origin: packets never mix octants
      o15d6  5 bits/axis origin, then 2 bits/axis direction (default)"""
    root = bvh.walk[0]
    bmin, bmax = root[0:3], root[3:6]
    ext = torch.clamp(bmax - bmin, min=1e-6)
    p = torch.clamp((o - bmin) / ext, 0.0, 1.0)
    octant = (((d[..., 0] < 0).long() << 2) | ((d[..., 1] < 0).long() << 1)
              | (d[..., 2] < 0).long())
    dead_u = dead.long() << 30

    def morton(bits: int):
        q = torch.clamp(p * float(1 << bits), 0.0,
                        float((1 << bits) - 1)).long()
        return ((_expand_bits_u32(q[..., 0]) << 2)
                | (_expand_bits_u32(q[..., 1]) << 1)
                | _expand_bits_u32(q[..., 2]))

    if KEY == "d3o21":
        return dead_u | (octant << 21) | morton(7)
    if KEY == "o15d6":
        dq = torch.clamp((d + 1.0) * 2.0, 0.0, 3.0).long()
        d6 = (dq[..., 0] << 4) | (dq[..., 1] << 2) | dq[..., 2]
        return dead_u | (morton(5) << 6) | d6
    return dead_u | (morton(7) << 3) | octant


def _sort_bands(R: int) -> int:
    """Band count of a flat field of R rays: the band context's when it
    splits R into whole packets, else 1 (one sort over all rays)."""
    B = get_bands()
    if B > 1 and R % B == 0 and (R // B) % PACKET == 0:
        return B
    return 1


def make_ray_order(bvh: BVH, o, d, dead):
    """(perm, inv) ordering rays by their sort key (`sort_order`).  The
    order can be reused by later traversals whose rays share
    (approximately) the same origins.  Any permutation gives the same
    hits: the sort only serves speed."""
    R = int(o.numel() // 3)
    return sort_order(ray_sort_keys(bvh, o.reshape(R, 3), d.reshape(R, 3),
                                    dead.reshape(R)))


def sort_order(keys):
    """(perm, inv) of flat sort keys: a stable sort, the inverse
    permutation from a scatter.  Under a band context that splits the R
    keys into whole packets (`_sort_bands`) perm and inv are (B, R/B)
    band-local indices."""
    R = keys.numel()
    B = _sort_bands(R)
    perm = torch.sort(keys.reshape(B, R // B), dim=1, stable=True).indices
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(R // B, device=perm.device)
                 .expand(B, R // B))
    return (perm, inv) if B > 1 else (perm[0], inv[0])


def _sorted_traverse(fn, bvh: BVH, o, d, t_min, t_max, max_steps: int,
                     order=None):
    shape = tuple(o.shape[:-1])
    _count_rays(fn.__name__ + "_sorted", t_min, t_max, shape)
    R = int(o.numel() // 3)
    f32 = dict(dtype=torch.float32, device=o.device)
    o = o.reshape(R, 3)
    d = d.reshape(R, 3)
    t_min = torch.broadcast_to(torch.as_tensor(t_min, **f32), shape
                               ).reshape(R)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, **f32), shape
                               ).reshape(R)
    if order is None:
        order = make_ray_order(bvh, o, d, dead=t_max < t_min)
    perm, inv = order
    if perm.dim() == 2:                 # band-local: to global indices
        base = (torch.arange(perm.shape[0], device=perm.device)
                * perm.shape[1])[:, None]
        perm, inv = (perm + base).reshape(-1), (inv + base).reshape(-1)
    out = fn(bvh, o[perm], d[perm], t_min[perm], t_max[perm],
             max_steps=max_steps)
    if isinstance(out, HitRecord):
        return HitRecord(*[a[inv].reshape(shape) for a in out])
    return out[inv].reshape(shape)


def closest_hit_sorted(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000,
                       order=None):
    """Closest hit for incoherent (bounce) ray fields of any shape: sorts,
    traverses, restores the order.  `order` from make_ray_order skips the
    sort."""
    return _sorted_traverse(closest_hit, bvh, o, d, t_min, t_max, max_steps,
                            order)


def any_hit_sorted(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000,
                   order=None):
    """Occlusion query for incoherent (shadow) ray fields of any shape."""
    return _sorted_traverse(any_hit, bvh, o, d, t_min, t_max, max_steps,
                            order)
