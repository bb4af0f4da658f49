"""Stackless threaded BVH: host build + packet traversal (port of
eidola_tpu/ops/bvh.py, the flattened opaque path).

- `build_bvh` is the JAX package's host build, on the port's own copies
  of its builders (binned SAH from `ops/bvh_build.py` or the C++ one in
  `native/`, preorder escape links, Morton-ordered leaves, octant walk
  tables from `ops/bvh_oct.py`) and always emits the f32 coefficient
  table the fused drains read.
- `_traverse` walks 128-ray packets over the (octant) walk table with
  torch ops: the slab test per packet, leaf events pushed into a
  per-packet queue of depth QUEUE, and a drain whenever any queue fills
  or the walk ends.  The drain compacts the queued events and calls the
  fused kernels of `ops/bvh_fused.py` on all of them in one launch.
  Draining in one launch instead of CHUNK slices changes only which hit
  wins an exact-t tie.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.transfer import to_device
from . import bvh_fused

LEAF_SIZE_CUDA = 64
LEAF_SIZE_CPU = 8
PACKET = 128
QUEUE = 32
CULL_K = 64
_BIG = 1e30
# walk steps between host checks of the loop condition; the step itself
# is gated on the device-side condition, so this changes no result
_CHECK_EVERY = 16


class BVH(NamedTuple):
    walk: torch.Tensor         # (N, 8) f32: bmin, bmax, miss-link, leaf-id (bitcast i32)
    leaf_blocks: torch.Tensor  # (L, leaf_size*12) f32: (v0, e1, e2, pad) per tri
    prim_id: torch.Tensor      # (L*leaf_size,) int64 original triangle id (-1 = pad)
    n_tris: torch.Tensor       # () int64
    leaf_cmat: torch.Tensor    # (L, 16, 4*leaf_size) f32 MT coefficient table
    leaf_anchor: torch.Tensor  # (L, 3) f32
    walk_oct: Optional[torch.Tensor] = None   # (8*N, 8) octant walk tables
    slot_of_tri: Optional[torch.Tensor] = None  # (T,) int64
    cull_boxes: Optional[torch.Tensor] = None   # (K, 6) f32

    @property
    def leaf_size(self) -> int:
        return self.leaf_blocks.shape[1] // 12


class HitRecord(NamedTuple):
    tri: torch.Tensor   # (R,) int64 original triangle id, -1 on miss
    t: torch.Tensor     # (R,) f32 hit distance (_BIG on miss)
    u: torch.Tensor     # (R,) f32 barycentric u
    v: torch.Tensor     # (R,) f32 barycentric v


def leaf_size_for(device) -> int:
    """64-triangle leaves on the card, 8 on the CPU (as the JAX package)."""
    return LEAF_SIZE_CUDA if torch.device(device).type == "cuda" else LEAF_SIZE_CPU


def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(p01: np.ndarray) -> np.ndarray:
    q = np.clip(p01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits(q[:, 0]) << np.uint32(2))
        | (_expand_bits(q[:, 1]) << np.uint32(1))
        | _expand_bits(q[:, 2])
    )


def build_bvh_np(v0, v1, v2, leaf_size: int) -> dict:
    """Host build (eidola_tpu/ops/bvh.py:201-343 without the subset and
    SBVH options): returns the BVH fields as numpy arrays."""
    from ..native import build_bvh_native
    from .bvh_build import build_sah_topology, collect_frontier, \
        flatten_preorder
    from .bvh_oct import build_octant_tables

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("empty scene")
    tb_min = np.minimum(np.minimum(v0, v1), v2)
    tb_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tb_min + tb_max) * 0.5

    native = build_bvh_native(tb_min, tb_max, centroid, leaf_size)
    if native is not None:
        bmin, bmax, escape, blk, leaf_tris = native
    else:
        lefts, rights, n_bmin, n_bmax, node_tris = build_sah_topology(
            tb_min, tb_max, centroid, leaf_size)
        bmin, bmax, escape, blk, leaf_tris = flatten_preorder(
            lefts, rights, n_bmin, n_bmax, node_tris, leaf_size)
    n_nodes = bmin.shape[0]
    n_leaves = len(leaf_tris)

    # per-leaf Morton order of the triangles (stable layout)
    ext = tb_max.max(axis=0) - tb_min.min(axis=0)
    origin = tb_min.min(axis=0)
    morton = morton3d((centroid - origin) / np.maximum(ext, 1e-20))
    lens = np.asarray([t.size for t in leaf_tris], np.int64)
    all_tris = (np.concatenate(leaf_tris).astype(np.int64)
                if n_leaves else np.zeros(0, np.int64))
    leaf_id = np.repeat(np.arange(n_leaves, dtype=np.int64), lens)
    order = np.lexsort((morton[all_tris], leaf_id))
    all_tris = all_tris[order]
    starts = np.zeros(n_leaves + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    pos_in_leaf = np.arange(all_tris.size, dtype=np.int64) - starts[leaf_id]
    slot = leaf_id * leaf_size + pos_in_leaf

    prim_id = np.full(n_leaves * leaf_size, -1, np.int32)
    prim_id[slot] = all_tris.astype(np.int32)
    blocks = np.zeros((n_leaves * leaf_size, 12), np.float32)
    blocks[slot, 0:3] = v0[all_tris]
    blocks[slot, 3:6] = v1[all_tris] - v0[all_tris]
    blocks[slot, 6:9] = v2[all_tris] - v0[all_tris]

    walk = np.zeros((n_nodes, 8), np.float32)
    walk[:, 0:3] = bmin
    walk[:, 3:6] = bmax
    walk[:, 6] = escape.astype(np.int32).view(np.float32)
    walk[:, 7] = blk.astype(np.int32).view(np.float32)

    blocks2 = blocks.reshape(n_leaves, leaf_size * 12)
    leaf_cmat, leaf_anchor = bvh_fused.build_leaf_tables_np(blocks2, leaf_size)

    slot_of_tri = np.full(T, -1, np.int32)
    occupied = prim_id >= 0
    slot_of_tri[prim_id[occupied]] = np.nonzero(occupied)[0].astype(np.int32)
    return dict(
        walk=walk, leaf_blocks=blocks2, prim_id=prim_id, n_tris=np.int32(T),
        leaf_cmat=leaf_cmat, leaf_anchor=leaf_anchor,
        walk_oct=build_octant_tables(walk), slot_of_tri=slot_of_tri,
        cull_boxes=collect_frontier(walk, CULL_K),
    )


def bvh_to_device(fields: dict, device) -> BVH:
    """numpy BVH fields -> BVH of tensors (ints as int64, floats f32)."""
    if fields.get("leaf_cmat") is None:
        cm, an = bvh_fused.build_leaf_tables_np(
            np.asarray(fields["leaf_blocks"], np.float32),
            np.asarray(fields["leaf_blocks"]).shape[1] // 12)
        fields = dict(fields, leaf_cmat=cm, leaf_anchor=an)
    return BVH(**{k: to_device(fields.get(k), device) for k in BVH._fields})


def build_bvh(v0, v1, v2, *, device, leaf_size: int | None = None) -> BVH:
    """Build on the host and move to `device`; the leaf size follows the
    device unless given."""
    if leaf_size is None:
        leaf_size = leaf_size_for(device)
    return bvh_to_device(build_bvh_np(v0, v1, v2, leaf_size), device)


def _split_walk(tab):
    """(N, 8) f32 walk rows -> box planes (N, 6) f32 and links (N, 2) int64
    (miss link, leaf id; bit-cast from the f32 columns)."""
    return tab[:, 0:6].contiguous(), \
        tab[:, 6:8].contiguous().view(torch.int32).to(torch.int64)


def _traverse(bvh: BVH, o, d, t_min, t_max, any_hit: bool, max_steps: int):
    """Packet traversal core.  o, d: (R, 3); t_min/t_max: (R,) or scalars.
    Returns (HitRecord, stats dict)."""
    dev = o.device
    R = o.shape[0]
    n_pkt = -(-R // PACKET)
    pad_r = n_pkt * PACKET - R
    f32 = dict(dtype=torch.float32, device=dev)
    t_min = torch.broadcast_to(torch.as_tensor(t_min, **f32), (R,))
    t_max = torch.broadcast_to(torch.as_tensor(t_max, **f32), (R,))

    def pad(a, fill):
        if pad_r == 0:
            return a
        return torch.cat([a, a.new_full((pad_r,) + a.shape[1:], fill)])

    o = pad(o, 0.0)
    d = pad(d, 1.0)
    t_min = pad(t_min, 0.0).reshape(n_pkt, PACKET)
    t_max = pad(t_max, -1.0).reshape(n_pkt, PACKET)   # dead rays: t_max < t_min
    ox, oy, oz = (o[:, k].reshape(n_pkt, PACKET) for k in range(3))
    dx, dy, dz = (d[:, k].reshape(n_pkt, PACKET) for k in range(3))

    def inv(c):
        return torch.where(c >= 0.0, 1.0, -1.0) / torch.clamp(torch.abs(c),
                                                              min=1e-12)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    if bvh.walk_oct is not None:
        # one octant table per packet, by majority direction sign
        half_p = PACKET // 2
        oct_base = bvh.walk.shape[0] * (
            ((dx < 0.0).sum(1) > half_p).long()
            + 2 * ((dy < 0.0).sum(1) > half_p).long()
            + 4 * ((dz < 0.0).sum(1) > half_p).long()
        )
        box, links = _split_walk(bvh.walk_oct)
    else:
        oct_base = torch.zeros(n_pkt, dtype=torch.int64, device=dev)
        box, links = _split_walk(bvh.walk)

    n = bvh.leaf_size
    node = torch.zeros(n_pkt, dtype=torch.int64, device=dev)
    t_best = t_max.clone()
    tri_best = torch.full((n_pkt, PACKET), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((n_pkt, PACKET), **f32)
    v_best = torch.zeros((n_pkt, PACKET), **f32)
    queue = torch.zeros((n_pkt, QUEUE), dtype=torch.int64, device=dev)
    cnt = torch.zeros(n_pkt, dtype=torch.int64, device=dev)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    stats = {"events": 0, "drains": 0}

    def walk_step():
        nonlocal node, cnt, step
        live = node >= 0
        go = live.any() & (cnt < QUEUE).all() & (step < max_steps)
        nid = node.clamp(min=0)
        row = box[oct_base + nid]                         # (n_pkt, 6)
        lk = links[oct_base + nid]                        # (n_pkt, 2)
        tx0 = (row[:, 0:1] - ox) * ix
        tx1 = (row[:, 3:4] - ox) * ix
        ty0 = (row[:, 1:2] - oy) * iy
        ty1 = (row[:, 4:5] - oy) * iy
        tz0 = (row[:, 2:3] - oz) * iz
        tz1 = (row[:, 5:6] - oz) * iz
        t_near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                             torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
        t_far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                            torch.maximum(ty0, ty1)),
                              torch.maximum(tz0, tz1))
        ray_hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_best)
        pkt_hit = ray_hit.any(1) & live
        miss, leaf_id = lk[:, 0], lk[:, 1]
        is_leaf = leaf_id >= 0
        push = pkt_hit & is_leaf & go
        slot = cnt.clamp(max=QUEUE - 1)[:, None]
        cur = queue.gather(1, slot)[:, 0]
        queue.scatter_(1, slot, torch.where(push, leaf_id, cur)[:, None])
        cnt = cnt + push.long()
        nxt = torch.where(pkt_hit & ~is_leaf, nid + 1, miss)
        node = torch.where(live & go, nxt, node)
        step = step + go.long()
        return go

    def drain():
        nonlocal t_best, tri_best, u_best, v_best, cnt
        offsets = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
        total = int(offsets[-1])
        if total > 0:
            s = torch.arange(total, device=dev)
            sp = torch.searchsorted(offsets, s, right=True) - 1
            leaf = queue[sp, s - offsets[sp]]
            valid = torch.ones(total, dtype=torch.int32, device=dev)
            g = lambda a: a[sp]
            anchor = bvh.leaf_anchor[leaf]
            rays = (g(ox), g(oy), g(oz), g(dx), g(dy), g(dz), g(t_min))
            gtb = g(t_best)
            nxt_sp = torch.cat([sp[1:], sp.new_full((1,), -1)])
            # run-end scatter: the last event of each sub-packet's run holds
            # its fold; every other row goes to a discarded extra row
            idx = torch.where(sp != nxt_sp, sp, n_pkt)

            def scat(best, m):
                out = torch.cat([best, best[:1]])
                out[idx] = m
                return out[:n_pkt]

            if any_hit:
                hit_e = bvh_fused.mt_any_fused(
                    bvh.leaf_cmat, anchor, leaf, sp, valid, *rays, gtb, n) > 0
                t_best = scat(t_best, torch.where(hit_e, -_BIG, gtb))
                tri_best = scat(tri_best,
                                torch.where(hit_e, 0, g(tri_best)))
            else:
                t_e, slot_e, u_e, v_e = bvh_fused.mt_fused(
                    bvh.leaf_cmat, anchor, leaf, leaf, sp, valid, *rays, gtb, n)
                improved = t_e < gtb
                t_best = scat(t_best, torch.where(improved, t_e, gtb))
                tri_best = scat(tri_best,
                                torch.where(improved, slot_e, g(tri_best)))
                u_best = scat(u_best, torch.where(improved, u_e, g(u_best)))
                v_best = scat(v_best, torch.where(improved, v_e, g(v_best)))
            stats["events"] += total
            stats["drains"] += 1
        if any_hit:
            # resolved rays retire from the slab test entirely
            t_best = torch.where(tri_best >= 0, -_BIG, t_best)
        cnt = torch.zeros_like(cnt)

    while bool((node >= 0).any()) and int(step) < max_steps:
        go = torch.ones((), dtype=torch.bool, device=dev)
        while bool(go):
            for _ in range(_CHECK_EVERY):
                go = walk_step()
        drain()
    stats["steps"] = int(step)

    def flat(a):
        return a.reshape(n_pkt * PACKET)[:R]

    t, tri_slot, u, v = flat(t_best), flat(tri_best).long(), flat(u_best), \
        flat(v_best)
    if any_hit:
        # blocker identity is never used: tri 0 reads "occluded"
        tri = torch.where(tri_slot >= 0, 0, -1)
        return HitRecord(tri=tri, t=t, u=u, v=v), stats
    tri = torch.where(tri_slot >= 0, bvh.prim_id[tri_slot.clamp(min=0)], -1)
    t = torch.where(tri >= 0, torch.abs(t), _BIG)
    return HitRecord(tri=tri, t=t, u=u, v=v), stats


def closest_hit(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000):
    """Closest-hit query over a flat ray stream (consecutive 128 rays share
    a traversal cursor)."""
    return _traverse(bvh, o, d, t_min, t_max, False, max_steps)[0]


def any_hit(bvh: BVH, o, d, t_min, t_max, max_steps: int = 100_000):
    """Occlusion query: bool (R,) occluded."""
    return _traverse(bvh, o, d, t_min, t_max, True, max_steps)[0].tri >= 0
