"""The walk kernel's least time from its counted work, frozen from
chip_smoke.py's `walk_bound` and `_bound`, with the published peaks of
one NVIDIA H100 SXM (dense f32 outside the tensor cores; HBM3).

A launch's bound is the larger of its operations at PEAK_F32 and its
bytes at PEAK_BYTES.  The work is what this BVH needed: the walk steps
and leaf events the kernel counted on these rays, so a change of the
BVH's layout changes the count as well as the time.
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PACKET = 128
# flops per lane, as ops/bvh_walk.py counts them: one slab test, one
# triangle test (the cross-product Moller-Trumbore), one instanced
# event's move to object space
WALK_FLOP = 25
MT_FLOP = 53
XFORM_FLOP = 33


class Launch(NamedTuple):
    """One walk launch's counted work and its inputs' sizes."""
    steps: int          # walk steps summed over packets
    events: int         # drained leaf events summed over packets
    walk_rows: int      # rows of the walk table
    leaf_rows: int      # rows of the leaf table
    leaf_n: int         # triangles a leaf
    rays_numel: int     # floats of the (8, P, 128) ray planes
    lanes: int          # P * 128
    inst_leaves: int    # rows of leaf_mesh_row (0: flat BVH)
    instances: int      # rows of inst_inv (0: flat BVH)


def bound(bytes_: float, flops: float) -> tuple[float, str]:
    """(least ms, which peak bounds it)."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def walk_bound(x: Launch) -> tuple[float, str]:
    """Least time for one traversal: the walk rows and leaf rows it can
    have touched (at most one row per walk step and one leaf per drained
    event, each read once), rays in and the four result planes out,
    against walk steps x 128 lanes x one slab test plus drained events x
    128 lanes x leaf_n triangle tests.  An instanced event also reads its
    two indices and its instance's 12-float transform and moves 128 rays
    to object space."""
    bytes_ = (min(x.steps, x.walk_rows) * 8 * 4
              + min(x.events, x.leaf_rows) * x.leaf_n * 12 * 4
              + x.rays_numel * 4 + x.lanes * 4 * 4)
    flops = PACKET * (x.steps * WALK_FLOP + x.events * x.leaf_n * MT_FLOP)
    if x.inst_leaves:
        bytes_ += (min(x.events, x.inst_leaves) * 2 * 4
                   + min(x.events, x.instances) * 12 * 4)
        flops += PACKET * x.events * XFORM_FLOP
    return bound(bytes_, flops)
