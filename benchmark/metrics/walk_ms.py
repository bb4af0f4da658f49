"""Device time of the walk kernels (csrc/bvh_walk.cu) a frame of the
traced window."""
from ..tracing import WALK_KERNEL


def read(trace):
    us = sum(e - s for name, s, e in trace.events if WALK_KERNEL in name)
    return us / 1e3 / trace.frames if us else None
