"""The walk kernels' share of their roofline over the walk frames: the
summed least times (roofline.walk_bound of each launch's counted steps
and leaf events) over the summed kernel times."""
from ..roofline import walk_bound


def read(trace):
    if not trace.walks:
        return None
    least = sum(walk_bound(launch)[0] for launch, _ in trace.walks)
    took = sum(ms for _, ms in trace.walks)
    return 100.0 * least / took if took > 0 else None
