"""Share of a frame in which no operation ran on the device: 1 - the
device's busy time a frame (the union of the profiled stretch's device
intervals over its frames) over the untraced window's time a frame.  The
profiler slows the host-bound frames, not the device's operations, so
the window's frames, not the profiled ones, are the denominator."""


def read(trace):
    if not trace.events or trace.frames < 1 or trace.frame_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.frames / trace.frame_s)
