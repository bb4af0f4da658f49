"""Device kernels (memcopies and memsets aside) a frame of the traced
window: the host dispatch's launches."""
from ..tracing import kernel_count


def read(trace):
    n = kernel_count(trace.events)
    return n / trace.frames if n else None
