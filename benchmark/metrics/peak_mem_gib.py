"""Peak device memory allocated from the scene's load to the window's
end (torch.cuda.max_memory_allocated after reset_peak_memory_stats)."""


def read(trace):
    return trace.peak_bytes / 2**30 if trace.peak_bytes else None
