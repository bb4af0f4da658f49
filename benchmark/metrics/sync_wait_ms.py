"""Host ms a frame of the stage frames inside the program's sync spans:
the host waiting for the stream to drain at a blocking read."""
from ..host_spans import frame_split, stage_spans


def read(trace):
    split = frame_split(stage_spans(trace))
    return None if split is None else split["sync_ns"] / 1e6 / split["frames"]
