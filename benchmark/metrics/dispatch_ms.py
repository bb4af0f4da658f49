"""Host ms a frame of the stage frames inside the program's frame span but
outside its sync spans: Python and torch's dispatch of the frame."""
from ..host_spans import frame_split, stage_spans


def read(trace):
    split = frame_split(stage_spans(trace))
    if split is None:
        return None
    return (split["frame_ns"] - split["sync_ns"]) / 1e6 / split["frames"]
