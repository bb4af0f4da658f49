"""Blocking reads a frame of the stage frames: the program's sync spans
(StageTimer.sync, every site) over its frame spans."""
from ..host_spans import frame_split, stage_spans


def read(trace):
    split = frame_split(stage_spans(trace))
    return None if split is None else split["syncs"] / split["frames"]
