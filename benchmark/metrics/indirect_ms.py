"""The indirect stage (K2, render/indirect.py with render/tracer.py and
ops/packets.py) a frame: StageTimer's gi_trace and gi_resample."""
STAGES = ("gi_trace", "gi_resample")


def read(trace):
    got = [trace.stages[s] for s in STAGES if s in trace.stages]
    return sum(got) / trace.stage_frames if got else None
