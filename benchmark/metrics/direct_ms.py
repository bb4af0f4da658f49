"""The direct stage (K1, render/direct.py) a frame: its StageTimer
stages summed."""
STAGES = ("primary_trace", "shading_ris", "shadow_trace",
          "di_temporal_shade", "di_spatial")


def read(trace):
    got = [trace.stages[s] for s in STAGES if s in trace.stages]
    return sum(got) / trace.stage_frames if got else None
