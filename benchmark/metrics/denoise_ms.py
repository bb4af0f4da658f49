"""The a-trous denoiser (K3/K4, render/denoise.py) a frame: StageTimer's
denoise stage."""


def read(trace):
    ms = trace.stages.get("denoise")
    return None if ms is None else ms / trace.stage_frames
