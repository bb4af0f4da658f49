"""Carry state between the JAX package and the port through numpy.

`to_torch` maps the JAX package's NamedTuples (SceneData, BVH, Camera,
RenderParams, TonemapParams, FrameState, GBuffer, ...) to the port's
classes of the same name, field by field, converting every array with
numpy: integer arrays (uint32 words included) become int64 tensors,
floats f32.  A JAX BVH built without the fused coefficient table (the
CPU default) gets it computed from its leaf rows.  `to_numpy` turns a
port tree back into numpy for comparisons.

Both sides only meet here as numpy arrays: this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.alias_table import AliasTable
from .ops.bvh import BVH, HitRecord, bvh_to_device
from .render.config import RenderParams, TonemapParams
from .render.frame import FrameState
from .render.gbuffer import GBuffer, GBufferView
from .render.shade_state import State
from .scene.camera import Camera
from .scene.data import (EnvMap, Lights, Materials, SceneData,
                         SunSkyParams, TexStack)
from .utils.transfer import to_device

_CLASSES = {c.__name__: c for c in (
    AliasTable, BVH, HitRecord, RenderParams, TonemapParams, FrameState,
    GBuffer, GBufferView, State, Camera, EnvMap, Lights, Materials,
    SceneData, SunSkyParams, TexStack)}


def to_torch(obj, device):
    """JAX-package tree (NamedTuples, dicts, arrays) -> port tree."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: to_torch(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        name = type(obj).__name__
        if name not in _CLASSES:
            raise TypeError(f"no port counterpart for {name}")
        if name == "BVH":
            return bvh_to_device(
                {k: (None if v is None else np.asarray(v))
                 for k, v in obj._asdict().items()}, device)
        cls = _CLASSES[name]
        fields = obj._asdict()
        return cls(**{k: to_torch(fields.get(k), device)
                      for k in cls._fields})
    return to_device(np.asarray(obj), device)


def to_numpy(obj):
    """Port tree -> the same structure with numpy arrays."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_numpy(x) for x in obj])
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)
