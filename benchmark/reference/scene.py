"""The cell's input: the scene the reference traces, made by the
benchmark.

A scene is the module `scenes/<name>.py` of the configuration's `scene`,
found by that name: a new scene of the reference is a new file, and
nothing here names one.  Its `make(*, device, **scene_args)` gives a
`Standin`: the world-space triangles in float64, split into the opaque
ones and the alpha-tested ones, the alpha-tested ones' texture
coordinates, their texture's alpha and cutoff, the view (eye, center,
vertical field of view in degrees) of the scene's own camera, its light
(a kind of light.py's, lights/<kind>.py, and its arguments) and the
number of its triangle and punctual emitters, which the reference does
not sample yet.
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import NamedTuple

import torch

from . import scenes


class Standin(NamedTuple):
    opaque: torch.Tensor       # (T, 3, 3) f64 world-space vertices
    alpha: torch.Tensor        # (A, 3, 3) f64 the alpha-tested triangles
    alpha_uv: torch.Tensor     # (A, 3, 2) f64
    leaf_alpha: torch.Tensor   # (h, w) f64 texture alpha, repeat-wrapped
    cutoff: float
    view: tuple                # (eye, center, fovy_deg)
    light: tuple               # (kind, {light_args}): lights/<kind>.py
    emitters: int              # triangle and punctual emitters


def names() -> list:
    """The scenes the reference makes: the modules of scenes/."""
    return sorted(m.name for m in pkgutil.iter_modules(scenes.__path__))


def make(name: str, *, device, **scene_args) -> Standin:
    """The scene `name` (scenes/<name>.py) with the configuration's
    `scene_args`; a KeyError names the scenes that exist."""
    if name not in names():
        raise KeyError(f"no scene {name!r} in the reference; it has "
                       f"{names()}")
    module = importlib.import_module(f"{scenes.__name__}.{name}")
    return module.make(device=device, **scene_args)
