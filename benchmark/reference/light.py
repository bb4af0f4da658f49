"""The scene's light, which the reference samples and evaluates.

A light is the module `lights/<kind>.py` of the kind that the scene's
`light` names, found by that name: a new light of the reference is a new
file, and nothing here names one.  Its `make(*, device, num,
**light_args)` gives, in the precision `num` (precision.Precision), an
object with

  sample(u1, u2, u3, u4)  (wi, pdf, li): a direction drawn from four
                          uniform numbers, its solid-angle pdf and the
                          radiance along it
  radiance(d)             the radiance along unit directions d (..., 3)
  pdf(d)                  the solid-angle pdf with which `sample` draws d
"""
from __future__ import annotations

import importlib
import pkgutil

from . import lights


def names() -> list:
    """The lights the reference has: the modules of lights/."""
    return sorted(m.name for m in pkgutil.iter_modules(lights.__path__))


def make(kind: str, *, device, num, **light_args):
    """The light `kind` (lights/<kind>.py) with the scene's `light_args`;
    a KeyError names the lights that exist."""
    if kind not in names():
        raise KeyError(f"no light {kind!r} in the reference; it has "
                       f"{names()}")
    module = importlib.import_module(f"{lights.__name__}.{kind}")
    return module.make(device=device, num=num, **light_args)
