"""The shading state of closest hits in one kernel (csrc/shade_state.cu;
replaces no TPU kernel).

`render/shade_state.get_state` turned a hit record into the shading state
in ~830 torch launches a call (~1,400 with a ray cone), six calls a
default frame; on the card it runs `shade` instead, one launch a call,
and keeps its torch body (`get_state_ref`) for CPU tensors.  `shade`
checks its arguments and raises on anything the kernel does not take, a
CPU tensor included.

- The lanes (o, d, tri, t, u, v) share one leading shape and are read
  through their own strides: a strided or broadcast view (the primary
  rays' one origin) needs no copy, as long as each input walks its
  leading dimensions as one.
- The cone is None (level 0), a Python float or a 0-d f32 tensor on the
  lanes' device, which the kernel reads there (no host sync).
- The scene's tables are read as they are (contiguous).
- `LAUNCHES` counts the calls run through the kernel, so a run can show
  that the frame went through it (a default standin frame: 6).
"""
from __future__ import annotations

import ctypes
import math

import torch

LAUNCHES = 0

F32, I64, BOOL = torch.float32, torch.int64, torch.bool
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


class _TexStack(ctypes.Structure):
    _fields_ = [("data", P), ("size", P), ("wrap", P), ("h", L), ("w2", L),
                ("untextured", I)]


class _InstSearch(ctypes.Structure):
    _fields_ = [("tri_base", P), ("attr_base", P), ("n", I)]


class _Lanes(ctypes.Structure):
    _fields_ = [("n", L), ("o", P), ("so", L), ("so3", L),
                ("d", P), ("sd", L), ("sd3", L), ("tri", P), ("stri", L),
                ("t", P), ("st", L), ("u", P), ("su", L), ("v", P),
                ("sv", L), ("cone", P), ("cone_value", F), ("has_cone", I)]


# the scene's tables in the kernel's order: (label, dtype, shape), where
# T, M, NT and I stand for the triangles, materials, textures, instances
_TRI = [("tri_gn", I64, ("T",)), ("tri_nrm", I64, ("T", 3)),
        ("tri_uv", F32, ("T", 3, 2)), ("tri_tangent", I64, ("T", 3)),
        ("tri_hand", F32, ("T", 3)), ("tri_color", I64, ("T", 3)),
        ("tri_mat", I64, ("T",)), ("tri_uv_density", F32, ("T",))]
_MAT = [("base_color", F32, ("M", 4)), ("emissive", F32, ("M", 3)),
        ("metallic", F32, ("M",)), ("roughness", F32, ("M",)),
        ("ior", F32, ("M",)), ("transmission", F32, ("M",)),
        ("base_tex", I64, ("M",)), ("mr_tex", I64, ("M",)),
        ("normal_tex", I64, ("M",)), ("emissive_tex", I64, ("M",))]
_TEX = [("data", F32, ("NT", None, None, 4)), ("size", I64, ("NT", 2)),
        ("wrap", I64, ("NT", 2))]
_INST = [("tri_base", I64, ("I",)), ("attr_base", I64, ("I",)),
         ("rot", F32, ("I", 9)), ("nrm_rot", F32, ("I", 9)),
         ("det_sign", F32, ("I",)), ("uvd_scale", F32, ("I",))]


class _Tables(ctypes.Structure):
    _fields_ = ([(f, P) for f, _, _ in _TRI + _MAT]
                + [("tex", _TexStack), ("max_level", L),
                   ("inst", _InstSearch)]
                + [(f, P) for f, _, _ in _INST[2:]])


# render/shade_state.State's fields: (name, dtype, trailing shape)
FIELDS = [("pos", F32, (3,)), ("nrm", F32, (3,)), ("geo_nrm", F32, (3,)),
          ("uv", F32, (2,)), ("albedo", F32, (3,)), ("opacity", F32, ()),
          ("metallic", F32, ()), ("roughness", F32, ()), ("ior", F32, ()),
          ("transmission", F32, ()), ("emission", F32, (3,)),
          ("mat_id", I64, ()), ("valid", BOOL, ())]


class _Out(ctypes.Structure):
    _fields_ = [(f, P) for f, _, _ in FIELDS]


def _lib():
    from ..utils.cuda_build import load

    lib = load("shade_state")
    if not getattr(lib, "_eidola_typed", False):
        sizes = (L * 3)()
        lib.eidola_shade_state_abi.argtypes = [P]
        lib.eidola_shade_state_abi.restype = None
        lib.eidola_shade_state_abi(sizes)
        mirrors = [ctypes.sizeof(s) for s in (_Lanes, _Tables, _Out)]
        if list(sizes) != mirrors:
            raise RuntimeError(f"shade_state: the kernel's structs are "
                               f"{list(sizes)} bytes, their mirrors here "
                               f"{mirrors}")
        lib.eidola_shade_state.argtypes = [P, P, P, P]
        lib.eidola_shade_state.restype = I
        lib._eidola_typed = True
    return lib


def _check(named: list, dims: dict, dev: torch.device,
           contiguous: bool) -> None:
    """Each (label, tensor, dtype, shape) must match, on `dev`; a name in
    a shape binds to the extent it first meets (in `dims`), None takes
    any extent."""
    for label, a, dtype, shape in named:
        if a.dtype != dtype:
            raise ValueError(f"shade_state: {label} must be {dtype}, got "
                             f"{a.dtype}")
        want = tuple(dims.setdefault(s, x) if isinstance(s, str) else s
                     for s, x in zip(shape, a.shape))
        if a.dim() != len(shape) or any(
                s is not None and s != x for s, x in zip(want, a.shape)):
            raise ValueError(f"shade_state: {label} must be {shape} "
                             f"({dims}), got {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"shade_state: all inputs must be on {dev}, "
                             f"{label} is on {a.device}")
        if contiguous and not a.is_contiguous():
            raise ValueError(f"shade_state: {label} must be contiguous")


def _lane_stride(label: str, a, lead: tuple) -> int:
    """The stride (elements) from one lane of `a` to the next, its leading
    dimensions `lead` walked as one; raises where they are not (a
    transposed or doubly strided view)."""
    dims = [(n, s) for n, s in zip(lead, a.stride()) if n != 1]
    for (_, outer), (n, inner) in zip(dims, dims[1:]):
        if outer != n * inner:
            raise ValueError(f"shade_state: {label}'s lanes {lead} with "
                             f"strides {a.stride()[:len(lead)]} are not one "
                             "strided dimension")
    return dims[-1][1] if dims else 0


def _ptr(a) -> int:
    return 0 if a is None else a.data_ptr()


def _tables(scene) -> _Tables:
    """The scene's tables, checked, as the kernel's struct."""
    m, tex, inst = scene.materials, scene.textures, scene.inst
    dev = scene.tri_mat.device
    dims: dict = {}
    named = ([(f, getattr(scene, f), dt, s) for f, dt, s in _TRI]
             + [(f"materials.{f}", getattr(m, f), dt, s)
                for f, dt, s in _MAT]
             + [(f"textures.{f}", getattr(tex, f), dt, s)
                for f, dt, s in _TEX])
    if inst is not None:
        named += [(f"inst.{f}", getattr(inst, f), dt, s)
                  for f, dt, s in _INST]
    _check(named, dims, dev, contiguous=True)
    if tex.data.data_ptr() % 16:
        raise ValueError("shade_state: textures.data must be 16-byte "
                         "aligned (a texel is one 16-byte load)")
    if dims.get("I", 0) >= 2 ** 31:
        raise ValueError("shade_state: at most 2^31 - 1 instances")
    tw = tex.data.shape[2] // 2
    vals = [_ptr(getattr(scene, f)) for f, _, _ in _TRI] + [
        _ptr(getattr(m, f)) for f, _, _ in _MAT]
    extra = [_ptr(getattr(inst, f)) if inst is not None else 0
             for f, _, _ in _INST]
    return _Tables(
        *vals,
        _TexStack(_ptr(tex.data), _ptr(tex.size), _ptr(tex.wrap),
                  tex.data.shape[1], tex.data.shape[2],
                  int(tex.data.shape[0] == 1 and tex.data.shape[1] == 1)),
        max(int(tw).bit_length() - 1, 0),
        _InstSearch(extra[0], extra[1],
                    0 if inst is None else inst.tri_base.shape[0]),
        *extra[2:])


def _lanes(o, d, tri, t, u, v, cone) -> _Lanes:
    """The lanes and the cone, checked, as the kernel's struct."""
    dev = tri.device
    lead = tuple(tri.shape)
    named = [("o", o, F32, lead + (3,)), ("d", d, F32, lead + (3,)),
             ("tri", tri, I64, lead), ("t", t, F32, lead),
             ("u", u, F32, lead), ("v", v, F32, lead)]
    if isinstance(cone, torch.Tensor):
        named.append(("cone_angle", cone, F32, ()))
    _check(named, {}, dev, contiguous=False)
    lanes = _Lanes(n=math.prod(lead))
    for name, a in zip(("o", "d", "tri", "t", "u", "v"),
                       (o, d, tri, t, u, v)):
        setattr(lanes, name, a.data_ptr())
        setattr(lanes, "s" + name, _lane_stride(name, a, lead))
    lanes.so3, lanes.sd3 = o.stride(-1), d.stride(-1)
    if cone is not None:
        lanes.has_cone = 1
        if isinstance(cone, torch.Tensor):
            lanes.cone = cone.data_ptr()
        else:
            lanes.cone_value = float(cone)
    return lanes


def launcher(scene, o, d, tri, t, u, v, cone_angle=None):
    """(launch, outputs) for one call with the wrapper's checks done and
    the outputs (State's fields, in order) allocated with torch.empty;
    `launch()` only launches the kernel on the current stream (it does
    not count).  `shade` calls it once; chip_smoke.py times it alone."""
    lanes = _lanes(o, d, tri, t, u, v, cone_angle)
    tables = _tables(scene)
    if scene.tri_mat.device != tri.device:
        raise ValueError(f"shade_state: all inputs must be on {tri.device}, "
                         f"the scene is on {scene.tri_mat.device}")
    if tri.device.type != "cuda":
        raise ValueError(f"shade_state: the kernel takes CUDA tensors, got "
                         f"{tri.device} (the CPU runs render/shade_state.py's "
                         "get_state_ref)")
    lead = tuple(tri.shape)
    outs = [torch.empty(lead + tail, dtype=dt, device=tri.device)
            for _, dt, tail in FIELDS]
    out = _Out(*[a.data_ptr() for a in outs])
    fn = _lib().eidola_shade_state
    stream = torch.cuda.current_stream(tri.device).cuda_stream
    args = [ctypes.byref(lanes), ctypes.byref(tables), ctypes.byref(out),
            P(stream)]

    def launch(_alive=(scene, o, d, tri, t, u, v, cone_angle, outs)):
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"shade_state: CUDA launch failed with "
                               f"cudaError_t {err}")

    return launch, outs


def shade(scene, o, d, tri, t, u, v, cone_angle=None) -> list:
    """State's fields of the hit record (tri, t, u, v) of rays (o, d) on
    the card, in one launch on the current stream, counted in LAUNCHES;
    lanes with tri < 0 get the invalid state."""
    global LAUNCHES
    launch, outs = launcher(scene, o, d, tri, t, u, v, cone_angle)
    launch()
    LAUNCHES += 1
    return outs
