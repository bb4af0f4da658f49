"""One lap of the alpha HitTest's queue march in two kernels
(csrc/alpha_lap.cu; replaces no TPU kernel).

A lap of render/tracer.py's queue march takes the queued band indices
`sel` (index order), runs the alpha test on their records, compacts the
rays that re-trace past a rejected hit, traces them in the hop BVH and
scatters the results back into the band.  On the card `lap_prep` and
`lap_merge` are all of that but the sort and the walk: two launches where
the torch lap issued ~320.  `render/tracer._march_lap` calls them for
CUDA tensors and its plain versions (`_lap_prep_ref`, `_lap_merge_ref`,
the same lap in torch) for CPU tensors; these wrappers check their
arguments and raise on anything the kernels do not take, a CPU tensor
included.

- `Band`: the band's flat planes; `lap_merge` updates the record, rng,
  pending, occluded and budget planes in place.
- `AlphaTables`: what the alpha test reads of the scene.
- `Lap`: a lap's compact rays, their sort keys (ops/packets.py's
  `ray_sort_keys` under `KEY`) and its scratch.
- `LAUNCHES` counts the laps run through the kernels (`lap_merge` adds
  one), so a run can show that the march went through them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import packets

LAUNCHES = 0
# ops/packets.py's key layouts as the kernel numbers them; any other
# layout is the default branch of ray_sort_keys (o21d3)
KEY_LAYOUTS = {"o15d6": 0, "d3o21": 1}


class Band(NamedTuple):
    """One band of a queue march: flat planes of R rays (contiguous)."""
    o: torch.Tensor          # (R, 3) f32
    d: torch.Tensor          # (R, 3) f32
    tmax: torch.Tensor       # (R,) f32 the re-trace's t_max
    tri: torch.Tensor        # (R,) int64 the record, updated in place
    t: torch.Tensor          # (R,) f32
    u: torch.Tensor          # (R,) f32
    v: torch.Tensor          # (R,) f32
    rng: torch.Tensor        # (R,) int64 uint32 rng words
    pending: torch.Tensor    # (R,) bool an untested alpha hit
    occluded: torch.Tensor   # (R,) bool
    bleft: torch.Tensor      # (R,) int64 tests / re-traces left


class AlphaTables(NamedTuple):
    """The scene arrays the alpha test reads (render/tracer.py
    `_alpha_passthrough`); tri_base and attr_base are None on a flat
    scene."""
    tri_mat: torch.Tensor        # (T,) int64
    tri_uv: torch.Tensor         # (T, 3, 2) f32
    base_color: torch.Tensor     # (M, 4) f32
    base_tex: torch.Tensor       # (M,) int64
    alpha_mode: torch.Tensor     # (M,) int64
    alpha_cutoff: torch.Tensor   # (M,) f32
    tex_data: torch.Tensor       # (NT, TH, W2, 4) f32
    tex_size: torch.Tensor       # (NT, 2) int64
    tex_wrap: torch.Tensor       # (NT, 2) int64
    tri_base: Optional[torch.Tensor] = None    # (I,) int64
    attr_base: Optional[torch.Tensor] = None   # (I,) int64


class Lap(NamedTuple):
    """A lap's n queued rays, compacted in queue order."""
    o: torch.Tensor       # (n, 3) f32
    d: torch.Tensor       # (n, 3) f32
    tn: torch.Tensor      # (n,) f32 re-trace t_min (1 where no re-trace)
    tx: torch.Tensor      # (n,) f32 re-trace t_max (-1 where none)
    keys: torch.Tensor    # (n,) int64 wavefront sort keys
    go: torch.Tensor      # (n,) bool re-traced past a rejected hit
    occ: torch.Tensor     # (n,) bool a solid hit occluded the ray
    bleft: torch.Tensor   # (n,) int64 budget left after the lap
    rng: torch.Tensor     # (n,) int64 the advanced rng words


F32, I64, BOOL = torch.float32, torch.int64, torch.bool
_BAND_DTYPES = (F32, F32, F32, I64, F32, F32, F32, I64, BOOL, BOOL, I64)
_TABLE_DTYPES = (I64, F32, F32, I64, I64, F32, F32, I64, I64, I64, I64)
_LAP_DTYPES = (F32, F32, F32, F32, I64, BOOL, BOOL, I64, I64)


def _check(name: str, named: list) -> torch.device:
    """Each (label, tensor, dtype, shape) must match and be contiguous, all
    on one CUDA device (a None in shape takes any extent)."""
    dev = named[0][1].device
    for label, a, dtype, shape in named:
        if a.dtype != dtype:
            raise ValueError(f"{name}: {label} must be {dtype}, got "
                             f"{a.dtype}")
        if a.dim() != len(shape) or any(
                s is not None and s != x for s, x in zip(shape, a.shape)):
            raise ValueError(f"{name}: {label} must be {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if a.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, "
                             f"{label} is on {a.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev} "
                         "(the CPU runs render/tracer.py's plain lap)")
    return dev


def _band_args(sel, band: Band) -> list:
    R = band.tri.shape[0]
    n = sel.shape[0]
    shapes = [(R, 3), (R, 3)] + [(R,)] * 9
    return ([("sel", sel, I64, (n,))]
            + [(f"band.{f}", a, dt, s) for f, a, dt, s in
               zip(Band._fields, band, _BAND_DTYPES, shapes)])


def _lap_args(lap: Lap, n: int) -> list:
    shapes = [(n, 3), (n, 3)] + [(n,)] * 7
    return [(f"lap.{f}", a, dt, s) for f, a, dt, s in
            zip(Lap._fields, lap, _LAP_DTYPES, shapes)]


def _ptr(a):
    return ctypes.c_void_p(None if a is None else a.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _lib():
    from ..utils.cuda_build import load

    lib = load("alpha_lap")
    if not getattr(lib, "_eidola_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.eidola_lap_prep.argtypes = ([P, I] + [P] * 11 + [P] * 9
                                        + [L, L, I, P, P, I, P, I, I]
                                        + [P] * 9 + [P])
        lib.eidola_lap_prep.restype = I
        lib.eidola_lap_merge.argtypes = ([P, I] + [P] * 11 + [P] * 4
                                         + [P] * 9 + [I, P])
        lib.eidola_lap_merge.restype = I
        lib._eidola_typed = True
    return lib


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def lap_prep(sel, band: Band, tables: AlphaTables, walk,
             occl: bool) -> Lap:
    """The alpha test of the queued records band[sel], their budget and
    re-trace segments and sort keys over `walk` row 0 (the hop BVH's root
    box), as one launch on the current stream."""
    n = sel.shape[0]
    inst = tables.tri_base is not None
    if inst != (tables.attr_base is not None) or (
            inst and tables.attr_base.shape != tables.tri_base.shape):
        raise ValueError("lap_prep: tri_base and attr_base come together, "
                         "one entry each an instance")
    T, M, NT = (tables.tri_mat.shape[0], tables.base_tex.shape[0],
                tables.tex_size.shape[0])
    tshapes = [(T,), (T, 3, 2), (M, 4), (M,), (M,), (M,),
               (NT, None, None, 4), (NT, 2), (NT, 2), (None,), (None,)]
    named = _band_args(sel, band) + [
        (f"tables.{f}", a, dt, s) for f, a, dt, s in
        zip(AlphaTables._fields, tables, _TABLE_DTYPES, tshapes)
        if a is not None]
    named.append(("walk", walk, F32, (None, 8)))
    dev = _check("lap_prep", named)
    f32 = dict(dtype=F32, device=dev)
    out = Lap(torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
              torch.empty(n, **f32), torch.empty(n, **f32),
              torch.empty(n, dtype=I64, device=dev),
              torch.empty(n, dtype=BOOL, device=dev),
              torch.empty(n, dtype=BOOL, device=dev),
              torch.empty(n, dtype=I64, device=dev),
              torch.empty(n, dtype=I64, device=dev))
    tex = tables.tex_data
    untextured = int(tex.shape[0] == 1 and tex.shape[1] == 1)
    n_inst = tables.tri_base.shape[0] if inst else 0
    err = _lib().eidola_lap_prep(
        _ptr(sel), n, *[_ptr(a) for a in band],
        *[_ptr(a) for a in tables[:9]], tex.shape[1], tex.shape[2],
        untextured, _ptr(tables.tri_base), _ptr(tables.attr_base), n_inst,
        _ptr(walk), int(occl), KEY_LAYOUTS.get(packets.KEY, 2),
        *[_ptr(a) for a in out], _stream())
    _raise_on("lap_prep", err)
    return out


def lap_merge(sel, band: Band, rec2, lap: Lap, occl: bool) -> None:
    """Scatter a lap back into the band in place: band.(tri, t, u, v)[sel]
    take rec2's where lap.go, then rng, pending, occluded and bleft; one
    launch on the current stream, counted in LAUNCHES."""
    global LAUNCHES
    n = sel.shape[0]
    named = (_band_args(sel, band)
             + [(f"rec2.{f}", a, dt, (n,)) for f, a, dt in
                zip(("tri", "t", "u", "v"), rec2, (I64, F32, F32, F32))]
             + _lap_args(lap, n))
    _check("lap_merge", named)
    err = _lib().eidola_lap_merge(
        _ptr(sel), n, *[_ptr(a) for a in band], *[_ptr(a) for a in rec2],
        *[_ptr(a) for a in lap], int(occl), _stream())
    _raise_on("lap_merge", err)
    LAUNCHES += 1

