"""One a-trous level of the denoiser in one kernel (csrc/atrous.cu;
replaces no TPU kernel).

`render/denoise.py`'s torch level (`_edge_stopped` over `atrous_level`'s
25 taps) issued ~875 launches; on the card `atrous_denoise` runs each
level as one launch of `run_level` instead, the levels ping-ponging
between two buffers that `run_levels` allocates, and keeps the torch level
for CPU tensors.  These wrappers check their arguments and raise on
anything the kernel does not take, a CPU tensor included.

- `View`: the planes the edge stops read (positions, normals, material
  hashes, valid), any strides; under a shard context each carries the
  rows the exchange brought above and below.
- `LAUNCHES` counts the levels run through the kernel, so a run can show
  that the denoiser went through it (a default frame: 4 + 5).
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

LAUNCHES = 0

F32, I64, BOOL = torch.float32, torch.int64, torch.bool


class View(NamedTuple):
    """The view planes of `level`, (h + 2 e, w, ...) each."""
    pos: torch.Tensor        # (., w, 3) f32
    nrm: torch.Tensor        # (., w, 3) f32
    mat_hash: torch.Tensor   # (., w) int64
    valid: torch.Tensor      # (., w) bool


def _lib():
    from ..utils.cuda_build import load

    lib = load("atrous")
    if not getattr(lib, "_eidola_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.eidola_atrous_level.argtypes = (
            [P, L, L, L, I] + [P, L, L, L] * 2 + [P, L, L] * 2
            + [I, I, I, I] + [P] * 4 + [P])
        lib.eidola_atrous_level.restype = I
        lib._eidola_typed = True
    return lib


def _check(img, view: View, level: int, sigmas, e_img: int, e_view: int,
           out):
    """(h, w) of a level's arguments; raises on what the kernel does not
    take."""
    if not 0 <= level < 30:
        raise ValueError(f"atrous: level must lie in [0, 30), got {level}")
    if e_img < 0 or e_view < 0:
        raise ValueError(f"atrous: row extensions must be >= 0, got "
                         f"{e_img}, {e_view}")
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"atrous: img must be (h, w, 3), got "
                         f"{tuple(img.shape)}")
    h, w = img.shape[0] - 2 * e_img, img.shape[1]
    if h < 1 or w < 1:
        raise ValueError(f"atrous: img {tuple(img.shape)} holds no pixel "
                         f"under e = {e_img}")
    hv = h + 2 * e_view
    named = [("img", img, F32, (img.shape[0], w, 3)),
             ("view.pos", view.pos, F32, (hv, w, 3)),
             ("view.nrm", view.nrm, F32, (hv, w, 3)),
             ("view.mat_hash", view.mat_hash, I64, (hv, w)),
             ("view.valid", view.valid, BOOL, (hv, w))]
    named += [(f"sigma_{n}", s, F32, ())
              for n, s in zip(("lum", "norm", "depth"), sigmas)]
    if out is not None:
        named.append(("out", out, F32, (h, w, 3)))
    dev = img.device
    for label, a, dtype, shape in named:
        if a.dtype != dtype:
            raise ValueError(f"atrous: {label} must be {dtype}, got "
                             f"{a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"atrous: {label} must be {shape}, got "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"atrous: all inputs must be on {dev}, "
                             f"{label} is on {a.device}")
    if out is not None and not out.is_contiguous():
        raise ValueError("atrous: out must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"atrous: the kernel takes CUDA tensors, got {dev} "
                         "(the CPU runs render/denoise.py's torch level)")
    return h, w


def launcher(img, view: View, level: int, sigma_lum, sigma_norm,
             sigma_depth, out=None, e_img: int = 0, e_view: int = 0):
    """(launch, out) for one level with the wrapper's checks done and the
    output allocated (torch.empty) unless given; `launch()` only launches
    the kernel on the current stream (it does not count).  `run_level`
    calls it once; chip_smoke.py times it alone."""
    sigmas = (sigma_lum, sigma_norm, sigma_depth)
    h, w = _check(img, view, level, sigmas, e_img, e_view, out)
    if out is None:
        out = torch.empty((h, w, 3), dtype=F32, device=img.device)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    args = [ptr(img), *img.stride(), e_img,
            ptr(view.pos), *view.pos.stride(),
            ptr(view.nrm), *view.nrm.stride(),
            ptr(view.mat_hash), *view.mat_hash.stride(),
            ptr(view.valid), *view.valid.stride(),
            e_view, h, w, level, *[ptr(s) for s in sigmas], ptr(out),
            ctypes.c_void_p(
                torch.cuda.current_stream(img.device).cuda_stream)]
    fn = _lib().eidola_atrous_level

    def launch(_alive=(img, view, sigmas, out)):
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"atrous: CUDA launch failed with cudaError_t "
                               f"{err}")

    return launch, out


def run_level(img, view: View, level: int, sigma_lum, sigma_norm,
              sigma_depth, out=None, e_img: int = 0, e_view: int = 0):
    """One a-trous level at stride 2^level of the (h + 2 e_img, w, 3)
    image on the card, rows clamped to the planes' extensions and columns
    to the image: (h, w, 3) in `out` (allocated if None); one launch on
    the current stream, counted in LAUNCHES."""
    global LAUNCHES
    launch, out = launcher(img, view, level, sigma_lum, sigma_norm,
                           sigma_depth, out, e_img, e_view)
    launch()
    LAUNCHES += 1
    return out


def run_levels(img, view: View, levels: int, sigma_lum, sigma_norm,
               sigma_depth, e_view: int = 0,
               exchange: Optional[Callable] = None):
    """Levels 0..levels-1 of the (h, w, 3) image on the card, one launch
    each, ping-ponging between two buffers.  `exchange(img, pad)`, where
    given (a shard context), returns the image with `pad` rows from the
    neighbours above and below; `view` then carries `e_view` rows each
    side, at least the last level's pad."""
    if levels <= 0:
        return img
    bufs = [torch.empty((img.shape[0], img.shape[1], 3), dtype=F32,
                        device=img.device) for _ in range(min(levels, 2))]
    for lv in range(levels):
        pad = 2 << lv
        src, e_img = (img, 0) if exchange is None else (exchange(img, pad),
                                                        pad)
        img = run_level(src, view, lv, sigma_lum, sigma_norm, sigma_depth,
                        out=bufs[lv % 2], e_img=e_img, e_view=e_view)
    return img
