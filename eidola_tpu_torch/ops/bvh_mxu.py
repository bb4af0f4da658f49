"""Per-event leaf intersection as one product per event (port of
eidola_tpu/ops/bvh_mxu.py).

Moller-Trumbore's four determinant forms are linear in ten ray features
f = [o', d, o' x d, 1] (o' = o - anchor, the leaf's first vertex), so an
event's leaf of n triangles is a (4n x 10) @ (10 x 128) product of
coefficients (`build_cmat`) and its lanes' features (`build_feats`),
followed by the epilogue (det guard 1e-12, inv = 1/det, t/u/v = num x
inv, inside test, tmin < t < tlim) and the per-lane minimum over the n
triangles, lowest index on ties.  Nothing folds across events: the
caller (`ops/bvh.py:_traverse` under EIDOLA_MT=mxu) folds each
sub-packet's events itself.

- On a CUDA tensor `mt_mxu` launches the hand-written kernel of
  `csrc/bvh_mxu.cu` (built with nvcc at first use), which builds each
  event's nonzero coefficients in shared memory from its leaf row, and
  counts the launch in `LAUNCHES`; `launcher` gives the bare launch,
  which chip_smoke.py times alone.
- On a CPU tensor it runs the plain-torch version `mt_mxu_ref`, which
  repeats the kernel's arithmetic in the same order (each dot sums its
  19 nonzero coefficients' products in feature order, as the fused
  drains do: `_dots_sparse`), in slices of at most 4096 events: with the
  kernel built without FMA contraction the two agree bit for bit.  The
  dense sum over all ten features that the Pallas kernel's product
  computes differs from it only in the sign of an exact zero.

All f32: on the TPU this product ran in bf16 (bvh_mxu.py:33-36); the
port keeps every drain exact.
"""
from __future__ import annotations

import ctypes

import torch

from .bvh_fused import KDIM, LANES, NFEAT, _dots_sparse, _features

_BIG = 1e30
CHUNK = 4096    # events per slice of the plain version

LAUNCHES = {"mt_mxu": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def build_cmat(row, n_tris: int):
    """Per-event coefficient matrix (bvh_mxu.py:39-65): row (CE, n*12)
    f32 leaf rows of (v0, e1, e2, pad) per triangle -> (cmat (CE, 4n,
    KDIM) f32, rows [det | t_num | u_num | v_num] over the features
    [o', d, o' x d, 1, 0...], anchor (CE, 3)); each coefficient computed
    as the kernel computes it."""
    ce = row.shape[0]
    tri = row.reshape(ce, n_tris, 12)
    c = lambda i: tri[:, :, i]
    anchor = tri[:, 0, 0:3]
    v0x = c(0) - anchor[:, 0:1]
    v0y = c(1) - anchor[:, 1:2]
    v0z = c(2) - anchor[:, 2:3]
    e1x, e1y, e1z, e2x, e2y, e2z = c(3), c(4), c(5), c(6), c(7), c(8)
    nx, ny, nz = _cross(e1x, e1y, e1z, e2x, e2y, e2z)
    const_t = -((v0x * nx + v0y * ny) + v0z * nz)
    ux, uy, uz = _cross(v0x, v0y, v0z, e2x, e2y, e2z)
    wx, wy, wz = _cross(e1x, e1y, e1z, v0x, v0y, v0z)
    z = torch.zeros_like(nx)
    pad = (z,) * (KDIM - NFEAT)
    blocks = (
        (z, z, z, -nx, -ny, -nz, z, z, z, z),
        (nx, ny, nz, z, z, z, z, z, z, const_t),
        (z, z, z, ux, uy, uz, e2x, e2y, e2z, z),
        (z, z, z, wx, wy, wz, -e1x, -e1y, -e1z, z),
    )
    return torch.cat([torch.stack(b + pad, dim=-1) for b in blocks],
                     dim=1), anchor


def build_feats(anchor, ox, oy, oz, dx, dy, dz):
    """(CE, KDIM, 128) feature stack [o', d, o' x d, 1, 0...]
    (bvh_mxu.py:68-80)."""
    f = _features(anchor, ox, oy, oz, dx, dy, dz)
    return torch.cat([f, f.new_zeros((f.shape[0], KDIM - NFEAT,
                                      f.shape[2]))], dim=1)


def mt_mxu_ref(row, n_tris: int, ox, oy, oz, dx, dy, dz, t_min, t_lim,
               chunk: int = CHUNK):
    """Plain-torch `mt_mxu`: per-lane best (t, k, u, v) of each event's
    leaf, t = 1e30, k = 0, u = v = 0 on a miss (no hit below 1e30)."""
    n = n_tris
    out = []
    for s in range(0, row.shape[0], chunk):
        e = slice(s, s + chunk)
        cm, anchor = build_cmat(row[e], n)
        feats = _features(anchor, ox[e], oy[e], oz[e], dx[e], dy[e], dz[e])
        # the fused drains' dot: the nonzero products in feature order
        det, tn, un, vn = _dots_sparse(cm.transpose(1, 2), feats, n)
        ok = torch.abs(det) > 1e-12
        inv = torch.where(ok, 1.0 / det, 0.0)
        t, u, v = tn * inv, un * inv, vn * inv
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min[e][:, None]) & (t < t_lim[e][:, None]))
        tm = torch.where(hit, t, _BIG)
        tb = torch.amin(tm, dim=1)
        kidx = torch.arange(n, device=row.device, dtype=torch.int32)
        kb = torch.amin(torch.where(tm <= tb[:, None], kidx[None, :, None],
                                    n), dim=1)
        miss = tb >= _BIG
        ub = torch.gather(u, 1, kb[:, None].long()).squeeze(1)
        vb = torch.gather(v, 1, kb[:, None].long()).squeeze(1)
        out.append((torch.where(miss, _BIG, tb),
                    torch.where(miss, 0, kb).to(torch.int32),
                    torch.where(miss, 0.0, ub), torch.where(miss, 0.0, vb)))
    return tuple(torch.cat(x) for x in zip(*out))


def _check(row, n_tris: int, planes):
    dev = row.device
    ce = row.shape[0]
    if row.dtype != torch.float32 or row.dim() != 2 or \
            row.shape[1] != 12 * n_tris:
        raise ValueError(f"mt_mxu: row must be f32 (CE, {12 * n_tris}), got "
                         f"{tuple(row.shape)} {row.dtype}")
    for a in planes:
        if a.dtype != torch.float32 or tuple(a.shape) != (ce, LANES):
            raise ValueError(f"mt_mxu: ray planes must be f32 ({ce}, "
                             f"{LANES}), got {tuple(a.shape)} {a.dtype}")
        if a.device != dev:
            raise ValueError(f"mt_mxu: all inputs must be on {dev}")
    if dev.type == "cuda" and n_tris not in (8, 64):
        raise ValueError(f"mt_mxu: the CUDA kernel is built for leaf sizes "
                         f"8 and 64, got {n_tris}")


def _lib():
    from ..utils.cuda_build import load

    lib = load("bvh_mxu")
    if not getattr(lib, "_eidola_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.eidola_mt_mxu.argtypes = [P] * 13 + [I, I, P]
        lib.eidola_mt_mxu.restype = I
        lib._eidola_typed = True
    return lib


def launcher(row, n_tris: int, *planes):
    """(launch, outputs) for a CUDA call of `mt_mxu` with its arguments:
    the inputs made contiguous once and the outputs allocated; `launch()`
    only launches the kernel on the current stream (it does not count).
    The wrapper calls it once; chip_smoke.py times it alone."""
    ce = row.shape[0]
    ins = [row.contiguous()] + [p.contiguous() for p in planes]
    t = torch.empty((ce, LANES), dtype=torch.float32, device=row.device)
    outs = (t, torch.empty((ce, LANES), dtype=torch.int32, device=row.device),
            torch.empty_like(t), torch.empty_like(t))
    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in (*ins, *outs)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = _lib().eidola_mt_mxu

    def launch(_alive=(ins, outs)):   # the tensors behind `ptrs`
        err = fn(*ptrs, ce, n_tris, stream)
        if err != 0:
            raise RuntimeError(f"mt_mxu: CUDA launch failed with "
                               f"cudaError_t {err}")

    return launch, outs


def mt_mxu(row, n_tris: int, ox, oy, oz, dx, dy, dz, t_min, t_lim):
    """Per-event leaf intersection (bvh_mxu.py:127-164): row (CE, n*12)
    gathered leaf rows; rays and bounds (CE, 128) f32.  Returns per-lane
    best (t f32, k int32, u f32, v f32), each (CE, 128); t = 1e30 and
    k = u = v = 0 where nothing hit."""
    planes = (ox, oy, oz, dx, dy, dz, t_min, t_lim)
    _check(row, n_tris, planes)
    if row.device.type == "cpu":
        return mt_mxu_ref(row, n_tris, *planes)
    if row.device.type != "cuda":
        raise ValueError(f"mt_mxu: unsupported device {row.device}")
    launch, out = launcher(row, n_tris, *planes)
    launch()
    LAUNCHES["mt_mxu"] += 1
    return out
