"""Fused leaf drains (port of eidola_tpu/ops/bvh_fused.py).

`mt_fused` (closest hit) and `mt_any_fused` (occlusion) take a compacted
list of CE leaf events, each one (sub-packet, leaf) pair with 128 ray
lanes, intersect the lanes with the leaf's triangles through the static
per-leaf coefficient table, and fold the results per sub-packet: every
output row holds its segment's prefix fold (a segment is a run of
consecutive events of one sub-packet).

- On a CUDA tensor the wrapper launches the hand-written kernel of
  `csrc/bvh_fused.cu` (built with nvcc at first use) and counts the
  launch in `LAUNCHES`.
- On a CPU tensor it runs the plain-torch version (`mt_fused_ref`,
  `mt_any_fused_ref`), which computes the same arithmetic in the same
  order: each dot product sums features 0..9 in turn, so with the kernel
  built without FMA contraction the two agree bit for bit.

The table is always f32 here: the H100 has no bf16-only matrix path that
the TPU's drain had to feed (eidola_tpu/ops/bvh_fused.py:79-98).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

_BIG = 1e30
KDIM = 16       # feature rows of the table (10 used, padded like the TPU's)
NFEAT = 10
LANES = 128

LAUNCHES = {"mt_fused": 0, "mt_any_fused": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_leaf_tables_np(blocks: np.ndarray, leaf_size: int):
    """Static per-leaf MT coefficient table (bvh_fused.py:101-145), f32.

    blocks: (L, n*12) leaf rows of (v0, e1, e2, pad) per triangle.
    Returns (cmT (L, KDIM, 4n) f32, anchor (L, 3) f32); column blocks of
    cmT are [det | t_num | u_num | v_num] over the features
    [o'(3), d(3), o'xd(3), 1, 0...] with o' = o - anchor."""
    L = blocks.shape[0]
    n = leaf_size
    tri = blocks.reshape(L, n, 12).astype(np.float32)
    v0 = tri[:, :, 0:3]
    e1 = tri[:, :, 3:6]
    e2 = tri[:, :, 6:9]
    anchor = np.ascontiguousarray(v0[:, 0, :])
    v0c = v0 - anchor[:, None, :]
    nvec = np.cross(e1, e2)
    const_t = -np.sum(v0c * nvec, -1)

    cmT = np.zeros((L, KDIM, 4 * n), np.float32)
    b = cmT.reshape(L, KDIM, 4, n)

    def put(rows, block, val):
        b[:, rows:rows + 3, block, :] = val.transpose(0, 2, 1)

    put(3, 0, -nvec)                 # det  = -n . d
    put(0, 1, nvec)                  # t    =  n . o' + const
    b[:, 9, 1, :] = const_t
    put(3, 2, np.cross(v0c, e2))     # u    = (v0c x e2) . d + e2 . (o'xd)
    put(6, 2, e2)
    put(3, 3, np.cross(e1, v0c))     # v    = (e1 x v0c) . d - e1 . (o'xd)
    put(6, 3, -e1)
    return cmT, anchor.astype(np.float32)


# ---------------------------------------------------------------- helpers

def _features(anchor_row, gox, goy, goz, gdx, gdy, gdz):
    """(CE, NFEAT, 128) feature stack [o', d, o'xd, 1], o' = o - anchor."""
    ox = gox - anchor_row[:, 0:1]
    oy = goy - anchor_row[:, 1:2]
    oz = goz - anchor_row[:, 2:3]
    return torch.stack([ox, oy, oz, gdx, gdy, gdz,
                        oy * gdz - oz * gdy,
                        oz * gdx - ox * gdz,
                        ox * gdy - oy * gdx,
                        torch.ones_like(ox)], dim=1)


def _dots(cm, feats, n):
    """(CE, 4n, 128) = sum over features 0..9 in order (no reassociation)."""
    acc = cm[:, 0, :, None] * feats[:, None, 0, :]
    for k in range(1, NFEAT):
        acc = acc + cm[:, k, :, None] * feats[:, None, k, :]
    return acc[:, 0:n], acc[:, n:2 * n], acc[:, 2 * n:3 * n], acc[:, 3 * n:]


def segment_starts(sp, valid):
    """(CE,) bool: row 0, and every valid row whose sub-packet differs from
    the last valid row before it (an invalid row never starts a segment)."""
    ce = sp.shape[0]
    idx = torch.arange(ce, device=sp.device)
    last_valid = torch.cummax(torch.where(valid != 0, idx, -1), dim=0).values
    prev = torch.cat([last_valid.new_full((1,), -1), last_valid[:-1]])
    prev_sp = torch.where(prev >= 0, sp[prev.clamp(min=0)], -1)
    return (idx == 0) | ((valid != 0) & (sp != prev_sp))


def _start_row(starts):
    """(CE,) index of the segment start each row belongs to."""
    idx = torch.arange(starts.shape[0], device=starts.device)
    return torch.cummax(torch.where(starts, idx, 0), 0).values


def _check(name, cm_tab, anchor_row, ints, planes, n_tris):
    dev = cm_tab.device
    ce = planes[0].shape[0]
    if cm_tab.dtype != torch.float32 or cm_tab.dim() != 3 or \
            cm_tab.shape[1] != KDIM or cm_tab.shape[2] != 4 * n_tris:
        raise ValueError(f"{name}: cm_tab must be f32 (L, {KDIM}, "
                         f"{4 * n_tris}), got {tuple(cm_tab.shape)} "
                         f"{cm_tab.dtype}")
    if anchor_row.dtype != torch.float32 or tuple(anchor_row.shape) != (ce, 3):
        raise ValueError(f"{name}: anchor_row must be f32 ({ce}, 3)")
    for a in ints:
        if a.shape != (ce,) or a.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: event ids must be int ({ce},)")
    for a in planes:
        if a.dtype != torch.float32 or tuple(a.shape) != (ce, LANES):
            raise ValueError(f"{name}: ray planes must be f32 ({ce}, "
                             f"{LANES}), got {tuple(a.shape)} {a.dtype}")
    for a in (anchor_row, *ints, *planes):
        if a.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}")
    if dev.type == "cuda" and n_tris not in (8, 64):
        raise ValueError(f"{name}: the CUDA kernel is built for leaf sizes "
                         f"8 and 64, got {n_tris}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _i32(t):
    return t.to(torch.int32).contiguous()


def _lib():
    from ..utils.cuda_build import load

    lib = load("bvh_fused")
    if not getattr(lib, "_eidola_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.eidola_mt_fused.argtypes = [P] * 18 + [I, I, P]
        lib.eidola_mt_fused.restype = I
        lib.eidola_mt_any_fused.argtypes = [P] * 14 + [I, I, P]
        lib.eidola_mt_any_fused.restype = I
        lib._eidola_typed = True
    return lib


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


# ------------------------------------------------------------- closest hit

def mt_fused_ref(cm_tab, anchor_row, dma_row, gleaf, sp, valid,
                 gox, goy, goz, gdx, gdy, gdz, gtmin, gtb, n_tris: int,
                 chunk: int = 1024):
    """Plain-torch closest-hit drain with the kernel's exact semantics.

    Per event the carry-free first minimum over hits with t <= tlim equals
    the kernel's (whose filter is t <= carry): whenever it beats the carry
    the minima coincide, and otherwise `better` keeps the carry in both.
    The in-segment fold `better = tb <= base_t` (ties to the later event)
    is an associative argmin, evaluated as a segmented doubling scan and
    then merged with the segment seed (tlim, 0, 0, 0)."""
    ce, n = gox.shape[0], n_tris
    val = (valid != 0)[:, None]
    starts = segment_starts(sp, valid)
    # the segment seed: the carried-in best of the segment's first row
    seed = gtb[_start_row(starts)]
    tb_l, kb_l, ub_l, vb_l = [], [], [], []
    for s in range(0, ce, chunk):
        e = slice(s, min(s + chunk, ce))
        feats = _features(anchor_row[e], gox[e], goy[e], goz[e],
                          gdx[e], gdy[e], gdz[e])
        det, tn, un, vn = _dots(cm_tab[dma_row[e].long()], feats, n)
        ok = torch.abs(det) > 1e-12
        inv = torch.where(ok, 1.0 / det, 0.0)
        t, u, v = tn * inv, un * inv, vn * inv
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > gtmin[e][:, None]) & (t <= seed[e][:, None])
               & val[e][:, None])
        tm = torch.where(hit, t, _BIG)
        tb = torch.amin(tm, dim=1)
        kidx = torch.arange(n, device=gox.device)[None, :, None]
        kb = torch.amin(torch.where(tm <= tb[:, None], kidx, n), dim=1)
        tb_l.append(tb)
        kb_l.append(kb)
        ub_l.append(torch.gather(u, 1, kb[:, None]).squeeze(1))
        vb_l.append(torch.gather(v, 1, kb[:, None]).squeeze(1))
    tb, kb = torch.cat(tb_l), torch.cat(kb_l)
    ub, vb = torch.cat(ub_l), torch.cat(vb_l)
    slot = gleaf.long()[:, None] * n + kb

    seg = torch.cumsum(starts.long(), 0)
    sh = 1
    while sh < ce:
        same = (seg[sh:] == seg[:-sh])[:, None]
        take = same & (tb[sh:] > tb[:-sh])
        tb = torch.cat([tb[:sh], torch.where(take, tb[:-sh], tb[sh:])])
        slot = torch.cat([slot[:sh], torch.where(take, slot[:-sh], slot[sh:])])
        ub = torch.cat([ub[:sh], torch.where(take, ub[:-sh], ub[sh:])])
        vb = torch.cat([vb[:sh], torch.where(take, vb[:-sh], vb[sh:])])
        sh *= 2
    better = tb <= seed                    # merge the seed (tlim, 0, 0, 0)
    return (torch.where(better, tb, seed),
            torch.where(better, slot, 0).to(torch.int32),
            torch.where(better, ub, 0.0),
            torch.where(better, vb, 0.0))


def mt_fused(cm_tab, anchor_row, dma_row, gleaf, sp, valid,
             gox, goy, goz, gdx, gdy, gdz, gtmin, gtb, n_tris: int):
    """Closest-hit drain: per-row PREFIX-FOLDED (t, global slot, u, v)
    (CE, 128) — run-end rows hold each sub-packet's fold, as in
    eidola_tpu/ops/bvh_fused.py:mt_fused.  cm_tab: (L, 16, 4n) f32;
    anchor_row (CE, 3); dma_row/gleaf/sp/valid (CE,) int; rays and bounds
    (CE, 128) f32."""
    planes = (gox, goy, goz, gdx, gdy, gdz, gtmin, gtb)
    _check("mt_fused", cm_tab, anchor_row, (dma_row, gleaf, sp, valid),
           planes, n_tris)
    if cm_tab.device.type == "cpu":
        return mt_fused_ref(cm_tab, anchor_row, dma_row, gleaf, sp, valid,
                            *planes, n_tris)
    if cm_tab.device.type != "cuda":
        raise ValueError(f"mt_fused: unsupported device {cm_tab.device}")
    ce = gox.shape[0]
    starts = _i32(segment_starts(sp, valid))
    args = [cm_tab.contiguous(), anchor_row.contiguous(), _i32(dma_row),
            _i32(gleaf), _i32(valid), starts] + [p.contiguous() for p in planes]
    t = torch.empty((ce, LANES), dtype=torch.float32, device=gox.device)
    s = torch.empty((ce, LANES), dtype=torch.int32, device=gox.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    err = _lib().eidola_mt_fused(
        *[_ptr(a) for a in args], _ptr(t), _ptr(s), _ptr(u), _ptr(v),
        ce, n_tris, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, "mt_fused")
    LAUNCHES["mt_fused"] += 1
    return t, s, u, v


# ---------------------------------------------------------------- any hit

def mt_any_fused_ref(cm_tab, anchor_row, dma_row, sp, valid,
                     gox, goy, goz, gdx, gdy, gdz, gtmin, gtb, n_tris: int,
                     chunk: int = 1024):
    """Plain-torch occlusion drain: sign-based MT OR'd over triangles, then
    a segmented prefix-OR (reset at each segment start)."""
    ce, n = gox.shape[0], n_tris
    val = (valid != 0)[:, None]
    hits = []
    for s in range(0, ce, chunk):
        e = slice(s, min(s + chunk, ce))
        feats = _features(anchor_row[e], gox[e], goy[e], goz[e],
                          gdx[e], gdy[e], gdz[e])
        det, tn, un, vn = _dots(cm_tab[dma_row[e].long()], feats, n)
        det2 = det * det
        ud, vd, td = un * det, vn * det, tn * det
        h = ((torch.abs(det) > 1e-12) & (ud >= 0.0) & (vd >= 0.0)
             & (ud + vd <= det2) & (td > gtmin[e][:, None] * det2)
             & (td < gtb[e][:, None] * det2) & val[e][:, None])
        hits.append(h.any(dim=1))
    c = torch.cumsum(torch.cat(hits).to(torch.int64), 0)        # (CE, 128)
    start_row = _start_row(segment_starts(sp, valid))
    before = torch.where((start_row > 0)[:, None],
                         c[(start_row - 1).clamp(min=0)], 0)
    return ((c - before) > 0).to(torch.int32)


def mt_any_fused(cm_tab, anchor_row, dma_row, sp, valid,
                 gox, goy, goz, gdx, gdy, gdz, gtmin, gtb, n_tris: int):
    """Occlusion drain: per-row PREFIX-OR'd hit flags (CE, 128) int32, as
    in eidola_tpu/ops/bvh_fused.py:mt_any_fused (f32-exact tests)."""
    planes = (gox, goy, goz, gdx, gdy, gdz, gtmin, gtb)
    _check("mt_any_fused", cm_tab, anchor_row, (dma_row, sp, valid),
           planes, n_tris)
    if cm_tab.device.type == "cpu":
        return mt_any_fused_ref(cm_tab, anchor_row, dma_row, sp, valid,
                                *planes, n_tris)
    if cm_tab.device.type != "cuda":
        raise ValueError(f"mt_any_fused: unsupported device {cm_tab.device}")
    ce = gox.shape[0]
    starts = _i32(segment_starts(sp, valid))
    args = [cm_tab.contiguous(), anchor_row.contiguous(), _i32(dma_row),
            _i32(valid), starts] + [p.contiguous() for p in planes]
    h = torch.empty((ce, LANES), dtype=torch.int32, device=gox.device)
    err = _lib().eidola_mt_any_fused(
        *[_ptr(a) for a in args], _ptr(h), ce, n_tris,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, "mt_any_fused")
    LAUNCHES["mt_any_fused"] += 1
    return h
