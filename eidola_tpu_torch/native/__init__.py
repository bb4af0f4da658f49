"""C++ host builders of the port (alias tables, binned-SAH BVH) and the
octahedral normal codec, bound with ctypes.

`src/eidola_native.cpp` is compiled with g++ at first use into the
git-ignored `eidola_tpu_torch/_build/` (utils/cuda_build.Build, named by a
hash of the source and the flags).  `get_lib()` returns None when no C++
compiler is available or EIDOLA_NO_NATIVE is set; callers then use the
numpy builders, which emit the same arrays.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from ..utils.cuda_build import Build, build_together

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "eidola_native.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False


def native_build():
    """The g++ build of the host builders, or None without a compiler."""
    gxx = shutil.which("g++")
    return None if gxx is None else Build("eidola_native", _SRC,
                                          [gxx, *GXX_FLAGS])


def _bind(path: str):
    lib = ctypes.CDLL(path)
    c = ctypes
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    lib.eidola_build_alias.restype = c.c_double
    lib.eidola_build_alias.argtypes = [f64p, c.c_int64, i32p, f32p, f32p,
                                       f32p]
    lib.eidola_build_bvh.restype = c.c_int64
    lib.eidola_build_bvh.argtypes = [
        f32p, f32p, f32p, c.c_int64, c.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p, i64p,
    ]
    lib.eidola_oct_encode.restype = None
    lib.eidola_oct_encode.argtypes = [f32p, c.c_int64, u32p]
    lib.eidola_oct_decode.restype = None
    lib.eidola_oct_decode.argtypes = [u32p, c.c_int64, f32p]
    return lib


def get_lib():
    """Load (compiling if needed) the native library; None if unavailable
    or when EIDOLA_NO_NATIVE is set (read at each call; the JAX package
    reads it at its first load), so the numpy builders run."""
    global _lib, _tried
    if os.environ.get("EIDOLA_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        build = native_build()
        if build is None:
            return None
        try:
            build_together([build])
        except (OSError, RuntimeError):
            return None
        _lib = _bind(build.out)
        return _lib


def build_alias_native(weights: np.ndarray):
    """Native alias-table build; returns (alias, q, pdf, alias_pdf, total)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(weights, np.float64).ravel()
    n = w.size
    alias = np.empty(n, np.int32)
    q = np.empty(n, np.float32)
    pdf = np.empty(n, np.float32)
    alias_pdf = np.empty(n, np.float32)
    total = lib.eidola_build_alias(w, n, alias, q, pdf, alias_pdf)
    return alias, q, pdf, alias_pdf, float(total)


def build_bvh_native(tb_min, tb_max, centroid, leaf_size: int):
    """Native SAH build + flatten; returns (bmin, bmax, escape, blk,
    leaf_tris_list) matching ops/bvh_build.py, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tb_min = np.ascontiguousarray(tb_min, np.float32)
    tb_max = np.ascontiguousarray(tb_max, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    T = tb_min.shape[0]
    cap = 2 * T + 2
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    escape = np.empty(cap, np.int32)
    blk = np.empty(cap, np.int32)
    leaf_tris = np.empty(T, np.int32)
    leaf_start = np.empty(T + 2, np.int32)
    n_leaves = np.zeros(1, np.int64)
    n_nodes = lib.eidola_build_bvh(
        tb_min.reshape(-1), tb_max.reshape(-1), centroid.reshape(-1),
        T, leaf_size, bmin.reshape(-1), bmax.reshape(-1), escape, blk,
        leaf_tris, leaf_start, n_leaves,
    )
    if n_nodes < 0:
        return None
    L = int(n_leaves[0])
    leaves = [leaf_tris[leaf_start[i]:leaf_start[i + 1]].astype(np.int64)
              for i in range(L)]
    return (bmin[:n_nodes].copy(), bmax[:n_nodes].copy(),
            escape[:n_nodes].astype(np.int64), blk[:n_nodes].astype(np.int64),
            leaves)


def oct_encode_native(normals: np.ndarray):
    """(..., 3) f32 unit vectors -> (...) uint32 octahedral words, or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = np.ascontiguousarray(normals, np.float32)
    count = n.reshape(-1, 3).shape[0]
    out = np.empty(count, np.uint32)
    lib.eidola_oct_encode(n.reshape(-1), count, out)
    return out.reshape(normals.shape[:-1])


def oct_decode_native(packed: np.ndarray):
    """(...) uint32 octahedral words -> (..., 3) f32 unit vectors, or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(packed, np.uint32).reshape(-1)
    out = np.empty(p.size * 3, np.float32)
    lib.eidola_oct_decode(p, p.size, out)
    return out.reshape(np.shape(packed) + (3,))
