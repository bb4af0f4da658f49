"""Build the port's CUDA sources with nvcc into shared libraries with a
plain C interface, and load them with ctypes.

Sources live in `eidola_tpu_torch/csrc/`; libraries go to the
git-ignored `eidola_tpu_torch/_build/`, named by a hash of the source and
the nvcc flags, so a change to either builds a new library.  Nothing is
built at import time: `load(name)` builds on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no FMA contraction, so kernels round every product and sum
# like their plain torch versions (bitwise agreement); no fast math.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (looked on PATH and /usr/local/cuda/bin)")
    return path


def lib_path(name: str) -> str:
    """_build/lib<name>-<hash>.so, the hash over csrc/<name>.cu and the
    flags."""
    with open(os.path.join(SRC_DIR, name + ".cu"), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def _build(name: str, out: str, timeout: float = 600.0) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{proc.stdout}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = lib_path(name)
        if not os.path.exists(out):
            _build(name, out)
        lib = _libs[name] = ctypes.CDLL(out)
    return lib
