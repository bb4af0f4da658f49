"""Build the port's native sources into shared libraries with a plain C
interface, and load them with ctypes.

CUDA sources live in `eidola_tpu_torch/csrc/` and are built with nvcc; the
C++ host builders (`eidola_tpu_torch/native/`) are built with g++ through
the same `Build`.  Libraries go to the git-ignored `eidola_tpu_torch/_build/`,
named by a hash of the source, the headers it includes from the repo and
the flags, so a change to any of them builds a new library.  Nothing is
built at import time: `load(name)` builds on first use, and
`build_together` starts several compilers at once and waits for all of
them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no FMA contraction, so kernels round every product and sum
# like their plain torch versions (bitwise agreement); no fast math.
# -Xptxas -v: each kernel's registers, spills and shared memory go to the
# build's log (see ptxas_summary).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
# every csrc/<name>.cu; chip_smoke.py builds them all at once
CUDA_SOURCES = ("alpha_lap", "atrous", "bvh_fused", "bvh_mxu", "bvh_walk",
                "shade_state")

_libs: dict[str, ctypes.CDLL] = {}
# the viewer renders from two threads; one builds and loads at a time
# (a build's temporary file is named by the process, not the thread)
_load_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (looked on PATH and /usr/local/cuda/bin)")
    return path


def local_includes(src: str) -> list[str]:
    """`src` and every file it reaches by `#include "..."` (resolved next
    to the including file), each once, in the order first reached."""
    seen = []
    todo = [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)
        todo += [os.path.join(os.path.dirname(path), n) for n in names]
    return seen


class Build:
    """One compiler run: `cmd_head + ["-o", tmp, src]` into `out`, where
    `out` is named by a hash of the source, the local headers it includes
    and `cmd_head[1:]`."""

    def __init__(self, name: str, src: str, cmd_head: list[str]):
        key = hashlib.sha256(" ".join(cmd_head[1:]).encode())
        for path in local_includes(src):
            with open(path, "rb") as f:
                key.update(f.read())
        self.name, self.src, self.cmd_head = name, src, cmd_head
        self.out = os.path.join(BUILD_DIR,
                                f"lib{name}-{key.hexdigest()[:16]}.so")
        self.proc = None
        self.tmp = None
        self.log = ""    # the compiler's output, once finished

    @property
    def built(self) -> bool:
        return os.path.exists(self.out)

    def start(self) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.tmp = f"{self.out}.{os.getpid()}.tmp"
        self.proc = subprocess.Popen(
            [*self.cmd_head, "-o", self.tmp, self.src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self, timeout: float = 600.0) -> None:
        try:
            log, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(f"{self.cmd_head[0]} failed building "
                               f"{self.name}:\n{log}")
        self.log = log
        os.replace(self.tmp, self.out)


def cuda_build(name: str) -> Build:
    """The nvcc build of csrc/<name>.cu."""
    return Build(name, os.path.join(SRC_DIR, name + ".cu"),
                 [_nvcc(), *NVCC_FLAGS])


def ptxas_summary(log: str) -> list[dict]:
    """The kernels of an nvcc log made with -Xptxas -v: one dict per entry
    function with its (mangled) name, registers, bytes of spill stores and
    loads, and bytes of static shared memory."""
    out = []
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers([^\n]*)", log,
            re.S):
        smem = re.search(r"(\d+) bytes smem", m.group(5))
        out.append({"kernel": m.group(1), "registers": int(m.group(4)),
                    "spill_stores": int(m.group(2)),
                    "spill_loads": int(m.group(3)),
                    "smem": int(smem.group(1)) if smem else 0})
    return out


def build_together(builds: list[Build]) -> None:
    """Start every build not yet on disk, then wait for all of them."""
    todo = [b for b in builds if not b.built]
    try:
        for b in todo:
            b.start()
    finally:
        for b in todo:
            if b.proc is not None:
                b.finish()


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(name)
            if lib is None:
                build = cuda_build(name)
                build_together([build])
                lib = _libs[name] = ctypes.CDLL(build.out)
    return lib
