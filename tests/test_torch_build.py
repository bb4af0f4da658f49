"""The build key of the port's native libraries (utils/cuda_build.py).

A library is named by a hash of its source, every header the source
reaches through `#include "..."` and the compiler flags, so that editing
a shared header (csrc/mt_tri4.cuh, included by both drain sources)
builds new libraries instead of loading stale ones.  Nothing is compiled
here: `Build` only hashes until it is started.
"""
import os

import pytest

from eidola_tpu_torch.utils.cuda_build import SRC_DIR, Build, local_includes

HEAD = ["nvcc", "-O3"]


def _tree(tmp_path):
    (tmp_path / "a.cuh").write_text("#define X 1\n")
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "b.cuh"\n#include <stdint.h>\n'
                   '  #  include "a.cuh"\n')
    return src


def test_includes_are_followed_once_in_order(tmp_path):
    src = _tree(tmp_path)
    assert local_includes(str(src)) == [str(src), str(tmp_path / "b.cuh"),
                                        str(tmp_path / "a.cuh")]
    drains = [local_includes(os.path.join(SRC_DIR, f"{name}.cu"))
              for name in ("bvh_fused", "bvh_mxu")]
    assert all(paths[1:] == [os.path.join(SRC_DIR, "mt_tri4.cuh")]
               for paths in drains)


def test_key_follows_headers_and_flags(tmp_path):
    src = _tree(tmp_path)
    out = Build("k", str(src), HEAD).out
    assert Build("k", str(src), HEAD).out == out
    assert Build("k", str(src), ["nvcc", "-O2"]).out != out
    (tmp_path / "a.cuh").write_text("#define X 2\n")    # a nested header
    changed = Build("k", str(src), HEAD).out
    assert changed != out
    (tmp_path / "k.cu").write_text(src.read_text() + "\n")
    assert Build("k", str(src), HEAD).out != changed


@pytest.mark.parametrize("name,headers", [
    ("alpha_lap", ["scene_fetch.cuh"]), ("shade_state", ["scene_fetch.cuh"]),
    ("atrous", []), ("bvh_walk", [])])
def test_kernels_reach_their_shared_headers(name, headers):
    """The lap and shading-state kernels share csrc/scene_fetch.cuh (the
    texture fetch, the instance search), so its edits rebuild both."""
    paths = local_includes(os.path.join(SRC_DIR, f"{name}.cu"))
    assert paths[1:] == [os.path.join(SRC_DIR, h) for h in headers]
