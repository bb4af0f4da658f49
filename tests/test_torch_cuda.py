"""The port's hand-written CUDA kernels against their plain versions.

Needs a CUDA device (marked `cuda`; skips without one) and imports no JAX,
so it runs on a machine with the card but no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: the suite's conftest.py configures JAX.)  Built without
FMA contraction, each kernel must agree with its plain version bit for
bit, invalid tail rows included; the walk kernel against `walk_ref`
with group=1 (its one-block-per-packet semantics), outputs and per-packet
step and event counts alike.
"""
import numpy as np
import pytest
import torch

from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import bvh_fused as TF
from eidola_tpu_torch.ops import bvh_walk as TW
from eidola_tpu_torch.utils.drain_case import make_case, random_runs, torch_args

torch.set_num_threads(2)

CASES = [
    # (leaf size, leaves, runs, events, spread, seed)
    (8, 6, [3, 14, 1, 9, 2, 5], 48, 0.0, 7),
    (64, 6, [3, 14, 1, 9, 2, 5], 48, 0.0, 8),
    (64, 512, random_runs(1000, 32, 9), 1024, 20.0, 9),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("n,leaves,runs,ce,spread,seed", CASES)
def test_closest_kernel_matches_plain(cuda, n, leaves, runs, ce, spread, seed):
    c = make_case(n, leaves, runs, ce, seed, spread)
    args = torch_args(c, cuda, closest=True)
    before = TF.LAUNCHES["mt_fused"]
    out = TF.mt_fused(*args, n)
    ref = TF.mt_fused_ref(*args, n)
    torch.cuda.synchronize()
    assert TF.LAUNCHES["mt_fused"] == before + 1
    assert (out[0] < args[-1]).any(), "degenerate case: no hits"
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,leaves,runs,ce,spread,seed", CASES)
def test_any_kernel_matches_plain(cuda, n, leaves, runs, ce, spread, seed):
    c = make_case(n, leaves, runs, ce, seed, spread)
    args = torch_args(c, cuda, closest=False)
    before = TF.LAUNCHES["mt_any_fused"]
    h = TF.mt_any_fused(*args, n)
    ref = TF.mt_any_fused_ref(*args, n)
    torch.cuda.synchronize()
    assert TF.LAUNCHES["mt_any_fused"] == before + 1
    assert 0 < int(h.sum()) < h.numel()
    assert torch.equal(h, ref)


def _walk_case(dev, leaf_size, seed):
    """1500 triangles in a cluster, 1000 rays aimed into it (a third of
    them shadow-length, 24 dead); the rays pad to 8 packets."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (1500, 3)).astype(np.float32)
    v = [c + rng.normal(0, 0.3, (1500, 3)).astype(np.float32)
         for _ in range(3)]
    bvh = TB.build_bvh(*v, device=dev, leaf_size=leaf_size)
    o = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (1000, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(1000) % 3, 1e9, 4.0).astype(np.float32)
    tmax[:24] = -1.0
    rays = TW.pack_rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                        torch.full((1000,), 1e-4, device=dev),
                        torch.from_numpy(tmax).to(dev))
    return bvh, rays


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [8, 64])
@pytest.mark.parametrize("name", ["walk_closest", "walk_any"])
def test_walk_kernel_matches_plain(cuda, name, leaf_size):
    bvh, rays = _walk_case(cuda, leaf_size, seed=leaf_size)
    P = rays.shape[1]
    stats = torch.zeros((P, 2), dtype=torch.int32, device=cuda)
    ref_stats = torch.zeros_like(stats)
    before = TW.LAUNCHES[name]
    out = getattr(TW, name)(bvh.walk, bvh.leaf_blocks, rays, 100_000,
                            stats=stats)
    ref = TW.walk_ref(bvh.walk, bvh.leaf_blocks, rays, name == "walk_any",
                      100_000, group=1, stats=ref_stats)
    torch.cuda.synchronize()
    assert TW.LAUNCHES[name] == before + 1
    assert 0 < int((out[1] >= 0).sum()) < out[1].numel()
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(stats, ref_stats)
