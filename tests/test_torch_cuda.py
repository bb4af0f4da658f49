"""The port's hand-written CUDA kernels against their plain versions.

Needs a CUDA device (marked `cuda`; skips without one) and imports no JAX,
so it runs on a machine with the card but no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: the suite's conftest.py configures JAX.)  Built without
FMA contraction, each kernel must agree with its plain version bit for
bit, invalid tail rows included.
"""
import pytest
import torch

from eidola_tpu_torch.ops import bvh_fused as TF
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
