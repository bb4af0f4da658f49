"""The frozen walk bound agrees with chip_smoke.py's on a recorded case:
the bistro_flat 1080p primary walk (16,200 packets, 2,025,502 steps,
223,824 leaf events; bound 1.5472 ms, operations), and on an instanced
case."""
import pytest
import torch

from benchmark import roofline


def _case(P, steps, events, nodes, leaves, n, inst):
    walk = torch.zeros((nodes, 8))
    leaf_blocks = torch.zeros((leaves, n * 12))
    rays = torch.zeros((8, P, 128))
    st = torch.zeros((P, 2), dtype=torch.int64)
    st[0] = torch.tensor([steps, events])
    ins = None
    if inst:
        ins = (torch.zeros(leaves, dtype=torch.int32),
               torch.zeros(leaves, dtype=torch.int32), torch.zeros((50, 12)))
    launch = roofline.Launch(steps, events, nodes, leaves, n, rays.numel(),
                             rays[0].numel(), leaves if inst else 0,
                             50 if inst else 0)
    return (walk, leaf_blocks, rays, st, ins), launch


@pytest.mark.parametrize("inst", [False, True])
def test_walk_bound_agrees_with_chip_smoke(inst):
    import chip_smoke

    args, launch = _case(16200, 2025502, 223824, 90000, 45000, 64, inst)
    assert roofline.walk_bound(launch) == chip_smoke.walk_bound(*args)


def test_recorded_flat_primary():
    _, launch = _case(16200, 2025502, 223824, 90000, 45000, 64, False)
    ms, what = roofline.walk_bound(launch)
    assert what == "operations"
    assert round(ms, 4) == 1.5472
