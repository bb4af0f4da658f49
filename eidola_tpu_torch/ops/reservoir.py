"""Weighted-reservoir (ReSTIR) algebra (port of eidola_tpu/ops/reservoir.py;
ref shaders/reservoir.glsl:26-128).

A reservoir is a dict {"sample": dict of per-lane tensors, "num": f32 M,
"weight": f32 wSum}; every op is vectorized over the lane shape."""
from __future__ import annotations

import torch


def _select_sample(cond, new_sample, old_sample):
    def sel(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)

    return {k: sel(new_sample[k], old_sample[k]) for k in old_sample}


def make_reservoir(sample, lane_shape, *, device):
    return {
        "sample": sample,
        "num": torch.zeros(lane_shape, dtype=torch.float32, device=device),
        "weight": torch.zeros(lane_shape, dtype=torch.float32, device=device),
    }


def resv_check(resv):
    """NaN guard (ref reservoir.glsl:26-44)."""
    bad = ~torch.isfinite(resv["weight"])
    out = dict(resv)
    out["weight"] = torch.where(bad, 0.0, resv["weight"])
    out["num"] = torch.where(bad, 0.0, resv["num"])
    return out


def resv_update(resv, sample, weight, u):
    """Streaming RIS update with one candidate per lane
    (ref reservoir.glsl:46-60)."""
    weight = torch.where(torch.isfinite(weight) & (weight >= 0.0), weight, 0.0)
    w_sum = resv["weight"] + weight
    take = u * w_sum < weight
    out = dict(resv)
    out["weight"] = w_sum
    out["num"] = resv["num"] + 1.0
    out["sample"] = _select_sample(take, sample, resv["sample"])
    return out


def resv_merge_same_target(resv, other, u, enabled=None):
    """Merge two reservoirs sharing a target function
    (ref reservoir.glsl:62-82)."""
    other = resv_check(other)
    ow = other["weight"]
    on = other["num"]
    if enabled is not None:
        ow = torch.where(enabled, ow, 0.0)
        on = torch.where(enabled, on, 0.0)
    w_sum = resv["weight"] + ow
    take = u * w_sum < ow
    out = dict(resv)
    out["weight"] = w_sum
    out["num"] = resv["num"] + on
    out["sample"] = _select_sample(take, other["sample"], resv["sample"])
    return out


def resv_clamp(resv, max_num):
    """M-clamp bounding temporal staleness (ref reservoir.glsl:116-128)."""
    num = resv["num"]
    scale = torch.where(num > max_num, max_num / torch.clamp(num, min=1e-20),
                        1.0)
    out = dict(resv)
    out["num"] = torch.minimum(num, max_num)
    out["weight"] = resv["weight"] * scale
    return out


def resv_big_w(resv, p_hat):
    """Unbiased contribution weight W = wSum / (M * pHat)."""
    denom = resv["num"] * p_hat
    return torch.where(denom > 1e-20,
                       resv["weight"] / torch.clamp(denom, min=1e-20), 0.0)
