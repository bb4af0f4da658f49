"""Host -> device transfer of numpy trees (the port's counterpart of
eidola_tpu/utils/transfer.py).

`to_device` moves a tree leaf by leaf; `batched_device_put` gives the same
tensors with one host-to-device copy per dtype, as the JAX package
uploads a scene (one `device_put` per dtype instead of ~40 transfers,
SURVEY §5.8).  `COPIES` counts the host-to-device copies of both (none
for a CPU device).
"""
from __future__ import annotations

import numpy as np
import torch

# every leaf of a batched upload starts at a multiple of ALIGN bytes, where
# cudaMalloc would start it: the kernels read tables with 16-byte cp.async
ALIGN = 256
COPIES = [0]


def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _host(leaf) -> np.ndarray:
    """A numpy leaf as `to_device` converts it: integers to int64, floats
    to f32, the rest as they are."""
    a = np.asarray(leaf)
    if a.dtype.kind in "iu":
        return a.astype(np.int64, copy=False)
    if a.dtype.kind == "f":
        return a.astype(np.float32, copy=False)
    return a


def to_device(tree, device):
    """numpy leaves of a NamedTuple tree -> tensors on `device` (int64
    for every integer dtype, f32 for floats); tensors move as they are."""
    if tree is None:
        return None
    if _is_tree(tree):
        return type(tree)(*[to_device(x, device) for x in tree])
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = _host(tree)
    t = torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable
                         else a.copy())
    if torch.device(device).type != "cpu":
        COPIES[0] += 1
    return t.to(device)


def _aligned_empty(n: int, dtype, device):
    """n elements of `dtype` on `device` whose first one sits at a
    multiple of ALIGN bytes."""
    item = torch.empty((), dtype=dtype).element_size()
    raw = torch.empty(n + ALIGN // item, dtype=dtype, device=device)
    shift = (-raw.data_ptr() % ALIGN) // item
    return raw[shift:shift + n]


def batched_device_put(tree, device):
    """`to_device(tree, device)` with one host-to-device copy per dtype:
    the numpy leaves of each converted dtype are staged in one pageable
    host buffer, each leaf at an ALIGN-byte offset, copied in one piece
    and sliced back into their shapes on the device; on the CPU the
    leaves are views of the staging buffer itself.  Nothing stays
    page-locked after the call.  A leaf is a view of its dtype's blob, so
    it keeps the whole blob alive.  Tensors move as `to_device` moves
    them; None stays None."""
    device = torch.device(device)
    leaves: list = []

    def flatten(x):
        if _is_tree(x):
            return type(x), [flatten(v) for v in x]
        leaves.append(x)
        return len(leaves) - 1

    spec = flatten(tree)
    groups: dict = {}
    out = list(leaves)
    for i, x in enumerate(leaves):
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            out[i] = x.to(device)
            continue
        a = _host(x)
        groups.setdefault(a.dtype, []).append((i, a))
    for dt, group in groups.items():
        item = dt.itemsize
        offs, n = [], 0
        for _, a in group:
            offs.append(n)
            n += -(-a.size * item // ALIGN) * ALIGN // item
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        blob = stage = _aligned_empty(n, tdt, "cpu")
        view = stage.numpy()
        for (_, a), off in zip(group, offs):
            view[off:off + a.size] = a.reshape(-1)
        if device.type != "cpu":
            blob = _aligned_empty(n, tdt, device)
            blob.copy_(stage)
            COPIES[0] += 1
        for (i, a), off in zip(group, offs):
            out[i] = blob[off:off + a.size].view(a.shape)

    def build(s):
        if isinstance(s, int):
            return out[s]
        cls, kids = s
        return cls(*[build(k) for k in kids])

    return build(spec)
