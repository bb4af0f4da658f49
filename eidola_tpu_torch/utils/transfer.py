"""Host -> device transfer of numpy trees (the port's counterpart of
eidola_tpu/utils/transfer.py)."""
from __future__ import annotations

import numpy as np
import torch


def to_device(tree, device):
    """numpy leaves of a NamedTuple tree -> tensors on `device` (int64
    for every integer dtype, f32 for floats); tensors move as they are."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[to_device(x, device) for x in tree])
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = np.asarray(tree)
    t = torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable
                         else a.copy())
    if a.dtype.kind in "iu":
        t = t.to(torch.int64)
    elif a.dtype.kind == "f":
        t = t.to(torch.float32)
    return t.to(device)
