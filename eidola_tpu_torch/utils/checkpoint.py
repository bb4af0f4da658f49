"""Frame-state checkpoint/restore (port of eidola_tpu/utils/checkpoint.py).

The reference has no checkpointing (SURVEY §5.4); the frame state here
is an explicit tree (render/frame.py FrameState), so a deterministic
save and resume is one npz.  Leaves are stored as leaf_0, leaf_1, ... in
jax.tree_util's order (NamedTuple fields in order, dict keys sorted,
None skipped), so a file saved by either package loads into the other's
template: integer leaves come back in the template's dtype (the port's
int64 words hold the JAX package's uint32 values).
"""
from __future__ import annotations

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The tensors of a tree (NamedTuples, tuples, lists, dicts; None
    skipped) in jax.tree_util's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if template is None:
        return None
    if isinstance(template, dict):
        filled = {k: tree_unflatten(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[tree_unflatten(x, leaves) for x in template])
    if isinstance(template, (tuple, list)):
        return type(template)(tree_unflatten(x, leaves) for x in template)
    return next(leaves)


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors (FrameState, reservoirs, ...) to npz."""
    np.savez_compressed(path, **{
        f"leaf_{i}": (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x))
        for i, x in enumerate(tree_leaves(tree))})


def load_pytree(path: str, template):
    """Load into the structure of `template` (e.g. init_frame_state(...)),
    each leaf on the template leaf's device in its dtype; a leaf count or
    shape that differs raises ValueError."""
    leaves = tree_leaves(template)
    with np.load(path) as data:
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"template needs {len(leaves)}")
        new = []
        for i, old in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if tuple(old.shape) != arr.shape:
                raise ValueError(f"shape mismatch: {tuple(old.shape)} vs "
                                 f"{arr.shape}")
            dtype = torch.empty((), dtype=old.dtype).numpy().dtype
            new.append(torch.from_numpy(np.array(arr, dtype, order="C"))
                       .to(old.device))
    return tree_unflatten(template, iter(new))
