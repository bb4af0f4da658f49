"""Octant-ordered walk tables: direction-aware descent for the stackless
packet walk.

The preorder/escape-link walk (ops/bvh.py) visits children in a FIXED
order (left first), so for ~half of all rays the FAR child is explored
before the near one: t_best tightens late and the walk pushes leaf events
that a near-first order would have pruned.  Classic GPU fix is a stack
with per-node ordered descent; the stackless TPU analog is PRECOMPUTED
THREADINGS — one preorder table per ray-direction octant, where every
internal node's children are swapped iff the ray direction is negative
along the node's split axis (so the near child always comes first).
Traversal picks ONE table per 128-ray packet by majority direction sign
and walks it exactly like the default table (same gather cost, same
escape-link semantics).  This replaces the ordered `rayQueryProceedEXT`
descent the reference gets from the hardware traversal unit
(ref shaders/traceray_rq.glsl:108-147).

Build input is the already-flattened (N, 8) walk array — topology is
reconstructed from the escape links, so this works unchanged for the
flattened scene walk AND the instanced/grafted world walk:

- subtree size:   size[i] = (escape[i] if >= 0 else N) - i
- internal node:  left = i + 1, right = i + 1 + size[left]
- split axis:     argmax |center(left) - center(right)|  (the child boxes
  themselves record the build split; no builder cooperation needed)

Results are identical up to exact-t ties (the drain keeps the FIRST of
equal-t hits, which is visit-order dependent); geometry tests compare t.
"""
from __future__ import annotations

import numpy as np

OCTS = 8


def _topology(walk: np.ndarray):
    """Reconstruct (size, left, right, axis, is_leaf) from a flattened
    preorder walk table (N, 8) [bmin, bmax, escape(i32 bits), leaf(i32)]."""
    n = walk.shape[0]
    esc = walk[:, 6].view(np.int32).astype(np.int64)
    leaf = walk[:, 7].view(np.int32)
    is_leaf = leaf >= 0
    size = np.where(esc >= 0, esc, n) - np.arange(n)
    left = np.where(is_leaf, -1, np.arange(n) + 1)
    right = np.where(
        is_leaf, -1, left + np.where(left < n, size[np.minimum(left, n - 1)], 0)
    )
    center = (walk[:, 0:3] + walk[:, 3:6]) * 0.5
    lc = np.clip(left, 0, n - 1)
    rc = np.clip(right, 0, n - 1)
    diff = np.abs(center[lc] - center[rc])
    axis = np.argmax(diff, axis=1)
    return size, left, right, axis, is_leaf


def build_octant_tables(walk: np.ndarray) -> np.ndarray:
    """(N, 8) flattened walk -> (8*N, 8) stacked per-octant tables.

    Octant index o = (dx<0) | (dy<0)<<1 | (dz<0)<<2; table o is the
    preorder emission where node children are swapped iff bit axis[i] of o
    is set (near child first for rays in that octant).  Escape links are
    table-local; traversal adds o*N to every gather row.
    """
    walk = np.asarray(walk, np.float32)
    n = walk.shape[0]
    size, left, right, axis, is_leaf = _topology(walk)
    swap_by_axis = np.empty((3, n), bool)
    center = (walk[:, 0:3] + walk[:, 3:6]) * 0.5
    for a in range(3):
        lc = np.clip(left, 0, n - 1)
        rc = np.clip(right, 0, n - 1)
        # near child for NEGATIVE direction along a = the larger center;
        # swap when left is the smaller one
        swap_by_axis[a] = center[lc, a] <= center[rc, a]

    out = np.empty((OCTS, n, 8), np.float32)
    out[0] = walk  # octant 0 (all positive) keeps the build order
    for o in range(1, OCTS):
        neg = np.array([o & 1, (o >> 1) & 1, (o >> 2) & 1], bool)
        swap = ~is_leaf & neg[axis] & swap_by_axis[axis, np.arange(n)]
        perm = np.empty(n, np.int64)     # new position -> old node
        esc = np.empty(n, np.int64)
        stack = [(0, -1)]
        cursor = 0
        while stack:
            node, e = stack.pop()
            me = cursor
            cursor += 1
            perm[me] = node
            esc[me] = e
            if left[node] >= 0:
                c1, c2 = left[node], right[node]
                if swap[node]:
                    c1, c2 = c2, c1
                second_pos = me + 1 + size[c1]
                stack.append((c2, e))
                stack.append((c1, second_pos))
        assert cursor == n
        out[o] = walk[perm]
        out[o, :, 6] = esc.astype(np.int32).view(np.float32)
    return out.reshape(OCTS * n, 8)
