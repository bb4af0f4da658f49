"""Host-side BVH construction: binned SAH topology + preorder/escape-link
flattening (replaces nvvk::RaytracingBuilderKHR's FAST_TRACE build,
ref src/accelstruct.cpp:110-162).

Two phases:
1. topology: greedy top-down binned SAH (16 centroid bins on the largest
   axis, leaf when SAH says stop or <= leaf_size tris)
2. flatten: preorder emission where `hit internal -> i+1` and
   `miss/leaf -> escape[i]` (escape(left)=preorder(right),
   escape(right)=escape(parent)) — the stackless-threading invariant the
   device traversal relies on (ops/bvh.py)

This is pure numpy (a copy of the JAX package's builders); the C++
builder of eidola_tpu_torch/native emits the SAH layout and is used for
multi-million-triangle scenes when g++ is present.
"""
from __future__ import annotations

import numpy as np

N_BINS = 16


def build_sah_topology(bmin, bmax, centroid, leaf_size: int):
    """Greedy binned-SAH tree over triangle index arrays.

    Returns parallel lists (left, right, node_tris) where leaves have
    left == -1 and node_tris holds their triangle indices, plus per-node
    bounds.  Iterative stack to avoid Python recursion limits.
    """
    T = bmin.shape[0]
    lefts, rights, bounds_min, bounds_max, node_tris = [], [], [], [], []

    def alloc():
        lefts.append(-1)
        rights.append(-1)
        bounds_min.append(None)
        bounds_max.append(None)
        node_tris.append(None)
        return len(lefts) - 1

    root = alloc()
    stack = [(root, np.arange(T, dtype=np.int64))]
    inv_total = 1.0

    while stack:
        node, idx = stack.pop()
        nb_min = bmin[idx].min(axis=0)
        nb_max = bmax[idx].max(axis=0)
        bounds_min[node] = nb_min
        bounds_max[node] = nb_max
        n = idx.size
        if n <= leaf_size:
            node_tris[node] = idx
            continue

        c = centroid[idx]
        c_min = c.min(axis=0)
        c_max = c.max(axis=0)
        ext = c_max - c_min
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            # all centroids coincide: arbitrary median split
            half = n // 2
            order = np.arange(n)
        else:
            # binned SAH
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            bin_id = ((c[:, axis] - c_min[axis]) * scale).astype(np.int64)
            counts = np.bincount(bin_id, minlength=N_BINS)
            binf_min = np.full((N_BINS, 3), np.inf)
            binf_max = np.full((N_BINS, 3), -np.inf)
            np.minimum.at(binf_min, bin_id, bmin[idx])
            np.maximum.at(binf_max, bin_id, bmax[idx])

            # prefix/suffix sweep
            lmin = np.minimum.accumulate(binf_min, axis=0)
            lmax = np.maximum.accumulate(binf_max, axis=0)
            rmin = np.minimum.accumulate(binf_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(binf_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = n - lcount

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(lmin, lmax) * lcount + np.concatenate(
                [area(rmin[1:], rmax[1:]) * rcount[:-1], [np.inf]]
            )
            cost = cost[:-1]  # split AFTER bin k, k in [0, N_BINS-2]
            best = int(np.argmin(cost))
            go_left = bin_id <= best
            nl = int(go_left.sum())
            if nl == 0 or nl == n:
                half = n // 2
                order = np.argsort(c[:, axis], kind="stable")
            else:
                l_idx = idx[go_left]
                r_idx = idx[~go_left]
                lefts[node] = alloc()
                rights[node] = alloc()
                stack.append((rights[node], r_idx))
                stack.append((lefts[node], l_idx))
                continue

        l_idx = idx[order[:half]]
        r_idx = idx[order[half:]]
        lefts[node] = alloc()
        rights[node] = alloc()
        stack.append((rights[node], r_idx))
        stack.append((lefts[node], l_idx))

    return (
        np.asarray(lefts, np.int64),
        np.asarray(rights, np.int64),
        np.stack(bounds_min).astype(np.float32),
        np.stack(bounds_max).astype(np.float32),
        node_tris,
    )


def flatten_preorder(lefts, rights, bmin, bmax, node_tris, leaf_size: int):
    """Emit preorder node order + escape links + packed leaf triangle lists.

    Returns (order, escape, leaf_block, out_bmin, out_bmax) where leaf_block
    is the tri-block id per node (-1 internal) and the caller packs the
    triangle slots from the concatenated `leaf_tris` list (len = num_leaves,
    each <= leaf_size entries).
    """
    n_nodes = lefts.shape[0]
    pre_index = np.full(n_nodes, -1, np.int64)
    order = []
    escape = []
    leaf_tris = []
    leaf_block = []

    stack = [(0, -1)]  # (topology node, escape preorder index placeholder)
    # escape must reference PREORDER indices; emit with deferred right links
    # using the classic trick: process (node, escape) DFS where left child's
    # escape is the right child's (future) preorder index.  We do it in two
    # sweeps: first compute subtree sizes, then emit.
    size = np.ones(n_nodes, np.int64)
    # subtree sizes bottom-up via reverse topological order (children were
    # allocated after parents, so reversed index order works)
    for i in range(n_nodes - 1, -1, -1):
        if lefts[i] >= 0:
            size[i] = 1 + size[lefts[i]] + size[rights[i]]

    out_bmin = np.empty((n_nodes, 3), np.float32)
    out_bmax = np.empty((n_nodes, 3), np.float32)
    esc_arr = np.empty(n_nodes, np.int64)
    blk_arr = np.full(n_nodes, -1, np.int64)

    stack = [(0, -1)]
    cursor = 0
    while stack:
        node, esc = stack.pop()
        me = cursor
        cursor += 1
        out_bmin[me] = bmin[node]
        out_bmax[me] = bmax[node]
        esc_arr[me] = esc
        if lefts[node] < 0:
            blk_arr[me] = len(leaf_tris)
            leaf_tris.append(node_tris[node])
        else:
            l, r = lefts[node], rights[node]
            right_pos = me + 1 + size[l]
            stack.append((r, esc))
            stack.append((l, right_pos))
    assert cursor == n_nodes
    return out_bmin, out_bmax, esc_arr, blk_arr, leaf_tris

