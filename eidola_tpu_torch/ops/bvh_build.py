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

`build_sbvh_topology` is the spatial-split variant (SBVH): straddling
references are chopped at bin planes, so a triangle may sit in more than
one leaf.  This is pure numpy (a copy of the JAX package's builders); the
C++ builder of eidola_tpu_torch/native emits the SAH layout and is used
for multi-million-triangle scenes when g++ is present.
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


def build_sbvh_topology(v0, v1, v2, leaf_size: int,
                        alpha: float = 1e-5, max_ref_factor: float = 1.6):
    """Spatial-split BVH (SBVH, Stich et al. 2009, chopped-AABB variant):
    like build_sah_topology, but when the best object split's children
    OVERLAP significantly (SA(L ∩ R)/SA(root) > alpha), a binned SPATIAL
    split is also scored — bin planes chop straddling triangle REFERENCES
    into both sides with their AABBs clipped to the slab.  Less overlap
    means ray packets descend fewer branches, shrinking the leaf-event
    unions that the leaf drains pay for.  A copy of
    eidola_tpu/ops/bvh_build.py:build_sbvh_topology: the same arrays bit
    for bit.

    References duplicate (bounded by max_ref_factor x T); leaves hold
    triangle ids with possible cross-leaf duplicates — the traversal is
    unchanged (a duplicate is the same triangle; closest/any-hit fold
    identically).  Chopping the AABB instead of the true clipped polygon
    keeps the build cheap; the box still bounds the triangle piece.

    Returns the same tuple as build_sah_topology.
    """
    T = v0.shape[0]
    tb_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tb_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)

    lefts, rights, bounds_min, bounds_max, node_tris = [], [], [], [], []

    def alloc():
        lefts.append(-1)
        rights.append(-1)
        bounds_min.append(None)
        bounds_max.append(None)
        node_tris.append(None)
        return len(lefts) - 1

    def sa(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    root = alloc()
    ref_tri0 = np.arange(T, dtype=np.int64)
    stack = [(root, ref_tri0, tb_min.copy(), tb_max.copy())]
    root_sa = max(float(sa(tb_min.min(0), tb_max.max(0))), 1e-30)
    ref_budget = int(T * max_ref_factor)
    ref_count = T

    while stack:
        node, tri, rb_min, rb_max = stack.pop()
        nb_min = rb_min.min(axis=0)
        nb_max = rb_max.max(axis=0)
        bounds_min[node] = nb_min
        bounds_max[node] = nb_max
        n = tri.size
        if n <= leaf_size:
            node_tris[node] = np.unique(tri)
            continue

        c = (rb_min + rb_max) * 0.5
        c_min = c.min(axis=0)
        c_max = c.max(axis=0)
        axis = int(np.argmax(c_max - c_min))
        ext = (c_max - c_min)[axis]

        best = None  # (cost, kind, payload)
        if ext >= 1e-12:
            scale = N_BINS * (1.0 - 1e-6) / ext
            bin_id = ((c[:, axis] - c_min[axis]) * scale).astype(np.int64)
            counts = np.bincount(bin_id, minlength=N_BINS)
            bf_min = np.full((N_BINS, 3), np.inf)
            bf_max = np.full((N_BINS, 3), -np.inf)
            np.minimum.at(bf_min, bin_id, rb_min)
            np.maximum.at(bf_max, bin_id, rb_max)
            lmin = np.minimum.accumulate(bf_min, axis=0)
            lmax = np.maximum.accumulate(bf_max, axis=0)
            rmin = np.minimum.accumulate(bf_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bf_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            cost = sa(lmin, lmax) * lcount + np.concatenate(
                [sa(rmin[1:], rmax[1:]) * (n - lcount[:-1]), [np.inf]]
            )
            k = int(np.argmin(cost[:-1]))
            nl = int(lcount[k])
            if 0 < nl < n:
                ov_min = np.maximum(lmin[k], rmin[k + 1])
                ov_max = np.minimum(lmax[k], rmax[k + 1])
                overlap = float(sa(ov_min, ov_max)) if (ov_max > ov_min).all() else 0.0
                best = (float(cost[k]), "obj", (bin_id <= k))

                # spatial split worth scoring only when children overlap
                if overlap / root_sa > alpha and ref_count < ref_budget:
                    edges = nb_min[axis] + (nb_max[axis] - nb_min[axis]) * (
                        np.arange(1, N_BINS) / N_BINS
                    )
                    s_costs = np.full(N_BINS - 1, np.inf)
                    for e_i, plane in enumerate(edges):
                        go_l = rb_min[:, axis] < plane
                        go_r = rb_max[:, axis] > plane
                        go_l |= ~go_r          # degenerate on-plane refs
                        n_l = int(go_l.sum())
                        n_r = int(go_r.sum())
                        if n_l == 0 or n_r == 0:
                            continue
                        lmn = rb_min[go_l].min(0)
                        lmx = rb_max[go_l].max(0).copy()
                        lmx[axis] = min(lmx[axis], plane)
                        rmn = rb_min[go_r].min(0).copy()
                        rmx = rb_max[go_r].max(0)
                        rmn[axis] = max(rmn[axis], plane)
                        s_costs[e_i] = float(sa(lmn, lmx)) * n_l + float(
                            sa(rmn, rmx)) * n_r
                    sk = int(np.argmin(s_costs))
                    if s_costs[sk] < best[0]:
                        best = (float(s_costs[sk]), "spatial", edges[sk])

        if best is None:
            order = np.argsort(c[:, axis], kind="stable")
            half = n // 2
            go_left = np.zeros(n, bool)
            go_left[order[:half]] = True
            best = (0.0, "obj", go_left)

        kind, payload = best[1], best[2]
        if kind == "obj":
            go_left = payload
            if not (0 < int(go_left.sum()) < n):
                order = np.argsort(c[:, axis], kind="stable")
                go_left = np.zeros(n, bool)
                go_left[order[: n // 2]] = True
            l_args = (tri[go_left], rb_min[go_left], rb_max[go_left])
            r_args = (tri[~go_left], rb_min[~go_left], rb_max[~go_left])
        else:
            plane = payload
            go_l = rb_min[:, axis] < plane
            go_r = rb_max[:, axis] > plane
            go_l |= ~go_r
            if int(go_l.sum()) == n or int(go_r.sum()) == n:
                # no progress (every ref straddles): median object split
                order = np.argsort(c[:, axis], kind="stable")
                go_left = np.zeros(n, bool)
                go_left[order[: n // 2]] = True
                l_args = (tri[go_left], rb_min[go_left], rb_max[go_left])
                r_args = (tri[~go_left], rb_min[~go_left], rb_max[~go_left])
                lefts[node] = alloc()
                rights[node] = alloc()
                stack.append((rights[node],) + r_args)
                stack.append((lefts[node],) + l_args)
                continue
            dup = go_l & go_r
            ref_count += int(dup.sum())
            lmx = rb_max[go_l].copy()
            lmx[:, axis] = np.minimum(lmx[:, axis], plane)
            rmn = rb_min[go_r].copy()
            rmn[:, axis] = np.maximum(rmn[:, axis], plane)
            l_args = (tri[go_l], rb_min[go_l], lmx)
            r_args = (tri[go_r], rmn, rb_max[go_r])

        lefts[node] = alloc()
        rights[node] = alloc()
        stack.append((rights[node],) + r_args)
        stack.append((lefts[node],) + l_args)

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


def collect_frontier(walk: np.ndarray, k_max: int) -> np.ndarray:
    """Up to k_max node AABBs that exactly cover the tree's geometry: a
    greedy cut of the flattened preorder walk, always expanding the
    largest-surface-area node (its box is replaced by its two children's).

    A ray pre-cull table (the JAX package's opt-in alpha cull; the port
    keeps `cull_boxes` so its BVHs equal the JAX package's, and no
    traversal of the port reads them): a ray segment missing every
    frontier box provably misses everything in the tree, because the
    frontier is a full cover.  Returns (k_max, 6)
    [bmin, bmax]; unused rows are degenerate (min > max) so a slab test
    can never pass them.
    """
    import heapq

    walk = np.asarray(walk, np.float32)
    n = walk.shape[0]
    esc = walk[:, 6].view(np.int32)
    leaf = walk[:, 7].view(np.int32)

    def area(i):
        e = np.maximum(walk[i, 3:6] - walk[i, 0:3], 0.0)
        return float(2.0 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2]))

    heap = [(-area(0), 0)]
    done: list[int] = []
    while heap and (len(heap) + len(done)) < k_max:
        _, i = heapq.heappop(heap)
        if leaf[i] >= 0:          # leaf: can't expand further
            done.append(i)
            continue
        l = i + 1                 # preorder: left child follows its parent
        r = int(esc[l])           # left child's escape IS the right sibling
        if r < 0 or r >= n:       # defensive: malformed link, keep the node
            done.append(i)
            continue
        heapq.heappush(heap, (-area(l), l))
        heapq.heappush(heap, (-area(r), r))
    idx = done + [i for (_, i) in heap]
    out = np.empty((k_max, 6), np.float32)
    out[:, 0:3] = 1.0   # degenerate (min > max): slab test never passes
    out[:, 3:6] = 0.0
    out[: len(idx)] = walk[idx, 0:6]
    return out
