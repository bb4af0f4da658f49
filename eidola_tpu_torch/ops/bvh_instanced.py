"""Two-level (instanced) BVH: shared object-space leaf pools under one
grafted world-space walk (port of eidola_tpu/ops/bvh_instanced.py; ref
src/accelstruct.cpp:132-162 TLAS over BLAS).

- Host (`build_instanced_bvh_np`): per unique mesh one binary SAH BVH in
  object space (`ops/bvh.build_bvh_np`).  For each instance the mesh's
  walk rows are re-emitted with their boxes transformed to world space
  and grafted under a SAH top tree over the instance bounds
  (`build_sah_topology(..., leaf_size=1)`), giving one flat
  preorder/escape walk the packet traversal runs unchanged.  Its leaf
  ids index a global leaf table: leaf -> (shared mesh leaf row,
  instance).
- Device (`ops/bvh.py:_traverse(..., inst=...)`): each drained event
  reads its mesh leaf row and intersects its rays moved into the
  instance's object space; a hit resolves to the global triangle id
  inst_tri_base[instance] + mesh-local prim id.

Every array equals its counterpart in the JAX package's build bit for
bit (the ints as int64 tensors).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.transfer import to_device
from . import bvh as _bvh
from .bvh import build_bvh_np, leaf_size_for
from .bvh_build import build_sah_topology
from .bvh_fused import build_leaf_tables_np
from .bvh_oct import build_octant_tables


class InstIndex(NamedTuple):
    """What the drains need of an instanced BVH: global leaf id ->
    (shared mesh leaf row, instance), the per-instance world->object
    transforms and the triangle-id bases."""
    leaf_mesh_row: torch.Tensor  # (Lg,) int64
    leaf_inst: torch.Tensor      # (Lg,) int64
    inst_inv: torch.Tensor       # (I, 12) f32 world->object 3x4, row-major
    mesh_prim: torch.Tensor      # (Lm*leaf_size,) int64 mesh-local tri (-1 pad)
    inst_tri_base: torch.Tensor  # (I,) int64


class InstancedBVH(NamedTuple):
    """Grafted world-space walk over shared object-space leaf pools; walk
    rows as ops/bvh.BVH.walk, with leaf ids into the global leaf table."""
    walk: torch.Tensor           # (N, 8) f32
    leaf_mesh_row: torch.Tensor  # (Lg,) int64 -> row of leaf_blocks
    leaf_inst: torch.Tensor      # (Lg,) int64 -> instance id
    leaf_blocks: torch.Tensor    # (Lm, leaf_size*12) f32 object-space pool
    mesh_prim: torch.Tensor      # (Lm*leaf_size,) int64 mesh-local tri (-1 pad)
    inst_inv: torch.Tensor       # (I, 12) f32
    inst_tri_base: torch.Tensor  # (I,) int64 global tri base per instance
    n_tris: torch.Tensor         # () int64 instanced triangles in all
    leaf_cmat: Optional[torch.Tensor] = None    # (Lm, 16, 4n) f32
    leaf_anchor: Optional[torch.Tensor] = None  # (Lm, 3) f32
    walk_oct: Optional[torch.Tensor] = None     # (8*N, 8) f32
    slot_of_tri: Optional[torch.Tensor] = None  # (T,) pool slot, -1 = not here
    inst_of_tri: Optional[torch.Tensor] = None  # (T,) instance id

    @property
    def leaf_size(self) -> int:
        return self.leaf_blocks.shape[1] // 12

    @property
    def inst_index(self) -> InstIndex:
        return InstIndex(self.leaf_mesh_row, self.leaf_inst, self.inst_inv,
                         self.mesh_prim, self.inst_tri_base)


def closest_hit_instanced(bvh: InstancedBVH, o, d, t_min, t_max,
                          max_steps: int = 100_000):
    from .bvh import _traverse

    return _traverse(bvh, o, d, t_min, t_max, False, max_steps,
                     inst=bvh.inst_index)[0]


def any_hit_instanced(bvh: InstancedBVH, o, d, t_min, t_max,
                      max_steps: int = 100_000):
    from .bvh import _traverse

    return _traverse(bvh, o, d, t_min, t_max, True, max_steps,
                     inst=bvh.inst_index)[0].tri >= 0


def _transform_aabbs(bmin: np.ndarray, bmax: np.ndarray, m: np.ndarray):
    """World boxes of object boxes under the affine m (3x4), per axis:
    t + sum_j min/max(R[:, j] * lo_j, R[:, j] * hi_j)."""
    r = m[:3, :3]
    t = m[:3, 3]
    lo = np.full_like(bmin, 0.0) + t
    hi = np.full_like(bmax, 0.0) + t
    for j in range(3):
        a = bmin[:, j: j + 1] * r[:, j][None, :]
        b = bmax[:, j: j + 1] * r[:, j][None, :]
        lo = lo + np.minimum(a, b)
        hi = hi + np.maximum(a, b)
    return lo.astype(np.float32), hi.astype(np.float32)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """(4x4 or 3x4) affine -> 3x4 inverse (row-major, float64)."""
    r = np.linalg.inv(m[:3, :3])
    out = np.zeros((3, 4), np.float64)
    out[:3, :3] = r
    out[:3, 3] = -r @ m[:3, 3]
    return out


def affine_3x4(m) -> np.ndarray:
    """A 4x4 or 3x4 object->world transform as its float64 3x4 rows."""
    m = np.asarray(m, np.float64)
    return m.reshape(-1, 4)[:3] if m.size == 12 else m.reshape(4, 4)[:3]


def build_instanced_bvh_np(meshes, instances, leaf_size: int,
                           mesh_prim_ids=None, mesh_tris_full=None,
                           inst_tri_base_override=None,
                           n_tris_virtual: int | None = None) -> dict:
    """eidola_tpu/ops/bvh_instanced.py:build_instanced_bvh as numpy
    fields.  meshes: [(v0, v1, v2)] object-space triangles per unique
    mesh; instances: [(mesh index, 4x4 or 3x4 object->world)].

    Subset builds (the opaque/alpha split): `mesh_prim_ids` are the
    mesh-local ids of each mesh's subset triangles, `mesh_tris_full` the
    full per-mesh counts, `inst_tri_base_override` the instances' bases
    in the full numbering and `n_tris_virtual` its size, so hits report
    ids in the numbering of the full build."""
    if not meshes or not instances:
        raise ValueError("an instanced BVH needs meshes and instances")
    blas = [build_bvh_np(v0, v1, v2, leaf_size,
                         None if mesh_prim_ids is None else mesh_prim_ids[k],
                         None if mesh_tris_full is None
                         else mesh_tris_full[k], octant=False)
            for k, (v0, v1, v2) in enumerate(meshes)]
    mesh_leaf_base = np.zeros(len(meshes) + 1, np.int64)
    for k, b in enumerate(blas):
        mesh_leaf_base[k + 1] = mesh_leaf_base[k] + b["leaf_blocks"].shape[0]
    leaf_blocks = np.concatenate([b["leaf_blocks"] for b in blas], axis=0)
    mesh_prim = np.concatenate([b["prim_id"] for b in blas], axis=0)

    I = len(instances)
    mats = [affine_3x4(m) for (_, m) in instances]
    mesh_of = np.asarray([mi for (mi, _) in instances], np.int64)
    if mesh_tris_full is not None:
        mesh_tris = [int(t) for t in mesh_tris_full]
    else:
        mesh_tris = [int(np.max(b["prim_id"]) + 1) if b["prim_id"].size
                     else 0 for b in blas]
    if inst_tri_base_override is not None:
        inst_tri_base = np.asarray(inst_tri_base_override, np.int64)
        if inst_tri_base.shape[0] != I:
            raise ValueError("one tri base per instance")
        n_tris_total = int(n_tris_virtual)
    else:
        inst_tri_base = np.zeros(I, np.int64)
        acc = 0
        for k in range(I):
            inst_tri_base[k] = acc
            acc += mesh_tris[mesh_of[k]]
        n_tris_total = acc

    # per-instance walk rows with world-space boxes and local links
    inst_walks = []
    inst_bounds = np.zeros((I, 6), np.float32)
    for k in range(I):
        w = np.array(blas[mesh_of[k]]["walk"], np.float32, copy=True)
        lo, hi = _transform_aabbs(w[:, 0:3], w[:, 3:6], mats[k])
        w[:, 0:3] = lo
        w[:, 3:6] = hi
        inst_walks.append(w)
        inst_bounds[k, 0:3] = lo[0]
        inst_bounds[k, 3:6] = hi[0]

    # top tree over the instance bounds, one instance per leaf
    ib_min = inst_bounds[:, 0:3]
    ib_max = inst_bounds[:, 3:6]
    lefts, rights, n_bmin, n_bmax, node_insts = build_sah_topology(
        ib_min, ib_max, (ib_min + ib_max) * 0.5, leaf_size=1)

    # graft: preorder where a top leaf expands to its instance's walk
    # block (links offset; block-exit links -> the top leaf's escape;
    # leaf ids offset into the global leaf table)
    n_top = lefts.shape[0]
    size = np.ones(n_top, np.int64)
    for i in range(n_top - 1, -1, -1):
        if lefts[i] >= 0:
            size[i] = 1 + size[lefts[i]] + size[rights[i]]
        else:
            size[i] = sum(inst_walks[j].shape[0] for j in node_insts[i])

    walk = np.zeros((int(size[0]), 8), np.float32)
    leaf_mesh_row_parts, leaf_inst_parts = [], []
    leaf_base = 0
    stack = [(0, -1)]
    cursor = 0
    while stack:
        node, esc = stack.pop()
        if lefts[node] >= 0:
            me = cursor
            cursor += 1
            walk[me, 0:3] = n_bmin[node]
            walk[me, 3:6] = n_bmax[node]
            walk[me, 6] = np.int32(esc).view(np.float32)
            walk[me, 7] = np.int32(-1).view(np.float32)
            l, r = lefts[node], rights[node]
            stack.append((r, esc))
            stack.append((l, me + 1 + size[l]))
            continue
        insts = node_insts[node]
        if len(insts) != 1:
            raise AssertionError("top leaves hold exactly one instance")
        k = int(insts[0])
        block = np.array(inst_walks[k], copy=True)
        n_i = block.shape[0]
        esc_local = block[:, 6].view(np.int32)
        blk_local = block[:, 7].view(np.int32)
        esc_new = np.where(esc_local >= 0, esc_local + cursor,
                           np.int32(esc)).astype(np.int32)
        blk_new = np.where(blk_local >= 0, blk_local + leaf_base,
                           blk_local).astype(np.int32)
        block[:, 6] = esc_new.view(np.float32)
        block[:, 7] = blk_new.view(np.float32)
        walk[cursor: cursor + n_i] = block
        cursor += n_i
        n_leaves_mesh = blas[mesh_of[k]]["leaf_blocks"].shape[0]
        leaf_mesh_row_parts.append(np.arange(n_leaves_mesh, dtype=np.int32)
                                   + np.int32(mesh_leaf_base[mesh_of[k]]))
        leaf_inst_parts.append(np.full(n_leaves_mesh, k, np.int32))
        leaf_base += n_leaves_mesh
    if cursor != walk.shape[0]:
        raise AssertionError("graft did not fill the walk")

    inst_inv = np.stack([_invert_affine(m).reshape(12) for m in mats]
                        ).astype(np.float32)
    leaf_cmat, leaf_anchor = build_leaf_tables_np(leaf_blocks, leaf_size)

    # global tri -> (pool slot, instance), -1 for tris this BVH does not
    # own (the other half of a split, or unoccupied)
    mesh_slot_of_local = []
    for k in range(len(blas)):
        lo = int(mesh_leaf_base[k]) * leaf_size
        hi = int(mesh_leaf_base[k + 1]) * leaf_size
        mp = mesh_prim[lo:hi]
        inv = np.full(mesh_tris[k], -1, np.int32)
        occ = mp >= 0
        inv[mp[occ]] = (np.nonzero(occ)[0] + lo).astype(np.int32)
        mesh_slot_of_local.append(inv)
    slot_of_tri = np.full(max(n_tris_total, 1), -1, np.int32)
    inst_of_tri = np.full(max(n_tris_total, 1), -1, np.int32)
    for k in range(I):
        base = int(inst_tri_base[k])
        n_m = mesh_tris[mesh_of[k]]
        slot_of_tri[base: base + n_m] = mesh_slot_of_local[mesh_of[k]]
        inst_of_tri[base: base + n_m] = k
    if not n_tris_total:
        slot_of_tri = np.zeros(0, np.int32)
        inst_of_tri = np.zeros(0, np.int32)

    return dict(
        walk=walk,
        leaf_mesh_row=np.concatenate(leaf_mesh_row_parts),
        leaf_inst=np.concatenate(leaf_inst_parts),
        leaf_blocks=leaf_blocks,
        mesh_prim=mesh_prim,
        inst_inv=inst_inv,
        inst_tri_base=inst_tri_base.astype(np.int32),
        n_tris=np.int32(n_tris_total),
        leaf_cmat=leaf_cmat,
        leaf_anchor=leaf_anchor,
        walk_oct=build_octant_tables(walk) if _bvh.OCT else None,
        slot_of_tri=slot_of_tri,
        inst_of_tri=inst_of_tri,
    )


def build_instanced_bvh(meshes, instances, *, device,
                        leaf_size: int | None = None, **subset
                        ) -> InstancedBVH:
    """Build on the host and move to `device`; the leaf size follows the
    device unless given.  `subset`: the keyword arguments of
    build_instanced_bvh_np for a subset build."""
    if leaf_size is None:
        leaf_size = leaf_size_for(device)
    fields = build_instanced_bvh_np(meshes, instances, leaf_size, **subset)
    return InstancedBVH(**{k: to_device(fields[k], device)
                           for k in InstancedBVH._fields})
