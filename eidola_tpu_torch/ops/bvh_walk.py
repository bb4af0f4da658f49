"""One-kernel BVH traversal (port of eidola_tpu/ops/bvh_pallas.py:_run).

The whole traversal of a ray stream runs in one launch: each 128-ray
packet walks the build-order table `bvh.walk` stacklessly, queues the
leaves it hits (LIFO, LQ = 4 deep) and drains them inline with a
cross-product Moller-Trumbore over the leaf's rows `bvh.leaf_blocks`.

- `walk_closest` / `walk_any` take the walk table, the leaf rows and the
  rays as one (8, P, 128) f32 tensor (o, d, t_min, t_max planes; see
  `pack_rays`) and return (t, slot, u, v) planes.  On a CUDA tensor they
  launch the kernel of `csrc/bvh_walk.cu` (built with nvcc at first use)
  and count the launch in `LAUNCHES` (`launcher` gives the bare launch,
  which chip_smoke.py times alone); on a CPU tensor they run the plain
  version `walk_ref` with group=1.
- `inst=(leaf_mesh_row, leaf_inst, inst_inv)` makes the table an
  instanced BVH's grafted walk (ops/bvh_instanced.py): a drained leaf id
  g reads the shared pool row leaf_mesh_row[g] and tests the rays moved
  into the object space of instance leaf_inst[g], as the instanced drain
  of ops/bvh.py:_traverse does; the slot keeps the global leaf id.  The
  JAX kernel took flat BVHs only.
- `walk_ref(..., group=G)` is the plain torch version.  G packets share
  one walk/drain decision, as the TPU's (8, 128) tile made the JAX kernel
  do: group=8 is that kernel's semantics, group=1 the CUDA kernel's (one
  block per packet).  The group changes only the order in which a
  packet's leaf events drain, hence only which hit wins an exact-t tie.
- `closest_hit_walk` / `any_hit_walk` are the front doors, with the
  post-processing of `_traverse_pallas` (bvh_pallas.py:286-315); an
  instanced slot resolves to inst_tri_base[instance] + the mesh-local
  triangle.
"""
from __future__ import annotations

import ctypes

import torch

from .bvh import _BIG, PACKET, HitRecord, _to_object_space

LQ = 4
_CHUNK = 512     # packets per batch of walk_ref's vectorized triangle test
# flops per lane: one slab test (6 sub, 6 mul, 10 min/max, 3 compares)
# and one triangle test (the cross-product MT of csrc/bvh_walk.cu)
WALK_FLOP = 25
MT_FLOP = 53
# an instanced event's move to object space: 18 products and 15 sums
XFORM_FLOP = 33

LAUNCHES = {"walk_closest": 0, "walk_any": 0}
# the launches among LAUNCHES that walked an instanced BVH
INST_LAUNCHES = {"walk_closest": 0, "walk_any": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = INST_LAUNCHES[k] = 0


def pack_rays(o, d, t_min, t_max, multiple: int = PACKET):
    """Flat rays -> (8, P, 128) f32 planes [ox, oy, oz, dx, dy, dz, t_min,
    t_max], padded to a multiple of `multiple` rays as bvh_pallas._run pads
    (o = 0, d = 1, t_min = 0, t_max = -1: dead lanes)."""
    R = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t_min = torch.broadcast_to(torch.as_tensor(t_min, **f32), (R,))
    t_max = torch.broadcast_to(torch.as_tensor(t_max, **f32), (R,))
    n = -(-R // multiple) * multiple
    out = torch.empty((8, n), **f32)
    out[0:3, R:] = 0.0
    out[3:6, R:] = 1.0
    out[6, R:] = 0.0
    out[7, R:] = -1.0
    out[0:3, :R] = o.T
    out[3:6, :R] = d.T
    out[6, :R] = t_min
    out[7, :R] = t_max
    return out.reshape(8, n // PACKET, PACKET)


def _inv(c):
    return torch.where(c >= 0.0, 1.0, -1.0) / torch.clamp(torch.abs(c),
                                                          min=1e-12)


def walk_ref(walk, leaf_blocks, rays, any_hit: bool, max_steps: int,
             group: int = 1, stats=None, inst=None):
    """Plain torch traversal.  walk (N, 8) f32, leaf_blocks (L, n*12) f32,
    rays (8, P, 128) f32 with P a multiple of `group`.  Returns (t, slot,
    u, v) as (P, 128) planes (slot int32, -1 = no hit).  `stats`, an
    int32 (P, 2) tensor, receives each packet's walk steps and drained
    leaf events.  `inst`: (leaf_mesh_row (Lg,), leaf_inst (Lg,), inst_inv
    (I, 12)) of an instanced BVH."""
    ox, oy, oz, dx, dy, dz, tmin, tmax = rays
    P = ox.shape[0]
    if P % group:
        raise ValueError(f"walk_ref: {P} packets are not a multiple of "
                         f"group {group}")
    dev = ox.device
    n = leaf_blocks.shape[1] // 12
    tris = leaf_blocks.reshape(-1, n, 12)
    box = walk[:, 0:6]
    links = walk[:, 6:8].contiguous().view(torch.int32).long()
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    G = P // group
    gid = torch.arange(P, device=dev) // group
    kidx = torch.arange(n, device=dev)[None, :, None]

    cursor = torch.zeros(P, dtype=torch.int64, device=dev)
    qcnt = torch.zeros(P, dtype=torch.int64, device=dev)
    queue = torch.zeros((P, LQ), dtype=torch.int64, device=dev)
    t_best = tmax.clone()
    slot = torch.full((P, PACKET), -1, dtype=torch.int64, device=dev)
    u = torch.zeros_like(t_best)
    v = torch.zeros_like(t_best)
    step = torch.zeros(G, dtype=torch.int64, device=dev)
    events = torch.zeros(P, dtype=torch.int64, device=dev)

    while True:
        live = cursor >= 0
        g_live = live.reshape(G, group).any(1)
        g_on = ((g_live | (qcnt > 0).reshape(G, group).any(1))
                & (step < max_steps))
        if not bool(g_on.any()):
            break
        g_walk = g_on & g_live & (qcnt < LQ).reshape(G, group).all(1)
        g_drain = g_on & ~g_walk

        # walk step: every live packet of a walking group
        w = torch.nonzero(g_walk[gid] & live)[:, 0]
        if w.numel():
            nid = cursor[w]
            row = box[nid]
            a = lambda plane: plane[w]
            tx0 = (row[:, 0:1] - a(ox)) * a(ix)
            tx1 = (row[:, 3:4] - a(ox)) * a(ix)
            ty0 = (row[:, 1:2] - a(oy)) * a(iy)
            ty1 = (row[:, 4:5] - a(oy)) * a(iy)
            tz0 = (row[:, 2:3] - a(oz)) * a(iz)
            tz1 = (row[:, 5:6] - a(oz)) * a(iz)
            tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                             torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
            tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                             torch.maximum(ty0, ty1)),
                               torch.maximum(tz0, tz1))
            pkt_hit = ((tn <= tf) & (tf >= a(tmin))
                       & (tn <= a(t_best))).any(1)
            miss, leaf = links[nid, 0], links[nid, 1]
            push = pkt_hit & (leaf >= 0)
            qc = qcnt[w]
            q = queue[w]
            at = qc.clamp(max=LQ - 1)[:, None]
            q.scatter_(1, at, torch.where(push[:, None], leaf[:, None],
                                          q.gather(1, at)))
            queue[w] = q
            qcnt[w] = qc + push.long()
            cursor[w] = torch.where(pkt_hit & (leaf < 0), nid + 1, miss)
        step += g_walk.long()

        # drain step: every packet of a draining group with a queued leaf
        dr = torch.nonzero(g_drain[gid] & (qcnt > 0))[:, 0]
        for s in range(0, dr.numel(), _CHUNK):
            c = dr[s:s + _CHUNK]
            qcnt[c] -= 1
            leaf = queue[c].gather(1, qcnt[c][:, None])[:, 0]
            a = lambda plane: plane[c][:, None, :]
            cox, coy, coz, cdx, cdy, cdz = (a(ox), a(oy), a(oz), a(dx),
                                            a(dy), a(dz))
            if inst is None:
                e = tris[leaf]                               # (C, n, 12)
            else:
                e = tris[inst[0][leaf].long()]
                xf = inst[2][inst[1][leaf].long()][:, :, None]
                cox, coy, coz, cdx, cdy, cdz = _to_object_space(
                    xf, cox, coy, coz, cdx, cdy, cdz)
            col = lambda i: e[:, :, i:i + 1]
            px = cdy * col(8) - cdz * col(7)
            py = cdz * col(6) - cdx * col(8)
            pz = cdx * col(7) - cdy * col(6)
            det = col(3) * px + col(4) * py + col(5) * pz
            ok = torch.abs(det) > 1e-12
            inv_det = torch.where(ok, 1.0 / det, 0.0)
            tvx, tvy, tvz = cox - col(0), coy - col(1), coz - col(2)
            uk = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * col(5) - tvz * col(4)
            qy = tvz * col(3) - tvx * col(5)
            qz = tvx * col(4) - tvy * col(3)
            vk = (cdx * qx + cdy * qy + cdz * qz) * inv_det
            tk = (col(6) * qx + col(7) * qy + col(8) * qz) * inv_det
            t_b = a(t_best)
            h = (ok & (uk >= 0.0) & (vk >= 0.0) & (uk + vk <= 1.0)
                 & (tk > a(tmin)) & (tk < t_b))
            # the kernel's in-order strict `tk < t_b` fold keeps the first
            # of the minimal hits: the first k attaining the minimum
            best = torch.amin(torch.where(h, tk, torch.inf), dim=1)
            k = torch.amin(torch.where(h & (tk == best[:, None]), kidx, n),
                           dim=1)
            found = k < n
            kk = k.clamp(max=n - 1)[:, None]
            t_c = torch.where(found, best, t_best[c])
            slot_c = torch.where(found, leaf[:, None] * n + k, slot[c])
            u[c] = torch.where(found, uk.gather(1, kk)[:, 0], u[c])
            v[c] = torch.where(found, vk.gather(1, kk)[:, 0], v[c])
            if any_hit:
                t_c = torch.where(slot_c >= 0, -_BIG, t_c)
            t_best[c] = t_c
            slot[c] = slot_c
            events[c] += 1

    if stats is not None:
        stats[:, 0] = step[gid].to(torch.int32)
        stats[:, 1] = events.to(torch.int32)
    return t_best, slot.to(torch.int32), u, v


def _check(name, walk, leaf_blocks, rays, inst):
    dev = walk.device
    if walk.dtype != torch.float32 or walk.dim() != 2 or walk.shape[1] != 8:
        raise ValueError(f"{name}: walk must be f32 (N, 8), got "
                         f"{tuple(walk.shape)} {walk.dtype}")
    if leaf_blocks.dtype != torch.float32 or leaf_blocks.dim() != 2 or \
            leaf_blocks.shape[1] % 12:
        raise ValueError(f"{name}: leaf_blocks must be f32 (L, n*12)")
    if rays.dtype != torch.float32 or rays.dim() != 3 or \
            rays.shape[0] != 8 or rays.shape[2] != PACKET:
        raise ValueError(f"{name}: rays must be f32 (8, P, {PACKET}), got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    others = [leaf_blocks, rays]
    if inst is not None:
        mesh_row, leaf_inst, inst_inv = inst
        for a in (mesh_row, leaf_inst):
            if a.dim() != 1 or a.shape != mesh_row.shape or \
                    a.dtype not in (torch.int32, torch.int64):
                raise ValueError(f"{name}: leaf_mesh_row and leaf_inst must "
                                 f"be int (Lg,)")
        if inst_inv.dtype != torch.float32 or inst_inv.dim() != 2 or \
                inst_inv.shape[1] != 12:
            raise ValueError(f"{name}: inst_inv must be f32 (I, 12)")
        others += list(inst)
    if any(a.device != dev for a in others):
        raise ValueError(f"{name}: all inputs must be on {dev}")
    if dev.type == "cuda" and leaf_blocks.shape[1] // 12 not in (8, 64):
        raise ValueError(f"{name}: the CUDA kernel is built for leaf sizes "
                         f"8 and 64, got {leaf_blocks.shape[1] // 12}")


def _lib():
    from ..utils.cuda_build import load

    lib = load("bvh_walk")
    if not getattr(lib, "_eidola_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.eidola_walk.argtypes = [P, I] + [P] * 10 + [I, I, I, I, P]
        lib.eidola_walk.restype = I
        lib._eidola_typed = True
    return lib


def launcher(name, walk, leaf_blocks, rays, max_steps, stats=None,
             inst=None):
    """(launch, outputs) for a CUDA call of `name` ("walk_closest" or
    "walk_any") with the wrapper's arguments: the inputs converted once
    and the outputs allocated; `launch()` only launches the kernel on the
    current stream (it does not count).  The wrapper calls it once;
    chip_smoke.py times it alone."""
    P = rays.shape[1]
    if stats is not None and (stats.dtype != torch.int32 or
                              tuple(stats.shape) != (P, 2) or
                              not stats.is_contiguous() or
                              stats.device != walk.device):
        raise ValueError(f"{name}: stats must be contiguous int32 ({P}, 2) "
                         f"on {walk.device}")
    walk, leaf_blocks, rays = (a.contiguous() for a in
                               (walk, leaf_blocks, rays))
    if inst is None:
        inst = (None, None, None)
    else:
        inst = (inst[0].to(torch.int32).contiguous(),
                inst[1].to(torch.int32).contiguous(), inst[2].contiguous())
    t = torch.empty((P, PACKET), dtype=torch.float32, device=walk.device)
    outs = (t, torch.empty((P, PACKET), dtype=torch.int32,
                           device=walk.device),
            torch.empty_like(t), torch.empty_like(t))
    ptr = lambda a: ctypes.c_void_p(None if a is None else a.data_ptr())
    ptrs = [ptr(walk), walk.shape[0], ptr(leaf_blocks),
            *[ptr(a) for a in inst], ptr(rays), *[ptr(a) for a in outs],
            ptr(stats), P, leaf_blocks.shape[1] // 12, int(name == "walk_any"),
            int(max_steps),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
    fn = _lib().eidola_walk

    def launch(_alive=(walk, leaf_blocks, rays, inst, outs, stats)):
        err = fn(*ptrs)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with "
                               f"cudaError_t {err}")

    return launch, outs


def _walk(name, walk, leaf_blocks, rays, max_steps, stats, inst):
    _check(name, walk, leaf_blocks, rays, inst)
    if walk.device.type == "cpu":
        return walk_ref(walk, leaf_blocks, rays, name == "walk_any",
                        max_steps, group=1, stats=stats, inst=inst)
    if walk.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {walk.device}")
    launch, out = launcher(name, walk, leaf_blocks, rays, max_steps, stats,
                           inst)
    launch()
    LAUNCHES[name] += 1
    INST_LAUNCHES[name] += inst is not None
    return out


def walk_closest(walk, leaf_blocks, rays, max_steps: int, stats=None,
                 inst=None):
    """Closest hit of every ray: (t, slot, u, v) (P, 128) planes."""
    return _walk("walk_closest", walk, leaf_blocks, rays, max_steps, stats,
                 inst)


def walk_any(walk, leaf_blocks, rays, max_steps: int, stats=None, inst=None):
    """Occlusion of every ray: slot >= 0 marks an occluded lane (its t is
    -1e30)."""
    return _walk("walk_any", walk, leaf_blocks, rays, max_steps, stats, inst)


def _traverse_walk(bvh, o, d, t_min, t_max, any_hit: bool,
                   max_steps: int) -> HitRecord:
    """`bvh`: a BVH, or an InstancedBVH (told by its leaf_mesh_row)."""
    R = o.shape[0]
    rays = pack_rays(o, d, t_min, t_max)
    fn = walk_any if any_hit else walk_closest
    instanced = hasattr(bvh, "leaf_mesh_row")
    inst = (bvh.leaf_mesh_row, bvh.leaf_inst, bvh.inst_inv) if instanced \
        else None
    t, slot, u, v = (a.reshape(-1)[:R] for a in
                     fn(bvh.walk, bvh.leaf_blocks, rays, max_steps,
                        inst=inst))
    hit = slot >= 0
    slot = slot.long().clamp(min=0)
    if instanced:
        # global id = the instance's tri base + the mesh-local prim id
        n = bvh.leaf_size
        leaf_g, k = slot // n, slot % n
        p = bvh.mesh_prim[bvh.leaf_mesh_row[leaf_g] * n + k]
        tri = torch.where(hit & (p >= 0),
                          p + bvh.inst_tri_base[bvh.leaf_inst[leaf_g]], -1)
    else:
        tri = torch.where(hit, bvh.prim_id[slot], -1)
    t = torch.where(tri >= 0, torch.abs(t), _BIG)
    return HitRecord(tri=tri, t=t, u=u, v=v)


def closest_hit_walk(bvh, o, d, t_min, t_max, max_steps: int = 100_000):
    """Drop-in for ops.bvh.closest_hit (or closest_hit_instanced) through
    the walk kernel."""
    return _traverse_walk(bvh, o, d, t_min, t_max, False, max_steps)


def any_hit_walk(bvh, o, d, t_min, t_max, max_steps: int = 100_000):
    """Drop-in for ops.bvh.any_hit (or any_hit_instanced) through the walk
    kernel."""
    return _traverse_walk(bvh, o, d, t_min, t_max, True, max_steps).tri >= 0
