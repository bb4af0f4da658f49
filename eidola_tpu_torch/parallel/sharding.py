"""Pixel-row data parallelism on torch.distributed (counterpart of
eidola_tpu/parallel/sharding.py).

The image is split by rows across ranks, one process per rank; the scene
(BVH, materials, lights, textures) is replicated, since every rank needs
random access to all of it during traversal.  The JAX package traces one
global program under a band context and lets XLA's SPMD partitioner
insert the collectives.  PyTorch has no partitioner for gathers and
sorts, so here the frame is rank-local: each rank renders only its own
rows of every plane, under `shard_context(group)` (ops/halo.py), and
communicates itself, through parallel/exchange.py, where XLA put its
collectives:

  - temporal and spatial reuse, GI history -> halo-row exchange of the
    packed previous state (render/frame.py, direct.py, indirect.py)
  - a-trous taps near the band edges       -> one row exchange per level
                                              (render/denoise.py)
  - auto exposure's log-average, the local
    exposure pyramid's coarse levels        -> all_reduce, all_gather
                                              (render/post.py)
The wavefront sort and the alpha queue march cover the rank's own rays
(no communication), and the deep-bounce tile choice is computed whole on
every rank (render/indirect.py).  The carried FrameState holds the rank's
rows; frame_idx, accum_count and prev_cam are replicated.
"""
from __future__ import annotations

import os
import socket
import tempfile
import time

import torch

from ..ops.halo import shard_context
from ..render.config import RenderConfig
from ..render.frame import FrameState, render_frame
from ..utils.checkpoint import tree_leaves, tree_unflatten
from . import exchange
from .comm_audit import collective_summary
from .exchange import RowGroup


def padded_height(h: int, n: int, half_res: bool = True) -> int:
    """Smallest height >= h whose full-res and half-res row counts both
    divide by n (1080 on 8 ranks -> 1088: render 8 extra rows, crop the
    output)."""
    q = n * (2 if half_res else 1)
    return -(-h // q) * q


def _heights(cfg: RenderConfig) -> set:
    """The image heights of the carried planes: the full-res frame and
    the GI's half-res reservoirs."""
    hs = {cfg.height}
    if cfg.indirect_half_res:
        hs.add(cfg.half_height)
    return hs


def check_heights(cfg: RenderConfig, world: int):
    """Raise when an image height does not divide by the world size: a
    band of unequal height would break every rank's row arithmetic, and
    padding silently would hide the extra rows."""
    bad = sorted(h for h in _heights(cfg) if h % world)
    if bad:
        raise ValueError(
            f"image heights {bad} not divisible by {world} ranks; render at "
            f"height {padded_height(cfg.height, world, cfg.indirect_half_res)}"
            f" (padded_height) and crop the output instead")


def _map(tree, fn):
    return tree_unflatten(tree, iter([fn(a) for a in tree_leaves(tree)]))


def shard_state(state: FrameState, cfg: RenderConfig,
                group: RowGroup) -> FrameState:
    """The rank's rows of every leaf whose first dimension is an image
    height; every other leaf (frame_idx, accum_count, prev_cam)
    replicated."""
    check_heights(cfg, group.world)
    hs = _heights(cfg)

    def cut(a):
        if a.dim() >= 1 and a.shape[0] in hs:
            row0, n = group.rows(a.shape[0])
            return a[row0:row0 + n].clone()
        return a

    return state._replace(**{f: _map(getattr(state, f), cut)
                             for f in state._fields if f != "prev_cam"})


_PLANES = {"gbuf": False, "di_resv": False, "di_vis": False,
           "accum": False, "gi_resv": True}     # field: half-res?


def assert_row_sharded(state: FrameState, cfg: RenderConfig,
                       group: RowGroup):
    """Every image plane of the rank's carried state holds exactly the
    rank's rows (not the whole image, not another band size)."""
    for field, half in _PLANES.items():
        h = cfg.half_height if half and cfg.indirect_half_res else cfg.height
        n = group.rows(h)[1]

        def check(a, field=field):
            if a.shape[0] != n:
                raise AssertionError(
                    f"{field} leaf {tuple(a.shape)} is not the rank's "
                    f"{n} of {h} rows")
            return a

        _map(getattr(state, field), check)


def make_sharded_step(cfg: RenderConfig, group: RowGroup):
    """The frame step of one rank: render_frame under the shard context,
    on the rank's state (shard_state), returning the rank's rows of the
    new state and of every output."""
    check_heights(cfg, group.world)

    def step(scene, cam, params, tm, state, timer=None):
        with shard_context(group):
            return render_frame(cfg, scene, cam, params, tm, state,
                                timer=timer)

    return step


def gather_rows(group: RowGroup, x):
    """The full image on every rank from each rank's rows of `x`."""
    return exchange.all_gather_rows(group, x, "gather_rows")


def _walk_launches() -> dict:
    from ..ops import bvh_fused, bvh_mxu, bvh_walk

    return {**bvh_fused.LAUNCHES, **bvh_walk.LAUNCHES, **bvh_mxu.LAUNCHES}


def _reset_launches():
    from ..ops import bvh_fused, bvh_mxu, bvh_walk

    for m in (bvh_fused, bvh_mxu, bvh_walk):
        m.reset_launches()


def orbit_cameras(cam, frames: int, orbit: float, aspect: float) -> list:
    """The camera of each frame: the scene's, then orbited by `orbit`
    radians a frame about a pivot 3 units ahead, as the headless app's
    --orbit moves it (a CameraManipulator; its first move rebuilds the
    projection at its default 60 degrees, as the JAX app's does)."""
    from ..scene.camera import CameraManipulator

    fwd = -cam.view_inv[:3, 2].cpu().numpy()
    eye = cam.pos.cpu().numpy()
    manip = CameraManipulator(eye, eye + fwd * 3.0, aspect=aspect,
                              device=cam.pos.device)
    manip._cam = cam
    return [cam] + [manip.orbit(orbit, 0.0) if orbit else manip.hold()
                    for _ in range(frames - 1)]


def render_rank(group: RowGroup, job: dict, scene=None, cam=None) -> dict:
    """Render `job["frames"]` frames of `job["scene"]` (a registry name,
    loaded here unless `scene`, `cam` are given) under `job["cfg"]` on
    `job["device"]` as `group`'s rank, `job["trav"]` the traversal
    (ops/packets.TRAV; without it the rank keeps its own, "auto" by
    default: the walk kernel on a card), the camera orbiting
    `job["orbit"]` radians a frame (orbit_cameras), the tonemapper's auto
    exposure bits `job["auto_exposure"]` (0 by default).  Returns, for the rank: each
    frame's full `job["output"]` ("image" by default) gathered from every
    rank (numpy, on rank 0 only), its ms per frame (synchronised host
    clock), the collective summary of frame 1 (the first after the
    warm-up), the kernels' launches in the frames, the rows of the
    carried planes, and with `job["gbuf"]` the last frame's primary
    triangles and depths of the whole image (numpy, rank 0)."""
    from ..app.headless import set_numerics
    from ..models.scenes import load_scene
    from ..ops import packets
    from ..render.config import default_params, default_tonemap
    from ..render.frame import init_frame_state

    cfg, dev = job["cfg"], torch.device(job["device"])
    set_numerics()
    if scene is None:
        scene, cam = load_scene(job["scene"], device=dev)
    params = default_params(device=dev)
    tm = default_tonemap(device=dev)._replace(auto_exposure=torch.tensor(
        job.get("auto_exposure", 0), device=dev))
    state = shard_state(init_frame_state(cfg, cam), cfg, group)
    step = make_sharded_step(cfg, group)
    cams = orbit_cameras(cam, job["frames"], job.get("orbit", 0.0),
                         cfg.width / cfg.height)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    trav, packets.TRAV = packets.TRAV, job.get("trav", packets.TRAV)
    images, ms, audit = [], [], None
    try:
        _reset_launches()
        for k, cam in enumerate(cams):
            group.log.clear()
            sync()
            t0 = time.perf_counter()
            state, out = step(scene, cam, params, tm, state)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if k == min(1, job["frames"] - 1):
                audit = collective_summary(group.log)
            launches = _walk_launches()
            img = gather_rows(group, out[job.get("output", "image")])
            if group.rank == 0:
                images.append(img.cpu().numpy())
    finally:
        packets.TRAV = trav
    assert_row_sharded(state, cfg, group)
    gbuf = None
    if job.get("gbuf"):
        gbuf = [gather_rows(group, a).cpu().numpy()
                for a in (state.gbuf.tri, state.gbuf.depth)]
    return {"rank": group.rank, "images": images, "ms": ms, "audit": audit,
            "launches": launches, "gbuf": gbuf if group.rank == 0 else None,
            "rows": {f: int(tree_leaves(getattr(state, f))[0].shape[0])
                     for f in _PLANES}}


def _rank_main(rank, world, backend, init_method, fn, args, out_dir,
               threads, timeout_s):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    group = exchange.init_group(rank, world, backend, init_method, timeout_s)
    try:
        torch.save(fn(group, *args), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        exchange.close_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, backend: str, fn, args=(), timeout_s=600.0,
              threads: int = 0) -> list:
    """Run fn(group, *args) on `world` new processes (spawn), one rank
    each, over a fresh `backend` process group at tcp://localhost, and
    return their results in rank order.  `fn` and its arguments are
    pickled: a module-level function of a module that imports no JAX.
    Raises when a rank fails, and kills every rank and raises
    TimeoutError when the run outlasts `timeout_s` (a hung collective
    fails fast).  `threads` > 0 sets each rank's torch threads."""
    init = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="eidola_ranks_") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, backend, init, fn, args, out_dir,
                              threads, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks over {backend} did not "
                                   f"finish within {timeout_s} s")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world)]
