"""The port's hand-written CUDA kernels against their plain versions.

Needs a CUDA device (marked `cuda`; skips without one) and imports no JAX,
so it runs on a machine with the card but no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: the suite's conftest.py configures JAX.)  Built without
FMA contraction, each kernel must agree with its plain version bit for
bit, invalid tail rows included (mt_mxu: dead rays), and on
drain_case's edges (the reciprocal's division branch, dets at the 1e-12
threshold, all-dead and all-hit warps); the walk kernel
against `walk_ref` with group=1 (its one-block-per-packet semantics), on
flat and instanced BVHs, the instanced alpha BVH among them, outputs and
per-packet step and event counts alike; the alpha march's lap
kernels (`lap_prep`, `lap_merge`) against the plain lap on every lap of
a standin frame at 1920x1080 and on small flat, instanced and
untextured scenes under MASK and BLEND, whole frames alike, and their
launch count against the march's select spans; the a-trous level kernel
(ops/atrous.py) against the torch level at levels 0-4, on full and
strided views, images narrower than a level's reach, invalid pixels,
mismatched material hashes and row-extended planes, the whole denoiser
and a frame alike, with its launches, no host sync and no other kernel.
"""
import os

import numpy as np
import pytest
import torch

from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import bvh_fused as TF
from eidola_tpu_torch.ops import bvh_instanced as TI
from eidola_tpu_torch.ops import bvh_mxu as TM
from eidola_tpu_torch.ops import bvh_walk as TW
from eidola_tpu_torch.utils.drain_case import (make_case, mxu_args,
                                               random_runs, torch_args)

torch.set_num_threads(2)

CASES = [
    # (leaf size, leaves, runs, events, spread, seed, drain_case edges)
    (8, 6, [3, 14, 1, 9, 2, 5], 48, 0.0, 7, False),
    (64, 6, [3, 14, 1, 9, 2, 5], 48, 0.0, 8, False),
    (64, 512, random_runs(1000, 32, 9), 1024, 20.0, 9, False),
    # many one-event segments: one block per event, no carry
    (64, 256, [1] * 2000, 2048, 20.0, 10, False),
    # 32-event segments (the queue's depth), an invalid tail, exact-t
    # ties inside an event and across the first two
    (64, 64, [32] * 30, 1024, 0.0, 11, False),
    (8, 64, [32] * 30, 1024, 0.0, 12, False),
    # the edges: det at the 1e-12 threshold and 2^126 (the division
    # branch), warps whose lanes all hit triangle 0, dead warps and events
    (64, 6, [3, 14, 1, 9, 2, 5], 48, 0.0, 13, True),
    (8, 6, [3, 14, 1, 9, 2, 5], 48, 0.0, 14, True),
    (64, 64, random_runs(1000, 32, 15), 1024, 0.0, 15, True),
]
PARAMS = "n,leaves,runs,ce,spread,seed,edge"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize(PARAMS, CASES)
def test_closest_kernel_matches_plain(cuda, n, leaves, runs, ce, spread, seed,
                                      edge):
    c = make_case(n, leaves, runs, ce, seed, spread, edge)
    args = torch_args(c, cuda, closest=True)
    before = TF.LAUNCHES["mt_fused"]
    out = TF.mt_fused(*args, n)
    ref = TF.mt_fused_ref(*args, n)
    torch.cuda.synchronize()
    assert TF.LAUNCHES["mt_fused"] == before + 1
    assert (out[0] < args[-1]).any(), "degenerate case: no hits"
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize(PARAMS, CASES)
def test_any_kernel_matches_plain(cuda, n, leaves, runs, ce, spread, seed,
                                  edge):
    c = make_case(n, leaves, runs, ce, seed, spread, edge)
    args = torch_args(c, cuda, closest=False)
    before = TF.LAUNCHES["mt_any_fused"]
    h = TF.mt_any_fused(*args, n)
    ref = TF.mt_any_fused_ref(*args, n)
    torch.cuda.synchronize()
    assert TF.LAUNCHES["mt_any_fused"] == before + 1
    assert 0 < int(h.sum()) < h.numel()
    assert torch.equal(h, ref)


@pytest.mark.cuda
@pytest.mark.parametrize(PARAMS, CASES)
def test_mxu_kernel_matches_plain(cuda, n, leaves, runs, ce, spread, seed,
                                  edge):
    """mt_mxu on gathered leaf rows: exact-t ties inside each event
    (triangle 1 duplicates 0) and across events (leaf 1 duplicates leaf
    0), a dead invalid tail."""
    c = make_case(n, leaves, runs, ce, seed, spread, edge)
    args = mxu_args(c, cuda)
    before = TM.LAUNCHES["mt_mxu"]
    out = TM.mt_mxu(args[0], n, *args[1:])
    ref = TM.mt_mxu_ref(args[0], n, *args[1:])
    torch.cuda.synchronize()
    assert TM.LAUNCHES["mt_mxu"] == before + 1
    hit = out[0] < 1e30
    assert hit.any() and not hit[c["n_valid"]:].any()
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))


def _walk_case(dev, leaf_size, seed):
    """1500 triangles in a cluster, 1000 rays aimed into it (a third of
    them shadow-length, 24 dead); the rays pad to 8 packets."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (1500, 3)).astype(np.float32)
    v = [c + rng.normal(0, 0.3, (1500, 3)).astype(np.float32)
         for _ in range(3)]
    bvh = TB.build_bvh(*v, device=dev, leaf_size=leaf_size)
    o = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (1000, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(1000) % 3, 1e9, 4.0).astype(np.float32)
    tmax[:24] = -1.0
    rays = TW.pack_rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                        torch.full((1000,), 1e-4, device=dev),
                        torch.from_numpy(tmax).to(dev))
    return bvh, rays


def _instanced_walk_case(dev, leaf_size, seed):
    """Two clustered meshes under six instances (rotated, scaled 0.5-2,
    one mirrored, translated), 2000 rays aimed into them (a third
    shadow-length, 24 dead)."""
    rng = np.random.default_rng(seed)
    meshes = []
    for n in (900, 500):
        c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        meshes.append(tuple(c + rng.normal(0, 0.2, (n, 3)).astype(np.float32)
                            for _ in range(3)))
    instances = []
    for k in range(6):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * rng.uniform(0.5, 2.0)
        if k == 3:
            m[:3, 0] *= -1.0
        m[:3, 3] = rng.uniform(-4, 4, 3)
        instances.append((k % 2, m))
    bvh = TI.build_instanced_bvh(meshes, instances, device=dev,
                                 leaf_size=leaf_size)
    o = rng.uniform(-8, 8, (2000, 3)).astype(np.float32)
    tgt = np.stack([m[:3, 3] for _, m in instances])[np.arange(2000) % 6]
    d = (tgt + rng.uniform(-1, 1, (2000, 3))).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(2000) % 3, 1e9, 6.0).astype(np.float32)
    tmax[:24] = -1.0
    rays = TW.pack_rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                        torch.full((2000,), 1e-4, device=dev),
                        torch.from_numpy(tmax).to(dev))
    return bvh, rays, (bvh.leaf_mesh_row, bvh.leaf_inst, bvh.inst_inv)


@pytest.mark.cuda
@pytest.mark.parametrize("instanced", [False, True], ids=["flat", "instanced"])
@pytest.mark.parametrize("leaf_size", [8, 64])
@pytest.mark.parametrize("name", ["walk_closest", "walk_any"])
def test_walk_kernel_matches_plain(cuda, name, leaf_size, instanced):
    if instanced:
        bvh, rays, inst = _instanced_walk_case(cuda, leaf_size,
                                               seed=leaf_size + 1)
    else:
        bvh, rays = _walk_case(cuda, leaf_size, seed=leaf_size)
        inst = None
    P = rays.shape[1]
    stats = torch.zeros((P, 2), dtype=torch.int32, device=cuda)
    ref_stats = torch.zeros_like(stats)
    before = TW.LAUNCHES[name]
    out = getattr(TW, name)(bvh.walk, bvh.leaf_blocks, rays, 100_000,
                            stats=stats, inst=inst)
    ref = TW.walk_ref(bvh.walk, bvh.leaf_blocks, rays, name == "walk_any",
                      100_000, group=1, stats=ref_stats, inst=inst)
    torch.cuda.synchronize()
    assert TW.LAUNCHES[name] == before + 1
    assert 0 < int((out[1] >= 0).sum()) < out[1].numel()
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(stats, ref_stats)


def _option_walk_case(dev, leaf_size, monkeypatch):
    """The walk on the instanced alpha BVH: mini_grove's alpha half built
    instanced (EIDOLA_ALPHA_FLAT=0); 1024 rays aimed at the canopies, a
    third shadow-length, 24 dead."""
    from eidola_tpu_torch.models import scenes as TS

    rng = np.random.default_rng(leaf_size)
    monkeypatch.setenv("EIDOLA_ALPHA_FLAT", "0")
    monkeypatch.setenv("EIDOLA_ALPHA_LEAF", str(leaf_size))
    bvh = TS.mini_grove(device=dev)[0].bvh_alpha
    assert hasattr(bvh, "leaf_mesh_row") and bvh.leaf_size == leaf_size
    lo, hi = [-3.0, 0.5, -3.0], [3.0, 3.5, 3.0]
    inst = (bvh.leaf_mesh_row, bvh.leaf_inst, bvh.inst_inv)
    o = rng.uniform([-6, 0, 6], [10, 6, 9], (1024, 3)).astype(np.float32)
    d = (rng.uniform(lo, hi, (1024, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(1024) % 3, 1e9, 5.0).astype(np.float32)
    tmax[:24] = -1.0
    rays = TW.pack_rays(torch.from_numpy(o).to(dev),
                        torch.from_numpy(d).to(dev),
                        torch.full((1024,), 1e-4, device=dev),
                        torch.from_numpy(tmax).to(dev))
    return bvh, rays, inst


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [8, 64])
@pytest.mark.parametrize("name", ["walk_closest", "walk_any"])
def test_walk_kernel_on_option_bvhs(cuda, name, leaf_size, monkeypatch):
    """The walk kernel takes the instanced alpha BVH unchanged: bitwise
    against walk_ref(group=1), counts included."""
    bvh, rays, inst = _option_walk_case(cuda, leaf_size, monkeypatch)
    P = rays.shape[1]
    stats = torch.zeros((P, 2), dtype=torch.int32, device=cuda)
    ref_stats = torch.zeros_like(stats)
    out = getattr(TW, name)(bvh.walk, bvh.leaf_blocks, rays, 100_000,
                            stats=stats, inst=inst)
    ref = TW.walk_ref(bvh.walk, bvh.leaf_blocks, rays, name == "walk_any",
                      100_000, group=1, stats=ref_stats, inst=inst)
    torch.cuda.synchronize()
    assert 0 < int((out[1] >= 0).sum()) < out[1].numel()
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(stats, ref_stats)


@pytest.mark.cuda
@pytest.mark.parametrize("instanced", [False, True], ids=["flat", "instanced"])
@pytest.mark.parametrize("leaf_size", [8, 64])
def test_walk_kernel_seeded_matches_plain(cuda, leaf_size, instanced):
    """walk_closest on primary_seed's rays: last frame's triangle re-tested
    against rays a little off (render/direct.py _seed_tmax) bounds t_max
    on most lanes, so the walk prunes from step 0.  Bitwise equal to
    walk_ref with the counts, the same hits as without the seed, and no
    more leaf events."""
    from types import SimpleNamespace

    from eidola_tpu_torch.render.config import RenderConfig
    from eidola_tpu_torch.render.direct import _seed_tmax

    if instanced:
        bvh, rays, inst = _instanced_walk_case(cuda, leaf_size,
                                               seed=leaf_size + 3)
    else:
        bvh, rays = _walk_case(cuda, leaf_size, seed=leaf_size + 2)
        inst = None
    R = rays.shape[1] * rays.shape[2]
    o, d = rays[0:3].reshape(3, R).T, rays[3:6].reshape(3, R).T
    tn = torch.full((R,), 1e-4, device=cuda)
    tx = torch.full((R,), 1e8, device=cuda)
    prev = TW.closest_hit_walk(bvh, o + 0.002, d, tn, tx)
    scene = SimpleNamespace(bvh=bvh, inst=inst)
    t_max0 = _seed_tmax(RenderConfig(primary_seed=True), scene, o, d,
                        prev.tri)
    assert 0.2 < float((t_max0 < 1e8).float().mean()) < 1.0
    seeded = TW.pack_rays(o, d, tn, t_max0)
    P = seeded.shape[1]
    stats = torch.zeros((P, 2), dtype=torch.int32, device=cuda)
    ref_stats = torch.zeros_like(stats)
    base_stats = torch.zeros_like(stats)
    out = TW.walk_closest(bvh.walk, bvh.leaf_blocks, seeded, 100_000,
                          stats=stats, inst=inst)
    ref = TW.walk_ref(bvh.walk, bvh.leaf_blocks, seeded, False, 100_000,
                      group=1, stats=ref_stats, inst=inst)
    base = TW.walk_closest(bvh.walk, bvh.leaf_blocks,
                           TW.pack_rays(o, d, tn, tx), 100_000,
                           stats=base_stats, inst=inst)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(stats, ref_stats)
    assert torch.equal(out[1], base[1]) and torch.equal(out[0], base[0])
    assert int(stats[:, 1].sum()) <= int(base_stats[:, 1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [8, 64])
def test_walk_kernel_matches_brute_force(cuda, leaf_size):
    """The walk kernel's closest and any hit against ops/intersect's
    brute_force_closest on the card, on a small random scene: the same
    triangle on >= 0.999 of rays (another only at an exact-t tie), t
    within 1e-5 relative, occlusion equal."""
    from eidola_tpu_torch.ops.intersect import brute_force_closest

    rng = np.random.default_rng(leaf_size + 40)
    c = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    vn = [c + rng.normal(0, 0.3, (600, 3)).astype(np.float32)
          for _ in range(3)]
    bvh = TB.build_bvh(*vn, device=cuda, leaf_size=leaf_size)
    v = [torch.from_numpy(a).to(cuda) for a in vn]
    n = 2000
    o = torch.from_numpy(rng.uniform(-5, 5, (n, 3)).astype(np.float32)
                         ).to(cuda)
    d = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)
                         ).to(cuda) - o
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    tn = torch.full((n,), 1e-4, device=cuda)
    tx = torch.where(torch.arange(n, device=cuda) % 3 == 0, 4.0, 1e8)
    rec = TW.closest_hit_walk(bvh, o, d, tn, tx)
    occ = TW.any_hit_walk(bvh, o, d, tn, tx)
    tri, t, _, _ = brute_force_closest(o, d, v[0], v[1] - v[0], v[2] - v[0],
                                       tn, tx)
    torch.cuda.synchronize()
    hit = tri >= 0
    assert 0.1 < float(hit.float().mean()) < 0.95
    assert torch.equal(rec.tri >= 0, hit) and torch.equal(occ, hit)
    assert float((rec.tri == tri).float().mean()) >= 0.999
    assert torch.allclose(rec.t[hit], t[hit], rtol=1e-5)


@pytest.mark.cuda
def test_png_roundtrip_of_a_card_frame(cuda):
    """utils/png.py on a 1920x1080 frame rendered on the card."""
    from eidola_tpu_torch.app import headless
    from eidola_tpu_torch.utils.png import decode_png, encode_png

    img = headless.run(["--scene", "cornell", "--size", "1920", "1080",
                        "--frames", "1", "--no-denoise", "--no-indirect",
                        "--device", "cuda", "--quiet"])["image"]
    u8 = headless.to_u8(img)
    assert u8.shape == (1080, 1920, 3) and u8.std() > 0
    back = decode_png(encode_png(u8))
    assert np.array_equal(back[..., :3], u8) and (back[..., 3] == 255).all()


@pytest.mark.cuda
def test_gltf_scene_on_the_card(cuda, tmp_path):
    """The glTF loader builds a small instanced GLB's SceneData on cuda,
    every tensor of it."""
    from eidola_tpu_torch.models.scenes import write_standin_glb
    from eidola_tpu_torch.scene.gltf import load_gltf_scene

    path = str(tmp_path / "standin.glb")
    write_standin_glb(path, target_mtris=0.005)
    scene, cam = load_gltf_scene(path, device=cuda)
    assert scene.inst is not None and scene.bvh_alpha is not None
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk((scene, cam))
    assert len(leaves) > 50
    assert all(t.device.type == "cuda" for t in leaves)


@pytest.mark.cuda
def test_device_monitor_on_the_card(cuda):
    from eidola_tpu_torch.utils.monitor import DeviceMonitor

    x = torch.ones(1 << 20, device=cuda)
    mon = DeviceMonitor(cuda, interval_s=0.0)
    mon.refresh()
    assert mon.bytes_in_use[-1] >= x.numel() * 4
    assert mon.bytes_limit > 2**30 and mon.host_rss[-1] > 0
    assert torch.cuda.get_device_name(cuda) in mon.summary()


@pytest.mark.cuda
def test_sharded_step_world_one_over_nccl(cuda):
    """chip_smoke.py's multidevice phase (b) at a small size: the sharded
    step at world size 1 over NCCL, through the walk kernels, equal to the
    single-process frame on the card (the bounds of
    tests/test_parallel.py:45-46)."""
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.ops import packets as TP
    from eidola_tpu_torch.parallel import exchange as X
    from eidola_tpu_torch.parallel.sharding import free_port, render_rank
    from eidola_tpu_torch.render.config import (RenderConfig,
                                                default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    cfg = RenderConfig(width=64, height=64, max_depth=2,
                       traversal_max_steps=1024)
    scene, cam = load_scene("cornell", device=cuda)
    job = dict(scene="cornell", cfg=cfg, frames=3, device="cuda",
               trav="pallas")
    group = X.init_group(0, 1, "nccl", f"tcp://localhost:{free_port()}")
    try:
        res = render_rank(group, job, scene, cam)
    finally:
        X.close_group()
    params, tm = default_params(device=cuda), default_tonemap(device=cuda)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    TP.TRAV, trav = "pallas", TP.TRAV
    try:
        for _ in range(3):
            state, out = step(scene, cam, params, tm, state)
    finally:
        TP.TRAV = trav
    diff = np.abs(res["images"][-1] - out["image"].cpu().numpy())
    assert diff.max() < 5e-2 and diff.mean() < 2e-3, (diff.max(), diff.mean())
    assert res["launches"]["walk_closest"] > 0
    assert res["launches"]["walk_any"] > 0
    assert res["audit"]["total"] >= 0 and res["rows"]["gbuf"] == 64


@pytest.mark.cuda
def test_default_trav_takes_walk_kernel(cuda, monkeypatch):
    """With nothing set ("auto"), CUDA rays through the image door launch
    walk_closest and no drain kernel."""
    from eidola_tpu_torch.ops import packets as TP

    monkeypatch.setattr(TP, "TRAV", "auto")
    rng = np.random.default_rng(21)
    c = rng.uniform(-2, 2, (1500, 3)).astype(np.float32)
    v = [c + rng.normal(0, 0.3, (1500, 3)).astype(np.float32)
         for _ in range(3)]
    bvh = TB.build_bvh(*v, device=cuda)
    h, w = 32, 64
    o = torch.tensor([0.3, 0.2, 9.0], device=cuda).expand(h, w, 3)
    tgt = torch.from_numpy(rng.uniform(-2, 2, (h, w, 3)).astype(
        np.float32)).to(cuda)
    d = (tgt - o) / (tgt - o).norm(dim=-1, keepdim=True)
    tmin = torch.full((h, w), 1e-4, device=cuda)
    tmax = torch.full((h, w), 1e9, device=cuda)
    TW.reset_launches()
    TF.reset_launches()
    TM.reset_launches()
    rec = TP.closest_hit_img(bvh, o.contiguous(), d, tmin, tmax)
    torch.cuda.synchronize()
    assert TP.resolve_trav(o.device) == "pallas"
    assert TW.LAUNCHES["walk_closest"] == 1
    assert TF.LAUNCHES["mt_fused"] == TF.LAUNCHES["mt_any_fused"] == 0
    assert TM.LAUNCHES["mt_mxu"] == 0
    assert float((rec.tri >= 0).float().mean()) > 0.05


@pytest.mark.cuda
def test_batched_device_put_on_the_card(cuda, monkeypatch):
    """A scene's host tree uploaded with one copy per dtype: every leaf at
    a 256-byte offset on the card, bit for bit equal to to_device's."""
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.scene import data as TD
    from eidola_tpu_torch.utils import transfer as TT

    seen = []
    real = TD.batched_device_put
    monkeypatch.setattr(TD, "batched_device_put",
                        lambda t, d: seen.append(t) or real(t, d))
    load_scene("mini_grove", device=cuda)
    want = TT.to_device(seen[0], cuda)
    before = TT.COPIES[0]
    got = TT.batched_device_put(seen[0], cuda)
    copies = TT.COPIES[0] - before

    def leaves(tree):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            for x in tree:
                yield from leaves(x)
        else:
            yield tree

    dtypes = set()
    for a, b in zip(leaves(got), leaves(want), strict=True):
        if b is None:
            assert a is None
            continue
        dtypes.add(a.dtype)
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert a.data_ptr() % TT.ALIGN == 0
        assert torch.equal(_bits(a), _bits(b))
    assert 1 <= copies <= len(dtypes)


@pytest.mark.cuda
def test_bench_on_the_card(cuda):
    """The bench at a small size on the card: instanced and alpha walks
    through the walk kernels, no drain, the golden held, the device
    metrics filled in."""
    import contextlib
    import io
    import json

    from eidola_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--scene", "mini_grove", "--size", "64", "64",
                         "--warmup", "1", "--iters", "2"])
    out = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 0 and out["correct"] is True, out
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["power_limit_w"] > 0 and out["device"]["count"] >= 1
    per = out["launches_per_frame"]
    assert per["walk_closest_instanced"] > 0 and per["walk_any"] > 0
    assert per["walk_closest"] > per["walk_closest_instanced"]   # alpha BVH
    assert per["mt_fused"] == per["mt_any_fused"] == per["mt_mxu"] == 0
    assert out["peak_mem_gib"] > 0
    assert out["mrays_method"].startswith("measured")


@pytest.mark.cuda
def test_bench_frame_events_fill_the_window(cuda):
    """The bench's timed window on the card: the CUDA events at its frame
    boundaries sum to within 5% of the window's host-clock ms."""
    from eidola_tpu_torch import bench
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.render.config import (default_params,
                                                default_tonemap)

    scene, cam = load_scene("mini_grove", device=cuda)
    cfg = bench.frame_cfg(scene, 64, 64)
    _, out, first, window, frame_ms, _ = bench.time_frames(
        cfg, scene, cam, default_params(device=cuda),
        default_tonemap(device=cuda), cuda, 1, 4)
    assert bool(torch.isfinite(out["image"]).all())
    assert first > 0 and len(frame_ms) == 4 and min(frame_ms) > 0
    assert abs(sum(frame_ms) - window) <= 0.05 * window, (frame_ms, window)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "mini_grove"])
def test_small_reference_on_the_card(cuda, name):
    """Frame 3 at 272x136 (a GI field that cannot be tiled, as at 1080p)
    through the walk kernels and the card's queue alpha march, against
    the JAX package's stored frame (tests/golden_torch/; mini_grove's
    rendered under the same march), within 0.02 mean abs; the readings
    on the card equal the same frame's readings taken on the host."""
    import os

    from eidola_tpu_torch.app.headless import alpha_geometry
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.render.config import (RenderConfig,
                                                default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step
    from eidola_tpu_torch.utils import reference as R

    scene, cam = load_scene(name, device=cuda)
    cfg = RenderConfig(width=272, height=136, max_depth=4,
                       traversal_max_steps=1024,
                       env_mode="hdr" if scene.env is not None else "sunsky",
                       alpha_geometry=alpha_geometry(scene))
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    params, tm = default_params(device=cuda), default_tonemap(device=cuda)
    for _ in range(4):
        state, out = step(scene, cam, params, tm, state)
    ref = R.load(os.path.join(R.REF_DIR, R.file_name(
        name, 272, 136, 4, 3, "queue" if cfg.alpha_geometry else "auto")))
    got = R.compare(out["hdr"], ref)
    assert got["ok"], R.line(name, got)
    host = R.compare(out["hdr"].cpu(), ref)
    assert host["block_max_at"] == got["block_max_at"]
    assert host["mean_abs"] == pytest.approx(got["mean_abs"], rel=1e-6,
                                             abs=1e-12)


@pytest.mark.cuda
def test_three_stage_queue_reference_on_the_card(cuda, monkeypatch):
    """mini_grove at 400x200 under EIDOLA_MARCH_MIN=2048: the card's queue
    march (its default) runs the three lap capacities of 1920x1080, each
    for a lap, and frame 3 holds against JAX's frame under the same
    switches (tests/golden_torch/, the `_queue_min2048` file)."""
    import os

    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.render import tracer as TT
    from eidola_tpu_torch.render.config import (default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step
    from eidola_tpu_torch.utils import reference as R
    from test_torch_fullsize import (QUEUE3, QUEUE3_CAPS, QUEUE3_SIZE,
                                     count_laps, laps_per_stage, small_cfg)

    for k, v in QUEUE3.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("EIDOLA_ALPHA_MARCH", raising=False)
    laps = count_laps(monkeypatch)
    scene, cam = load_scene("mini_grove", device=cuda)
    cfg = small_cfg(scene, *QUEUE3_SIZE)
    assert TT._march_mode(cuda) == "queue"
    assert TT._march_caps(cfg.width * cfg.height) == QUEUE3_CAPS
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    params, tm = default_params(device=cuda), default_tonemap(device=cuda)
    for _ in range(4):
        state, out = step(scene, cam, params, tm, state)
    assert min(laps_per_stage(laps, QUEUE3_CAPS)) >= 1, laps
    ref = R.load(os.path.join(R.REF_DIR, R.file_name(
        "mini_grove", *QUEUE3_SIZE, 4, 3, "queue", "min2048")))
    got = R.compare(out["hdr"], ref)
    assert got["ok"], R.line("mini_grove queue3", got)


@pytest.mark.cuda
def test_bench_standin_reads_the_queue_reference(cuda):
    """The bench's standin line on the card, no switch set, 2 warm-up and 3
    timed frames (chip_smoke.py's bench phase): frame 1 is held against
    JAX's frame 1 under the queue march, the card's
    (`bistro_standin_1920x1080_d4_f1_queue.npz`), and the window's last
    frame, 4, against JAX's frame 4 under it after the window
    (`reference_last_*`); both within the bound, `correct`."""
    from eidola_tpu_torch import bench
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.utils import reference as R

    scene, cam = load_scene("bistro_standin", device=cuda)
    out = bench.measure(scene, cam, cuda, "bistro_standin", warmup=2,
                        iters=3)
    assert out["correct"] is True, out.get("error")
    assert out["alpha_march"] == "queue"
    assert out["reference_frame"] == 1 and out["reference_last_frame"] == 4
    for tag, frame in (("", 1), ("last_", 4)):
        assert out[f"reference_{tag}file"].endswith(
            f"bistro_standin_1920x1080_d4_f{frame}_queue.npz")
        assert out[f"reference_{tag}mean_abs"] < R.BOUND
        assert out[f"reference_{tag}block_mean_abs"] < R.BOUND
        assert len(out[f"reference_{tag}block_max_at"]) == 2


@pytest.mark.cuda
def test_phase_frames_find_their_references(cuda, tmp_path):
    """chip_smoke.py's interactive frames (1, 3) and gltf frames (2, 4)
    find their stored JAX frames on the card: the card's march (queue),
    the files' names, and for the gltf frames the sha256 of the inputs
    written on this machine.  Renders no frame (the configs come from
    the scenes at a small triangle count)."""
    import importlib.util

    from eidola_tpu_torch.app import headless
    from eidola_tpu_torch.models.scenes import load_scene, write_standin_glb
    from eidola_tpu_torch.render.tracer import _march_mode
    from eidola_tpu_torch.scene.data import attach_env
    from eidola_tpu_torch.scene.hdr import build_env_map, load_hdr
    from eidola_tpu_torch.utils import reference as R

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(R.ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    march = _march_mode(cuda)
    assert march == "queue"
    files = R.write_inputs(str(tmp_path))
    inputs = {k: v["sha256"] for k, v in files.items()}
    small = str(tmp_path / "small.glb")
    write_standin_glb(small, 0.002)
    glb, _ = load_scene(small, device=cuda)
    glb = attach_env(glb, build_env_map(load_hdr(files["hdr"]["path"]),
                                        device=cuda))
    standin, _ = load_scene("bistro_standin", device=cuda,
                            target_mtris=0.002)
    cases = [(cs.INTERACTIVE, standin, "bistro_standin", None, frame,
              f"bistro_standin_1920x1080_d4_f{frame}_queue_interactive.npz")
             for frame in cs.INTERACTIVE_FRAMES]
    cases += [(["--scene", files["glb"]["path"], "-e",
                files["hdr"]["path"]] + cs.GLTF, glb, R.GLTF_SCENE, inputs,
               frame, f"standin_glb_1920x1080_d4_f{frame}_queue.npz")
              for frame in cs.GLTF_FRAMES]
    for argv, scene, name, inp, frame, want in cases:
        args = headless.build_argparser().parse_args(argv)
        cfg = headless.frame_config(args, scene, *args.size[:2])
        path = R.find(name, cfg, frame, march, args.orbit, inp)
        assert path is not None and os.path.basename(path) == want
        assert R.march_of(R.load(path)["meta"]) == march


@pytest.mark.cuda
def test_entry_step_on_the_card(cuda):
    """entry("cuda")'s step against entry("cpu")'s, the goldens' bound."""
    from eidola_tpu_torch.entry import entry

    fn, args = entry(cuda)
    _, got = fn(*args)
    fn, args = entry("cpu")
    _, want = fn(*args)
    assert got.is_cuda and bool(torch.isfinite(got).all())
    assert float((got.cpu() - want).abs().mean()) < 0.02


@pytest.mark.cuda
def test_every_sync_of_an_alpha_frame_is_spanned(cuda):
    """Under torch.cuda.set_sync_debug_mode("warn"), every synchronizing
    call of a mini_grove frame (the alpha HitTest's queue march, the sun
    and sky, the GI bounces) falls inside one of the StageTimer's sync
    spans, as many a site as the timer's spans count."""
    import time
    import warnings

    from eidola_tpu_torch import bench
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.render.config import (default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step
    from eidola_tpu_torch.utils.profiler import StageTimer

    scene, cam = load_scene("mini_grove", device=cuda)
    cfg = bench.frame_cfg(scene, 64, 64)
    step = make_step(cfg)
    params, tm = default_params(device=cuda), default_tonemap(device=cuda)
    state, _ = step(scene, cam, params, tm, init_frame_state(cfg, cam))
    torch.cuda.synchronize()
    timer = StageTimer(cuda)
    warned = []

    def hook(message, *a, **k):
        # one warning a sync, stamped on the spans' clock (the mode's own
        # notice that it is a prototype is not one)
        if "called a synchronizing CUDA operation" in str(message):
            warned.append(time.perf_counter_ns())

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(scene, cam, params, tm, state, timer=timer)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [s for s in timer.spans() if s[0] == "sync"]
    seen, spanned = {}, {}
    for t in warned:
        site = next((s[1] for s in syncs if s[4] <= t <= s[5]), None)
        seen[site] = seen.get(site, 0) + 1
    for s in syncs:
        spanned[s[1]] = spanned.get(s[1], 0) + 1
    assert spanned.get("march.count", 0) > 0
    assert seen == spanned


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _plain_laps(monkeypatch):
    """Route the queue march's laps through the plain lap on the card."""
    from eidola_tpu_torch.render import tracer as TT

    monkeypatch.setattr(TT, "_lap_prep", TT._lap_prep_ref)
    monkeypatch.setattr(TT, "_lap_merge", TT._lap_merge_ref)


def _hold_laps(monkeypatch) -> list:
    """Every lap of the queue march runs from one state twice, through
    lap_prep + lap_merge and through the plain lap: the compact rays,
    keys and scratch, then the band after the whole lap, bitwise.  Returns
    the (lanes, occl) of each lap held."""
    from eidola_tpu_torch.ops import alpha_lap
    from eidola_tpu_torch.ops.packets import closest_hit_sorted, sort_order
    from eidola_tpu_torch.render import tracer as TT

    held, lap = [], TT._march_lap

    def checked(sc, hop, sel, band, max_steps, occl):
        plain = type(band)(*[a.clone() for a in band])
        got = alpha_lap.lap_prep(sel, band, TT._alpha_tables(sc), hop.walk,
                                 occl)
        want = TT._lap_prep_ref(sc, hop, sel, plain, occl)
        for f, a, b in zip(got._fields, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        lap(sc, hop, sel, band, max_steps, occl)
        TT._lap_merge_ref(sel, plain, closest_hit_sorted(
            hop, want.o, want.d, want.tn, want.tx, max_steps=max_steps,
            order=sort_order(want.keys)), want, occl)
        for f, a, b in zip(band._fields, band, plain):
            assert torch.equal(a, b), f
        held.append((sel.numel(), occl))

    monkeypatch.setattr(TT, "_march_lap", checked)
    return held


@pytest.fixture(scope="module")
def standin_1080():
    """bistro_standin on the card with bench.py's 1920x1080 config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eidola_tpu_torch import bench
    from eidola_tpu_torch.models.scenes import load_scene

    scene, cam = load_scene("bistro_standin", device=torch.device("cuda"))
    return scene, cam, bench.frame_cfg(scene, 1920, 1080)


def _frames(scene, cam, cfg, n, timer=None):
    from eidola_tpu_torch.render.config import (default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    dev = cam.pos.device
    params, tm = default_params(device=dev), default_tonemap(device=dev)
    state, step = init_frame_state(cfg, cam), make_step(cfg)
    for _ in range(n):
        state, out = step(scene, cam, params, tm, state, timer=timer)
    torch.cuda.synchronize()
    return state, out


@pytest.mark.cuda
def test_alpha_lap_kernels_match_plain_on_standin_laps(standin_1080,
                                                       monkeypatch):
    """Every lap of a standin frame at 1920x1080 (the queue march, the
    card's default), closest and occlusion: lap_prep + lap_merge equal the
    plain lap bit for bit."""
    monkeypatch.delenv("EIDOLA_ALPHA_MARCH", raising=False)
    held = _hold_laps(monkeypatch)
    _frames(*standin_1080, 1)
    assert {o for _, o in held} == {False, True}, held
    assert max(n for n, _ in held) > 4096, held


def _trace_case(kind, dev):
    """(scene, o, d, t_max of the shadow rays) for the small lap cases:
    mini_grove with its MASK leaf cards made BLEND (instanced, textured),
    the alpha screen (flat, textured MASK), the stacked quads (untextured
    MASK at base alpha 0.4, and BLEND at 0.5)."""
    from eidola_tpu_torch.models import scenes as TS
    from eidola_tpu_torch.scene import data as TD

    rng = np.random.default_rng(23)
    n = 4096
    if kind.startswith("untextured"):
        blend = kind.endswith("blend")
        quads = [TS.quad_tris([-2, -2, z], [2, -2, z], [2, 2, z],
                              [-2, 2, z]) for z in (1.0, 1.3, 1.6)]
        box = TS.box_tris([0, 0, -1.0], [0.5, 0.5, 0.5])
        tris = np.concatenate(quads + [box])
        nq = sum(q.shape[0] for q in quads)
        mats = np.concatenate([np.zeros(nq, np.int32),
                               np.ones(box.shape[0], np.int32)])
        scene = TD.upload_scene(
            tris[:, 0], tris[:, 1], tris[:, 2], device=dev, mat_ids=mats,
            materials=[{"base_color": [1, 1, 1, 0.5 if blend else 0.4],
                        "alpha_mode": TD.ALPHA_BLEND if blend
                        else TD.ALPHA_MASK, "alpha_cutoff": 0.5},
                       {"base_color": [0.5, 0.2, 0.2, 1.0]}])
        o = np.concatenate([rng.uniform(-2.5, 2.5, (n, 2)),
                            np.full((n, 1), 4.0)], 1)
        d = np.tile([0.0, 0.0, -1.0], (n, 1))
        smax = 6.0
    else:
        name, center, spread = {
            "mini_grove_blend": ("mini_grove", [0.0, 1.8, 0.0], 3.0),
            "flat": ("alpha_demo", [0.0, 1.2, 0.0], 1.6)}[kind]
        scene, _ = getattr(TS, name)(device=dev)
        if kind == "mini_grove_blend":
            am = scene.materials.alpha_mode
            scene = scene._replace(materials=scene.materials._replace(
                alpha_mode=torch.where(am == TD.ALPHA_MASK, TD.ALPHA_BLEND,
                                       am)))
        ang = rng.uniform(0, 2 * np.pi, n)
        o = np.stack([6 * np.sin(ang), rng.uniform(0.5, 4, n),
                      6 * np.cos(ang)], -1)
        d = np.asarray(center) + rng.uniform(-spread, spread, (n, 3)) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        smax = 8.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return scene, f32(o), f32(d), smax


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mini_grove_blend", "flat", "untextured",
                                  "untextured_blend"])
def test_alpha_lap_kernels_match_plain_on_small_scenes(cuda, kind,
                                                       monkeypatch):
    """The same on 4,096 rays traced at a small scene, closest hits and
    shadow rays through the queue march: mini_grove under BLEND (an
    instanced scene), a flat textured scene, an untextured one (MASK and
    BLEND); then the traces equal the plain lap's."""
    from eidola_tpu_torch.ops import rng as trng
    from eidola_tpu_torch.render import tracer as TT
    from eidola_tpu_torch.render.config import RenderConfig

    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", "queue")
    scene, o, d, smax = _trace_case(kind, cuda)
    assert (scene.inst is not None) == (kind == "mini_grove_blend")
    n = o.shape[0]
    cfg = RenderConfig(width=64, height=64, alpha_geometry=True,
                       traversal_max_steps=2048)
    rng = trng.seed_pixels(1, n, 5, device=cuda)[0]
    tmin = torch.full((n,), 1e-4, device=cuda)

    def traces():
        r1, rec = TT.trace_closest(cfg, scene, o, d, tmin,
                                   torch.full_like(tmin, 1e8), rng)
        r2, occ = TT.trace_occlusion(cfg, scene, o, d, tmin,
                                     torch.full_like(tmin, smax), rng)
        return [r1, *rec, r2, occ]

    with monkeypatch.context() as mp:
        held = _hold_laps(mp)
        got = traces()
    assert {oc for _, oc in held} == {False, True}, held
    with monkeypatch.context() as mp:
        _plain_laps(mp)
        want = traces()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < int(got[-1].sum()) < n


@pytest.mark.cuda
def test_standin_frame_with_lap_kernels_is_the_plain_laps(standin_1080,
                                                          monkeypatch):
    """Two standin frames at 1920x1080 through the lap kernels equal, bit
    for bit, the same frames with the plain lap monkeypatched in: image,
    linear light and the carried state."""
    monkeypatch.delenv("EIDOLA_ALPHA_MARCH", raising=False)
    got = _frames(*standin_1080, 2)
    with monkeypatch.context() as mp:
        _plain_laps(mp)
        want = _frames(*standin_1080, 2)
    a, b = list(_leaves(got)), list(_leaves(want))
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
def test_alpha_lap_launches_are_the_march_selects(standin_1080):
    """alpha_lap.LAUNCHES over a standin frame equals the frame's
    march.select spans (one per lap), and stays 0 over a cornell frame
    (no alpha geometry: no march)."""
    from eidola_tpu_torch import bench
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.ops import alpha_lap
    from eidola_tpu_torch.utils.profiler import StageTimer

    scene, cam, cfg = standin_1080
    counts = []
    for sc, cm, cf in ((scene, cam, cfg), (*load_scene(
            "cornell", device=cam.pos.device), None)):
        cf = cf or bench.frame_cfg(sc, 320, 240)
        timer = StageTimer(cm.pos.device)
        before = alpha_lap.LAUNCHES
        _frames(sc, cm, cf, 1, timer=timer)
        selects = sum(1 for s in timer.spans()
                      if s[0] == "sync" and s[1] == "march.select")
        counts.append((alpha_lap.LAUNCHES - before, selects))
    (laps, selects), (flat_laps, flat_selects) = counts
    assert laps == selects > 0, counts
    assert flat_laps == flat_selects == 0, counts


def _atrous_case(h, w, seed, dev, strided=False):
    """(noisy image, view, sigmas) on `dev`: an (h, w, 3) image in [0, 1],
    a view with 10% invalid pixels and three material hashes, positions
    in a 4-unit cube and unit normals; `strided`: the view planes are
    [::2, ::2] of a (2h, 2w) view, as the indirect stage's."""
    from eidola_tpu_torch.render.gbuffer import GBufferView

    r = np.random.default_rng(seed)
    hv, wv = (2 * h, 2 * w) if strided else (h, w)
    nrm = r.normal(size=(hv, wv, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(dev)
    planes = [t(r.random((hv, wv)) < 0.9),
              t((4 * r.random((hv, wv, 3))).astype(np.float32)),
              t(nrm.astype(np.float32)), t(r.integers(0, 3, (hv, wv)))]
    if strided:
        planes = [a[::2, ::2] for a in planes]
    valid, pos, nrm, mat_hash = planes
    view = GBufferView(valid, None, pos, nrm, None, mat_hash, None, None,
                       None, None)
    img = t(r.random((h, w, 3)).astype(np.float32))
    sig = [torch.tensor(x, dtype=torch.float32, device=dev)
           for x in (4.0, 128.0, 2.0)]
    return img, view, sig


ATROUS_CASES = [
    # (h, w, level, strided view): every level of a default frame, the
    # indirect stage's strided view, images narrower than the level's
    # reach (16 px at level 4) and a single pixel
    *[(67, 93, level, False) for level in range(5)],
    (67, 93, 0, True), (67, 93, 4, True),
    (7, 5, 4, False), (7, 5, 4, True), (1, 1, 2, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level,strided", ATROUS_CASES)
def test_atrous_level_kernel_matches_plain(cuda, h, w, level, strided):
    """One launch of ops/atrous.py's kernel equals the torch level
    (render/denoise.atrous_level) on the same CUDA tensors bit for bit."""
    from eidola_tpu_torch.ops import atrous
    from eidola_tpu_torch.render import denoise as D

    img, view, sig = _atrous_case(h, w, 100 * level + h, cuda, strided)
    before = atrous.LAUNCHES
    got = atrous.run_level(img, atrous.View(view.pos, view.nrm,
                                            view.mat_hash, view.valid),
                           level, *sig)
    want = D.atrous_level(img, view, level, *sig)
    torch.cuda.synchronize()
    assert atrous.LAUNCHES == before + 1
    assert got.shape == want.shape == (h, w, 3)
    assert torch.equal(_bits(got), _bits(want))
    if h * w > 1:
        assert bool((got != img).any()), "degenerate case: nothing moved"
        assert bool((~view.valid).any()), "degenerate case: all valid"


@pytest.mark.cuda
@pytest.mark.parametrize("r0", [0, 24, 36])
def test_atrous_level_kernel_on_row_extended_planes(cuda, r0):
    """A band of 24 rows from row r0 of a 60x37 image, as a shard holds it:
    its image with pad = 8 rows above and below (level 2's reach) and its
    view planes with e = 16, the rows an exchange brings (clamped at the
    image's border).  The kernel's level 2 on them equals those rows of
    the torch level on the whole image, bit for bit."""
    from eidola_tpu_torch.ops import atrous
    from eidola_tpu_torch.render import denoise as D

    level, n, e = 2, 24, 16
    pad = 2 << level
    img, view, sig = _atrous_case(60, 37, 5 + r0, cuda)
    want = D.atrous_level(img, view, level, *sig)[r0:r0 + n]
    rows = lambda x: torch.clamp(
        torch.arange(r0 - x, r0 + n + x, device=cuda), 0, 59)
    planes = atrous.View(*[a[rows(e)] for a in (view.pos, view.nrm,
                                                 view.mat_hash, view.valid)])
    got = atrous.run_level(img[rows(pad)], planes, level, *sig, e_img=pad,
                           e_view=e)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("levels,strided", [(4, False), (5, True)])
def test_atrous_denoise_launches_only_its_levels(cuda, levels, strided):
    """render/denoise.atrous_denoise on the card, the direct call's 4 levels
    on a full view and the indirect call's 5 on a strided one: the torch
    levels' result bit for bit, `levels` launches counted, no host sync
    (set_sync_debug_mode("error")) and no device kernel but the level
    kernels (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from eidola_tpu_torch.ops import atrous
    from eidola_tpu_torch.render import denoise as D

    img, view, sig = _atrous_case(90, 160, 11 + levels, cuda, strided)
    want = img
    for level in range(levels):
        want = D.atrous_level(want, view, level, *sig)
    D.atrous_denoise(img, view, levels, *sig)      # loads the kernel
    torch.cuda.synchronize()
    before = atrous.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = D.atrous_denoise(img, view, levels, *sig)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert atrous.LAUNCHES == before + levels
    dev_type = torch.autograd.DeviceType.CUDA
    kernels = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == dev_type
               and not e.name().startswith(("Memcpy", "Memset"))]
    assert len(kernels) == levels, kernels
    assert all("atrous_level_kernel" in k for k in kernels), kernels
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_default_frame_denoises_through_nine_level_launches(cuda,
                                                            monkeypatch):
    """A default cornell frame on the card adds 4 + 5 to
    ops/atrous.LAUNCHES, and equals, bit for bit, the same frame with the
    torch levels monkeypatched into its denoiser."""
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.ops import atrous
    from eidola_tpu_torch.render import denoise as D
    from eidola_tpu_torch.render import frame as RF
    from eidola_tpu_torch.render.config import RenderConfig

    scene, cam = load_scene("cornell", device=cuda)
    cfg = RenderConfig(width=96, height=64)
    before = atrous.LAUNCHES
    got = _frames(scene, cam, cfg, 1)
    assert atrous.LAUNCHES - before == 9 == (cfg.denoise_direct_levels
                                             + cfg.denoise_indirect_levels)

    def plain(img, view, levels, *sig):
        for level in range(levels):
            img = D.atrous_level(img, view, level, *sig)
        return img

    monkeypatch.setattr(RF, "atrous_denoise", plain)
    want = _frames(scene, cam, cfg, 1)
    assert atrous.LAUNCHES - before == 9
    a, b = list(_leaves(got)), list(_leaves(want))
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
