"""The port's instancing (ops/bvh_instanced.py, the instanced drain of
ops/bvh.py, scene/data.upload_scene_instanced, the instanced get_state
and emitter pdf) against the JAX package's.

- `build_instanced_bvh`: every array bit for bit equal to JAX's, for two
  meshes under five instances (scaled, rotated, one mirrored), and for a
  subset build (the opaque half of a split).
- Instanced closest and any hit through the packets front door under
  the default traversal (the instanced torch walk) against JAX's
  instanced walk on the same BVH, and against the port's flat build of
  the same triangles baked to world space.
- The same queries through the walk kernel's plain version with its
  instanced drain (`walk_ref(inst=)`, where EIDOLA_TRAV=pallas sends an
  instanced BVH) against JAX's instanced walk and the port's
  `_traverse(inst=)`: triangle ids equal except at exact-t ties and the
  drains' edge verdicts (ROADMAP C: the torch walk tests through the
  coefficient table, the walk kernel with cross products), t within 1e-5
  relative and u, v within 1e-4 absolute on the rays whose ids agree
  (the bound this file already holds instanced u to; measured up to
  3.2e-5 against JAX, whose object-space rays XLA evaluates in another
  order, on instances translated by up to 5 units and scaled by 0.5-2);
  group=1 against group=8 hit for hit.
- `upload_scene_instanced`: every array of the scene bit for bit equal
  to JAX's (attribute pools, Instancing, lights, BVHs), for a scene with
  an emissive material and for a split scene (an instanced opaque half
  and a flat world-space alpha half); with the HitTest off, the split
  scene's two halves together give the hits of the unsplit scene.
- `get_state` and `light_pdf_for_bsdf_dir` on the same hit records in
  both packages; and, as tests/test_instanced_scene.py holds the JAX
  package, the instanced scene shades like the same geometry baked to a
  flat scene (a mirrored instance with a normal map included).

Tolerances: builds and uploads bitwise (the host arithmetic is the same
numpy in the same order).  Traversal as tests/test_torch_bvh.py: hit
masks equal, winners equal on >= 0.999 of hits, t within 1e-4 relative.
Shading on identical hit records within 1e-5 (f32 elementwise work in
another order); instanced vs flattened within 2e-3, the bound of
tests/test_instanced_scene.py (the flat scene's attributes are baked in
f32 on the host).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.ops.bvh_fused as JF
import eidola_tpu.ops.bvh_instanced as JI
import eidola_tpu.render.pathtrace as JP
import eidola_tpu.render.shade_state as JSS
import eidola_tpu.scene.data as JD
from eidola_tpu.render.config import RenderConfig as JConfig
from eidola_tpu.render.config import default_params as j_default_params
from eidola_tpu_torch import interop
from eidola_tpu_torch.ops import bvh as TB
from eidola_tpu_torch.ops import bvh_instanced as TI
from eidola_tpu_torch.ops import bvh_walk as TW
from eidola_tpu_torch.ops import packets as TPK
from eidola_tpu_torch.render import pathtrace as TP
from eidola_tpu_torch.render import shade_state as TSS
from eidola_tpu_torch.render import tracer as TT
from test_torch_foundations import host_builders_like_jax, same_host_builders
from eidola_tpu_torch.render.config import RenderConfig, default_params
from eidola_tpu_torch.scene import data as TD

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _tris(n, seed, spread=1.0, size=0.4):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, (n, 1, 3))
    tris = (base + r.uniform(-size, size, (n, 3, 3))).astype(np.float32)
    return tris[:, 0], tris[:, 1], tris[:, 2]


def _xform(seed, scale=1.0, mirror=False):
    """Random rotation x scale (+ translation) as a 4x4 object->world."""
    r = np.random.default_rng(seed)
    q, _ = np.linalg.qr(r.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    m = np.eye(4)
    m[:3, :3] = q * scale
    if mirror:
        m[:3, 0] *= -1.0
    m[:3, 3] = r.uniform(-5, 5, size=3)
    return m


MESHES = [_tris(150, 25), _tris(90, 26)]
INSTANCES = [(0, _xform(200)), (1, _xform(201)), (0, _xform(202, 2.0)),
             (1, _xform(203, 0.5, mirror=True)), (0, _xform(204))]


def _flatten(meshes, instances):
    parts = [[], [], []]
    for mi, m in instances:
        r, t = m[:3, :3], m[:3, 3]
        for k in range(3):
            parts[k].append((meshes[mi][k] @ r.T + t).astype(np.float32))
    return [np.concatenate(p) for p in parts]


def _assert_bits(port, ref, path):
    a, b = np.asarray(port), np.asarray(ref)
    assert a.shape == b.shape, path
    if b.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.astype(np.float32).view(np.int32),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=path)


def _compare_tree(port, ref, path=""):
    """Field by field, bit for bit; a JAX BVH without the coefficient
    table (the CPU build) is held against the JAX table builder.  JAX's
    `cull_boxes` (its opt-in alpha pre-cull's table) has no port
    counterpart and is left out."""
    if ref is None:
        assert port is None, path
        return
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        if "leaf_cmat" in ref._fields and ref.leaf_cmat is None:
            blocks = np.asarray(ref.leaf_blocks)
            cm, an = JF.build_leaf_tables_np(blocks, blocks.shape[1] // 12)
            ref = ref._replace(leaf_cmat=cm, leaf_anchor=an)
        for name in ref._fields:
            if name == "cull_boxes":
                continue
            _compare_tree(getattr(port, name), getattr(ref, name),
                          f"{path}.{name}")
        return
    if path.endswith("ground_irradiance"):   # see tests/test_torch_scene.py
        np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                                   rtol=1e-5, err_msg=path)
        return
    _assert_bits(port, ref, path)


@pytest.fixture(scope="module")
def built():
    j = JI.build_instanced_bvh(MESHES, INSTANCES, leaf_size=8)
    with host_builders_like_jax():
        t = TI.build_instanced_bvh(MESHES, INSTANCES, device=CPU,
                                   leaf_size=8)
    return j, t


def test_build_matches_jax_bitwise(built):
    j, t = built
    assert np.linalg.det(INSTANCES[3][1][:3, :3]) < 0
    assert int(t.n_tris) == 3 * 150 + 2 * 90
    _compare_tree(interop.to_numpy(t), j)


def test_subset_build_matches_jax_bitwise(monkeypatch):
    """The opaque half of a split: mesh-local subsets, ids in the full
    numbering."""
    same_host_builders(monkeypatch)
    ids = [np.arange(0, 150, 3, dtype=np.int32),
           np.arange(1, 90, 2, dtype=np.int32)]
    meshes = [tuple(v[i] for v in m) for m, i in zip(MESHES, ids)]
    kw = dict(mesh_prim_ids=ids, mesh_tris_full=[150, 90],
              inst_tri_base_override=np.asarray([0, 150, 240, 390, 480]),
              n_tris_virtual=630)
    j = JI.build_instanced_bvh(meshes, INSTANCES, leaf_size=8, **kw)
    t = TI.build_instanced_bvh(meshes, INSTANCES, device=CPU, leaf_size=8,
                               **kw)
    _compare_tree(interop.to_numpy(t), j)
    assert (t.slot_of_tri >= 0).sum() == 3 * 50 + 2 * 45


def _rays(n=640, seed=5):
    r = np.random.default_rng(seed)
    o = r.uniform(-9, 9, (n, 3)).astype(np.float32)
    tgt = r.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(np.arange(n) % 2, 1e9, 8.0).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), tmax


def test_instanced_hits_match_jax_and_flat(built, monkeypatch):
    same_host_builders(monkeypatch)
    j, t = built
    # the default traversal: the instanced torch walk of ops/bvh.py
    monkeypatch.setattr(TPK, "TRAV", "xla")
    monkeypatch.setattr(TW, "walk_ref", None)
    assert TPK._is_inst(t)
    o, d, tmin, tmax = _rays()
    targs = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    jr = JI.closest_hit_instanced(j, *[jnp.asarray(a) for a in
                                       (o, d, tmin, tmax)])
    tr = TPK.closest_hit(t, *targs)
    flat = TB.build_bvh(*_flatten(MESHES, INSTANCES), device=CPU,
                        leaf_size=8)
    fr = TB.closest_hit(flat, *targs)
    jtri, ttri, ftri = np.asarray(jr.tri), tr.tri.numpy(), fr.tri.numpy()
    hits = jtri >= 0
    assert 0.1 < hits.mean() < 0.95, "degenerate rays"
    for other, name in ((ttri, "port"), (ftri, "flat")):
        np.testing.assert_array_equal(other >= 0, hits, err_msg=name)
        assert (other[hits] == jtri[hits]).mean() >= 0.999, name
    np.testing.assert_allclose(tr.t.numpy()[hits], np.asarray(jr.t)[hits],
                               rtol=1e-4)
    np.testing.assert_allclose(fr.t.numpy()[hits], np.asarray(jr.t)[hits],
                               rtol=1e-4)
    same = hits & (ttri == jtri)
    np.testing.assert_allclose(tr.u.numpy()[same], np.asarray(jr.u)[same],
                               atol=1e-4)

    jo = np.asarray(JI.any_hit_instanced(j, *[jnp.asarray(a) for a in
                                              (o, d, tmin, tmax)]))
    to = TPK.any_hit(t, *targs).numpy()
    assert 0 < jo.sum() < jo.size
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(TB.any_hit(flat, *targs).numpy(), jo)


def _walk_planes(t, o, d, tmin, tmax, any_hit, group):
    rays = TW.pack_rays(*(torch.from_numpy(a) for a in (o, d, tmin, tmax)),
                        multiple=group * TW.PACKET)
    out = TW.walk_ref(t.walk, t.leaf_blocks, rays, any_hit, 100_000,
                      group=group,
                      inst=(t.leaf_mesh_row, t.leaf_inst, t.inst_inv))
    return [a.reshape(-1)[:o.shape[0]].numpy() for a in out]


def test_walk_ref_instanced_matches_jax_and_torch_walk(built, monkeypatch):
    """The walk kernel's instanced drain (plain version, reached through
    the front door under EIDOLA_TRAV=pallas) against JAX's instanced walk
    and the port's _traverse(inst=)."""
    j, t = built
    o, d, tmin, tmax = _rays()
    targs = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    jargs = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    calls = []
    real = TW.walk_ref
    monkeypatch.setattr(TW, "walk_ref", lambda *a, **k: calls.append(
        k.get("inst") is not None) or real(*a, **k))
    monkeypatch.setattr(TPK, "TRAV", "pallas")
    wr = TPK.closest_hit(t, *targs)
    wo = TPK.any_hit(t, *targs).numpy()
    assert calls == [True, True]
    jr = JI.closest_hit_instanced(j, *jargs)
    xr = TB._traverse(t, *targs, False, 100_000, inst=t.inst_index)[0]
    jtri, wtri = np.asarray(jr.tri), wr.tri.numpy()
    hits = jtri >= 0
    assert 0.1 < hits.mean() < 0.95, "degenerate rays"
    # every instance, the mirrored one included, supplies winners
    assert set(np.unique(t.inst_of_tri[torch.from_numpy(wtri[hits])]
                         .numpy())) == set(range(len(INSTANCES)))
    for name, ref in (("jax", jr), ("torch walk", xr)):
        rtri = np.asarray(ref.tri)
        np.testing.assert_array_equal(rtri >= 0, hits, err_msg=name)
        same = hits & (wtri == rtri)
        assert same.sum() >= 0.999 * hits.sum(), name
        np.testing.assert_allclose(wr.t.numpy()[same],
                                   np.asarray(ref.t)[same], rtol=1e-5,
                                   err_msg=name)
        for a, b in ((wr.u, ref.u), (wr.v, ref.v)):
            np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                       rtol=0, atol=1e-4, err_msg=name)
        assert (wr.t.numpy()[~hits] == np.asarray(ref.t)[~hits]).all()
    jo = np.asarray(JI.any_hit_instanced(j, *jargs))
    assert 0 < jo.sum() < jo.size
    np.testing.assert_array_equal(wo, jo)


def test_walk_ref_instanced_group1_matches_group8(built):
    _, t = built
    o, d, tmin, tmax = _rays(n=1024, seed=6)
    t8, s8, _, _ = _walk_planes(t, o, d, tmin, tmax, False, 8)
    t1, s1, _, _ = _walk_planes(t, o, d, tmin, tmax, False, 1)
    assert 0.1 < (s8 >= 0).mean() < 0.95
    np.testing.assert_array_equal(s1 >= 0, s8 >= 0)
    assert (s1 != s8).mean() <= 0.01
    # the nearest t does not depend on the drain order
    np.testing.assert_array_equal(t1, t8)
    _, a8, _, _ = _walk_planes(t, o, d, tmin, tmax, True, 8)
    _, a1, _, _ = _walk_planes(t, o, d, tmin, tmax, True, 1)
    np.testing.assert_array_equal(a1 >= 0, a8 >= 0)


def test_walk_wrapper_rejects_bad_instance_inputs(built):
    _, t = built
    o, d, tmin, tmax = _rays(n=128)
    rays = TW.pack_rays(*(torch.from_numpy(a) for a in (o, d, tmin, tmax)))
    with pytest.raises(ValueError):
        TW.walk_closest(t.walk, t.leaf_blocks, rays, 100,
                        inst=(t.leaf_mesh_row, t.leaf_inst[:-1], t.inst_inv))
    with pytest.raises(ValueError):
        TW.walk_closest(t.walk, t.leaf_blocks, rays, 100,
                        inst=(t.leaf_mesh_row, t.leaf_inst,
                              t.inst_inv[:, :9]))


def _mesh(n=60, seed=5):
    """Object-space mesh with full attributes; materials alternate 0/1."""
    r = np.random.default_rng(seed)
    v0, v1, v2 = _tris(n, seed, spread=1.0)
    gn = np.cross(v1 - v0, v2 - v0)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    normals = gn[:, None] + r.normal(size=(n, 3, 3)).astype(np.float32) * 0.1
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    uvs = r.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    t = np.cross(normals, [0.3, 0.9, 0.1])
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-20)
    tangents = np.concatenate([t, np.ones((n, 3, 1), np.float32)], -1)
    colors = r.uniform(0.2, 1, (n, 3, 4)).astype(np.float32)
    return dict(v0=v0, v1=v1, v2=v2, normals=normals.astype(np.float32),
                uvs=uvs, tangents=tangents.astype(np.float32),
                colors=colors, mat_ids=(np.arange(n) % 2).astype(np.int32))


def _normal_map():
    r = np.random.default_rng(9)
    nm = np.zeros((8, 8, 4), np.float32)
    v = r.normal(size=(8, 8, 3)).astype(np.float32) * 0.4
    v[..., 2] = 1.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    nm[..., :3] = v * 0.5 + 0.5
    nm[..., 3] = 1.0
    return nm


EMISSIVE = [
    {"base_color": [0.8, 0.6, 0.4, 1.0], "metallic": 0.2, "roughness": 0.6,
     "normal_tex": 0},
    {"base_color": [0.3, 0.5, 0.9, 1.0], "emissive": [3.0, 2.0, 1.0]},
]
SPLIT = [
    {"base_color": [0.8, 0.6, 0.4, 1.0]},
    {"base_color": [1, 1, 1, 0.0], "alpha_mode": TD.ALPHA_MASK,
     "alpha_cutoff": 0.5},
]
SCENE_INSTANCES = [(0, _xform(40)), (0, _xform(41, 1.7)),
                   (0, _xform(42, 0.6, mirror=True))]


def _uploads(materials):
    mesh = _mesh()
    tex = [_normal_map()]
    js = JD.upload_scene_instanced([mesh], SCENE_INSTANCES,
                                   materials=materials, textures=tex)
    ts = TD.upload_scene_instanced([mesh], SCENE_INSTANCES, device=CPU,
                                   materials=materials, textures=tex)
    return js, ts, mesh


@pytest.mark.parametrize("materials", [EMISSIVE, SPLIT],
                         ids=["emissive", "split-flat-alpha"])
def test_upload_scene_instanced_matches_jax(materials):
    js, ts, mesh = _uploads(materials)
    assert (ts.bvh_alpha is not None) == (materials is SPLIT)
    if materials is SPLIT:
        assert isinstance(ts.bvh, TI.InstancedBVH)
        assert isinstance(ts.bvh_alpha, TB.BVH)
    _compare_tree(interop.to_numpy(ts), js)


def _scene_rays(n=512, seed=50):
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    tgt = np.stack([m[:3, 3] for _, m in SCENE_INSTANCES])[
        np.arange(n) % 3] + r.uniform(-1, 1, (n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_split_halves_merge_to_unsplit_hits():
    """With the HitTest off, alpha geometry counts as opaque: the split
    scene's opaque instanced half and flat alpha half, merged by
    trace_closest / trace_occlusion, hit what the unsplit scene of the
    same geometry hits, in the same triangle numbering."""
    _, whole, _ = _uploads(EMISSIVE)
    _, split, _ = _uploads(SPLIT)
    assert whole.bvh_alpha is None and split.bvh_alpha is not None
    o, d = [torch.from_numpy(a) for a in _scene_rays(seed=52)]
    n = o.shape[0]
    tmin, tmax = torch.full((n,), 1e-4), torch.full((n,), 1e9)
    smax = torch.full((n,), 4.0)
    cfg = RenderConfig(width=8, height=8, alpha_geometry=False)
    rng = torch.zeros(n, dtype=torch.int64)
    _, rec = TT.trace_closest(cfg, split, o, d, tmin, tmax, rng)
    _, occ = TT.trace_occlusion(cfg, split, o, d, tmin, smax, rng)
    want = TI.closest_hit_instanced(whole.bvh, o, d, tmin, tmax)
    hit = want.tri >= 0
    assert hit.float().mean() > 0.3
    assert torch.equal(rec.tri >= 0, hit)
    # both halves supply winners
    assert bool((split.bvh.slot_of_tri[rec.tri[hit]] >= 0).any())
    assert bool((split.bvh_alpha.slot_of_tri[rec.tri[hit]] >= 0).any())
    assert (rec.tri[hit] == want.tri[hit]).float().mean() >= 0.999
    np.testing.assert_allclose(rec.t[hit].numpy(), want.t[hit].numpy(),
                               rtol=1e-4)
    want_occ = TI.any_hit_instanced(whole.bvh, o, d, tmin, smax)
    assert 0 < int(want_occ.sum()) < n
    assert torch.equal(occ, want_occ)


def test_get_state_and_light_pdf_match_jax():
    js, ts, _ = _uploads(EMISSIVE)
    o, d = _scene_rays()
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    rec = TB._traverse(ts.bvh, to, td, 1e-4, 1e9, False, 100_000,
                       inst=ts.bvh.inst_index)[0]
    hit = rec.tri >= 0
    assert hit.float().mean() > 0.3
    # mirrored instance and the emissive material both among the hits
    rows, inst = TD.shade_row(ts, rec.tri.clamp(min=0))
    assert (inst[hit] == 2).any() and (ts.tri_mat[rows][hit] == 1).any()
    cone = torch.full(rec.t.shape, 1e-3)
    st = TSS.get_state(ts, to, td, rec.tri, rec.t, rec.u, rec.v,
                       cone_angle=cone)
    jrec = [jnp.asarray(a.numpy()) for a in rec]
    jst = JSS.get_state(js, jnp.asarray(o), jnp.asarray(d), *jrec,
                        cone_angle=jnp.asarray(cone.numpy()))
    for name in st._fields:
        a, b = getattr(st, name).numpy(), np.asarray(getattr(jst, name))
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    cos = torch.abs((st.geo_nrm * td).sum(-1))
    tp = TP.light_pdf_for_bsdf_dir(RenderConfig(width=8, height=8), ts,
                                   default_params(device=CPU), td, rec.tri,
                                   rec.t, cos)
    jp = JP.light_pdf_for_bsdf_dir(JConfig(width=8, height=8), js,
                                   j_default_params(), jnp.asarray(d),
                                   jrec[0], jrec[1], jnp.asarray(cos.numpy()))
    assert (tp[hit] > 0).any()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-9)


def _bake(mesh, world):
    """One instance baked to world space as the round-2 loader did."""
    r, t = world[:3, :3], world[:3, 3]
    n = mesh["normals"] @ np.linalg.inv(r)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tx = mesh["tangents"][..., :3] @ r.T
    tx /= np.maximum(np.linalg.norm(tx, axis=-1, keepdims=True), 1e-20)
    return dict(v0=mesh["v0"] @ r.T + t, v1=mesh["v1"] @ r.T + t,
                v2=mesh["v2"] @ r.T + t, normals=n.astype(np.float32),
                uvs=mesh["uvs"], colors=mesh["colors"],
                mat_ids=mesh["mat_ids"],
                tangents=np.concatenate([tx, mesh["tangents"][..., 3:]],
                                        -1).astype(np.float32))


def test_instanced_shades_like_flattened():
    """tests/test_instanced_scene.py's parity on the port: state, light
    pmf and the mirrored instance's normal-mapped TBN."""
    mesh = _mesh()
    tex = [_normal_map()]
    inst = TD.upload_scene_instanced([mesh], SCENE_INSTANCES, device=CPU,
                                     materials=EMISSIVE, textures=tex)
    baked = [_bake(mesh, m) for _, m in SCENE_INSTANCES]
    flat = {k: np.concatenate([b[k] for b in baked]) for k in baked[0]}
    flat_scene = TD.upload_scene(
        flat["v0"].astype(np.float32), flat["v1"].astype(np.float32),
        flat["v2"].astype(np.float32), device=CPU, normals=flat["normals"],
        uvs=flat["uvs"], tangents=flat["tangents"], colors=flat["colors"],
        mat_ids=flat["mat_ids"], materials=EMISSIVE, textures=tex)
    o, d = [torch.from_numpy(a) for a in _scene_rays(seed=51)]

    def trace_shade(scene):
        rec = (TI.closest_hit_instanced if scene.inst is not None
               else TB.closest_hit)(scene.bvh, o, d, torch.full((512,), 1e-4),
                                    torch.full((512,), 1e9))
        return rec, TSS.get_state(scene, o, d, *rec)

    ri, si = trace_shade(inst)
    rf, sf = trace_shade(flat_scene)
    hit = rf.tri >= 0
    assert torch.equal(ri.tri >= 0, hit) and hit.float().mean() > 0.3
    same = hit & (ri.tri == rf.tri)
    assert same.sum() > 0.9 * hit.sum()
    assert (ri.tri[same] >= 2 * 60).any()        # the mirrored instance
    for name in ("pos", "nrm", "geo_nrm", "uv", "albedo", "emission",
                 "roughness"):
        np.testing.assert_allclose(getattr(si, name)[same].numpy(),
                                   getattr(sf, name)[same].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    pool_w = inst.tri_light_pmf.numpy()
    for k in range(3):
        got = pool_w * inst.inst.pmf_scale[k].item()
        want = flat_scene.tri_light_pmf[k * 60:(k + 1) * 60].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-9)
    assert inst.tri_mat.shape[0] * 3 == flat_scene.tri_mat.shape[0]
    assert inst.bvh.leaf_blocks.shape[0] < flat_scene.bvh.leaf_blocks.shape[0]
