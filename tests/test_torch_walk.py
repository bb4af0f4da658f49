"""The port's one-kernel traversal (ops/bvh_walk.py) against the JAX
package's Pallas traversal kernel and the port's other traversal.

- `walk_ref(group=8)` against JAX `bvh_pallas._run` (interpret mode on
  the CPU) on the same BVH and rays: triangle slots equal on every ray;
  t within rtol 1e-5 and u, v within atol 1e-5 (barycentrics lie in
  [0, 1]).  Not bitwise: on a 500-triangle scene t differs by up to
  2.4e-6 (8.6e-7 relative) and u, v by up to 2.5e-6, from XLA's own
  evaluation of the interpreted kernel.
- `group=1` (the CUDA kernel's semantics) against `group=8`: hit for hit,
  except that at an exact-t tie either triangle may win; occlusion flags
  equal.
- The front doors `closest_hit_walk` / `any_hit_walk` against the port's
  default traversal (ops/bvh.py) and the brute-force oracle, on the
  scenes of tests/test_torch_bvh.py, at that file's bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eidola_tpu.ops.bvh import build_bvh as j_build_bvh
from eidola_tpu.ops.bvh_pallas import _run as j_run
from eidola_tpu.ops.intersect import brute_force_closest
from eidola_tpu_torch import interop
from eidola_tpu_torch.ops import bvh as tb
from eidola_tpu_torch.ops import bvh_instanced as TI
from eidola_tpu_torch.ops import bvh_walk as W
from eidola_tpu_torch.ops import packets as P
from test_torch_bvh import SCENES, _random_rays, _random_tris

torch.set_num_threads(2)

MAX_STEPS = 100_000


@pytest.fixture(scope="module")
def case():
    a, b, c = _random_tris(500, seed=4)
    o, d = _random_rays(1024, 5)
    jbvh = j_build_bvh(a, b, c)
    R = o.shape[0]
    tmin = np.full(R, 1e-4, np.float32)
    # a third of the rays end early, so the any-hit cases differ
    tmax = np.where(np.arange(R) % 3, 1e9, 2.5).astype(np.float32)
    return jbvh, interop.to_torch(jbvh, torch.device("cpu")), o, d, tmin, tmax


def _jax_run(jbvh, o, d, tmin, tmax, any_hit):
    ls = jbvh.leaf_size
    ncol = 128 if (ls * 12) % 128 == 0 else ls * 12 // 8
    rows = jbvh.leaf_blocks.reshape(-1, ls * 12 // ncol, ncol)
    out = j_run(jbvh.walk, rows, jnp.asarray(o), jnp.asarray(d),
                jnp.asarray(tmin), jnp.asarray(tmax), any_hit=any_hit,
                max_steps=MAX_STEPS, leaf_size=ls)
    return [np.asarray(x) for x in out]


def _port(tbvh, o, d, tmin, tmax, any_hit, group):
    R = o.shape[0]
    rays = W.pack_rays(*(torch.from_numpy(x) for x in (o, d, tmin, tmax)),
                       multiple=group * W.PACKET)
    out = W.walk_ref(tbvh.walk, tbvh.leaf_blocks, rays, any_hit, MAX_STEPS,
                     group=group)
    return [x.reshape(-1)[:R].numpy() for x in out]


@pytest.mark.parametrize("any_hit", [False, True])
def test_group8_matches_pallas_kernel(case, any_hit):
    jbvh, tbvh, o, d, tmin, tmax = case
    jt, js, ju, jv = _jax_run(jbvh, o, d, tmin, tmax, any_hit)
    pt, ps, pu, pv = _port(tbvh, o, d, tmin, tmax, any_hit, group=8)
    hit = js >= 0
    assert 50 < hit.sum() < hit.size
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(pt, jt, rtol=1e-5)
    np.testing.assert_allclose(pu, ju, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)


def test_group1_matches_group8(case):
    _, tbvh, o, d, tmin, tmax = case
    t8, s8, _, _ = _port(tbvh, o, d, tmin, tmax, False, group=8)
    t1, s1, _, _ = _port(tbvh, o, d, tmin, tmax, False, group=1)
    np.testing.assert_array_equal(s1 >= 0, s8 >= 0)
    assert (s1 != s8).mean() <= 0.01
    # the nearest t does not depend on the drain order: a different
    # winner is only allowed at an exact-t tie
    np.testing.assert_array_equal(t1, t8)
    _, a8, _, _ = _port(tbvh, o, d, tmin, tmax, True, group=8)
    _, a1, _, _ = _port(tbvh, o, d, tmin, tmax, True, group=1)
    np.testing.assert_array_equal(a1 >= 0, a8 >= 0)


def test_stats_count_steps_and_events(case):
    _, tbvh, o, d, tmin, tmax = case
    rays = W.pack_rays(*(torch.from_numpy(x) for x in (o, d, tmin, tmax)))
    stats = torch.zeros((rays.shape[1], 2), dtype=torch.int32)
    W.walk_closest(tbvh.walk, tbvh.leaf_blocks, rays, MAX_STEPS,
                   stats=stats)
    steps, events = stats[:, 0], stats[:, 1]
    assert (steps > 0).all() and (events > 0).all()
    # every drained event was pushed by a walk step
    assert (events <= steps).all()
    # a step cap stops the walk: fewer steps, and no more events than
    # were pushed
    capped = torch.zeros_like(stats)
    W.walk_closest(tbvh.walk, tbvh.leaf_blocks, rays, 5, stats=capped)
    assert (capped[:, 0] <= 5).all()
    assert (capped[:, 1] <= capped[:, 0]).all()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_front_doors_match_default_traversal_and_oracle(scene):
    (a, b, c), o, d = SCENES[scene]()
    tbvh = interop.to_torch(j_build_bvh(a, b, c), torch.device("cpu"))
    n = o.shape[0]
    tmin, tmax = np.full(n, 1e-4, np.float32), np.full(n, 1e9, np.float32)
    args = [torch.from_numpy(x) for x in (o, d, tmin, tmax)]
    wr = W.closest_hit_walk(tbvh, *args)
    xr = tb.closest_hit(tbvh, *args)
    ot, _, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(a), jnp.asarray(b - a),
        jnp.asarray(c - a), jnp.asarray(tmin), jnp.asarray(tmax))
    wtri, xtri, otri = wr.tri.numpy(), xr.tri.numpy(), np.asarray(ot)
    hits = xtri >= 0
    assert hits.sum() >= 10
    np.testing.assert_array_equal(wtri >= 0, hits)
    np.testing.assert_array_equal(otri >= 0, hits)
    assert (wtri[hits] == xtri[hits]).mean() >= 0.999
    assert (wtri[hits] == otri[hits]).mean() >= 0.99
    np.testing.assert_allclose(wr.t.numpy()[hits], xr.t.numpy()[hits],
                               rtol=1e-4)
    assert (wr.t.numpy()[~hits] == xr.t.numpy()[~hits]).all()

    short = torch.from_numpy(np.where(np.arange(n) % 2, 1e9, 3.0)
                             .astype(np.float32))
    occ_w = W.any_hit_walk(tbvh, args[0], args[1], args[2], short)
    occ_x = tb.any_hit(tbvh, args[0], args[1], args[2], short)
    assert 0 < int(occ_x.sum()) < n
    assert torch.equal(occ_w, occ_x)


def _small_instanced_bvh():
    """Two random meshes under three instances (rotated, scaled,
    translated), leaf 8."""
    rng = np.random.default_rng(11)
    meshes = [_random_tris(120, seed=12), _random_tris(80, seed=13)]
    instances = []
    for k, (mesh, scale) in enumerate([(0, 1.0), (1, 1.5), (0, 0.7)]):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * scale
        m[:3, 3] = [2.0 * k - 2.0, 0.0, 0.0]
        instances.append((mesh, m))
    return TI.build_instanced_bvh(meshes, instances,
                                  device=torch.device("cpu"), leaf_size=8)


@pytest.mark.parametrize("instanced,first", [
    (False, "xla"), (True, "xla"), (False, "auto"), (True, "auto")],
    ids=["flat", "instanced", "flat-auto", "instanced-auto"])
def test_trav_switch_routes_front_doors(case, monkeypatch, instanced, first):
    """EIDOLA_TRAV=pallas (packets.TRAV) sends the image doors through
    the walk kernel's wrapper, for a flat and for an instanced BVH (with
    its instance tables); "auto" (the default) on CPU rays and "xla" send
    them through the torch walk (ops/bvh, ops/bvh_instanced)."""
    monkeypatch.setattr(P, "TRAV", first)
    torch_walks = []
    for mod, name in ((tb, "closest_hit"), (TI, "closest_hit_instanced")):
        real_walk = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real_walk, **k: (
            torch_walks.append(real) or real(*a, **k)))
    tbvh = _small_instanced_bvh() if instanced else case[1]
    h, w = 16, 32
    rng = np.random.default_rng(3)
    o = torch.from_numpy(np.broadcast_to(np.float32([0.3, 0.2, 7.0]),
                                         (h, w, 3)).copy())
    tgt = torch.from_numpy(rng.uniform(-3, 3, (h, w, 3)).astype(np.float32))
    d = (tgt - o) / (tgt - o).norm(dim=-1, keepdim=True)
    tmin, tmax = torch.full((h, w), 1e-4), torch.full((h, w), 1e9)
    calls = []
    real = W.walk_closest
    monkeypatch.setattr(W, "walk_closest", lambda *a, **k: calls.append(
        k.get("inst") is not None) or real(*a, **k))
    default = P.closest_hit_img(tbvh, o, d, tmin, tmax)
    assert not calls and len(torch_walks) == 1
    monkeypatch.setattr(P, "TRAV", "pallas")
    rec = P.closest_hit_img(tbvh, o, d, tmin, tmax)
    assert calls == [instanced] and len(torch_walks) == 1
    assert (rec.tri >= 0).float().mean() > 0.05
    assert (rec.tri == default.tri).float().mean() >= 0.999
