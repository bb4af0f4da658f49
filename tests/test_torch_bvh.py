"""The port's packet traversal against the JAX package's.

On the random scenes of tests/test_bvh.py and tests/test_bvh_fused.py,
the same BVH (built by the JAX package, carried over by interop) and the
same rays go through JAX `closest_hit` / `any_hit` (the exact-f32 cols
drain on CPU) and the port's, whose drains are the coefficient-table
kernels' plain versions.  Hit for hit, except exact-t ties: at least
0.999 of winners equal and t within rtol 1e-4, the bounds
tests/test_bvh_fused.py holds the fused drain to.  Both are also held
against `intersect.brute_force_closest`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eidola_tpu.ops.bvh import any_hit as j_any_hit
from eidola_tpu.ops.bvh import build_bvh as j_build_bvh
from eidola_tpu.ops.bvh import closest_hit as j_closest_hit
from eidola_tpu.ops.intersect import brute_force_closest
from eidola_tpu_torch import interop
from eidola_tpu_torch.ops import bvh as tb
from eidola_tpu_torch.ops.packets import (any_hit_img, closest_hit_img,
                                          from_tiles, to_tiles)
from test_torch_foundations import same_host_builders

torch.set_num_threads(2)


def _random_tris(n, seed=0, spread=4.0, size=0.5):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, size=(n, 1, 3))
    offs = r.uniform(-size, size, size=(n, 3, 3))
    tris = (base + offs).astype(np.float32)
    return tris[:, 0], tris[:, 1], tris[:, 2]


def _random_rays(n, seed=1, spread=6.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aimed(ntris, nrays, seed, spread=0.8, size=0.5):
    """The test_bvh_fused.py scenes: rays aimed into a dense cluster."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (ntris, 3)).astype(np.float32)
    v = [c + rng.normal(0, size, (ntris, 3)).astype(np.float32)
         for _ in range(3)]
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-4, 4, (nrays, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (nrays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return v, o, d


SCENES = {
    "random_500": lambda: (_random_tris(500, seed=4), *_random_rays(512, 5)),
    "random_200": lambda: (_random_tris(200, seed=7), *_random_rays(256, 8)),
    "aimed_40": lambda: _aimed(40, 256, seed=11),
    "aimed_60": lambda: _aimed(60, 256, seed=31),
}


def _both(scene):
    (a, b, c), o, d = SCENES[scene]()
    bvh = j_build_bvh(a, b, c)
    return (a, b, c), o, d, bvh, interop.to_torch(bvh, torch.device("cpu"))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_closest_hit_matches_jax_and_oracle(scene):
    (a, b, c), o, d, jbvh, tbvh = _both(scene)
    n = o.shape[0]
    tmin, tmax = np.full(n, 1e-4, np.float32), np.full(n, 1e9, np.float32)
    jr = j_closest_hit(jbvh, jnp.asarray(o), jnp.asarray(d), tmin, tmax)
    tr = tb.closest_hit(tbvh, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(tmin), torch.from_numpy(tmax))
    jt, jtri = np.asarray(jr.t), np.asarray(jr.tri)
    tt, ttri = tr.t.numpy(), tr.tri.numpy()
    ot, _, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(a), jnp.asarray(b - a),
        jnp.asarray(c - a), jnp.asarray(tmin), jnp.asarray(tmax))
    otri = np.asarray(ot)
    hits = jtri >= 0
    assert hits.sum() >= 10, "degenerate scene: almost no hits"
    np.testing.assert_array_equal(ttri >= 0, hits)
    np.testing.assert_array_equal(otri >= 0, hits)
    assert (ttri[hits] == jtri[hits]).mean() >= 0.999
    np.testing.assert_allclose(tt[hits], jt[hits], rtol=1e-4)
    same = hits & (ttri == jtri)
    np.testing.assert_allclose(tr.u.numpy()[same], np.asarray(jr.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(tr.v.numpy()[same], np.asarray(jr.v)[same],
                               atol=1e-4)
    assert (ttri[hits] == otri[hits]).mean() >= 0.99


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_any_hit_matches_jax(scene):
    _, o, d, jbvh, tbvh = _both(scene)
    n = o.shape[0]
    # shadow-ray style bounds: half the rays end before most geometry
    tmax = np.where(np.arange(n) % 2, 1e9, 3.0).astype(np.float32)
    tmin = np.full(n, 1e-4, np.float32)
    jo = np.asarray(j_any_hit(jbvh, jnp.asarray(o), jnp.asarray(d), tmin,
                              tmax))
    to = tb.any_hit(tbvh, torch.from_numpy(o), torch.from_numpy(d),
                    torch.from_numpy(tmin), torch.from_numpy(tmax)).numpy()
    assert 0 < jo.sum() < n
    np.testing.assert_array_equal(to, jo)


def test_image_front_doors_match_flat_traversal():
    """closest_hit_img / any_hit_img = the flat traversal on tile order."""
    (a, b, c), _, _, _, tbvh = _both("aimed_40")
    h, w = 16, 32
    rng = np.random.default_rng(3)
    o = torch.from_numpy(np.broadcast_to(np.float32([0.3, 0.2, 4.0]),
                                         (h, w, 3)).copy())
    tgt = torch.from_numpy(rng.uniform(-1, 1, (h, w, 3)).astype(np.float32))
    d = tgt - o
    d = d / d.norm(dim=-1, keepdim=True)
    tmin, tmax = torch.full((h, w), 1e-4), torch.full((h, w), 1e9)
    rec = closest_hit_img(tbvh, o, d, tmin, tmax)
    flat = tb.closest_hit(tbvh, to_tiles(o, h, w), to_tiles(d, h, w),
                          to_tiles(tmin, h, w), to_tiles(tmax, h, w))
    assert torch.equal(rec.tri, from_tiles(flat.tri, h, w))
    assert (rec.tri >= 0).float().mean() > 0.1
    occ = any_hit_img(tbvh, o, d, tmin, tmax)
    assert torch.equal(occ, rec.tri >= 0)


def test_port_build_equals_jax_build(monkeypatch):
    same_host_builders(monkeypatch)
    (a, b, c), _, _, jbvh, tbvh = _both("random_500")
    own = tb.build_bvh(a, b, c, device="cpu")
    for k in tb.BVH._fields:
        x, y = getattr(own, k), getattr(tbvh, k)
        if x.dtype == torch.float32:         # walk links are NaN-bit ints
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k
