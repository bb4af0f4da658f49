"""The port's GI-frame modules against the JAX package's, at small sizes.

Inputs are made with numpy from seeds (or are the JAX package's own scene
arrays, carried over by `eidola_tpu_torch.interop`) and go through both.
Tolerances:
- integer work is bitwise: sort keys, the deep-tile lane pick, RNG words;
- f32 elementwise work (a-trous denoise, the HDR environment functions,
  the light pdf of a BSDF direction) within 1e-5 (relative where the
  values reach radiances of ~100);
- traversal-fed estimators (sorted doors, NEE, trace_radiance): the port
  drains with the coefficient-table formulation and the JAX CPU oracle
  with the unrolled `cols` one, so hit distances differ in the last bits
  and a shadow verdict or closest winner may flip at an exact comparison:
  >= 99.9% of hits equal, and contributions within rtol 1e-4 on >= 99% of
  lanes (>= 98% after two bounces), with equal RNG words.
The whole slice is held against the JAX package through the stored
golden frames (tests/test_torch_golden.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.ops.packets as JP
from eidola_tpu.models.scenes import cornell_box, hdr_env_demo
from eidola_tpu.ops.bvh import build_bvh as j_build_bvh
from eidola_tpu.ops.packets import closest_hit_img as j_closest_hit_img
from eidola_tpu.render import config as jcfg
from eidola_tpu.render import indirect as JI
from eidola_tpu.render.denoise import atrous_denoise as j_atrous
from eidola_tpu.render.gbuffer import GBufferView as JView
from eidola_tpu.render.gbuffer import center_rays as j_center_rays
from eidola_tpu.render.pathtrace import \
    light_pdf_for_bsdf_dir as j_light_pdf
from eidola_tpu.render.shade_state import get_state as j_get_state
from eidola_tpu.render.tracer import nee_contribution as j_nee
from eidola_tpu.render.tracer import trace_radiance as j_trace_radiance
from eidola_tpu.scene import hdr as JH
from eidola_tpu_torch import interop
from eidola_tpu_torch.ops import packets as P
from eidola_tpu_torch.render import indirect as TI
from eidola_tpu_torch.render.config import RenderConfig
from eidola_tpu_torch.render.denoise import atrous_denoise
from eidola_tpu_torch.render.pathtrace import light_pdf_for_bsdf_dir
from eidola_tpu_torch.render.tracer import nee_contribution, trace_radiance
from eidola_tpu_torch.scene import hdr as TH
from test_torch_bvh import _random_rays, _random_tris
from test_torch_foundations import same_host_builders

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _t(x):
    return interop.to_torch(x, CPU)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def rand_bvh():
    a, b, c = _random_tris(500, seed=4)
    jbvh = j_build_bvh(a, b, c)
    return jbvh, _t(jbvh)


def _rays(n, seed):
    o, d = _random_rays(n, seed)
    dead = np.random.default_rng(seed).random(n) < 0.2
    return o, d, dead


@pytest.mark.parametrize("key", ["o21d3", "d3o21", "o15d6"])
def test_ray_sort_keys_bitwise(rand_bvh, key, monkeypatch):
    jbvh, tbvh = rand_bvh
    o, d, dead = _rays(2048, 12)
    monkeypatch.setattr(JP, "_KEY", key)
    monkeypatch.setattr(P, "KEY", key)
    jk = np.asarray(JP.ray_sort_keys(jbvh, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(dead))).astype(np.int64)
    tk = P.ray_sort_keys(tbvh, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(dead)).numpy()
    assert len(np.unique(jk)) > 100
    np.testing.assert_array_equal(tk, jk)


def test_make_ray_order_is_a_stable_sort(rand_bvh):
    _, tbvh = rand_bvh
    o, d, dead = (torch.from_numpy(x) for x in _rays(1024, 13))
    perm, inv = P.make_ray_order(tbvh, o, d, dead)
    keys = P.ray_sort_keys(tbvh, o, d, dead)
    assert (keys[perm][1:] >= keys[perm][:-1]).all()
    assert torch.equal(perm[inv], torch.arange(1024))
    assert dead[perm][-int(dead.sum()):].all()     # dead rays sort last


def test_sorted_doors_match_jax(rand_bvh):
    jbvh, tbvh = rand_bvh
    o, d, _ = _rays(1024, 14)
    o, d = o.reshape(32, 32, 3), d.reshape(32, 32, 3)
    tmin = np.full((32, 32), 1e-4, np.float32)
    tmax = np.where(np.arange(1024).reshape(32, 32) % 3, 1e9, 2.5
                    ).astype(np.float32)
    tmax[:2] = -1.0                                  # dead rays
    jargs = [jnp.asarray(x) for x in (o, d, tmin, tmax)]
    targs = [torch.from_numpy(x) for x in (o, d, tmin, tmax)]
    jr = JP.closest_hit_sorted(jbvh, *jargs)
    tr = P.closest_hit_sorted(tbvh, *targs)
    jtri, ttri = np.asarray(jr.tri), tr.tri.numpy()
    assert ttri.shape == (32, 32)
    hits = jtri >= 0
    assert 50 < hits.sum() < hits.size
    np.testing.assert_array_equal(ttri >= 0, hits)
    assert (ttri[hits] == jtri[hits]).mean() >= 0.999
    np.testing.assert_allclose(tr.t.numpy()[hits], np.asarray(jr.t)[hits],
                               rtol=1e-4)
    jo = np.asarray(JP.any_hit_sorted(jbvh, *jargs))
    to = P.any_hit_sorted(tbvh, *targs).numpy()
    assert 0 < jo.sum() < jo.size
    np.testing.assert_array_equal(to, jo)
    # the same hits through the walk kernel's traversal
    P.TRAV = "pallas"
    try:
        wr = P.closest_hit_sorted(tbvh, *targs)
    finally:
        P.TRAV = "xla"
    assert (wr.tri.numpy() == ttri).mean() >= 0.999


@pytest.mark.parametrize("h2,w2,word", [(16, 16, 7), (27, 45, 123456789),
                                        (540, 960, 4000000000)])
def test_long_tile_lanes_equal(h2, w2, word):
    jc = jcfg.RenderConfig(width=2 * w2, height=2 * h2)
    jflat, jinv = JI._long_tile_lanes(jc, jnp.uint32(word), h2, w2)
    tflat, tinv = TI._long_tile_lanes(RenderConfig(width=2 * w2,
                                                   height=2 * h2),
                                      torch.tensor(word), h2, w2)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    assert tinv == jinv


def _random_view(h, w, seed):
    r = np.random.default_rng(seed)
    nrm = r.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    f = lambda *s: r.random(s).astype(np.float32)
    return dict(valid=r.random((h, w)) < 0.9, depth=1 + 4 * f(h, w),
                pos=4 * f(h, w, 3), nrm=nrm, albedo=f(h, w, 3),
                mat_hash=r.integers(0, 3, (h, w)).astype(np.int32),
                metallic=f(h, w), roughness=f(h, w), ior=1 + f(h, w),
                transmission=f(h, w))


@pytest.mark.parametrize("h,w,levels", [(32, 32, 4), (16, 24, 5)])
def test_atrous_denoise_matches(h, w, levels):
    v = _random_view(h, w, seed=h + w)
    img = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    sig = [np.float32(x) for x in (4.0, 128.0, 2.0)]
    j = np.asarray(j_atrous(jnp.asarray(img),
                            JView(**{k: jnp.asarray(x) for k, x in v.items()}),
                            levels, *sig))
    t = atrous_denoise(torch.from_numpy(img), _t(JView(**v)), levels,
                       *(torch.tensor(s) for s in sig)).numpy()
    assert np.abs(j - img).mean() > 1e-3               # it did filter
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hdr_scene():
    scene, cam = hdr_env_demo()
    return scene, cam, _t(scene)


def test_build_env_map_matches(hdr_scene, monkeypatch):
    same_host_builders(monkeypatch)
    scene, _, tscene = hdr_scene
    img = np.asarray(scene.env.image)
    env = TH.build_env_map(img, device=CPU)
    for k in ("alias", "q", "pdf", "alias_pdf"):
        np.testing.assert_array_equal(_np(getattr(env.table, k)),
                                      np.asarray(getattr(scene.env.table, k)))
    np.testing.assert_allclose(float(env.integral), float(scene.env.integral),
                               rtol=1e-6)


def test_env_functions_match(hdr_scene):
    scene, _, tscene = hdr_scene
    r = np.random.default_rng(21)
    d = r.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = [r.random(4096).astype(np.float32) for _ in range(4)]
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    np.testing.assert_allclose(TH.env_eval(tscene.env, td, 1.5).numpy(),
                               np.asarray(JH.env_eval(scene.env, jd, 1.5)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TH.env_pdf(tscene.env, td).numpy(),
                               np.asarray(JH.env_pdf(scene.env, jd)),
                               rtol=1e-5)
    jw, jp, jl = JH.env_sample(scene.env, *map(jnp.asarray, u))
    tw, tp, tl = TH.env_sample(tscene.env, *map(torch.from_numpy, u))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


@pytest.fixture(scope="module")
def cornell():
    scene, cam = cornell_box()
    return scene, cam, _t(scene)


@pytest.mark.parametrize("which", ["cornell", "hdr"])
def test_light_pdf_for_bsdf_dir_matches(which, cornell, hdr_scene):
    scene, _, tscene = cornell if which == "cornell" else hdr_scene
    env_mode = "hdr" if which == "hdr" else "sunsky"
    r = np.random.default_rng(5)
    n = 2048
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    T = int(scene.bvh.n_tris)
    tri = r.integers(-1, T, n).astype(np.int32)
    emissive = np.nonzero(np.asarray(scene.tri_light_pmf) > 0)[0]
    if emissive.size:                   # half the hits on the lights
        tri[::2] = r.choice(emissive, n // 2)
    tri[1::4] = -1                      # a quarter escaped to the env
    dist = (0.1 + 3 * r.random(n)).astype(np.float32)
    cos = r.uniform(-1, 1, n).astype(np.float32)
    jp = np.asarray(j_light_pdf(jcfg.RenderConfig(env_mode=env_mode), scene,
                                jcfg.default_params(), jnp.asarray(d),
                                jnp.asarray(tri), jnp.asarray(dist),
                                jnp.asarray(cos)))
    tp = light_pdf_for_bsdf_dir(
        RenderConfig(env_mode=env_mode), tscene, _t(jcfg.default_params()),
        torch.from_numpy(d), torch.from_numpy(tri).long(),
        torch.from_numpy(dist), torch.from_numpy(cos)).numpy()
    assert (jp > 0).mean() > 0.1
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-12)


FIELD = 16
CFG = dict(width=FIELD, height=FIELD, max_depth=2, traversal_max_steps=1024)


@pytest.fixture(scope="module")
def surfaces(cornell):
    """A 16x16 field of cornell primary-hit surfaces (JAX State) plus
    per-lane RNG words."""
    scene, cam, tscene = cornell
    d = j_center_rays(cam, FIELD, FIELD)
    o = jnp.broadcast_to(cam.pos, d.shape)
    n = (FIELD, FIELD)
    rec = j_closest_hit_img(scene.bvh, o, d, jnp.full(n, 1e-4),
                            jnp.full(n, 1e8))
    state = j_get_state(scene, o, d, rec.tri, rec.t, rec.u, rec.v)
    rng = np.random.default_rng(8).integers(0, 2**32, n, dtype=np.uint32)
    return state, -d, rng


def _close_share(a, b, rtol=1e-4, atol=1e-5):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0] * ok.shape[1], -1).all(-1).mean()


def test_nee_contribution_matches(cornell, surfaces):
    scene, _, tscene = cornell
    state, wo, rng = surfaces
    jrng, jc = j_nee(jcfg.RenderConfig(**CFG), scene, jcfg.default_params(),
                     state, wo, jnp.asarray(rng))
    trng, tc = nee_contribution(RenderConfig(**CFG), tscene,
                                _t(jcfg.default_params()), _t(state), _t(wo),
                                torch.from_numpy(rng.astype(np.int64)))
    np.testing.assert_array_equal(trng.numpy(), np.asarray(jrng))
    jc, tc = np.asarray(jc), tc.numpy()
    assert (jc.sum(-1) > 0).mean() > 0.3
    assert _close_share(tc, jc) >= 0.99


def test_trace_radiance_matches(cornell, surfaces):
    """Two bounces from the surfaces, with the first-vertex record, the
    depth-1 snapshot and lanes killed after it (the tiled multi-bounce
    options of indirect_stage)."""
    scene, _, tscene = cornell
    state, wo, rng = surfaces
    kill = np.random.default_rng(9).random((FIELD, FIELD)) < 0.5
    jrng, jl, jv, jsnap = j_trace_radiance(
        jcfg.RenderConfig(**CFG), scene, jcfg.default_params(), None, None,
        jnp.asarray(rng), num_bounces=2, collect_first_vertex=True,
        start_state=state, start_wo=wo, snapshot_after_depth=1,
        kill_after_snapshot=jnp.asarray(kill))
    trng, tl, tv, tsnap = trace_radiance(
        RenderConfig(**CFG), tscene, _t(jcfg.default_params()), None, None,
        torch.from_numpy(rng.astype(np.int64)), num_bounces=2,
        collect_first_vertex=True, start_state=_t(state), start_wo=_t(wo),
        snapshot_after_depth=1, kill_after_snapshot=torch.from_numpy(kill))
    np.testing.assert_array_equal(trng.numpy(), np.asarray(jrng))
    jl, tl = np.asarray(jl), tl.numpy()
    assert (jl.sum(-1) > 0).mean() > 0.3
    assert _close_share(tsnap.numpy(), np.asarray(jsnap)) >= 0.99
    assert _close_share(tl, jl) >= 0.98
    assert (tv.valid.numpy() == np.asarray(jv.valid)).mean() >= 0.99
    assert np.asarray(jv.valid).mean() > 0.3
    assert _close_share(tv.xs.numpy(), np.asarray(jv.xs)) >= 0.99
    assert _close_share(tv.ns.numpy(), np.asarray(jv.ns)) >= 0.99


DEBUG = {"direct": 1, "indirect": 2, "base_color": 3, "normal": 4,
         "depth": 5, "metallic": 6, "emissive": 7, "roughness": 8,
         "texcoord": 9}


@pytest.mark.parametrize("mode", sorted(DEBUG))
def test_debug_channels(mode):
    """Each debug channel replaces the displayed HDR image with its
    buffer, as frame.py:_debug_image in the JAX package."""
    from eidola_tpu_torch.models.scenes import load_scene
    from eidola_tpu_torch.ops.math import ldr_to_hdr
    from eidola_tpu_torch.render.config import (default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    scene, cam = load_scene("cornell", device=CPU)
    cfg = RenderConfig(width=16, height=16, max_depth=2,
                       traversal_max_steps=1024, debug_mode=DEBUG[mode])
    state, out = make_step(cfg)(scene, cam, default_params(device=CPU),
                                default_tonemap(device=CPU),
                                init_frame_state(cfg, cam))
    img = out["hdr"]
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    if mode == "direct":
        assert torch.equal(img, ldr_to_hdr(out["direct_ldr"]))
    elif mode == "indirect":
        up = out["indirect_ldr"].repeat_interleave(2, 0).repeat_interleave(
            2, 1)
        assert torch.equal(img, ldr_to_hdr(up))
    elif mode in ("depth", "metallic", "roughness"):
        assert torch.equal(img[..., 0], img[..., 2])
        assert img.min() >= 0.0 and img.max() <= 1.0
    elif mode in ("normal", "base_color"):
        assert img.min() >= 0.0 and img.max() <= 1.0
        assert img.std() > 0.01
    elif mode == "emissive":
        assert img.max() > 1.0          # the ceiling light
    else:
        assert (img[..., 2] == 0).all()
