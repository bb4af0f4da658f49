"""The port's foundation modules against the JAX package, on identical
inputs made with numpy from a seed.

Bit-exact: RNG words, octahedral codes, offset_ray bits, G-buffer words,
tile reordering, halo gathers, alias draws.  Within 1e-5 (f32 elementwise
work; transcendentals and reductions may round differently in XLA and
torch): math, tonemap, reservoirs, BSDF, sun & sky, camera rays,
get_state, light sampling, compose and post (whose dither words are
bit-exact through the RNG).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eidola_tpu.models.scenes import cornell_box, stress_grid
from eidola_tpu.ops import alias_table as j_alias
from eidola_tpu.ops import halo as j_halo
from eidola_tpu.ops import math as j_math
from eidola_tpu.ops import octahedral as j_oct
from eidola_tpu.ops import packets as j_packets
from eidola_tpu.ops import reservoir as j_resv
from eidola_tpu.ops import rng as j_rng
from eidola_tpu.ops import tonemap as j_tm
from eidola_tpu.render import bsdf as j_bsdf
from eidola_tpu.render import compose as j_compose
from eidola_tpu.render import config as j_cfg
from eidola_tpu.render import gbuffer as j_gbuf
from eidola_tpu.render import pathtrace as j_pt
from eidola_tpu.render import post as j_post
from eidola_tpu.render import shade_state as j_ss
from eidola_tpu.scene import camera as j_cam
from eidola_tpu.scene import sunsky as j_sky
from eidola_tpu_torch import interop
from eidola_tpu_torch.ops import alias_table as t_alias
from eidola_tpu_torch.ops import halo as t_halo
from eidola_tpu_torch.ops import math as t_math
from eidola_tpu_torch.ops import octahedral as t_oct
from eidola_tpu_torch.ops import packets as t_packets
from eidola_tpu_torch.ops import reservoir as t_resv
from eidola_tpu_torch.ops import rng as t_rng
from eidola_tpu_torch.ops import tonemap as t_tm
from eidola_tpu_torch.render import bsdf as t_bsdf
from eidola_tpu_torch.render import compose as t_compose
from eidola_tpu_torch.render import config as t_cfg
from eidola_tpu_torch.render import gbuffer as t_gbuf
from eidola_tpu_torch.render import pathtrace as t_pt
from eidola_tpu_torch.render import post as t_post
from eidola_tpu_torch.render import shade_state as t_ss
from eidola_tpu_torch.scene import sunsky as t_sky
from eidola_tpu_torch.scene.camera import spawn_rays

torch.set_num_threads(2)
CPU = torch.device("cpu")
RNG = np.random.default_rng(1234)


def T(a):
    """numpy -> torch the way interop converts (uint words -> int64)."""
    return interop.to_torch(np.asarray(a), CPU)


def J(a):
    return np.asarray(a)


def P(a):
    return a.numpy()


def close(p, j, rtol=1e-5, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(P(p), J(j), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def exact(p, j):
    np.testing.assert_array_equal(P(p).astype(np.int64),
                                  J(j).astype(np.int64))


def u32(*shape):
    return RNG.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def unit(*shape):
    v = RNG.normal(size=shape + (3,)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def uni(*shape, lo=0.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


# ------------------------------------------------------------------ rng

@pytest.mark.parametrize("fn", ["pcg", "pcg_advance", "rand", "_to_float01"])
def test_rng_words_bit_exact(fn):
    s = u32(4096)
    j = getattr(j_rng, fn)(jnp.asarray(s))
    p = getattr(t_rng, fn)(T(s))
    for a, b in zip(p if isinstance(p, tuple) else (p,),
                    j if isinstance(j, tuple) else (j,)):
        if a.dtype == torch.float32:
            np.testing.assert_array_equal(P(a).view(np.int32),
                                          J(b).view(np.int32))
        else:
            exact(a, b)


@pytest.mark.parametrize("k", [2, 3])
def test_pcg_nd_bit_exact(k):
    v = u32(1024, k)
    fn = "pcg2d" if k == 2 else "pcg3d"
    exact(getattr(t_rng, fn)(T(v)), getattr(j_rng, fn)(jnp.asarray(v)))


def test_tea_and_seed_pixels_bit_exact():
    a, b = u32(2048), u32(2048)
    exact(t_rng.tea(T(a), T(b)), j_rng.tea(jnp.asarray(a), jnp.asarray(b)))
    for word in (0, 7, 0xFFFFFFFF, 0x8F1BBCDC):
        exact(t_rng.seed_pixels(24, 40, word, device=CPU),
              j_rng.seed_pixels(24, 40, jnp.uint32(word)))


# ----------------------------------------------------------- octahedral

def test_octahedral_codes_bit_exact():
    n = unit(4096)
    n[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
             [0, -1, 0], [0.6, 0, -0.8], [0, -0.6, -0.8]]
    code_j = j_oct.encode_unit_u32(jnp.asarray(n))
    exact(t_oct.encode_unit_u32(T(n)), code_j)
    np.testing.assert_array_equal(t_oct.encode_unit_u32_np(n),
                                  j_oct.encode_unit_u32_np(n))
    close(t_oct.decode_unit_u32(T(J(code_j))), j_oct.decode_unit_u32(code_j),
          atol=1e-6)


def test_unorm_and_albedo_words_bit_exact():
    v = uni(2048, 4, lo=-0.2, hi=1.2)
    exact(t_oct.pack_unorm4x8(T(v)), j_oct.pack_unorm4x8(jnp.asarray(v)))
    h = u32(2048)
    exact(t_oct.pack_albedo_hash(T(v[:, :3]), T(h)),
          j_oct.pack_albedo_hash(jnp.asarray(v[:, :3]), jnp.asarray(h)))
    words = u32(2048)
    close(t_oct.unpack_unorm4x8(T(words)),
          j_oct.unpack_unorm4x8(jnp.asarray(words)), atol=0)
    pa, ph = t_oct.unpack_albedo_hash(T(words))
    ja, jh = j_oct.unpack_albedo_hash(jnp.asarray(words))
    close(pa, ja, atol=0)
    exact(ph, jh)


# ----------------------------------------------------------------- math

def test_offset_ray_bits_exact():
    p = RNG.normal(0, 1, (4096, 3)).astype(np.float32)
    p[:512] *= 0.01                                   # below origin_thresh
    n = unit(4096)
    a = t_math.offset_ray(T(p), T(n))
    b = j_math.offset_ray(jnp.asarray(p), jnp.asarray(n))
    np.testing.assert_array_equal(P(a).view(np.int32), J(b).view(np.int32))


def test_math_helpers_match():
    n = unit(2048)
    tp, bp = t_math.make_frame(T(n))
    tj, bj = j_math.make_frame(jnp.asarray(n))
    close(tp, tj)
    close(bp, bj)
    f, g = uni(2048, hi=3.0), uni(2048, hi=3.0)
    close(t_math.power_heuristic(T(f), T(g)),
          j_math.power_heuristic(jnp.asarray(f), jnp.asarray(g)))
    c = uni(2048, 3, hi=50.0)
    close(t_math.hdr_to_ldr(T(c)), j_math.hdr_to_ldr(jnp.asarray(c)))
    ldr = uni(2048, 3, hi=0.999)
    close(t_math.ldr_to_hdr(T(ldr)), j_math.ldr_to_hdr(jnp.asarray(ldr)),
          rtol=1e-5, atol=1e-4)
    close(t_math.clamp_radiance(T(c), 20.0),
          j_math.clamp_radiance(jnp.asarray(c), 20.0))
    u1, u2 = uni(2048), uni(2048)
    close(t_math.cosine_sample_hemisphere(T(u1), T(u2)),
          j_math.cosine_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2)))
    mid = RNG.integers(-1, 50, 2048).astype(np.int32)
    exact(t_math.hash8bit(T(mid)), j_math.hash8bit(jnp.asarray(mid)))


# -------------------------------------------------------------- tonemap

@pytest.mark.parametrize("kind", [0, 1, 2])
def test_tonemap_matches(kind):
    c = uni(4096, 3, hi=20.0)
    close(t_tm.apply_tonemap(T(c), kind), j_tm.apply_tonemap(jnp.asarray(c),
                                                            kind))
    close(t_tm.srgb_to_linear(T(c / 20)), j_tm.srgb_to_linear(jnp.asarray(
        c / 20)))


# ------------------------------------------------------------ reservoir

def _resv(n, seed):
    r = np.random.default_rng(seed)
    return {
        "sample": {"li": r.uniform(0, 5, (n, 3)).astype(np.float32),
                   "dist": r.uniform(0, 9, n).astype(np.float32)},
        "num": r.integers(0, 90, n).astype(np.float32),
        "weight": np.where(r.random(n) < 0.05, np.nan,
                           r.uniform(0, 3, n)).astype(np.float32),
    }


def test_reservoir_algebra_matches():
    a, b = _resv(2048, 1), _resv(2048, 2)
    cand = _resv(2048, 3)["sample"]
    w = np.where(RNG.random(2048) < 0.1, -1.0, uni(2048, hi=4.0)).astype(
        np.float32)
    u, en = uni(2048), RNG.random(2048) < 0.7
    tj = lambda d: {k: (tj(v) if isinstance(v, dict) else jnp.asarray(v))
                    for k, v in d.items()}
    tt = lambda d: interop.to_torch(d, CPU)

    def same(p, j):
        for k in ("num", "weight"):
            close(p[k], j[k])
        for k in p["sample"]:
            close(p["sample"][k], j["sample"][k])

    same(t_resv.resv_check(tt(a)), j_resv.resv_check(tj(a)))
    ca, cb = t_resv.resv_check(tt(a)), j_resv.resv_check(tj(a))
    same(t_resv.resv_update(ca, tt(cand), T(w), T(u)),
         j_resv.resv_update(cb, tj(cand), jnp.asarray(w), jnp.asarray(u)))
    same(t_resv.resv_merge_same_target(ca, tt(b), T(u), T(en)),
         j_resv.resv_merge_same_target(cb, tj(b), jnp.asarray(u),
                                       jnp.asarray(en)))
    same(t_resv.resv_clamp(ca, torch.tensor(40.0)),
         j_resv.resv_clamp(cb, jnp.float32(40.0)))
    ph = uni(2048, hi=2.0)
    close(t_resv.resv_big_w(ca, T(ph)), j_resv.resv_big_w(cb, jnp.asarray(ph)))


# --------------------------------------------------------------- alias

def test_alias_table_and_draws_match():
    w = RNG.exponential(1.0, 300)
    w[::7] = 0.0
    tj, total_j = j_alias.make_alias_table(w)
    tp, total_p = t_alias.make_alias_table(w)
    assert total_j == total_p
    for a, b in zip(tp, tj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        t_alias.build_alias_table_np(w)[0], j_alias.build_alias_table_np(w)[0])
    u1, u2 = uni(8192), uni(8192)
    ip, pp = t_alias.sample_alias(interop.to_torch(tp, CPU), T(u1), T(u2))
    ij, pj = j_alias.sample_alias(j_alias.AliasTable(*map(jnp.asarray, tj)),
                                  jnp.asarray(u1), jnp.asarray(u2))
    exact(ip, ij)
    close(pp, pj, rtol=0, atol=0)


# ------------------------------------------------------------------ bsdf

def _bsdf_inputs(n=4096):
    albedo = uni(n, 3)
    met, rough = uni(n), uni(n, lo=0.02, hi=1.0)
    wo, wi = unit(n), unit(n)
    wo[..., 2] = np.abs(wo[..., 2])
    return albedo, met, rough, wo, wi


def test_bsdf_eval_pdf_sample_match():
    albedo, met, rough, wo, wi = _bsdf_inputs()
    pj = j_bsdf.BsdfParams(jnp.asarray(albedo), jnp.asarray(met),
                           jnp.asarray(rough))
    pt = t_bsdf.BsdfParams(T(albedo), T(met), T(rough))
    close(t_bsdf.eval_bsdf(pt, T(wo), T(wi)),
          j_bsdf.eval_bsdf(pj, jnp.asarray(wo), jnp.asarray(wi)),
          rtol=1e-4, atol=1e-5)
    close(t_bsdf.pdf_bsdf(pt, T(wo), T(wi)),
          j_bsdf.pdf_bsdf(pj, jnp.asarray(wo), jnp.asarray(wi)),
          rtol=1e-4, atol=1e-5)
    u = [uni(4096) for _ in range(3)]
    sp = t_bsdf.sample_bsdf(pt, T(wo), *map(T, u))
    sj = j_bsdf.sample_bsdf(pj, jnp.asarray(wo), *map(jnp.asarray, u))
    close(sp[0], sj[0], atol=1e-4)


# ------------------------------------------------------------- sun & sky

@pytest.fixture(scope="module")
def sky_scene():
    scene, cam = stress_grid(n=2)
    return scene, cam, interop.to_torch(scene, CPU)


def test_sky_radiance_and_sun_sampling_match(sky_scene):
    js, _, ts = sky_scene
    d = unit(4096)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], np.asarray(
        js.sunsky.sun_direction) / np.linalg.norm(js.sunsky.sun_direction)]
    a = t_sky.sky_radiance(ts.sunsky, T(d))
    b = j_sky.sky_radiance(js.sunsky, jnp.asarray(d))
    close(a, b, rtol=2e-5, atol=1e-5)
    u1, u2 = uni(2048), uni(2048)
    for x, y in zip(t_sky.sample_sun(ts.sunsky, T(u1), T(u2)),
                    j_sky.sample_sun(js.sunsky, jnp.asarray(u1),
                                     jnp.asarray(u2))):
        close(x, y, rtol=1e-5, atol=1e-5)
    exact(t_sky.sun_pdf(ts.sunsky, T(d)) > 0, j_sky.sun_pdf(js.sunsky,
                                                            jnp.asarray(d)) > 0)


def test_ground_irradiance_matches(sky_scene):
    js, _, _ = sky_scene
    mine = t_sky.finalize_sunsky(t_sky.SunSkyParams(*map(np.asarray,
                                                         js.sunsky)))
    np.testing.assert_allclose(mine.ground_irradiance,
                               np.asarray(js.sunsky.ground_irradiance),
                               rtol=1e-5)


# ---------------------------------------------------------------- camera

def test_spawn_rays_match():
    _, cam = cornell_box()
    seeds = u32(24, 40)
    sp, op, dp = spawn_rays(interop.to_torch(cam, CPU), 24, 40, T(seeds))
    sj, oj, dj = j_cam.spawn_rays(cam, 24, 40, jnp.asarray(seeds))
    exact(sp, sj)
    close(op, oj, rtol=0, atol=0)
    close(dp, dj, atol=1e-6)


# ----------------------------------------------------- shading + gbuffer

@pytest.fixture(scope="module")
def cornell():
    scene, cam = cornell_box()
    return scene, cam, interop.to_torch(scene, CPU)


def _hits(n_tris, n=2048):
    tri = RNG.integers(-1, n_tris, n).astype(np.int32)
    u, v = uni(n, hi=0.6), uni(n, hi=0.4)
    t = uni(n, lo=0.5, hi=4.0)
    o = RNG.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) + [0, 1, 3]
    return o.astype(np.float32), unit(n), tri, t, u, v


def test_get_state_matches(cornell):
    js, _, ts = cornell
    o, d, tri, t, u, v = _hits(int(js.bvh.n_tris))
    sp = t_ss.get_state(ts, *map(T, (o, d, tri, t, u, v)), cone_angle=0.01)
    sj = j_ss.get_state(js, *map(jnp.asarray, (o, d, tri, t, u, v)),
                        cone_angle=0.01)
    for name, a, b in zip(sp._fields, sp, sj):
        if a.dtype in (torch.bool, torch.int64):
            exact(a, b)
        else:
            close(a, b, err_msg=name)


def test_pack_gbuffer_words_bit_exact(cornell):
    js, _, ts = cornell
    o, d, tri, t, u, v = _hits(int(js.bvh.n_tris))
    sj = j_ss.get_state(js, *map(jnp.asarray, (o, d, tri, t, u, v)))
    # identical f32 state on both sides: the JAX state through interop
    sp = interop.to_torch(sj, CPU)
    gp = t_gbuf.pack_gbuffer(sp, T(t), T(tri))
    gj = j_gbuf.pack_gbuffer(sj, jnp.asarray(t), jnp.asarray(tri))
    for name, a, b in zip(gp._fields, gp, gj):
        if name == "depth":
            close(a, b, rtol=0, atol=0)
        else:
            exact(a, b)


def test_decode_gbuffer_and_center_rays_match(cornell):
    js, cam, _ = cornell
    tcam = interop.to_torch(cam, CPU)
    close(t_gbuf.center_rays(tcam, 16, 32), j_gbuf.center_rays(cam, 16, 32),
          atol=1e-6)
    o, d, tri, t, u, v = _hits(int(js.bvh.n_tris), n=512)
    sj = j_ss.get_state(js, *map(jnp.asarray, (o, d, tri, t, u, v)))
    gj = j_gbuf.pack_gbuffer(sj, jnp.asarray(t), jnp.asarray(tri))
    gj = j_gbuf.GBuffer(*[a.reshape(16, 32) for a in gj])
    rays = j_gbuf.center_rays(cam, 16, 32)
    vj = j_gbuf.decode_gbuffer(gj, cam.pos, rays)
    vp = t_gbuf.decode_gbuffer(interop.to_torch(gj, CPU), tcam.pos,
                               T(J(rays)))
    for a, b in zip(vp, vj):
        close(a.to(torch.float32), jnp.asarray(b, jnp.float32), atol=1e-6)


# --------------------------------------------------------- light sampling

@pytest.mark.parametrize("which", ["cornell", "stress"])
def test_sample_direct_light_matches(which, cornell, sky_scene):
    js, _, ts = cornell if which == "cornell" else sky_scene
    cfg = j_cfg.RenderConfig()
    params = j_cfg.default_params()
    pos = RNG.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32) + [0, 1, 0]
    seeds = u32(2048)
    sp, lp = t_pt.sample_direct_light(t_cfg.RenderConfig(), ts,
                                      interop.to_torch(params, CPU), T(pos),
                                      T(seeds))
    sj, lj = j_pt.sample_direct_light(cfg, js, params, jnp.asarray(pos),
                                      jnp.asarray(seeds))
    exact(sp, sj)
    for name, a, b in zip(lp._fields, lp, lj):
        if a.dtype == torch.bool:
            exact(a, b)
        else:
            close(a, b, rtol=1e-5, atol=1e-5)
    d = unit(1024)
    close(t_pt.env_radiance(t_cfg.RenderConfig(), ts, None, T(d)),
          j_pt.env_radiance(cfg, js, params, jnp.asarray(d)), rtol=2e-5)


# ---------------------------------------------------- compose + post

def test_compose_matches(cornell):
    js, cam, _ = cornell
    h, w = 16, 32
    direct = uni(h, w, 3, hi=0.95)
    emission = uni(h, w, 3, hi=2.0)
    o, d, tri, t, u, v = _hits(int(js.bvh.n_tris), n=h * w)
    sj = j_ss.get_state(js, *map(jnp.asarray, (o, d, tri, t, u, v)))
    gj = j_gbuf.pack_gbuffer(sj, jnp.asarray(t), jnp.asarray(tri))
    gj = j_gbuf.GBuffer(*[a.reshape(h, w) for a in gj])
    vj = j_gbuf.decode_gbuffer(gj, cam.pos, j_gbuf.center_rays(cam, h, w))
    vp = interop.to_torch(vj, CPU)
    indirect = uni(h // 2, w // 2, 3, hi=0.9)
    for ind in (None, indirect):
        close(t_compose.compose(T(direct), None if ind is None else T(ind),
                                T(emission), vp),
              j_compose.compose(jnp.asarray(direct),
                                None if ind is None else jnp.asarray(ind),
                                jnp.asarray(emission), vj), rtol=1e-5)


@pytest.mark.parametrize("auto", [0, 1, 3])
def test_post_process_matches(auto):
    img = (RNG.exponential(0.6, (24, 40, 3))).astype(np.float32)
    tm = j_cfg.default_tonemap()._replace(auto_exposure=jnp.asarray(
        auto, jnp.int32), vignette=jnp.float32(0.3))
    for word in (0, 123456789):
        a = t_post.post_process(T(img), interop.to_torch(tm, CPU),
                                frame_word=word)
        b = j_post.post_process(jnp.asarray(img), tm, frame_word=word)
        close(a, b, rtol=1e-5, atol=2e-5)


# ----------------------------------------------------- tiles and halos

def test_tiles_and_halo_gather_exact():
    a = RNG.normal(size=(32, 48, 3)).astype(np.float32)
    pt = t_packets.to_tiles(T(a), 32, 48)
    exact(pt.view(torch.int32), J(j_packets.to_tiles(jnp.asarray(a), 32, 48)
                                  ).view(np.int32))
    assert torch.equal(t_packets.from_tiles(pt, 32, 48), T(a))
    ry = RNG.integers(0, 32, (32, 48)).astype(np.int32)
    rx = RNG.integers(0, 48, (32, 48)).astype(np.int32)
    gp, mp = t_halo.halo_gather(T(a), T(ry), T(rx), 6)
    gj, mj = j_halo.halo_gather(jnp.asarray(a), jnp.asarray(ry),
                                jnp.asarray(rx), 6)
    close(gp, gj, rtol=0, atol=0)
    exact(mp, mj)
