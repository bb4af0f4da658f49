"""The last public names of the JAX package that the port takes over, held
against the JAX functions on the same numpy-seeded inputs, and the
per-device traversal switch.

- `ops/rng.rand2` / `rand3`: the state and the floats bit for bit.
- `native.oct_encode_native` / `oct_decode_native` (the port's own copy
  of the C++ codec): within JAX's own bound of the jnp codec (decoded
  dots > 0.9999) and its round trip (> 0.99999), never skipped; words
  and decodes bit for bit against the JAX package's native codec where
  that library loaded; None under EIDOLA_NO_NATIVE=1.
- `utils/transfer.batched_device_put` against `to_device` on real scenes'
  host trees (cornell, mini_grove, the hdr scene's EnvMap): equal dtypes,
  shapes and values, one blob per dtype and no copy on the CPU, every leaf
  at a 256-byte offset.
- `utils/profiler.Profiler` / `MilliTimer`: JAX's TestProfilerMonitor
  cases on CPU tensors, the 64-sample window, a disabled profiler.
- `ops/packets.resolve_trav`: "auto" is "xla" on the CPU and "pallas" on
  CUDA, explicit values stand, anything else raises.
- The headless app on cornell 32x32 on the CPU prints the JAX app's load
  line and Profiler rows and reports the traversal it took.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eidola_tpu.native as j_native
import eidola_tpu_torch.native as t_native
from eidola_tpu.ops import octahedral as j_oct
from eidola_tpu.ops import rng as j_rng
from eidola_tpu.utils.profiler import MilliTimer as JMilliTimer
from eidola_tpu.utils.profiler import Profiler as JProfiler
from eidola_tpu_torch.app import headless
from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.ops import packets as P
from eidola_tpu_torch.ops import rng as t_rng
from eidola_tpu_torch.scene import data as TD
from eidola_tpu_torch.scene import hdr as TH
from eidola_tpu_torch.utils import transfer as TT
from eidola_tpu_torch.utils.profiler import MilliTimer, Profiler

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ rng

@pytest.mark.parametrize("fn", ["rand2", "rand3"])
def test_rand_n_bit_exact(fn):
    s = np.random.default_rng(11).integers(0, 2**32, 4096, dtype=np.uint64
                                           ).astype(np.uint32)
    j = getattr(j_rng, fn)(jnp.asarray(s))
    p = getattr(t_rng, fn)(torch.from_numpy(s.astype(np.int64)))
    assert len(p) == len(j) == int(fn[-1]) + 1
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0], np.int64))
    for a, b in zip(p[1:], j[1:]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))


# ------------------------------------------------------ native oct codec

def test_oct_native_round_trip():
    """JAX's tests/test_native.py round trip, on the port's codec."""
    n = _unit(4096, 0)
    packed = t_native.oct_encode_native(n)
    assert packed.dtype == np.uint32 and packed.shape == (4096,)
    dec = t_native.oct_decode_native(packed)
    assert dec.shape == (4096, 3)
    assert ((dec * n).sum(-1)).min() > 0.99999


@pytest.mark.parametrize("shape", [(512,), (16, 32)])
def test_oct_native_matches_jnp_codec(shape):
    """Within JAX's own bound of its jnp codec; shapes round trip."""
    n = _unit(int(np.prod(shape)), 1).reshape(shape + (3,))
    native = t_native.oct_decode_native(t_native.oct_encode_native(n))
    assert native.shape == shape + (3,)
    ours = np.asarray(j_oct.decode_unit_u32(j_oct.encode_unit_u32(
        jnp.asarray(n, jnp.float32))))
    assert ((native * ours).sum(-1)).min() > 0.9999


def test_oct_native_bitwise_jax_native():
    if j_native.get_lib() is None:
        pytest.skip("the JAX package's native library did not load")
    n = _unit(4096, 2)
    n[:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0.6, 0, -0.8],
             [0, 0, 0]]
    words = t_native.oct_encode_native(n)
    np.testing.assert_array_equal(words, j_native.oct_encode_native(n))
    np.testing.assert_array_equal(
        t_native.oct_decode_native(words).view(np.int32),
        j_native.oct_decode_native(words).view(np.int32))


def test_oct_native_off(monkeypatch):
    monkeypatch.setenv("EIDOLA_NO_NATIVE", "1")
    assert t_native.oct_encode_native(_unit(8, 3)) is None
    assert t_native.oct_decode_native(np.zeros(8, np.uint32)) is None


# ---------------------------------------------------- batched upload

def _leaves(tree, path=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


def _same(a, b) -> bool:
    """Bitwise: the walk tables carry integer links bit-cast into f32."""
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return torch.equal(bits(a), bits(b))


def _host_tree(monkeypatch, load):
    """The host tree that the scene's loader hands to batched_device_put."""
    seen = []
    for mod in (TD, TH):
        real = mod.batched_device_put
        monkeypatch.setattr(mod, "batched_device_put", lambda t, d, real=real:
                            seen.append(t) or real(t, d))
    load()
    return seen[0]


def _check_batched(host):
    """batched_device_put on the CPU: to_device's leaves bit for bit, each
    at an ALIGN-byte offset in its dtype's one blob, and no copy counted
    (the leaves are views of the staging buffer)."""
    want = TT.to_device(host, CPU)
    before = TT.COPIES[0]
    got = TT.batched_device_put(host, CPU)
    copies = TT.COPIES[0] - before
    blobs = {}
    for (pw, w), (pg, g) in zip(_leaves(want), _leaves(got), strict=True):
        assert pw == pg
        if w is None:
            assert g is None, pw
            continue
        blobs.setdefault(g.dtype, set()).add(g.untyped_storage().data_ptr())
        assert g.dtype == w.dtype and g.shape == w.shape, pw
        assert _same(g, w), pw
        assert g.data_ptr() % TT.ALIGN == 0, pw
    assert copies == 0
    assert all(len(b) == 1 for b in blobs.values()), blobs
    return set(blobs)


@pytest.mark.parametrize("name", ["cornell", "mini_grove"])
def test_batched_device_put_matches_to_device(monkeypatch, name):
    host = _host_tree(monkeypatch, lambda: load_scene(name, device=CPU))
    assert isinstance(host.bvh.walk, np.ndarray)     # the BVH rides along
    dtypes = _check_batched(host)
    assert dtypes <= {torch.float32, torch.int64, torch.bool}


def test_batched_device_put_env_map(monkeypatch):
    img = np.random.default_rng(5).uniform(0, 4, (16, 32, 3))
    host = _host_tree(monkeypatch,
                      lambda: TH.build_env_map(img, device=CPU))
    assert isinstance(host, TD.EnvMap)
    _check_batched(host)


def test_batched_device_put_passes_tensors_and_none():
    """Tensors and None pass through; uint8 promotes to int64, f16 and
    f64 scalars to f32, bools stay bools, as to_device converts them."""
    t = torch.arange(5, dtype=torch.float32)
    tree = TD.EnvMap(image=np.arange(7, dtype=np.uint8).reshape(7, 1),
                     table=t, integral=np.array([True, False]),
                     average=TD.EnvMap(np.float16(1.5), None, np.float64(2.5),
                                       np.zeros((0, 3), np.int32)))
    got = TT.batched_device_put(tree, CPU)
    assert got.table is t and got.average.table is None
    for (pw, w), (_, g) in zip(_leaves(TT.to_device(tree, CPU)),
                               _leaves(got), strict=True):
        if w is not None:
            assert g.dtype == w.dtype and _same(g, w), pw
            assert g is t or g.data_ptr() % TT.ALIGN == 0, pw


# ------------------------------------------------------------ profiler

def test_profiler_scopes_like_jax():
    """JAX's TestProfilerMonitor.test_profiler_scopes on CPU tensors, and
    the same summary layout as JAX's."""
    prof, jprof = Profiler(enabled=True), JProfiler(enabled=True)
    with prof.scope("work", block_on={"x": torch.ones(8, 8)}):
        x = torch.ones((8, 8)).sum()
    out = prof.timeit("jit", lambda a: (a * 2, [a]), x)
    assert float(out[0]) == 128.0
    with jprof.scope("work"):
        jnp.ones((8, 8)).sum()
    s, js = prof.summary(), jprof.summary()
    assert "work" in s and "jit" in s
    assert s.splitlines()[0] == js.splitlines()[0]
    row = re.compile(r"^(\S+) +(\d+\.\d\d) +(\d+) +(\d+\.\d\d)$")
    assert [row.match(r).group(1, 3) for r in s.splitlines()[1:]] == [
        ("work", "1"), ("jit", "1")]
    assert len(s.splitlines()[1]) == len(js.splitlines()[1])


def test_profiler_window_and_disabled():
    prof = Profiler(enabled=True)
    for i in range(70):
        with prof.scope("s"):
            pass
        prof.scopes["s"].samples[-1] = float(i) / 1e3
    s = prof.scopes["s"]
    assert s.count == 70 and len(s.samples) == 64
    assert s.avg_ms == pytest.approx(np.mean(np.arange(6, 70)))
    off = Profiler(enabled=False)
    with off.scope("s"):
        pass
    assert off.timeit("t", lambda: 3) == 3 and off.scopes == {}


def test_milli_timer_like_jax(capsys):
    t, jt = MilliTimer("load "), JMilliTimer("load ")
    dt, jdt = t.print("scene+BVH"), jt.print("scene+BVH")
    lines = capsys.readouterr().out.splitlines()
    assert dt >= 0.0 and jdt >= 0.0 and t.ms() >= dt
    assert [re.sub(r"\d+\.\d", "X", ln) for ln in lines] == [
        "load scene+BVH: X ms"] * 2


# ------------------------------------------------------- traversal switch

@pytest.mark.parametrize("trav,cpu,cuda", [
    ("auto", "xla", "pallas"), ("xla", "xla", "xla"),
    ("pallas", "pallas", "pallas")])
def test_resolve_trav(monkeypatch, trav, cpu, cuda):
    monkeypatch.setattr(P, "TRAV", trav)
    assert P.resolve_trav(torch.device("cpu")) == cpu
    assert P.resolve_trav(torch.device("cuda")) == cuda
    assert P.resolve_trav("cuda:0") == cuda


def test_resolve_trav_unknown_raises(monkeypatch):
    monkeypatch.setattr(P, "TRAV", "fast")
    with pytest.raises(ValueError, match="EIDOLA_TRAV"):
        P.resolve_trav(CPU)
    o = torch.zeros(128, 3)
    with pytest.raises(ValueError):
        P.closest_hit(None, o, o, 0.0, 1.0)


# --------------------------------------------------------- headless app

def test_headless_readout(monkeypatch, capsys):
    monkeypatch.setattr(P, "TRAV", "auto")
    res = headless.run(["--scene", "cornell", "--size", "32", "32",
                        "--frames", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^load scene\+BVH: \d+\.\d ms$", out, re.M)
    rows = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(Compile\+first|Render) +\d+\.\d\d +(\d+) +\d+\.\d\d$", out,
        re.M)}
    assert rows == {"Compile+first": 1, "Render": 2}
    assert res["trav"] == "xla" and res["profiler"] in out
    assert res["load_s"] > 0 and len(res["frame_ms"]) == 3


@pytest.mark.parametrize("key", ["cornell", "alpha"])
def test_frames_bitwise_under_either_upload(monkeypatch, key):
    """The golden config's frames (64x64, depth 2, 4 frames) from a scene
    uploaded by batched_device_put and by to_device: bit for bit."""
    from eidola_tpu_torch.render.config import (RenderConfig,
                                                default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    def frames():
        scene, cam = load_scene(key, device=CPU)
        cfg = RenderConfig(width=64, height=64, max_depth=2,
                           traversal_max_steps=1024,
                           alpha_geometry=headless.alpha_geometry(scene))
        params, tm = default_params(device=CPU), default_tonemap(device=CPU)
        state, step = init_frame_state(cfg, cam), make_step(cfg)
        for _ in range(4):
            state, out = step(scene, cam, params, tm, state)
        return out["hdr"]

    monkeypatch.setattr(P, "TRAV", "auto")
    batched = frames()
    monkeypatch.setattr(TD, "batched_device_put", TT.to_device)
    assert _same(batched, frames())
