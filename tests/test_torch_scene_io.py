"""The port's scene pipeline against the JAX package's: the PNG codec, the
Radiance .hdr codec, env_params and the glTF loader.

- `utils/png.py` (the port's stand-in for PIL): its own files round-trip;
  it decodes what PIL writes in every colour type it supports (grey,
  grey+alpha, RGB, RGBA, palette at 1-8 bits, 1-bit, tRNS colour keys,
  16-bit grey) and files written here with each of the five row filters
  at 8 and 16 bits, to the same RGBA pixels as PIL's
  `Image.open(...).convert("RGBA")`: equal, byte for byte.
- `load_hdr` equals the JAX package's, bitwise, on a flat file, on a
  file this test encodes with new-style RLE scanlines (runs and
  literals), and on a PNG; `write_hdr` writes the same bytes.
- `env_params` gives the same firefly clamp as JAX's (f32, bitwise).
- `load_gltf_scene` gives the same SceneData and camera as the JAX
  loader, every array bitwise (integers and floats alike; the sky's
  ground irradiance within 1e-5 relative, as in tests/test_torch_scene.py)
  on: the GLB of tests/test_gltf.py's `make_test_glb` (flattened,
  textured, an emissive triangle, a spot light, a camera node), its
  data-URI .gltf case, a .gltf with an external .bin and an external PNG
  holding strided, sparse and normalized accessors, a TRS node, COLOR_0,
  TANGENT, point and directional lights, samplers, ior and transmission
  (no camera: the bounds fit), and an instanced GLB with alpha-MASK
  foliage written by `models/scenes.write_standin_glb`.
- The env map and glTF comparisons give the port the host builder the
  JAX side took (`same_host_builders`), and hold again with the JAX
  package's native library forced off (the `*_native_off` cases), as
  when its g++ build races another test worker.
"""
import base64
import importlib.util
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import eidola_tpu.render.config as JC
import eidola_tpu.scene.data as JD
import eidola_tpu.scene.gltf as JG
import eidola_tpu.scene.hdr as JH
from eidola_tpu_torch import interop
from eidola_tpu_torch.models import scenes as TS
from eidola_tpu_torch.render import config as TC
from eidola_tpu_torch.scene import data as TD
from eidola_tpu_torch.scene import gltf as TG
from eidola_tpu_torch.scene import hdr as TH
from eidola_tpu_torch.utils.png import decode_png, encode_png

from test_torch_foundations import jax_native_off, same_host_builders
from test_torch_scene import _compare, _with_table

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))


def _pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _noise(shape, seed=0):
    """Random bytes with a flat band, so the filters see runs and edges."""
    a = (np.random.default_rng(seed).random(shape) * 256).astype(np.uint8)
    a[: shape[0] // 2] //= 37
    return a


# ---- PNG -----------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip(channels):
    img = _noise((37, 53, channels), seed=channels)
    data = encode_png(img)
    back = decode_png(data)
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()
    np.testing.assert_array_equal(_pil_rgba(data), back)


_SRC = Image.fromarray(_noise((19, 23, 3), seed=5))
PIL_CASES = {
    "L": lambda: _pil_png(_SRC.convert("L")),
    "LA": lambda: _pil_png(Image.fromarray(_noise((19, 23, 2), 6), "LA")),
    "RGB": lambda: _pil_png(_SRC),
    "RGBA": lambda: _pil_png(Image.fromarray(_noise((19, 23, 4), 7),
                                             "RGBA")),
    "P2": lambda: _pil_png(_SRC.convert("P", palette=Image.ADAPTIVE,
                                        colors=2)),
    "P16_trns": lambda: _pil_png(_SRC.convert("P", palette=Image.ADAPTIVE,
                                              colors=16), transparency=3),
    "P256_trns": lambda: _pil_png(_SRC.convert("P", palette=Image.ADAPTIVE,
                                               colors=200), transparency=9),
    "1bit": lambda: _pil_png(_SRC.convert("1")),
    "L_trns": lambda: _pil_png(_SRC.convert("L"), transparency=11),
    "RGB_trns": lambda: _pil_png(_SRC, transparency=tuple(
        int(x) for x in np.asarray(_SRC)[18, 0])),
    "I16": lambda: _pil_png(Image.fromarray(
        (np.arange(19 * 23).reshape(19, 23) * 97).astype(np.uint16))),
}


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_png_decodes_what_pil_writes(case):
    data = PIL_CASES[case]()
    np.testing.assert_array_equal(decode_png(data), _pil_rgba(data))


def _filtered(raw: np.ndarray, bpp: int, ftype: int) -> bytes:
    """Rows of `raw` (h, stride) uint8 filtered with one filter type, by
    the PNG specification's formulas (a = left, b = up, c = up-left)."""
    h, stride = raw.shape
    r = raw.astype(np.int64)
    out = []
    for y in range(h):
        prev = r[y - 1] if y else np.zeros(stride, np.int64)
        row = []
        for i in range(stride):
            a = r[y, i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pred = [0, a, b, (a + b) // 2,
                    a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c)
                    else (b if abs(p - b) <= abs(p - c) else c)][ftype]
            row.append((r[y, i] - pred) & 0xFF)
        out.append(bytes([ftype] + row))
    return b"".join(out)


def _png_file(w, h, depth, ctype, rows: bytes, interlace=0) -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype,depth", [(0, 8), (4, 8), (2, 8), (6, 8),
                                         (2, 16), (6, 16)])
def test_png_filters_match_pil(ftype, ctype, depth):
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    w, h = 11, 9
    bpp = ch * depth // 8
    raw = _noise((h, w * bpp), seed=ftype * 10 + ctype)
    data = _png_file(w, h, depth, ctype, _filtered(raw, bpp, ftype))
    np.testing.assert_array_equal(decode_png(data), _pil_rgba(data))


def test_png_interlaced_and_bad_input_raise():
    raw = _noise((4, 12), seed=1)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_png_file(4, 4, 8, 2, _filtered(raw, 3, 0), interlace=1))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.float32))


# ---- .hdr ----------------------------------------------------------------

def _rle_hdr(path, rgbe: np.ndarray) -> None:
    """A Radiance file with new-style RLE scanlines: each component coded
    apart, runs of >= 3 equal bytes as (128 + n, value), the rest as
    literal blocks of up to 128."""
    H, W = rgbe.shape[:2]
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {H} +X {W}\n".encode()]
    for y in range(H):
        line = bytearray([2, 2, W >> 8, W & 0xFF])
        for c in range(4):
            v = rgbe[y, :, c].tolist()
            x = 0
            lit = []
            while x < W:
                run = 1
                while x + run < W and v[x + run] == v[x] and run < 127:
                    run += 1
                if run >= 3:
                    if lit:
                        line += bytes([len(lit)] + lit)
                        lit = []
                    line += bytes([128 + run, v[x]])
                    x += run
                else:
                    lit.append(v[x])
                    x += 1
                    if len(lit) == 128:
                        line += bytes([128] + lit)
                        lit = []
            if lit:
                line += bytes([len(lit)] + lit)
        out.append(bytes(line))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _hdr_image(seed=0, shape=(12, 40, 3)):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) ** 3 * 40).astype(np.float32)
    img[:4] = 0.5                  # runs
    img[5, 3:30] = [100.0, 3.0, 0.0]
    img[7] = 0.0                   # exponent 0
    return img


def test_hdr_flat_matches_jax(tmp_path):
    img = _hdr_image()
    pj, pt = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    JH.write_hdr(pj, img)
    TH.write_hdr(pt, img)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    got, want = TH.load_hdr(pj), JH.load_hdr(pj)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_hdr_rle_matches_jax(tmp_path):
    img = _hdr_image(seed=1)
    flat = str(tmp_path / "flat.hdr")
    TH.write_hdr(flat, img)
    with open(flat, "rb") as f:
        rgbe = np.frombuffer(f.read()[-img.shape[0] * img.shape[1] * 4:],
                             np.uint8).reshape(img.shape[0], img.shape[1], 4)
    rle = str(tmp_path / "rle.hdr")
    _rle_hdr(rle, rgbe)
    assert os.path.getsize(rle) < os.path.getsize(flat)   # really coded
    got, want = TH.load_hdr(rle), JH.load_hdr(rle)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TH.load_hdr(flat))


def test_hdr_png_fallback_matches_jax(tmp_path):
    p = str(tmp_path / "env.png")
    Image.fromarray(_noise((6, 10, 4), seed=3), "RGBA").save(p)
    np.testing.assert_array_equal(TH.load_hdr(p), JH.load_hdr(p))
    bad = str(tmp_path / "env.exr")
    with open(bad, "wb") as f:
        f.write(b"v/1\x01")
    with pytest.raises(ValueError, match="env.exr"):
        TH.load_hdr(bad)


def test_env_params_matches_jax(monkeypatch):
    same_host_builders(monkeypatch)
    _check_env_params()


def test_env_params_matches_jax_native_off(monkeypatch):
    """The JAX side's alias table on its numpy builder: the port's
    follows it, and the clamp stays bitwise."""
    jax_native_off(monkeypatch)
    same_host_builders(monkeypatch)
    _check_env_params()


def _check_env_params():
    img = _hdr_image(seed=2)
    jp = JD.env_params(JC.default_params(), JH.build_env_map(img))
    tp = TD.env_params(TC.default_params(device="cpu"),
                       TH.build_env_map(img, device="cpu"))
    assert tp.firefly_clamp.dtype == torch.float32
    assert np.asarray(tp.firefly_clamp).view(np.int32) == \
        np.asarray(jp.firefly_clamp).view(np.int32)


# ---- glTF ----------------------------------------------------------------

def _make_test_glb():
    spec = importlib.util.spec_from_file_location(
        "gltf_cases", os.path.join(TESTS, "test_gltf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_test_glb


def _data_uri_gltf(path):
    """tests/test_gltf.py's .gltf with a base64 buffer and a scaled node."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    raw = pos.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "scale": [2, 2, 2]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "buffers": [{
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(raw).decode(),
            "byteLength": len(raw),
        }],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(raw)}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": 3, "type": "VEC3"}],
    }
    with open(path, "w") as f:
        json.dump(gltf, f)


def _feature_gltf(path):
    """A .gltf whose buffer is an external .bin and whose texture is an
    external PNG: a box with interleaved (strided) POSITION+NORMAL, a
    sparse accessor moving two vertices, normalized u8 TEXCOORD_0 and
    u16 COLOR_0 (vec3), TANGENT, a node under a TRS parent, a point and a
    directional light, a clamped/mirrored sampler, ior and transmission,
    and no camera."""
    base = os.path.dirname(path)
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 1, (8, 3)).astype(np.float32)
    nrm = rng.normal(size=(8, 3)).astype(np.float32)
    inter = np.concatenate([pos, nrm], 1).astype(np.float32)   # stride 24
    uv = rng.integers(0, 256, (8, 2)).astype(np.uint8)
    col = rng.integers(0, 65536, (8, 3)).astype(np.uint16)
    tan = np.concatenate([rng.normal(size=(8, 3)), np.sign(rng.normal(
        size=(8, 1)))], 1).astype(np.float32)
    idx = np.asarray([0, 1, 2, 2, 1, 3, 4, 5, 6, 6, 5, 7, 0, 2, 4, 4, 2, 6],
                     np.uint32)
    sp_idx = np.asarray([1, 6], np.uint16)
    sp_val = np.asarray([[0.5, 2.0, 0.25], [-1.5, 0.0, 1.0]], np.float32)
    blobs = []

    def view(arr, stride=None):
        off = sum(len(b) for b in blobs)
        raw = arr.tobytes()
        blobs.append(raw + b"\x00" * (-len(raw) % 4))
        v = {"buffer": 0, "byteOffset": off, "byteLength": len(raw)}
        if stride:
            v["byteStride"] = stride
        return v

    views = [view(inter, 24), view(uv), view(col), view(tan), view(idx),
             view(sp_idx), view(sp_val)]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": 8, "type": "VEC3",
         "sparse": {"count": 2,
                    "indices": {"bufferView": 5, "componentType": 5123},
                    "values": {"bufferView": 6}}},
        {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
         "count": 8, "type": "VEC3"},
        {"bufferView": 1, "componentType": 5121, "normalized": True,
         "count": 8, "type": "VEC2"},
        {"bufferView": 2, "componentType": 5123, "normalized": True,
         "count": 8, "type": "VEC3"},
        {"bufferView": 3, "componentType": 5126, "count": 8, "type": "VEC4"},
        {"bufferView": 4, "componentType": 5125, "count": 18,
         "type": "SCALAR"},
    ]
    with open(os.path.join(base, "feature.bin"), "wb") as f:
        f.write(b"".join(blobs))
    Image.fromarray(_noise((8, 6, 3), seed=8)).save(
        os.path.join(base, "albedo map.png"))
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 2, 3]}],
        "nodes": [
            {"rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "translation": [1.0, 0.5, -2.0], "scale": [1.5, 1.0, 0.5],
             "children": [1]},
            {"mesh": 0, "translation": [0.0, 1.0, 0.0]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}},
             "translation": [0, 4, 0]},
            {"extensions": {"KHR_lights_punctual": {"light": 1}},
             "rotation": [-0.3826834, 0.0, 0.0, 0.9238795]},
        ],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                           "COLOR_0": 3, "TANGENT": 4},
            "indices": 5, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                                     "baseColorTexture": {"index": 0},
                                     "metallicRoughnessTexture":
                                         {"index": 0}},
            "extensions": {"KHR_materials_ior": {"ior": 1.33},
                           "KHR_materials_transmission":
                               {"transmissionFactor": 0.6}}}],
        "samplers": [{"wrapS": 33071, "wrapT": 33648}],
        "images": [{"uri": "albedo%20map.png"}],
        "textures": [{"source": 0, "sampler": 0}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1, 0.5, 0.2], "intensity": 30.0,
             "range": 9.0},
            {"type": "directional", "intensity": 2.0}]}},
        "buffers": [{"uri": "feature.bin",
                     "byteLength": sum(len(b) for b in blobs)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    with open(path, "w") as f:
        json.dump(gltf, f)


GLTF_CASES = {
    "test_glb": ("t.glb", lambda p: _make_test_glb()(p)),
    "data_uri": ("tri.gltf", _data_uri_gltf),
    "features": ("feature.gltf", _feature_gltf),
    "standin_glb": ("standin.glb",
                    lambda p: TS.write_standin_glb(p, target_mtris=0.005)),
}


@pytest.mark.parametrize("case", sorted(GLTF_CASES))
def test_gltf_scene_matches_jax(tmp_path, case, monkeypatch):
    same_host_builders(monkeypatch)
    _check_gltf(tmp_path, case)


@pytest.mark.parametrize("case", sorted(GLTF_CASES))
def test_gltf_scene_matches_jax_native_off(tmp_path, case, monkeypatch):
    """The JAX loader on its numpy builders (its library forced off), as
    when its g++ build races another test worker: the port's loader
    follows it and stays bitwise."""
    jax_native_off(monkeypatch)
    same_host_builders(monkeypatch)
    _check_gltf(tmp_path, case)


def _check_gltf(tmp_path, case):
    name, write = GLTF_CASES[case]
    path = str(tmp_path / name)
    write(path)
    js, jcam = JG.load_gltf_scene(path)
    ts, tcam = TG.load_gltf_scene(path, device="cpu")
    if case == "standin_glb":
        # nodes share meshes: instanced, with the foliage split off
        assert ts.inst is not None and ts.bvh_alpha is not None
        assert int((ts.materials.alpha_mode == TD.ALPHA_MASK).sum()) == 1
        assert int((ts.materials.normal_tex >= 0).sum()) == 2
    if case == "features":
        assert int(ts.lights.num_punc) == 2 and ts.textures.size.shape[0] == 2
    _compare(interop.to_numpy(ts), js._replace(
        bvh=_with_table(js.bvh), bvh_alpha=_with_table(js.bvh_alpha)))
    _compare(interop.to_numpy(tcam), jcam)


def test_gltf_env_and_scene_front_door(tmp_path):
    """load_scene takes a .glb path; an env map passed to the loader is
    the scene's env, as attach_env makes it."""
    path = str(tmp_path / "t.glb")
    _make_test_glb()(path)
    env = TH.build_env_map(_hdr_image(seed=3), device="cpu")
    scene, _ = TS.load_scene(path, device="cpu")
    with_env, _ = TG.load_gltf_scene(path, env, device="cpu")
    assert scene.env is None and with_env.env is env
    assert int(scene.bvh.n_tris) == 3


def test_gltf_non_png_image_needs_pil(tmp_path, monkeypatch):
    """A JPEG texture decodes through PIL as in the JAX loader; without
    PIL the loader names the image."""
    path = str(tmp_path / "t.glb")
    _make_test_glb()(path)
    gltf, binary = TG._read_glb(path)
    jpg = io.BytesIO()
    Image.fromarray(_noise((8, 8, 3), 2)).save(jpg, format="JPEG")
    gltf["images"] = [{"uri": "data:image/jpeg;base64,"
                       + base64.b64encode(jpg.getvalue()).decode(),
                       "mimeType": "image/jpeg"}]
    want = np.asarray(Image.open(io.BytesIO(jpg.getvalue())).convert(
        "RGBA"), np.float32) / 255.0
    np.testing.assert_array_equal(
        TG._decode_image(gltf, [binary], str(tmp_path), 0), want)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ValueError, match="image 0 .image/jpeg."):
        TG._decode_image(gltf, [binary], str(tmp_path), 0)
