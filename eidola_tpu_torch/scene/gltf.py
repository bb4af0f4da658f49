"""glTF 2.0 scene import -> SceneData (port of eidola_tpu/scene/gltf.py;
ref src/scene.cpp:57-125 Scene::load driving tinygltf, attribute
extraction scene.cpp:209-289, material import scene.cpp:415-448,
punctual lights scene.cpp:319-353).

A pure-Python parser for .gltf (JSON with external or data-URI buffers)
and .glb (the binary container).  A primitive that one node draws is
flattened into world space (upload_scene); when nodes share primitives,
they stay object-space pools under instance transforms
(upload_scene_instanced, the TLAS-over-BLAS analog, ref
accelstruct.cpp:132-162).  PNG images are decoded by utils/png.py; any
other image type goes through PIL, as in the JAX loader, and raises
naming the image where PIL is missing.

`write_glb` is the other direction, for scenes the repo builds in code:
one glTF mesh per mesh, one primitive per material, one node per
instance, PNG textures.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .camera import Camera, make_camera
from .data import (ALPHA_BLEND, ALPHA_MASK, ALPHA_OPAQUE, LIGHT_DIRECTIONAL,
                   LIGHT_POINT, LIGHT_SPOT, WRAP_CLAMP, WRAP_MIRROR,
                   WRAP_REPEAT, SceneData, attach_env, default_sunsky,
                   upload_scene, upload_scene_instanced)

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}
_ALPHA = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK, "BLEND": ALPHA_BLEND}
# glTF sampler wrap enums -> WRAP_* (ref scene.cpp:554-646)
_WRAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}
_GLB_MAGIC, _CHUNK_JSON, _CHUNK_BIN = 0x46546C67, 0x4E4F534A, 0x004E4942


def _read_glb(path: str) -> tuple[dict, bytes | None]:
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != _GLB_MAGIC:
            raise ValueError(f"{path}: not a GLB file")
        gltf = binary = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            clen, ctype = struct.unpack("<II", header)
            data = f.read(clen)
            if ctype == _CHUNK_JSON:
                gltf = json.loads(data)
            elif ctype == _CHUNK_BIN:
                binary = data
        if gltf is None:
            raise ValueError(f"{path}: GLB missing JSON chunk")
        return gltf, binary


def _read_uri(uri: str, base_dir: str) -> bytes:
    """A buffer or image URI: base64 data, or a file beside the glTF."""
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    from urllib.parse import unquote

    with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
        return f.read()


def _load_buffers(gltf: dict, base_dir: str, glb_bin: bytes | None):
    return [glb_bin if buf.get("uri") is None
            else _read_uri(buf["uri"], base_dir)
            for buf in gltf.get("buffers", [])]


def _accessor(gltf: dict, bufs, idx: int) -> np.ndarray:
    """Decode accessor idx to a (count, n) array, honouring byte stride,
    normalization and sparse storage."""
    acc = gltf["accessors"][idx]
    n = _TYPE_COUNT[acc["type"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize

    if "bufferView" in acc:
        bv = gltf["bufferViews"][acc["bufferView"]]
        data = bufs[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or n * itemsize
        if stride == n * itemsize:
            out = np.frombuffer(data, dtype, count=count * n,
                                offset=start).reshape(count, n).copy()
        else:
            raw = np.frombuffer(data, np.uint8,
                                count=stride * (count - 1) + n * itemsize,
                                offset=start)
            strided = np.lib.stride_tricks.as_strided(
                raw, shape=(count, n * itemsize), strides=(stride, 1))
            out = strided.reshape(-1).view(dtype).reshape(count, n).copy()
    else:
        out = np.zeros((count, n), dtype)

    sparse = acc.get("sparse")
    if sparse:
        sc = sparse["count"]
        iv = sparse["indices"]
        bv = gltf["bufferViews"][iv["bufferView"]]
        sidx = np.frombuffer(
            bufs[bv["buffer"]], _COMPONENT_DTYPE[iv["componentType"]],
            count=sc,
            offset=bv.get("byteOffset", 0) + iv.get("byteOffset", 0))
        vv = sparse["values"]
        bv = gltf["bufferViews"][vv["bufferView"]]
        out[sidx] = np.frombuffer(
            bufs[bv["buffer"]], dtype, count=sc * n,
            offset=bv.get("byteOffset", 0) + vv.get("byteOffset", 0),
        ).reshape(sc, n)

    if acc.get("normalized") and dtype != np.float32:
        out = out.astype(np.float32) / float(np.iinfo(dtype).max)
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _decode_image(gltf: dict, bufs, base_dir: str, idx: int) -> np.ndarray:
    """Image -> float RGBA in [0, 1] (sRGB -> linear for colour textures
    is the caller's, per glTF semantics, ref gltf_material.glsl:37-46)."""
    from ..utils.png import SIGNATURE, decode_png

    img = gltf["images"][idx]
    if "uri" in img:
        raw = _read_uri(img["uri"], base_dir)
    else:
        bv = gltf["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        raw = bytes(bufs[bv["buffer"]][off: off + bv["byteLength"]])
    if raw.startswith(SIGNATURE):
        rgba = decode_png(raw)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(
                f"glTF image {idx} ({img.get('mimeType', 'unknown type')}) "
                f"is not a PNG, and decoding it needs PIL") from None
        import io

        rgba = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    return rgba.astype(np.float32) / 255.0


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def load_gltf_scene(path: str, env_map=None, *, device
                    ) -> tuple[SceneData, Camera]:
    """Parse a glTF scene into SceneData on `device` and a camera (the
    file's first perspective camera, else one that frames the bounds).

    Mirrors Scene::load (scene.cpp:57-125): materials, drawable nodes with
    POSITION/NORMAL/TEXCOORD_0/TANGENT/COLOR_0, punctual lights, textures,
    emissive-triangle extraction (inside the upload)."""
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith(".glb"):
        gltf, glb_bin = _read_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_bin = None
    bufs = _load_buffers(gltf, base_dir, glb_bin)

    # ---- materials (ref scene.cpp:415-448) --------------------------------
    tex_source = [t.get("source", -1) for t in gltf.get("textures", [])]
    tex_sampler = [t.get("sampler", -1) for t in gltf.get("textures", [])]
    samplers = gltf.get("samplers", [])

    def _wraps(tex_idx: int) -> tuple[int, int]:
        si = tex_sampler[tex_idx]
        if si < 0 or si >= len(samplers):
            return WRAP_REPEAT, WRAP_REPEAT
        s = samplers[si]
        return (_WRAP.get(s.get("wrapS", 10497), WRAP_REPEAT),
                _WRAP.get(s.get("wrapT", 10497), WRAP_REPEAT))

    used_images: dict[tuple[int, bool, int, int], int] = {}
    images: list[dict] = []

    def tex_id(tex_idx: int | None, srgb: bool) -> int:
        if tex_idx is None or tex_idx < 0 or tex_idx >= len(tex_source):
            return -1
        src = tex_source[tex_idx]
        if src < 0:
            return -1
        ws, wt = _wraps(tex_idx)
        key = (src, srgb, ws, wt)
        if key not in used_images:
            arr = _decode_image(gltf, bufs, base_dir, src)
            if srgb:
                arr = np.concatenate([_srgb_to_linear(arr[..., :3]),
                                      arr[..., 3:]], -1)
            used_images[key] = len(images)
            images.append({"image": arr.astype(np.float32), "wrap_s": ws,
                           "wrap_t": wt})
        return used_images[key]

    materials = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        ext = m.get("extensions", {})
        emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]),
                              np.float32) * float(
            ext.get("KHR_materials_emissive_strength", {}).get(
                "emissiveStrength", 1.0))
        materials.append({
            "base_color": pbr.get("baseColorFactor", [1, 1, 1, 1]),
            "metallic": pbr.get("metallicFactor", 1.0),
            "roughness": pbr.get("roughnessFactor", 1.0),
            "emissive": emissive,
            "ior": ext.get("KHR_materials_ior", {}).get("ior", 1.5),
            "transmission": ext.get("KHR_materials_transmission", {}).get(
                "transmissionFactor", 0.0),
            "base_tex": tex_id(pbr.get("baseColorTexture", {}).get("index"),
                               srgb=True),
            "mr_tex": tex_id(
                pbr.get("metallicRoughnessTexture", {}).get("index"),
                srgb=False),
            "normal_tex": tex_id(m.get("normalTexture", {}).get("index"),
                                 srgb=False),
            "emissive_tex": tex_id(m.get("emissiveTexture", {}).get("index"),
                                   srgb=True),
            "alpha_mode": _ALPHA.get(m.get("alphaMode", "OPAQUE"), 0),
            "alpha_cutoff": m.get("alphaCutoff", 0.5),
            "double_sided": int(m.get("doubleSided", False)),
        })
    if not materials:
        materials = [{"base_color": [0.8, 0.8, 0.8, 1.0], "metallic": 0.0,
                      "roughness": 0.8}]

    # ---- drawable nodes (ref scene.cpp importDrawableNodes) ---------------
    scene_idx = gltf.get("scene", 0)
    roots = gltf.get("scenes", [{}])[scene_idx].get("nodes", [])
    nodes = gltf.get("nodes", [])

    v0s, v1s, v2s = [], [], []
    nrm, uvs, tans, cols, mids = [], [], [], [], []
    punc = {"pos": [], "color": [], "dir": [], "type": [], "range": [],
            "cos_inner": [], "cos_outer": []}
    cam_out: Camera | None = None
    gltf_lights = (gltf.get("extensions", {})
                   .get("KHR_lights_punctual", {}).get("lights", []))

    def extract_prim(prim: dict):
        """Object-space per-triangle dict for one primitive, extracted
        once per (mesh, primitive) however many nodes draw it."""
        if prim.get("mode", 4) != 4:  # triangles only
            return None
        attrs = prim.get("attributes", {})
        if "POSITION" not in attrs:
            return None
        pos = _accessor(gltf, bufs, attrs["POSITION"]).astype(np.float64)
        if "indices" in prim:
            idx = _accessor(gltf, bufs, prim["indices"]).reshape(-1)
            idx = idx.astype(np.int64)
        else:
            idx = np.arange(pos.shape[0], dtype=np.int64)
        tri = idx.reshape(-1, 3)
        T = tri.shape[0]
        out = {
            "v0": pos[tri[:, 0]], "v1": pos[tri[:, 1]], "v2": pos[tri[:, 2]],
            "normals": None, "uvs": np.zeros((T, 3, 2), np.float32),
            "tangents": None, "colors": None,
            "mat_ids": np.full(T, prim.get("material", 0), np.int32),
        }
        if "NORMAL" in attrs:
            n = _accessor(gltf, bufs, attrs["NORMAL"]).astype(np.float64)
            out["normals"] = n[tri]
        if "TEXCOORD_0" in attrs:
            uv = _accessor(gltf, bufs, attrs["TEXCOORD_0"])[..., :2]
            out["uvs"] = uv[tri].astype(np.float32)
        if "TANGENT" in attrs:
            tg = _accessor(gltf, bufs, attrs["TANGENT"]).astype(np.float64)
            out["tangents"] = tg[tri]
        if "COLOR_0" in attrs:
            c = _accessor(gltf, bufs, attrs["COLOR_0"]).astype(np.float32)
            if c.shape[1] == 3:
                c = np.concatenate([c, np.ones((c.shape[0], 1), np.float32)],
                                   1)
            out["colors"] = c[tri]
        return out

    def bake_prim(p: dict, world: np.ndarray):
        """A primitive under its node's transform, in world space."""
        r, t = world[:3, :3], world[:3, 3]
        nrm_mat = np.linalg.inv(r).T
        wv = [(p[k] @ r.T) + t for k in ("v0", "v1", "v2")]
        v0s.append(wv[0].astype(np.float32))
        v1s.append(wv[1].astype(np.float32))
        v2s.append(wv[2].astype(np.float32))
        if p["normals"] is not None:
            n = p["normals"] @ nrm_mat.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            nrm.append(n.astype(np.float32))
        else:
            gn = np.cross(wv[1] - wv[0], wv[2] - wv[0])
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                             1e-20)
            nrm.append(np.repeat(gn[:, None], 3, 1).astype(np.float32))
        uvs.append(p["uvs"])
        if p["tangents"] is not None:
            tg = p["tangents"]
            txyz = tg[..., :3] @ r.T
            ln = np.maximum(np.linalg.norm(txyz, axis=-1, keepdims=True),
                            1e-20)
            tans.append(np.concatenate([txyz / ln, tg[..., 3:4]], -1)
                        .astype(np.float32))
        else:
            tans.append(None)
        cols.append(p["colors"])
        mids.append(p["mat_ids"])

    prim_cache: dict[tuple[int, int], dict | None] = {}
    draws: list[tuple[tuple[int, int], np.ndarray]] = []

    def walk(node_idx: int, parent: np.ndarray):
        nonlocal cam_out
        node = nodes[node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            prims = gltf["meshes"][node["mesh"]].get("primitives", [])
            for pi, prim in enumerate(prims):
                key = (node["mesh"], pi)
                if key not in prim_cache:
                    prim_cache[key] = extract_prim(prim)
                if prim_cache[key] is not None:
                    draws.append((key, world))
        light_idx = (node.get("extensions", {})
                     .get("KHR_lights_punctual", {}).get("light"))
        if light_idx is not None and light_idx < len(gltf_lights):
            li = gltf_lights[light_idx]
            kind = {"point": LIGHT_POINT, "directional": LIGHT_DIRECTIONAL,
                    "spot": LIGHT_SPOT}.get(li.get("type", "point"),
                                            LIGHT_POINT)
            color = np.asarray(li.get("color", [1, 1, 1]), np.float64)
            color = color * li.get("intensity", 1.0)
            spot = li.get("spot", {})
            punc["pos"].append(world[:3, 3])
            punc["color"].append(color)
            punc["dir"].append(-world[:3, 2])  # glTF lights point down -Z
            punc["type"].append(kind)
            punc["range"].append(li.get("range", 0.0))
            punc["cos_inner"].append(np.cos(spot.get("innerConeAngle", 0.0)))
            punc["cos_outer"].append(
                np.cos(spot.get("outerConeAngle", np.pi / 4)))
        if "camera" in node and cam_out is None:
            c = gltf["cameras"][node["camera"]]
            if c.get("type") == "perspective":
                eye = world[:3, 3]
                fwd = -world[:3, 2]
                cam_out = make_camera(
                    eye, eye + fwd,
                    fovy_deg=np.degrees(c["perspective"].get("yfov", 1.0)),
                    device=device)
        for ch in node.get("children", []):
            walk(ch, world)

    for r in roots:
        walk(r, np.eye(4))

    if not draws:
        raise ValueError(f"{path}: no triangle geometry found")

    common = dict(materials=materials, textures=images if images else None,
                  sunsky=default_sunsky(), device=device)
    if punc["pos"]:
        common["punctual"] = {
            k: np.asarray(v, np.float32 if k != "type" else np.int32)
            for k, v in punc.items()}

    keys = list(dict.fromkeys(k for k, _ in draws))
    if len(keys) < len(draws):
        # nodes share primitives: a two-level BVH over shared object-space
        # pools (ref accelstruct.cpp:132-162), no flattening
        key_of = {k: i for i, k in enumerate(keys)}
        meshes = [prim_cache[k] for k in keys]
        instances = [(key_of[k], world) for k, world in draws]
        scene = upload_scene_instanced(meshes, instances, **common)
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for mi, world in instances:
            p = np.concatenate([meshes[mi]["v0"], meshes[mi]["v1"],
                                meshes[mi]["v2"]])
            wp = p @ world[:3, :3].T + world[:3, 3]
            lo = np.minimum(lo, wp.min(0))
            hi = np.maximum(hi, wp.max(0))
    else:
        for k, world in draws:
            bake_prim(prim_cache[k], world)

        def cat(parts, make_default):
            return np.concatenate([make_default(v0s[i].shape[0]) if p is None
                                   else p for i, p in enumerate(parts)])

        v0 = np.concatenate(v0s)
        kwargs = dict(normals=np.concatenate(nrm), uvs=np.concatenate(uvs),
                      mat_ids=np.concatenate(mids), **common)
        if any(t is not None for t in tans):
            kwargs["tangents"] = cat(tans, lambda n: np.tile(
                [1, 0, 0, 1.0], (n, 3, 1)).astype(np.float32))
        if any(c is not None for c in cols):
            kwargs["colors"] = cat(cols,
                                   lambda n: np.ones((n, 3, 4), np.float32))
        scene = upload_scene(v0, np.concatenate(v1s), np.concatenate(v2s),
                             **kwargs)
        lo = v0.min(0)
        hi = np.concatenate(v2s).max(0)
    if env_map is not None:
        scene = attach_env(scene, env_map)

    if cam_out is None:
        # frame the scene bounds (nvpro CameraManip fit analog)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
        eye = center + np.asarray([0.6, 0.35, 1.0]) * radius * 2.0
        cam_out = make_camera(eye, center, fovy_deg=50.0, device=device)
    return scene, cam_out


def _linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * c ** (1.0 / 2.4) - 0.055)


def write_glb(path: str, meshes: list[dict], instances, materials,
              textures=(), camera=None) -> int:
    """Write a scene given as upload_scene_instanced takes it to a GLB
    that load_gltf_scene reads back as the same geometry.

    meshes: [{"v0", "v1", "v2", optional "uvs", "mat_ids"}] in object
    space, each written as one glTF mesh with one unindexed primitive
    per material it uses; instances: [(mesh index, 4x4)], one node each
    with its `matrix`; materials: the registry's dicts (factors, texture
    ids, alpha mode and cutoff); textures: linear (H, W, 4) f32 images,
    written as 8-bit PNG, sRGB-encoded where a material uses the image
    as base colour (the loader linearises those again); camera: (eye,
    center, fovy_deg) becomes a perspective camera node.  Returns the
    file's size in bytes."""
    from ..utils.png import encode_png

    blobs, views, accessors = [], [], []

    def add_view(raw: bytes) -> int:
        off = sum(len(b) for b in blobs)
        blobs.append(raw + b"\x00" * (-len(raw) % 4))
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(raw)})
        return len(views) - 1

    def add_accessor(arr: np.ndarray, type_: str) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        accessors.append({
            "bufferView": add_view(arr.tobytes()), "componentType": 5126,
            "count": int(arr.shape[0]), "type": type_,
            "min": arr.min(0).tolist(), "max": arr.max(0).tolist()})
        return len(accessors) - 1

    srgb = {m["base_tex"] for m in materials if m.get("base_tex", -1) >= 0}
    images = []
    for i, tex in enumerate(textures):
        tex = np.asarray(tex, np.float32)
        rgb = _linear_to_srgb(tex[..., :3]) if i in srgb else tex[..., :3]
        u8 = np.round(np.clip(np.concatenate([rgb, tex[..., 3:4]], -1),
                              0.0, 1.0) * 255.0).astype(np.uint8)
        images.append({"bufferView": add_view(encode_png(u8)),
                       "mimeType": "image/png"})

    gl_meshes = []
    for m in meshes:
        T = m["v0"].shape[0]
        mat_ids = np.asarray(m.get("mat_ids", np.zeros(T, np.int32)))
        prims = []
        for mat in np.unique(mat_ids):
            sel = mat_ids == mat
            pos = np.stack([np.asarray(m[k])[sel] for k in ("v0", "v1", "v2")],
                           1).reshape(-1, 3)
            attrs = {"POSITION": add_accessor(pos, "VEC3")}
            if m.get("uvs") is not None:
                attrs["TEXCOORD_0"] = add_accessor(
                    np.asarray(m["uvs"])[sel].reshape(-1, 2), "VEC2")
            prims.append({"attributes": attrs, "material": int(mat)})
        gl_meshes.append({"primitives": prims})

    gl_materials = []
    for m in materials:
        pbr = {"baseColorFactor": [float(x) for x in
                                   m.get("base_color", [1, 1, 1, 1])],
               "metallicFactor": float(m.get("metallic", 0.0)),
               "roughnessFactor": float(m.get("roughness", 0.5))}
        out = {"pbrMetallicRoughness": pbr}
        if m.get("base_tex", -1) >= 0:
            pbr["baseColorTexture"] = {"index": int(m["base_tex"])}
        if m.get("normal_tex", -1) >= 0:
            out["normalTexture"] = {"index": int(m["normal_tex"])}
        if m.get("alpha_mode", ALPHA_OPAQUE) != ALPHA_OPAQUE:
            out["alphaMode"] = {ALPHA_MASK: "MASK",
                                ALPHA_BLEND: "BLEND"}[m["alpha_mode"]]
            out["alphaCutoff"] = float(m.get("alpha_cutoff", 0.5))
        if "emissive" in m:
            out["emissiveFactor"] = [float(x) for x in m["emissive"]]
        gl_materials.append(out)

    def column_major(m) -> list:
        m = np.asarray(m, np.float64)
        if m.shape == (3, 4):
            m = np.vstack([m, [0.0, 0.0, 0.0, 1.0]])
        return m.T.reshape(-1).tolist()

    nodes = [{"mesh": int(mi), "matrix": column_major(mat)}
             for mi, mat in instances]
    gltf = {"asset": {"version": "2.0", "generator": "eidola_tpu_torch"},
            "scene": 0, "meshes": gl_meshes, "materials": gl_materials,
            "bufferViews": views, "accessors": accessors}
    if images:
        gltf["images"] = images
        gltf["textures"] = [{"source": i} for i in range(len(images))]
    if camera is not None:
        eye, center, fovy_deg = camera
        eye, center = (np.asarray(x, np.float64) for x in (eye, center))
        f = (center - eye) / np.linalg.norm(center - eye)
        s = np.cross(f, [0.0, 1.0, 0.0])
        s /= np.linalg.norm(s)
        cam_to_world = np.eye(4)
        cam_to_world[:3, 0], cam_to_world[:3, 1] = s, np.cross(s, f)
        cam_to_world[:3, 2], cam_to_world[:3, 3] = -f, eye
        gltf["cameras"] = [{"type": "perspective", "perspective": {
            "yfov": float(np.radians(fovy_deg)), "znear": 0.01}}]
        nodes.append({"camera": 0, "matrix": column_major(cam_to_world)})
    gltf["nodes"] = nodes
    gltf["scenes"] = [{"nodes": list(range(len(nodes)))}]
    binc = b"".join(blobs)
    gltf["buffers"] = [{"byteLength": len(binc)}]
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(binc)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _CHUNK_JSON))
        f.write(js)
        f.write(struct.pack("<II", len(binc), _CHUNK_BIN))
        f.write(binc)
    return total
