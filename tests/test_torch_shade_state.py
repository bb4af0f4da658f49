"""The shading-state kernel (csrc/shade_state.cu, ops/shade_state.py) and
`render/shade_state.get_state`'s routing; no JAX.

On the CPU: the wrapper raises on what the kernel does not take, CPU
tensors included, before any launch and before the kernel is built; CPU
tensors take the torch body (`get_state_ref`) and count no launch; the
lanes' layouts reduce to one stride each (or raise), and the structs
it is handed carry the tensors' pointers, strides and the cone;
the ctypes mirrors list the CUDA structs' fields in order.  The torch
body itself is held against the JAX package's get_state in
tests/test_torch_foundations.py and tests/test_torch_instanced.py.

On the card (marked `cuda`; skips without one, imports no JAX, so it
also runs as `python -m pytest tests/test_torch_shade_state.py
--noconftest`): every field of State equals `get_state_ref`'s bit for
bit, on an instanced textured scene with and without normal maps, a flat
one (cornell), a flat textured one under each wrap mode, with and
without a cone (a float or a 0-d tensor), on strided and broadcast
lanes, on invalid lanes; every call of a standin frame, and the frame
itself against one rendered through the torch body.
"""
import os
import re

import numpy as np
import pytest
import torch

from eidola_tpu_torch.models.scenes import load_scene
from eidola_tpu_torch.ops import shade_state as K
from eidola_tpu_torch.render import shade_state as RS

SRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                   "shade_state.cu")


def records(scene, n, seed, miss=0.1):
    """(o, d, tri, t, u, v) of n synthetic hits on `scene`: triangle ids
    spread over every instance (or row), a share `miss` of them -1."""
    r = np.random.default_rng(seed)
    if scene.inst is None:
        tri = r.integers(0, scene.tri_mat.shape[0], n)
    else:
        # an instance, then a triangle of it (the last one's first alone)
        base = scene.inst.tri_base.cpu().numpy()
        span = np.diff(np.append(base, base[-1] + 1))
        i = r.integers(0, base.shape[0], n)
        tri = base[i] + (r.random(n) * span[i]).astype(np.int64)
    tri[r.random(n) < miss] = -1
    u = r.random(n).astype(np.float32)
    v = (r.random(n) * (1.0 - u)).astype(np.float32)
    t = (r.random(n) * 60.0 + 0.05).astype(np.float32)
    o = (r.normal(size=(n, 3)) * 10.0).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dev = scene.tri_mat.device
    return [torch.from_numpy(a).to(dev) for a in (o, d, tri, t, u, v)]


def _layout(args, layout):
    """The same lanes as contiguous planes, as strided views of wider
    ones, or with every ray leaving one origin, a broadcast view (as the
    primary rays leave the camera)."""
    o, d, tri, t, u, v = args
    n = tri.shape[0]
    if layout == "contiguous":
        return args
    if layout == "strided":
        big = torch.zeros((n, 8), dtype=o.dtype, device=o.device)
        big[:, 1:4], big[:, 4:7] = o, d
        rec = torch.stack([t, u, v, t], 1)
        return [big[:, 1:4], big[:, 4:7], torch.stack([tri, tri], 1)[:, 1],
                rec[:, 0], rec[:, 1], rec[:, 2]]
    h, w = 8, n // 8            # (h, w) lanes from one origin
    lane = lambda a: a[:h * w].reshape((h, w) + a.shape[1:])
    return [torch.broadcast_to(o[0], (h, w, 3)), lane(d), lane(tri),
            lane(t), lane(u), lane(v)]


@pytest.fixture(scope="module")
def cornell_cpu():
    return load_scene("cornell", device="cpu")[0]


FAULTS = {
    # fault: the message the wrapper raises
    "cpu": "takes CUDA tensors",
    "t_dtype": "t must be torch.float32",
    "tri_dtype": "tri must be torch.int64",
    "o_channels": r"o must be \(4000, 3\)",
    "lanes_shape": r"u must be \(4000,\)",
    "cone_dtype": "cone_angle must be torch.float32",
    "cone_shape": r"cone_angle must be \(\)",
    "devices": "all inputs must be on",
    "table_dtype": "tri_mat must be torch.int64",
    "table_rows": r"tri_uv must be \('T', 3, 2\)",
    "table_layout": "materials.base_color must be contiguous",
    "texture_channels": r"textures.data must be \('NT', None, None, 4\)",
    "layout": "are not one strided dimension",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_shade_state_wrapper_checks_its_arguments(cornell_cpu, fault):
    """ops/shade_state.shade raises before any launch (and before the
    kernel is built) on each fault, a CPU call with all else right among
    them; LAUNCHES does not move."""
    scene = cornell_cpu
    o, d, tri, t, u, v = records(scene, 4000, 3)
    cone = torch.tensor(0.002)
    if fault == "t_dtype":
        t = t.double()
    elif fault == "tri_dtype":
        tri = tri.int()
    elif fault == "o_channels":
        o = o[:, :2]
    elif fault == "lanes_shape":
        u = u[:-1]
    elif fault == "cone_dtype":
        cone = cone.double()
    elif fault == "cone_shape":
        cone = cone.reshape(1)
    elif fault == "devices":
        d = d.to("meta")
    elif fault == "table_dtype":
        scene = scene._replace(tri_mat=scene.tri_mat.int())
    elif fault == "table_rows":
        scene = scene._replace(tri_uv=scene.tri_uv[:-1])
    elif fault == "table_layout":
        m = scene.materials
        bc = torch.zeros(4, m.base_color.shape[0]).t()
        scene = scene._replace(materials=m._replace(base_color=bc))
    elif fault == "texture_channels":
        tex = scene.textures
        scene = scene._replace(textures=tex._replace(data=tex.data[..., :3]))
    elif fault == "layout":
        # (80, 50) lanes stored as (50, 80): no one stride walks them
        d = d.reshape(50, 80, 3).transpose(0, 1)
        o, tri, t, u, v = [a.reshape((80, 50) + a.shape[1:])
                           for a in (o, tri, t, u, v)]
    before = K.LAUNCHES
    with pytest.raises(ValueError, match=FAULTS[fault]):
        K.shade(scene, o, d, tri, t, u, v, cone)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("name,kw", [("cornell", {}), ("textured", {}),
                                     ("bistro_standin",
                                      {"target_mtris": 0.05})])
@pytest.mark.parametrize("cone", [None, 0.002, "tensor"])
def test_get_state_on_cpu_is_the_torch_body(monkeypatch, name, kw, cone):
    """CPU tensors take get_state_ref, field for field, and count no
    launch; the kernel's wrapper is never reached."""
    scene = load_scene(name, device="cpu", **kw)[0]
    args = records(scene, 3000, 5)
    cone = torch.tensor(0.001) if cone == "tensor" else cone
    want = RS.get_state_ref(scene, *args, cone_angle=cone)

    def never(*a, **k):
        raise AssertionError("the kernel's wrapper was reached on the CPU")

    monkeypatch.setattr(K, "shade", never)
    before = K.LAUNCHES
    got = RS.get_state(scene, *args, cone_angle=cone)
    assert K.LAUNCHES == before
    assert isinstance(got, RS.State)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("view,stride", [
    # contiguous (h, w) lanes
    (lambda a: a.reshape(4, 6, 3), 3),
    # a column of a wider plane
    (lambda a: torch.zeros(4, 6, 8)[..., 2:5], 8),
    # one origin broadcast over the lanes
    (lambda a: torch.broadcast_to(a[0, 0], (4, 6, 3)), 0),
    # unit dimensions
    (lambda a: a.reshape(1, 24, 1, 3), 3),
    # every other lane
    (lambda a: torch.zeros(48, 3)[::2], 6),
    # transposed, every other row, every other row and column: no one
    # stride
    (lambda a: a.reshape(6, 4, 3).transpose(0, 1), None),
    (lambda a: torch.zeros(8, 6, 3)[::2], None),
    (lambda a: torch.zeros(8, 12, 3)[::2, ::2], None),
])
def test_lane_stride(view, stride):
    """ops/shade_state._lane_stride: the one stride that walks a view's
    leading dimensions, or a ValueError where none does."""
    a = view(torch.zeros(24, 3))
    lead = tuple(a.shape[:-1])
    if stride is None:
        with pytest.raises(ValueError, match="not one strided dimension"):
            K._lane_stride("o", a, lead)
    else:
        assert K._lane_stride("o", a, lead) == stride


@pytest.mark.parametrize("layout", ["contiguous", "strided", "broadcast"])
@pytest.mark.parametrize("cone", [None, 0.003, "tensor"])
def test_lanes_struct_carries_pointers_strides_and_cone(cornell_cpu, layout,
                                                         cone):
    """The struct the kernel reads: every lane input's pointer and the
    stride from one lane to the next (o and d also their component's),
    the lanes' count, the cone as a pointer or a value."""
    o, d, tri, t, u, v = _layout(records(cornell_cpu, 4000, 7), layout)
    cone = torch.tensor(0.001) if cone == "tensor" else cone
    ln = K._lanes(o, d, tri, t, u, v, cone)
    assert ln.n == tri.numel()
    for name, a in zip(("o", "d", "tri", "t", "u", "v"), (o, d, tri, t, u, v)):
        assert getattr(ln, name) == a.data_ptr()
        lane = a.stride(tri.dim() - 1)       # the innermost lane dimension
        assert getattr(ln, "s" + name) == lane
    assert (ln.so3, ln.sd3) == (o.stride(-1), d.stride(-1))
    if layout == "broadcast":
        assert ln.so == 0
    assert ln.has_cone == (cone is not None)
    if isinstance(cone, torch.Tensor):
        assert ln.cone == cone.data_ptr()
    elif cone is not None:
        assert ln.cone is None and ln.cone_value == np.float32(cone)


@pytest.mark.parametrize("name,kw", [("cornell", {}), ("textured", {}),
                                     ("mini_grove", {})])
def test_tables_struct_carries_the_scene(name, kw):
    """The scene's struct: every table's pointer, the stack's extents,
    its deepest mip and the untextured flag, the instances (none on a
    flat scene: null pointers, 0 instances)."""
    scene = load_scene(name, device="cpu", **kw)[0]
    tb = K._tables(scene)
    for f, _, _ in K._TRI:
        assert getattr(tb, f) == getattr(scene, f).data_ptr()
    for f, _, _ in K._MAT:
        assert getattr(tb, f) == getattr(scene.materials, f).data_ptr()
    data = scene.textures.data
    assert (tb.tex.data, tb.tex.h, tb.tex.w2) == (data.data_ptr(),
                                                   data.shape[1],
                                                   data.shape[2])
    assert tb.tex.untextured == (data.shape[0] == data.shape[1] == 1)
    assert tb.max_level == max((data.shape[2] // 2).bit_length() - 1, 0)
    inst = scene.inst
    if inst is None:
        assert (tb.inst.tri_base, tb.inst.n, tb.rot) == (None, 0, None)
    else:
        assert tb.inst.n == inst.tri_base.shape[0]
        assert tb.inst.tri_base == inst.tri_base.data_ptr()
        assert tb.uvd_scale == inst.uvd_scale.data_ptr()


@pytest.mark.parametrize("struct", ["Lanes", "Tables", "Out", "TexStack",
                                    "InstSearch"])
def test_ctypes_mirrors_follow_the_kernel_structs(struct):
    """Each ctypes mirror lists its CUDA struct's fields in order (the
    library also checks the sizes when it loads)."""
    text = open(SRC).read() + open(os.path.join(os.path.dirname(SRC),
                                                "scene_fetch.cuh")).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, map(str.strip, body.split(";"))):
        first, *more = [re.sub(r"\[.*", "", w) for w in decl.split(",")]
        names += [first.split()[-1].lstrip("*")] + [m.strip() for m in more]
    mirror = getattr(K, "_" + struct)
    assert names == [f for f, _ in mirror._fields_]


# ---- on the card ------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _assert_bitwise(got, want, label=""):
    bad = [f for f, a, b in zip(RS.State._fields, got, want)
           if a.dtype != b.dtype or a.shape != b.shape
           or not torch.equal(_bits(a), _bits(b))]
    assert not bad, f"{label}: fields {bad} differ from get_state_ref"


_SCENES = {}


def _scene(name, dev):
    """(scene, camera) on `dev`, loaded once a module."""
    if name not in _SCENES:
        kw = {"target_mtris": 0.05} if name == "bistro_standin" else {}
        _SCENES[name] = load_scene(name, device=dev, **kw)
    return _SCENES[name]


def _cone(kind, dev):
    return {None: None, "float": 0.0021,
            "tensor": torch.tensor(0.0009, device=dev)}[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided", "broadcast"])
@pytest.mark.parametrize("cone", [None, "float", "tensor"])
@pytest.mark.parametrize("name", ["bistro_standin", "cornell", "textured",
                                  "mini_grove"])
def test_shade_state_kernel_matches_plain(cuda, name, cone, layout):
    """One launch equals get_state_ref on the same CUDA tensors bit for bit,
    on every field, invalid lanes included."""
    scene = _scene(name, cuda)[0]
    args = _layout(records(scene, 20000, 11), layout)
    cone = _cone(cone, cuda)
    want = RS.get_state_ref(scene, *args, cone_angle=cone)
    before = K.LAUNCHES
    got = RS.get_state(scene, *args, cone_angle=cone)
    assert K.LAUNCHES == before + 1
    assert (~want.valid).any() and want.valid.any()
    if name == "bistro_standin":     # materials with and without normal maps
        has_nm = scene.materials.normal_tex[want.mat_id[want.valid]] >= 0
        assert has_nm.any() and (~has_nm).any()
    _assert_bitwise(got, want, f"{name} {cone} {layout}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("cone", [None, "tensor"])
@pytest.mark.parametrize("name", ["textured", "bistro_standin"])
def test_shade_state_kernel_wrap_modes(cuda, name, mode, cone):
    """Each wrap mode (repeat, clamp, mirror) on uvs spread over [-1, 2]:
    bitwise equal to get_state_ref."""
    scene = _scene(name, cuda)[0]
    tex = scene.textures
    scene = scene._replace(tri_uv=scene.tri_uv * 3.0 - 1.0,
                           textures=tex._replace(
                               wrap=torch.full_like(tex.wrap, mode)))
    args = records(scene, 20000, 13 + mode)
    cone = _cone(cone, cuda)
    _assert_bitwise(RS.get_state(scene, *args, cone_angle=cone),
                    RS.get_state_ref(scene, *args, cone_angle=cone),
                    f"{name} wrap {mode}")


@pytest.mark.cuda
def test_shade_state_kernel_on_invalid_lanes_only(cuda):
    """Lanes with tri < 0 everywhere (and a call of no lanes): the invalid
    state's constants, bitwise."""
    scene = _scene("bistro_standin", cuda)[0]
    args = records(scene, 5000, 17, miss=1.0)
    _assert_bitwise(RS.get_state(scene, *args, cone_angle=0.001),
                    RS.get_state_ref(scene, *args, cone_angle=0.001),
                    "all invalid")
    empty = [a[:0] for a in args]
    _assert_bitwise(RS.get_state(scene, *empty),
                    RS.get_state_ref(scene, *empty), "no lanes")


@pytest.mark.cuda
def test_standin_frame_shades_through_six_launches(cuda, monkeypatch):
    """A default standin frame on the card adds 6 to LAUNCHES, 2 calls
    with a cone (the primary hit, the GI sample's hit) and 4 without (the
    multi-bounce's bounces); each call equals get_state_ref on its inputs
    bit for bit, and the frame equals the same frame rendered through
    get_state_ref, on every tensor it leaves."""
    from eidola_tpu_torch.render import direct, indirect, tracer
    from eidola_tpu_torch.render.config import (RenderConfig,
                                                default_params,
                                                default_tonemap)
    from eidola_tpu_torch.render.frame import init_frame_state, make_step

    scene, cam = _scene("bistro_standin", cuda)
    cfg = RenderConfig(width=160, height=96)
    mods = (direct, indirect, tracer)
    calls = []

    def kept(*args, cone_angle=None):
        calls.append((args, cone_angle))
        return RS.get_state(*args, cone_angle=cone_angle)

    def frame():
        params, tm = default_params(device=cuda), default_tonemap(device=cuda)
        out = make_step(cfg)(scene, cam, params, tm,
                             init_frame_state(cfg, cam))
        torch.cuda.synchronize()
        return out

    for m in mods:
        monkeypatch.setattr(m, "get_state", kept)
    before = K.LAUNCHES
    got = frame()
    assert K.LAUNCHES - before == len(calls) == 6
    assert [c is not None for _, c in calls].count(True) == 2
    for k, (args, cone) in enumerate(calls):
        _assert_bitwise(RS.get_state(*args, cone_angle=cone),
                        RS.get_state_ref(*args, cone_angle=cone),
                        f"call {k}")
    for m in mods:
        monkeypatch.setattr(m, "get_state", RS.get_state_ref)
    before = K.LAUNCHES
    want = frame()
    assert K.LAUNCHES == before

    def leaves(tree):
        if torch.is_tensor(tree):
            yield tree
        elif isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, (list, tuple)):
            for x in tree:
                yield from leaves(x)

    a, b = list(leaves(got)), list(leaves(want))
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
