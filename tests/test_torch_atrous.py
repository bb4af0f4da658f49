"""The a-trous level kernel's wrapper (ops/atrous.py) and the denoiser's
routing (render/denoise.py) on the CPU; no JAX.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds
it against the torch level, bit for bit).  Here: the wrapper raises on
what the kernel does not take, CPU tensors included, before any launch;
CPU tensors take the torch level and count no launch; the card's path
(`run_levels`) ping-pongs between two buffers and exchanges the image's
rows at each level's pad under a shard context, shown with the launch
replaced by a recorder.
"""
import numpy as np
import pytest
import torch

from eidola_tpu_torch.ops import atrous
from eidola_tpu_torch.render import denoise as D
from eidola_tpu_torch.render.gbuffer import GBufferView


def _case(h, w, seed, strided=False):
    """(image, view, sigmas) on the CPU: 10% invalid pixels, three material
    hashes; `strided`: the view is [::2, ::2] of a (2h, 2w) one."""
    r = np.random.default_rng(seed)
    hv, wv = (2 * h, 2 * w) if strided else (h, w)
    nrm = r.normal(size=(hv, wv, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    planes = [torch.from_numpy(r.random((hv, wv)) < 0.9),
              torch.from_numpy((4 * r.random((hv, wv, 3)))
                               .astype(np.float32)),
              torch.from_numpy(nrm.astype(np.float32)),
              torch.from_numpy(r.integers(0, 3, (hv, wv)))]
    if strided:
        planes = [a[::2, ::2] for a in planes]
    valid, pos, nrm, mat_hash = planes
    view = GBufferView(valid, None, pos, nrm, None, mat_hash, None, None,
                       None, None)
    img = torch.from_numpy(r.random((h, w, 3)).astype(np.float32))
    sig = [torch.tensor(x, dtype=torch.float32) for x in (4.0, 128.0, 2.0)]
    return img, view, sig


def _planes(view):
    return atrous.View(view.pos, view.nrm, view.mat_hash, view.valid)


FAULTS = {
    # fault: the message the wrapper raises
    "cpu": "takes CUDA tensors",
    "img_dtype": "img must be torch.float32",
    "hash_dtype": "view.mat_hash must be torch.int64",
    "valid_dtype": "view.valid must be torch.bool",
    "img_channels": r"img must be \(h, w, 3\)",
    "pos_channels": r"view.pos must be \(12, 9, 3\)",
    "view_rows": r"view.nrm must be \(12, 9, 3\)",
    "view_extension": r"view.pos must be \(16, 9, 3\)",
    "sigma_shape": r"sigma_norm must be \(\)",
    "devices": "all inputs must be on",
    "level": "level must lie in",
    "extension": "row extensions must be >= 0",
    "no_pixel": "holds no pixel",
    "out_shape": r"out must be \(12, 9, 3\)",
    "out_layout": "out must be contiguous",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_atrous_wrapper_checks_its_arguments(fault):
    """ops/atrous.run_level raises before any launch (and before the kernel
    is built) on each fault, a CPU tensor with all else right among them;
    LAUNCHES does not move."""
    img, view, sig = _case(12, 9, 1)
    planes = _planes(view)
    kw = {}
    level = 1
    if fault == "img_dtype":
        img = img.double()
    elif fault == "hash_dtype":
        planes = planes._replace(mat_hash=planes.mat_hash.int())
    elif fault == "valid_dtype":
        planes = planes._replace(valid=planes.valid.to(torch.uint8))
    elif fault == "img_channels":
        img = torch.zeros(12, 9, 4)
    elif fault == "pos_channels":
        planes = planes._replace(pos=planes.pos[..., :2])
    elif fault == "view_rows":
        planes = planes._replace(nrm=planes.nrm[:11])
    elif fault == "view_extension":
        kw["e_view"] = 2          # the planes carry no extra rows
    elif fault == "sigma_shape":
        sig[1] = sig[1].reshape(1)
    elif fault == "devices":
        planes = planes._replace(pos=planes.pos.to("meta"))
    elif fault == "level":
        level = 30
    elif fault == "extension":
        kw["e_img"] = -1
    elif fault == "no_pixel":
        kw["e_img"] = 6
    elif fault == "out_shape":
        kw["out"] = torch.empty(12, 9, 4)
    elif fault == "out_layout":
        kw["out"] = torch.empty(12, 3, 9).transpose(1, 2)
    before = atrous.LAUNCHES
    with pytest.raises(ValueError, match=FAULTS[fault]):
        atrous.run_level(img, planes, level, *sig, **kw)
    assert atrous.LAUNCHES == before


@pytest.mark.parametrize("h,w,levels,strided", [(24, 40, 4, False),
                                                (12, 20, 5, True),
                                                (7, 5, 5, False)])
def test_atrous_denoise_on_cpu_is_the_torch_level(h, w, levels, strided):
    """CPU tensors take the torch level (atrous_level) at every level and
    count no launch."""
    img, view, sig = _case(h, w, h + levels, strided)
    want = img
    for level in range(levels):
        want = D.atrous_level(want, view, level, *sig)
    before = atrous.LAUNCHES
    got = D.atrous_denoise(img, view, levels, *sig)
    assert atrous.LAUNCHES == before
    assert torch.equal(got, want)
    assert float((got - img).abs().mean()) > 1e-3       # it did filter


class _Recorder:
    """Stands in for atrous.run_level: records each level's source and
    output and writes the source's own rows plus the level."""

    def __init__(self):
        self.calls = []

    def __call__(self, src, view, level, *sig, out=None, e_img=0, e_view=0):
        self.calls.append(dict(src=src, out=out, level=level, e_img=e_img,
                               e_view=e_view, view=view, sig=sig))
        out.copy_(src[e_img:src.shape[0] - e_img] + level)
        return out


@pytest.mark.parametrize("sharded", [False, True])
def test_run_levels_ping_pongs_between_two_buffers(monkeypatch, sharded):
    """The card's path over 5 levels: each level writes one of two buffers,
    never the one it reads; the first reads the input, each next one the
    last output; under a shard context the image is exchanged at each
    level's pad (2 << level) and read with that many extra rows."""
    rec = _Recorder()
    monkeypatch.setattr(atrous, "run_level", rec)
    img, view, sig = _case(10, 6, 3)
    pads = []

    def exchange(a, pad):
        pads.append(pad)
        rows = torch.clamp(torch.arange(-pad, a.shape[0] + pad), 0,
                           a.shape[0] - 1)
        return a[rows]

    got = atrous.run_levels(img, _planes(view), 5, *sig, e_view=32,
                            exchange=exchange if sharded else None)
    assert [c["level"] for c in rec.calls] == [0, 1, 2, 3, 4]
    outs = [c["out"].data_ptr() for c in rec.calls]
    assert len(set(outs)) == 2 and outs[0::2] == [outs[0]] * 3
    assert outs[1::2] == [outs[1]] * 2
    assert all(c["src"].data_ptr() != c["out"].data_ptr() for c in rec.calls)
    assert all(c["e_view"] == 32 for c in rec.calls)
    if sharded:
        assert pads == [2, 4, 8, 16, 32]
        assert [c["e_img"] for c in rec.calls] == pads
    else:
        assert rec.calls[0]["src"] is img
        assert all(c["e_img"] == 0 for c in rec.calls)
        assert all(rec.calls[i + 1]["src"] is rec.calls[i]["out"]
                   for i in range(4))
    assert got is rec.calls[-1]["out"]
    want = img
    for level in range(5):
        want = want + level
    assert torch.equal(got, want)
    assert atrous.run_levels(img, _planes(view), 0, *sig) is img


def test_atrous_denoise_routes_card_tensors_to_the_kernel(monkeypatch):
    """Tensors off the CPU (here on the meta device) go to run_levels with
    the view's four planes, no row extension and no exchange."""
    seen = []
    monkeypatch.setattr(atrous, "run_levels",
                        lambda *a, **k: seen.append((a, k)) or a[0])
    img, view, sig = _case(8, 8, 4)
    meta = lambda a: None if a is None else a.to("meta")
    img, sig = meta(img), [meta(s) for s in sig]
    view = GBufferView(*[meta(a) for a in view])
    assert D.atrous_denoise(img, view, 4, *sig) is img
    (args, kw), = seen
    assert args[0] is img and args[2] == 4 and args[3:] == tuple(sig)
    assert tuple(args[1]) == (view.pos, view.nrm, view.mat_hash, view.valid)
    assert kw == dict(e_view=0, exchange=None)
