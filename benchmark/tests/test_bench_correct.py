"""`correct` fails where it should: the control (the reference in TF32
in the program's place) fails the cell's limits, and so does a run whose
timed path is broken underneath, for each fault a one-card frame can
have, the light's among them.  (A frame has no exchange between cards to
leave out.)  At the size of the tiny cell of conftest.bench_copy, on the
CPU and, marked `cuda`, on the card; the CPU runs the program's alpha
march both ways."""
import pytest
import torch

from benchmark import check, manifest
from benchmark.frames import Frames
from benchmark.reference import Reference

from .conftest import run_copy

SEED = 2**31 + 5


def _readings(root, device):
    cell = manifest.load_cell("standin_orbit_tiny", root=str(root))
    frames = Frames(cell.config, cell.traffic, SEED, device)
    frames.warm(4)
    index = frames.index - 1
    rec = check.record(frames.step, frames.scene, frames.cam, frames.params,
                       frames.tm, frames.prev, SEED,
                       cell.workload["check"]["rays_per_call"])
    ref = Reference(cell.config, cell.traffic, SEED, device)
    ctl = Reference(cell.config, cell.traffic, SEED, device, control=True,
                    scene=ref.scene)
    want = check.reference_answers(ref, rec, frames.out, frames.prev, index)
    program = check.compare(ref, rec, frames.out, frames.state, frames.prev,
                            index, want=want)
    control = check.control_readings(ctl, want, rec, frames.out,
                                     frames.prev, index)
    return cell, program, control


def _control_fails(root, device):
    cell, program, control = _readings(root, device)
    limits = cell.workload["limits"]
    assert check.judge(program, limits)[0], program
    ok, rows = check.judge(control, limits)
    assert not ok, rows
    # the control fails every number of the frame
    for name in check.NUMBERS:
        assert control[name] > limits[name], (name, control[name])


@pytest.mark.parametrize("march", ["lockstep", "queue"])
def test_control_fails_on_cpu(bench_copy, march, monkeypatch):
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", march)
    _control_fails(bench_copy, torch.device("cpu"))


@pytest.mark.cuda
def test_control_fails_on_card(bench_copy, cuda):
    _control_fails(bench_copy, cuda)


BREAK_FRAME = """
import eidola_tpu_torch.render.frame as F
_render = F.render_frame
def broken(cfg, scene, cam, params, tm, state, timer=None):
    new, out = _render(cfg, scene, cam, params, tm, state, timer=timer)
{body}
    return new, out
F.render_frame = broken
"""
BREAK_TRACER = """
import eidola_tpu_torch.render.tracer as T
{body}
"""
BREAK_SUN = """
import math
import torch
import eidola_tpu_torch.render.pathtrace as P
_sample_env = P.sample_env
def broken(cfg, scene, params, u1, u2, u3, u4):
{body}
P.sample_env = broken
"""
FAULTS = {
    # the step hands back the state it was given
    "state_unchanged": BREAK_FRAME.format(body="    new = state"),
    # half of the rows rendered, the rest given the mean of those
    "half_left_out": BREAK_FRAME.format(body=(
        "    h = out['image'].shape[0] // 2\n"
        "    for k in ('image', 'direct_ldr', 'indirect_ldr'):\n"
        "        x = out[k].clone()\n"
        "        x[h:] = x[:h].mean(dim=(0, 1))\n"
        "        out[k] = x\n"
        "    acc = new.accum.clone()\n"
        "    acc[h:] = acc[:h].mean(dim=(0, 1))\n"
        "    new = new._replace(accum=acc)")),
    # an answer altered where it is produced: one 4x4 tile of the image
    "image_altered": BREAK_FRAME.format(body=(
        "    x = out['image'].clone()\n"
        "    x[:4, :4] = 1.0 - x[:4, :4]\n"
        "    out['image'] = x")),
    # the walk's closest hits put 1% farther
    "hits_altered": BREAK_TRACER.format(body=(
        "for name in ('closest_hit_img', 'closest_hit_sorted'):\n"
        "    def farther(*a, _f=getattr(T, name), **k):\n"
        "        r = _f(*a, **k)\n"
        "        return r._replace(t=r.t * 1.01)\n"
        "    setattr(T, name, farther)")),
    # the opaque any-hit walks answer the opposite
    "occlusion_altered": BREAK_TRACER.format(body=(
        "for name in ('any_hit_img', 'any_hit_sorted'):\n"
        "    def flipped(*a, _f=getattr(T, name), **k):\n"
        "        return ~_f(*a, **k)\n"
        "    setattr(T, name, flipped)")),
    # the primary walk given a far end short of the scene, as a seeded
    # t_max that cut off the true hit would give it
    "primary_tmax_short": """
import eidola_tpu_torch.render.direct as D
D._TMAX = 8.0
""",
    # the denoiser one level short
    "denoise_altered": """
import eidola_tpu_torch.render.frame as F
_denoise = F.atrous_denoise
def short(img, view, levels, *a, **k):
    return _denoise(img, view, levels - 1, *a, **k)
F.atrous_denoise = short
""",
    # the light's faults, none of which touches a ray or an image stage:
    # the sun's pdf twice what its draws have
    "sun_pdf_doubled": BREAK_SUN.format(body=(
        "    wi, pdf, li = _sample_env(cfg, scene, params, u1, u2, u3, u4)\n"
        "    return wi, pdf * 2.0, li")),
    # the sky 1% dim along every escaped ray and primary miss
    "sky_dimmed": """
import eidola_tpu_torch.render.direct as D
import eidola_tpu_torch.render.pathtrace as P
import eidola_tpu_torch.render.tracer as T
_env = P.env_radiance
def dimmed(cfg, scene, params, d):
    return _env(cfg, scene, params, d) * 0.99
P.env_radiance = D.env_radiance = T.env_radiance = dimmed
""",
    # the drawn direction turned 0.01 rad about the vertical
    "sun_turned": BREAK_SUN.format(body=(
        "    wi, pdf, li = _sample_env(cfg, scene, params, u1, u2, u3, u4)\n"
        "    c, s = math.cos(0.01), math.sin(0.01)\n"
        "    x, y, z = wi.unbind(-1)\n"
        "    return torch.stack([c * x + s * z, y, c * z - s * x], -1), "
        "pdf, li")),
    # the sun's two words swapped
    "draws_reordered": BREAK_SUN.format(body=(
        "    return _sample_env(cfg, scene, params, u2, u1, u3, u4)")),
    # the MIS light pdf of an escaped BSDF ray nought everywhere
    "mis_pdf_zero": """
import torch
import eidola_tpu_torch.render.pathtrace as P
import eidola_tpu_torch.render.tracer as T
def zero(cfg, scene, d):
    return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
P.env_pdf_dir = T.env_pdf_dir = zero
""",
}


LIGHT_FAULTS = ("sun_pdf_doubled", "sky_dimmed", "sun_turned",
                "draws_reordered", "mis_pdf_zero")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("march", ["lockstep", "queue"])
def test_a_broken_timed_path_is_not_correct(bench_copy, fault, march,
                                            monkeypatch):
    monkeypatch.setenv("EIDOLA_ALPHA_MARCH", march)
    r = run_copy(bench_copy, "standin_orbit_tiny",
                 prelude=FAULTS[fault])["result"]
    assert r["correct"] is False, r["check"]
    assert r["failed"] == 1
    if fault in LIGHT_FAULTS:      # the light's own number catches it
        row = r["check"]["light_mismatch"]
        assert row["value"] > row["limit"], r["check"]
