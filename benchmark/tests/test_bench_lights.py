"""The reference's sun and sky (reference/lights/sunsky.py, float64)
against the program's (eidola_tpu_torch/scene/sunsky.py, float32) on the
CPU, at the numbers of the program's default sun and sky, by check.py's
own tolerances: the radiance and pdf of a few thousand directions, and
the draws of a grid of random words, each within L_REL and DIR_APART."""
import math

import numpy as np
import torch

from benchmark import check
from benchmark.reference.lights import sunsky as ref_sunsky
from benchmark.reference.precision import Precision
from benchmark.reference.scenes.bistro_standin import SUNSKY

N = 4096


def _program():
    from eidola_tpu_torch.scene import sunsky
    from eidola_tpu_torch.scene.data import SunSkyParams, default_sunsky

    p = sunsky.finalize_sunsky(default_sunsky())
    return sunsky, SunSkyParams(*[torch.as_tensor(np.array(x)) for x in p])


def _reference():
    return ref_sunsky.make(device=torch.device("cpu"), num=Precision(),
                           **SUNSKY)


def test_frozen_numbers_are_the_programs_defaults():
    _, p = _program()
    lit = _reference()
    assert torch.allclose(lit.sun.float(), p.sun_direction, atol=1e-7)
    for key in SUNSKY:
        if key != "sun_direction":
            assert np.allclose(np.asarray(SUNSKY[key], np.float32),
                               getattr(p, key).numpy()), key
    # the ground's irradiance, which both work out from the sky
    assert torch.allclose(lit.ground_irradiance, p.ground_irradiance.double(),
                          rtol=1e-5)


def _near_sun(lit, gen, n):
    """n directions about the sun, out to three radii, but for the rim
    (0.95-1.05 radii), where float32's arccos may put a direction on
    the other side of the disk's edge (check.py counts a share of
    those)."""
    r = float(lit.radius)
    ang = torch.rand(n, generator=gen, dtype=torch.float64) * 3.0 * r
    ang = torch.where((ang > 0.95 * r) & (ang < 1.05 * r), ang * 0.5, ang)
    phi = torch.rand(n, generator=gen, dtype=torch.float64) * 2 * math.pi
    t, b = ref_sunsky.make_frame(lit.sun)
    return ((torch.sin(ang) * torch.cos(phi))[:, None] * t
            + (torch.sin(ang) * torch.sin(phi))[:, None] * b
            + torch.cos(ang)[:, None] * lit.sun)


def test_radiance_and_pdf_agree_with_the_program():
    program, p = _program()
    lit = _reference()
    gen = torch.Generator().manual_seed(24)
    d = torch.randn(N, 3, generator=gen, dtype=torch.float64)
    d = torch.cat([d / torch.linalg.norm(d, dim=-1, keepdim=True),
                   _near_sun(lit, gen, N // 4)]).float()
    inside = lit.pdf(d) > 0
    assert 0 < int(inside.sum()) < d.shape[0]
    assert not check._off(program.sky_radiance(p, d), lit.radiance(d),
                          check.L_FLOOR).any()
    got, want = program.sun_pdf(p, d), lit.pdf(d)
    assert torch.equal(got > 0, want > 0)
    assert not check._off(got, want, 0.0).any()


def test_draws_agree_with_the_program():
    """The sun's cone drawn from a grid of (u1, u2), u1 from 0.003 up:
    below it float32 holds the cone's cosine within 2^-24 of 1 and the
    direction may lie past DIR_APART (check.py counts a share of
    those)."""
    program, p = _program()
    lit = _reference()
    u1, u2 = torch.meshgrid(torch.linspace(0.003, 0.999, 64),
                            torch.linspace(0.0, 0.999, 64), indexing="ij")
    u1, u2 = u1.reshape(-1), u2.reshape(-1)
    wi_g, pdf_g, li_g = program.sample_sun(p, u1, u2)
    wi_w, pdf_w, li_w = lit.sample(u1.double(), u2.double(), None, None)
    apart = torch.linalg.norm(wi_g.double() - wi_w, dim=-1)
    assert float(apart.max()) <= check.DIR_APART
    assert not check._off(check._weight(pdf_g, li_g),
                          check._weight(pdf_w, li_w), check.L_FLOOR).any()
    # the program's lookups at its own draws, as the check asks them
    assert not check._off(program.sky_radiance(p, wi_g), lit.radiance(wi_g),
                          check.L_FLOOR).any()
    got, want = program.sun_pdf(p, wi_g), lit.pdf(wi_g)
    assert bool((want > 0).all()) and torch.equal(got > 0, want > 0)
    assert not check._off(got, want, 0.0).any()
