"""`correct`: the window's last frame against the plain reference.

After the window, the harness renders the window's last frame once more
from the state it started from (`record`), with the program's ray front
doors (render/tracer.py's trace_closest and trace_occlusion, where
render/direct.py, render/indirect.py and render/tracer.py call them), its
light front doors (render/pathtrace.py's sample_direct_light and
env_radiance, where render/direct.py and render/tracer.py call them, and
env_pdf_dir, where render/tracer.py and light_pdf_for_bsdf_dir call it)
and its denoiser and compose calls in render/frame.py wrapped to keep
what they were given and gave: the primary rays in full, a sample drawn
from the seed of every other call's rays, of every light draw's random
words and sample, and of every radiance and pdf lookup's directions and
answers, the noisy light each denoiser call was given, the emission and
albedo compose was given.  The window's own outputs are what is judged.
The numbers, each the program against the reference (reference/):

  ray_max_abs        the primary rays: the program's origins and
                     directions against the reference's camera and
                     jitter (camera, seeds), largest difference
  closest_mismatch   share of the sampled closest-hit rays (primary,
                     GI, path bounces) whose hit differs: hit against
                     miss, or t apart by more than T_REL (walk kernels,
                     the alpha HitTest's march); the reference takes the
                     nearest hit with no far end, so a far end that the
                     program cut short of it shows
  occluded_mismatch  share of the sampled shadow rays (DI, NEE) whose
                     occlusion differs (any-hit walks, the march)
  denoise_max_abs    the window's denoised direct and indirect light
                     against the reference's a-trous of the noisy light
                     (K3, K4), largest difference
  image_max_abs      the window's LDR image against the reference's
                     compose, accumulation and post of the window's
                     denoised light (K5, K8), largest difference
  state_max_rel      the frame state the window left: its accumulated
                     HDR against the reference's (difference over
                     max(1, |reference|)), its count and frame index
  light_mismatch     the largest of three shares of the sampled light
                     records that disagree (the scene's light,
                     reference/lights/): draws, whose direction lies
                     more than DIR_APART from the one that the reference
                     draws from the same random words, or whose radiance
                     over pdf differs by more than L_REL; radiance
                     lookups that differ by more than L_REL; pdf lookups
                     that differ by more than L_REL, or are zero on one
                     side only.  The frame's escaped rays find the sun's
                     disk about once in 10^5, so each lookup call is
                     also asked, after the frame's own call, for its
                     answer at the frame's latest drawn directions: the
                     light's support

What the reference does not re-derive, and takes from the program's
frame: K1's and K2's shading and resampling (the RIS candidates'
weights, the reservoirs, the temporal merge, the path's throughput),
every ray but the primary ones, and so a shadow ray's far end (its
light sample's distance), and the accumulation before the frame.

Each has a limit in workloads/<cell>.json, set from the program's
readings over many seeds and the control's (PERF.md).  A number that is
not finite fails, and so does a frame whose calls were not all seen.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import math
from typing import NamedTuple

import torch

NUMBERS = ("ray_max_abs", "closest_mismatch", "occluded_mismatch",
           "denoise_max_abs", "image_max_abs", "state_max_rel",
           "light_mismatch")
T_REL = 1e-4
# a light draw's direction may lie this far from the reference's: float32
# puts the sun's draws within 2.5e-4 of it, past 1e-4 only where the
# cone's cosine is within 2^-24 of 1 (u1 under 0.003: 0.2% of draws)
DIR_APART = 1e-4
# a draw's radiance over pdf, a radiance or a pdf may differ from the
# reference's by this share: the program's sun pdf and disk radiance are
# 0.21% high (float32 holds 1 - cos of the sun's 0.00465 rad radius in
# steps of 2^-24: 181 of them for 181.4), each draw's weight and every
# other lookup within 3e-5; a light 1% off fails
L_REL = 5e-3
# a radiance is held to L_REL of max(|reference|, L_FLOOR): near zero a
# relative difference is float32's rounding in the sky's XYZ-to-RGB mix,
# not a fault; 1e-3 is a hundredth of the sun and sky's dimmest channel
# (0.099), so it does not bite there
L_FLOOR = 1e-3
# a lane's direction counts as one within this of unit length
UNIT = 1e-3
# the program's ray front doors, by the modules that call them
TRACE_SITES = (("eidola_tpu_torch.render.direct", "trace_closest"),
               ("eidola_tpu_torch.render.direct", "trace_occlusion"),
               ("eidola_tpu_torch.render.indirect", "trace_closest"),
               ("eidola_tpu_torch.render.tracer", "trace_closest"),
               ("eidola_tpu_torch.render.tracer", "trace_occlusion"))
# the program's light front doors, by the modules that call them
DRAW_SITES = (("eidola_tpu_torch.render.direct", "sample_direct_light"),
              ("eidola_tpu_torch.render.tracer", "sample_direct_light"))
LOOKUP_SITES = (
    ("eidola_tpu_torch.render.direct", "env_radiance", "radiance"),
    ("eidola_tpu_torch.render.tracer", "env_radiance", "radiance"),
    ("eidola_tpu_torch.render.tracer", "env_pdf_dir", "pdf"),
    ("eidola_tpu_torch.render.pathtrace", "env_pdf_dir", "pdf"))
FRAME = "eidola_tpu_torch.render.frame"


class Rays(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor


class Record(NamedTuple):
    primary: tuple          # (o, d) (H, W, 3) of the primary trace
    closest: list           # [(Rays, hit, t)] sampled
    occluded: list          # [(Rays, occluded)] sampled
    noisy: list             # [(img, pos, nrm, mat, valid)] a denoiser call
    emission: torch.Tensor
    albedo: torch.Tensor
    draws: list             # [(rng state, wi, pdf, li)] sampled, a draw
    radiance: list          # [(d, radiance)] sampled, a lookup
    pdf: list               # [(d, pdf)] sampled, a lookup


def _flat(x, n, like):
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return torch.broadcast_to(x, like.shape[:-1]).reshape(n)


class Recorder:
    def __init__(self, seed: int, per_call: int):
        self.gen = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFF)
        # the light's lanes come from a generator of their own, so that
        # the rays' sample is the one it was
        self.light_gen = torch.Generator().manual_seed(
            (int(seed) + 1) & 0xFFFFFFFF)
        self.per_call = per_call
        self.primary = None
        self.closest, self.occluded, self.noisy = [], [], []
        self.emission = self.albedo = None
        self.draws, self.lookups = [], {"radiance": [], "pdf": []}

    def pick(self, ok, gen):
        """per_call lanes drawn from those where `ok`, or None."""
        live = torch.nonzero(ok)[:, 0]
        if not live.numel():
            return None
        pick = torch.randint(0, live.numel(), (self.per_call,),
                             generator=gen).to(live.device)
        return live[pick]

    def rays(self, o, d, t_min, t_max):
        """The sampled live rays of a call, and their indices."""
        n = o.numel() // 3
        rays = Rays(o.reshape(n, 3), d.reshape(n, 3), _flat(t_min, n, o),
                    _flat(t_max, n, o))
        idx = self.pick(rays.t_max > rays.t_min, self.gen)
        if idx is None:
            return None, None
        return Rays(*[x[idx] for x in rays]), idx

    def directions(self, d):
        """The sampled lanes of a call whose direction is finite and of
        unit length, as (d (k, 3), their indices), or None."""
        d = d.reshape(-1, 3)
        ok = torch.isfinite(d).all(-1) & (
            (torch.linalg.norm(d, dim=-1) - 1.0).abs() < UNIT)
        idx = self.pick(ok, self.light_gen)
        return None if idx is None else (d[idx], idx)

    def trace(self, kind, args, out):
        o, d = args["o"], args["d"]
        sample, idx = self.rays(o, d, args["t_min"], args["t_max"])
        if kind == "trace_closest":
            if self.primary is None:
                self.primary = (o, d)
            rec = out[1]
            if sample is not None:
                t = rec.t.reshape(-1)[idx]
                self.closest.append((sample, rec.tri.reshape(-1)[idx] >= 0,
                                     t))
        elif sample is not None:
            self.occluded.append((sample, out[1].reshape(-1)[idx]))

    def draw(self, fn, bound, out):
        """A light draw: the state it was given, and its sample."""
        ls = out[1]
        picked = self.directions(ls.wi)
        if picked is not None:
            wi, idx = picked
            state = bound.arguments["rng_state"]
            self.draws.append((state.reshape(-1)[idx], wi,
                               ls.pdf.reshape(-1)[idx],
                               ls.li.reshape(-1, 3)[idx]))

    def lookup(self, kind, fn, bound, out):
        """A radiance or pdf lookup of directions `d`: its sampled lanes,
        and `fn`'s answer at the frame's latest drawn directions."""
        picked = self.directions(bound.arguments["d"])
        if picked is None:
            return
        d, idx = picked
        n = bound.arguments["d"].numel() // 3
        dirs, got = [d], [out.reshape(n, -1)[idx]]
        if self.draws:
            wi = self.draws[-1][1]
            bound.arguments["d"] = wi
            dirs.append(wi)
            got.append(fn(*bound.args, **bound.kwargs).reshape(
                wi.shape[0], -1))
        self.lookups[kind].append((torch.cat(dirs), torch.cat(got)))

    def result(self) -> Record:
        return Record(self.primary, self.closest, self.occluded, self.noisy,
                      self.emission, self.albedo, self.draws,
                      self.lookups["radiance"], self.lookups["pdf"])


@contextlib.contextmanager
def _wrapped(sites):
    """Replace each function `name` of module `mod_name` of `sites`
    (mod_name, name, make) by make(the function) for the block."""
    saved = []
    try:
        for mod_name, name, make in sites:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            setattr(mod, name, make(fn))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def record(step, scene, cam, params, tm, prev, seed: int,
           per_call: int) -> Record:
    """Render the frame from `prev` once more through `step`, keeping
    what check.py compares."""
    rec = Recorder(seed, per_call)

    def kept(keep):
        """make(fn): fn, and keep(fn, its bound arguments, its output)
        after each call."""
        def make(fn):
            sig = inspect.signature(fn)

            def wrapper(*a, **k):
                out = fn(*a, **k)
                keep(fn, sig.bind(*a, **k), out)
                return out
            return wrapper
        return make

    def tracer(kind):
        return kept(lambda fn, bound, out: rec.trace(kind, bound.arguments,
                                                     out))

    def denoiser(fn):
        def wrapper(img, view, *a, **k):
            rec.noisy.append((img, view.pos, view.nrm, view.mat_hash,
                              view.valid))
            return fn(img, view, *a, **k)
        return wrapper

    def composer(fn):
        def wrapper(direct, indirect, emission, view, *a, **k):
            rec.emission, rec.albedo = emission, view.albedo
            return fn(direct, indirect, emission, view, *a, **k)
        return wrapper

    sites = [(m, n, tracer(n)) for m, n in TRACE_SITES]
    sites += [(m, n, kept(rec.draw)) for m, n in DRAW_SITES]
    sites += [(m, n, kept(functools.partial(rec.lookup, kind)))
              for m, n, kind in LOOKUP_SITES]
    sites += [(FRAME, "atrous_denoise", denoiser),
              (FRAME, "compose", composer)]
    with _wrapped(sites), torch.no_grad():
        step(scene, cam, params, tm, prev)
    return rec.result()


# --- the answers both sides give, and the numbers between them ----------

def program_answers(record: Record, out: dict, state, prev) -> dict:
    return {
        "rays": record.primary,
        "closest": [(hit, t) for _, hit, t in record.closest],
        "occluded": [occ for _, occ in record.occluded],
        "denoised": [out["direct_ldr"], out["indirect_ldr"]],
        "image": out["image"],
        "state": (state.accum, float(state.accum_count),
                  int(state.frame_idx)),
        "draws": [(wi, pdf, li) for _, wi, pdf, li in record.draws],
        "radiance": [li for _, li in record.radiance],
        "pdf": [pdf for _, pdf in record.pdf],
    }


def reference_answers(ref, record: Record, out: dict, prev,
                      index: int) -> dict:
    """What the reference `ref` gives for the same frame: its own rays,
    and its answers for the rays, noisy light and denoised light that the
    program's frame had."""
    accum, count, img = ref.finish(out["direct_ldr"], out["indirect_ldr"],
                                   record.emission, record.albedo,
                                   prev.accum, float(prev.accum_count),
                                   index)
    return {
        "rays": ref.rays(index),
        "closest": [ref.closest(*rays) for rays, _, _ in record.closest],
        "occluded": [ref.occluded(*rays) for rays, _ in record.occluded],
        "denoised": [ref.denoise(*noisy, indirect=bool(k))
                     for k, noisy in enumerate(record.noisy)],
        "image": img,
        "state": (accum, count, index + 1),
        "draws": [ref.draw(state) for state, *_ in record.draws],
        "radiance": [ref.light.radiance(d) for d, _ in record.radiance],
        "pdf": [ref.light.pdf(d) for d, _ in record.pdf],
    }


def _max_abs(a, b) -> float:
    d = (a.double() - b.double().to(a.device)).abs()
    return float(d.max()) if d.numel() else 0.0


def _share(flags) -> float:
    flags = torch.cat([f.reshape(-1).to(torch.bool) for f in flags]) \
        if flags else torch.zeros(0, dtype=torch.bool)
    return float(flags.double().mean()) if flags.numel() else math.nan


def _off(got, want, floor: float):
    """Whether each record (a row of `want`'s shape, or of its first
    dimension) differs by more than L_REL of max(|want|, floor)."""
    got = got.double()
    want = want.double().to(got.device).reshape(got.shape)
    off = (got - want).abs() > L_REL * torch.clamp(want.abs(), min=floor)
    return off.reshape(off.shape[0], -1).any(-1)


def _weight(pdf, li):
    """A draw's radiance over its pdf, 0 where the pdf is."""
    pdf = pdf.double().reshape(-1, 1)
    return torch.where(pdf > 0.0, li.double() / torch.where(
        pdf > 0.0, pdf, torch.ones_like(pdf)), 0.0)


def light_mismatch(got: dict, want: dict) -> float:
    """The largest share of the light's sampled draws, radiance lookups
    and pdf lookups that disagree; inf where a kind was not seen."""
    draws = []
    for (wi_g, pdf_g, li_g), (wi_w, pdf_w, li_w) in zip(got["draws"],
                                                        want["draws"]):
        wi_w = wi_w.double().to(wi_g.device)
        apart = torch.linalg.norm(wi_g.double() - wi_w, dim=-1) > DIR_APART
        draws.append(apart | _off(_weight(pdf_g, li_g), _weight(pdf_w, li_w),
                                  L_FLOOR))
    radiance = [_off(g, w, L_FLOOR)
                for g, w in zip(got["radiance"], want["radiance"])]
    pdf = []
    for g, w in zip(got["pdf"], want["pdf"]):
        g = g.reshape(-1)
        w = w.reshape(-1).to(g.device)
        pdf.append(_off(g, w, 0.0) | ((g == 0) != (w == 0)))
    kinds = (draws, radiance, pdf)
    if not all(kinds) or any(len(got[k]) != len(want[k])
                             for k in ("draws", "radiance", "pdf")):
        return math.inf
    return max(_share(k) for k in kinds)


def readings(got: dict, want: dict) -> dict:
    """The numbers of the answers `got` against the reference's `want`."""
    closest = []
    for (hit_g, t_g), (hit_w, t_w) in zip(got["closest"], want["closest"]):
        t_g, t_w = t_g.double(), t_w.double().to(t_g.device)
        hit_w = hit_w.to(hit_g.device)
        apart = (t_g - t_w).abs() > T_REL * torch.clamp(t_w.abs(), min=1.0)
        closest.append((hit_g != hit_w) | (hit_g & hit_w & apart))
    occluded = [g != w.to(g.device)
                for g, w in zip(got["occluded"], want["occluded"])]
    acc_g, count_g, idx_g = got["state"]
    acc_w, count_w, idx_w = want["state"]
    acc_w = acc_w.double().to(acc_g.device)
    state = float(((acc_g.double() - acc_w).abs()
                   / torch.clamp(acc_w.abs(), min=1.0)).max())
    state = max(state, abs(count_g - count_w), abs(idx_g - idx_w))
    seen = (len(got["denoised"]) == len(want["denoised"]) == 2
            and len(got["closest"]) == len(want["closest"]) > 0
            and len(got["occluded"]) == len(want["occluded"]) > 0)
    denoise = max(_max_abs(g, w) for g, w in zip(got["denoised"],
                                                  want["denoised"]))
    return {
        "ray_max_abs": max(_max_abs(got["rays"][0], want["rays"][0]),
                           _max_abs(got["rays"][1], want["rays"][1])),
        "closest_mismatch": _share(closest),
        "occluded_mismatch": _share(occluded),
        "denoise_max_abs": denoise if seen else math.inf,
        "image_max_abs": _max_abs(got["image"], want["image"]),
        "state_max_rel": state,
        "light_mismatch": light_mismatch(got, want),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or below its limit; a number with no limit fails."""
    rows, ok = {}, True
    for name in NUMBERS:
        value = values.get(name, math.nan)
        limit = limits.get(name)
        rows[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) \
            and value <= limit
    return ok, rows


def compare(ref, record: Record, out: dict, state, prev, index: int,
            want: dict | None = None) -> dict:
    """The numbers of the program's frame `index` against `ref` (or its
    answers `want`, where they are at hand)."""
    if want is None:
        want = reference_answers(ref, record, out, prev, index)
    return readings(program_answers(record, out, state, prev), want)


def control_readings(ctl, want: dict, record: Record, out: dict, prev,
                     index: int) -> dict:
    """The control's numbers: the reference in TF32 (`ctl`) in the
    program's place, against the reference's answers `want` for the same
    frame and inputs."""
    return readings(reference_answers(ctl, record, out, prev, index), want)
