"""Ray-AABB and ray-triangle intersection primitives (port of
eidola_tpu/ops/intersect.py; ref shaders/traceray_rq.glsl:108-147).

Branch-free tensor code over a flat ray stream.  `ray_triangle` re-tests
last frame's triangle for `primary_seed` (render/direct.py);
`brute_force_closest` is the O(R*T) oracle a traversal is held against.
"""
from __future__ import annotations

import torch

from .math import cross, dot3

_HUGE = 1e30


def safe_inv_dir(d, eps: float = 1e-12):
    """Reciprocal direction with zero-component protection for slab tests."""
    s = torch.where(d >= 0.0, 1.0, -1.0)
    return s / torch.clamp(torch.abs(d), min=eps)


def ray_aabb(o, inv_d, t_min, t_max, bmin, bmax):
    """Slab test; every argument broadcasts.  o, inv_d, bmin, bmax:
    (..., 3); t_min, t_max: (...,).  Returns (hit mask, t_near)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max)
    return hit, t_near


def ray_triangle(o, d, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore with precomputed edges e1 = v1-v0, e2 = v2-v0,
    double-sided.  Returns (hit, t, u, v); t is 1e30 where there is no
    hit.  Degenerate (zero-edge) padding triangles never hit."""
    pvec = cross(d, e2)
    det = dot3(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
           & (t < t_max))
    return hit, torch.where(hit, t, _HUGE), u, v


def brute_force_closest(o, d, v0, e1, e2, t_min, t_max):
    """Closest hit of every ray against every triangle.  o, d: (R, 3);
    v0, e1, e2: (T, 3); t_min, t_max: (R,).  Returns (tri_id, t, u, v),
    tri_id -1 and t 1e30 on a miss; of equal t the lowest id wins."""
    hit, t, u, v = ray_triangle(o[:, None], d[:, None], v0[None], e1[None],
                                e2[None], t_min[:, None], t_max[:, None])
    best = torch.argmin(t, dim=1)
    r = torch.arange(o.shape[0], device=o.device)
    best_t = t[r, best]
    found = best_t < _HUGE * 0.5
    return (torch.where(found, best, -1), torch.where(found, best_t, _HUGE),
            u[r, best], v[r, best])
