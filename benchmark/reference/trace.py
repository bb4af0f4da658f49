"""Rays against every triangle of the scene: no acceleration structure.

A ray meets a triangle where its Pluecker products with the three edges
have one sign (or are zero) and the plane's distance lies in
(t_min, t_max).  Opaque triangles stop a ray; a leaf card stops it only
where its texture's alpha, bilinear at the hit, is at or above the
cutoff.  The march past leaf cards follows the frame's HitTest loop (the
reference renderer's shaders/traceray_rq.glsl): a closest-hit ray tests
at most `hops` leaf hits in front of the nearest opaque hit and takes
the next leaf hit after the last it passed, untested; a shadow ray tests
at most `hops + 1`.  After a passed hit at t the search goes on beyond
t * (1 + 1e-4) + 1e-5.
"""
from __future__ import annotations

import torch

INF = float("inf")
CANDIDATES = 8        # leaf hits kept a ray, nearest first
# ray x triangle products a pass, on the card and on the CPU
CHUNK = {"cuda": 1 << 25, "cpu": 1 << 21}


class Mesh:
    """Triangles (T, 3, 3) prepared for the products, in precision `num`."""

    def __init__(self, tris, num):
        v0, v1, v2 = (num(tris[:, k]) for k in range(3))
        self.n = num(torch.linalg.cross(v1 - v0, v2 - v0))
        self.n_v0 = num((self.n * v0).sum(-1))
        # Pluecker (moment, direction) of the edges v1->v2, v2->v0, v0->v1:
        # the products are the barycentric weights of v0, v1, v2 times a
        # common factor
        self.edges = [num(torch.cat([torch.linalg.cross(a, b - a), b - a],
                                    dim=-1))
                      for a, b in ((v1, v2), (v2, v0), (v0, v1))]
        self.count = tris.shape[0]

    def hits(self, o, d, t_min, t_max, num):
        """(t (R, T), weights (3, R, T)) with t = inf where the ray misses
        or the hit lies outside (t_min, t_max)."""
        ray = torch.cat([d, num(torch.linalg.cross(o, d))], dim=-1)
        w = torch.stack([num.mm(ray, e.T) for e in self.edges])
        dn = num.mm(d, self.n.T)
        t = (self.n_v0[None, :] - num.mm(o, self.n.T)) / dn
        inside = (((w >= 0).all(0) | (w <= 0).all(0)) & (w.sum(0) != 0)
                  & (dn != 0))
        ok = inside & (t > t_min[:, None]) & (t < t_max[:, None])
        return torch.where(ok, t, INF), w


def _bilinear(tex, uv):
    """Bilinear fetch of a repeat-wrapped (h, w) texture at uv (..., 2),
    texel centres at half-integers."""
    h, w = tex.shape
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.remainder(x0 + 1, w), torch.remainder(y0 + 1, h)
    x0, y0 = torch.remainder(x0, w), torch.remainder(y0, h)
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx) * (1 - fy)
            + (tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx) * fy)


class Tracer:
    def __init__(self, scene, hops: int, num):
        self.num = num
        self.hops = hops
        self.opaque = Mesh(scene.opaque, num)
        self.alpha = Mesh(scene.alpha, num)
        self.uv = num(scene.alpha_uv)
        self.tex = num(scene.leaf_alpha)
        self.cutoff = scene.cutoff

    def _chunks(self, n: int):
        chunk = CHUNK.get(self.tex.device.type, CHUNK["cpu"])
        step = max(1, chunk // max(self.opaque.count, self.alpha.count, 1))
        return [slice(i, min(i + step, n)) for i in range(0, n, step)]

    def _leaf_hits(self, o, d, t_min, t_max):
        """(t (R, K), passes (R, K)): the K nearest leaf hits in
        (t_min, t_max), and whether the alpha test lets the ray through."""
        num = self.num
        if not self.alpha.count:
            none = torch.full((o.shape[0], 1), INF, dtype=num.dtype,
                              device=o.device)
            return none, torch.zeros(none.shape, dtype=torch.bool,
                                     device=o.device)
        t, w = self.alpha.hits(o, d, t_min, t_max, num)
        k = min(CANDIDATES, t.shape[1])
        t, idx = torch.topk(t, k, dim=1, largest=False)
        w = torch.gather(w, 2, idx[None].expand(3, -1, -1))
        w = w / w.sum(0, keepdim=True)
        uv = num((w[..., None] * self.uv[idx].permute(2, 0, 1, 3)).sum(0))
        opacity = num(_bilinear(self.tex, uv))
        return t, opacity < self.cutoff

    def _march(self, t, passes, t_min, tests: int):
        """Walk the sorted leaf hits: (the hit taken (R,) or inf, whether
        a tested hit stopped the ray (R,))."""
        cur_min = t_min.clone()
        cur = torch.full_like(t_min, INF)
        stopped = torch.zeros(t_min.shape, dtype=torch.bool,
                              device=t.device)
        live = torch.ones_like(stopped)
        for hop in range(tests + 1):
            t_hit, first = torch.where(t > cur_min[:, None], t, INF).min(1)
            found = live & torch.isfinite(t_hit)
            cur = torch.where(live, t_hit, cur)
            if hop == tests:
                break
            through = passes.gather(1, first[:, None])[:, 0]
            stopped |= found & ~through
            live = found & through
            cur_min = torch.where(live, t_hit * (1.0 + 1e-4) + 1e-5, cur_min)
        return cur, stopped

    def closest(self, o, d, t_min, t_max):
        """(hit (R,), t (R,)) of rays (R, 3) in (t_min, t_max) (R,)."""
        num = self.num
        out_t = []
        for sl in self._chunks(o.shape[0]):
            oo, dd = num(o[sl]), num(d[sl])
            lo, hi = num(t_min[sl]), num(t_max[sl])
            t_op = self.opaque.hits(oo, dd, lo, hi, num)[0].min(1).values
            t, passes = self._leaf_hits(oo, dd, lo, torch.minimum(hi, t_op))
            # `hops` tested hits, then the next one taken untested
            t_leaf, _ = self._march(t, passes, lo, self.hops)
            out_t.append(torch.minimum(t_leaf, t_op))
        t = torch.cat(out_t)
        return torch.isfinite(t), t

    def occluded(self, o, d, t_min, t_max):
        """(R,) whether anything stops each ray in (t_min, t_max)."""
        num = self.num
        out = []
        for sl in self._chunks(o.shape[0]):
            oo, dd = num(o[sl]), num(d[sl])
            lo, hi = num(t_min[sl]), num(t_max[sl])
            t_op = self.opaque.hits(oo, dd, lo, hi, num)[0].min(1).values
            t, passes = self._leaf_hits(oo, dd, lo, hi)
            _, stopped = self._march(t, passes, lo, self.hops + 1)
            out.append(torch.isfinite(t_op) | stopped)
        return torch.cat(out)
