"""The Bistro stand-in, the scene of the `bistro_standin` configuration.

Written from the JAX package's models/scenes.py:standin_parts, whose
geometry part is frozen here (the street, four tessellated buildings and
two trees whose leaf cards are alpha-MASK tested, 729 lots of one
building and four trees at 2.83M triangles).  The scene is generated
from fixed numpy seeds, so the benchmark makes it itself, as a benchmark
makes a model's weights.  The textures other than the leaf's alpha are
left out: no number the check compares reads them.

`make(target_mtris=2.83)` gives the world-space triangles in float64
(each instance's 4x4 applied here, never the program's BVHs or
transforms), split into the opaque ones and the alpha-tested leaves, the
leaves' texture coordinates, the leaf texture's alpha and cutoff, and
the view (eye, center, vertical field of view in degrees), and its light:
the renderer's default sun and sky (lights/sunsky.py), whose numbers are
frozen here from the JAX package's scene/data.py:default_sunsky.  Its
materials emit nothing, so the sun and sky is the only light.
"""
from __future__ import annotations

import numpy as np
import torch

from ..scene import Standin

# the leaf material: alpha MASK at this cutoff, base colour alpha 1
LEAF_CUTOFF = 0.5
# the renderer's default sun and sky (scene/data.py:default_sunsky)
SUNSKY = {"sun_direction": [0.45, 0.78, 0.45], "sun_intensity": 1.0,
          "sun_angular_radius": 0.00465, "turbidity": 3.0,
          "ground_color": [0.4, 0.35, 0.3], "sky_tint": [1.0, 1.0, 1.0],
          "saturation": 1.0, "redblueshift": 0.0,
          "night_color": [0.0, 0.0, 0.01], "sun_glow_intensity": 1.0}


def quad_tris(p0, p1, p2, p3):
    p = [np.asarray(x, np.float32) for x in (p0, p1, p2, p3)]
    return np.stack([np.stack([p[0], p[1], p[2]]),
                     np.stack([p[0], p[2], p[3]])])


def box_grid_tris(center, half, sub: int):
    """A box with each face cut into sub x sub quads (float32)."""
    u = np.linspace(-1.0, 1.0, sub + 1)
    faces = []
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
        a, b = [i for i in range(3) if i != axis]
        ua, ub = np.meshgrid(u, u, indexing="ij")
        p = np.zeros((sub + 1, sub + 1, 3), np.float64)
        p[..., axis] = sign
        p[..., a] = ua
        p[..., b] = ub
        p00, p10, p01, p11 = p[:-1, :-1], p[1:, :-1], p[:-1, 1:], p[1:, 1:]
        t1 = np.stack([p00, p10, p11], axis=2).reshape(-1, 3, 3)
        t2 = np.stack([p00, p11, p01], axis=2).reshape(-1, 3, 3)
        faces.append(np.concatenate([t1, t2]))
    tris = np.concatenate(faces) * np.asarray(half) + np.asarray(center)
    return tris.astype(np.float32)


def tree(rng, n_leaves: int = 256):
    """(trunk triangles, leaf triangles, leaf uvs) of one tree, drawing
    from `rng` in the generator's order."""
    trunk = box_grid_tris([0, 1.1, 0], [0.13, 1.1, 0.13], sub=2)
    c = np.asarray([0.0, 2.5, 0.0], np.float32)
    rr = 1.25 * (0.45 + 0.55 * rng.random(n_leaves) ** 0.5)
    th = np.arccos(rng.uniform(-1, 1, n_leaves))
    ph = rng.uniform(0, 2 * np.pi, n_leaves)
    p = c + (rr[:, None] * np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1
    )).astype(np.float32)
    u = rng.normal(size=(n_leaves, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(n_leaves, 3)).astype(np.float32)
    v = np.cross(u, w)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    s = (0.22 + 0.16 * rng.random(n_leaves))[:, None].astype(np.float32)
    p00, p10 = p - u * s - v * s, p + u * s - v * s
    p11, p01 = p + u * s + v * s, p - u * s + v * s
    leaves = np.concatenate([np.stack([p00, p10, p11], axis=1),
                             np.stack([p00, p11, p01], axis=1)])
    uv = np.concatenate([
        np.tile(np.asarray([[0, 0], [1, 0], [1, 1]], np.float32),
                (n_leaves, 1, 1)),
        np.tile(np.asarray([[0, 0], [1, 1], [0, 1]], np.float32),
                (n_leaves, 1, 1))])
    return trunk, leaves, uv


def leaf_alpha():
    """The leaf texture's alpha: an ellipse cut-out of a 64x64 card."""
    ly, lx = np.mgrid[0:64, 0:64]
    ex, ey = (lx - 31.5) / 26.0, (ly - 31.5) / 30.0
    return ((ex * ex + ey * ey) < 1.0).astype(np.float64)


def yaw(t, s, x, y, z):
    c_, s_ = np.cos(t), np.sin(t)
    return np.asarray([[c_ * s, 0, s_ * s, x], [0, s, 0, y],
                       [-s_ * s, 0, c_ * s, z], [0, 0, 0, 1]], np.float64)


def standin(target_mtris: float = 2.83, *, device) -> Standin:
    rng = np.random.default_rng(7)
    target = int(target_mtris * 1e6)
    street = quad_tris([-140, 0, -140], [140, 0, -140], [140, 0, 140],
                       [-140, 0, 140])
    buildings = [box_grid_tris([0, (5.0 + 2.5 * k) / 2, 0],
                               [2.2 + 0.5 * k, (5.0 + 2.5 * k) / 2,
                                2.2 + 0.5 * k], sub=12) for k in range(4)]
    trees = [tree(rng) for _ in range(2)]
    per_tree = trees[0][0].shape[0] + trees[0][1].shape[0]
    n_lots = int(np.ceil(np.sqrt(
        target / (buildings[0].shape[0] + 4 * per_tree))))

    # (mesh, 4x4): meshes 0 street, 1-4 buildings, 5-6 trees, in the
    # generator's order of draws
    instances = [(0, np.eye(4))]
    lot = 10.0
    for i in range(n_lots):
        for j in range(n_lots):
            x = (i - n_lots / 2) * lot + rng.uniform(-1, 1)
            z = (j - n_lots / 2) * lot + rng.uniform(-1, 1)
            b = 1 + (i * 7 + j * 3) % 4
            instances.append((b, yaw(0.5 * np.pi * ((i + j) % 4),
                                     rng.uniform(0.85, 1.25), x, 0.0, z)))
            for _ in range(4):
                tx = x + rng.uniform(-lot / 2, lot / 2)
                tz = z + rng.uniform(-lot / 2, lot / 2)
                instances.append((5 + rng.integers(2),
                                  yaw(rng.uniform(0, 2 * np.pi),
                                      rng.uniform(0.7, 1.5), tx, 0.0, tz)))

    f64 = dict(dtype=torch.float64, device=device)
    opaque_mesh = [street] + buildings + [t[0] for t in trees]
    opaque_mesh = [torch.as_tensor(m, **f64) for m in opaque_mesh]
    leaf_mesh = {5: torch.as_tensor(trees[0][1], **f64),
                 6: torch.as_tensor(trees[1][1], **f64)}
    opaque, alpha, alpha_uv = [], [], []
    uv = {5: trees[0][2], 6: trees[1][2]}
    for mesh, m in instances:
        m = torch.as_tensor(m, **f64)
        rot, shift = m[:3, :3], m[:3, 3]
        opaque.append(opaque_mesh[mesh] @ rot.T + shift)
        if mesh in leaf_mesh:
            alpha.append(leaf_mesh[mesh] @ rot.T + shift)
            alpha_uv.append(torch.as_tensor(uv[mesh], **f64))
    view = ([0.0, 5.5, n_lots * lot * 0.52], [0.0, 3.0, 0.0], 55.0)
    return Standin(opaque=torch.cat(opaque), alpha=torch.cat(alpha),
                   alpha_uv=torch.cat(alpha_uv),
                   leaf_alpha=torch.as_tensor(leaf_alpha(), **f64),
                   cutoff=LEAF_CUTOFF, view=view, light=("sunsky", SUNSKY),
                   emitters=0)


def make(*, device, target_mtris: float = 2.83) -> Standin:
    return standin(target_mtris, device=device)
