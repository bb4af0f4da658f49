"""Procedural scenes + registry (port of eidola_tpu/models/scenes.py,
all eleven: cornell, boxes, punctual, textured, hdr, stress, alpha,
mini_grove, bistro_flat, bistro_standin, bistro_hdr)."""
from __future__ import annotations

import numpy as np
import torch

from ..scene.camera import Camera, make_camera
from ..scene.data import (ALPHA_MASK, SceneData, attach_env, default_sunsky,
                          upload_scene, upload_scene_instanced)
from ..scene.gltf import load_gltf_scene, write_glb
from ..scene.hdr import build_env_map

_FACES = [
    (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
    (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
    (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),
]


def box_tris(center, half):
    """12 triangles of an axis-aligned box, outward winding."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half, np.float32)
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        np.float32) * h + c
    return np.stack([corners[list(f)] for f in _FACES])


def quad_tris(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (ccw)."""
    p = [np.asarray(x, np.float32) for x in (p0, p1, p2, p3)]
    return np.stack([np.stack([p[0], p[1], p[2]]),
                     np.stack([p[0], p[2], p[3]])])


def uv_sphere(center, radius, n_lat=16, n_lon=24):
    c = np.asarray(center, np.float32)
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    pts = np.stack([
        np.outer(np.sin(lat), np.cos(lon)),
        np.outer(np.cos(lat), np.ones_like(lon)),
        np.outer(np.sin(lat), np.sin(lon)),
    ], axis=-1)
    v = c + radius * pts
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = v[i, j], v[i, j + 1]
            d, e = v[i + 1, j], v[i + 1, j + 1]
            if i > 0:
                tris.append(np.stack([a, b, d]))
            if i < n_lat - 1:
                tris.append(np.stack([b, e, d]))
    return np.stack(tris).astype(np.float32)


def box_grid_tris(center, half, sub: int = 8):
    """Box with each face tessellated into sub x sub quads."""
    cx, cy, cz = center
    hx, hy, hz = half
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
    tris = np.concatenate(faces)
    tris = tris * np.asarray([hx, hy, hz]) + np.asarray([cx, cy, cz])
    return tris.astype(np.float32)


def box_grid_mesh(center, half, sub: int = 8, uv_tile: float = 1.0):
    """box_grid_tris plus per-face planar UVs (each face maps its in-plane
    axes to [0, uv_tile]^2)."""
    tris = box_grid_tris(center, half, sub=sub)
    n_face = sub * sub * 2
    uvs = np.zeros((tris.shape[0], 3, 2), np.float32)
    c = np.asarray(center, np.float32)
    h = np.asarray(half, np.float32)
    for f, axis in enumerate((0, 0, 1, 1, 2, 2)):
        a, b = [i for i in range(3) if i != axis]
        sl = slice(f * n_face, (f + 1) * n_face)
        t = tris[sl]
        uvs[sl, :, 0] = (t[..., a] - c[a] + h[a]) / (2 * h[a]) * uv_tile
        uvs[sl, :, 1] = (t[..., b] - c[b] + h[b]) / (2 * h[b]) * uv_tile
    return tris, uvs


def _tree_mesh(rng, n_leaves: int = 256, bark_mat: int = 3,
               leaf_mat: int = 4):
    """Procedural tree: a tessellated trunk and a canopy of randomly
    oriented leaf quads with an alpha-MASK texture (the foliage workload:
    an alpha test per candidate hit).  A mesh dict for
    upload_scene_instanced."""
    trunk, trunk_uv = box_grid_mesh([0, 1.1, 0], [0.13, 1.1, 0.13],
                                    sub=2, uv_tile=2.0)
    c = np.asarray([0.0, 2.5, 0.0], np.float32)
    R = 1.25
    rr = R * (0.45 + 0.55 * rng.random(n_leaves) ** 0.5)
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
    p00 = p - u * s - v * s
    p10 = p + u * s - v * s
    p11 = p + u * s + v * s
    p01 = p - u * s + v * s
    leaf_tris = np.concatenate([np.stack([p00, p10, p11], axis=1),
                                np.stack([p00, p11, p01], axis=1)])
    uv1 = np.tile(np.asarray([[0, 0], [1, 0], [1, 1]], np.float32),
                  (n_leaves, 1, 1))
    uv2 = np.tile(np.asarray([[0, 0], [1, 1], [0, 1]], np.float32),
                  (n_leaves, 1, 1))
    tris = np.concatenate([trunk, leaf_tris])
    mats = np.concatenate([np.full(trunk.shape[0], bark_mat, np.int32),
                           np.full(leaf_tris.shape[0], leaf_mat, np.int32)])
    return {"v0": tris[:, 0], "v1": tris[:, 1], "v2": tris[:, 2],
            "uvs": np.concatenate([trunk_uv, uv1, uv2]), "mat_ids": mats}


def _bench_textures():
    """Procedural textures of the headline scene: brick with its normal
    map, plaster, asphalt, bark and an alpha-cutout leaf."""
    rng = np.random.default_rng(99)

    def noise(h, w, lo, hi):
        return (lo + (hi - lo) * rng.random((h, w)))[..., None]

    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w]
    row = yy // 16
    xoff = (xx + (row % 2) * 16) % 32
    mortar = ((yy % 16) < 2) | (xoff < 2)
    height = np.where(mortar, 0.0, 1.0).astype(np.float32)
    height += 0.15 * rng.random((h, w)).astype(np.float32)
    brick = np.zeros((h, w, 4), np.float32)
    shade = 0.75 + 0.25 * rng.random((h // 16 + 1, w // 32 + 2))
    bshade = shade[row, (xx + (row % 2) * 16) // 32]
    brick[..., 0] = np.where(mortar, 0.62, 0.55 * bshade)
    brick[..., 1] = np.where(mortar, 0.60, 0.28 * bshade)
    brick[..., 2] = np.where(mortar, 0.57, 0.22 * bshade)
    brick[..., 3] = 1.0
    gx = np.roll(height, -1, 1) - np.roll(height, 1, 1)
    gy = np.roll(height, -1, 0) - np.roll(height, 1, 0)
    nz = np.ones_like(gx) * 0.6
    nl = np.sqrt(gx * gx + gy * gy + nz * nz)
    brick_nrm = np.zeros((h, w, 4), np.float32)
    brick_nrm[..., 0] = (-gx / nl) * 0.5 + 0.5
    brick_nrm[..., 1] = (-gy / nl) * 0.5 + 0.5
    brick_nrm[..., 2] = (nz / nl) * 0.5 + 0.5
    brick_nrm[..., 3] = 1.0

    plaster = np.concatenate(
        [noise(128, 128, 0.55, 0.66), noise(128, 128, 0.56, 0.64),
         noise(128, 128, 0.58, 0.70), np.ones((128, 128, 1), np.float32)],
        axis=-1).astype(np.float32)

    asphalt = np.zeros((128, 128, 4), np.float32)
    g = 0.22 + 0.1 * rng.random((128, 128))
    lane = (np.abs(np.arange(128) - 64) < 2)[None, :] & \
        ((np.arange(128) % 32) < 20)[:, None]
    asphalt[..., 0] = np.where(lane, 0.7, g)
    asphalt[..., 1] = np.where(lane, 0.66, g)
    asphalt[..., 2] = np.where(lane, 0.5, g * 1.05)
    asphalt[..., 3] = 1.0

    bark = np.zeros((64, 64, 4), np.float32)
    bx = np.arange(64)[None, :]
    stripe = 0.5 + 0.5 * np.sin(bx * 1.1 + rng.random((64, 1)) * 3)
    bb = 0.18 + 0.12 * stripe + 0.06 * rng.random((64, 64))
    bark[..., 0] = bb * 1.4
    bark[..., 1] = bb
    bark[..., 2] = bb * 0.6
    bark[..., 3] = 1.0

    # leaf: elliptical alpha cutout + midrib (about half the texels below
    # the 0.5 cutoff, like real foliage cards)
    lh = lw = 64
    ly, lx = np.mgrid[0:lh, 0:lw]
    ex = (lx - 31.5) / 26.0
    ey = (ly - 31.5) / 30.0
    inside = (ex * ex + ey * ey) < 1.0
    leaf = np.zeros((lh, lw, 4), np.float32)
    vein = np.abs(lx - 31.5) < 1.5
    gshade = 0.25 + 0.3 * rng.random((lh, lw)) + 0.15 * vein
    leaf[..., 0] = 0.08 + 0.08 * gshade
    leaf[..., 1] = 0.30 + 0.35 * gshade
    leaf[..., 2] = 0.05 + 0.06 * gshade
    leaf[..., 3] = inside.astype(np.float32)

    return {"asphalt": asphalt, "brick": brick, "plaster": plaster,
            "bark": bark, "leaf": leaf, "brick_nrm": brick_nrm}


def _concat(parts):
    tris = np.concatenate([p for p, _ in parts])
    mats = np.concatenate([np.full(p.shape[0], m, np.int32) for p, m in parts])
    return tris, mats


def cornell_box(light_scale: float = 1.0, *, device):
    """Cornell-style box with an emissive ceiling quad."""
    white = {"base_color": [0.73, 0.73, 0.73, 1.0], "roughness": 0.9}
    red = {"base_color": [0.65, 0.05, 0.05, 1.0], "roughness": 0.9}
    green = {"base_color": [0.12, 0.45, 0.15, 1.0], "roughness": 0.9}
    metal = {"base_color": [0.8, 0.8, 0.85, 1.0], "metallic": 0.9,
             "roughness": 0.15}
    light = {"base_color": [1, 1, 1, 1],
             "emissive": [17.0 * light_scale, 12.0 * light_scale,
                          4.0 * light_scale]}
    s = 1.0
    parts = [
        (quad_tris([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]), 0),
        (quad_tris([-s, 2 * s, s], [s, 2 * s, s], [s, 2 * s, -s],
                   [-s, 2 * s, -s]), 0),
        (quad_tris([-s, 0, -s], [-s, 2 * s, -s], [s, 2 * s, -s],
                   [s, 0, -s]), 0),
        (quad_tris([-s, 0, s], [-s, 2 * s, s], [-s, 2 * s, -s],
                   [-s, 0, -s]), 1),
        (quad_tris([s, 0, -s], [s, 2 * s, -s], [s, 2 * s, s], [s, 0, s]), 2),
        (box_tris([-0.35, 0.6, -0.3], [0.28, 0.6, 0.28]), 3),
        (box_tris([0.4, 0.25, 0.35], [0.25, 0.25, 0.25]), 0),
        (quad_tris([-0.4, 1.98, 0.4], [0.4, 1.98, 0.4], [0.4, 1.98, -0.4],
                   [-0.4, 1.98, -0.4]), 4),
    ]
    tris, mats = _concat(parts)
    scene = upload_scene(
        tris[:, 0], tris[:, 1], tris[:, 2], device=device,
        mat_ids=mats, materials=[white, red, green, metal, light],
        sunsky=default_sunsky()._replace(enabled=np.int32(0)),
    )
    cam = make_camera(eye=[0, 1.0, 3.6], center=[0, 1.0, 0], fovy_deg=45.0,
                      device=device)
    return scene, cam


def boxes_sunsky(*, device):
    """Outdoor boxes under procedural sun & sky (no area lights)."""
    ground = {"base_color": [0.55, 0.55, 0.5, 1.0], "roughness": 0.95}
    blue = {"base_color": [0.2, 0.3, 0.8, 1.0], "roughness": 0.4}
    gold = {"base_color": [1.0, 0.77, 0.34, 1.0], "metallic": 1.0,
            "roughness": 0.25}
    parts = [
        (quad_tris([-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]), 0),
        (box_tris([-0.9, 1.0, 0], [0.5, 1.0, 0.5]), 1),
        (box_tris([0.9, 0.5, 0.4], [0.5, 0.5, 0.5]), 2),
        (uv_sphere([0.1, 0.45, -1.2], 0.45), 1),
    ]
    tris, mats = _concat(parts)
    scene = upload_scene(tris[:, 0], tris[:, 1], tris[:, 2], device=device,
                         mat_ids=mats, materials=[ground, blue, gold])
    cam = make_camera(eye=[0, 1.6, 4.5], center=[0, 0.8, 0], fovy_deg=50.0,
                      device=device)
    return scene, cam


def punctual_demo(*, device):
    """Point lights, no environment."""
    white = {"base_color": [0.8, 0.8, 0.8, 1.0], "roughness": 0.7}
    shiny = {"base_color": [0.9, 0.4, 0.3, 1.0], "metallic": 0.3,
             "roughness": 0.3}
    parts = [
        (quad_tris([-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]), 0),
        (quad_tris([-4, 0, -2.5], [-4, 4, -2.5], [4, 4, -2.5],
                   [4, 0, -2.5]), 0),
        (uv_sphere([-0.8, 0.6, 0], 0.6), 1),
        (box_tris([0.9, 0.5, 0.3], [0.45, 0.5, 0.45]), 0),
    ]
    tris, mats = _concat(parts)
    punctual = {
        "pos": np.asarray([[2.0, 3.0, 2.0], [-2.5, 2.0, 1.0]], np.float32),
        "color": np.asarray([[60.0, 55.0, 50.0], [20.0, 30.0, 60.0]],
                            np.float32),
        "type": np.asarray([0, 0], np.int32),
    }
    scene = upload_scene(
        tris[:, 0], tris[:, 1], tris[:, 2], device=device,
        mat_ids=mats, materials=[white, shiny], punctual=punctual,
        sunsky=default_sunsky()._replace(enabled=np.int32(0)),
    )
    cam = make_camera(eye=[0, 1.5, 4.0], center=[0, 0.7, 0], fovy_deg=50.0,
                      device=device)
    return scene, cam


def textured_demo(*, device):
    """Checkerboard-textured floor + striped box under sun & sky."""
    check = np.zeros((64, 64, 4), np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    c = ((yy // 8 + xx // 8) % 2).astype(np.float32)
    check[..., 0] = 0.15 + 0.7 * c
    check[..., 1] = 0.15 + 0.55 * c
    check[..., 2] = 0.15 + 0.35 * c
    check[..., 3] = 1.0
    stripes = np.zeros((32, 32, 4), np.float32)
    stripes[..., 0] = 0.9
    stripes[..., 1] = np.where((np.arange(32) // 4 % 2)[None, :], 0.7, 0.2)
    stripes[..., 2] = 0.2
    stripes[..., 3] = 1.0

    floor = quad_tris([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6])
    box = box_tris([0, 0.75, 0], [0.75, 0.75, 0.75])
    tris = np.concatenate([floor, box])
    mats = np.concatenate([np.zeros(floor.shape[0], np.int32),
                           np.ones(box.shape[0], np.int32)])
    uvs = np.zeros((tris.shape[0], 3, 2), np.float32)
    uvs[:2] = (tris[:2][..., [0, 2]] + 6.0) / 12.0 * 4.0
    uvs[2:] = (tris[2:][..., [0, 1]] + 1.5) / 3.0
    scene = upload_scene(
        tris[:, 0], tris[:, 1], tris[:, 2], device=device, uvs=uvs,
        mat_ids=mats,
        materials=[
            {"base_color": [1, 1, 1, 1], "roughness": 0.85, "base_tex": 0},
            {"base_color": [1, 1, 1, 1], "roughness": 0.35, "base_tex": 1},
        ],
        textures=[check, stripes],
    )
    cam = make_camera(eye=[3.2, 2.4, 4.2], center=[0, 0.6, 0], fovy_deg=45.0,
                      device=device)
    return scene, cam


def hdr_env_demo(*, device):
    """Boxes under a procedural HDR environment map (sun blob + sky
    gradient): the alias-map environment sampling path (env_mode='hdr')."""
    h, w = 32, 64
    yy = np.linspace(0, np.pi, h)[:, None]
    xx = np.linspace(0, 2 * np.pi, w)[None, :]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 2] = 0.4 + 0.3 * np.cos(yy) * np.ones_like(xx)
    img[..., 1] = 0.3
    img[..., 0] = 0.25
    sun = np.exp(-(((yy - 0.9) ** 2) + (xx - 1.5) ** 2) * 40.0)
    img[..., 0] += 120.0 * sun
    img[..., 1] += 100.0 * sun
    img[..., 2] += 60.0 * sun

    ground = {"base_color": [0.6, 0.6, 0.55, 1.0], "roughness": 0.9}
    shiny = {"base_color": [0.85, 0.3, 0.25, 1.0], "metallic": 0.6,
             "roughness": 0.25}
    parts = [
        (quad_tris([-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]), 0),
        (box_tris([-0.8, 0.8, 0], [0.5, 0.8, 0.5]), 1),
        (uv_sphere([0.9, 0.5, 0.6], 0.5), 1),
    ]
    tris, mats = _concat(parts)
    scene = upload_scene(
        tris[:, 0], tris[:, 1], tris[:, 2], device=device,
        mat_ids=mats, materials=[ground, shiny],
        sunsky=default_sunsky()._replace(enabled=np.int32(0)),
    )
    scene = attach_env(scene, build_env_map(img, device=device))
    cam = make_camera(eye=[0, 1.6, 4.2], center=[0, 0.7, 0], fovy_deg=50.0,
                      device=device)
    return scene, cam


def stress_grid(n: int = 12, *, device):
    """n^2-sphere grid under sun&sky — triangle-count stress scene."""
    rng = np.random.default_rng(0)
    parts = [(quad_tris([-40, 0, -40], [40, 0, -40], [40, 0, 40],
                        [-40, 0, 40]), 0)]
    for i in range(n):
        for j in range(n):
            x = (i - n / 2) * 2.2
            z = (j - n / 2) * 2.2
            r = 0.4 + 0.5 * rng.random()
            parts.append((uv_sphere([x, r, z], r, n_lat=10, n_lon=14),
                          1 + (i + j) % 2))
    tris, mats = _concat(parts)
    mats_list = [
        {"base_color": [0.5, 0.5, 0.5, 1], "roughness": 0.9},
        {"base_color": [0.7, 0.3, 0.2, 1], "roughness": 0.4},
        {"base_color": [0.9, 0.85, 0.6, 1], "metallic": 0.8, "roughness": 0.3},
    ]
    scene = upload_scene(tris[:, 0], tris[:, 1], tris[:, 2], device=device,
                         mat_ids=mats, materials=mats_list)
    cam = make_camera(eye=[0, 6.0, 18.0], center=[0, 1.0, 0], fovy_deg=55.0,
                      device=device)
    return scene, cam


def bistro_flat(target_mtris: float = 2.83, *, device):
    """Untextured, single-BVH Bistro-class stand-in: 2.83M opaque
    triangles (street, tessellated buildings, foliage spheres) under
    sun & sky."""
    rng = np.random.default_rng(7)
    target = int(target_mtris * 1e6)
    parts = [(quad_tris([-120, 0, -120], [120, 0, -120], [120, 0, 120],
                        [-120, 0, 120]), 0)]
    lot = 9.0
    per_building = 6 * 8 * 8 * 2
    per_sphere = 2 * 14 * 20
    est_per_lot = per_building + 6 * per_sphere
    n_lots = int(np.ceil(np.sqrt(target / est_per_lot)))
    for i in range(n_lots):
        for j in range(n_lots):
            x = (i - n_lots / 2) * lot + rng.uniform(-1, 1)
            z = (j - n_lots / 2) * lot + rng.uniform(-1, 1)
            hgt = rng.uniform(3.0, 14.0)
            w = rng.uniform(2.0, 3.4)
            parts.append((box_grid_tris([x, hgt / 2, z], [w, hgt / 2, w],
                                        sub=8), 1 + (i + j) % 2))
            for _ in range(6):
                fx = x + rng.uniform(-lot / 2, lot / 2)
                fz = z + rng.uniform(-lot / 2, lot / 2)
                fr = rng.uniform(0.5, 1.3)
                parts.append((uv_sphere([fx, fr * rng.uniform(1.0, 2.5), fz],
                                        fr, n_lat=14, n_lon=20), 3))
    tris, mats = _concat(parts)
    mats_list = [
        {"base_color": [0.45, 0.44, 0.42, 1], "roughness": 0.9},
        {"base_color": [0.75, 0.62, 0.48, 1], "roughness": 0.7},
        {"base_color": [0.55, 0.57, 0.62, 1], "roughness": 0.4,
         "metallic": 0.3},
        {"base_color": [0.15, 0.42, 0.12, 1], "roughness": 0.8},
    ]
    scene = upload_scene(tris[:, 0], tris[:, 1], tris[:, 2], device=device,
                         mat_ids=mats, materials=mats_list)
    cam = make_camera(eye=[0.0, 9.0, n_lots * lot * 0.52],
                      center=[0.0, 3.0, 0.0], fovy_deg=55.0, device=device)
    return scene, cam


def standin_parts(target_mtris: float = 2.83):
    """What bistro_standin is made of, on the host: (meshes, instances,
    materials, textures, (eye, center, fovy_deg)) as
    upload_scene_instanced and make_camera take them.  Meshes: the
    street, four tessellated buildings and two trees (bark, then
    alpha-MASK leaf cards); one building and four trees per lot, lots
    enough for >= target_mtris million instanced triangles."""
    rng = np.random.default_rng(7)
    target = int(target_mtris * 1e6)
    tex = _bench_textures()
    tex_list = [tex["asphalt"], tex["brick"], tex["plaster"], tex["bark"],
                tex["leaf"], tex["brick_nrm"]]
    materials = [
        {"base_color": [1, 1, 1, 1], "roughness": 0.9, "base_tex": 0},
        {"base_color": [1, 1, 1, 1], "roughness": 0.7, "base_tex": 1,
         "normal_tex": 5},
        {"base_color": [1, 1, 1, 1], "roughness": 0.45, "metallic": 0.2,
         "base_tex": 2, "normal_tex": 5},
        {"base_color": [1, 1, 1, 1], "roughness": 0.85, "base_tex": 3},
        {"base_color": [1, 1, 1, 1], "roughness": 0.7, "base_tex": 4,
         "alpha_mode": ALPHA_MASK, "alpha_cutoff": 0.5},
    ]

    gt = quad_tris([-140, 0, -140], [140, 0, -140], [140, 0, 140],
                   [-140, 0, 140])
    guv = np.zeros((2, 3, 2), np.float32)
    guv[:] = (gt[..., [0, 2]] + 140.0) / 280.0 * 70.0
    meshes = [{"v0": gt[:, 0], "v1": gt[:, 1], "v2": gt[:, 2], "uvs": guv,
               "mat_ids": np.zeros(2, np.int32)}]          # 0: street
    building_ids = []
    for k in range(4):
        w = 2.2 + 0.5 * k
        hgt = 5.0 + 2.5 * k
        tris, uvs = box_grid_mesh([0, hgt / 2, 0], [w, hgt / 2, w],
                                  sub=12, uv_tile=3.0 + k)
        building_ids.append(len(meshes))
        meshes.append({"v0": tris[:, 0], "v1": tris[:, 1], "v2": tris[:, 2],
                       "uvs": uvs,
                       "mat_ids": np.full(tris.shape[0], 1 + k % 2,
                                          np.int32)})
    tree_ids = []
    for _ in range(2):
        tree_ids.append(len(meshes))
        meshes.append(_tree_mesh(rng, n_leaves=256))

    per_building = int(meshes[building_ids[0]]["v0"].shape[0])  # 1728
    per_tree = int(meshes[tree_ids[0]]["v0"].shape[0])          # ~560
    trees_per_lot = 4
    n_lots = int(np.ceil(np.sqrt(
        target / (per_building + trees_per_lot * per_tree))))

    def yaw(t, s, x, y, z):
        c_, s_ = np.cos(t), np.sin(t)
        return np.asarray([[c_ * s, 0, s_ * s, x], [0, s, 0, y],
                           [-s_ * s, 0, c_ * s, z], [0, 0, 0, 1]],
                          np.float64)

    instances = [(0, np.eye(4))]
    lot = 10.0
    for i in range(n_lots):
        for j in range(n_lots):
            x = (i - n_lots / 2) * lot + rng.uniform(-1, 1)
            z = (j - n_lots / 2) * lot + rng.uniform(-1, 1)
            b = building_ids[(i * 7 + j * 3) % 4]
            instances.append((b, yaw(0.5 * np.pi * ((i + j) % 4),
                                     rng.uniform(0.85, 1.25), x, 0.0, z)))
            for _ in range(trees_per_lot):
                tx = x + rng.uniform(-lot / 2, lot / 2)
                tz = z + rng.uniform(-lot / 2, lot / 2)
                instances.append((tree_ids[rng.integers(2)],
                                  yaw(rng.uniform(0, 2 * np.pi),
                                      rng.uniform(0.7, 1.5), tx, 0.0, tz)))

    view = ([0.0, 5.5, n_lots * lot * 0.52], [0.0, 3.0, 0.0], 55.0)
    return meshes, instances, materials, tex_list, view


def bistro_standin(target_mtris: float = 2.83, *, device):
    """The JAX bench's headline scene: >= target_mtris million instanced
    triangles of textured tessellated buildings (base colour + normal
    maps), instanced trees with alpha-MASK leaf cards and a textured
    street, viewed down a street canyon under sun & sky."""
    meshes, instances, materials, textures, (eye, center, fovy) = \
        standin_parts(target_mtris)
    scene = upload_scene_instanced(meshes, instances, device=device,
                                   materials=materials, textures=textures)
    return scene, make_camera(eye=eye, center=center, fovy_deg=fovy,
                              device=device)


def write_standin_glb(path: str, target_mtris: float = 2.83) -> int:
    """bistro_standin's parts as a GLB (scene/gltf.py:write_glb): one glTF
    mesh per part, one primitive per material, one node per instance,
    PNG textures, the scene's camera.  Returns the file's size."""
    meshes, instances, materials, textures, view = standin_parts(
        target_mtris)
    return write_glb(path, meshes, instances, materials, textures, view)


def alpha_demo(*, device):
    """An alpha-MASK cutout screen in front of a box under sun & sky."""
    tex = np.ones((32, 32, 4), np.float32)
    yy, xx = np.mgrid[0:32, 0:32]
    tex[..., 3] = ((yy // 4 + xx // 4) % 2).astype(np.float32)
    tex[..., :3] = np.asarray([0.2, 0.6, 0.3])

    screen = quad_tris([-1.5, 0, 1.2], [1.5, 0, 1.2], [1.5, 2.4, 1.2],
                       [-1.5, 2.4, 1.2])
    box = box_tris([0, 0.6, -0.6], [0.6, 0.6, 0.6])
    floor = quad_tris([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6])
    tris = np.concatenate([screen, box, floor])
    mats = np.concatenate([np.zeros(screen.shape[0], np.int32),
                           np.ones(box.shape[0], np.int32),
                           np.full(floor.shape[0], 2, np.int32)])
    uvs = np.zeros((tris.shape[0], 3, 2), np.float32)
    uvs[:2] = (screen[..., [0, 1]] + 1.5) / 3.0
    scene = upload_scene(
        tris[:, 0], tris[:, 1], tris[:, 2], device=device, uvs=uvs,
        mat_ids=mats,
        materials=[
            {"base_color": [1, 1, 1, 1], "base_tex": 0,
             "alpha_mode": ALPHA_MASK, "alpha_cutoff": 0.5},
            {"base_color": [0.7, 0.25, 0.2, 1.0], "roughness": 0.5},
            {"base_color": [0.6, 0.6, 0.6, 1.0], "roughness": 0.9},
        ],
        textures=[tex])
    cam = make_camera(eye=[0, 1.4, 4.6], center=[0, 0.9, 0], fovy_deg=45.0,
                      device=device)
    return scene, cam


def bistro_hdr(target_mtris: float = 2.83, *, device):
    """bistro_standin under a procedural HDR environment (sun disk and
    glow, sky gradient, horizon band) with the sky model off."""
    scene, cam = bistro_standin(target_mtris, device=device)
    h, w = 128, 256
    yy = np.linspace(0, np.pi, h)[:, None] * np.ones((1, w))
    xx = np.linspace(0, 2 * np.pi, w)[None, :] * np.ones((h, 1))
    img = np.zeros((h, w, 3), np.float32)
    sky_t = np.clip(np.cos(yy), 0.0, 1.0)
    img[..., 0] = 0.20 + 0.10 * sky_t
    img[..., 1] = 0.28 + 0.18 * sky_t
    img[..., 2] = 0.45 + 0.35 * sky_t
    horizon = np.exp(-((yy - np.pi / 2) ** 2) * 18.0)
    img += horizon[..., None] * np.asarray([0.5, 0.38, 0.25], np.float32)
    ang = np.arccos(np.clip(
        np.sin(yy) * np.sin(0.95) * np.cos(xx - 1.2)
        + np.cos(yy) * np.cos(0.95), -1, 1))
    img += (np.exp(-(ang / 0.03) ** 2)[..., None]
            * np.asarray([18000.0, 15000.0, 9000.0], np.float32))
    img += (np.exp(-(ang / 0.3) ** 2)[..., None]
            * np.asarray([40.0, 30.0, 15.0], np.float32))
    scene = scene._replace(sunsky=scene.sunsky._replace(
        enabled=torch.zeros_like(scene.sunsky.enabled)))
    scene = attach_env(scene, build_env_map(img.astype(np.float32),
                                            device=device))
    return scene, cam


def mini_grove(*, device):
    """A few instanced trees with alpha-MASK leaf cards on a ground quad:
    the smallest scene with the opaque/alpha split, the instanced walk
    and the HitTest march at once."""
    rng = np.random.default_rng(5)
    tex = np.ones((8, 8, 4), np.float32)
    yy, xx = np.mgrid[0:8, 0:8]
    tex[..., 3] = (((yy + xx) % 2) == 0).astype(np.float32)
    tex[..., :3] = np.asarray([0.15, 0.5, 0.2])
    materials = [
        {"base_color": [0.6, 0.6, 0.6, 1.0], "roughness": 0.9},   # ground
        {"base_color": [0.5, 0.5, 0.5, 1.0]},                     # unused
        {"base_color": [0.5, 0.5, 0.5, 1.0]},                     # unused
        {"base_color": [0.45, 0.3, 0.2, 1.0], "roughness": 0.8},  # bark
        {"base_color": [1, 1, 1, 1], "base_tex": 0,               # leaves
         "alpha_mode": ALPHA_MASK, "alpha_cutoff": 0.5},
    ]
    gt = quad_tris([-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8])
    meshes = [{"v0": gt[:, 0], "v1": gt[:, 1], "v2": gt[:, 2],
               "mat_ids": np.zeros(2, np.int32)}]
    for _ in range(2):
        meshes.append(_tree_mesh(rng, n_leaves=24))
    instances = [(0, np.eye(4))]
    for k in range(4):
        t = np.eye(4)
        t[0, 3] = -3.0 + 2.0 * k
        t[2, 3] = rng.uniform(-2, 2)
        instances.append((1 + k % 2, t))
    scene = upload_scene_instanced(meshes, instances, device=device,
                                   materials=materials, textures=[tex])
    cam = make_camera(eye=[0, 2.5, 7.0], center=[0, 1.8, 0], fovy_deg=50.0,
                      device=device)
    return scene, cam


_REGISTRY = {
    "cornell": cornell_box,
    "boxes": boxes_sunsky,
    "punctual": punctual_demo,
    "textured": textured_demo,
    "hdr": hdr_env_demo,
    "stress": stress_grid,
    "alpha": alpha_demo,
    "mini_grove": mini_grove,
    "bistro_flat": bistro_flat,
    "bistro_standin": bistro_standin,
    "bistro_hdr": bistro_hdr,
}


def load_scene(name: str, *, device, **kwargs) -> tuple[SceneData, Camera]:
    """Scene front door: registry name or a .gltf/.glb path (ref
    SampleExample::loadScene, sample_example.cpp:82-92)."""
    if name.endswith((".gltf", ".glb")):
        return load_gltf_scene(name, device=device, **kwargs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown scene '{name}'; the port has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](device=device, **kwargs)
