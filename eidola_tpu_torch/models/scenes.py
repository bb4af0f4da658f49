"""Procedural scenes + registry (port of the opaque flattened scenes of
eidola_tpu/models/scenes.py: cornell, punctual, textured, hdr, stress,
bistro_flat)."""
from __future__ import annotations

import numpy as np

from ..scene.camera import Camera, make_camera
from ..scene.data import SceneData, attach_env, default_sunsky, upload_scene
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


_REGISTRY = {
    "cornell": cornell_box,
    "punctual": punctual_demo,
    "textured": textured_demo,
    "hdr": hdr_env_demo,
    "stress": stress_grid,
    "bistro_flat": bistro_flat,
}


def load_scene(name: str, *, device, **kwargs) -> tuple[SceneData, Camera]:
    """Scene front door by registry name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scene '{name}'; the port has "
                       f"{sorted(_REGISTRY)} (others come with later slices)")
    return _REGISTRY[name](device=device, **kwargs)
