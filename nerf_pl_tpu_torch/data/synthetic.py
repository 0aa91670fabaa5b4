"""The analytic synthetic shadow scene (``nerf_pl_tpu/data/synthetic.py``).

Ray-traces a lambertian position-coloured sphere over a checkered ground
disc with a hard point-light shadow, and writes a Blender-format scene:
RGBA frames, ``sm_*.png`` shadow maps and the light camera in the meta, which
the ``blender``, ``efficient_sm``, ``rgb_sm`` and ``shadows`` loaders read;
``generate_pyredner_scene`` rewrites its JSON in the ``pyredner2`` layout.
``generate_llff_scene`` writes the same scene in the LLFF layout
(``images/*.png`` and ``poses_bounds.npy``).  The PNGs go through the port's
own writer (``data/png.py``), so the scenes need no PIL; their pixels, JSON
and poses equal the JAX package's.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .png import write_png
from .shadow_common import get_ray_directions, get_rays, posed_ppc

SPHERE_C = np.array([0.0, 0.2, 0.0], np.float32)
SPHERE_R = 1.0
GROUND_Y = -1.0
# a finite ground disc inside the light's frustum: rays that hit ground
# outside it would gather clamped light depths and get targets the shadow
# mapping cannot match
GROUND_R = 3.5
LIGHT_POS = np.array([4.5, 7.5, 3.0], np.float32)


def look_at(eye, target=np.zeros(3, np.float32)):
    fwd = eye - target
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right = right / np.linalg.norm(right)
    up = np.cross(fwd, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, fwd, eye
    return m


def ray_sphere(o, d):
    """t of the first sphere hit, inf if none.  o, d: (N, 3)."""
    oc = o - SPHERE_C
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - SPHERE_R**2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return np.where((disc > 0) & (t > 1e-3), t, np.inf)


def ray_ground(o, d):
    t = (GROUND_Y - o[:, 1]) / d[:, 1]
    valid = (np.abs(d[:, 1]) > 1e-6) & (t > 1e-3)
    p = o + np.where(valid, t, 0.0)[:, None] * d
    valid &= p[:, 0] ** 2 + p[:, 2] ** 2 <= GROUND_R**2
    return np.where(valid, t, np.inf)


def in_shadow(p):
    """Is the segment from each point to the light blocked by the sphere?"""
    to_l = LIGHT_POS - p
    dist = np.linalg.norm(to_l, axis=-1, keepdims=True)
    d = to_l / dist
    t = ray_sphere(p + 1e-3 * d, d)
    return t < dist[:, 0]


def shade(o, d):
    """(rgb (N, 3), alpha (N,)) of each ray; white background."""
    n = o.shape[0]
    t_s = ray_sphere(o, d)
    t_g = ray_ground(o, d)
    rgb = np.ones((n, 3), np.float32)
    alpha = np.zeros(n, np.float32)

    hit_s = t_s < t_g
    if hit_s.any():
        p = o[hit_s] + t_s[hit_s, None] * d[hit_s]
        nrm = (p - SPHERE_C) / SPHERE_R
        light = LIGHT_POS - p
        light = light / np.linalg.norm(light, axis=-1, keepdims=True)
        lam = np.clip(np.sum(nrm * light, -1), 0.1, 1.0)
        rgb[hit_s] = (0.5 + 0.5 * nrm) * lam[:, None]  # position-coloured
        alpha[hit_s] = 1.0

    hit_g = (t_g < t_s) & np.isfinite(t_g)
    if hit_g.any():
        p = o[hit_g] + t_g[hit_g, None] * d[hit_g]
        checker = ((np.floor(p[:, 0]) + np.floor(p[:, 2])) % 2).astype(
            np.float32)
        base = 0.55 + 0.25 * checker[:, None] * np.ones((1, 3), np.float32)
        base[in_shadow(p)] *= 0.25
        rgb[hit_g] = base
        alpha[hit_g] = 1.0
    return np.clip(rgb, 0, 1), alpha


def _view_rays(c2w, wh, focal):
    o, d = get_rays(get_ray_directions(wh, wh, focal), c2w[:3, :4])
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def render_view(c2w, wh, focal):
    rgb, alpha = shade(*_view_rays(c2w, wh, focal))
    return rgb.reshape(wh, wh, 3), alpha.reshape(wh, wh)


def shadow_map_view(c2w, wh, focal):
    """The target shadow map: 1 where the first hit is shadowed, else 0
    (3 channels)."""
    o, d = _view_rays(c2w, wh, focal)
    t = np.minimum(ray_sphere(o, d), ray_ground(o, d))
    sm = np.zeros(o.shape[0], np.float32)
    hit = np.isfinite(t)
    sm[hit] = in_shadow(o[hit] + t[hit, None] * d[hit]).astype(np.float32)
    return np.stack([sm] * 3, -1).reshape(wh, wh, 3)


def generate_scene(out_dir, img_wh=64, n_train=20, n_val=2, n_test=2,
                   radius=4.5, camera_angle_x=0.8):
    """Write the whole scene (train, val and test splits); returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    wh = img_wh
    focal = 0.5 * 800 / np.tan(0.5 * camera_angle_x) * wh / 800
    light_c2w = look_at(LIGHT_POS)
    for split, n, off in [("train", n_train, 0.0), ("val", n_val, 0.33),
                          ("test", n_test, 0.66)]:
        frames = []
        for i in range(n):
            theta = 2 * np.pi * (i + off) / max(n, 1)
            height = 1.2 + 0.8 * np.sin(1.7 * theta)
            eye = np.array(
                [radius * np.sin(theta), height, radius * np.cos(theta)],
                np.float32,
            )
            c2w = look_at(eye)
            rgb, alpha = render_view(c2w, wh, focal)
            rgba = np.concatenate([rgb, alpha[..., None]], -1)
            name = f"r_{split}_{i}"
            write_png(os.path.join(out_dir, f"{name}.png"),
                      (rgba * 255).astype(np.uint8))
            sm = shadow_map_view(c2w, wh, focal)
            write_png(os.path.join(out_dir, f"sm_{name}.png"),
                      (sm * 255).astype(np.uint8))
            frames.append(
                {"file_path": f"./{name}", "transform_matrix": c2w.tolist()})
        meta = {
            "camera_angle_x": camera_angle_x,
            "light_camera_angle_x": camera_angle_x,
            "light_camera_transform_matrix": light_c2w.tolist(),
            "resolution": 800,
            "frames": frames,
        }
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return out_dir


def generate_pyredner_scene(out_dir, img_wh=64, n_train=20, n_val=2,
                            n_test=2, radius=4.5, camera_angle_x=0.8):
    """The same scene in the ``pyredner2`` layout: each pose stored as an
    explicit ``{"eye_pos", "camera"}`` PPC, the ray c2w left to the loader's
    look-at toward ``meta["look_at"]`` (the generator's ``look_at`` is the
    same math as ``camera.c2w_from_lookat``), and each frame's target in
    ``sm_file_path``.  Returns out_dir."""
    generate_scene(out_dir, img_wh, n_train, n_val, n_test, radius,
                   camera_angle_x)
    wh = (img_wh, img_wh)
    for split in ("train", "val", "test"):
        path = os.path.join(out_dir, f"transforms_{split}.json")
        with open(path) as f:
            meta = json.load(f)
        frames = []
        for fr in meta["frames"]:
            c2w = np.asarray(fr["transform_matrix"], np.float32)[:3, :4]
            cam, eye = posed_ppc(meta["camera_angle_x"], wh, c2w)
            name = fr["file_path"].split("/")[-1]
            frames.append({
                "transform_matrix": {"eye_pos": eye.tolist(),
                                     "camera": cam.tolist()},
                "sm_file_path": f"sm_{name}.png",
            })
        l2w = np.asarray(meta["light_camera_transform_matrix"], np.float32)[:3, :4]
        lcam, leye = posed_ppc(meta["light_camera_angle_x"], wh, l2w)
        with open(path, "w") as f:
            json.dump({
                "camera_angle_x": meta["camera_angle_x"],
                "light_camera_angle_x": meta["light_camera_angle_x"],
                "light_camera_transform_matrix": {
                    "eye_pos": leye.tolist(), "camera": lcam.tolist(),
                },
                "look_at": [0.0, 0.0, 0.0],
                "frames": frames,
            }, f)
    return out_dir


def generate_llff_scene(out_dir, img_wh=(64, 48), n_views=20, distance=4.5,
                        camera_angle_x=0.8, spheric: bool = False):
    """The same scene in the LLFF layout (``images/NNN.png`` and
    ``poses_bounds.npy``): a forward-facing fan of cameras looking at the
    sphere from one side, or with ``spheric=True`` an inward-facing ring
    (train with ``--spheric_poses``).  Poses are stored in COLMAP's "down
    right back" columns with an ``[H, W, focal]`` column; each view's depth
    bounds come from the analytic tracer (0.9 x the nearest hit, 1.1 x the
    farthest).  Returns out_dir."""
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    w, h = img_wh
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    rows = []
    for i in range(n_views):
        if spheric:
            theta = 2 * np.pi * i / max(n_views, 1)
            eye = np.array([distance * np.sin(theta),
                            1.0 + 0.5 * np.sin(2 * theta),
                            distance * np.cos(theta)], np.float32)
        else:
            # a lateral fan with a little height jitter, all looking at the
            # origin (forward-facing: the NDC warp holds)
            t = (i / max(n_views - 1, 1)) - 0.5
            eye = np.array([2.4 * t, 0.4 + 0.5 * np.sin(4 * np.pi * t),
                            distance], np.float32)
        c2w = look_at(eye)
        o, d = get_rays(get_ray_directions(h, w, focal), c2w[:3, :4])
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        rgb, _ = shade(o, d)
        write_png(os.path.join(out_dir, "images", f"{i:03d}.png"),
                  (rgb.reshape(h, w, 3) * 255).astype(np.uint8))
        t = np.minimum(ray_sphere(o, d), ray_ground(o, d))
        t = t[np.isfinite(t)]
        if len(t):
            near, far = 0.9 * float(t.min()), 1.1 * float(t.max())
        else:
            near, far = 1.0, 2.0 * float(np.linalg.norm(eye))
        down, right, back = -c2w[:3, 1], c2w[:3, 0], c2w[:3, 2]
        pose = np.stack([down, right, back, eye], 1)
        hwf = np.array([[h], [w], [focal]], np.float32)
        rows.append(np.concatenate(
            [np.concatenate([pose, hwf], 1).reshape(-1), [near, far]]))
    np.save(os.path.join(out_dir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
    return out_dir
