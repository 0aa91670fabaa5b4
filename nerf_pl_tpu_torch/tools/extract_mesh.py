"""Colored-mesh extraction (``nerf_pl_tpu/tools/extract_mesh.py``;
reference ``extract_color_mesh.py``).

The JAX tool's pipeline, step for step:
  1. the sigma of the fine model on a dense N³ grid, chunked, the last
     chunk padded with zero rows.  On the card the reference architecture
     runs the row-major fused forward sigma-only in float32 (kernel C′, one
     launch a chunk); sigma does not depend on the view direction, so this
     is the JAX tool's query on zero directions.  Other widths, and the CPU,
     take ``posenc`` + ``NeRF`` as ``ops/rendering.py::_query`` decides;
  2. the iso-surface at ``sigma_threshold`` (``mesh_utils``), with the
     x/y axis swap back into world ranges (``grid_vertices_to_world``);
  3. the largest connected cluster;
  4. color fusion: every training image projected onto the vertices,
     bilinear colour lookup, an occlusion test by the coarse model's
     opacity along camera-to-vertex rays ending at the vertex depth
     (``render_rays`` at ``test_time`` with ``N_importance=0``: C′ in
     float32 on the card), inverse-depth weights; or, with
     ``--use_vertex_normal``, one coarse + fine render along each vertex's
     density-gradient normal (C′ sigma-only, kernel B for the fine samples,
     C′ rgb);
  5. the colored binary PLY; ``--vol_path`` also writes the sigma grid as a
     ``.vol`` volume texture (``--vol_only`` stops there).

Images are read as PIL's ``Image.open(p).convert("RGB")`` reads them (RGBA
PNGs lose their alpha without blending) and resized with the port's copy of
PIL's LANCZOS (``data/resize.py``), so the sampled colours are Pillow's.
``run`` prints each stage's wall seconds on a ``[mesh]`` JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import dataset_dict
from ..data.llff import read_image
from ..data.resize import resize_lanczos
from ..ops.rendering import _query, render_rays
from .evaluate import load_models
from .mesh_utils import (
    bilinear_sample,
    keep_largest_cluster,
    marching_tetrahedra,
    save_vol,
    write_ply,
)

def get_opts(argv=None):
    """The JAX tool's flags, field for field, and ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--dataset_name", type=str, default="blender",
                        choices=["blender", "llff"])
    parser.add_argument("--scene_name", type=str, default="test")
    parser.add_argument("--img_wh", nargs="+", type=int, default=[800, 800])
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--chunk", type=int, default=32 * 1024)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--N_grid", type=int, default=256)
    parser.add_argument("--x_range", nargs="+", type=float, default=[-1.0, 1.0])
    parser.add_argument("--y_range", nargs="+", type=float, default=[-1.0, 1.0])
    parser.add_argument("--z_range", nargs="+", type=float, default=[-1.0, 1.0])
    parser.add_argument("--sigma_threshold", type=float, default=20.0)
    parser.add_argument("--occ_threshold", type=float, default=0.2)
    parser.add_argument("--use_vertex_normal", action="store_true")
    parser.add_argument("--N_importance", type=int, default=64)
    parser.add_argument("--near_t", type=float, default=1.0)
    parser.add_argument("--out_path", type=str, default=None)
    parser.add_argument("--blender_near", type=float, default=2.0)
    parser.add_argument("--blender_far", type=float, default=6.0)
    parser.add_argument("--vol_path", type=str, default=None,
                        help="also write the sigma grid as a .vol volume "
                        "texture (Unity VolumeRender parity, "
                        "reference README_Unity.md:22-28)")
    parser.add_argument("--vol_only", action="store_true",
                        help="stop after writing --vol_path (no mesh)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def query_sigma_grid(model_fine, xyz: np.ndarray, chunk: int) -> np.ndarray:
    """sigma for (M, 3) points, chunked (the last chunk padded with zero
    rows), on the model's device; float32, not clamped."""
    device = _device_of(model_fine)
    m = xyz.shape[0]
    pad = (-m) % chunk
    xyz_p = np.concatenate([xyz, np.zeros((pad, 3), xyz.dtype)], 0)
    pts = torch.from_numpy(np.ascontiguousarray(xyz_p, np.float32)).to(device)
    out = []
    with torch.no_grad():
        for i in range(0, len(xyz_p), chunk):
            sigma, _ = _query(model_fine, pts[None, i:i + chunk], None, 10,
                              True, torch.float32,
                              use_fused=device.type == "cuda")
            out.append(sigma[0])
    return torch.cat(out).cpu().numpy()[:m]


def grid_vertices_to_world(vertices, N, x_range, y_range, z_range):
    """Grid-index verts -> world.

    The sigma grid comes from ``np.meshgrid(x, y, z)`` with the default
    'xy' indexing, so grid axis 0 indexes y and axis 1 indexes x.  The
    reference performs this same axis swap (``extract_color_mesh.py:148-155``)
    but applies the wrong range offsets when ``x_range != y_range``; here
    axis 1 maps through x_range and axis 0 through y_range, as the JAX
    tool's documented fix does.
    """
    xmin, xmax = x_range
    ymin, ymax = y_range
    zmin, zmax = z_range
    v = vertices / N
    out = np.empty_like(v)
    out[:, 0] = (xmax - xmin) * v[:, 1] + xmin  # grid axis 1 -> world x
    out[:, 1] = (ymax - ymin) * v[:, 0] + ymin  # grid axis 0 -> world y
    out[:, 2] = (zmax - zmin) * v[:, 2] + zmin
    return out.astype(np.float32)


def _render_kwargs(device, n_samples, n_importance, white_back):
    return dict(N_samples=n_samples, N_importance=n_importance, perturb=0.0,
                noise_std=0.0, white_back=white_back, test_time=True,
                use_fused=device.type == "cuda", fused_channel_io=False)


def _padded(rays: np.ndarray, chunk: int) -> np.ndarray:
    """``rays`` padded to a whole number of chunks with the last ray."""
    pad = (-rays.shape[0]) % chunk
    return np.concatenate([rays, np.repeat(rays[-1:], pad, 0)], 0)


def _chunked_render(models, rays: np.ndarray, chunk: int, n_samples: int,
                    n_importance: int, white_back: bool):
    """``render_rays`` at ``test_time`` over (M, 8) rays, chunked; numpy
    outputs by key."""
    device = _device_of(models["coarse"])
    rkw = _render_kwargs(device, n_samples, n_importance, white_back)
    m = rays.shape[0]
    rays_t = torch.from_numpy(_padded(rays, chunk)).to(device)
    outs = {}
    with torch.no_grad():
        for i in range(0, len(rays_t), chunk):
            r = render_rays(models["coarse"], models.get("fine"),
                            rays_t[i:i + chunk], None, **rkw)
            for k, v in r.items():
                outs.setdefault(k, []).append(v)
    return {k: torch.cat(v).cpu().numpy()[:m] for k, v in outs.items()}


def _read_rgb(path: str, img_wh) -> np.ndarray:
    """PIL's ``Image.open(path).convert("RGB").resize(img_wh, LANCZOS)``."""
    return resize_lanczos(read_image(path), "RGB", tuple(img_wh))


def run(args) -> str:
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    kwargs = {"root_dir": args.root_dir, "img_wh": tuple(args.img_wh)}
    if args.dataset_name == "llff":
        kwargs["spheric_poses"] = True
        kwargs["split"] = "test"
    else:
        kwargs["split"] = "train"
        kwargs.update(near=args.blender_near, far=args.blender_far)
    dataset = dataset_dict[args.dataset_name](**kwargs)
    models = load_models(args.ckpt_path, device)
    stages = {"load_s": time.perf_counter() - t_start}

    def stage(name, t0):
        stages[name] = time.perf_counter() - t0
        return time.perf_counter()

    # 1. dense sigma grid (meshgrid ij over x, y, z like the reference's
    #    np.meshgrid(x, y, z) default 'xy' -> the x/y swap below undoes it)
    t0 = time.perf_counter()
    N = args.N_grid
    x = np.linspace(*args.x_range, N)
    y = np.linspace(*args.y_range, N)
    z = np.linspace(*args.z_range, N)
    xyz = np.stack(np.meshgrid(x, y, z), -1).reshape(-1, 3).astype(np.float32)
    print("Predicting occupancy ...")
    sigma = query_sigma_grid(models["fine"], xyz, args.chunk)
    sigma_grid = np.maximum(sigma, 0).reshape(N, N, N)
    t0 = stage("grid_s", t0)

    def report(**counts):
        stages["total_s"] = time.perf_counter() - t_start
        print("[mesh] " + json.dumps({"n_grid": N, **counts, **stages}),
              flush=True)

    if args.vol_path:
        # meshgrid 'xy' gives (y, x, z) axes; store the .vol x-major
        save_vol(args.vol_path, sigma_grid.transpose(1, 0, 2),
                 args.x_range, args.y_range, args.z_range)
        print(f"Wrote volume texture to {args.vol_path}")
        t0 = stage("vol_s", t0)
        if args.vol_only:
            report()
            return args.vol_path

    # 2. iso-surface
    print("Extracting mesh ...")
    vertices, triangles = marching_tetrahedra(sigma_grid, args.sigma_threshold)
    vertices_w = grid_vertices_to_world(
        vertices, N, args.x_range, args.y_range, args.z_range
    )
    n_surface = len(vertices_w)
    t0 = stage("surface_s", t0)

    if len(triangles) == 0:
        out_path = args.out_path or f"{args.scene_name}.ply"
        write_ply(out_path, vertices_w, triangles)
        print("No surface crossed sigma_threshold — wrote empty mesh.")
        report(vertices=len(vertices_w), faces=0)
        return out_path

    # 3. denoise
    print("Removing noise ...")
    vertices_w, triangles = keep_largest_cluster(vertices_w, triangles)
    print(
        f"Mesh has {len(vertices_w)/1e6:.2f} M vertices and "
        f"{len(triangles)/1e6:.2f} M faces."
    )
    t0 = stage("cluster_s", t0)

    W, H = args.img_wh
    K = np.array(
        [[dataset.focal, 0, W / 2], [0, dataset.focal, H / 2], [0, 0, 1]],
        dtype=np.float32,
    )
    n_vert = len(vertices_w)
    vertices_homo = np.concatenate([vertices_w, np.ones((n_vert, 1))], 1)

    if args.use_vertex_normal:
        # normals from the density gradient at each vertex (robust to
        # triangle winding, unlike face-normal averaging)
        # sigma_grid from meshgrid(x,y,z,'xy') has axes (y, x, z); gradients
        # come back per-axis as (d/dy, d/dx, d/dz)
        g_y, g_x, g_z = np.gradient(sigma_grid)
        # exact inverse of grid_vertices_to_world: grid axis 0 indexes
        # world Y (y_range), grid axis 1 indexes world X (x_range)
        i0 = (vertices_w[:, 1] - args.y_range[0]) / (
            args.y_range[1] - args.y_range[0]
        )
        i1 = (vertices_w[:, 0] - args.x_range[0]) / (
            args.x_range[1] - args.x_range[0]
        )
        i2 = (vertices_w[:, 2] - args.z_range[0]) / (
            args.z_range[1] - args.z_range[0]
        )
        idx = np.clip(
            np.round(np.stack([i0, i1, i2], 1) * N).astype(int), 0, N - 1
        )
        ii = (idx[:, 0], idx[:, 1], idx[:, 2])  # (y-axis, x-axis, z-axis)
        g = np.stack([g_x[ii], g_y[ii], g_z[ii]], axis=1)
        normals = -g / (np.linalg.norm(g, axis=1, keepdims=True) + 1e-8)
        near = dataset.bounds.min() * np.ones((n_vert, 1), np.float32)
        far = dataset.bounds.max() * np.ones((n_vert, 1), np.float32)
        rays_o = vertices_w - normals * near * args.near_t
        rays = np.concatenate(
            [rays_o, normals, near, far], 1
        ).astype(np.float32)
        results = _chunked_render(
            models, rays, args.chunk, args.N_samples, args.N_importance,
            dataset.white_back,
        )
        v_colors = np.clip(results["rgb_fine"], 0, 1) * 255.0
    else:
        non_occluded_sum = np.zeros((n_vert, 1))
        v_color_sum = np.zeros((n_vert, 3))
        print("Fusing colors ...")
        rkw = _render_kwargs(device, args.N_samples, 0, dataset.white_back)
        chunk = args.chunk
        for idx in range(len(dataset.image_paths)):
            image = _read_rgb(dataset.image_paths[idx], args.img_wh)

            P_c2w = np.concatenate(
                [dataset.poses[idx], np.array([[0, 0, 0, 1]])], 0
            )
            P_w2c = np.linalg.inv(P_c2w)[:3]
            vertices_cam = P_w2c @ vertices_homo.T  # "right up back"
            vertices_cam[1:] *= -1  # -> "right down forward"
            vertices_image = (K @ vertices_cam).T
            depth = vertices_image[:, -1:] + 1e-5
            vertices_image = vertices_image[:, :2] / depth
            vx = np.clip(vertices_image[:, 0], 0, W - 1)
            vy = np.clip(vertices_image[:, 1], 0, H - 1)
            colors = bilinear_sample(image, vx, vy)

            rays_o = np.broadcast_to(
                dataset.poses[idx][:, -1], (n_vert, 3)
            ).astype(np.float32)
            rays_d = vertices_w - rays_o
            rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
            near = dataset.bounds.min() * np.ones((n_vert, 1), np.float32)
            far = depth.astype(np.float32)
            rays = np.concatenate([rays_o, rays_d, near, far], 1).astype(
                np.float32
            )
            rays_t = torch.from_numpy(_padded(rays, chunk)).to(device)
            with torch.no_grad():
                opacity = torch.cat([
                    render_rays(models["coarse"], models.get("fine"),
                                rays_t[i:i + chunk], None,
                                **rkw)["opacity_coarse"]
                    for i in range(0, len(rays_t), chunk)])
            opacity = opacity.cpu().numpy()[:n_vert]
            opacity = np.nan_to_num(opacity[:, None], nan=1.0)
            non_occluded = np.ones_like(non_occluded_sum) * 0.1 / depth
            non_occluded += opacity < args.occ_threshold
            v_color_sum += colors * non_occluded
            non_occluded_sum += non_occluded
        v_colors = v_color_sum / non_occluded_sum
    t0 = stage("fusion_s", t0)

    out_path = args.out_path or f"{args.scene_name}.ply"
    write_ply(out_path, vertices_w, triangles, v_colors.astype(np.uint8))
    stage("write_s", t0)
    report(vertices=n_vert, faces=len(triangles), surface_vertices=n_surface)
    print("Done!")
    return out_path
