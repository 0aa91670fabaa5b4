"""Inspect a shadow dataset and its camera geometry (the counterpart of
``examples/inspect_shadow_scene.py``, the script form of the reference's
``shadows.ipynb``).

Prints the light rig, the first poses and the buffer shapes of the
``train`` split through the port's loaders, and checks the camera -> light
projection on the scene's own data: a world point on a camera ray must land
at its true light-space pixel (``ops/shadow_mapping.py::get_projections``
against the light camera's inverse, ``rtol=1e-3``).

    python -m nerf_pl_tpu_torch.examples.inspect_shadow_scene \
        --root_dir <scene> --img_wh 64 64 [--dataset_name efficient_sm] \
        [--device cuda|cpu]

Every flag of the JAX script parses as it does there and the same sections
are printed.  The projection runs on ``--device`` (default ``cuda``; the
script refuses to run without a card unless given ``cpu``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..data import dataset_dict
from ..ops.shadow_mapping import get_projections

RTOL = 1e-3


def get_opts(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root_dir", required=True)
    ap.add_argument("--dataset_name", default="efficient_sm",
                    choices=["efficient_sm", "rgb_sm", "shadows", "pyredner2"])
    ap.add_argument("--img_wh", nargs="+", type=int, default=[64, 64])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Print the report; returns whether the projection is consistent (None
    for a dataset without per-pose cameras)."""
    args = get_opts(argv)
    device = resolve_device(args.device)
    ds = dataset_dict[args.dataset_name](
        args.root_dir, "train", img_wh=tuple(args.img_wh))
    light = ds.light
    print("=== light rig ===")
    print("eye:", light.eye_pos)
    print("M:\n", light.camera)
    print("rays:", light.rays.shape, "near/far:",
          light.rays[0, 6], light.rays[0, 7])
    if hasattr(ds, "all_rays"):
        print("=== train buffers ===")
        print("rays:", ds.all_rays.shape, "targets:", ds.all_rgbs.shape)
        if hasattr(ds, "cam_ms"):
            print("poses:", ds.cam_ms.shape[0])
            for i in range(min(3, ds.cam_ms.shape[0])):
                print(f"  pose {i}: eye={ds.cam_eyes[i]}")
    if not hasattr(ds, "cam_ms"):
        return None

    # geometric consistency on the scene's data
    M, eye = ds.cam_ms[0], ds.cam_eyes[0]
    w, h = args.img_wh
    pix = np.array([[w / 2 + 0.5, h / 2 + 0.5, 1.0]], np.float32)
    t = np.array([3.0], np.float32)
    P = eye + t[0] * (M @ pix[0])
    pd = np.concatenate([pix, np.linalg.norm(t[0] * (M @ pix[0]))
                         [None, None].astype(np.float32)], 1)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    K = get_projections(on_device(M), on_device(eye), on_device(light.camera),
                        on_device(light.eye_pos), on_device(pd)).cpu().numpy()
    ml_inv = np.linalg.inv(light.camera)
    want = ml_inv @ (P - light.eye_pos)
    print("=== projection consistency (center pixel, t=3) ===")
    print("projected (ul, vl, wl):", K[0])
    print("expected  (u/w, v/w, w):",
          want[0] / want[2], want[1] / want[2], want[2])
    ok = np.allclose(K[0], [want[0] / want[2], want[1] / want[2], want[2]],
                     rtol=RTOL)
    print("consistent:", bool(ok))
    return bool(ok)


if __name__ == "__main__":
    main()
