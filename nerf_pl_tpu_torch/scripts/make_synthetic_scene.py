"""Write a geometrically consistent synthetic test scene with the port's
generator (``data/synthetic.py``; the counterpart of
``scripts/make_synthetic_scene.py``): Blender (the default; RGBA views,
shadow maps and a light camera), LLFF (``images/`` and ``poses_bounds.npy``:
a forward-facing fan, or with ``--spheric`` an inward-facing ring) or
pyredner (stored PPCs).

    python -m nerf_pl_tpu_torch.scripts.make_synthetic_scene \
        --out /tmp/sphere_scene --img_wh 64 --n_train 20 --n_val 2 \
        --n_test 2 [--format blender|llff|pyredner] [--device cuda|cpu]

Every flag of the JAX script parses as it does there and the same line is
printed.  The scene is written on the host; ``--device`` (default ``cuda``)
is the port's own, and like every entry point of the port the script
refuses to run without a card unless given ``cpu``.
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from ..data.synthetic import (generate_llff_scene, generate_pyredner_scene,
                              generate_scene)


def get_opts(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--img_wh", type=int, default=64)
    ap.add_argument("--n_train", type=int, default=20)
    ap.add_argument("--n_val", type=int, default=2)
    ap.add_argument("--n_test", type=int, default=2)
    ap.add_argument("--radius", type=float, default=4.5)
    ap.add_argument("--camera_angle_x", type=float, default=0.8)
    ap.add_argument("--format", choices=["blender", "llff", "pyredner"],
                    default="blender",
                    help="llff: images/ + poses_bounds.npy forward-facing fan")
    ap.add_argument("--img_h", type=int, default=None,
                    help="llff only: image height (default 3/4 of --img_wh)")
    ap.add_argument("--spheric", action="store_true",
                    help="llff only: inward-facing 360 ring (train with "
                    "--spheric_poses)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> str:
    args = get_opts(argv)
    resolve_device(args.device)
    if args.format == "llff":
        h = args.img_h or (args.img_wh * 3 // 4)
        generate_llff_scene(args.out, (args.img_wh, h), args.n_train,
                            args.radius, args.camera_angle_x,
                            spheric=args.spheric)
        kind = "llff-spheric" if args.spheric else "llff"
        print(f"wrote {args.out} ({kind}, {args.n_train} views @ "
              f"{args.img_wh}x{h})")
    elif args.format == "pyredner":
        generate_pyredner_scene(args.out, args.img_wh, args.n_train,
                                args.n_val, args.n_test, args.radius,
                                args.camera_angle_x)
        print(f"wrote {args.out} (pyredner, {args.n_train}+{args.n_val}+"
              f"{args.n_test} views @ {args.img_wh}x{args.img_wh})")
    else:
        generate_scene(args.out, args.img_wh, args.n_train, args.n_val,
                       args.n_test, args.radius, args.camera_angle_x)
        print(f"wrote {args.out} ({args.n_train}+{args.n_val}+{args.n_test} "
              f"views @ {args.img_wh}x{args.img_wh})")
    return args.out


if __name__ == "__main__":
    main()
