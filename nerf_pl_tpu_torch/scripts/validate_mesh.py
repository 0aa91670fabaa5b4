"""Validate a mesh extracted from the analytic synthetic scene (the
counterpart of ``scripts/validate_mesh.py``): the acceptance check of the
coloured-mesh tool.

The generator's geometry is known exactly (``data/synthetic.py``: a unit
sphere at ``SPHERE_C``, coloured ``0.5 + 0.5 * normal`` under Lambert
shading), so the vertices' distances to the sphere's centre should gather
at radius 1, and their colours should correlate with the analytic colour.
Prints the report, then PASS (exit code 0) or FAIL (exit code 1), as the
JAX script does.

    python -m nerf_pl_tpu_torch.scripts.validate_mesh mesh.ply \
        [--device cuda|cpu]

The check runs on the host; ``--device`` (default ``cuda``) is the port's
own, and like every entry point of the port the script refuses to run
without a card unless given ``cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import resolve_device
from ..data.synthetic import SPHERE_C
from ..tools.mesh_utils import read_ply


def report(path: str) -> dict:
    """The mesh's radius and colour statistics against the sphere."""
    verts, faces, colors = read_ply(path)
    r = np.linalg.norm(verts - SPHERE_C, axis=1)
    out = {
        "n_vertices": len(verts),
        "n_faces": len(faces),
        "radius_mean": float(r.mean()),
        "radius_std": float(r.std()),
        "radius_p5": float(np.percentile(r, 5)),
        "radius_p95": float(np.percentile(r, 95)),
        "frac_within_5pct_of_unit": float(np.mean(np.abs(r - 1.0) < 0.05)),
    }
    if colors is not None and len(colors):
        nrm = (verts - SPHERE_C) / r[:, None]
        analytic = np.clip(0.5 + 0.5 * nrm, 0, 1)
        got = colors.astype(np.float32) / 255.0
        # Lambert shading scales the analytic colour per vertex; the
        # per-channel correlation is shading-invariant in aggregate
        corr = [float(np.corrcoef(analytic[:, c], got[:, c])[0, 1])
                for c in range(3)]
        out["color_corr_rgb"] = [round(c, 3) for c in corr]
        out["color_mae"] = float(np.abs(analytic - got).mean())
    return out


def passes(rep: dict) -> bool:
    return (abs(rep["radius_mean"] - 1.0) < 0.05
            and rep["frac_within_5pct_of_unit"] > 0.9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rep = report(args.path)
    for k, v in rep.items():
        print(f"{k}: {v}")
    ok = passes(rep)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
