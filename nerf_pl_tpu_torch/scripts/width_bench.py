"""Train-step throughput at trunk widths other than the reference's (the
counterpart of ``scripts/width_bench.py``, ``--arch_width``).

Each width runs ``bench.py``'s step (batch 4,096, 64 + 128 samples, bf16,
perturb and noise on, the MSE of both passes, backward and Adam) as a
Python loop: one warm-up step, then ``--iters`` steps timed with CUDA
events and closed by fetching the last loss.  The step takes the fused MLP
where the port's ``render_rays`` takes it: kernels D and E at W = 256 (A at
every width), posenc + NeRF in PyTorch at the other widths, as JAX leaves
them to XLA.  Model TFLOP/s counts 3x the forward's matmul work a point
(``mlp_flops_per_point``: the forward, dgrad and wgrad) over the coarse
and the fine pass's points.  A width that fails prints a row with its
error and the others go on, as in the JAX script.

    python -m nerf_pl_tpu_torch.scripts.width_bench --widths 256 512 1024 \
        [--batch 4096] [--iters 20] [--remat_fine] [--out rows.json] \
        [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the script refuses to run without a
card unless given ``cpu`` (timed on the host clock there).
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from .. import resolve_device
from ..bench import make_step


def mlp_flops_per_point(W: int, D: int = 8, cx: int = 63, cd: int = 27) -> float:
    """Forward matmul FLOPs per sample point (2*m*n per (m,n) matvec)."""
    f = 2 * cx * W                      # layer 0
    f += (D - 2) * 2 * W * W            # layers 1..7 minus the skip layer
    f += 2 * (W + cx) * W               # skip layer
    f += 2 * W * 1                      # sigma head
    f += 2 * W * W                      # xyz_final
    f += 2 * (W + cd) * (W // 2)        # dir layer
    f += 2 * (W // 2) * 3               # rgb head
    return float(f)


def timed_steps(step, iters: int, device: torch.device) -> tuple:
    """Seconds of ``iters`` calls of ``step`` and the last loss: CUDA events
    on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            loss = step()
        end.record()
        final = float(loss)
        return start.elapsed_time(end) / 1e3, final
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    final = float(loss)
    return time.perf_counter() - t0, final


def bench_width(width: int, batch: int, iters: int, n_coarse: int = 64,
                n_fine: int = 128, remat_fine: bool = False,
                device=None) -> dict:
    device = resolve_device(device)
    step = make_step(batch, torch.bfloat16, device, width=width,
                     remat_fine=remat_fine)
    float(step())  # warm-up: the kernels build and load here
    dt, final = timed_steps(step, iters, device)
    if not math.isfinite(final):
        raise FloatingPointError(f"loss is not finite: {final}")
    rays_s = batch * iters / dt
    # points a ray: the coarse pass n_coarse, the fine n_coarse + n_fine
    pts_per_ray = n_coarse + (n_coarse + n_fine)
    # fwd + bwd ~= 3x the forward's matmul work (dgrad + wgrad)
    model_tf = rays_s * pts_per_ray * 3 * mlp_flops_per_point(width) / 1e12
    return {
        "width": width,
        "batch": batch,
        "remat_fine": remat_fine,
        "rays_per_s": round(rays_s, 1),
        "pts_per_s": round(rays_s * pts_per_ray, 1),
        "model_tflops_fwd_bwd": round(model_tf, 1),
        "sec_per_step": round(dt / iters, 4),
    }


def get_opts(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--remat_fine", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = get_opts(argv)
    device = resolve_device(args.device)
    rows = []
    for w in args.widths:
        try:
            r = bench_width(w, args.batch, args.iters,
                            remat_fine=args.remat_fine, device=device)
        except Exception as e:  # noqa: BLE001 — keep measuring other widths
            r = {"width": w, "batch": args.batch,
                 "error": f"{type(e).__name__}: {str(e)[:160]}"}
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
