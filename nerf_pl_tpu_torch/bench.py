"""Training-step throughput of the port on one card (the counterpart of
``bench.py``).

    python -m nerf_pl_tpu_torch.bench [--iters 20] [--dtype bfloat16]

The same workload as ``bench.py``: a batch of 4,096 rays, 64 coarse + 128
importance samples per ray, the full coarse + fine reference NeRF, perturb 1,
noise 1, white background, MSE on both passes, backward through the fused
MLP kernels and Adam (lr 5e-4, eps 1e-8).  One warm-up step, then ``iters``
steps timed on the host clock and closed by fetching the last loss.  Runs
on ``cuda`` only.  Prints ONE JSON line with ``bench.py``'s keys.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from . import resolve_device
from .graft_entry import flagship_models, make_rays
from .ops.rendering import render_rays
from .training.losses import mse_loss
from .training.optim import Adam, named_params

BASELINE_RAYS_PER_S = 1024 / 0.12  # reference 2080 Ti anchor (BASELINE.md)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_step(batch: int = 4096, compute_dtype=torch.bfloat16, device=None,
              width: int = 256, remat_fine: bool = False):
    """One training step of the workload on ``device`` (default ``cuda``):
    a closure that renders, backpropagates, steps Adam and returns the
    loss, still on the device.  ``width`` other than the reference's 256
    (``--arch_width``) renders through posenc + NeRF, as the renderer does
    at every width the fused MLP does not take; ``remat_fine`` recomputes
    the fine pass in the backward."""
    device = resolve_device(device)
    models = flagship_models(0, device, width)
    opt = Adam(named_params(models), lambda step: 5e-4, eps=1e-8)
    gen = torch.Generator().manual_seed(1)
    rays = make_rays(gen, batch, device=device)
    rgbs = torch.rand((batch, 3), generator=gen).to(device)
    render_gen = torch.Generator(device=device).manual_seed(9)

    def step():
        out = render_rays(models["coarse"], models["fine"], rays, render_gen,
                          N_samples=64, N_importance=128, perturb=1.0,
                          noise_std=1.0, white_back=True,
                          compute_dtype=compute_dtype, use_fused=True,
                          fused_channel_io=True, remat_fine=remat_fine)
        loss = mse_loss(out, rgbs)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def bench(batch: int = 4096, iters: int = 20,
          compute_dtype=torch.bfloat16) -> float:
    """Rays per second of ``iters`` training steps."""
    step = make_step(batch, compute_dtype, "cuda")
    float(step())  # warm-up: the kernels build and load here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    final = float(loss)  # the host fetch closes the timing
    dt = time.perf_counter() - t0
    if not math.isfinite(final):
        raise RuntimeError(f"loss is not finite: {final}")
    return batch * iters / dt


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    args = p.parse_args(argv)
    rate = bench(iters=args.iters, compute_dtype=_DTYPES[args.dtype])
    print(json.dumps({
        "metric": "train_rays_per_s_per_chip",
        "value": round(rate, 1),
        "dtype": args.dtype,
        "unit": "rays/s (fwd+bwd+adam, 64c+192f samples)",
        "vs_baseline": round(rate / BASELINE_RAYS_PER_S, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
