"""Kernel A against the other formulations of the sampler's rank (the
counterpart of ``scripts/bench_searchsorted.py``).

Shapes: the flagship fine-sampling step, 4,096 rays, a 65-wide CDF
(N_samples + 1) and 128 importance draws (reference
``models/rendering.py:37``).  Kernel A (``ops/searchsorted.py::
searchsorted_cuda``, a bisection) requires non-decreasing rows, so the
rows are CDFs, as ``sample_pdf`` builds them.  The rank sets (side right):

  * ``kernel A``: ``searchsorted_cuda`` (its plain version on the CPU);
  * ``torch.searchsorted(right=True)``: the library call, a yardstick that
    the port does not call;
  * the (B, K, M) broadcast compare-sum (``searchsorted_plain``);
  * the stable-sort formulation: one stable argsort of ``[cdf row | draws]``,
    the rank being the CDF entries before each draw.

First the four are checked to give the same ranks; then each is timed over
ITERS = 50 calls with CUDA events after a warm-up call, and so is
``ops/sampling.py::sample_pdf`` with its draws ``u`` and ``jitter``
injected (kernel A inside).

    python -m nerf_pl_tpu_torch.scripts.bench_searchsorted [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the script refuses to run without a
card unless given ``cpu`` (timed on the host clock there).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..ops.sampling import sample_pdf
from ..ops.searchsorted import searchsorted, searchsorted_plain

B, M, K = 4096, 65, 128
ITERS = 50


def searchsorted_library(seq: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """side='right' through ``torch.searchsorted``, as int32."""
    return torch.searchsorted(seq, vals, right=True).to(torch.int32)


def searchsorted_sort(seq: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """side='right' via one stable argsort of [seq_row | query_row]."""
    comb = torch.cat([seq, vals], dim=1)  # (B, M + K)
    order = torch.argsort(comb, dim=1, stable=True)  # seq wins ties: right
    seq_before = torch.cumsum((order < seq.shape[1]).to(torch.int32), dim=1)
    inv = torch.argsort(order, dim=1, stable=True)
    return torch.gather(seq_before, 1, inv)[:, seq.shape[1]:].to(torch.int32)


RANKS = {
    "kernel A (searchsorted_cuda)": lambda s, v: searchsorted(s, v, "right"),
    "torch.searchsorted (library)": searchsorted_library,
    "broadcast compare-sum": lambda s, v: searchsorted_plain(s, v, "right"),
    "stable-sort": searchsorted_sort,
}


def make_inputs(device, seed: int = 0) -> dict:
    """Seeded CDF rows (B, M), draws (B, K), rays and weights for
    ``sample_pdf``, made on the CPU and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand((B, M - 1), generator=gen) + 1e-3
    cdf = torch.cumsum(w / w.sum(1, keepdim=True), dim=1)
    cdf = torch.cat([torch.zeros((B, 1)), cdf], dim=1)  # (B, 65)
    u = torch.rand((B, K), generator=gen)
    rays = torch.cat([torch.zeros((B, 6)), torch.full((B, 1), 2.0),
                      torch.full((B, 1), 6.0)], 1)
    weights = torch.rand((B, M - 2), generator=gen)
    return {k: v.to(device) for k, v in dict(cdf=cdf, u=u, rays=rays,
                                             weights=weights).items()}


def rank_sets(cdf: torch.Tensor, u: torch.Tensor) -> dict:
    return {name: fn(cdf, u) for name, fn in RANKS.items()}


def time_us(fn, device: torch.device, iters: int = ITERS) -> float:
    """Microseconds a call over ``iters`` calls after a warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e6 / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    x = make_inputs(device)
    cdf, u = x["cdf"], x["u"]

    # the correctness cross-check first
    ranks = rank_sets(cdf, u)
    first = next(iter(ranks.values()))
    for name, r in ranks.items():
        if not torch.equal(r, first):
            raise AssertionError(f"{name} disagrees on the ranks")
    print(f"all {len(ranks)} backends agree on ranks")

    times = {}
    for name, fn in RANKS.items():
        times[name] = time_us(lambda: fn(cdf, u), device)
        print(f"searchsorted: {name:36s} {times[name]:9.1f} us/iter",
              flush=True)
    name = "sample_pdf (production backend)"
    times[name] = time_us(lambda: sample_pdf(x["rays"], x["weights"], K,
                                             u=u, jitter=u), device)
    print(f"{name:50s} {times[name]:9.1f} us/iter", flush=True)
    return times


if __name__ == "__main__":
    main()
