"""Entry point of the port (the counterpart of ``__graft_entry__.entry``).

``entry()`` returns ``(fn, args)``: a forward render step of the flagship
model (coarse + fine reference NeRF, 64 + 128 samples, perturb and noise
on) over 256 rays; ``fn(*args)`` is ``rgb_fine``, (256, 3).
``dryrun_multichip(n)`` runs one data-parallel training step over n ranks.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.nerf import init_nerf
from .ops.rendering import render_rays


def flagship_models(seed: int = 0, device=None) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {name: init_nerf(gen, device=device) for name in ("coarse", "fine")}


def make_rays(gen: torch.Generator, n: int, near: float = 2.0,
              far: float = 6.0, device=None) -> torch.Tensor:
    """(n, 8) rays near the origin with random unit directions."""
    o = torch.randn((n, 3), generator=gen) * 0.1
    d = torch.randn((n, 3), generator=gen)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    nf = torch.ones((n, 1))
    return torch.cat([o, d, near * nf, far * nf], -1).to(resolve_device(device))


def entry(device=None):
    """Returns ``(fn, example_args)``: a forward render step."""
    device = resolve_device(device)
    models = flagship_models(0, device)
    rays = make_rays(torch.Generator().manual_seed(2), 256, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def fn(models, rays, generator):
        with torch.no_grad():
            out = render_rays(
                models["coarse"], models["fine"], rays, generator,
                N_samples=64, N_importance=128, perturb=1.0, noise_std=1.0,
                white_back=True, use_fused=True, fused_channel_io=True)
        return out["rgb_fine"]

    return fn, (models, rays, gen)


def _dryrun_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of ``dryrun_multichip``: one data-parallel training step of
    the flagship model on its own rays, then a check that every rank holds
    the same parameters."""
    import hashlib
    import os

    import torch.distributed as dist

    from .parallel import mesh as pmesh
    from .training.losses import mse_loss
    from .training.optim import get_optimizer, make_lr_schedule, named_params

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    pmesh.initialize_distributed(device)
    try:
        mesh = pmesh.make_mesh(device, n)
        models = flagship_models(0, mesh.device)
        opt = get_optimizer("adam", make_lr_schedule(5e-4, "steplr", 1, 1),
                            named_params(models))
        pmesh.replicate(list(opt.params.values()), mesh)
        batch = 8  # one step per rank's shard
        gen = torch.Generator().manual_seed(3 + rank)
        rays = make_rays(gen, batch, device=mesh.device)
        rgbs = torch.rand((batch, 3), generator=gen).to(mesh.device)
        rgen = torch.Generator(device=mesh.device).manual_seed(rank)
        out = render_rays(models["coarse"], models["fine"], rays, rgen,
                          N_samples=8, N_importance=8, perturb=1.0,
                          noise_std=1.0, white_back=True, use_fused=True,
                          fused_channel_io=True)
        loss = mse_loss(out, rgbs)
        opt.zero_grad()
        loss.backward()
        pmesh.allreduce_grads(opt.params, mesh)
        opt.step()
        losses = pmesh.process_allgather(
            np.asarray([float(loss)], np.float64), mesh)
        h = hashlib.sha256()
        for p in opt.params.values():
            h.update(p.detach().cpu().numpy().tobytes())
        digests = pmesh.process_allgather(
            np.frombuffer(h.digest(), np.uint8), mesh)
        if not np.isfinite(losses).all():
            raise FloatingPointError(f"non-finite losses {losses.ravel()}")
        if not (digests == digests[0]).all():
            raise AssertionError("the ranks' parameters differ after the step")
        if rank == 0:
            print(f"dryrun_multichip({n}): OK — 1 step a rank, loss "
                  f"{losses.ravel().mean():.4f}, parameters equal on every "
                  "rank", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One data-parallel training step over ``n_devices`` ranks (the
    counterpart of ``__graft_entry__.dryrun_multichip``): one process per
    card over NCCL, or with ``device="cpu"`` per CPU rank over gloo.  Raises
    if a rank fails or the ranks' parameters differ after the step."""
    import torch.multiprocessing as mp

    from .training.launch import free_port

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"CUDA devices; {torch.cuda.device_count()} visible")
    mp.start_processes(_dryrun_rank, args=(n_devices, free_port(), dev.type),
                       nprocs=n_devices, join=True, start_method="spawn")
