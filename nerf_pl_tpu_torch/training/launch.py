"""The shared CLI launch of the port's trainers (``nerf_pl_tpu/training/launch.py``):
parse the flags, persist the config into the run dir before the system is
built (so a dataset-load crash still records it), train.

``--device`` (default ``cuda``) is the port's own flag; every other flag
parses as ``config.get_opts`` parses it.

PyTorch drives one device a process, so the launcher takes the place of
JAX's one controller over many devices:

  * ``--multihost``, or an environment ``torchrun`` set up (``RANK``,
    ``WORLD_SIZE``): this process is one rank of that group.
  * ``--num_devices N > 1`` otherwise: N workers are spawned on a localhost
    TCP store, rank i on ``cuda:i`` (NCCL), or on the CPU over gloo with
    ``--device cpu``.  A worker's exception makes the launch raise.
  * ``--num_devices`` unset means every visible device, as in JAX: every
    card with ``--device cuda``, one process with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Callable, Optional, Sequence

import torch

from .. import resolve_device
from ..config import Config, get_opts
from ..parallel import mesh as pmesh


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_size(cfg: Config, device: torch.device) -> int:
    """The ranks ``--num_devices`` asks for on ``device``."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = visible if cfg.num_devices is None else cfg.num_devices
    if n < 1:
        raise ValueError(f"--num_devices must be positive, got {n}")
    if device.type == "cuda" and n > visible:
        raise ValueError(f"--num_devices {n} exceeds the {visible} visible "
                         "CUDA devices")
    return n


def _save_config(cfg: Config) -> None:
    os.makedirs(os.path.join(cfg.log_dir, cfg.exp_name), exist_ok=True)
    cfg.save(os.path.join(cfg.log_dir, cfg.exp_name, "config.json"))


def _train(system_cls: Callable, cfg: Config, device: str):
    system = system_cls(cfg, device=device)
    try:
        system.fit()
    finally:
        if system.mesh.distributed:
            pmesh.dist.destroy_process_group()
    return system


def _worker(rank: int, n: int, port: int, system_cls: Callable, cfg: Config,
            device: str) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    _train(system_cls, cfg, device)


def launch(system_cls: Callable, allowed_datasets: Optional[Sequence[str]] = None,
           argv=None):
    """Train ``system_cls`` on the command line ``argv``; returns the system
    of this process (None when it spawned the workers)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg: Config = get_opts(rest)
    if allowed_datasets is not None and cfg.dataset_name not in allowed_datasets:
        raise ValueError(
            f"--dataset_name {cfg.dataset_name!r} not supported by this "
            f"trainer (expected one of {sorted(allowed_datasets)})")
    device = resolve_device(args.device)
    if cfg.multihost or pmesh.launched_by_torchrun():
        if os.environ.get("RANK", "0") == "0":
            _save_config(cfg)
        return _train(system_cls, cfg, args.device)
    n = world_size(cfg, device)
    _save_config(cfg)
    if n == 1:
        return _train(system_cls, cfg, args.device)
    import torch.multiprocessing as mp

    mp.start_processes(_worker, args=(n, free_port(), system_cls, cfg,
                                      args.device),
                       nprocs=n, join=True, start_method="spawn")
    return None
