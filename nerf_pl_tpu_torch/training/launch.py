"""The shared CLI launch of the port's trainers (``nerf_pl_tpu/training/launch.py``):
parse the flags, persist the config into the run dir before the system is
built (so a dataset-load crash still records it), train.

``--device`` (default ``cuda``) is the port's own flag; every other flag
parses as ``config.get_opts`` parses it.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Optional, Sequence

from ..config import Config, get_opts


def launch(system_cls: Callable, allowed_datasets: Optional[Sequence[str]] = None,
           argv=None):
    """Train ``system_cls`` on the command line ``argv``; returns the system."""
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg: Config = get_opts(rest)
    if allowed_datasets is not None and cfg.dataset_name not in allowed_datasets:
        raise ValueError(
            f"--dataset_name {cfg.dataset_name!r} not supported by this "
            f"trainer (expected one of {sorted(allowed_datasets)})")
    os.makedirs(os.path.join(cfg.log_dir, cfg.exp_name), exist_ok=True)
    cfg.save(os.path.join(cfg.log_dir, cfg.exp_name, "config.json"))
    system = system_cls(cfg, device=args.device)
    system.fit()
    return system
