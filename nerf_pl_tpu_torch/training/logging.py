"""Metrics/observability (``nerf_pl_tpu/training/logging.py``; reference
§5.5: TestTubeLogger + TensorBoard).

``RunLogger`` writes scalars/images to TensorBoard when available
(``torch.utils.tensorboard`` — host-side only, never on the compute path)
and always appends machine-readable JSONL to ``<log_dir>/<exp>/metrics.jsonl``
so runs are greppable without TensorBoard.  In a process group only rank 0
writes (``primary``): the ranks share the log directory, and N processes
appending to one ``metrics.jsonl`` would interleave every record.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np


def is_primary() -> bool:
    """True on rank 0, or without a process group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class RunLogger:
    def __init__(self, log_dir: str, exp_name: str, use_tensorboard: bool = True,
                 primary: Optional[bool] = None):
        self.dir = os.path.join(log_dir, exp_name)
        self.primary = is_primary() if primary is None else primary
        self._jsonl = None
        self._tb = None
        self._images = True
        # scalar writes come from the main loop while image dumps arrive
        # from the trainers' background writer (utils/io_async.py) —
        # serialize the streams
        self._lock = threading.Lock()
        if not self.primary:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.dir)
            except Exception:
                self._tb = None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        # sink checks happen INSIDE the lock: close() nulls them under it,
        # so a check-then-use outside would race the writer thread
        with self._lock:
            if not self._jsonl:
                return
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
            if self._tb:
                for k, v in values.items():
                    self._tb.add_scalar(k, float(v), int(step))

    def images(self, step: int, tag: str, images: np.ndarray) -> None:
        """images: (N, 3, H, W) float in [0, 1]."""
        with self._lock:
            if self._tb and self._images:
                try:
                    self._tb.add_images(tag, np.asarray(images), int(step))
                except ImportError as e:  # TensorBoard encodes with PIL
                    print(f"[log] image summaries off: {e}", flush=True)
                    self._images = False

    def close(self) -> None:
        with self._lock:
            if self._jsonl:
                self._jsonl.close()
                self._jsonl = None
            if self._tb:
                self._tb.close()
                self._tb = None
