"""Tracing and debugging aids (``nerf_pl_tpu/utils/profiling.py``), in torch.

  * ``profile_trace(log_dir, device)``: a context manager around
    ``torch.profiler`` (CPU activity, and CUDA activity on a card) that
    writes a Chrome-trace JSON, ``*.pt.trace.json``, into ``log_dir``,
    opened after a warm-up step of throwaway launches that the trace leaves
    out.  The
    trainers' ``--profile`` wraps their first epoch in it, into
    ``<log_dir>/<exp_name>/trace``.
  * ``raise_if_not_finite``: ``--debug_nans``, the counterpart of
    ``jax_debug_nans``: one synchronising call that raises
    ``FloatingPointError`` naming the epoch and step whose loss, or any
    parameter or parameter grad, is not finite.  ``torch.autograd.set_detect_anomaly``
    alone does not do this: it does not see a NaN made in the forward pass.
  * ``StepTimer``: rays/s and ms a step.

The JAX package's ``install_preemption_handler`` is not ported: it saves from
inside the signal handler, while the port's trainers set a flag there and
save at the next step boundary, so the state saved is never half an
optimizer step (``training/trainer.py``).  ``enable_compilation_cache`` and
``xla_dump`` are XLA's and have no counterpart.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterable

import torch


# the throwaway launches the tracer collects before a trace opens
WARMUP_LAUNCHES = 1024


@contextlib.contextmanager
def profile_trace(log_dir: str, device=None):
    """``with profile_trace("logs/exp/trace", "cuda"): step()`` -> a Chrome
    trace ``<host>_<pid>.<ms>.pt.trace.json`` in ``log_dir``; yields the
    profiler.  The trace opens on a tracer that has already collected
    ``WARMUP_LAUNCHES`` launches of a throwaway op, synchronised, in
    ``torch.profiler.schedule``'s warm-up step, which the trace leaves out:
    on the card, a tracer that had just started collecting lost the kernel
    events of its first launches (all 47 launches of the first 12 ms of 10
    traced steps of ``scripts/profile_step.py``, late in a long process),
    and a warm-up of one such step's ~940 launches absorbed the loss."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.device(device or "cpu").type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1 << 30)) as prof:
        scratch = torch.zeros(1, device=device)
        for _ in range(WARMUP_LAUNCHES):
            scratch.add_(1)
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


def raise_if_not_finite(loss: torch.Tensor, params: Iterable[torch.Tensor],
                        epoch: int, step: int) -> None:
    """Raise ``FloatingPointError`` unless ``loss``, every parameter and
    every parameter's grad are finite: one flag for all of them, fetched
    once.  The parameters are checked too because the fused MLP kernels'
    ReLU (``fmaxf``) turns a NaN activation into 0, so a NaN weight can
    leave the loss and the grads finite on the card."""
    flags = [torch.isfinite(loss).all()]
    for p in params:
        flags.append(torch.isfinite(p).all())
        if p.grad is not None:
            flags.append(torch.isfinite(p.grad).all())
    if not bool(torch.stack(flags).all()):
        raise FloatingPointError(
            f"--debug_nans: a non-finite loss, parameter or parameter grad at "
            f"epoch {epoch}, step {step} (loss {float(loss.detach())})")


class StepTimer:
    """Rays/s and ms a step over the steps ``update``d so far."""

    def __init__(self):
        self.steps = 0
        self.rays = 0
        self.seconds = 0.0

    def update(self, n_rays: int, dt: float):
        self.steps += 1
        self.rays += n_rays
        self.seconds += dt

    @property
    def rays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9)

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.seconds / max(self.steps, 1)
