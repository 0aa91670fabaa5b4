"""Adam and the step-LR schedule, as the JAX package composes them with
optax (``nerf_pl_tpu/training/optim.py``).

  * ``get_optimizer("adam", schedule)`` is
    ``optax.chain([add_decayed_weights(wd),] scale_by_adam(eps=1e-8),
    scale_by_learning_rate(schedule))``: moments with bias correction, the
    update ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-schedule(count)``.
    Its state is saved in optax's layout, ``((), ScaleByAdamState(count, mu,
    nu), ScaleByScheduleState(count))`` (the first entry only with weight
    decay), so checkpoints move both ways between the trainers.
  * ``--grad_clip`` scales the grads by ``min(1, clip / global_norm)``
    before the chain, statelessly; each grad keeps its dtype.
  * ``make_lr_schedule`` with ``steplr``: epoch-granular MultiStepLR driven
    by the global step.

sgd, radam, adamw, ranger, the cosine and poly schedules and warmup are not
ported yet and raise (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch

_NOT_PORTED = "is not ported yet (see ROADMAP.md, Queue 1)"


def make_lr_schedule(
    lr: float,
    lr_scheduler: str,
    steps_per_epoch: int,
    num_epochs: int,
    decay_step: Sequence[int] = (20,),
    decay_gamma: float = 0.1,
    poly_exp: float = 0.9,
    warmup_multiplier: float = 1.0,
    warmup_epochs: int = 0,
    optimizer: str = "adam",
) -> Callable[[int], float]:
    """``schedule(step)`` -> the float32 learning rate of that global step."""
    if lr_scheduler != "steplr":
        raise ValueError(f"lr_scheduler {lr_scheduler!r} {_NOT_PORTED}")
    if warmup_epochs > 0 and optimizer not in ("radam", "ranger"):
        raise ValueError(f"warmup {_NOT_PORTED}")
    milestones = np.asarray(sorted(decay_step), np.float32)

    def schedule(step: int) -> float:
        epoch = np.float32(step // steps_per_epoch)
        n = int(np.sum(epoch >= milestones))
        # float32 throughout, as the JAX schedule computes it
        return float(np.float32(lr) * np.float32(decay_gamma) ** np.float32(n))

    return schedule


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` (on the CPU) on ``device``; to a card by a non-blocking copy
    from pinned memory, which the host does not wait for."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class Adam:
    """optax's ``scale_by_adam`` + ``scale_by_learning_rate`` over named
    parameters, updated in place.  ``params``: ``{name: Parameter}`` with
    names ``"<model>/<path>"`` as in the JAX param tree (``coarse/
    xyz_layers/0/w``).  A parameter whose grad is None takes a zero grad, as
    JAX differentiates every leaf."""

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        self.params = dict(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.count = 0  # ScaleByAdamState.count
        self.sched_count = 0  # ScaleByScheduleState.count
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _grads(self) -> Dict[str, torch.Tensor]:
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        if self.grad_clip > 0:
            # stateless global-norm clip; every grad keeps its dtype
            gn = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                for g in grads.values()))
            scale = torch.clamp(self.grad_clip / torch.clamp(gn, min=1e-12),
                                max=1.0)
            grads = {k: (g * scale).to(g.dtype) for k, g in grads.items()}
        return grads

    @torch.no_grad()
    def step(self) -> None:
        """One update with no synchronising call: the step's scalars reach
        each parameter's device in one copy from pinned memory, queued
        behind the work already on the stream.  They stay tensors on that
        device, so the divisions and the ``lr`` product take the same
        kernels, and give the same bits, as ever (a CPU scalar divisor
        would make CUDA's ``div`` multiply by its reciprocal), and the
        product is rounded before the add (no fused multiply-add)."""
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        # float32 bias corrections, as optax computes decay ** count
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        lr = torch.tensor(-self.schedule(self.sched_count), dtype=torch.float32)
        host = torch.stack([c1, c2, lr])
        scalars: dict = {}
        for k, g in self._grads().items():
            p = self.params[k]
            key = (p.device, p.dtype)
            if key not in scalars:
                scalars[key] = host_to_device(host.to(p.dtype), p.device)
            c1_p, c2_p, lr_p = scalars[key]
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            mu_hat = mu / c1_p
            nu_hat = nu / c2_p
            update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            p.add_(lr_p * update)
        self.count = count
        self.sched_count += 1

    # ------------------------------------------------- optax state layout
    def state_tree(self) -> dict:
        """The optax state as a flax state dict (tuples as ``"0".."n"``)."""
        def tree(d):
            out: dict = {}
            for k, v in d.items():
                node = out
                *path, leaf = k.split("/")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = v.detach().cpu()
            return out

        adam = {"count": np.asarray(self.count, np.int32),
                "mu": tree(self.mu), "nu": tree(self.nu)}
        sched = {"count": np.asarray(self.sched_count, np.int32)}
        entries = ([{}] if self.weight_decay > 0 else []) + [adam, sched]
        return {str(i): e for i, e in enumerate(entries)}

    def load_state_tree(self, state: dict) -> None:
        """Restore from ``state_tree``'s layout, as either trainer wrote it."""
        first = 1 if self.weight_decay > 0 else 0
        if set(state) != {str(i) for i in range(first + 2)}:
            raise ValueError(f"optimizer state has entries {sorted(state)}; "
                             f"expected {first + 2} (adam"
                             f"{' with weight decay' if first else ''})")
        adam, sched = state[str(first)], state[str(first + 1)]

        def leaf(tree, key):
            node = tree
            for part in key.split("/"):
                node = node[part]
            return node

        with torch.no_grad():
            for k, p in self.params.items():
                for mine, src in ((self.mu, adam["mu"]), (self.nu, adam["nu"])):
                    arr = np.asarray(leaf(src, k), np.float32)
                    if tuple(arr.shape) != tuple(p.shape):
                        raise ValueError(f"optimizer state {k}: shape "
                                         f"{arr.shape} != {tuple(p.shape)}")
                    mine[k].copy_(torch.from_numpy(arr))
        self.count = int(adam["count"])
        self.sched_count = int(sched["count"])


def get_optimizer(optimizer: str, schedule: Callable[[int], float],
                  params: Dict[str, torch.nn.Parameter],
                  momentum: float = 0.9, weight_decay: float = 0.0,
                  grad_clip: float = 0.0) -> Adam:
    """The JAX package's ``get_optimizer`` for ``adam`` over ``params``."""
    del momentum  # sgd only
    if optimizer != "adam":
        raise ValueError(f"optimizer {optimizer!r} {_NOT_PORTED}")
    if not math.isfinite(grad_clip) or grad_clip < 0:
        raise ValueError(f"grad_clip must be >= 0, got {grad_clip}")
    return Adam(params, schedule, eps=1e-8, weight_decay=weight_decay,
                grad_clip=grad_clip)


def named_params(models: dict) -> Dict[str, torch.nn.Parameter]:
    """``{"coarse": NeRF, ...}`` -> ``{"coarse/xyz_layers/0/w": param}``."""
    return {f"{name}/{k.replace('.', '/')}": p
            for name, m in models.items() for k, p in m.named_parameters()}
