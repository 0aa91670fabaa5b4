"""The optimisers and learning-rate schedules, as the JAX package composes
them with optax (``nerf_pl_tpu/training/optim.py``; reference
``utils/__init__.py:10-49``).

  * ``get_optimizer(name, schedule, params)`` over named parameters,
    updated in place.  Each optimiser is the JAX package's optax chain:

      - ``sgd``: ``[add_decayed_weights(wd),] [trace(momentum),]
        scale_by_learning_rate`` (no trace at momentum 0);
      - ``adam``: ``[add_decayed_weights(wd),] scale_by_adam(eps=1e-8),
        scale_by_learning_rate`` (coupled, torch-style weight decay);
      - ``adamw``: ``scale_by_adam, [add_decayed_weights(wd),]
        scale_by_learning_rate`` (decoupled decay, after the core step);
      - ``radam``: ``scale_by_radam(b1=0.9)`` in adamw's place: the
        rectified update where ``ro >= 5``, else the bias-corrected first
        moment;
      - ``ranger``: the radam chain with ``b1=0.95`` inside
        ``lookahead(k=6, alpha=0.5)``: every 6th step the slow weights move
        half way to the fast ones and the parameters take the slow weights'
        place, applied as the update ``new_slow - p`` (``p + (new_slow - p)``,
        as ``optax.apply_updates`` applies it).

    Each step makes no synchronising call: the step's scalars (the bias
    corrections, the radam rectifier, the rate) are computed on the host from
    the step count, in float32 as optax computes them, and reach each
    parameter's device in one non-blocking copy from pinned memory; whether
    a step is rectified or syncs is decided on the host from the count.
  * The state is saved in optax's layout as a flax state dict (tuples as
    ``"0".."n"``, named tuples by field: ``EmptyState`` ``{}``,
    ``TraceState(trace)``, ``ScaleByAdamState(count, mu, nu)``,
    ``ScaleByScheduleState(count)``, ``LookaheadState(inner, slow, count)``),
    so full-state checkpoints move both ways between the trainers.
  * ``--grad_clip`` scales the grads by ``min(1, clip / global_norm)``
    before the chain, statelessly; each grad keeps its dtype.
  * ``make_lr_schedule``: epoch-granular ``steplr`` (MultiStepLR),
    ``cosine`` (CosineAnnealingLR, eta_min 1e-8) and ``poly``, driven by the
    global step, optionally behind the reference's GradualWarmupScheduler
    (a linear ramp to ``lr * multiplier``, the base schedule one epoch behind
    the warm-up's end); radam and ranger take no warm-up.  Computed in
    float32 as the JAX schedule computes it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

_F32 = np.float32


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
    if lr_scheduler not in ("steplr", "cosine", "poly"):
        raise ValueError(f"scheduler {lr_scheduler!r} not recognized!")
    eps = 1e-8
    milestones = np.asarray(sorted(decay_step), _F32)

    def base(epoch: np.float32, peak_lr: float) -> np.float32:
        # a Python float meets a float32 value as JAX's weak type does: it is
        # rounded to float32 first
        if lr_scheduler == "steplr":
            n = int(np.sum(epoch >= milestones))
            return _F32(peak_lr) * _F32(decay_gamma) ** _F32(n)
        if lr_scheduler == "cosine":
            arg = _F32(np.pi) * epoch / _F32(num_epochs)
            return _F32(eps) + _F32((peak_lr - eps) * 0.5) * (
                _F32(1.0) + np.cos(arg))
        return _F32(peak_lr) * (_F32(1.0) - epoch / _F32(num_epochs)) ** _F32(
            poly_exp)

    use_warmup = warmup_epochs > 0 and optimizer not in ("radam", "ranger")

    def schedule(step: int) -> float:
        epoch = _F32(step // steps_per_epoch)
        if not use_warmup:
            return float(base(epoch, lr))
        if epoch <= warmup_epochs:
            return float(_F32(lr) * (_F32(warmup_multiplier - 1.0) * epoch
                                     / _F32(warmup_epochs) + _F32(1.0)))
        # the reference's wrapper starts the after-schedule one epoch late
        return float(base(epoch - _F32(warmup_epochs) - _F32(1.0),
                          warmup_multiplier * lr))

    return schedule


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` (on the CPU) on ``device``; to a card by a non-blocking copy
    from pinned memory, which the host does not wait for."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _tree(d: Dict[str, torch.Tensor]) -> dict:
    """``{"coarse/xyz_layers/0/w": t}`` -> the nested flax state dict.  The
    leaves are the optimiser's own tensors (detached, on their device), which
    the next step updates in place: a writer snapshots them first
    (``utils/io_async.py::snapshot``)."""
    out: dict = {}
    for k, v in d.items():
        node = out
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.detach()
    return out


def _count(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


class Optimizer:
    """An optax chain over named parameters, updated in place.  ``params``:
    ``{name: Parameter}`` with names ``"<model>/<path>"`` as in the JAX param
    tree (``coarse/xyz_layers/0/w``).  A parameter whose grad is None takes a
    zero grad, as JAX differentiates every leaf.  Subclasses give the chain:
    ``_scalars`` (the step's float32 host scalars), ``_update`` (one
    parameter's update before the rate), ``_slots`` (the chain's states in
    optax's order) and ``_load_slots``."""

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
        self.params = dict(params)
        self.schedule = schedule
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.sched_count = 0  # ScaleByScheduleState.count

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

    # -- the chain ----------------------------------------------------------
    def _scalars(self) -> List[torch.Tensor]:
        return []

    def _update(self, k: str, g: torch.Tensor, p: torch.Tensor,
                sc: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _apply(self, k: str, p: torch.Tensor, u: torch.Tensor) -> None:
        p.add_(u)

    def _advance(self) -> None:
        self.sched_count += 1

    @torch.no_grad()
    def step(self) -> None:
        """One update with no synchronising call: the step's scalars reach
        each parameter's device in one copy from pinned memory, queued
        behind the work already on the stream.  They stay tensors on that
        device, so the divisions and the ``lr`` product take the same
        kernels, and give the same bits, on every device (a CPU scalar
        divisor would make CUDA's ``div`` multiply by its reciprocal), and
        each product is rounded before its add (no fused multiply-add)."""
        lr = torch.tensor(-self.schedule(self.sched_count), dtype=torch.float32)
        host = torch.stack(self._scalars() + [lr])
        scalars: dict = {}
        for k, g in self._grads().items():
            p = self.params[k]
            key = (p.device, p.dtype)
            if key not in scalars:
                scalars[key] = host_to_device(host.to(p.dtype), p.device)
            sc = scalars[key]
            self._apply(k, p, sc[-1] * self._update(k, g, p, sc))
        self._advance()

    # -- optax state layout ---------------------------------------------------
    def _slots(self) -> List[dict]:
        raise NotImplementedError

    def _load_slots(self, slots: List[dict]) -> None:
        raise NotImplementedError

    def _sched_slot(self) -> dict:
        return {"count": _count(self.sched_count)}

    def state_tree(self) -> dict:
        """The optax state as a flax state dict, its tensors shared with the
        optimiser (see ``_tree``)."""
        return {str(i): e for i, e in enumerate(self._slots())}

    def load_state_tree(self, state: dict) -> None:
        """Restore from ``state_tree``'s layout, as either trainer wrote it."""
        n = len(self._slots())
        if set(state) != {str(i) for i in range(n)}:
            raise ValueError(
                f"optimizer state has entries {sorted(state)}; expected {n} "
                f"({self.describe()})")
        self._load_slots([state[str(i)] for i in range(n)])

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimiser's state (the moments, the trace,
        lookahead's slow weights), for ``parallel.mesh.replicate``."""
        out = []
        for name in ("trace", "mu", "nu", "slow"):
            slot = getattr(self, name, None)
            if slot:
                out.extend(slot.values())
        return out

    def describe(self) -> str:
        wd = " with weight decay" if self.weight_decay > 0 else ""
        return f"{self.name}{wd}"

    def _load_tree(self, mine: Dict[str, torch.Tensor], src: dict,
                   what: str) -> None:
        with torch.no_grad():
            for k, p in self.params.items():
                node = src
                for part in k.split("/"):
                    node = node[part]
                arr = np.asarray(node, np.float32)
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"optimizer state {what} {k}: shape "
                                     f"{arr.shape} != {tuple(p.shape)}")
                mine[k].copy_(torch.from_numpy(arr))


class SGD(Optimizer):
    """``[add_decayed_weights,] [trace(momentum),] scale_by_learning_rate``."""

    name = "sgd"

    def __init__(self, params, schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        super().__init__(params, schedule, weight_decay, grad_clip)
        self.momentum = momentum
        self.trace = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                      if momentum > 0 else None)

    def _update(self, k, g, p, sc):
        if self.weight_decay > 0:
            g = g + self.weight_decay * p
        if self.trace is None:
            return g
        tr = self.trace[k]
        tr.copy_(g + self.momentum * tr)
        return tr

    def _slots(self):
        slots = [{}] if self.weight_decay > 0 else []
        if self.trace is not None:
            slots.append({"trace": _tree(self.trace)})
        return slots + [self._sched_slot()]

    def _load_slots(self, slots):
        if self.trace is not None:
            self._load_tree(self.trace, slots[-2]["trace"], "trace")
        self.sched_count = int(slots[-1]["count"])


class Adam(Optimizer):
    """``scale_by_adam`` + ``scale_by_learning_rate``; with ``weight_decay``
    the coupled ``add_decayed_weights`` first (``decoupled=False``) or,
    for adamw, after the core (``decoupled=True``)."""

    def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0, decoupled: bool = False):
        super().__init__(params, schedule, weight_decay, grad_clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decoupled = decoupled
        self.name = "adamw" if decoupled else "adam"
        self.count = 0  # ScaleByAdamState.count
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def _bias(self, count: int):
        # float32 bias corrections, as optax computes decay ** count
        b2t = torch.tensor(self.b2, dtype=torch.float32) ** count
        return 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** count, \
            b2t, 1.0 - b2t

    def _scalars(self):
        c1, _, c2 = self._bias(self.count + 1)
        return [c1, c2]

    def _moments(self, k, g, p, sc):
        if self.weight_decay > 0 and not self.decoupled:
            g = g + self.weight_decay * p
        b1, b2 = self.b1, self.b2
        mu, nu = self.mu[k], self.nu[k]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        return mu / sc[0], nu / sc[1]

    def _core(self, mu_hat, nu_hat, sc):
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)

    def _update(self, k, g, p, sc):
        u = self._core(*self._moments(k, g, p, sc), sc)
        if self.weight_decay > 0 and self.decoupled:
            u = u + self.weight_decay * p
        return u

    def _advance(self):
        self.count += 1
        super()._advance()

    def _adam_slot(self):
        return {"count": _count(self.count), "mu": _tree(self.mu),
                "nu": _tree(self.nu)}

    def _slots(self):
        wd = [{}] if self.weight_decay > 0 else []
        if self.decoupled:
            return [self._adam_slot()] + wd + [self._sched_slot()]
        return wd + [self._adam_slot(), self._sched_slot()]

    def _load_slots(self, slots):
        adam = slots[0 if self.decoupled or self.weight_decay <= 0 else 1]
        self._load_tree(self.mu, adam["mu"], "mu")
        self._load_tree(self.nu, adam["nu"], "nu")
        self.count = int(adam["count"])
        self.sched_count = int(slots[-1]["count"])


class RAdam(Adam):
    """optax's ``scale_by_radam`` (threshold 5) with the decoupled weight
    decay after it: ``r * mu_hat / (sqrt(nu_hat) + eps)`` where the
    variance is tractable (``ro >= 5``), else ``mu_hat``."""

    threshold = 5.0

    def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
        super().__init__(params, schedule, b1, b2, eps, weight_decay,
                         grad_clip, decoupled=True)
        self.name = "radam"
        self._rectified = False

    def _scalars(self):
        count = self.count + 1
        c1, b2t, c2 = self._bias(count)
        # optax's order, all in float32
        f32 = dict(dtype=torch.float32)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = torch.tensor(ro_inf, **f32) - torch.tensor(2 * count, **f32) \
            * b2t / (1 - b2t)
        self._rectified = bool(ro >= self.threshold)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * torch.tensor(ro_inf, **f32)
                       / (torch.tensor((ro_inf - 4.0) * (ro_inf - 2.0), **f32)
                          * ro))
        return [c1, c2, r]

    def _core(self, mu_hat, nu_hat, sc):
        if not self._rectified:
            return mu_hat
        return sc[2] * mu_hat / (torch.sqrt(nu_hat) + self.eps)


class Ranger(RAdam):
    """The radam chain (``b1 = 0.95``) inside ``lookahead(k=6, alpha=0.5)``,
    whose state is ``LookaheadState(inner, slow, count)``."""

    k, alpha = 6, 0.5

    def __init__(self, params, schedule, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        super().__init__(params, schedule, b1=0.95, eps=eps,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self.name = "ranger"
        self.la_count = 0  # LookaheadState.count
        self.slow = {k: p.detach().clone() for k, p in self.params.items()}

    def _apply(self, k, p, u):
        if (self.la_count + 1) % self.k:
            p.add_(u)
            return
        slow = self.slow[k]
        slow.copy_(slow + self.alpha * ((p + u) - slow))
        p.add_(slow - p)

    def _advance(self):
        self.la_count += 1
        super()._advance()

    def state_tree(self) -> dict:
        return {"inner": super().state_tree(), "slow": _tree(self.slow),
                "count": _count(self.la_count)}

    def load_state_tree(self, state: dict) -> None:
        if not isinstance(state, dict) or set(state) != {"inner", "slow",
                                                         "count"}:
            raise ValueError(f"optimizer state has entries "
                             f"{sorted(state)}; expected a LookaheadState "
                             f"(inner, slow, count) for {self.describe()}")
        super().load_state_tree(state["inner"])
        self._load_tree(self.slow, state["slow"], "slow")
        self.la_count = int(state["count"])


def get_optimizer(optimizer: str, schedule: Callable[[int], float],
                  params: Dict[str, torch.nn.Parameter],
                  momentum: float = 0.9, weight_decay: float = 0.0,
                  grad_clip: float = 0.0) -> Optimizer:
    """The JAX package's ``get_optimizer`` over ``params``."""
    if not math.isfinite(grad_clip) or grad_clip < 0:
        raise ValueError(f"grad_clip must be >= 0, got {grad_clip}")
    kw = dict(weight_decay=weight_decay, grad_clip=grad_clip)
    if optimizer == "sgd":
        return SGD(params, schedule, momentum=momentum, **kw)
    if optimizer in ("adam", "adamw"):
        return Adam(params, schedule, eps=1e-8, decoupled=optimizer == "adamw",
                    **kw)
    if optimizer == "radam":
        return RAdam(params, schedule, eps=1e-8, **kw)
    if optimizer == "ranger":
        return Ranger(params, schedule, eps=1e-8, **kw)
    raise ValueError(f"optimizer {optimizer!r} not recognized!")


def named_params(models: dict) -> Dict[str, torch.nn.Parameter]:
    """``{"coarse": NeRF, ...}`` -> ``{"coarse/xyz_layers/0/w": param}``."""
    return {f"{name}/{k.replace('.', '/')}": p
            for name, m in models.items() for k, p in m.named_parameters()}
