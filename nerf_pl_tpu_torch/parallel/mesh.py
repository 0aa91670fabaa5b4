"""Data parallelism over ``torch.distributed`` (``nerf_pl_tpu/parallel/mesh.py``;
the reference trains with Lightning DDP over NCCL, ``train.py:174-175``).

The JAX package lays one 1-D ``'rays'`` mesh over every chip and runs the
step inside ``shard_map``: row-sharded ray buffers, replicated parameters,
``pmean`` of the grads, the loss and the PSNR.  PyTorch has one device per
process, so here the mesh is the process group: one rank per device, each
running the per-rank body directly (``shard_map`` has no counterpart), with
NCCL between cards and gloo on the CPU.

  * ``initialize_distributed`` joins the group ``torchrun``'s environment
    describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``); without one it says so on stderr and stays single-process.
  * ``make_mesh`` -> ``Mesh(size, rank, device, distributed)``; size 1
    without a group is the single-process path, with no collective at all.
  * ``shard_rays`` takes this rank's contiguous block of rows
    (``[r n/d, (r+1) n/d)`` after truncating to a multiple of d), or with
    ``local=True`` truncates each rank's own rows to the global minimum.
  * ``replicate`` broadcasts tensors from rank 0; ``process_allgather``
    gathers a small host array from every rank.
  * ``all_gather_tiled`` concatenates every rank's rows under autograd; its
    backward sums the full gradient over the ranks and keeps this rank's
    slice (``psum_scatter``, the transpose of JAX's tiled ``all_gather``).
  * ``GradAllReduce`` averages the grads with one all-reduce a step over one
    preallocated float32 buffer that the grads are views of, queued on the
    current stream.

``COUNTS`` counts the collectives each function issues (read by
``chip_smoke.py``).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

COUNTS: Dict[str, int] = {"allreduce_grads": 0, "all_gather_tiled": 0,
                          "broadcast": 0, "process_allgather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def launched_by_torchrun() -> bool:
    """True when the environment describes a process group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group of the environment (``env://``), with NCCL for
    ``cuda`` and gloo for ``cpu`` unless ``backend`` is given.  Returns
    whether a group is up.  Without a group in the environment the run stays
    single-process, and says so: a wrong address here would otherwise leave
    N processes training N models that never meet."""
    if dist.is_initialized():
        return True
    if not launched_by_torchrun():
        print("initialize_distributed: proceeding single-process (no RANK "
              "and WORLD_SIZE in the environment)", file=sys.stderr)
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank() if device.index is None
                              else device.index)
    dist.init_process_group(backend or backend_for(device),
                            init_method="env://")
    return True


@dataclass
class Mesh:
    """One rank per device.  ``distributed``: a process group is up (even
    of size 1); its collectives run on the default group.  The mesh holds
    no reference to the group, so ``destroy_process_group`` frees it: a
    gloo group left for the interpreter's exit to free could abort a rank
    there."""

    size: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    distributed: bool = False

    @property
    def primary(self) -> bool:
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where small host values go for a collective: the card under
        NCCL, else the CPU."""
        if self.distributed and dist.get_backend() == "nccl":
            return self.device
        return torch.device("cpu")


def make_mesh(device, num_devices: Optional[int] = None) -> Mesh:
    """The mesh of this process: the group's size and rank when a group is
    up (``num_devices``, when given, must equal its size), else one device.
    ``device`` ``cuda`` without an index becomes ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if not dist.is_initialized():
        if (num_devices or 1) > 1:
            raise ValueError(
                f"--num_devices {num_devices} needs one process per device: "
                "start the run through the trainer CLI (it spawns them) or "
                "torchrun, not a single process")
        return Mesh(1, 0, device)
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices and num_devices != size:
        raise ValueError(f"--num_devices {num_devices} but the process group "
                         f"has {size} ranks")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    return Mesh(size, rank, device, distributed=True)


def rank_seed(seed: int, purpose: int, rank: int) -> int:
    """A seed for one purpose on one rank; rank 0 keeps the single-process
    seed so a world of one draws what a run without a group draws."""
    if rank == 0:
        return seed + purpose
    return int(np.random.SeedSequence([seed, purpose, rank]).generate_state(1)[0])


# ------------------------------------------------------------ data layout
def allreduce_int(value: int, mesh: Mesh, op) -> int:
    t = torch.tensor([value], dtype=torch.int64, device=mesh.comm_device)
    dist.all_reduce(t, op=op)
    return int(t.item())


def shard_rays(buf, mesh: Mesh, local: bool = False):
    """This rank's rows of a (N, C) buffer (numpy or tensor).

    ``local=False``: every rank holds the same global buffer and takes the
    contiguous block ``[r*(N//d), (r+1)*(N//d))`` (at most d-1 rows dropped,
    as DistributedSampler rounds).  ``local=True``: each rank holds only its
    own rows (``--per_host_data``); every rank keeps the global minimum of
    the ranks' row counts, agreed by one all-reduce of an int64."""
    d = mesh.size
    if d == 1:
        return buf
    if local:
        per = allreduce_int(int(buf.shape[0]), mesh, dist.ReduceOp.MIN)
        return buf[:per]
    per = buf.shape[0] // d
    return buf[mesh.rank * per:(mesh.rank + 1) * per]


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast each tensor from rank 0, in place (parameters and optimiser
    state, once at build and after a resume)."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t,
                           src=0)
            COUNTS["broadcast"] += 1


def process_allgather(x, mesh: Mesh) -> np.ndarray:
    """A small host array from every rank, stacked on a new leading axis
    (``multihost_utils.process_allgather``)."""
    arr = np.asarray(x)
    if not mesh.distributed:
        return arr[None]
    t = torch.from_numpy(np.array(arr)).to(mesh.comm_device)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    COUNTS["process_allgather"] += 1
    return torch.stack(parts).cpu().numpy()


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order (no autograd)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        COUNTS["all_gather_tiled"] += 1
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        # every rank differentiated its own copy of what follows the
        # gather: the cotangent of rank r's rows is the sum over ranks
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        r, n = ctx.mesh.rank, ctx.n
        return g[r * n:(r + 1) * n], None


def all_gather_tiled(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """JAX's ``all_gather(x, 'rays', tiled=True)`` under autograd; the
    identity on one rank.  Every rank must hold the same number of rows."""
    if mesh.size == 1:
        return x
    return _AllGatherTiled.apply(x, mesh)


class GradAllReduce:
    """The mean of the grads over the ranks, one collective a step.

    Every parameter's grad is a view into one preallocated float32 buffer
    (DDP's bucket views): ``zero_grad`` zeroes the buffer and backward
    accumulates into the views in place, so the all-reduce (``SUM``, then a
    division by the size) runs on the grads themselves, with no copy.  A
    parameter that got no grad keeps its zeros, which the optimisers read
    as no grad.  A grad that is not its view (set by other code) is copied
    in first.  On a card every op is queued on the current stream: nothing
    waits on the host.  ``n_extra`` trailing slots carry small values summed
    alongside (the preemption flag)."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], mesh: Mesh,
                 n_extra: int = 0):
        self.params = list(params.values())
        self.mesh = mesh
        self.total = sum(p.numel() for p in self.params)
        self.buf = torch.zeros(self.total + n_extra, dtype=torch.float32,
                               device=self.params[0].device)
        self.views, off = [], 0
        for p in self.params:
            self.views.append(self.buf[off:off + p.numel()].view(p.shape))
            off += p.numel()

    def zero_grad(self) -> None:
        """Zero the buffer (grads and extra slots) and make every grad its
        view again."""
        self.buf.zero_()
        for p, v in zip(self.params, self.views):
            if p.grad is not v:
                p.grad = v

    def __call__(self, extra: Optional[List[float]] = None) -> torch.Tensor:
        """Average the grads in place; returns the summed extra slots."""
        with torch.no_grad():
            for p, v in zip(self.params, self.views):
                if p.grad is None:
                    v.zero_()
                elif p.grad.data_ptr() != v.data_ptr():
                    v.copy_(p.grad)
                p.grad = v
            for i, x in enumerate(extra or ()):
                self.buf[self.total + i].fill_(float(x))
            dist.all_reduce(self.buf, op=dist.ReduceOp.SUM)
            COUNTS["allreduce_grads"] += 1
            if self.mesh.size > 1:
                self.buf[:self.total].div_(self.mesh.size)
        return self.buf[self.total:]


def allreduce_grads(params: Dict[str, torch.nn.Parameter], mesh: Mesh) -> None:
    """``pmean`` of the grads, once (a loop keeps its ``GradAllReduce``)."""
    if mesh.distributed:
        GradAllReduce(params, mesh)()
