"""Batched row-wise ``searchsorted`` (``nerf_pl_tpu/ops/searchsorted.py``).

For each row ``b`` find the insertion index of ``values[b, k]`` in the
sorted row ``sorted_seq[b, :]`` as a branch-free rank
``sum_m [v >= row[m]]`` (``side='right'``; ``>`` for ``'left'``).
``searchsorted_interp`` also returns the two CDF-bin endpoints the
deterministic importance sampler needs, as masked reductions over the row:

    lo = max_{m < M-1} (row[m] if row[m] <= u else 0)
    hi = min_{m >= 1}  (row[m] if row[m] >  u else row[M-1])

Dispatch follows the tensor's device: a CUDA tensor launches the kernel in
``csrc/searchsorted.cu`` (A: rank, B: rank + interp), a CPU tensor runs the
plain version.  Inputs are detached, as the JAX package stop-gradients them.

The rows must be non-decreasing (ties and plateaus allowed) and, for
``searchsorted_interp``, non-negative, as the importance sampler's CDF rows
are: a cumulative sum of non-negative floats after a leading zero.  On such
a row the compares that hold form a prefix, so kernels A and B find the
rank, the prefix's length, by bisection (``ceil(log2(M + 1))`` halving
steps) and return the plain count's value exactly; B then reads ``lo`` and
``hi`` off the row at the rank (``row[min(rank, M-1) - 1]``, or 0, and
``row[min(max(rank, 1), M-1)]``), the values the masked reductions select.
The plain versions keep the full reductions.
"""
from __future__ import annotations

import ctypes

import torch

from . import native


def searchsorted_plain(sorted_seq: torch.Tensor, values: torch.Tensor,
                       side: str = "right") -> torch.Tensor:
    """(B, M), (B, K) -> int32 (B, K)."""
    if side == "right":
        cmp = values[:, :, None] >= sorted_seq[:, None, :]
    elif side == "left":
        cmp = values[:, :, None] > sorted_seq[:, None, :]
    else:
        raise ValueError(f"side must be 'left' or 'right', got {side}")
    return cmp.sum(dim=-1).to(torch.int32)


def searchsorted_interp_plain(sorted_seq: torch.Tensor, values: torch.Tensor):
    """(B, M), (B, K) -> (ranks int32, lo, hi); side='right' semantics."""
    c = sorted_seq[:, None, :]  # (B, 1, M)
    hit = values[:, :, None] >= c  # (B, K, M)
    ranks = hit.sum(dim=-1).to(torch.int32)
    last = sorted_seq[:, -1:][:, None, :]  # (B, 1, 1)
    zero = torch.zeros((), dtype=sorted_seq.dtype, device=sorted_seq.device)
    lo = torch.where(hit[..., :-1], c[..., :-1], zero).amax(dim=-1)
    hi = torch.where(~hit[..., 1:], c[..., 1:], last).amin(dim=-1)
    return ranks, lo, hi


def _lib():
    lib = native.load("searchsorted")
    if not getattr(lib, "_typed", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.searchsorted_rank.argtypes = [p, p, p, i64, i32, i32, i32, i32, p]
        lib.searchsorted_rank.restype = ctypes.c_int
        lib.searchsorted_rank_interp.argtypes = [p, p, p, p, p, i64, i32, i32,
                                                 i32, p]
        lib.searchsorted_rank_interp.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_inputs(sorted_seq: torch.Tensor, values: torch.Tensor):
    for name, t in (("sorted_seq", sorted_seq), ("values", values)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if sorted_seq.device != values.device:
        raise ValueError("sorted_seq and values are on different devices")
    B, M = sorted_seq.shape
    if values.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} rows vs {values.shape[0]}")
    if M < 1 or M * 4 > 48 * 1024:
        raise ValueError(f"row length {M} outside the kernel's 1..12288")
    if B >= 2 ** 31:  # at least one row a CTA
        raise ValueError(f"{B} rows exceed the kernel's grid")
    return B, M, values.shape[1]


def rank_vector_width(values_ptr: int, K: int) -> int:
    """Queries a thread of kernel A or B reads and writes as one vector: 4
    (16 bytes) where every row of ``values`` starts on 16 bytes (K a
    multiple of 4 and ``values_ptr`` 16-byte aligned: a contiguous view at
    another offset is not), else 1.  The outputs are fresh allocations, so
    aligned."""
    return 4 if K % 4 == 0 and values_ptr % 16 == 0 else 1


def searchsorted_cuda(sorted_seq: torch.Tensor, values: torch.Tensor,
                      side: str = "right") -> torch.Tensor:
    """Kernel A: rank on the card, by bisection of each (non-decreasing)
    row; exactly ``searchsorted_plain``'s count on such rows."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side}")
    B, M, K = _check_inputs(sorted_seq, values)
    out = torch.empty((B, K), dtype=torch.int32, device=values.device)
    if B == 0 or K == 0:
        return out
    lib = _lib()
    with torch.cuda.device(values.device):
        err = lib.searchsorted_rank(
            sorted_seq.data_ptr(), values.data_ptr(), out.data_ptr(), B, M, K,
            int(side == "right"), rank_vector_width(values.data_ptr(), K),
            native.stream_of(values))
    native.check(lib, err, "searchsorted_rank")
    searchsorted_cuda.launches += 1
    return out


searchsorted_cuda.launches = 0


def searchsorted_interp_cuda(sorted_seq: torch.Tensor, values: torch.Tensor):
    """Kernel B: rank plus bin endpoints on the card, by bisection of each
    (non-decreasing, non-negative) row; exactly
    ``searchsorted_interp_plain``'s values on such rows."""
    B, M, K = _check_inputs(sorted_seq, values)
    dev = values.device
    ranks = torch.empty((B, K), dtype=torch.int32, device=dev)
    lo = torch.empty((B, K), dtype=torch.float32, device=dev)
    hi = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return ranks, lo, hi
    lib = _lib()
    with torch.cuda.device(values.device):
        err = lib.searchsorted_rank_interp(
            sorted_seq.data_ptr(), values.data_ptr(), ranks.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), B, M, K,
            rank_vector_width(values.data_ptr(), K), native.stream_of(values))
    native.check(lib, err, "searchsorted_rank_interp")
    searchsorted_interp_cuda.launches += 1
    return ranks, lo, hi


searchsorted_interp_cuda.launches = 0


def _dispatch(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no searchsorted for device {t.device}")


def searchsorted(sorted_seq: torch.Tensor, values: torch.Tensor,
                 side: str = "right") -> torch.Tensor:
    """Batched searchsorted; kernel A on CUDA, plain on the CPU."""
    sorted_seq = sorted_seq.detach()
    values = values.detach()
    fn = _dispatch(values, searchsorted_cuda, searchsorted_plain)
    return fn(sorted_seq.contiguous(), values.contiguous(), side)


def searchsorted_interp(sorted_seq: torch.Tensor, values: torch.Tensor):
    """Rank + bin endpoints (side='right'); kernel B on CUDA, plain on the
    CPU."""
    sorted_seq = sorted_seq.detach()
    values = values.detach()
    fn = _dispatch(values, searchsorted_interp_cuda, searchsorted_interp_plain)
    return fn(sorted_seq.contiguous(), values.contiguous())
