"""Micro-probe of the fused MLP kernels on the card (the port of the JAX
package's ``scripts/kernel_probe.py``).

    python -m nerf_pl_tpu_torch.scripts.kernel_probe

Times each route over ITERS = 20 calls (as the TPU probe) after one
warm-up call, with CUDA events, at P = 4096 x 192 points (the training
step's fine pass), and prints ms per call and TFLOP/s:
  * kernel I (``csrc/chain_probe.cu``): a bare chain of eight products of
    the MLP's shapes, x (P, 128) . W0 (128 x 256) . W (256 x 256) x 7, on the
    warpgroup tensor cores (wgmma, the weights streamed by TMA): pure bf16,
    and with f32 accumulation, bias, ReLU and a bf16 recast per layer, as
    the production kernels round.  The ceiling that the fused MLP kernels
    are held against;
  * the same eight products as bf16 ``torch.matmul`` calls (cuBLAS), a
    yardstick beside kernel I, not a route of the port;
  * kernel G at W = 256 on pre-embedded rows (no in-kernel sin);
  * kernel C' (the raw forward), C' + F' (forward and remat backward,
    ``stash_blocks=None``) and D' + E' (the stash route).
The MLP rows count 2 x 593,408 FLOP a point for a forward (the reference
MLP's multiply-adds; the TPU probe counted its kernel's padded 686,000),
4x for the remat route (forward, forward again, dgrad, wgrad) and 3x for the
stash route.  The TPU probe's block-size sweeps are dropped: the CUDA
kernels' tiles do not follow a block argument.  The last line is one JSON
object, ``{"launches": {...}}``: the launches of each kernel during the
probe.  The probe needs a card and refuses to run without one.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

from ..models.embedding import posenc
from ..models.nerf import init_nerf
from ..ops import fused_mlp as fm
from ..ops import native

P = 4096 * 192  # the fine pass's points at batch 4096
K0, N, OUT = 128, 256, 128  # the chain's shapes: x (P, K0), W0 (K0, N), W (N, N)
CHAIN_FLOP_PER_ROW = 2 * (K0 * N + 7 * N * N)
MLP_FLOP_PER_POINT = 2 * 593_408  # the reference MLP's multiply-adds, rgb
ITERS = 20  # timed calls per route, as the TPU probe's scan


def _lib():
    lib = native.load("chain_probe")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nerf_chain.argtypes = [p, p, p, p, ll, i, p]
        lib.nerf_chain.restype = i
        lib._typed = True
    return lib


def _check(t: torch.Tensor, name: str, dtype, cols: int, rows=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != cols or rows not in (None, t.shape[0]):
        raise ValueError(f"{name} must be ({rows or 'P'}, {cols}), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def chain_cuda(x: torch.Tensor, w0: torch.Tensor, w: torch.Tensor,
               fancy: bool = False) -> torch.Tensor:
    """Kernel I on the card: ``x (P, 128)`` f32, ``w0 (128, 256)`` and
    ``w (256, 256)`` bf16 -> ``(P, 128)`` f32, the first 128 columns of the
    eighth product (see ``chain_plain``).  Every tensor must be contiguous
    and start on 16 bytes: TMA reads the weights (16-byte base, 512-byte
    row pitch) and the kernel moves x and out in 8-byte pairs."""
    _check(x, "x", torch.float32, K0)
    _check(w0, "w0", torch.bfloat16, N, K0)
    _check(w, "w", torch.bfloat16, N, N)
    if not x.device == w0.device == w.device:
        raise ValueError("x, w0 and w must be on one device")
    lib = _lib()
    rows = x.shape[0]
    out = torch.empty((rows, OUT), dtype=torch.float32, device=x.device)
    if rows:
        with torch.cuda.device(x.device):
            err = lib.nerf_chain(x.data_ptr(), w0.data_ptr(), w.data_ptr(),
                                 out.data_ptr(), rows, int(fancy),
                                 native.stream_of(x))
        native.check(lib, err, "nerf_chain")
        chain_cuda.launches += 1
    return out


chain_cuda.launches = 0


def chain_plain(x: torch.Tensor, w0: torch.Tensor, w: torch.Tensor,
                fancy: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel I (``_chain_kernel``,
    scripts/kernel_probe.py:58-73), on any device.  Every product takes
    bf16 operands and sums in f32.  Pure: each product's output is rounded
    to bf16 (``preferred_element_type=bf16``), and the result is the eighth
    product's first 128 columns in f32.  Fancy: ``relu`` of the first
    product, then ``relu(h @ W + 0.1)`` seven times, each layer's input
    recast to bf16, the result left in f32."""
    def r(t):
        return t.to(torch.bfloat16).float()

    with torch.no_grad():
        h = r(x) @ w0.float()
        h = torch.relu(h) if fancy else r(h)
        for _ in range(7):
            h = r(h) @ w.float()
            h = torch.relu(h + 0.1) if fancy else r(h)
        return h[:, :OUT].contiguous()


def chain_matmul(x: torch.Tensor, w0: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """The pure chain as eight bf16 ``torch.matmul`` calls (cuBLAS): a
    yardstick for kernel I, not a part of the port."""
    h = torch.matmul(x.to(torch.bfloat16), w0)
    for _ in range(7):
        h = torch.matmul(h, w)
    return h[:, :OUT].float()


def probe_inputs(rows: int, device, seed: int = 0) -> tuple:
    """The chain's inputs as the TPU probe draws them: x ~ N(0, 1) f32,
    W0 ~ 0.1 N(0, 1) and W ~ 0.06 N(0, 1) in bf16, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, K0), generator=gen)
    w0 = (torch.randn((K0, N), generator=gen) * 0.1).to(torch.bfloat16)
    w = (torch.randn((N, N), generator=gen) * 0.06).to(torch.bfloat16)
    return x.to(device), w0.to(device), w.to(device)


def _ms(fn) -> float:
    fn()  # warm-up (and the first call's build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _counters() -> dict:
    return {"I": chain_cuda, **fm.KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available; the probe measures the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"kernel_probe on {torch.cuda.get_device_name(0)}, P = {P}, "
          f"{ITERS} calls per route", flush=True)
    x, w0, w = probe_inputs(P, dev)
    gen = torch.Generator().manual_seed(1)
    xyz = torch.rand((P, 3), generator=gen) * 3.0 - 1.5
    dirs = torch.randn((P, 3), generator=gen)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    xyz, dirs = xyz.to(dev), dirs.to(dev)
    x_emb = torch.cat([posenc(xyz, 10), posenc(dirs, 4)], -1).contiguous()
    x_raw = torch.cat([xyz, dirs, xyz.new_zeros((P, 2))], -1).contiguous()
    model = init_nerf(torch.Generator().manual_seed(0), device=dev)
    bf = torch.bfloat16
    for fn in _counters().values():
        fn.launches = 0

    def grad_route(stash_blocks):
        def step():
            out = fm.fused_nerf_apply_raw(model, xyz, dirs, bf,
                                          stash_blocks=stash_blocks)
            out.square().mean().backward()
        return step

    chain_flop = P * CHAIN_FLOP_PER_ROW
    fwd_flop = P * MLP_FLOP_PER_POINT
    routes = [
        ("chain pure-bf16 (kernel I)",
         lambda: chain_cuda(x, w0, w, False), chain_flop),
        ("chain bias/relu/f32 (kernel I)",
         lambda: chain_cuda(x, w0, w, True), chain_flop),
        ("chain pure-bf16 torch.matmul (cuBLAS)",
         lambda: chain_matmul(x, w0, w), chain_flop),
        ("padded fwd W=256 (no sin; kernel G)",
         lambda: fm.fused_nerf_apply_cuda(model, x_emb, False, bf), fwd_flop),
        ("raw fwd (kernel C')",
         lambda: fm.fused_nerf_apply_raw_cuda(model, x_raw, False, bf),
         fwd_flop),
        ("raw fwd+bwd remat (C' + F')", grad_route(None), 4 * fwd_flop),
        ("raw fwd+bwd STASH (D' + E')", grad_route("auto"), 3 * fwd_flop),
    ]
    for name, fn, flop in routes:
        ms = _ms(fn)
        model.zero_grad(set_to_none=True)
        print(f"{name:44s} {ms:9.3f} ms/iter  {flop / ms / 1e9:7.1f} TF/s",
              flush=True)
    print(json.dumps({"launches": {k: fn.launches
                                   for k, fn in _counters().items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
