"""The fused NeRF MLP forward on channel-major input
(``nerf_pl_tpu/ops/fused_mlp.py::fused_nerf_apply_raw_t``).

``fused_nerf_apply_raw_t(model, x_rawT)`` takes ``(8, P)`` float32 rows
``[xyz(3) | dir(3) | 0 0]`` and returns ``(8, P)`` float32: rows
``[rgb(3) | sigma | 0 x 4]``, or sigma in row 0 and zeros below when
``sigma_only``.  The positional encoding (10 xyz / 4 dir frequencies) runs
inside the kernel.

Dispatch follows the input's device: a CUDA tensor launches kernel C
(``csrc/fused_mlp.cu``), a CPU tensor runs ``fused_nerf_apply_raw_t_plain``
(``posenc`` + ``NeRF.forward`` on the raw layout, same rounding).  Only the
forward exists on the card: parameters that require grad raise there.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.embedding import posenc
from ..models.nerf import NeRF
from . import native

# the reference architecture the kernel is written for (models/nerf.py)
D, W, CX, CD, WH, SKIP = 8, 256, 63, 27, 128, 4
XYZ_FREQS, DIR_FREQS = 10, 4
RAW_COLS = OUT_COLS = 8


def supports_fused(model) -> bool:
    """The kernel is specialised to the reference architecture."""
    if not isinstance(model, NeRF):
        return False
    layers = model.xyz_layers
    return (
        len(layers) == D
        and tuple(layers[0].w.shape) == (CX, W)
        and tuple(layers[SKIP].w.shape) == (W + CX, W)
        and all(tuple(layers[i].w.shape) == (W, W)
                for i in range(1, D) if i != SKIP)
        and tuple(model.dir_layer.w.shape) == (W + CD, WH)
    )


def _embed_raw_t(x_rawT: torch.Tensor, sigma_only: bool) -> torch.Tensor:
    xyz = x_rawT[0:3].T
    x = posenc(xyz, XYZ_FREQS)
    if not sigma_only:
        x = torch.cat([x, posenc(x_rawT[3:6].T, DIR_FREQS)], dim=-1)
    return x


def fused_nerf_apply_raw_t_plain(model: NeRF, x_rawT: torch.Tensor,
                                 sigma_only: bool = False,
                                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel C on any device: ``posenc`` plus
    ``NeRF.forward`` with operands rounded to ``compute_dtype`` and f32
    products and sums."""
    out = model(_embed_raw_t(x_rawT.float(), sigma_only), sigma_only,
                compute_dtype)
    res = torch.zeros((OUT_COLS, x_rawT.shape[1]), dtype=torch.float32,
                      device=x_rawT.device)
    if sigma_only:
        res[0] = out[:, 0]
    else:
        res[:4] = out.T
    return res


def pack_weights(model: NeRF, compute_dtype):
    """Kernel operands: all weights as one ``compute_dtype`` buffer in the
    order W_0..W_7, Wsig, Wfin, Wdir, Wrgb (each ``(fan_in, fan_out)``
    row-major), all biases as one f32 buffer in the same order.  Cached on
    the module until a parameter is replaced or changed in place."""
    params = list(model.parameters())
    key = (compute_dtype, tuple((p.data_ptr(), p._version) for p in params))
    cached = getattr(model, "_fused_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    dense = list(model.xyz_layers) + [model.sigma, model.xyz_final,
                                      model.dir_layer, model.rgb]
    with torch.no_grad():
        wbuf = torch.cat([m.w.reshape(-1) for m in dense]).to(compute_dtype)
        bbuf = torch.cat([m.b.reshape(-1) for m in dense]).float()
    packed = (wbuf.contiguous(), bbuf.contiguous())
    model._fused_pack = (key, packed)
    return packed


def _lib():
    lib = native.load("fused_mlp")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.nerf_fused_fwd.argtypes = [p, p, p, p, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int, p]
        lib.nerf_fused_fwd.restype = ctypes.c_int
        lib.nerf_fused_weight_count.restype = ctypes.c_longlong
        lib.nerf_fused_bias_count.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def fused_nerf_apply_raw_t_cuda(model: NeRF, x_rawT: torch.Tensor,
                                sigma_only: bool = False,
                                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel C on the card (forward only)."""
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in model.parameters()):
        raise NotImplementedError(
            "the fused MLP backward is not ported yet (port slice 2: the "
            "training step); run under torch.no_grad()/inference_mode()")
    if x_rawT.device.type != "cuda":
        raise ValueError(f"x_rawT must be a CUDA tensor, got {x_rawT.device}")
    if x_rawT.dtype != torch.float32:
        raise TypeError(f"x_rawT must be float32, got {x_rawT.dtype}")
    if x_rawT.dim() != 2 or x_rawT.shape[0] != RAW_COLS:
        raise ValueError(f"x_rawT must be ({RAW_COLS}, P), got "
                         f"{tuple(x_rawT.shape)}")
    if not x_rawT.is_contiguous():
        raise ValueError("x_rawT must be contiguous")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute_dtype must be bfloat16 or float32, got "
                        f"{compute_dtype}")
    if not supports_fused(model):
        raise ValueError("the fused kernel needs the reference architecture")
    wbuf, bbuf = pack_weights(model, compute_dtype)
    if wbuf.device != x_rawT.device:
        raise ValueError(f"weights on {wbuf.device}, input on {x_rawT.device}")
    lib = _lib()
    if (wbuf.numel() != lib.nerf_fused_weight_count()
            or bbuf.numel() != lib.nerf_fused_bias_count()):
        raise ValueError("packed weights do not match the kernel's layout")
    P = x_rawT.shape[1]
    out = torch.empty((OUT_COLS, P), dtype=torch.float32, device=x_rawT.device)
    if P == 0:
        return out
    with torch.cuda.device(x_rawT.device):  # the launch uses the current device
        err = lib.nerf_fused_fwd(
            x_rawT.data_ptr(), out.data_ptr(), wbuf.data_ptr(), bbuf.data_ptr(),
            P, int(sigma_only), int(compute_dtype == torch.bfloat16),
            native.stream_of(x_rawT))
    native.check(lib, err, "nerf_fused_fwd")
    fused_nerf_apply_raw_t_cuda.launches += 1
    return out


fused_nerf_apply_raw_t_cuda.launches = 0


def fused_nerf_apply_raw_t(model: NeRF, x_rawT: torch.Tensor,
                           sigma_only: bool = False,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Channel-major fused MLP: (8, P) in -> (8, P) out.  Kernel C for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x_rawT.device.type == "cuda":
        return fused_nerf_apply_raw_t_cuda(model, x_rawT, sigma_only,
                                           compute_dtype)
    if x_rawT.device.type == "cpu":
        return fused_nerf_apply_raw_t_plain(model, x_rawT, sigma_only,
                                            compute_dtype)
    raise ValueError(f"no fused MLP for device {x_rawT.device}")
