"""nerf_pl_tpu_torch — the PyTorch/CUDA port of ``nerf_pl_tpu`` for NVIDIA
Hopper (H100).

Module names follow ``nerf_pl_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and the standard library only.

- ``config``   : the ``Config`` dataclass and ``get_opts``, as the JAX package's
- ``models``   : positional encoding, the NeRF ``nn.Module``, camera helpers
- ``ops``      : rays, sampling, searchsorted (CUDA kernels A and B),
                 compositing, the fused NeRF MLP forward (CUDA kernels C and
                 D) and backward (E and F) behind ``torch.autograd``, the
                 renderer, and the nvcc build of ``csrc/``
- ``data``     : the loaders (Blender, LLFF, shadow), PNG and JPEG readers,
                 per-host frame shards and the native ray store
- ``parallel`` : data parallelism over ``torch.distributed`` (one rank a
                 device: sharded rays, the grads' all-reduce, gathers)
- ``training`` : the vanilla-NeRF trainer, losses, metrics, Adam, logging,
                 msgpack checkpoints readable and writable by both packages
- ``tools``    : ``load_models``, ``render_image`` and the HTTP render server
- ``train``, ``bench``, ``graft_entry`` : the training CLI, the training-step
                 benchmark and the entry point

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
nothing falls back to the CPU when CUDA is missing.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for but absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
