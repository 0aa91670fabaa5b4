"""The NeRF MLP as an ``nn.Module`` whose parameter tree mirrors the JAX
param pytree name for name (``nerf_pl_tpu/models/nerf.py``).

  * ``xyz_layers.{i}.w`` is ``(fan_in, fan_out)`` and ``.b`` is
    ``(fan_out,)``, so a layer computes ``x @ w + b``; ``sigma``,
    ``xyz_final``, ``dir_layer`` and ``rgb`` follow the same layout.
  * D=8 ReLU layers of width W=256; before each skip layer the embedded
    xyz is concatenated in FRONT of the hidden activation.
  * Heads: ``sigma`` (no activation), ``xyz_final`` (no activation),
    ``[final, dir_emb] -> dir_layer + ReLU -> rgb + sigmoid``.
    Output ``cat([rgb, sigma])``; ``sigma_only`` returns ``(B, 1)``.

``nerf_from_numpy`` / ``nerf_to_numpy`` carry weights between the JAX
param tree (as numpy arrays) and the module.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored ``(fan_in, fan_out)``."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out, device=device))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device))

    def reset(self, generator: Optional[torch.Generator]):
        # torch nn.Linear bounds: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
        # both the weight and the bias (``_linear_init``, nerf.py:30-40)
        bound = 1.0 / math.sqrt(self.w.shape[0])
        with torch.no_grad():
            for p in (self.w, self.b):
                u = torch.rand(p.shape, generator=generator)
                p.copy_((2.0 * u - 1.0) * bound)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32):
        # operands rounded to the compute dtype, products and sum in f32
        # (the JAX ``preferred_element_type=float32`` contract; a bf16
        # torch.matmul would round its OUTPUT to bf16 instead)
        xw = x.to(compute_dtype).float() @ self.w.to(compute_dtype).float()
        return xw + self.b.float()


class NeRF(nn.Module):
    def __init__(self, D: int = 8, W: int = 256, in_channels_xyz: int = 63,
                 in_channels_dir: int = 27, skips: Sequence[int] = (4,),
                 device=None):
        super().__init__()
        layers = []
        for i in range(D):
            if i == 0:
                fan_in = in_channels_xyz
            elif i in skips:
                fan_in = W + in_channels_xyz
            else:
                fan_in = W
            layers.append(Dense(fan_in, W, device))
        self.xyz_layers = nn.ModuleList(layers)
        self.xyz_final = Dense(W, W, device)
        self.dir_layer = Dense(W + in_channels_dir, W // 2, device)
        self.sigma = Dense(W, 1, device)
        self.rgb = Dense(W // 2, 3, device)

    @property
    def width(self) -> int:
        return self.xyz_layers[0].w.shape[1]

    @property
    def skips(self) -> tuple:
        # a layer whose fan-in exceeds W receives the skip concat
        # (nerf_apply infers it the same way, nerf.py:101-103)
        cx, w_ = self.xyz_layers[0].w.shape
        return tuple(i for i in range(1, len(self.xyz_layers))
                     if self.xyz_layers[i].w.shape[0] == w_ + cx)

    def forward(self, x: torch.Tensor, sigma_only: bool = False,
                compute_dtype=torch.float32) -> torch.Tensor:
        """``x``: ``(B, cx)`` when ``sigma_only`` else ``(B, cx + cd)``
        embedded inputs.  Returns ``(B, 1)`` sigma or ``(B, 4)`` rgb+sigma."""
        cx = self.xyz_layers[0].w.shape[0]
        skips = self.skips
        input_xyz = x if sigma_only else x[..., :cx]
        h = input_xyz
        for i, layer in enumerate(self.xyz_layers):
            if i in skips:
                h = torch.cat([input_xyz, h], dim=-1)
            h = torch.relu(layer(h, compute_dtype))
        sigma = self.sigma(h, compute_dtype)
        if sigma_only:
            return sigma
        final = self.xyz_final(h, compute_dtype)
        d = torch.cat([final, x[..., cx:]], dim=-1)
        d = torch.relu(self.dir_layer(d, compute_dtype))
        rgb = torch.sigmoid(self.rgb(d, compute_dtype))
        return torch.cat([rgb, sigma], dim=-1)


def init_nerf(generator: Optional[torch.Generator] = None, D: int = 8,
              W: int = 256, in_channels_xyz: int = 63,
              in_channels_dir: int = 27, skips: Sequence[int] = (4,),
              device=None) -> NeRF:
    """A NeRF with ``nn.Linear``-bounded uniform weights drawn on the CPU
    from ``generator`` (so a seed gives the same weights on every device)."""
    device = resolve_device(device)
    model = NeRF(D, W, in_channels_xyz, in_channels_dir, skips)
    for m in model.modules():
        if isinstance(m, Dense):
            m.reset(generator)
    return model.to(device)


_HEADS = ("xyz_final", "dir_layer", "sigma", "rgb")


def nerf_from_numpy(tree: dict, device=None) -> NeRF:
    """JAX param tree (numpy leaves; ``xyz_layers`` a list or a dict keyed
    ``"0".."n"``) -> ``NeRF`` on ``device``."""
    device = resolve_device(device)
    layers = tree["xyz_layers"]
    if isinstance(layers, dict):
        layers = [layers[str(i)] for i in range(len(layers))]
    cx, w_ = np.shape(layers[0]["w"])
    cd = np.shape(tree["dir_layer"]["w"])[0] - w_
    skips = tuple(i for i in range(1, len(layers))
                  if np.shape(layers[i]["w"])[0] == w_ + cx)
    model = NeRF(len(layers), w_, cx, cd, skips)
    dense = [(f"xyz_layers.{i}", layer) for i, layer in enumerate(layers)]
    dense += [(h, tree[h]) for h in _HEADS]
    mods = dict(model.named_modules())
    with torch.no_grad():
        for name, p in dense:
            for leaf in ("w", "b"):
                dst = getattr(mods[name], leaf)
                src = torch.from_numpy(np.array(p[leaf], np.float32))
                if src.shape != dst.shape:
                    raise ValueError(
                        f"{name}.{leaf}: shape {tuple(src.shape)} != "
                        f"{tuple(dst.shape)}")
                dst.copy_(src)
    return model.to(device)


def nerf_param_tree(model: NeRF) -> dict:
    """``NeRF`` -> the JAX param tree layout with the parameters themselves
    (detached, on their device) as leaves."""
    def leaf(m):
        return {"w": m.w.detach(), "b": m.b.detach()}

    tree = {"xyz_layers": [leaf(m) for m in model.xyz_layers]}
    tree.update({h: leaf(getattr(model, h)) for h in _HEADS})
    return tree


def nerf_to_numpy(model: NeRF) -> dict:
    """``NeRF`` -> the JAX param tree layout with float32 numpy leaves."""
    tree = nerf_param_tree(model)
    tree["xyz_layers"] = [{k: v.float().cpu().numpy() for k, v in layer.items()}
                          for layer in tree["xyz_layers"]]
    for h in _HEADS:
        tree[h] = {k: v.float().cpu().numpy() for k, v in tree[h].items()}
    return tree
