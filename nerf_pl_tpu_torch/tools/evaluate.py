"""Model loading for rendering (``nerf_pl_tpu/tools/evaluate.py``).

Only ``load_models`` is ported so far; the test-set evaluation loop needs
the dataset loaders and comes with a later slice.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..models.nerf import init_nerf
from ..training.checkpoints import extract_model_state_dict, load_ckpt_into


def _width_of(state: dict) -> int:
    # --arch_width checkpoints carry their width in the weight shapes
    # (trunk layer 0 is (in_xyz, W)); 256 when absent
    w = state.get("xyz_layers/0/w")
    return int(w.shape[1]) if w is not None else 256


def load_models(ckpt_path: str, device=None) -> dict:
    """``{"coarse": NeRF, "fine": NeRF}`` from a checkpoint.  A checkpoint
    trained with N_importance=0 has no fine weights: then ``"fine"`` is
    omitted rather than substituted by a randomly initialised network."""
    device = resolve_device(device)
    models = {}
    for seed, name in enumerate(("coarse", "fine")):
        state = extract_model_state_dict(ckpt_path, name)
        if name == "fine" and not state:
            break
        gen = torch.Generator().manual_seed(seed)
        model = init_nerf(gen, W=_width_of(state), device="cpu")
        load_ckpt_into(model, ckpt_path, name, loaded=state)
        models[name] = model.to(device).requires_grad_(False)
    return models
