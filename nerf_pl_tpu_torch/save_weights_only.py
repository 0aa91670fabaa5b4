"""Strip the optimiser and trainer state from a checkpoint, keeping only the
model weights: the small "portable scene" artifact (the counterpart of
``save_weights_only.py``; reference ``utils/save_weights_only.py``).

    python -m nerf_pl_tpu_torch.save_weights_only --ckpt_path run.ckpt \
        [--out_path weights.ckpt] [--device cuda|cpu]

Without ``--out_path`` the output is ``<input stem>_weights<suffix>``, never
the input itself.  ``--device`` (default ``cuda``) is the port's own: the
work is on the host, and like every entry point of the port the tool
refuses to run without a card unless given ``cpu``.
"""
from __future__ import annotations

import argparse
import os

from . import resolve_device
from .training.checkpoints import load_checkpoint, save_checkpoint


def weights_path(ckpt_path: str) -> str:
    """The default output path: never the input (``str.replace`` of
    '.ckpt' would be a no-op on a name without it and overwrite the full
    checkpoint)."""
    root, ext = os.path.splitext(ckpt_path)
    out = f"{root}_weights{ext or '.ckpt'}"
    if out == ckpt_path:
        raise ValueError(f"cannot derive an output path from {ckpt_path!r}")
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    state = load_checkpoint(args.ckpt_path)
    out = args.out_path or weights_path(args.ckpt_path)
    save_checkpoint(out, {"params": state["params"]})
    print(f"weights-only checkpoint saved to {out}")
    return out


if __name__ == "__main__":
    main()
