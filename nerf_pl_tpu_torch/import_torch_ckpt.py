"""Convert a reference (PyTorch-Lightning) ``.ckpt`` into the port's
checkpoint, or back with ``--export`` (the counterpart of
``import_torch_ckpt.py``).

    python -m nerf_pl_tpu_torch.import_torch_ckpt --ckpt_path ref.ckpt \
        --out_path ours.ckpt [--full_state] [--export] [--device cuda|cpu]

Every flag of ``import_torch_ckpt.py`` parses as it does there;
``--device`` (default ``cuda``) is the port's own.
"""
from __future__ import annotations

from .tools.import_torch_ckpt import main

if __name__ == "__main__":
    main()
