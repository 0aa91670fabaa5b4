"""Render the test set of a trained model with the port (the counterpart of
``eval.py``): per-frame PNGs, optional depth maps, a GIF and the mean PSNR.

    python -m nerf_pl_tpu_torch.eval --root_dir /data/lego \
        --ckpt_path ckpts/lego/epoch=15.ckpt --img_wh 400 400 \
        --N_importance 128 [--fused_channel_io false] [--save_depth] \
        [--device cuda|cpu]

Every flag of ``eval.py`` parses as it does there; ``--device`` (default
``cuda``) is the port's own.
"""
from __future__ import annotations

from .tools.evaluate import get_opts, run


def main(argv=None):
    return run(get_opts(argv))


if __name__ == "__main__":
    main()
