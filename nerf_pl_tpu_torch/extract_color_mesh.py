"""Extract a colored mesh from a trained model with the port (the
counterpart of ``extract_color_mesh.py``): a PLY, and with ``--vol_path`` a
``.vol`` volume texture.

    python -m nerf_pl_tpu_torch.extract_color_mesh --root_dir /data/lego \
        --ckpt_path ckpts/lego/epoch=15.ckpt --img_wh 800 800 \
        --N_grid 256 --sigma_threshold 20 --out_path lego.ply \
        [--use_vertex_normal --N_importance 64] [--device cuda|cpu]

Every flag of ``extract_color_mesh.py`` parses as it does there;
``--device`` (default ``cuda``) is the port's own.
"""
from __future__ import annotations

from .tools.extract_mesh import get_opts, run


def main(argv=None):
    return run(get_opts(argv))


if __name__ == "__main__":
    main()
