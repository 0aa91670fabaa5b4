"""Remake the lossy WebP fixtures of the image-reader tests and of
``chip_smoke.py`` (whose machine has no encoder), with Pillow, from the
port's deterministic synthetic scenes:

  * ``llff_00{0..3}.webp``: the 4 views of ``generate_llff_scene`` at
    504x378 (the LLFF fit's scene), lossy at quality 80;
  * ``blender_rgba.webp``: a 64x64 RGBA frame of ``generate_scene``, lossy
    with its alpha (an ``ALPH`` chunk);
  * ``anim.webp``: two 96x72 crops of LLFF view 0 as a lossy animation.

``digests.json`` records each file's Pillow mode, shape and the SHA-256
of ``np.asarray(Image.open(path))``'s bytes.  Run from the repository
root: ``python tests/data/webp/make_webp_fixtures.py``.
"""
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

from nerf_pl_tpu_torch.data import synthetic  # noqa: E402
from nerf_pl_tpu_torch.data.png import read_png  # noqa: E402


def digest(path: str) -> dict:
    im = Image.open(path)
    px = np.asarray(im)
    return {"mode": im.mode, "shape": list(px.shape),
            "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


def main() -> None:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        llff = synthetic.generate_llff_scene(os.path.join(tmp, "llff"),
                                             img_wh=(504, 378), n_views=4)
        for i in range(4):
            img, _ = read_png(os.path.join(llff, "images", f"{i:03d}.png"))
            Image.fromarray(img).save(os.path.join(HERE, f"llff_{i:03d}.webp"),
                                      "WEBP", quality=80, method=4)
            if i == 0:
                frames = [Image.fromarray(img[40:112, 60:156]),
                          Image.fromarray(img[140:212, 200:296])]
        scene = synthetic.generate_scene(os.path.join(tmp, "blender"),
                                         img_wh=64, n_train=1, n_val=0,
                                         n_test=0)
        rgba, _ = read_png(os.path.join(scene, "r_train_0.png"))
        Image.fromarray(rgba, "RGBA").save(
            os.path.join(HERE, "blender_rgba.webp"), "WEBP", quality=75)
        frames[0].save(os.path.join(HERE, "anim.webp"), "WEBP", save_all=True,
                       append_images=frames[1:], quality=70, duration=100)
    for name in sorted(os.listdir(HERE)):
        if name.endswith(".webp"):
            out[name] = digest(os.path.join(HERE, name))
    out["_made_with"] = {"pillow": Image.__version__,
                         "libwebp": features.version("webp")}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
