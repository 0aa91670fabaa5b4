"""Remake the JPEG 2000 fixtures of ``chip_smoke.py`` (whose machine has no
encoder), with Pillow (OpenJPEG), from the port's deterministic synthetic
scenes:

  * ``llff_00{0..3}.jp2``: the 4 views of ``generate_llff_scene`` at
    504x378 (the LLFF fit's scene), irreversible 9/7 with the colour
    transform, two quality layers (rates 80 and 40);
  * ``blender_rgba.j2k``: a 64x64 RGBA frame of ``generate_scene`` as a
    reversible (lossless) raw codestream;
  * ``blender_rgb97.j2k``: the frame's RGB as an irreversible 9/7 raw
    codestream with the colour transform (ICT), for holding the C++ 9/7
    lifting, float dequantisation and ICT against their plain versions;
  * ``depth_i16.jp2``: a 64x64 ``I;16`` map (the frame's luma times 257
    plus a ramp), reversible;
  * ``palette_p.jp2``: a 64x64 ``P`` image: the frame's luma quantised to
    24 indices in a gray JP2 rewritten with a ``pclr`` box (three repeated
    colours) and an sRGB ``colr``;
  * ``fern_tile.j2k``: a 1024x1024 RGB tile (LLFF view 0 tiled), 9/7 with
    the colour transform, rates 400 and 160.  ``chip_smoke.py`` repeats its
    tile-part 4 x 3 times into a 4096x3072 codestream
    (``image_writers.tile_mosaic``): at 1024 every tile's code-blocks and
    wavelet parities are the first tile's (at 1008 they would not be).

``digests.json`` records each file's Pillow mode, shape and the SHA-256 of
``np.asarray(Image.open(path))``'s bytes.  Run from the repository root:
``python tests/data/jpeg2000/make_jpeg2000_fixtures.py``.
"""
import hashlib
import io
import json
import os
import sys
import tempfile

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import image_writers as W  # noqa: E402
from nerf_pl_tpu_torch.data import synthetic  # noqa: E402
from nerf_pl_tpu_torch.data.png import read_png  # noqa: E402

TILE = 1024


def digest(path: str) -> dict:
    im = Image.open(path)
    px = np.asarray(im)
    return {"mode": im.mode, "shape": list(px.shape),
            "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


def encode(img: np.ndarray, mode: str, **kw) -> bytes:
    b = io.BytesIO()
    im = Image.fromarray(img, None if mode == "I;16" else mode)
    (im.convert("I;16") if mode == "I;16" else im).save(b, "JPEG2000", **kw)
    return b.getvalue()


def write(name: str, data: bytes) -> None:
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(data)


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        llff = synthetic.generate_llff_scene(os.path.join(tmp, "llff"),
                                             img_wh=(504, 378), n_views=4)
        views = [read_png(os.path.join(llff, "images", f"{i:03d}.png"))[0]
                 for i in range(4)]
        scene = synthetic.generate_scene(os.path.join(tmp, "blender"),
                                         img_wh=64, n_train=1, n_val=0,
                                         n_test=0)
        rgba, _ = read_png(os.path.join(scene, "r_train_0.png"))
    for i, img in enumerate(views):
        write(f"llff_{i:03d}.jp2", encode(img, "RGB", irreversible=True,
                                          mct=1, quality_layers=[80, 40]))
    write("blender_rgba.j2k", encode(rgba, "RGBA", no_jp2=True))
    write("blender_rgb97.j2k", encode(np.ascontiguousarray(rgba[..., :3]),
                                      "RGB", no_jp2=True, irreversible=True,
                                      mct=1))
    luma = rgba[..., :3].astype(np.int64) @ np.array([299, 587, 114]) // 1000
    ramp = np.add.outer(np.arange(64), np.arange(64)) * 3
    write("depth_i16.jp2", encode((luma * 257 + ramp).astype(np.uint16)
                                  .clip(0, 65535), "I;16"))
    idx = (luma * 24 // 256).astype(np.uint8)
    pal = np.random.RandomState(18).randint(0, 256, (24, 3))
    pal[5], pal[9], pal[17] = pal[2], pal[2], pal[11]
    write("palette_p.jp2", W.rewrite_jp2(encode(idx, "L"), colr=16, extra=[
        (b"pclr", W.pclr_box(pal)),
        (b"cmap", bytes([0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 2]))]))
    tile = np.tile(views[0], (3, 3, 1))[:TILE, :TILE]
    write("fern_tile.j2k", encode(np.ascontiguousarray(tile), "RGB",
                                  no_jp2=True, irreversible=True, mct=1,
                                  quality_layers=[400, 160],
                                  tile_size=(TILE, TILE)))
    out = {name: digest(os.path.join(HERE, name))
           for name in sorted(os.listdir(HERE))
           if name.endswith((".jp2", ".j2k"))}
    out["_made_with"] = {"pillow": Image.__version__,
                         "openjpeg": features.version("jpg_2000")}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
