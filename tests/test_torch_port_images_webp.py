"""The port's WebP reader against Pillow (libwebp through ``WebPAnimDecoder``)
and through the JAX loader functions, bit for bit.

Files of Pillow's own encoder (lossless and lossy, with and without alpha,
palette images whose colour-indexing transform bundles 2, 4 or 8 pixels in
a byte at widths that are not a multiple of it) and of the tests' writers
for what Pillow never writes: VP8 frames with the simple loop filter, 2, 4
and 8 token partitions, absolute segment values, loop-filter deltas and
sharpness, skipped macroblocks and coefficient probability updates; VP8L
streams through each transform; ``ALPH`` chunks raw and VP8L-coded under
each filter; an animation whose frame 0 is smaller than its canvas.  Then
the committed fixtures against their recorded Pillow digests, and the
refusals.
"""
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import image as port_image
from nerf_pl_tpu_torch.data import webp

import image_writers as W
from test_torch_port_images import WH, hold_loaders

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "webp")


def _scene(w, h, channels, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3) % 256, (xx * 2 + yy * 9) % 256,
                     ((xx - yy) * 5) % 256, 255 - (xx * yy) % 256], -1)
    img = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255)
    img = img.astype(np.uint8)[..., :channels]
    if channels == 4:
        img[..., 3] = np.where((xx + yy) % 7 == 0, 0, img[..., 3])
    return img


def _pillow(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "WEBP", **kw)
    return b.getvalue()


def _cases():
    """(name, bytes, size) of every layout."""
    out = []
    w, h = WH
    for ch in (3, 4):
        img = _scene(w, h, ch, ch)
        for tag, kw in (("lossless", dict(lossless=True)),
                        ("lossless-m0", dict(lossless=True, method=0)),
                        ("lossless-m6", dict(lossless=True, quality=100,
                                             method=6)),
                        ("q80", dict(quality=80)), ("q10-m6", dict(quality=10,
                                                                   method=6)),
                        ("q50-m0", dict(quality=50, method=0))):
            out.append((f"pillow-{tag}-{ch}", _pillow(img, **kw), WH))
    odd = _scene(33, 17, 4, 5)
    out.append(("pillow-q90-odd", _pillow(odd, quality=90), (33, 17)))
    out.append(("pillow-lossless-odd", _pillow(odd, lossless=True), (33, 17)))
    rng = np.random.RandomState(3)
    for n in (2, 3, 5, 17):  # 8, 4, 2 and 1 pixels a byte
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        out.append((f"pillow-palette{n}", _pillow(
            pal[rng.randint(0, n, (h, 13))], lossless=True), (13, h)))
    vp8 = {"default": {}, "simple": dict(simple=True),
           "partitions2": dict(partitions=1),
           "partitions4-sharp": dict(partitions=2, sharpness=3),
           "partitions8-simple": dict(partitions=3, simple=True),
           "segments": dict(segments=True),
           "segments-absolute": dict(segments=True, absolute=True),
           "lf-delta-sharp6": dict(lf_delta=True, sharpness=6, level=63),
           "skip": dict(skip_proba=80), "no-filter": dict(level=0),
           "all-i4": dict(i4_share=1.0), "all-i16": dict(i4_share=0.0),
           "proba-updates": dict(proba_updates=60),
           "simple-everything": dict(simple=True, sharpness=2,
                                     lf_delta=True, segments=True)}
    for tag, kw in vp8.items():
        out.append((f"vp8-{tag}", W.webp_container(
            W.vp8_bytes(w, h, seed=len(out), **kw), b"VP8 "), WH))
    out.append(("vp8-odd-partitions8", W.webp_container(
        W.vp8_bytes(57, 45, seed=1, partitions=3), b"VP8 "), (57, 45)))
    img = _scene(w, h, 4, 7)
    for tr in [("subtract_green",), ("predictor",), ("cross_color",),
               ("subtract_green", "predictor", "cross_color"), ("palette",)]:
        src = img if tr != ("palette",) else img // 64 * 85
        out.append(("vp8l-" + "-".join(tr), W.webp_container(
            W.vp8l_bytes(src, tr, tile_bits=3, seed=2), b"VP8L"), WH))
    frame = W.vp8_bytes(w, h, seed=11)
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = ((xx * 9 + yy * 5) % 256).astype(np.uint8)
    for method in (0, 1):
        for filt in range(4):
            out.append((f"alph-m{method}-f{filt}", W.webp_container(
                frame, b"VP8 ", alph=W.alph_bytes(alpha, method, filt)), WH))
    small = W.vp8_bytes(w - 10, h - 8, seed=12)
    out.append(("anim-offset", W.webp_container(
        small, b"VP8 ", canvas=WH, anim_offset=(6, 4)), WH))
    out.append(("anim-offset-alpha", W.webp_container(
        small, b"VP8 ", alph=W.alph_bytes(alpha[:h - 8, :w - 10], 1, 3),
        canvas=WH, anim_offset=(4, 8)), WH))
    out.append(("anim-vp8l", W.webp_container(
        W.vp8l_bytes(img[:h - 4, :w - 2]), b"VP8L", canvas=WH,
        anim_offset=(2, 4)), WH))
    out.append(("vp8x-icc-exif", W.webp_container(frame, b"VP8 ", icc=True),
                WH))
    return out


CASES = _cases()


@pytest.mark.parametrize("name,data,size", CASES, ids=[c[0] for c in CASES])
def test_webp_layout_matches_pillow_and_jax_loaders(tmp_path, name, data,
                                                    size):
    path = str(tmp_path / f"{name}.webp")
    with open(path, "wb") as f:
        f.write(data)
    pil = Image.open(path)
    want = np.asarray(pil)
    pic = port_image.read_picture(path)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    if size == WH:  # odd sizes have no half of the same aspect ratio
        hold_loaders(path)


def test_webp_fixtures_match_recorded_digests():
    """The committed lossy fixtures decode to the SHA-256 of Pillow's
    decode recorded when they were made, in Pillow here and in the port."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    names = sorted(k for k in digests if k.endswith(".webp"))
    assert len(names) == 6
    total = 0
    for name in names:
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        rec = digests[name]
        pil = Image.open(path)
        assert pil.mode == rec["mode"]
        assert hashlib.sha256(np.asarray(pil).tobytes()).hexdigest() == \
            rec["sha256"], name
        pic = port_image.read_picture(path)
        assert pic.mode == rec["mode"] and list(pic.pixels.shape) == rec["shape"]
        assert hashlib.sha256(pic.pixels.tobytes()).hexdigest() == \
            rec["sha256"], name
    assert total < 1 << 20


def test_webp_refusals_name_the_file(tmp_path):
    """Truncated and corrupt files raise in Pillow and in the port, the
    port's message naming the file."""
    good = W.webp_container(W.vp8_bytes(*WH, seed=4), b"VP8 ")
    lossless = W.webp_container(W.vp8l_bytes(_scene(*WH, 4, 1)), b"VP8L")
    inter = bytearray(good)
    inter[20] |= 1  # the frame tag's key-frame bit: an interframe
    files = {"cut-chunk": good[:60], "cut-lossless": lossless[:40],
             "interframe": bytes(inter),
             "no-frame": W._riff([(b"EXIF", b"Exif\0\0")])}
    for name, body in files.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(body)
        with pytest.raises(Exception):
            Image.open(path).load()
        with pytest.raises(ValueError, match=rf"{name}\.webp: "):
            port_image.read_picture(str(path))


def test_webp_stage_seconds_are_reported():
    """``webp.decode(seconds=...)`` names the C++ stages it ran."""
    st = {}
    webp.decode(W.webp_container(W.vp8_bytes(*WH, seed=9), b"VP8 "),
                seconds=st)
    assert set(st) == {"parse_reconstruct", "loop_filter", "upsample_rgb"}
    st = {}
    webp.decode(W.webp_container(W.vp8l_bytes(_scene(*WH, 4, 2)), b"VP8L"),
                seconds=st)
    assert set(st) == {"entropy", "transforms"}
