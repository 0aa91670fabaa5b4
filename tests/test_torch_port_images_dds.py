"""The port's DDS reader against Pillow 12.1 and through the JAX loader
functions, bit for bit, and its C++ block stage (``csrc/bcn_decode.cpp``)
against the plain version and against Pillow's ``BcnDecode.c`` on seeded
random blocks.

Layouts: the uncompressed bitmasks (24- and 32-bit, 5-6-5, 4-4-4-4,
1-5-5-5), 8-bit luminance, luminance + alpha, palette-8 with alphas; the
FourCCs DXT1, DXT3, DXT5, BC4U, ATI1, BC5U, ATI2, BC5S; the DX10 header's
BC1-BC5 typeless and unorm, BC5 snorm, BC6H UF16 and SF16, BC7 typeless,
unorm and srgb, R8G8B8A8; Pillow's own DXT1, DXT5, BC5 and uncompressed
files.  Any 16 bytes are a BC6H or BC7 block, so seeded random blocks
reach every mode, partition and the reserved ones.  What Pillow refuses
raises ``ValueError`` naming the file.
"""
import io

import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu_torch.data import dds
from nerf_pl_tpu_torch.data import image as port_image

import image_writers as W
from test_torch_port_images import WH, hold_loaders

H, WW = WH[1], WH[0]
BLOCKS = -(-WW // 4) * -(-H // 4)
FOURCC = [("dxt1", b"DXT1", 1), ("dxt3", b"DXT3", 2), ("dxt5", b"DXT5", 3),
          ("bc4u", b"BC4U", 4), ("ati1", b"ATI1", 4), ("bc5u", b"BC5U", 5),
          ("ati2", b"ATI2", 5), ("bc5s", b"BC5S", 5)]
DXGI = [("bc1-typeless", 70, 1), ("bc1-unorm", 71, 1), ("bc2-unorm", 74, 2),
        ("bc3-typeless", 76, 3), ("bc4-unorm", 80, 4), ("bc5-unorm", 83, 5),
        ("bc5-snorm", 84, 5), ("bc6h-uf16", 95, 6), ("bc6h-sf16", 96, 6),
        ("bc7-typeless", 97, 7), ("bc7-unorm", 98, 7), ("bc7-srgb", 99, 7)]


def _blocks(rng, n: int, count: int = BLOCKS) -> bytes:
    raw = rng.randint(0, 256, (count, dds._BLOCK_BYTES[n])).astype(np.uint8)
    if n == 7:  # every mode, and the reserved first byte 0
        raw[:, 0] = ((raw[:, 0] | 1) << rng.randint(0, 8, count)) & 0xFF
        raw[::11, 0] = 0
    if n == 1:  # both BC1 orders of the endpoints
        raw[::2, [0, 2]] = raw[::2, [2, 0]]
    return raw.tobytes()


def _cases():
    rng = np.random.RandomState(23)
    img = rng.randint(0, 256, (H, WW, 4))
    img[:8] = img[0, 0]
    out = []
    for name, masks, bits, flags in (
            ("rgb24", (0xFF0000, 0xFF00, 0xFF), 24, W.DDS_RGB),
            ("bgra32", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 32,
             W.DDS_RGB | W.DDS_ALPHAPIXELS),
            ("rgb565", (0xF800, 0x7E0, 0x1F), 16, W.DDS_RGB),
            ("argb4444", (0xF00, 0xF0, 0xF, 0xF000), 16,
             W.DDS_RGB | W.DDS_ALPHAPIXELS),
            ("argb1555", (0x7C00, 0x3E0, 0x1F, 0x8000), 16,
             W.DDS_RGB | W.DDS_ALPHAPIXELS),
            ("xbgr32-holes", (0xF0, 0xF000, 0x3F0000, 0), 32, W.DDS_RGB)):
        c = len(masks)
        out.append((name, W.dds_bytes(WW, H, W.dds_masks(
            img[..., :c], masks, bits), flags, bitcount=bits, masks=masks)))
    pal = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    out += [("l8", W.dds_bytes(WW, H, img[..., 0].astype(np.uint8).tobytes(),
                               W.DDS_LUMINANCE, bitcount=8)),
            ("la16", W.dds_bytes(WW, H, img[..., :2].astype(np.uint8)
                                 .tobytes(), W.DDS_LUMINANCE
                                 | W.DDS_ALPHAPIXELS, bitcount=16)),
            ("p8", W.dds_bytes(WW, H, img[..., 0].astype(np.uint8).tobytes(),
                               W.DDS_PAL8, bitcount=8, palette=pal)),
            ("rgba8-dx10", W.dds_bytes(WW, H, img.astype(np.uint8).tobytes(),
                                       0, dxgi=28))]
    for name, cc, n in FOURCC:
        out.append((name, W.dds_bytes(WW, H, _blocks(rng, n), W.DDS_FOURCC,
                                      fourcc=cc)))
    for name, fmt, n in DXGI:
        out.append((name, W.dds_bytes(WW, H, _blocks(rng, n), 0, dxgi=fmt)))
    out.append(("bc7-mode6-encoded", W.dds_bytes(WW, H, W.bc7_mode6_bytes(
        img.astype(np.uint8)), 0, dxgi=98)))
    for kw in ({}, dict(pixel_format="DXT1"), dict(pixel_format="DXT5"),
               dict(pixel_format="BC5")):
        b = io.BytesIO()
        c = 3 if kw.get("pixel_format") == "BC5" else 4
        Image.fromarray(img[..., :c].astype(np.uint8)).save(b, "DDS", **kw)
        out.append(("pillow-" + kw.get("pixel_format", "rgba"), b.getvalue()))
    return out


CASES = _cases()


@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_dds_layout_matches_pillow_and_jax_loaders(tmp_path, name, data):
    path = str(tmp_path / f"{name}.dds")
    with open(path, "wb") as f:
        f.write(data)
    pil = Image.open(path)
    pil.load()
    assert pil.format == "DDS"
    want = np.asarray(pil)
    pic = port_image.read_picture(path)
    assert pic.mode == pil.mode
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape
    np.testing.assert_array_equal(pic.pixels, want)
    hold_loaders(path)


@pytest.mark.parametrize("fmt,n,signed", [(95, 6, 0), (96, 6, 1), (98, 7, 0)],
                         ids=["bc6h-uf16", "bc6h-sf16", "bc7"])
def test_bc6h_bc7_random_blocks_match_pillow(fmt, n, signed):
    """4,096 seeded random blocks (every mode and partition, the reserved
    modes too) through ``Image.open`` and through the port's C++ stage and
    plain version."""
    data = _blocks(np.random.RandomState(fmt), n, 4096)
    w, h = 256, 256
    want = np.asarray(Image.open(io.BytesIO(W.dds_bytes(w, h, data, 0,
                                                        dxgi=fmt))))
    np.testing.assert_array_equal(dds.decode_blocks(data, n, signed, w, h),
                                  want)
    np.testing.assert_array_equal(dds.decode_blocks_plain(data, n, signed,
                                                          w, h), want)


def test_bcn_stage_equals_its_plain_version():
    """Each block decoder in C++ against the plain version on seeded random
    blocks at ragged sizes (edges clipped)."""
    rng = np.random.RandomState(4)
    for n, signed in ((1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (5, 1), (6, 0),
                      (6, 1), (7, 0)):
        for w, h in ((37, 29), (1, 1), (64, 8)):
            data = _blocks(rng, n, -(-w // 4) * -(-h // 4))
            np.testing.assert_array_equal(
                dds.decode_blocks(data, n, signed, w, h),
                dds.decode_blocks_plain(data, n, signed, w, h),
                err_msg=f"decoder {n} signed {signed} at {w}x{h}")
    with pytest.raises(ValueError, match="truncated"):
        dds.decode_blocks(b"\0" * 15, 7, 0, 4, 8)


def test_dds_refusals_name_the_file(tmp_path):
    """What Pillow refuses raises ``ValueError`` naming the file: DXGI
    formats its plugin lacks (BC4 snorm, BC1 srgb, B8G8R8A8), an unknown
    FourCC, another header size, 24-bit luminance, no format flags, blocks
    cut short; a DX10 header cut short is no DDS file to ``Image.open``."""
    rng = np.random.RandomState(8)
    blocks = _blocks(rng, 1)
    files = {
        "bc4-snorm.dds": W.dds_bytes(WW, H, blocks, 0, dxgi=81),
        "bc1-srgb.dds": W.dds_bytes(WW, H, blocks, 0, dxgi=72),
        "bgra8-dx10.dds": W.dds_bytes(WW, H, bytes(WW * H * 4), 0, dxgi=87),
        "fourcc.dds": W.dds_bytes(WW, H, blocks, W.DDS_FOURCC, fourcc=b"ABCD"),
        "header.dds": W.dds_bytes(WW, H, blocks, W.DDS_FOURCC,
                                  fourcc=b"DXT1")[:4] + b"\x64\0\0\0"
        + bytes(200),
        "l24.dds": W.dds_bytes(WW, H, bytes(WW * H * 3), W.DDS_LUMINANCE,
                               bitcount=24),
        "no-flags.dds": W.dds_bytes(WW, H, blocks, 0),
        "cut-blocks.dds": W.dds_bytes(WW, H, blocks[:100], W.DDS_FOURCC,
                                      fourcc=b"DXT1"),
        "cut-l8.dds": W.dds_bytes(WW, H, bytes(50), W.DDS_LUMINANCE,
                                  bitcount=8),
        "cut-dx10.dds": W.dds_bytes(WW, H, b"", 0, dxgi=98)[:130],
    }
    for name, body in files.items():
        path = tmp_path / name
        path.write_bytes(body)
        with pytest.raises(Exception):
            Image.open(path).load()
        with pytest.raises(ValueError, match=rf"{name.replace('.', r'\.')}: "):
            port_image.read_picture(str(path))
