"""A DDS reader: the top mip level of the first face, as Pillow's
``DdsImagePlugin`` gives it.

The header's pixel format picks the layout, as the plugin does: the
uncompressed bitmasks (``DDPF_RGB``, with ``DDPF_ALPHAPIXELS`` ``RGBA``,
else ``RGB``: each channel's masked bits over the mask's largest value,
times 255, truncated; ``DdsRgbDecoder``), 8-bit luminance ``L``, 16-bit
luminance + alpha ``LA``, palette-8 ``P`` (a 256-entry RGBA palette, its
alphas kept as ``transparency`` bytes, as Pillow's ``P`` to ``RGBA``
reads them); the FourCCs DXT1, DXT3, DXT5, BC4U/ATI1, BC5U/ATI2 and BC5S;
the DX10 header's BC1-BC5 typeless/unorm, BC5 snorm, BC6H UF16/SF16, BC7
typeless/unorm/srgb and R8G8B8A8 typeless/unorm/srgb.  Any other format
raises, as Pillow's ``NotImplementedError`` does; so does a header whose
size is not 124.

The block stages (BC1 with its 3-colour + punch-through rule, BC2's 4-bit
and BC3's interpolated alpha, BC4 and BC5 unsigned and signed, BC6H's 14
modes, BC7's 8 modes; each as Pillow's ``BcnDecode.c`` rounds them) run
in C++ (``csrc/bcn_decode.cpp``, built with g++ at first use through
``data/native.py``; a failed build raises, naming the source), which the
loaders call.  ``decode_blocks_plain`` is the same decode in Python and
numpy, which the tests hold the C++ against.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bcn_decode.cpp"

_RGB, _ALPHAPIXELS, _FOURCC, _PAL8, _LUMINANCE = 0x40, 0x1, 0x4, 0x20, 0x20000
# FourCC / DXGI format -> (mode, Pillow's bcn decoder number, signed)
_FOURCCS = {b"DXT1": ("RGBA", 1, 0), b"DXT3": ("RGBA", 2, 0),
            b"DXT5": ("RGBA", 3, 0), b"BC4U": ("L", 4, 0),
            b"ATI1": ("L", 4, 0), b"BC5S": ("RGB", 5, 1),
            b"BC5U": ("RGB", 5, 0), b"ATI2": ("RGB", 5, 0)}
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0),
         74: ("RGBA", 2, 0), 76: ("RGBA", 3, 0), 77: ("RGBA", 3, 0),
         79: ("L", 4, 0), 80: ("L", 4, 0), 82: ("RGB", 5, 0),
         83: ("RGB", 5, 0), 84: ("RGB", 5, 1), 95: ("RGB", 6, 0),
         96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0),
         99: ("RGBA", 7, 0)}
_DXGI_RGBA8 = (27, 28, 29)
_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}

_lock = threading.Lock()
_lib = None


def _native():
    """The C++ block stage, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            lib.bcn_decode.restype = ctypes.c_int
            lib.bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_void_p]
            _lib = lib
        return _lib


# ------------------------------------------------------ the plain blocks
def _565(c: np.ndarray) -> np.ndarray:
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | (r >> 5), g | (g >> 6), b | (b >> 5)], -1)


def _bc1_color(blk: np.ndarray, separate_alpha: bool) -> np.ndarray:
    """(n, 8) colour halves -> (n, 16, 4) RGBA."""
    w = blk.astype(np.int64)
    c0 = w[:, 0] | (w[:, 1] << 8)
    c1 = w[:, 2] | (w[:, 3] << 8)
    lut = w[:, 4] | (w[:, 5] << 8) | (w[:, 6] << 16) | (w[:, 7] << 24)
    p0, p1 = _565(c0), _565(c1)
    four = (c0 > c1) | separate_alpha
    p2 = np.where(four[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four[:, None], (p0 + 2 * p1) // 3, 0)
    a = np.full(len(blk), 255, np.int64)
    pal = np.stack([np.concatenate([p, aa[:, None]], 1) for p, aa in
                    ((p0, a), (p1, a), (p2, a), (p3, np.where(four, 255, 0)))],
                   1)  # (n, 4 entries, 4)
    sel = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, sel[..., None], 1)


def _bc3_alpha(blk: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 8) alpha halves -> (n, 16) values."""
    w = blk.astype(np.int64)
    if signed:
        a0 = (w[:, 0] ^ 0x80)
        a1 = (w[:, 1] ^ 0x80)
    else:
        a0, a1 = w[:, 0], w[:, 1]
    seven = a0 > a1
    levels = [a0, a1]
    for k in range(1, 7):
        levels.append(np.where(seven, ((7 - k) * a0 + k * a1) // 7,
                               ((5 - k) * a0 + k * a1) // 5 if k < 5 else 0))
    levels[6] = np.where(seven, levels[6], 0)
    levels[7] = np.where(seven, levels[7], 255)
    pal = np.stack(levels, 1)
    bits = np.zeros(len(blk), np.int64)
    for k in range(6):
        bits |= w[:, 2 + k] << (8 * k)
    sel = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(pal, sel, 1) & 0xFF


def _bc_simple(blocks: np.ndarray, n: int, signed: int) -> np.ndarray:
    """Pillow's decoders 1-5 over (count, bytes) blocks -> (count, 16, C)."""
    if n == 1:
        return _bc1_color(blocks, False)
    if n == 2:
        out = _bc1_color(blocks[:, 8:], True)
        nib = (blocks[:, :8].astype(np.int64)[:, :, None]
               >> np.array([0, 4])) & 15
        out[..., 3] = (nib.reshape(-1, 16) << 4) | nib.reshape(-1, 16)
        return out
    if n == 3:
        out = _bc1_color(blocks[:, 8:], True)
        out[..., 3] = _bc3_alpha(blocks[:, :8], False)
        return out
    if n == 4:
        return _bc3_alpha(blocks, bool(signed))[..., None]
    out = np.full((len(blocks), 16, 3), 128 if signed else 0, np.int64)
    out[..., 0] = _bc3_alpha(blocks[:, :8], bool(signed))
    out[..., 1] = _bc3_alpha(blocks[:, 8:], bool(signed))
    return out


# BC7: (subsets, partition bits, rotation bits, index-selection bits,
# colour bits, alpha bits, p-bit per endpoint, p-bit per subset, index
# bits, second index bits) of each mode
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# the two-subset partitions (one bit a pixel) and the three-subset ones
# (two bits a pixel), pixel 0 lowest
_P2 = (0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
       0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
       0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
       0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
       0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
       0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
       0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
       0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
_P3 = (0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000,
       0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500,
       0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450,
       0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0,
       0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4,
       0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
       0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
       0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
       0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
       0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8,
       0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414,
       0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
       0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254)
# the anchor pixel of subset 1 (two subsets), of subsets 1 and 2 (three)
_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
       15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
       15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
       6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_A3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
        3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
        8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
        3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_A3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
        15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
        15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
        15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
            4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


def _subset(ns: int, part: int, i: int) -> int:
    if ns == 2:
        return (_P2[part] >> i) & 1
    if ns == 3:
        return (_P3[part] >> (2 * i)) & 3
    return 0


def _is_anchor(ns: int, part: int, i: int) -> bool:
    return i == 0 or (ns == 2 and i == _A2[part]) or (
        ns == 3 and i in (_A3A[part], _A3B[part]))


class _Bits:
    def __init__(self, block: bytes):
        self.v, self.pos = int.from_bytes(block, "little"), 0

    def take(self, n: int) -> int:
        out = (self.v >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return out


def _bc7_block(block: bytes):
    """16 RGBA tuples of one BC7 block."""
    if block[0] == 0:  # no mode bit set: Pillow's opaque black
        return [(0, 0, 0, 255)] * 16
    bits = _Bits(block)
    mode = 0
    while not bits.take(1):
        mode += 1
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    part, rot, isel = bits.take(pb), bits.take(rb), bits.take(isb)
    nep = 2 * ns
    ep = [[0, 0, 0, 255] for _ in range(nep)]
    for c in range(3):
        for e in range(nep):
            ep[e][c] = bits.take(cb)
    if ab:
        for e in range(nep):
            ep[e][3] = bits.take(ab)
    if epb or spb:
        cb += 1
        ab += 1 if ab else 0
        pbits = ([bits.take(1) for _ in range(nep)] if epb else
                 [p for p in (bits.take(1) for _ in range(ns)) for _ in (0, 1)])
        for e in range(nep):
            for c in range(4 if ab else 3):
                ep[e][c] = ((ep[e][c] << 1) | pbits[e]) & 0xFF
    for e in range(nep):
        for c, n in ((0, cb), (1, cb), (2, cb), (3, ab)):
            if n:
                v = (ep[e][c] << (8 - n)) & 0xFF
                ep[e][c] = v | (v >> n)
    cw = _WEIGHTS[ib]
    aw = _WEIGHTS[ib2 if ab and ib2 else ib]
    cbit = bits.pos
    abit = cbit + 16 * ib - ns
    out = []
    for i in range(16):
        s = 2 * _subset(ns, part, i)
        n = ib - 1 if _is_anchor(ns, part, i) else ib
        i0 = (bits.v >> cbit) & ((1 << n) - 1)
        cbit += n
        if ab and ib2:
            n2 = ib2 - 1 if i == 0 else ib2
            i1 = (bits.v >> abit) & ((1 << n2) - 1)
            abit += n2
            wc, wa = (aw[i1], cw[i0]) if isel else (cw[i0], aw[i1])
        else:
            wc = wa = cw[i0]
        e0, e1 = ep[s], ep[s + 1]
        px = [((64 - wc) * e0[c] + wc * e1[c] + 32) >> 6 for c in range(3)]
        px.append(((64 - wa) * e0[3] + wa * e1[3] + 32) >> 6)
        if rot:
            px[rot - 1], px[3] = px[3], px[rot - 1]
        out.append(tuple(px))
    return out


# BC6H: each mode's fields in the order they are stored: (endpoint value,
# first bit, last bit), a value's bits running from first to last; the
# values are rw gw bw rx gx bx ry gy by rz gz bz (0-11)
def _fields(spec: str):
    names = {k: i for i, k in enumerate(
        "rw gw bw rx gx bx ry gy by rz gz bz".split())}
    out = []
    for tok in spec.split():
        name, rng = tok.split("[")
        rng = rng.rstrip("]")
        a, b = (int(v) for v in rng.split(":")) if ":" in rng else (
            int(rng), int(rng))
        # [9:0] is stored lowest bit first; [10:15] (reversed) highest first
        out.append((names[name], b, a))
    return out


_BC6_LAYOUTS = [_fields(s) for s in (
    "gy[4] by[4] bz[4] rw[9:0] gw[9:0] bw[9:0] rx[4:0] gz[4] gy[3:0] gx[4:0] "
    "bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "gy[5] gz[4] gz[5] rw[6:0] bz[0] bz[1] by[4] gw[6:0] by[5] bz[2] gy[4] "
    "bw[6:0] bz[3] bz[5] bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] bx[5:0] "
    "by[3:0] ry[5:0] rz[5:0]",
    "rw[9:0] gw[9:0] bw[9:0] rx[4:0] rw[10] gy[3:0] gx[3:0] gw[10] bz[0] "
    "gz[3:0] bx[3:0] bw[10] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] gz[4] gy[3:0] gx[4:0] gw[10] "
    "gz[3:0] bx[3:0] bw[10] bz[1] by[3:0] ry[3:0] bz[0] bz[2] rz[3:0] gy[4] "
    "bz[3]",
    "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] by[4] gy[3:0] gx[3:0] gw[10] "
    "bz[0] gz[3:0] bx[4:0] bw[10] by[3:0] ry[3:0] bz[1] bz[2] rz[3:0] bz[4] "
    "bz[3]",
    "rw[8:0] by[4] gw[8:0] gy[4] bw[8:0] bz[4] rx[4:0] gz[4] gy[3:0] gx[4:0] "
    "bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "rw[7:0] gz[4] by[4] gw[7:0] bz[2] gy[4] bw[7:0] bz[3] bz[4] rx[5:0] "
    "gy[3:0] gx[4:0] bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[5:0] rz[5:0]",
    "rw[7:0] bz[0] by[4] gw[7:0] gy[5] gy[4] bw[7:0] gz[5] bz[4] rx[4:0] "
    "gz[4] gy[3:0] gx[5:0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] "
    "rz[4:0] bz[3]",
    "rw[7:0] bz[1] by[4] gw[7:0] by[5] gy[4] bw[7:0] bz[5] bz[4] rx[4:0] "
    "gz[4] gy[3:0] gx[4:0] bz[0] gz[3:0] bx[5:0] by[3:0] ry[4:0] bz[2] "
    "rz[4:0] bz[3]",
    "rw[5:0] gz[4] bz[0] bz[1] by[4] gw[5:0] gy[5] by[5] bz[2] gy[4] "
    "bw[5:0] gz[5] bz[3] bz[5] bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] "
    "bx[5:0] by[3:0] ry[5:0] rz[5:0]",
    "rw[9:0] gw[9:0] bw[9:0] rx[9:0] gx[9:0] bx[9:0]",
    "rw[9:0] gw[9:0] bw[9:0] rx[8:0] rw[10] gx[8:0] gw[10] bx[8:0] bw[10]",
    "rw[9:0] gw[9:0] bw[9:0] rx[7:0] rw[10:11] gx[7:0] gw[10:11] bx[7:0] "
    "bw[10:11]",
    "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10:15] gx[3:0] gw[10:15] bx[3:0] "
    "bw[10:15]")]
# (subsets, transformed, endpoint bits, delta bits r g b) of modes 1-14
_BC6_MODES = ((2, 1, 10, 5, 5, 5), (2, 1, 7, 6, 6, 6), (2, 1, 11, 5, 4, 4),
              (2, 1, 11, 4, 5, 4), (2, 1, 11, 4, 4, 5), (2, 1, 9, 5, 5, 5),
              (2, 1, 8, 6, 5, 5), (2, 1, 8, 5, 6, 5), (2, 1, 8, 5, 5, 6),
              (2, 0, 6, 6, 6, 6), (1, 0, 10, 10, 10, 10),
              (1, 1, 11, 9, 9, 9), (1, 1, 12, 8, 8, 8), (1, 1, 16, 4, 4, 4))


def _sext(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _bc6_unquantize(v: int, bits: int, signed: bool) -> int:
    if not signed:
        if bits >= 15:
            return v
        if v == 0:
            return 0
        if v == (1 << bits) - 1:
            return 0xFFFF
        return ((v << 15) + 0x4000) >> (bits - 1)
    x = _sext(v, 16)  # Pillow keeps endpoints in 16 bits: a masked sum of
    if bits >= 16:    # fewer bits stays positive
        return x
    neg = x < 0
    x = -x if neg else x
    if x == 0:
        return 0
    x = 0x7FFF if x >= (1 << (bits - 1)) - 1 else ((x << 15) + 0x4000) >> (
        bits - 1)
    return -x if neg else x


_F255 = np.float32(255.0)


def _bc6_channel(v: int, signed: bool) -> int:
    """A lerped value -> Pillow's 8-bit sample: the half it finishes to,
    clamped to [0, 1] and scaled by 255 in float32, truncated."""
    if signed:
        h = (0x8000 | ((-v * 31) >> 5)) if v < 0 else (v * 31) >> 5
    else:
        h = (v * 31) >> 6
    f = np.array([h & 0xFFFF], np.uint16).view(np.float16).astype(np.float32)[0]
    if f > 1:
        return 255
    if not f > 0:  # negative, or NaN (x86's float -> int conversion of NaN)
        return 0
    return int(f * _F255)


def _bc6_block(block: bytes, signed: bool):
    bits = _Bits(block)
    m = bits.take(2)
    if m < 2:
        mode = m
    else:
        m |= bits.take(3) << 2
        mode = {2: 2, 6: 3, 10: 4, 14: 5, 18: 6, 22: 7, 26: 8, 30: 9, 3: 10,
                7: 11, 11: 12, 15: 13}.get(m)
        if mode is None:  # a reserved mode: Pillow's zeros
            return [(0, 0, 0)] * 16
    ns, tr, epb, *db = _BC6_MODES[mode]
    e = [0] * 12
    for idx, first, last in _BC6_LAYOUTS[mode]:
        step = 1 if last >= first else -1
        for b in range(first, last + step, step):
            e[idx] |= bits.take(1) << b
    part = bits.take(5) if ns == 2 else 0
    nep = 6 if ns == 1 else 12
    mask = (1 << epb) - 1
    if signed:
        for c in range(3):
            e[c] = _sext(e[c], epb)
    if signed or tr:
        for i in range(3, nep):
            e[i] = _sext(e[i], db[i % 3])
    if tr:
        for i in range(3, nep):
            e[i] = (e[i] + e[i % 3]) & mask
    u = [_bc6_unquantize(v & 0xFFFF, epb, signed) for v in e[:nep]]
    ib = 4 if ns == 1 else 3
    w = _WEIGHTS[ib]
    out = []
    for i in range(16):
        s = 6 * _subset(ns, part, i)
        n = ib - 1 if (i == 0 or (ns == 2 and i == _A2[part])) else ib
        k = w[bits.take(n)]
        out.append(tuple(_bc6_channel(
            (u[s + c] * (64 - k) + u[s + 3 + c] * k) >> 6, signed)
            for c in range(3)))
    return out


def decode_blocks_plain(data: bytes, n: int, signed: int, w: int,
                        h: int) -> np.ndarray:
    """Decode ``ceil(w/4) * ceil(h/4)`` blocks of Pillow's decoder ``n``
    (1-7) into (h, w[, C]) uint8: the plain version of the C++ stage."""
    bw, bh = -(-w // 4), -(-h // 4)
    size = _BLOCK_BYTES[n]
    if len(data) < bw * bh * size:
        raise ValueError("image file is truncated")
    blocks = np.frombuffer(data[:bw * bh * size], np.uint8).reshape(-1, size)
    if n <= 5:
        px = _bc_simple(blocks, n, signed)
    else:
        dec = _bc7_block if n == 7 else (lambda b: _bc6_block(b, bool(signed)))
        px = np.array([dec(bytes(b)) for b in blocks], np.int64)
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        4 * bh, 4 * bw, c)[:h, :w].astype(np.uint8)
    return img[..., 0] if c == 1 else np.ascontiguousarray(img)


def decode_blocks(data: bytes, n: int, signed: int, w: int, h: int
                  ) -> np.ndarray:
    """The C++ stage: ``decode_blocks_plain``'s output."""
    bw, bh = -(-w // 4), -(-h // 4)
    need = bw * bh * _BLOCK_BYTES[n]
    if len(data) < need:
        raise ValueError("image file is truncated")
    c = 1 if n == 4 else (3 if n in (5, 6) else 4)
    out = np.empty((h, w, c), np.uint8)
    rc = _native().bcn_decode(data, need, n, signed, w, h,
                              out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"BCn decode failed ({rc})")
    return out[..., 0] if c == 1 else out


# ----------------------------------------------------------- container
def _rgb_masks(data: bytes, pos: int, w: int, h: int, bitcount: int,
               masks) -> np.ndarray:
    """``DdsRgbDecoder``: each pixel's little-endian word, each mask's bits
    over the mask's value, times 255, truncated; short data reads as
    zeros."""
    nbytes = bitcount // 8
    want = w * h * nbytes
    body = data[pos:pos + want]
    body += bytes(want - len(body))
    raw = np.frombuffer(body, np.uint8).reshape(-1, nbytes).astype(np.uint64)
    word = np.zeros(len(raw), np.uint64)
    for k in range(nbytes):
        word |= raw[:, k] << np.uint64(8 * k)
    out = []
    for m in masks:
        shift = 0
        if m:
            while (m >> (shift + 1)) << (shift + 1) == m:
                shift += 1
        total = m >> shift
        if not total:
            out.append(np.zeros(len(word), np.uint8))
            continue
        v = ((word & np.uint64(m)) >> np.uint64(shift)).astype(np.float64)
        out.append(((v / total) * 255).astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, len(masks))


def open_dds(data: bytes):
    """The header as ``DdsImageFile._open`` reads it: a dict;
    ``struct.error`` where ``Image.open`` moves on, ``ValueError`` where it
    raises."""
    (hsize,) = struct.unpack("<I", data[4:8])
    if hsize != 124:
        raise ValueError(f"unsupported DDS header size {hsize}")
    head = data[8:128]
    if len(head) != 120:
        raise ValueError(f"incomplete DDS header: {len(head)} bytes")
    height, width = struct.unpack("<2I", head[4:12])
    pfflags, fourcc, bitcount = struct.unpack("<I4sI", head[72:84])
    pos = 128
    out = dict(size=(width, height), pos=pos)
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        out.update(mode="RGBA" if n == 4 else "RGB", kind="masks",
                   bitcount=bitcount,
                   masks=struct.unpack(f"<{n}I", head[84:84 + 4 * n]))
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            out.update(mode="L", kind="raw")
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            out.update(mode="LA", kind="raw")
        else:
            raise ValueError(f"unsupported DDS luminance bitcount {bitcount}")
    elif pfflags & _PAL8:
        out.update(mode="P", kind="raw", pos=pos + 1024,
                   palette=data[pos:pos + 1024])
    elif pfflags & _FOURCC:
        if fourcc == b"DX10":
            (fmt,) = struct.unpack("<I", data[128:132])
            out["pos"] = pos + 20
            if fmt in _DXGI:
                mode, n, signed = _DXGI[fmt]
                out.update(mode=mode, kind="bcn", n=n, signed=signed)
            elif fmt in _DXGI_RGBA8:
                out.update(mode="RGBA", kind="raw")
            else:
                raise ValueError(f"unimplemented DXGI format {fmt}")
        elif fourcc in _FOURCCS:
            mode, n, signed = _FOURCCS[fourcc]
            out.update(mode=mode, kind="bcn", n=n, signed=signed)
        else:
            raise ValueError(f"unimplemented DDS pixel format {fourcc!r}")
    else:
        raise ValueError(f"unknown DDS pixel format flags {pfflags}")
    return out


def load_dds(data: bytes, head: dict, plain: bool = False):
    """``(pixels, mode, palette, transparency)`` of an opened header."""
    w, h = head["size"]
    mode, pos = head["mode"], head["pos"]
    palette = transparency = None
    if head["kind"] == "masks":
        px = _rgb_masks(data, pos, w, h, head["bitcount"], head["masks"])
    elif head["kind"] == "bcn":
        dec = decode_blocks_plain if plain else decode_blocks
        px = dec(data[pos:], head["n"], head["signed"], w, h)
    else:
        c = {"L": 1, "P": 1, "LA": 2, "RGBA": 4}[mode]
        body = data[pos:pos + w * h * c]
        if len(body) < w * h * c:
            raise ValueError("image file is truncated")
        px = np.frombuffer(body, np.uint8).reshape((h, w, c) if c > 1
                                                   else (h, w)).copy()
        if mode == "P":
            pal = np.frombuffer(head["palette"].ljust(1024, b"\0"),
                                np.uint8).reshape(256, 4)
            palette = pal[:, :3].copy()
            transparency = pal[:, 3].tobytes()
    return px, mode, palette, transparency
