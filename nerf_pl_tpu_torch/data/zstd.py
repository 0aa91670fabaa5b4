"""A Zstandard decoder (RFC 8878) for TIFF compression 50000, as libtiff's
``tif_zstd.c`` decodes a strip or tile through libzstd.

It reads skippable frames (skipped) and Zstandard frames: the frame header
(window descriptor, frame content size, no dictionary: a dictionary ID
raises), raw, RLE and compressed blocks; literals raw, RLE or Huffman-coded
in one or four streams, with the tree's weights given directly or
FSE-coded, or treeless (the previous block's tree); sequences whose literal
length, match length and offset codes are predefined, RLE, FSE-coded or a
repeat of the previous block's table, with the three repeat offsets; and
the content checksum (the low 32 bits of XXH64), whose mismatch raises as
libzstd's does.  Every fault of the stream raises ``ValueError``.

The Huffman literals are read by the decoder libzstd 1.5.7 takes, which
shows on a corrupt stream: four streams of 8 bytes or more go through its
fast decoders (``HUF_decompress4X*_usingDTable_internal_fast``), which read
a stream on past its start into the bytes before it and do not check where
it ends; shorter four-stream literals through the decoder
``HUF_selectDecoder`` picks for a new tree (X1, one symbol a lookup, or X2,
two, whose last symbol may skip a pair's bits), kept for treeless blocks;
one stream through X1 for a new tree.  X1 and X2 must end on the stream's
first bit.

``decompress_plain`` is the plain Python version of the C++ stage
(``csrc/zstd_decode.cpp``), which ``decompress`` runs; ``blocks`` lists a
frame's blocks and the modes of each, for tests that check a stream's
coverage.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "zstd_decode.cpp"
MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 * 1024

# RFC 8878 3.1.1.3.2.1: literal length and match length codes (baseline,
# extra bits); the predefined distributions and their accuracy logs
_LL = ([(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)])
_ML = ([(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)])
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
                2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1] * 6 + [2] * 3 + [1] * 15 + [-1] * 5, 5)
# the largest accuracy log and symbol each table takes
_MAX_LOG = {"ll": 9, "ml": 9, "of": 8}
_MAX_SYMBOL = {"ll": 35, "ml": 52, "of": 31}

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


class ZstdError(ValueError):
    pass


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    n, p = len(data), 0

    def rnd(acc, lane):
        return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64

    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).tolist()
        for i in range(0, len(lanes), 4):
            v = [rnd(v[k], lanes[i + k]) for k in range(4)]
        p = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for k in range(4):
            h = ((h ^ rnd(0, v[k])) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= rnd(0, struct.unpack_from("<Q", data, p)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (struct.unpack_from("<I", data, p)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------ bitstreams
class _Forward:
    """Little-endian bits read from the start (FSE table descriptions)."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.bit, self.end = data, pos * 8, end * 8

    def read(self, n: int) -> int:
        if self.bit + n > self.end:
            raise ZstdError("an FSE table description past its block")
        v = int.from_bytes(self.data[self.bit >> 3:(self.bit + n + 7 >> 3) + 1],
                           "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def byte_end(self) -> int:
        return -(-self.bit // 8)


class _Backward:
    """A bitstream read from its end toward its start, after the padding
    bits and the 1 that ends the last byte."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a bitstream without its end mark")
        self.value = int.from_bytes(data, "little")
        self.left = len(data) * 8 - (8 - data[-1].bit_length()) - 1

    def read(self, n: int) -> int:
        """``n`` bits (zeros past the start, which ``overflowed`` tells)."""
        self.left -= n
        if self.left >= 0:
            return (self.value >> self.left) & ((1 << n) - 1)
        v = (self.value << -self.left) & ((1 << n) - 1) if n else 0
        return v

    def overflowed(self) -> bool:
        return self.left < 0


# ------------------------------------------------------------------ FSE
def _read_distribution(data: bytes, pos: int, end: int, max_log: int,
                       max_symbol: int) -> Tuple[List[int], int, int]:
    """An FSE table description: (normalised counts, accuracy log, byte
    after it)."""
    br = _Forward(data, pos, end)
    log = br.read(4) + 5
    if log > max_log:
        raise ZstdError(f"an FSE accuracy log of {log}")
    remaining, counts, symbol = (1 << log) + 1, [], 0
    while remaining > 1 and symbol <= max_symbol:
        bits = remaining.bit_length()
        low = (1 << bits) - 1 - remaining  # values read in bits - 1 bits
        v = br.read(bits - 1)
        if v >= low:
            v |= br.read(1) << (bits - 1)
            if v >= 1 << (bits - 1):
                v -= low
        prob = v - 1
        remaining -= abs(prob)
        counts.append(prob)
        symbol += 1
        if prob == 0:
            while True:
                rep = br.read(2)
                counts += [0] * rep
                symbol += rep
                if rep != 3:
                    break
    if remaining != 1 or symbol > max_symbol + 1:
        raise ZstdError("an FSE table description that does not sum up")
    return counts, log, br.byte_end()


def _fse_table(counts: List[int], log: int):
    """The decoding table: per state (symbol, bits, baseline)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("an FSE table that does not spread")
    nxt = [1 if c == -1 else c for c in counts]
    table = []
    for st in range(size):
        s = symbols[st]
        x = nxt[s]
        nxt[s] += 1
        bits = log - (x.bit_length() - 1)
        table.append((s, bits, (x << bits) - size))
    return table


def _rle_table(symbol: int):
    return [(symbol, 0, 0)]


# -------------------------------------------------------------- Huffman
def _huffman_weights(data: bytes, pos: int, end: int) -> Tuple[List[int], int]:
    """A Huffman tree description: the weights and the byte after it."""
    if pos >= end:
        raise ZstdError("a Huffman tree description past its block")
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if pos + size > end:
            raise ZstdError("Huffman weights past their block")
        w = []
        for b in data[pos:pos + size]:
            w += [b >> 4, b & 15]
        return w[:n], pos + size
    if pos + head > end:
        raise ZstdError("Huffman weights past their block")
    counts, log, after = _read_distribution(data, pos, pos + head, 6, 255)
    table = _fse_table(counts, log)
    br = _Backward(data[after:pos + head])
    s1, s2 = br.read(log), br.read(log)
    w = []
    while True:  # two interleaved states until the stream runs out
        sym, bits, base = table[s1]
        w.append(sym)
        s1 = base + br.read(bits)
        if br.overflowed():
            w.append(table[s2][0])
            break
        sym, bits, base = table[s2]
        w.append(sym)
        s2 = base + br.read(bits)
        if br.overflowed():
            w.append(table[s1][0])
            break
        if len(w) > 255:
            raise ZstdError("too many Huffman weights")
    return w, pos + head


def _huffman_table(weights: List[int]):
    """(table over max_bits: (symbol, bits) per prefix, max_bits)."""
    if len(weights) > 255:
        raise ZstdError("too many Huffman weights")
    if max(weights, default=0) > 12:
        raise ZstdError("a Huffman weight past 12")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    if max_bits > 11:
        raise ZstdError("a Huffman tree deeper than 11 bits")
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights that leave no power of two")
    weights = weights + [rest.bit_length()]
    size = 1 << max_bits
    table = [None] * size
    # codes: by increasing weight (longer codes first), then by symbol
    pos = 0
    for w in range(1, max_bits + 1):
        for s, sw in enumerate(weights):
            if sw == w:
                n = 1 << (w - 1)
                table[pos:pos + n] = [(s, max_bits + 1 - w)] * n
                pos += n
    if pos != size:
        raise ZstdError("a Huffman table that does not fill")
    return table, max_bits


# HUF_selectDecoder's timings: (table, per 256 bytes) of X1 and X2 by the
# share of compressed to regenerated bytes, in sixteenths
_ALGO_TIME = ((0, 0, 1, 1), (0, 0, 1, 1), (150, 216, 381, 119),
              (170, 205, 514, 112), (177, 199, 539, 110),
              (197, 194, 644, 107), (221, 192, 735, 107),
              (256, 189, 881, 106), (359, 188, 1167, 109),
              (582, 187, 1570, 114), (688, 187, 1712, 122),
              (825, 186, 1965, 136), (976, 185, 2131, 150),
              (1180, 186, 2070, 175), (1377, 185, 1731, 202),
              (1412, 185, 1695, 202))


def _select_x2(dst: int, src: int) -> bool:
    """libzstd's ``HUF_selectDecoder``: the two-symbol decoder (X2) where
    its time, less 1/32, beats the one-symbol decoder's (X1)."""
    q = 15 if src >= dst else src * 16 // dst
    a0, b0, a1, b1 = _ALGO_TIME[q]
    t0, t1 = a0 + b0 * (dst >> 8), a1 + b1 * (dst >> 8)
    return t1 + (t1 >> 5) < t0


def _huffman_stream(data: bytes, table, max_bits: int, n: int,
                    x2: bool = False) -> bytes:
    """``n`` literals of one stream.  X1 must end on the stream's first bit;
    X2 reads a pair where both codes fit in its 11-bit lookup (the tree's
    depth if deeper), and its last symbol, where that lookup holds a pair,
    skips both codes' bits and stops at the stream's start
    (``HUF_decodeLastSymbolX2``)."""
    br = _Backward(data)
    target = max(11, max_bits)
    out = bytearray()
    while len(out) < n:
        at = br.left
        s, l1 = table[br.read(max_bits)]
        out.append(s)
        br.left = at - l1
        if not x2:
            continue
        s2, l2 = table[br.read(max_bits)]
        br.left = at - l1
        if l1 + l2 > target:
            continue
        if len(out) < n:
            out.append(s2)
            br.left -= l2
        else:
            br.left = max(at - l1 - l2, 0) if at > 0 else at
    if br.left != 0:
        raise ZstdError("a Huffman stream of the wrong length")
    return bytes(out)


# ----------------------------------------------------------- the blocks
class _State:
    def __init__(self):
        self.huffman = None
        self.x2 = False  # the decoder libzstd built the tree's table for
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _State, modes: dict
              ) -> Tuple[bytes, int]:
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    modes["literals"] = ("raw", "rle", "compressed", "treeless")[kind]
    if kind < 2:
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, head = ((b0 >> 4) + (data[pos + 1] << 4)
                          + (data[pos + 2] << 12)), 3
        pos += head
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals past their block")
            return data[pos:pos + size], pos + size
        if pos >= end:
            raise ZstdError("RLE literals past their block")
        return bytes([data[pos]]) * size, pos + 1
    head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + head > end:
        raise ZstdError("a literals header past its block")
    v = int.from_bytes(data[pos:pos + head], "little") >> 4
    bits = {0: 10, 1: 10, 2: 14, 3: 18}[fmt]
    regen, comp = v & ((1 << bits) - 1), v >> bits
    streams = 1 if fmt == 0 else 4
    modes["streams"] = streams
    pos += head
    if pos + comp > end:
        raise ZstdError("compressed literals past their block")
    stop = pos + comp
    if kind == 2:
        modes["weights"] = "direct" if data[pos] >= 128 else "fse"
        weights, pos = _huffman_weights(data, pos, stop)
        st.huffman = _huffman_table(weights)
        # one stream: HUF_decompress1X1; four: HUF_selectDecoder's pick; a
        # treeless block takes the table's decoder
        st.x2 = streams == 4 and regen > 0 and _select_x2(regen, comp)
    elif st.huffman is None:
        raise ZstdError("treeless literals without a previous tree")
    table, max_bits = st.huffman
    if streams == 1:
        return _huffman_stream(data[pos:stop], table, max_bits, regen,
                               st.x2), stop
    if pos + 6 > stop:
        raise ZstdError("a jump table past its literals")
    s1, s2, s3 = struct.unpack_from("<HHH", data, pos)
    pos += 6
    each = (regen + 3) // 4
    if each * 3 > regen or pos + s1 + s2 + s3 > stop:
        raise ZstdError("literal streams of bad sizes")
    bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
    counts = [each] * 3 + [regen - 3 * each]
    if min(b - a for a, b in zip(bounds, bounds[1:])) >= 8 and \
            3 * each < regen:
        # HUF_decompress4X*_usingDTable_internal_fast: each stream read from
        # its end back through the bytes before it (to the jump table), the
        # end mark's byte allowed to be 0, and no check of where it ends
        out = b"".join(_huffman_fast(data[pos - 6:bounds[i + 1]], table,
                                     max_bits, counts[i]) for i in range(4))
        return out, stop
    out = b"".join(_huffman_stream(data[bounds[i]:bounds[i + 1]], table,
                                   max_bits, counts[i], st.x2)
                   for i in range(4))
    return out, stop


def _huffman_fast(data: bytes, table, max_bits: int, n: int) -> bytes:
    """``n`` literals of the stream that ends ``data``, as the fast 4-stream
    decoders read it: from below the end mark (the whole last byte where it
    is 0), on past the stream's start, zeros past ``data``'s."""
    value = int.from_bytes(data, "little")
    left = len(data) * 8 - (8 - data[-1].bit_length()) - 1 if data[-1] else \
        len(data) * 8
    out = bytearray()
    for _ in range(n):
        if left >= max_bits:
            peek = (value >> (left - max_bits)) & ((1 << max_bits) - 1)
        else:
            peek = (value << (max_bits - left)) & ((1 << max_bits) - 1) \
                if left > 0 else 0
        s, bits = table[peek]
        out.append(s)
        left -= bits
    return bytes(out)


def _sequence_table(name: str, mode: int, data: bytes, pos: int, end: int,
                    st: _State, modes: dict):
    modes[name] = ("predefined", "rle", "fse", "repeat")[mode]
    if mode == 0:
        counts, log = {"ll": _LL_DEFAULT, "ml": _ML_DEFAULT,
                       "of": _OF_DEFAULT}[name]
        st.tables[name] = _fse_table(counts, log)
    elif mode == 1:
        if pos >= end:
            raise ZstdError("an RLE sequence code past its block")
        if data[pos] > _MAX_SYMBOL[name]:
            raise ZstdError(f"an RLE {name} code of {data[pos]}")
        st.tables[name] = _rle_table(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_distribution(data, pos, end, _MAX_LOG[name],
                                              _MAX_SYMBOL[name])
        st.tables[name] = _fse_table(counts, log)
    elif st.tables[name] is None:
        raise ZstdError(f"a repeated {name} table without a previous one")
    return pos


def _block(data: bytes, pos: int, end: int, out: bytearray, st: _State,
           modes: dict) -> None:
    lits, pos = _literals(data, pos, end, st, modes)
    if pos >= end:
        raise ZstdError("a block without its sequences header")
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes["sequences"] = nseq
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after a block's empty sequences")
        out += lits
        return
    flags = data[pos]
    pos += 1
    if flags & 3:
        raise ZstdError("reserved sequence mode bits set")
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _sequence_table(name, (flags >> shift) & 3, data, pos, end, st,
                              modes)
    if pos > end:
        raise ZstdError("sequences past their block")
    br = _Backward(data[pos:end])
    tl, to, tm = st.tables["ll"], st.tables["of"], st.tables["ml"]
    logs = [max(len(t), 1).bit_length() - 1 for t in (tl, to, tm)]
    sl, so, sm = br.read(logs[0]), br.read(logs[1]), br.read(logs[2])
    rep, lit = st.rep, 0
    for i in range(nseq):
        ll_code, of_code, ml_code = tl[sl][0], to[so][0], tm[sm][0]
        if of_code > 31:
            raise ZstdError(f"an offset code of {of_code}")
        offset = (1 << of_code) + br.read(of_code)
        ml_base, ml_bits = _ML[ml_code]
        ml = ml_base + br.read(ml_bits)
        ll_base, ll_bits = _LL[ll_code]
        ll = ll_base + br.read(ll_bits)
        if offset > 3:
            off = offset - 3
            rep[:] = [off, rep[0], rep[1]]
        else:
            idx = offset - 1 + (ll == 0)
            if idx == 0:
                off = rep[0]
            elif idx == 3:
                off = rep[0] - 1
                rep[:] = [off, rep[0], rep[1]]
            else:
                off = rep[idx]
                rep[:] = ([off, rep[0], rep[2]] if idx == 1 else
                          [off, rep[0], rep[1]])
        if off == 0:
            raise ZstdError("an offset of 0")
        if lit + ll > len(lits):
            raise ZstdError("sequences that take more literals than the block has")
        out += lits[lit:lit + ll]
        lit += ll
        if off > len(out):
            raise ZstdError("an offset before the start of the frame")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            for k in range(ml):
                out.append(out[start + k])
        if i + 1 < nseq:
            sl = tl[sl][2] + br.read(tl[sl][1])
            sm = tm[sm][2] + br.read(tm[sm][1])
            so = to[so][2] + br.read(to[so][1])
    if br.left != 0:
        raise ZstdError("a sequence bitstream of the wrong length")
    out += lits[lit:]


class _Cut(Exception):
    """The data ends where libzstd's streaming decoder waits for more."""


def _frame_header(data: bytes, pos: int):
    """(index after the header, window size, content size or None, checksum
    flag); ``_Cut`` where the data ends first."""
    if pos + 5 > len(data):
        raise _Cut
    fhd = data[pos + 4]
    fcs_flag, single, reserved = fhd >> 6, (fhd >> 5) & 1, (fhd >> 3) & 1
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    dict_size = (0, 1, 2, 4)[dict_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + 5 + (not single) + dict_size + fcs_size > len(data):
        raise _Cut
    if reserved:
        raise ZstdError("a frame header's reserved bit set")
    pos += 5
    window = None
    if not single:
        wd = data[pos]
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
        pos += 1
    if dict_size:
        did = int.from_bytes(data[pos:pos + dict_size], "little")
        if did:
            raise ZstdError(f"a frame that needs dictionary {did}")
    pos += dict_size
    size = None
    if fcs_size:
        size = int.from_bytes(data[pos:pos + fcs_size], "little")
        size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    if window is None:
        window = size
    if window > 1 << 27:  # ZSTD_WINDOWLOG_LIMIT_DEFAULT
        raise ZstdError("a frame whose window is past libzstd's default limit")
    return pos, window, size, checksum


def _whole(data: bytes, pos: int, checksum: int) -> bool:
    """Whether the frame's blocks (and checksum) all lie in ``data``
    (``ZSTD_findFrameCompressedSize``)."""
    while True:
        if pos + 3 > len(data):
            return False
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3 + (1 if (head >> 1) & 3 == 1 else head >> 3)
        if pos > len(data):
            return False
        if head & 1:
            return pos + 4 * checksum <= len(data)


def blocks(data: bytes) -> List[dict]:
    """Each block of the first Zstandard frame: its type and, for a
    compressed block, the literals' and sequence tables' modes."""
    listing: List[dict] = []
    _decode(data, None, listing)
    return listing


def _decode(data: bytes, room: Optional[int], listing: Optional[list] = None
            ) -> bytes:
    """The first frame as libtiff's loop over ``ZSTD_decompressStream``
    takes it into ``room`` bytes (None: all of it): a frame whose content
    size fits and whose bytes are all there is decoded in one pass, every
    check made; else block by block, stopping quietly where the data ends
    or once the output is full (after one block more where a block filled
    it exactly)."""
    pos = 0
    while True:  # skippable frames
        if pos + 4 > len(data):
            return b""
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & 0xFFFFFFF0 != 0x184D2A50:
            break
        if pos + 8 > len(data):
            return b""
        pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
    if magic != MAGIC:
        raise ZstdError(f"not a Zstandard frame (magic {magic:#010x})")
    try:
        pos, window, size, checksum = _frame_header(data, pos)
    except _Cut:
        return b""
    one_pass = (size is not None and (room is None or room >= size)
                and _whole(data, pos, checksum))
    block_max = min(window or _BLOCK_MAX, _BLOCK_MAX)
    out, st, last, extra = bytearray(), _State(), 0, False
    while not last:
        if pos + 3 > len(data):
            return bytes(out)
        head = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        pos += 3
        modes = {"type": ("raw", "rle", "compressed", "reserved")[kind]}
        if listing is not None:
            listing.append(modes)
        if kind == 3:
            raise ZstdError("a reserved block type")
        if bsize > block_max:
            raise ZstdError("a block past the frame's largest")
        if pos + (1 if kind == 1 else bsize) > len(data):
            return bytes(out)
        if kind == 1:
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif kind == 0:
            out += data[pos:pos + bsize]
            pos += bsize
        else:
            before = len(out)
            _block(data, pos, pos + bsize, out, st, modes)
            if len(out) - before > _BLOCK_MAX:
                raise ZstdError("a block of more than 128 KiB")
            pos += bsize
        if last and size is not None and len(out) != size:
            raise ZstdError("a frame whose content is not its stated size")
        if not one_pass and room is not None and len(out) >= room:
            if extra or len(out) > room:
                return bytes(out)
            extra = True  # the flush completed: one more block is read
    if checksum:
        if pos + 4 > len(data):
            return bytes(out)
        if struct.unpack_from("<I", data, pos)[0] != xxh64(bytes(out)) & 0xFFFFFFFF:
            raise ZstdError("a content checksum mismatch")
    return bytes(out)


def decompress_plain(data: bytes, expected: int) -> bytes:
    """The plain version: the first frame's first ``expected`` bytes;
    raises where libzstd raises or where the frame gives fewer (libtiff's
    "Not enough data")."""
    try:
        out = _decode(data, expected)
    except (IndexError, struct.error) as e:
        raise ZstdError(f"a corrupt Zstandard stream ({e!r})") from None
    if len(out) < expected:
        raise ZstdError(f"Not enough data: {len(out)} of {expected} bytes")
    return out[:expected]


# ---------------------------------------------------------- the C++ stage
_lock = threading.Lock()
_lib = None


def _native():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            lib.zstd_decompress.restype = ctypes.c_int64
            lib.zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def decompress(data: bytes, expected: int) -> bytes:
    """``decompress_plain`` through ``csrc/zstd_decode.cpp``."""
    out = np.empty(max(expected, 1), np.uint8)
    err = ctypes.create_string_buffer(256)
    n = _native().zstd_decompress(data, len(data), out.ctypes.data, expected,
                                  err, len(err))
    if n < 0:
        raise ZstdError(err.value.decode(errors="replace"))
    return out[:expected].tobytes()
