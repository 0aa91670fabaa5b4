"""The plain versions of the JPEG 2000 decoder's C++ stages
(``csrc/j2k_decode.cpp``), in Python and numpy: each computes the same
integers and float32 values in the same order, and the tests and
``chip_smoke.py`` hold the C++ against them.  Nothing on the loaders'
path falls back to them.

* ``tier2``: packet headers (T.800 B.10: tag trees, pass counts, Lblock,
  lengths, OpenJPEG's bit reader with its stuffing after 0xFF) and bodies,
  into each code-block's zero bit-planes, passes and bytes.
* ``tier1``: the MQ decoder (C.3) and the three coding passes of D.3 with
  the run mode, reconstructing each coefficient as OpenJPEG does: on
  becoming significant at bit-plane ``p`` it is ``3 << (p - 1)`` (in units
  of half the lowest plane), and each refinement adds or takes
  ``1 << (p - 1)``.
* ``idwt``: dequantisation (reversible: ``v / 2`` truncated; irreversible:
  ``float(v) * (step / 2)``) and the inverse wavelet, horizontal then
  vertical at each level: integer 5/3 lifting, or float32 9/7 lifting with
  OpenJPEG's constants (``K``, ``1.625732422`` for ``2 / K``, then the
  delta, gamma, beta and alpha steps, each ``x + (a + b) * c``).
* ``mct``: the inverse RCT in integers or ICT in float32, then rounding
  (``lrintf``: ties to even), the DC level shift and the clamp to the
  component's precision.
"""
from __future__ import annotations

import numpy as np

from .j2k_codestream import Corrupt

# --------------------------------------------------------------- tier-2


class _Bits:
    """OpenJPEG's ``opj_bio`` reader: a byte after 0xFF gives 7 bits."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.d, self.p, self.end = data, pos, end
        self.buf = self.ct = 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.p < self.end:
            self.buf |= self.d[self.p]
            self.p += 1

    def read(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v |= ((self.buf >> self.ct) & 1) << i
        return v

    def align(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


class _TagTree:
    def __init__(self, w: int, h: int):
        dims, self.parent = [], []
        while True:
            dims.append((w, h))
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        base, bases = 0, []
        for w, h in dims:
            bases.append(base)
            base += w * h
        self.value = [999] * base  # opj_tgt_reset's: see the C++ TagTree
        self.low = [0] * base
        self.parent = [-1] * base
        for lv in range(len(dims) - 1):
            w, h = dims[lv]
            pw = dims[lv + 1][0]
            for j in range(h):
                for i in range(w):
                    self.parent[bases[lv] + j * w + i] = (
                        bases[lv + 1] + (j // 2) * pw + i // 2)

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> int:
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


def _passes(bits: _Bits) -> int:
    if not bits.read(1):
        return 1
    if not bits.read(1):
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


def tier2(data: bytes, pk: np.ndarray, pb_list: np.ndarray, pb: np.ndarray,
          mb: np.ndarray, sop: bool):
    """Packets -> ``(numbps, passes, offsets, lengths, bytes)`` of each
    code-block: ``numbps`` is ``Mb - zero bit-planes`` (0 where the block
    was never included), ``bytes`` every block's data joined in block
    order at ``offsets``."""
    n = len(mb)
    numbps = np.zeros(n, np.int32)
    passes = np.zeros(n, np.int32)
    lblock = [3] * n
    seen = [False] * n
    chunks = [[] for _ in range(n)]
    incl = [None] * len(pb)
    imsb = [None] * len(pb)
    pos, end = 0, len(data)
    for layer, first, count in pk.tolist():
        if sop and end - pos >= 6 and data[pos] == 0xFF and \
                data[pos + 1] == 0x91:
            pos += 6
        bits = _Bits(data, pos, end)
        got = []
        if bits.read(1):
            for b in pb_list[first:first + count].tolist():
                cw, ch, c0 = (int(v) for v in pb[b])
                if cw * ch == 0:
                    continue
                if incl[b] is None:
                    incl[b], imsb[b] = _TagTree(cw, ch), _TagTree(cw, ch)
                for k in range(cw * ch):
                    ci = c0 + k
                    if not seen[ci]:
                        inc = incl[b].decode(bits, k, layer + 1)
                    else:
                        inc = bits.read(1)
                    if not inc:
                        continue
                    if not seen[ci]:
                        i = 0
                        while not imsb[b].decode(bits, k, i):
                            i += 1
                        numbps[ci] = int(mb[ci]) + 1 - i
                        seen[ci] = True
                    new = _passes(bits)
                    while bits.read(1):
                        lblock[ci] += 1
                    if passes[ci] + new > 109:
                        raise Corrupt("more than 109 coding passes in a "
                                      "code-block")
                    nbits = lblock[ci] + new.bit_length() - 1
                    if nbits > 32:
                        raise Corrupt("a code-block length of more than 32 "
                                      "bits")
                    got.append((ci, bits.read(nbits)))
                    passes[ci] += new
        bits.align()
        pos = bits.p
        for ci, length in got:
            if pos + length > end:
                raise Corrupt(f"a code-block segment of {length} bytes runs "
                              "past the tile's data")
            chunks[ci].append(data[pos:pos + length])
            pos += length
    offsets = np.zeros(n, np.int64)
    lengths = np.zeros(n, np.int32)
    out = bytearray()
    for ci in range(n):
        offsets[ci] = len(out)
        for c in chunks[ci]:
            out += c
        lengths[ci] = len(out) - offsets[ci]
    return numbps, passes, offsets, lengths, bytes(out)


# --------------------------------------------------------------- tier-1
# (Qe, next MPS state, next LPS state, switch) of T.800 Table C.2
MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
CTX_RL, CTX_UNI = 17, 18


class _MQ:
    """T.800 C.3's decoder; past the data it reads 0xFF 0xFF, a marker."""

    def __init__(self, data: bytes):
        self.d, self.n, self.bp = data, len(data), 0
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[0], self.state[CTX_RL], self.state[CTX_UNI] = 4, 3, 46
        self.c = self._at(0) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _at(self, p: int) -> int:
        return self.d[p] if p < self.n else 0xFF

    def _bytein(self):
        nxt = self._at(self.bp + 1)
        if self._at(self.bp) == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += nxt << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.state[cx]
        qe, nmps, nlps, switch = MQ_TABLE[st]
        mps = self.mps[cx]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = mps
                self.state[cx] = nmps
            else:
                d = 1 - mps
                if switch:
                    self.mps[cx] = 1 - mps
                self.state[cx] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return mps
            if self.a < qe:
                d = 1 - mps
                if switch:
                    self.mps[cx] = 1 - mps
                self.state[cx] = nlps
            else:
                d = mps
                self.state[cx] = nmps
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a >= 0x8000:
                return d


def zc_context(h: int, v: int, d: int, orient: int) -> int:
    """Table D.1: the zero-coding context of a coefficient whose
    horizontal, vertical and diagonal neighbours have ``h``, ``v``, ``d``
    significant (OpenJPEG's ``orient`` 1 swaps h and v)."""
    if orient == 1:
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d == 0:
            return 0 if hv == 0 else 1 if hv == 1 else 2
        if d == 1:
            return 3 if hv == 0 else 4 if hv == 1 else 5
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if h == 0:
        if v == 0:
            return 0 if d == 0 else 1 if d == 1 else 2
        return 3 if v == 1 else 4
    if h == 1:
        if v == 0:
            return 5 if d == 0 else 6
        return 7
    return 8


_SC = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0),
       (0, 0): (9, 0), (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1),
       (-1, -1): (13, 1)}


def sc_context(hc: int, vc: int):
    """Table D.3: (context, xor bit) from the clamped horizontal and
    vertical sign contributions."""
    return _SC[(hc, vc)]


def tier1(seg: bytes, w: int, h: int, orient: int, numbps: int,
          passes: int) -> np.ndarray:
    """One code-block's coefficients, (h, w) int32."""
    out = np.zeros((h, w), np.int32)
    if passes == 0 or w == 0 or h == 0:
        return out
    if numbps >= 31:
        raise Corrupt(f"{numbps} bit-planes in a code-block")
    mq = _MQ(seg)
    W2 = w + 2
    sig = [0] * (W2 * (h + 2))
    neg = [0] * (W2 * (h + 2))
    visited = [0] * (W2 * (h + 2))
    refined = [0] * (W2 * (h + 2))
    val = [0] * (W2 * (h + 2))

    def counts(i):
        hh = sig[i - 1] + sig[i + 1]
        vv = sig[i - W2] + sig[i + W2]
        dd = (sig[i - W2 - 1] + sig[i - W2 + 1] + sig[i + W2 - 1]
              + sig[i + W2 + 1])
        return hh, vv, dd

    def sign_of(i, oneplushalf):
        def contrib(j):
            return 0 if not sig[j] else (-1 if neg[j] else 1)
        hc = max(-1, min(1, contrib(i - 1) + contrib(i + 1)))
        vc = max(-1, min(1, contrib(i - W2) + contrib(i + W2)))
        cx, xor = sc_context(hc, vc)
        s = mq.decode(cx) ^ xor
        val[i] = -oneplushalf if s else oneplushalf
        sig[i], neg[i] = 1, s

    def column(x, y0):
        return [(y0 + k + 1) * W2 + x + 1 for k in range(min(4, h - y0))]

    bp = numbps
    kind = 2
    for _ in range(passes):
        if bp < 1:
            break
        one = 1 << bp
        half = one >> 1
        oph = one | half
        for y0 in range(0, h, 4):
            for x in range(w):
                col = column(x, y0)
                if kind == 0:  # significance propagation
                    for i in col:
                        if sig[i] or visited[i]:
                            continue
                        hh, vv, dd = counts(i)
                        if hh + vv + dd == 0:
                            continue
                        if mq.decode(zc_context(hh, vv, dd, orient)):
                            sign_of(i, oph)
                        visited[i] = 1
                elif kind == 1:  # magnitude refinement
                    for i in col:
                        if not sig[i] or visited[i]:
                            continue
                        if refined[i]:
                            cx = 16
                        else:
                            hh, vv, dd = counts(i)
                            cx = 15 if hh + vv + dd else 14
                        v = mq.decode(cx)
                        val[i] += half if v ^ (val[i] < 0) else -half
                        refined[i] = 1
                else:  # cleanup
                    start = 0
                    if len(col) == 4 and not any(
                            sig[i] or visited[i] or sum(counts(i))
                            for i in col):
                        if not mq.decode(CTX_RL):
                            continue
                        r = mq.decode(CTX_UNI) << 1
                        r |= mq.decode(CTX_UNI)
                        sign_of(col[r], oph)
                        start = r + 1
                        for i in col[start:]:
                            hh, vv, dd = counts(i)
                            if mq.decode(zc_context(hh, vv, dd, orient)):
                                sign_of(i, oph)
                        continue
                    for i in col[start:]:
                        if sig[i] or visited[i]:
                            continue
                        hh, vv, dd = counts(i)
                        if mq.decode(zc_context(hh, vv, dd, orient)):
                            sign_of(i, oph)
                if kind == 2:
                    for i in col:
                        visited[i] = 0
        kind += 1
        if kind == 3:
            kind = 0
            bp -= 1
    for y in range(h):
        out[y] = val[(y + 1) * W2 + 1:(y + 1) * W2 + 1 + w]
    return out


# --------------------------------------------------------------- inverse DWT
K = np.float32(1.230174105)
TWO_INV_K = np.float32(1.625732422)
STEPS = (np.float32(-0.443506852), np.float32(-0.882911075),
         np.float32(0.052980118), np.float32(1.586134342))


def _half(a: np.ndarray) -> np.ndarray:
    """C's ``a / 2``: truncated toward 0."""
    return (np.abs(a) // 2 * np.sign(a)).astype(np.int32)


def _mirror(pos: np.ndarray, n: int) -> np.ndarray:
    pos = np.where(pos < 0, -pos, pos)
    return np.where(pos >= n, 2 * (n - 1) - pos, pos)


def _lift53(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Rows of ``x`` (low samples then high) -> reconstructed rows."""
    n = x.shape[1]
    low, high = x[:, :sn], x[:, sn:]
    out = np.empty_like(x)
    if n == 1:
        return _half(x) if cas else x.copy()
    lp = np.arange(sn) * 2 + cas        # positions of the low samples
    hp = np.arange(n - sn) * 2 + 1 - cas
    out[:, lp] = low
    out[:, hp] = high
    left, right = _mirror(lp - 1, n), _mirror(lp + 1, n)
    out[:, lp] = out[:, lp] - ((out[:, left] + out[:, right] + 2) >> 2)
    left, right = _mirror(hp - 1, n), _mirror(hp + 1, n)
    out[:, hp] = out[:, hp] + ((out[:, left] + out[:, right]) >> 1)
    return out


def _lift97(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = x.shape[1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or \
            (cas == 1 and not (sn > 0 or dn > 1)):
        return x.copy()
    lp = np.arange(sn) * 2 + cas
    hp = np.arange(dn) * 2 + 1 - cas
    out = np.empty_like(x)
    out[:, lp] = x[:, :sn] * K
    out[:, hp] = x[:, sn:] * TWO_INV_K
    for k, c in enumerate(STEPS):
        tgt = lp if k % 2 == 0 else hp
        left, right = _mirror(tgt - 1, n), _mirror(tgt + 1, n)
        out[:, tgt] = out[:, tgt] + (out[:, left] + out[:, right]) * c
    return out


def idwt(coef: np.ndarray, res: np.ndarray, bands: list,
         reversible: bool) -> np.ndarray:
    """A tile-component's coefficient plane (int32, ``tier1``'s units) ->
    its samples: int32 (5/3) or float32 (9/7).  ``res`` holds each
    resolution's (x0, y0, x1, y1); ``bands`` each band's plane rectangle
    and step."""
    if reversible:
        a = _half(coef)
    else:
        a = np.zeros(coef.shape, np.float32)
        for bx0, by0, bx1, by1, step in bands:
            a[by0:by1, bx0:bx1] = coef[by0:by1, bx0:bx1].astype(
                np.float32) * np.float32(step)
    lift = _lift53 if reversible else _lift97
    for r in range(1, len(res)):
        x0, y0, x1, y1 = (int(v) for v in res[r])
        px0, py0, px1, py1 = (int(v) for v in res[r - 1])
        rw, rh = x1 - x0, y1 - y0
        if rw and rh:
            a[:rh, :rw] = lift(a[:rh, :rw], px1 - px0, x0 % 2)
            a[:rh, :rw] = lift(a[:rh, :rw].T, py1 - py0, y0 % 2).T
    return a


# --------------------------------------------------------------- MCT, DC shift
ICT = (np.float32(1.402), np.float32(0.34413), np.float32(0.71414),
       np.float32(1.772))


def mct(planes: list, mct_on: bool, prec: list, sgnd: list) -> list:
    """Samples of each component (int32 or float32) -> clamped int32."""
    planes = [p.copy() for p in planes]
    if mct_on and len(planes) >= 3:
        y, u, v = planes[:3]
        if y.dtype == np.int32:
            g = y - ((u + v) >> 2)
            planes[:3] = [v + g, g, u + g]
        else:
            planes[:3] = [y + v * ICT[0], (y - u * ICT[1]) - v * ICT[2],
                          y + u * ICT[3]]
    out = []
    for p, bits, s in zip(planes, prec, sgnd):
        lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if s else \
            (0, (1 << bits) - 1)
        shift = 0 if s else 1 << (bits - 1)
        if p.dtype == np.int32:
            q = p.astype(np.int64) + shift
        else:
            with np.errstate(invalid="ignore"):
                big = p > np.float32(2147483647.0)
                small = p < np.float32(-2147483648.0)
                q = np.rint(np.where(big | small, 0, p)).astype(np.int64)
            q = np.where(big, hi - shift, np.where(small, lo - shift, q))
            q = q + shift
        out.append(np.clip(q, lo, hi).astype(np.int32))
    return out
