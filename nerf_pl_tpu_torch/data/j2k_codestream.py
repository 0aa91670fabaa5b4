"""The JPEG 2000 codestream (ITU-T T.800 Annex A) as the C++ stages of
``csrc/j2k_decode.cpp`` take it: the marker segments, each tile's geometry
(tile-components, resolutions, sub-bands, precincts and code-blocks, as
T.800 B.5-B.7 and OpenJPEG's ``opj_tcd_init_tile`` lay them out) and the
order of its packets (B.12, as OpenJPEG's ``opj_pi_next_*`` walk them).

Main header: SIZ, COD, COC, QCD, QCC, then TLM, PLM, CRG, COM and any
unknown marker (read and skipped).  Tile-part headers: SOT, COD, COC, QCD,
QCC, PLT, COM and unknown markers, skipped the same way.
Tile-parts may come in any order; each tile's parts are joined in their
order in the stream.  What the port does not read raises ``Unsupported``
(a ``ValueError``) naming the feature: POC, PPM and PPT, RGN (regions of
interest), EPH markers, component subsampling and any code-block style bit
(BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM).  SOP markers are read.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, TLM, PLM, PLT = 0xFF51, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58
QCD, QCC, RGN, POC, PPM, PPT = 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF60, 0xFF61
CRG, COM = 0xFF63, 0xFF64
_SKIPPED = (TLM, PLM, PLT, CRG, COM)
_REFUSED = {POC: "progression order changes (POC)",
            PPM: "packed packet headers (PPM)",
            PPT: "packed packet headers (PPT)",
            RGN: "regions of interest (RGN)"}
_STYLES = {0x01: "BYPASS", 0x02: "RESET", 0x04: "TERMALL", 0x08: "VSC",
           0x10: "PTERM", 0x20: "SEGSYM"}
LRCP, RLCP, RPCL, PCRL, CPRL = range(5)


class Unsupported(ValueError):
    """A layout the port does not read."""


class Corrupt(ValueError):
    """A codestream OpenJPEG refuses."""


@dataclass
class Coding:
    """COD/COC of one component: levels, code-block exponents, style, the
    wavelet (1: reversible 5/3, 0: irreversible 9/7), precinct exponents
    per resolution."""
    levels: int = 0
    cbw: int = 6
    cbh: int = 6
    style: int = 0
    reversible: int = 1
    precincts: List[tuple] = field(default_factory=list)


@dataclass
class Quant:
    """QCD/QCC of one component: style (0 none, 1 derived, 2 expounded),
    guard bits, ``(exponent, mantissa)`` per band in T.800's order."""
    style: int = 0
    guard: int = 2
    steps: List[tuple] = field(default_factory=list)


@dataclass
class TileParams:
    order: int = LRCP
    layers: int = 1
    mct: int = 0
    sop: bool = False
    eph: bool = False
    coding: List[Coding] = field(default_factory=list)
    quant: List[Quant] = field(default_factory=list)


@dataclass
class Header:
    xsiz: int
    ysiz: int
    xo: int
    yo: int
    xt: int
    yt: int
    xto: int
    yto: int
    prec: List[int]
    sgnd: List[int]
    dx: List[int]
    dy: List[int]
    params: TileParams
    tiles: Dict[int, "Tile"] = field(default_factory=dict)

    @property
    def ncomp(self) -> int:
        return len(self.prec)

    @property
    def grid(self):
        return (-(-(self.xsiz - self.xto) // self.xt),
                -(-(self.ysiz - self.yto) // self.yt))


@dataclass
class Tile:
    index: int
    params: TileParams
    parts: List[bytes] = field(default_factory=list)


def _copy(p: TileParams) -> TileParams:
    return TileParams(p.order, p.layers, p.mct, p.sop, p.eph,
                      [Coding(c.levels, c.cbw, c.cbh, c.style, c.reversible,
                              list(c.precincts)) for c in p.coding],
                      [Quant(q.style, q.guard, list(q.steps))
                       for q in p.quant])


def _spcod(body: bytes, pos: int, with_precincts: bool) -> Coding:
    levels, cbw, cbh, style, wavelet = body[pos:pos + 5]
    if levels > 32:
        raise Corrupt(f"{levels} decomposition levels")
    if cbw > 8 or cbh > 8 or cbw + cbh > 8:
        raise Corrupt("code-block size out of range")
    pos += 5
    if with_precincts:
        pp = body[pos:pos + levels + 1]
        if len(pp) < levels + 1:
            raise Corrupt("truncated precinct sizes")
        precincts = [(b & 15, b >> 4) for b in pp]
    else:
        precincts = [(15, 15)] * (levels + 1)
    return Coding(levels, cbw + 2, cbh + 2, style, 1 if wavelet == 1 else 0,
                  precincts)


def _sqcd(body: bytes) -> Quant:
    sq = body[0]
    style, guard = sq & 31, sq >> 5
    if style == 0:
        steps = [(b >> 3, 0) for b in body[1:]]
    elif style in (1, 2):
        words = struct.unpack(f">{(len(body) - 1) // 2}H",
                              body[1:1 + (len(body) - 1) // 2 * 2])
        steps = [(w >> 11, w & 0x7FF) for w in words]
        if style == 1:
            steps = steps[:1]
    else:
        raise Corrupt(f"quantization style {style}")
    if not steps:
        raise Corrupt("no quantization step")
    return Quant(style, guard, steps)


def _component(body: bytes, ncomp: int):
    if ncomp < 257:
        return body[0], body[1:]
    return struct.unpack(">H", body[:2])[0], body[2:]


def _apply(marker: int, body: bytes, p: TileParams, ncomp: int,
           coc_set: set, qcc_set: set) -> None:
    """A COD, COC, QCD or QCC segment into ``p``; a main COD or QCD does not
    overwrite a component its COC or QCC set."""
    if marker == COD:
        if len(body) < 5 + 5:
            raise Corrupt("short COD")
        scod = body[0]
        order, layers, mct = body[1], struct.unpack(">H", body[2:4])[0], body[4]
        if order > 4:
            raise Corrupt(f"progression order {order}")
        if layers == 0:
            raise Corrupt("no quality layer")
        p.order, p.layers, p.mct = order, layers, mct
        p.sop, p.eph = bool(scod & 2), bool(scod & 4)
        c = _spcod(body, 5, bool(scod & 1))
        for i in range(ncomp):
            if i not in coc_set:
                p.coding[i] = Coding(c.levels, c.cbw, c.cbh, c.style,
                                     c.reversible, list(c.precincts))
    elif marker == COC:
        comp, rest = _component(body, ncomp)
        if comp >= ncomp:
            raise Corrupt(f"COC of component {comp}")
        p.coding[comp] = _spcod(rest, 1, bool(rest[0] & 1))
        coc_set.add(comp)
    elif marker == QCD:
        q = _sqcd(body)
        for i in range(ncomp):
            if i not in qcc_set:
                p.quant[i] = Quant(q.style, q.guard, list(q.steps))
    elif marker == QCC:
        comp, rest = _component(body, ncomp)
        if comp >= ncomp:
            raise Corrupt(f"QCC of component {comp}")
        p.quant[comp] = _sqcd(rest)
        qcc_set.add(comp)


def _segments(data: bytes, pos: int):
    """``(marker, body, next position)`` of the marker segment at ``pos``."""
    if pos + 4 > len(data):
        raise Corrupt("the codestream ends in a header")
    marker, length = struct.unpack(">HH", data[pos:pos + 4])
    if marker >> 8 != 0xFF:
        raise Corrupt(f"expected a marker at byte {pos}")
    if length < 2 or pos + 2 + length > len(data):
        raise Corrupt(f"marker 0x{marker:04X} runs past the codestream")
    return marker, data[pos + 4:pos + 2 + length], pos + 2 + length


def parse(data: bytes) -> Header:
    """The main header and every tile-part of a codestream."""
    if data[:2] != b"\xff\x4f" or len(data) < 4 or data[2:4] != b"\xff\x51":
        raise Corrupt("no SOC and SIZ")
    marker, body, pos = _segments(data, 2)
    if len(body) < 36:
        raise Corrupt("short SIZ")
    (_, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz) = struct.unpack(
        ">HIIIIIIIIH", body[:36])
    if csiz == 0 or len(body) < 36 + 3 * csiz:
        raise Corrupt("SIZ component count")
    if (xt == 0 or yt == 0 or xo >= xsiz or yo >= ysiz or xto > xo
            or yto > yo or xto + xt <= xo or yto + yt <= yo):
        raise Corrupt("SIZ image or tile geometry")
    prec, sgnd, dx, dy = [], [], [], []
    for i in range(csiz):
        s, rx, ry = body[36 + 3 * i:39 + 3 * i]
        if (s & 0x7F) + 1 > 38 or rx == 0 or ry == 0:
            raise Corrupt("SIZ component")
        prec.append((s & 0x7F) + 1)
        sgnd.append(s >> 7)
        dx.append(rx)
        dy.append(ry)
    params = TileParams(coding=[Coding() for _ in range(csiz)],
                        quant=[Quant() for _ in range(csiz)])
    hdr = Header(xsiz, ysiz, xo, yo, xt, yt, xto, yto, prec, sgnd, dx, dy,
                 params)
    coc_set, qcc_set = set(), set()
    seen = set()
    while True:
        if pos + 2 > len(data):
            raise Corrupt("the codestream ends in the main header")
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker in (SOT, EOC):
            break
        marker, body, pos = _segments(data, pos)
        if marker in _REFUSED:
            raise Unsupported(_REFUSED[marker])
        if marker in (COD, COC, QCD, QCC):
            _apply(marker, body, params, csiz, coc_set, qcc_set)
            seen.add(marker)
    if COD not in seen or QCD not in seen:
        raise Corrupt("no COD or QCD in the main header")
    _tile_parts(data, pos, hdr)
    return hdr


def _tile_parts(data: bytes, pos: int, hdr: Header) -> None:
    nx, ny = hdr.grid
    n = len(data)
    while pos + 2 <= n:
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == EOC:
            return
        if marker != SOT:
            raise Corrupt(f"expected SOT at byte {pos}")
        start = pos
        marker, body, pos = _segments(data, pos)
        if len(body) != 8:
            raise Corrupt("SOT length")
        isot, psot, tpsot, _ = struct.unpack(">HIBB", body)
        if isot >= nx * ny:
            raise Corrupt(f"tile {isot} of {nx * ny}")
        end = n if psot == 0 else start + psot
        if end > n:
            raise Corrupt(f"tile {isot} part {tpsot} runs past the codestream")
        tile = hdr.tiles.get(isot)
        if tile is None:
            tile = hdr.tiles[isot] = Tile(isot, _copy(hdr.params))
        if tpsot != len(tile.parts):
            raise Corrupt(f"tile {isot} part {tpsot} out of order")
        coc_set, qcc_set = set(), set()
        while True:
            if pos + 2 > end:
                raise Corrupt(f"tile {isot} has no SOD")
            marker = struct.unpack(">H", data[pos:pos + 2])[0]
            if marker == SOD:
                pos += 2
                break
            marker, body, pos = _segments(data, pos)
            if marker in _REFUSED:
                raise Unsupported(_REFUSED[marker])
            if marker in (COD, COC, QCD, QCC):
                if tpsot != 0:
                    raise Corrupt(f"0x{marker:04X} after tile {isot}'s "
                                  "first part")
                _apply(marker, body, tile.params, hdr.ncomp, coc_set, qcc_set)
        tile.parts.append(data[pos:end])
        pos = end
    raise Corrupt("the codestream ends without EOC")


# --------------------------------------------------------------- geometry
def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceilpow2(a: int, n: int) -> int:
    return -((-a) >> n)


@dataclass
class Layout:
    """One tile's arrays for the C++ stages.  Per component ``c``:
    ``rect[c]`` (x0, y0, x1, y1) of the tile-component, ``res[c]`` a
    (levels + 1, 4) array of resolution rectangles, ``bands[c]`` a list of
    (x0, y0, x1, y1 in the component's coefficient plane, orient, Mb,
    exponent, mantissa) for LL then each level's HL, LH, HH.  Code-blocks
    (``cblk_*``, one row each): plane position, size, orient, Mb, component.
    Precinct-bands (``pb_*``): code-block grid and first code-block.
    Packets (``pk_*``): layer, first entry and count in ``pb_list``."""
    rect: list
    res: list
    bands: list
    cblk: np.ndarray          # (n, 7) int64: comp, px, py, w, h, orient, mb
    pb: np.ndarray            # (m, 3) int32: cw, ch, first code-block
    pk: np.ndarray            # (k, 3) int32: layer, first, count
    pb_list: np.ndarray       # int32


def _band_step(q: Quant, index: int) -> tuple:
    if q.style == 1:
        e0, m0 = q.steps[0]
        e = e0 - (index - 1) // 3 if index else e0
        return max(e, 0), m0
    if index < len(q.steps):
        return q.steps[index]
    return 0, 0


def tile_rect(hdr: Header, t: int):
    nx = hdr.grid[0]
    p, q = t % nx, t // nx
    return (max(hdr.xto + p * hdr.xt, hdr.xo),
            max(hdr.yto + q * hdr.yt, hdr.yo),
            min(hdr.xto + (p + 1) * hdr.xt, hdr.xsiz),
            min(hdr.yto + (q + 1) * hdr.yt, hdr.ysiz))


def layout(hdr: Header, tile: Tile) -> Layout:
    """The geometry and packet order of ``tile``."""
    p = tile.params
    tx0, ty0, tx1, ty1 = tile_rect(hdr, tile.index)
    rects, res_all, bands_all = [], [], []
    cblk_rows, pb_rows = [], []
    pb_index = {}  # (comp, res, prec) -> list of pb ids in band order
    prec_grid = {}  # (comp, res) -> (pw, ph, ppx, ppy)
    for c in range(hdr.ncomp):
        if hdr.dx[c] != 1 or hdr.dy[c] != 1:
            raise Unsupported("component subsampling")
        cod, q = p.coding[c], p.quant[c]
        if cod.style:
            raise Unsupported("code-block style " + "+".join(
                n for b, n in _STYLES.items() if cod.style & b))
        x0, y0, x1, y1 = tx0, ty0, tx1, ty1
        rects.append((x0, y0, x1, y1))
        nl = cod.levels
        res = []
        bands = []
        for r in range(nl + 1):
            lv = nl - r
            res.append((_ceilpow2(x0, lv), _ceilpow2(y0, lv),
                        _ceilpow2(x1, lv), _ceilpow2(y1, lv)))
        res_all.append(np.array(res, np.int64))
        for r in range(nl + 1):
            rx0, ry0, rx1, ry1 = res[r]
            ppx, ppy = cod.precincts[r] if r < len(cod.precincts) else (15, 15)
            if r and (ppx == 0 or ppy == 0):
                raise Corrupt("a precinct exponent of 0 past resolution 0")
            pw = (_ceilpow2(rx1, ppx) - (rx0 >> ppx)) if rx1 > rx0 else 0
            ph = (_ceilpow2(ry1, ppy) - (ry0 >> ppy)) if ry1 > ry0 else 0
            prec_grid[(c, r)] = (pw, ph, ppx, ppy)
            if r == 0:
                orients = (0,)
                cbg_w, cbg_h = ppx, ppy
                px0, py0 = (rx0 >> ppx) << ppx, (ry0 >> ppy) << ppy
            else:
                orients = (1, 2, 3)
                cbg_w, cbg_h = ppx - 1, ppy - 1
                px0 = _ceilpow2((rx0 >> ppx) << ppx, 1)
                py0 = _ceilpow2((ry0 >> ppy) << ppy, 1)
            cbw, cbh = min(cod.cbw, cbg_w), min(cod.cbh, cbg_h)
            for orient in orients:
                if r == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                    ox = oy = 0
                    index = 0
                else:
                    nb = nl - r + 1
                    xob, yob = orient & 1, orient >> 1
                    bx0 = _ceilpow2(x0 - (xob << (nb - 1)), nb)
                    by0 = _ceilpow2(y0 - (yob << (nb - 1)), nb)
                    bx1 = _ceilpow2(x1 - (xob << (nb - 1)), nb)
                    by1 = _ceilpow2(y1 - (yob << (nb - 1)), nb)
                    prev = res[r - 1]
                    ox = (prev[2] - prev[0]) if xob else 0
                    oy = (prev[3] - prev[1]) if yob else 0
                    index = 3 * (r - 1) + orient
                e, m = _band_step(q, index)
                mb = e + q.guard - 1
                bands.append((ox, oy, ox + bx1 - bx0, oy + by1 - by0, orient,
                              mb, e, m, r))
                empty = bx1 <= bx0 or by1 <= by0
                for prec in range(pw * ph):
                    ids = pb_index.setdefault((c, r, prec), [])
                    if empty:
                        continue
                    gx0 = px0 + (prec % pw) * (1 << cbg_w)
                    gy0 = py0 + (prec // pw) * (1 << cbg_h)
                    cx0, cy0 = max(gx0, bx0), max(gy0, by0)
                    cx1 = min(gx0 + (1 << cbg_w), bx1)
                    cy1 = min(gy0 + (1 << cbg_h), by1)
                    sx, sy = (cx0 >> cbw) << cbw, (cy0 >> cbh) << cbh
                    cw = (_ceilpow2(cx1, cbw) << cbw) - sx >> cbw
                    ch = (_ceilpow2(cy1, cbh) << cbh) - sy >> cbh
                    if cw < 0 or ch < 0:
                        raise Corrupt("a precinct outside its band")
                    ids.append(len(pb_rows))
                    pb_rows.append((cw, ch, len(cblk_rows)))
                    for j in range(ch):
                        for i in range(cw):
                            kx0 = max(sx + (i << cbw), cx0)
                            ky0 = max(sy + (j << cbh), cy0)
                            kx1 = min(sx + ((i + 1) << cbw), cx1)
                            ky1 = min(sy + ((j + 1) << cbh), cy1)
                            cblk_rows.append((c, ox + kx0 - bx0, oy + ky0 - by0,
                                              max(kx1 - kx0, 0),
                                              max(ky1 - ky0, 0), orient, mb))
        bands_all.append(bands)
    keys = packet_order(hdr, p, (tx0, ty0, tx1, ty1), prec_grid)
    pk, pb_list = [], []
    for layer, r, c, prec in keys:
        ids = pb_index[(c, r, prec)]
        pk.append((layer, len(pb_list), len(ids)))
        pb_list += ids
    return Layout(rects, res_all, bands_all,
                  np.array(cblk_rows, np.int64).reshape(-1, 7),
                  np.array(pb_rows, np.int32).reshape(-1, 3),
                  np.array(pk, np.int32).reshape(-1, 3),
                  np.array(pb_list, np.int32))


def packet_order(hdr: Header, p: TileParams, trect, prec_grid) -> list:
    """``(layer, resolution, component, precinct)`` of each packet in the
    tile's progression order, as OpenJPEG's packet iterator gives them."""
    ncomp = hdr.ncomp
    nres = [p.coding[c].levels + 1 for c in range(ncomp)]
    maxres = max(nres)
    layers = p.layers
    out = []
    if p.order in (LRCP, RLCP):
        outer = ((l, r) for l in range(layers) for r in range(maxres)) \
            if p.order == LRCP else \
            ((l, r) for r in range(maxres) for l in range(layers))
        for l, r in outer:
            for c in range(ncomp):
                if r >= nres[c]:
                    continue
                pw, ph, _, _ = prec_grid[(c, r)]
                out += [(l, r, c, k) for k in range(pw * ph)]
        return out
    tx0, ty0, tx1, ty1 = trect
    dx = dy = 0
    for c in range(ncomp):
        for r in range(nres[c]):
            _, _, ppx, ppy = prec_grid[(c, r)]
            lv = nres[c] - 1 - r
            ddx, ddy = 1 << (ppx + lv), 1 << (ppy + lv)
            dx = ddx if not dx else min(dx, ddx)
            dy = ddy if not dy else min(dy, ddy)
    done = set()

    def visit(r, c, x, y):
        if r >= nres[c]:
            return
        pw, ph, ppx, ppy = prec_grid[(c, r)]
        lv = nres[c] - 1 - r
        trx0, try0 = _ceildiv(tx0, 1 << lv), _ceildiv(ty0, 1 << lv)
        trx1, try1 = _ceildiv(tx1, 1 << lv), _ceildiv(ty1, 1 << lv)
        rpx, rpy = ppx + lv, ppy + lv
        if not (y % (1 << rpy) == 0
                or (y == ty0 and (try0 << lv) % (1 << rpy))):
            return
        if not (x % (1 << rpx) == 0
                or (x == tx0 and (trx0 << lv) % (1 << rpx))):
            return
        if pw == 0 or ph == 0 or trx0 == trx1 or try0 == try1:
            return
        prci = (_ceildiv(x, 1 << lv) >> ppx) - (trx0 >> ppx)
        prcj = (_ceildiv(y, 1 << lv) >> ppy) - (try0 >> ppy)
        k = prci + prcj * pw
        for l in range(layers):
            if (l, r, c, k) not in done:
                done.add((l, r, c, k))
                out.append((l, r, c, k))

    def ys():
        y = ty0
        while y < ty1:
            yield y
            y += dy - y % dy

    def xs():
        x = tx0
        while x < tx1:
            yield x
            x += dx - x % dx

    if p.order == RPCL:
        for r in range(maxres):
            for y in ys():
                for x in xs():
                    for c in range(ncomp):
                        visit(r, c, x, y)
    elif p.order == PCRL:
        for y in ys():
            for x in xs():
                for c in range(ncomp):
                    for r in range(nres[c]):
                        visit(r, c, x, y)
    else:  # CPRL
        for c in range(ncomp):
            cdx = cdy = 0
            for r in range(nres[c]):
                _, _, ppx, ppy = prec_grid[(c, r)]
                lv = nres[c] - 1 - r
                ddx, ddy = 1 << (ppx + lv), 1 << (ppy + lv)
                cdx = ddx if not cdx else min(cdx, ddx)
                cdy = ddy if not cdy else min(cdy, ddy)
            y = ty0
            while y < ty1:
                x = tx0
                while x < tx1:
                    for r in range(nres[c]):
                        visit(r, c, x, y)
                    x += cdx - x % cdx
                y += cdy - y % cdy
    return out
