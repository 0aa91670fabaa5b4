"""CCITT fax decoding for TIFF compressions 2, 3 and 4, as libtiff 4.7's
``tif_fax3.c`` decodes them (Pillow reads these files through libtiff).

Compression 2 (``CCITTRLE``) is Modified Huffman: each row a run of
T.4 white and black codes (terminating, make-up and extended make-up),
the rows byte-aligned, no EOL.  Compression 3 (``CCITTFAX3``) is T.4: an
EOL before each row; with Group3Options (tag 292) bit 0 each EOL is
followed by a tag bit, 1 for a row coded as above and 0 for one coded in
T.4's two-dimensional modes (pass, horizontal, vertical -3..3) against the
row before; bit 2 (fill bits before each EOL) needs nothing of the
decoder.  Compression 4 (``CCITTFAX4``) is T.6: every row coded in the
two-dimensional modes, no EOLs.  The reference row is white at the start of
each strip or tile.  A row decodes into runs that alternate white and
black from white; white pixels are 0 bits and black ones 1, whatever the
photometric interpretation (the TIFF reader's raw mode inverts them).

The decoder repeats libtiff's state machine (``Fax3Decode1D``,
``Fax3Decode2D``, ``Fax4Decode``, ``Fax3DecodeRLE`` and their macros),
faults included, because Pillow keeps what libtiff gives: a code word no
table holds, an uncompressed-mode extension or a bad row length ends the
row where it is (the rest of it white, as ``CLEANUP_RUNS`` fills it); data
that runs out inside a row is an error (``ValueError``), except in T.6
after at least one row of the strip, where libtiff stops and the strip's
other rows keep what the row buffer held.  ``decode_plain`` is the plain
version of the C++ stage (``csrc/ccitt_decode.cpp``), which ``decode``
runs: the two give the same rows for every input.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ccitt_decode.cpp"

# T.4 Tables 2 and 3: (run, code) for white and black terminating codes,
# their make-up codes, and the extended make-up codes both colours share
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111"
).split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 "
    "0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()

# libtiff's table states (tif_fax3.h)
(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
 S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL) = range(13)


def codes(white: bool) -> List[Tuple[int, str]]:
    """(run, code) of every T.4 code of a colour, terminating codes first."""
    term, makeup = ((_WHITE_TERM, _WHITE_MAKEUP) if white else
                    (_BLACK_TERM, _BLACK_MAKEUP))
    return (list(enumerate(term)) + [(64 * (i + 1), c) for i, c in
                                     enumerate(makeup)]
            + [(1792 + 64 * i, c) for i, c in enumerate(_EXT_MAKEUP)])


def _table(size: int, entries) -> List[Tuple[int, int, int]]:
    """``mkg3states``' table over ``size`` bits taken first bit lowest:
    ``(state, width, param)`` (``S_NULL`` and width 0 where no code
    matches)."""
    tab = [(S_NULL, 0, 0)] * (1 << size)
    for code, state, param in entries:
        n = len(code)
        low = int(code[::-1], 2) if n else 0
        for high in range(1 << (size - n)):
            tab[low | (high << n)] = (state, n, param)
    return tab


def _colour_table(white: bool):
    size = 12 if white else 13
    term, makeup = (S_TERMW, S_MAKEUPW) if white else (S_TERMB, S_MAKEUPB)
    entries = [(c, term if run < 64 else makeup if run < 1792 else S_MAKEUP,
                run) for run, c in codes(white)]
    entries.append(("0" * 11, S_EOL, 0))  # an EOL's 11 zeros
    return _table(size, entries)


_MAIN = _table(7, [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
                   ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
                   ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
                   ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)])
_WHITE = _colour_table(True)
_BLACK = _colour_table(False)
_REVERSE = [int(f"{i:08b}"[::-1], 2) for i in range(256)]
_U32 = 0xFFFFFFFF


def _i32(v: int) -> int:
    """A C ``int`` of the value (the run arrays are ``uint32_t``: a run
    added to ``a0`` or ``b1`` wraps)."""
    return ((v + 0x80000000) & _U32) - 0x80000000


class _Fault(Exception):
    """libtiff's decoder returns -1: ``TIFFReadEncodedStrip`` fails."""


class _Eof(Exception):
    """The data ran out with no bit left (the macros' ``eoflab``)."""


class _Row(Exception):
    """A row ends early (``goto done1d`` / ``eol2d``)."""


class _Decoder:
    """One strip or tile: libtiff's cached state and macros."""

    def __init__(self, data: bytes, width: int, runs: list, nruns: int,
                 two_d_ref: bool):
        self.data, self.cp = data, 0
        self.acc, self.avail = 0, 0
        self.lastx = width
        self.runs, self.nruns = runs, nruns
        self.eolcnt = 0
        self.cur, self.ref = 0, nruns  # offsets of curruns and refruns
        if two_d_ref:
            runs[nruns] = width
            runs[nruns + 1] = 0

    # -- bits (NeedBits8, NeedBits16, GetBits, ClrBits)
    def need8(self, n):
        if self.avail < n:
            if self.cp >= len(self.data):
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= _REVERSE[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8

    def need16(self, n):
        if self.avail < n:
            if self.cp >= len(self.data):
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= _REVERSE[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= len(self.data):
                        self.avail = n
                    else:
                        self.acc |= _REVERSE[self.data[self.cp]] << self.avail
                        self.cp += 1
                        self.avail += 8

    def bits(self, n):
        return self.acc & ((1 << n) - 1)

    def clr(self, n):
        self.avail -= n
        self.acc >>= n

    def lookup(self, size, table, wide):
        (self.need16 if wide else self.need8)(size)
        ent = table[self.bits(size)]
        self.clr(ent[1])
        return ent

    # -- runs (SETVALUE, CLEANUP_RUNS)
    def setvalue(self, x):
        if self.pa >= self.cur + self.nruns:
            raise _Fault("buffer overflow")
        self.runs[self.pa] = (self.run_length + x) & _U32
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run_length = 0

    def cleanup(self):
        if self.run_length:
            self.setvalue(0)
        if self.a0 != self.lastx:
            while self.a0 > self.lastx and self.pa > self.cur:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.runs[self.pa])
            if self.a0 < self.lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.cur) & 1:
                    self.setvalue(0)
                self.setvalue(self.lastx - self.a0)
            elif self.a0 > self.lastx:
                self.setvalue(self.lastx)
                self.setvalue(0)

    def start_row(self):
        self.a0, self.run_length, self.pa = 0, 0, self.cur

    def sync_eol(self):
        if self.eolcnt == 0:
            while True:
                self.need16(11)
                if self.bits(11) == 0:
                    break
                self.clr(1)
        while True:
            self.need8(8)
            if self.bits(8):
                break
            self.clr(8)
        while self.bits(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0

    def colour_run(self, white):
        """A run of one colour: make-up codes then a terminating one;
        False where another code ends the row."""
        size, table = (12, _WHITE) if white else (13, _BLACK)
        term = S_TERMW if white else S_TERMB
        makeup = S_MAKEUPW if white else S_MAKEUPB
        while True:
            state, _, param = self.lookup(size, table, True)
            if state == term:
                self.setvalue(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 = _i32(self.a0 + param)
                self.run_length = _i32(self.run_length + param)
            elif state == S_EOL:
                return "eol"
            else:
                return False

    def expand1d(self):
        """EXPAND1D; raises _Eof after its cleanup where the data ran out."""
        try:
            while True:
                r = self.colour_run(True)
                if r == "eol":
                    self.eolcnt = 1
                    break
                if not r or self.a0 >= self.lastx:
                    break
                r = self.colour_run(False)
                if r == "eol":
                    self.eolcnt = 1
                    break
                if not r or self.a0 >= self.lastx:
                    break
                if (self.pa - self.cur >= 2 and self.runs[self.pa - 1] == 0
                        and self.runs[self.pa - 2] == 0):
                    self.pa -= 2
        except _Eof:
            self.cleanup()
            raise
        self.cleanup()

    def check_b1(self):
        if self.pa != self.cur:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _Fault("buffer overflow")
                self.b1 = _i32(self.b1 + self.runs[self.pb]
                               + self.runs[self.pb + 1])
                self.pb += 2

    def expand2d(self):
        """EXPAND2D; raises _Eof after its cleanup where the data ran out."""
        runs = self.runs
        try:
            while self.a0 < self.lastx:
                if self.pa >= self.cur + self.nruns:
                    raise _Fault("buffer overflow")
                state, _, param = self.lookup(7, _MAIN, False)
                if state == S_PASS:
                    self.check_b1()
                    if self.pb + 1 >= self.ref + self.nruns:
                        raise _Fault("buffer overflow")
                    self.b1 = _i32(self.b1 + runs[self.pb])
                    self.pb += 1
                    self.run_length = _i32(self.run_length + self.b1 - self.a0)
                    self.a0 = self.b1
                    self.b1 = _i32(self.b1 + runs[self.pb])
                    self.pb += 1
                elif state == S_HORIZ:
                    first = (self.pa - self.cur) & 1 == 0  # white first
                    if (self.colour_run(first) is not True
                            or self.colour_run(not first) is not True):
                        raise _Row
                    self.check_b1()
                elif state in (S_V0, S_VR):
                    self.check_b1()
                    self.setvalue(self.b1 - self.a0 + (param if state == S_VR
                                                       else 0))
                    if self.pb >= self.ref + self.nruns:
                        raise _Fault("buffer overflow")
                    self.b1 = _i32(self.b1 + runs[self.pb])
                    self.pb += 1
                elif state == S_VL:
                    self.check_b1()
                    if self.b1 < self.a0 + param:
                        raise _Row
                    self.setvalue(self.b1 - self.a0 - param)
                    self.pb -= 1
                    self.b1 = _i32(self.b1 - runs[self.pb])
                elif state == S_EXT:
                    runs[self.pa] = (self.lastx - self.a0) & _U32
                    self.pa += 1
                    raise _Row
                elif state == S_EOL:
                    runs[self.pa] = (self.lastx - self.a0) & _U32
                    self.pa += 1
                    self.need8(4)
                    self.clr(4)
                    self.eolcnt = 1
                    raise _Row
                else:
                    raise _Row
            if self.run_length:
                if self.run_length + self.a0 < self.lastx:
                    self.need8(1)  # expect a final V0
                    if not self.bits(1):
                        raise _Row
                    self.clr(1)
                self.setvalue(0)
        except _Row:
            pass
        except _Eof:
            self.cleanup()
            raise
        self.cleanup()

    def fill(self, row: np.ndarray):
        """``_TIFFFax3fillruns``: the runs into ``row`` (bits), clamped."""
        runs, lo, hi, lastx = self.runs, self.cur, self.pa, self.lastx
        if (hi - lo) & 1:
            runs[hi] = 0
            hi += 1
        x = 0
        for i in range(lo, hi, 2):
            for j, bit in ((i, 0), (i + 1, 1)):
                run = runs[j]
                if (x + run) & _U32 > lastx or run > lastx:
                    run = runs[j] = (lastx - x) & _U32
                if run:
                    row[x:x + run] = bit
                    x += run


def decode_plain(data: bytes, compression: int, options: int, width: int,
                 rows: int, runs: list, buf: np.ndarray) -> int:
    """The plain version: one strip or tile of ``rows`` rows of ``width``
    pixels into ``buf`` ((rows, width) uint8 bits); returns the rows it
    wrote (a strip that ends early leaves the others as they were).
    ``runs`` is libtiff's run buffer, kept from one strip to the next
    (``run_buffer``).  Raises ``ValueError`` where libtiff's decoder
    fails."""
    two_d = compression == 4 or (compression == 3 and options & 1)
    nruns = len(runs) // 2
    d = _Decoder(data, width, runs, nruns, two_d)
    line, row_2d = 0, False
    try:
        while line < rows:
            d.start_row()
            try:
                if compression == 4:
                    d.pb = d.ref + 1
                    d.b1 = runs[d.ref]
                    d.expand2d()
                    if d.eolcnt:
                        raise _Eof
                elif compression == 3:
                    d.sync_eol()
                    if two_d:
                        d.need8(1)
                        one_d = d.bits(1)
                        d.clr(1)
                        row_2d = not one_d
                        d.pb = d.ref + 1
                        d.b1 = runs[d.ref]
                        d.expand2d() if not one_d else d.expand1d()
                    else:
                        d.expand1d()
                else:
                    d.expand1d()
            except _Eof:
                in_rows = d.pa != d.cur
                if compression == 4:
                    try:  # EOFG4: the EOFB's 13 bits
                        d.need16(13)
                    except _Eof:
                        pass
                    d.clr(13)
                elif not in_rows:  # EOF at the row's start (EOF1D, EOF2D)
                    d.cleanup()
                d.fill(buf[line])
                # libtiff fails a strip whose data ends at its first row, in
                # Modified Huffman, or inside a 2-D row of T.4, and keeps the
                # rows it has in the other cases ("don't error on
                # badly-terminated strips")
                if line == 0 or compression == 2 or (
                        compression == 3 and two_d and in_rows and row_2d):
                    raise _Fault("premature end of data")
                return line + 1
            d.fill(buf[line])
            if compression == 2:
                d.clr(d.avail & 7)  # FAXMODE_BYTEALIGN
            if two_d:
                if compression == 4 or d.pa < d.cur + nruns:
                    d.setvalue(0)  # an imaginary change for the next row
                d.cur, d.ref = d.ref, d.cur
            line += 1
    except _Fault as e:
        raise ValueError(f"CCITT compression {compression}: {e} at row "
                         f"{line}") from None
    return rows


def run_buffer(width: int, compression: int, options: int) -> list:
    """libtiff's run arrays for rows of ``width`` pixels (zeroed once for
    the image: ``Fax3SetupState``), as a list of both halves."""
    nruns = -(-(width + 1) // 32) * 32
    if compression == 4 or (compression == 3 and options & 1):
        nruns *= 2
    return [0] * (2 * nruns)


# ---------------------------------------------------------- the C++ stage
_lock = threading.Lock()
_lib = None


def _native():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            lib.ccitt_decode.restype = ctypes.c_int
            lib.ccitt_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def decode(data: bytes, compression: int, options: int, width: int,
           rows: int, runs: np.ndarray, buf: np.ndarray) -> int:
    """``decode_plain`` through ``csrc/ccitt_decode.cpp``; ``runs`` a
    uint32 array of ``len(run_buffer(...))`` entries, kept across strips."""
    err = ctypes.create_string_buffer(256)
    rc = _native().ccitt_decode(data, len(data), compression, options, width,
                                rows, runs.ctypes.data, len(runs) // 2,
                                buf.ctypes.data, err, len(err))
    if rc < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return rc
