// The C++ stage of the port's CCITT fax decoder (nerf_pl_tpu_torch/data/
// ccitt.py holds the plain version and the description): one TIFF strip or
// tile of compression 2 (Modified Huffman, rows byte-aligned), 3 (T.4, 1-D
// or, with Group3Options bit 0, 2-D) or 4 (T.6) into rows of bits, with
// libtiff 4.7's tif_fax3.c state machine, faults included.  Built with g++
// at first use and called through ctypes.

#include <cstdint>
#include <cstdio>
#include <vector>

namespace {

enum {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct Ent {
  uint8_t state, width;
  uint16_t param;
};

// T.4 Tables 2 and 3, as in ccitt.py
const char *kWhiteTerm[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",
    "1110",     "1111",     "10011",    "10100",    "00111",    "01000",
    "001000",   "000011",   "110100",   "110101",   "101010",   "101011",
    "0100111",  "0001100",  "0001000",  "0010111",  "0000011",  "0000100",
    "0101000",  "0101011",  "0010011",  "0100100",  "0011000",  "00000010",
    "00000011", "00011010", "00011011", "00010010", "00010011", "00010100",
    "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100",
    "00100101", "01011000", "01011001", "01011010", "01011011", "01001010",
    "01001011", "00110010", "00110011", "00110100"};
const char *kWhiteMakeUp[27] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",
    "00110111",  "01100100",  "01100101",  "01101000",  "01100111",
    "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001",
    "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000",    "010011011"};
const char *kBlackTerm[64] = {
    "0000110111",   "010",          "11",           "10",
    "011",          "0011",         "0010",         "00011",
    "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",
    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001",
    "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011",
    "000000100100", "000000110111", "000000111000", "000000100111",
    "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char *kBlackMakeUp[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",
    "000000110011",  "000000110100",  "000000110101",  "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char *kExtMakeUp[13] = {
    "00000001000",  "00000001100",  "00000001101",  "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states' tables over `size` bits taken first bit lowest
void put(std::vector<Ent> &t, int size, const char *code, int state, int param) {
  int n = 0, low = 0;
  for (; code[n]; ++n) low |= (code[n] == '1') << n;
  for (int high = 0; high < (1 << (size - n)); ++high)
    t[low | (high << n)] = Ent{(uint8_t)state, (uint8_t)n, (uint16_t)param};
}

struct Tables {
  std::vector<Ent> main, white, black;
  uint8_t reverse[256];
  Tables() : main(128, Ent{S_Null, 0, 0}), white(4096, Ent{S_Null, 0, 0}),
             black(8192, Ent{S_Null, 0, 0}) {
    put(main, 7, "0001", S_Pass, 0);
    put(main, 7, "001", S_Horiz, 0);
    put(main, 7, "1", S_V0, 0);
    put(main, 7, "011", S_VR, 1);
    put(main, 7, "000011", S_VR, 2);
    put(main, 7, "0000011", S_VR, 3);
    put(main, 7, "010", S_VL, 1);
    put(main, 7, "000010", S_VL, 2);
    put(main, 7, "0000010", S_VL, 3);
    put(main, 7, "0000001", S_Ext, 0);
    put(main, 7, "0000000", S_EOL, 0);
    for (int w = 0; w < 2; ++w) {
      std::vector<Ent> &t = w ? white : black;
      int size = w ? 12 : 13;
      for (int i = 0; i < 64; ++i) put(t, size, w ? kWhiteTerm[i] : kBlackTerm[i], w ? S_TermW : S_TermB, i);
      for (int i = 0; i < 27; ++i)
        put(t, size, w ? kWhiteMakeUp[i] : kBlackMakeUp[i], w ? S_MakeUpW : S_MakeUpB, 64 * (i + 1));
      for (int i = 0; i < 13; ++i) put(t, size, kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
      put(t, size, "00000000000", S_EOL, 0);  // an EOL's 11 zeros
    }
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
      reverse[i] = (uint8_t)r;
    }
  }
};
const Tables kT;

struct Fault {
  const char *msg;
};
struct Eof {};
struct RowEnd {};

// libtiff's cached decoder state and macros for one strip or tile
struct Decoder {
  const uint8_t *data;
  int64_t n, cp = 0;
  uint32_t acc = 0;
  int avail = 0;
  int lastx;
  uint32_t *runs;
  int64_t nruns;
  int eolcnt = 0;
  int64_t cur = 0, ref;  // offsets of curruns and refruns
  int a0 = 0, run_length = 0, b1 = 0;
  int64_t pa = 0, pb = 0;

  inline void need8(int k) {
    if (avail < k) {
      if (cp >= n) {
        if (avail == 0) throw Eof{};
        avail = k;
      } else {
        acc |= (uint32_t)kT.reverse[data[cp++]] << avail;
        avail += 8;
      }
    }
  }
  inline void need16(int k) {
    if (avail < k) {
      if (cp >= n) {
        if (avail == 0) throw Eof{};
        avail = k;
      } else {
        acc |= (uint32_t)kT.reverse[data[cp++]] << avail;
        if ((avail += 8) < k) {
          if (cp >= n) {
            avail = k;
          } else {
            acc |= (uint32_t)kT.reverse[data[cp++]] << avail;
            avail += 8;
          }
        }
      }
    }
  }
  inline uint32_t bits(int k) const { return acc & ((1u << k) - 1); }
  inline void clr(int k) {
    avail -= k;
    acc >>= k;
  }
  inline const Ent &lookup(int size, const std::vector<Ent> &t, bool wide) {
    if (wide)
      need16(size);
    else
      need8(size);
    const Ent &e = t[bits(size)];
    clr(e.width);
    return e;
  }
  inline void setvalue(int x) {
    if (pa >= cur + nruns) throw Fault{"buffer overflow"};
    runs[pa++] = (uint32_t)(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > cur) a0 -= (int)runs[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - cur) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  void sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        need16(11);
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need8(8);
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
  }
  // a run of one colour: 1 done, 0 another code ends the row, 2 an EOL
  int colour_run(bool white) {
    const std::vector<Ent> &t = white ? kT.white : kT.black;
    int term = white ? S_TermW : S_TermB, makeup = white ? S_MakeUpW : S_MakeUpB;
    for (;;) {
      const Ent &e = lookup(white ? 12 : 13, t, true);
      if (e.state == term) {
        setvalue(e.param);
        return 1;
      }
      if (e.state == makeup || e.state == S_MakeUp) {
        a0 += e.param;
        run_length += e.param;
      } else {
        return e.state == S_EOL ? 2 : 0;
      }
    }
  }
  void expand1d() {
    try {
      for (;;) {
        int r = colour_run(true);
        if (r == 2) {
          eolcnt = 1;
          break;
        }
        if (!r || a0 >= lastx) break;
        r = colour_run(false);
        if (r == 2) {
          eolcnt = 1;
          break;
        }
        if (!r || a0 >= lastx) break;
        if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
      }
    } catch (const Eof &) {
      cleanup();
      throw;
    }
    cleanup();
  }
  void check_b1() {
    if (pa != cur)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) throw Fault{"buffer overflow"};
        b1 += runs[pb] + runs[pb + 1];
        pb += 2;
      }
  }
  void expand2d() {
    try {
      while (a0 < lastx) {
        if (pa >= cur + nruns) throw Fault{"buffer overflow"};
        const Ent &e = lookup(7, kT.main, false);
        switch (e.state) {
          case S_Pass:
            check_b1();
            if (pb + 1 >= ref + nruns) throw Fault{"buffer overflow"};
            b1 += runs[pb++];
            run_length += b1 - a0;
            a0 = b1;
            b1 += runs[pb++];
            break;
          case S_Horiz: {
            bool white = ((pa - cur) & 1) == 0;
            if (colour_run(white) != 1 || colour_run(!white) != 1) throw RowEnd{};
            check_b1();
            break;
          }
          case S_V0:
          case S_VR:
            check_b1();
            setvalue(b1 - a0 + (e.state == S_VR ? e.param : 0));
            if (pb >= ref + nruns) throw Fault{"buffer overflow"};
            b1 += runs[pb++];
            break;
          case S_VL:
            check_b1();
            if (b1 < a0 + (int)e.param) throw RowEnd{};
            setvalue(b1 - a0 - e.param);
            b1 -= runs[--pb];
            break;
          case S_Ext:
            runs[pa++] = (uint32_t)(lastx - a0);
            throw RowEnd{};
          case S_EOL:
            runs[pa++] = (uint32_t)(lastx - a0);
            need8(4);
            clr(4);
            eolcnt = 1;
            throw RowEnd{};
          default:
            throw RowEnd{};
        }
      }
      if (run_length) {
        if (run_length + a0 < lastx) {
          need8(1);  // expect a final V0
          if (!bits(1)) throw RowEnd{};
          clr(1);
        }
        setvalue(0);
      }
    } catch (const RowEnd &) {
    } catch (const Eof &) {
      cleanup();
      throw;
    }
    cleanup();
  }
  // _TIFFFax3fillruns: the runs into a row of bits, clamped at lastx
  void fill(uint8_t *row) {
    int64_t hi = pa;
    if ((hi - cur) & 1) runs[hi++] = 0;
    uint32_t x = 0, ux = (uint32_t)lastx;
    for (int64_t i = cur; i < hi; i += 2)
      for (int j = 0; j < 2; ++j) {
        uint32_t run = runs[i + j];
        if (x + run > ux || run > ux) run = runs[i + j] = ux - x;
        if (run) {
          for (uint32_t k = 0; k < run; ++k) row[x + k] = (uint8_t)j;
          x += run;
        }
      }
  }
};

}  // namespace

extern "C" {

// data: one strip's or tile's bytes (fill order 1); rows x width bits into
// buf (one byte a pixel); runs: libtiff's two run arrays of nruns entries,
// kept from one strip to the next.  Returns the rows written, or -1 with
// `err` set where libtiff's decoder fails.
int ccitt_decode(const uint8_t *data, int64_t len, int compression, int options,
                 int64_t width, int64_t rows, uint32_t *runs, int64_t nruns,
                 uint8_t *buf, char *err, int errlen) {
  bool two_d = compression == 4 || (compression == 3 && (options & 1));
  Decoder d;
  d.data = data;
  d.n = len;
  d.lastx = (int)width;
  d.runs = runs;
  d.nruns = nruns;
  d.ref = nruns;
  if (two_d) {
    runs[nruns] = (uint32_t)width;
    runs[nruns + 1] = 0;
  }
  int64_t line = 0;
  bool row_2d = false;  // the row being read is coded in T.4's 2-D modes
  try {
    while (line < rows) {
      uint8_t *row = buf + line * width;
      d.a0 = 0;
      d.run_length = 0;
      d.pa = d.cur;
      try {
        if (compression == 4) {
          d.pb = d.ref + 1;
          d.b1 = (int)runs[d.ref];
          d.expand2d();
          if (d.eolcnt) throw Eof{};
        } else if (compression == 3) {
          d.sync_eol();
          if (two_d) {
            d.need8(1);
            bool one_d = d.bits(1);
            d.clr(1);
            row_2d = !one_d;
            d.pb = d.ref + 1;
            d.b1 = (int)runs[d.ref];
            if (one_d)
              d.expand1d();
            else
              d.expand2d();
          } else {
            d.expand1d();
          }
        } else {
          d.expand1d();
        }
      } catch (const Eof &) {
        bool in_row = d.pa != d.cur;
        if (compression == 4) {  // EOFG4: the EOFB's 13 bits
          try {
            d.need16(13);
          } catch (const Eof &) {
          }
          d.clr(13);
        } else if (!in_row) {  // EOF at the row's start (EOF1D, EOF2D)
          d.cleanup();
        }
        d.fill(row);
        // libtiff fails a strip whose data ends at its first row, in Modified
        // Huffman, or inside a 2-D row of T.4, and keeps the rows it has in
        // the other cases ("don't error on badly-terminated strips")
        if (line == 0 || compression == 2 || (compression == 3 && two_d && in_row && row_2d))
          throw Fault{"premature end of data"};
        return (int)(line + 1);
      }
      d.fill(row);
      if (compression == 2) d.clr(d.avail & 7);  // FAXMODE_BYTEALIGN
      if (two_d) {
        if (compression == 4 || d.pa < d.cur + nruns) d.setvalue(0);
        int64_t t = d.cur;
        d.cur = d.ref;
        d.ref = t;
      }
      ++line;
    }
  } catch (const Fault &f) {
    if (err && errlen > 0)
      snprintf(err, errlen, "CCITT compression %d: %s at row %lld", compression, f.msg,
               (long long)line);
    return -1;
  }
  return (int)rows;
}

}  // extern "C"
