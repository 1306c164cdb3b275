// CCITT fax decoder for the TIFF reader (io/tiff.py): one strip or tile of
// TIFF compression 2 (Modified Huffman, each row byte-aligned, no EOL),
// 32771 (CCITT RLE-W: Modified Huffman, each row word-aligned as
// Fax3DecodeRLE aligns it: the bits left in its accumulator cut to a
// multiple of 16, and a byte skipped when none are left and the next byte
// lies at an odd address, which for PIL's mapped file is an odd offset;
// with 16 or more bits left the next row starts on the encoder's pad byte,
// and a code in no table ends a row as EXPAND1D ends it), 3
// (T.4: one-dimensional, or two-dimensional when T4Options bit 0 is set,
// every row after an EOL, fill bits or not) or 4 (T.6), as libtiff's
// tif_fax3.c decodes it for PIL: Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D
// and Fax4Decode with their EXPAND1D / EXPAND2D / SYNC_EOL / CLEANUP_RUNS
// steps, the run arrays and the reference line kept as libtiff keeps them.
// White runs are 0 bits and black runs 1 bits whatever the photometric
// interpretation says; the reader applies it. Bits are read most
// significant first: a FillOrder 2 strip is bit-reversed by the caller.
//
// Where libtiff only warns (a row of the wrong length) this file does as
// libtiff does; a code that is in no table, which libtiff reports and
// then decodes past, and a strip that ends before its rows (except a T.6
// strip with at least one row, which libtiff accepts and leaves the rest
// as it was) return an error.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
  S_MakeUp, S_EOL
};

struct Entry {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

struct Code {
  const char* bits;
  int run;
};

// ITU-T T.4 tables 2 and 3: terminating (0-63) and make-up codes
const Code kWhiteTerm[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320},
    {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
    {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5},
    {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10},
    {"0000101", 11}, {"0000111", 12}, {"00000100", 13}, {"00000111", 14},
    {"000011000", 15}, {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18},
    {"00001100111", 19}, {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22},
    {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26},
    {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30},
    {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42},
    {"000011011011", 43}, {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46},
    {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50},
    {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54},
    {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62},
    {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
// both colours
const Code kExtMakeUp[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

// Tables indexed by the next `wid` bits with the first bit in bit 0, as
// libtiff's LOOKUP macros index theirs.
struct Tables {
  Entry white[1 << 12], black[1 << 13], main[1 << 7];
  static void put(Entry* t, int wid, const char* bits, State s, int param) {
    int len = static_cast<int>(std::strlen(bits)), v = 0;
    for (int i = 0; i < len; ++i) v |= (bits[i] - '0') << i;
    for (int suffix = 0; suffix < (1 << (wid - len)); ++suffix) {
      Entry& e = t[v | (suffix << len)];
      e.state = s;
      e.width = static_cast<uint8_t>(len);
      e.param = param;
    }
  }
  Tables() {
    for (const Code& c : kWhiteTerm) put(white, 12, c.bits, S_TermW, c.run);
    for (const Code& c : kWhiteMakeUp) put(white, 12, c.bits, S_MakeUpW, c.run);
    for (const Code& c : kBlackTerm) put(black, 13, c.bits, S_TermB, c.run);
    for (const Code& c : kBlackMakeUp) put(black, 13, c.bits, S_MakeUpB, c.run);
    for (const Code& c : kExtMakeUp) {
      put(white, 12, c.bits, S_MakeUp, c.run);
      put(black, 13, c.bits, S_MakeUp, c.run);
    }
    // mkg3states.c's EOLH: eleven zeros, the EOL's closing 1 left unread
    put(white, 12, "00000000000", S_EOL, 0);
    put(black, 13, "00000000000", S_EOL, 0);
    put(main, 7, "1", S_V0, 0);
    put(main, 7, "011", S_VR, 1);
    put(main, 7, "000011", S_VR, 2);
    put(main, 7, "0000011", S_VR, 3);
    put(main, 7, "010", S_VL, 1);
    put(main, 7, "000010", S_VL, 2);
    put(main, 7, "0000010", S_VL, 3);
    put(main, 7, "001", S_Horiz, 0);
    put(main, 7, "0001", S_Pass, 0);
    put(main, 7, "0000001", S_Ext, 0);
    put(main, 7, "0000000", S_EOL, 0);
  }
};
const Tables kT;

struct Bad {};  // a code in no table, or runs past the arrays
struct Eof {};  // the data ended before the rows did

uint8_t reverse(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct Decoder {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t acc = 0;
  int avail = 0;
  int lastx;
  std::vector<int32_t> cur, ref;  // run arrays: white, black, white, ...
  int32_t* pa = nullptr;
  int32_t* thisrun = nullptr;
  int32_t* pb = nullptr;
  int32_t a0 = 0, b1 = 0, run_length = 0;
  int eol = 0;
  // EXPAND1D's recovery: a code in no table ends the row (libtiff reports
  // it and decodes on), kept for RLE-W, whose word alignment can leave the
  // reader on a pad byte
  bool recover = false;

  Decoder(const uint8_t* d, long n, int width) : cp(d), ep(d + n), lastx(width) {
    size_t nruns = 2 * (static_cast<size_t>(width) + 2) + 8;
    cur.assign(nruns, 0);
    ref.assign(nruns, 0);
    ref[0] = width;  // the reference line before the first row: all white
  }

  // NeedBits8 / NeedBits16: past the data, zeros stand in until none of
  // the real bits are left
  void need(int n) {
    while (avail < n) {
      if (cp >= ep) {
        if (avail == 0) throw Eof{};
        avail = n;
        return;
      }
      acc |= static_cast<uint32_t>(reverse(*cp++)) << avail;
      avail += 8;
    }
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    acc >>= n;
    avail -= n;
  }
  const Entry& lookup(const Entry* t, int wid) {
    need(wid);
    const Entry& e = t[get(wid)];
    clr(e.width);
    return e;
  }
  void setvalue(int32_t x) {
    if (pa >= cur.data() + cur.size()) throw Bad{};
    *pa++ = run_length + x;
    a0 += x;
    run_length = 0;
  }
  void cleanup_runs() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  void start_row() {
    a0 = 0;
    run_length = 0;
    pa = thisrun = cur.data();
  }
  // one run of a colour: make-up codes, then its terminating code
  bool run(bool white) {
    for (;;) {
      const Entry& e = white ? lookup(kT.white, 12) : lookup(kT.black, 13);
      switch (e.state) {
        case S_EOL:
          eol = 1;
          return false;
        case S_TermW: case S_TermB:
          if ((e.state == S_TermW) != white) throw Bad{};
          setvalue(e.param);
          return true;
        case S_MakeUpW: case S_MakeUpB: case S_MakeUp:
          if (e.state != S_MakeUp && (e.state == S_MakeUpW) != white) throw Bad{};
          a0 += e.param;
          run_length += e.param;
          break;
        default:
          if (recover) return false;
          throw Bad{};
      }
    }
  }
  void expand1d() {
    for (;;) {
      if (!run(true)) break;
      if (a0 >= lastx) break;
      if (!run(false)) break;
      if (a0 >= lastx) break;
      if (pa - thisrun >= 2 && pa[-1] == 0 && pa[-2] == 0) pa -= 2;
    }
    cleanup_runs();
  }
  void check_b1() {
    if (pa != thisrun) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref.data() + ref.size()) throw Bad{};
        b1 += pb[0] + pb[1];
        pb += 2;
      }
    }
  }
  void expand2d() {
    while (a0 < lastx) {
      if (pa >= cur.data() + cur.size()) throw Bad{};
      const Entry& e = lookup(kT.main, 7);
      switch (e.state) {
        case S_Pass:
          check_b1();
          b1 += *pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += *pb++;
          break;
        case S_Horiz:
          if ((pa - thisrun) & 1) {
            if (!run(false)) throw Bad{};
            if (!run(true)) throw Bad{};
          } else {
            if (!run(true)) throw Bad{};
            if (!run(false)) throw Bad{};
          }
          check_b1();
          break;
        case S_V0:
          check_b1();
          setvalue(b1 - a0);
          b1 += *pb++;
          break;
        case S_VR:
          check_b1();
          setvalue(b1 - a0 + e.param);
          b1 += *pb++;
          break;
        case S_VL:
          check_b1();
          if (b1 < a0 + e.param) throw Bad{};
          setvalue(b1 - a0 - e.param);
          b1 -= *--pb;
          break;
        case S_EOL:
          *pa++ = lastx - a0;
          need(4);
          if (get(4)) throw Bad{};
          clr(4);
          eol = 1;
          cleanup_runs();
          return;
        default:
          throw Bad{};
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {
        // expect a final V0
        need(1);
        if (!get(1)) throw Bad{};
        clr(1);
      }
      setvalue(0);
    }
    cleanup_runs();
  }
  void sync_eol() {
    if (eol == 0) {
      for (;;) {
        need(11);
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need(8);
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eol = 0;
  }
  void start_2d_row() {
    start_row();
    pb = ref.data();
    b1 = *pb++;
  }
  // the row's runs into packed bits, black runs set (_TIFFFax3fillruns),
  // then the row becomes the reference (with its imaginary change)
  void fill(uint8_t* row) {
    std::memset(row, 0, (static_cast<size_t>(lastx) + 7) / 8);
    int32_t x = 0;
    for (int32_t* r = thisrun; r < pa; r += 2) {
      int32_t w = r[0];
      if (x + w > lastx || w > lastx) w = lastx - x;
      x += w;
      if (r + 1 >= pa) break;
      int32_t b = r[1];
      if (x + b > lastx || b > lastx) b = lastx - x;
      for (int32_t i = x; i < x + b; ++i) row[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
      x += b;
    }
  }
  void swap_reference() {
    setvalue(0);  // imaginary change for reference
    std::fill(pa, cur.data() + cur.size(), 0);
    cur.swap(ref);
  }
};

}  // namespace

extern "C" {

// Decode one strip or tile of `rows` rows of `width` pixels into `out`,
// rows of (width + 7) / 8 bytes, most significant bit first. `compression`
// is the TIFF code (2, 3, 4 or 32771), `t4options` the T4Options tag (bit 0:
// two-dimensional), `offset` the chunk's offset in the file (RLE-W aligns
// its rows to the file's words). Returns the rows decoded (all of them), -1 for a code in
// no table, -2 for data that ends before the rows, -3 for bad arguments.
int ccitt_decode(const uint8_t* src, long n, int width, int rows, int compression,
                 int t4options, uint8_t* out, long offset) {
  if (!src || !out || n < 0 || width <= 0 || rows < 0 ||
      ((compression < 2 || compression > 4) && compression != 32771))
    return -3;
  Decoder d(src, n, width);
  d.recover = compression == 32771;
  const size_t stride = (static_cast<size_t>(width) + 7) / 8;
  int line = 0;
  try {
    for (; line < rows; ++line) {
      uint8_t* row = out + stride * line;
      if (compression == 2) {
        d.start_row();
        d.expand1d();
        d.fill(row);
        d.clr(d.avail & 7);  // FAXMODE_BYTEALIGN
      } else if (compression == 32771) {
        d.start_row();
        d.expand1d();
        d.fill(row);
        d.clr(d.avail & 15);  // FAXMODE_WORDALIGN
        if (d.avail == 0 && ((d.cp - src + offset) & 1)) ++d.cp;
      } else if (compression == 3 && !(t4options & 1)) {
        d.start_row();
        d.sync_eol();
        d.expand1d();
        d.fill(row);
      } else if (compression == 3) {
        d.sync_eol();
        d.need(1);
        bool one_d = d.get(1);
        d.clr(1);
        d.start_2d_row();
        if (one_d) {
          d.expand1d();
        } else {
          d.expand2d();
        }
        d.fill(row);
        d.swap_reference();
      } else {
        d.start_2d_row();
        d.expand2d();
        if (d.eol) throw Eof{};
        d.fill(row);
        d.swap_reference();
      }
    }
  } catch (const Bad&) {
    return -1;
  } catch (const Eof&) {
    // Fax4Decode does not fail a strip that ends after a row: the rows
    // left stay as they were (white)
    if (compression == 4 && line > 0) {
      std::memset(out + stride * line, 0, stride * (rows - line));
      return rows;
    }
    return -2;
  }
  return rows;
}

}  // extern "C"
