// Phase One IIQ compressed-bitstream decoder.
//
// Implements the publicly documented dcraw semantics of
// phase_one_load_raw_c (per-row bit streams of unary-selected code
// lengths + differential prediction, with the format-5 gamma ramp for
// small values). The reference app gets IIQ from the rawler crate
// (Cargo.toml:27); this is a fresh C++ implementation of the published
// bitstream layout. Container parsing, margins, black-field arithmetic
// and the uncompressed/XOR variants live in Python (io/makers.py
// parse_iiq) — this file is only the per-row entropy decode.
//
// Exported (C ABI, ctypes):
//   phase_one_decode(data, len, row_offsets, out, raw_width, raw_height,
//                    fmt, big_endian)
//
// `row_offsets` are byte offsets of each row's bitstream relative to
// `data`. Output is the post-prediction, curve-applied 16-bit "pixel"
// value (pre black subtraction). Returns 0 on success, negative codes on
// malformed input (row offset out of range, predictor overflow, or a
// carry-over length code before any length was established).

#include <cstdint>
#include <cstring>

namespace {

// MSB-first bit reader over 32-bit words fetched in file byte order
// (dcraw ph1_bithuff): the 64-bit accumulator refills one word at a
// time; reads past the end of the stream see zero bits.
struct Ph1Bits {
  const uint8_t* data;
  long len;
  long pos;
  uint64_t bitbuf = 0;
  int vbits = 0;
  bool big;

  Ph1Bits(const uint8_t* d, long n, long start, bool big_endian)
      : data(d), len(n), pos(start), big(big_endian) {}

  uint32_t get4() {
    uint32_t b[4] = {0, 0, 0, 0};
    for (int i = 0; i < 4; i++)
      if (pos + i < len) b[i] = data[pos + i];
    pos += 4;
    return big ? (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
               : (b[3] << 24) | (b[2] << 16) | (b[1] << 8) | b[0];
  }

  unsigned bits(int nbits) {
    if (nbits == 0) return 0;
    if (vbits < nbits) {
      bitbuf = bitbuf << 32 | get4();
      vbits += 32;
    }
    unsigned c = (unsigned)(bitbuf << (64 - vbits) >> (64 - nbits));
    vbits -= nbits;
    return c;
  }
};

}  // namespace

extern "C" {

int phase_one_decode(const uint8_t* data, long len,
                     const uint32_t* row_offsets, uint16_t* out,
                     int raw_width, int raw_height, int fmt,
                     int big_endian) {
  if (!data || !row_offsets || !out || raw_width <= 0 || raw_height <= 0)
    return -1;
  static const int kLength[10] = {8, 7, 6, 9, 11, 10, 5, 12, 14, 13};
  // format-5 ramp for values below 256: i*i/3.969 + 0.5
  uint16_t curve[256];
  for (int i = 0; i < 256; i++)
    curve[i] = (uint16_t)((double)i * i / 3.969 + 0.5);

  int lenc[2] = {0, 0};  // persists across rows (dcraw function scope)
  const int tail_start = raw_width & ~7;
  // dcraw's derror() is non-fatal: a predictor overflow marks the file
  // corrupt (a warning in dcraw) but decoding continues — a single
  // flipped bit garbles the rest of its row, not the whole image, so
  // slightly damaged files still render exactly as dcraw renders them.
  for (int row = 0; row < raw_height; row++) {
    long off = (long)row_offsets[row];
    if (off < 0 || off >= len) return -2;
    Ph1Bits br(data, len, off, big_endian != 0);
    int pred[2] = {0, 0};
    for (int col = 0; col < raw_width; col++) {
      if (col >= tail_start) {
        lenc[0] = lenc[1] = 14;
      } else if ((col & 7) == 0) {
        for (int i = 0; i < 2; i++) {
          int j = 0;
          while (j < 5 && !br.bits(1)) j++;
          if (j--) lenc[i] = kLength[j * 2 + (int)br.bits(1)];
        }
      }
      int i = col & 1;
      if (lenc[i] == 14) {
        pred[i] = (int)br.bits(16);
      } else {
        if (lenc[i] < 1 || lenc[i] > 16) return -4;
        pred[i] += (int)br.bits(lenc[i]) + 1 - (1 << (lenc[i] - 1));
      }
      // overflowed predictors carry forward (dcraw keeps pred as-is) and
      // the store truncates to 16 bits, matching dcraw's ushort write
      const uint16_t stored = (uint16_t)pred[i];
      uint16_t pix = (fmt == 5 && stored < 256) ? curve[stored] : stored;
      out[(long)row * raw_width + col] = pix;
    }
  }
  return 0;
}

}  // extern "C"
