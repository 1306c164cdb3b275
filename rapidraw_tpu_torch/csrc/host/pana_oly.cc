// Panasonic RW2 and Olympus ORF predictive bitstream decoders.
//
// Both algorithms are implemented from their publicly documented dcraw
// semantics (panasonic_load_raw / olympus_load_raw) — the reference app
// gets these formats from the rawler crate (Cargo.toml:27); this is a
// fresh C++ implementation of the published bitstream layouts.
//
// Exported (C ABI, ctypes):
//   panasonic_decode(stream, len, out, raw_width, height)     RW2 12-bit
//   olympus_decode(stream, len, out, raw_width, width, height) ORF predictive
//
// Returns 0 on success; negative codes on malformed input.

#include <cstdint>
#include <cstring>

namespace {

// ------------------------------------------------------------- Panasonic
// RW2 bit reader: the file is consumed in 0x4000-byte sections, each
// stored with its two halves swapped (the first 0x4000-0x2008 bytes of
// file data land at buffer offset 0x2008, the next 0x2008 at offset 0).
// Bits are then read as a plain LSB-first bitstream addressed by a
// DOWN-counting 17-bit cursor: each n-bit read decrements the cursor and
// returns flat bits [vbits, vbits+n) of the section — i.e. values are
// packed from the END of each section backwards.
struct PanaBits {
  const uint8_t* data;
  long len;
  long pos = 0;
  uint8_t buf[0x4001];
  int vbits = 0;
  static constexpr int kLoadFlags = 0x2008;

  explicit PanaBits(const uint8_t* d, long n) : data(d), len(n) {
    std::memset(buf, 0, sizeof(buf));
  }

  bool refill() {
    long first = 0x4000 - kLoadFlags;
    long n1 = first, n2 = kLoadFlags;
    if (pos + n1 + n2 > len) {
      // final partial section: zero-fill
      std::memset(buf, 0, 0x4000);
      n1 = len - pos > first ? first : (len - pos > 0 ? len - pos : 0);
      n2 = len - pos - n1 > 0 ? len - pos - n1 : 0;
    }
    std::memcpy(buf + kLoadFlags, data + pos, n1);
    pos += n1;
    std::memcpy(buf, data + pos, n2);
    pos += n2;
    return true;
  }

  unsigned bits(int nbits) {
    if (vbits == 0) refill();
    vbits = (vbits - nbits) & 0x1ffff;
    // dcraw pana_bits: the byte index XORs 0x3ff0, i.e. the down-counting
    // cursor walks 16-byte groups FORWARD through the section while bytes
    // within each group are consumed backward
    int byte = (vbits >> 3) ^ 0x3ff0;
    return ((buf[byte] | (buf[byte + 1] << 8)) >> (vbits & 7)) &
           ((1u << nbits) - 1);
  }
};

// -------------------------------------------------------------- Olympus
// MSB-first bit reader (dcraw getbits with zero_after_ff = 0).
struct MsbBits {
  const uint8_t* data;
  long len;
  long pos = 0;
  uint64_t acc = 0;
  int nacc = 0;

  MsbBits(const uint8_t* d, long n) : data(d), len(n) {}

  void fill(int need) {
    while (nacc < need) {
      uint8_t b = pos < len ? data[pos++] : 0;
      acc = (acc << 8) | b;
      nacc += 8;
    }
  }

  unsigned peek(int nbits) {
    fill(nbits);
    return (unsigned)((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
  }

  void skip(int nbits) { nacc -= nbits; }

  unsigned get(int nbits) {
    if (nbits == 0) return 0;
    unsigned v = peek(nbits);
    skip(nbits);
    return v;
  }
};

}  // namespace

extern "C" {

// RW2 12-bit "Panasonic RAW" bitstream: per 14-pixel group, two predictor
// channels (even/odd columns) coded as an 8+4-bit seed or an 8-bit delta
// scaled by a 2-bit shift chosen every third pixel.
int panasonic_decode(const uint8_t* stream, long len, uint16_t* out,
                     int raw_width, int height) {
  if (!stream || !out || raw_width <= 0 || height <= 0) return -1;
  PanaBits br(stream, len);
  for (int row = 0; row < height; row++) {
    int pred[2] = {0, 0}, nonz[2] = {0, 0}, sh = 0;
    for (int col = 0; col < raw_width; col++) {
      int i = col % 14;
      if (i == 0) pred[0] = pred[1] = nonz[0] = nonz[1] = 0;
      if (i % 3 == 2) sh = 4 >> (3 - (int)br.bits(2));
      if (nonz[i & 1]) {
        int j = (int)br.bits(8);
        if (j) {
          pred[i & 1] -= 0x80 << sh;
          if (pred[i & 1] < 0 || sh == 4) pred[i & 1] &= ~(-1 << sh);
          pred[i & 1] += j << sh;
        }
      } else {
        nonz[i & 1] = (int)br.bits(8);
        if (nonz[i & 1] || i > 11)
          pred[i & 1] = nonz[i & 1] << 4 | (int)br.bits(4);
      }
      int v = pred[col & 1];
      if (v > 0xffff) return -2;
      out[(long)row * raw_width + col] = (uint16_t)v;
    }
  }
  return 0;
}

// ORF predictive codec: per pixel a 3-bit sign+low pair, a 12-entry
// unary-class Huffman "high" value (escape 12 -> raw bits), per-channel
// carry state, and a W/N/NW gradient predictor.
int olympus_decode(const uint8_t* stream, long len, uint16_t* out,
                   int raw_width, int width, int height) {
  if (!stream || !out || raw_width <= 0 || height <= 0 || width > raw_width)
    return -1;
  // class table: peek 12 bits; the leading-zero count selects
  // (code_length << 8 | value); index 0 is the 12-length escape value 12
  static uint16_t huff[4096];
  {
    int n = 0;
    huff[n] = (12 << 8) | 12;
    for (int i = 11; i >= 0; i--)
      for (int c = 0; c < (2048 >> i); c++) {
        if (++n > 4095) break;
        huff[n] = (uint16_t)(((i + 1) << 8) | i);
      }
  }
  if (len < 8) return -2;
  MsbBits br(stream + 7, len - 7);  // 7 skip bytes before the bitstream
  for (int row = 0; row < height; row++) {
    int acarry[2][3] = {{0, 0, 0}, {0, 0, 0}};
    for (int col = 0; col < raw_width; col++) {
      int* carry = acarry[col & 1];
      int i = 2 * (carry[2] < 3);
      int nbits;
      for (nbits = 2 + i; ((uint16_t)carry[0]) >> (nbits + i); nbits++) {
      }
      int sign3 = (int)br.get(3);
      int low = sign3 & 3;
      int sign = (sign3 & 4) ? -1 : 0;
      unsigned c12 = br.peek(12);
      uint16_t h = huff[c12];
      br.skip(h >> 8);
      int high = (uint8_t)h;
      if (high == 12) high = (int)br.get(16 - nbits) >> 1;
      carry[0] = (high << nbits) | (int)br.get(nbits);
      int diff = (carry[0] ^ sign) + carry[1];
      carry[1] = (diff * 3 + carry[1]) >> 5;
      carry[2] = carry[0] > 16 ? 0 : carry[2] + 1;
      if (col >= width) continue;
      int pred;
      uint16_t* raw = out;
      if (row < 2 && col < 2)
        pred = 0;
      else if (row < 2)
        pred = raw[(long)row * width + col - 2];
      else if (col < 2)
        pred = raw[(long)(row - 2) * width + col];
      else {
        int w = raw[(long)row * width + col - 2];
        int n = raw[(long)(row - 2) * width + col];
        int nw = raw[(long)(row - 2) * width + col - 2];
        if ((w < nw && nw < n) || (n < nw && nw < w)) {
          int dw = w - nw, dn = n - nw;
          if ((dw < 0 ? -dw : dw) > 32 || (dn < 0 ? -dn : dn) > 32)
            pred = w + n - nw;
          else
            pred = (w + n) >> 1;
        } else {
          int dw = w - nw, dn = n - nw;
          pred = (dw < 0 ? -dw : dw) > (dn < 0 ? -dn : dn) ? w : n;
        }
      }
      int v = pred + ((diff << 2) | low);
      if (v >> 12) return -3;  // corrupt stream
      raw[(long)row * width + col] = (uint16_t)v;
    }
  }
  return 0;
}

}  // extern "C"
