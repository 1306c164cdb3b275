// Vendor RAW Huffman decoders: Nikon NEF (compression 34713) and Pentax
// PEF (compression 65535).
//
// Fresh implementations from the publicly documented formats (the Huffman
// code tables and difference/predictor semantics are format-defined
// constants, documented in dcraw/exiftool/rawler). The reference app gets
// these decoders from the rawler crate (raw_processing.rs:15-30); here the
// byte-serial inner loops live in C++ because a Python bit-reader costs
// minutes for a 24MP frame.
//
// Both formats share the same structure: a plain MSB-first bitstream (no
// JPEG byte stuffing), a canonical Huffman code giving a "difference
// class", a signed difference decoded JPEG-style, and a two-channel
// predictor: the first two columns of each row predict vertically from the
// previous row of the same column, later columns predict horizontally from
// two columns left (column-parity channels).
//
// Exported (C ABI):
//   nikon_decode(stream, len, out, w, h, tree, split, vpred4, bits)
//   pentax_decode(stream, len, out, w, h, bits)
// Return 0 on success; negative on malformed input.

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* p;
  long len;
  long pos = 0;   // byte position
  int bit = 0;    // bits consumed of current byte
  bool overrun = false;

  BitReader(const uint8_t* data, long n) : p(data), len(n) {}

  inline int get1() {
    if (pos >= len) { overrun = true; return 0; }
    int b = (p[pos] >> (7 - bit)) & 1;
    if (++bit == 8) { bit = 0; ++pos; }
    return b;
  }
  inline uint32_t getbits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | get1();
    return v;
  }
};

// Canonical Huffman built from (counts per length 1..16, values).
struct Huff {
  // lookup by walking bits (tables are tiny: <= 15 codes)
  uint16_t code[32];
  uint8_t clen[32];
  uint8_t value[32];
  int n = 0;

  bool build(const uint8_t* counts, const uint8_t* vals, int nvals) {
    int k = 0;
    uint32_t c = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i) {
        if (k >= nvals || k >= 32) return false;
        if (c >= (1u << l)) return false;  // over-subscribed
        code[k] = (uint16_t)c;
        clen[k] = (uint8_t)l;
        value[k] = vals[k];
        ++c;
        ++k;
      }
      c <<= 1;
    }
    n = k;
    return k > 0;
  }

  // Explicit (code, length, symbol) triples — PEF makernote 0x220 carries
  // the code table verbatim and it need not be canonical.
  bool build_explicit(const uint16_t* codes, const uint8_t* lens,
                      const uint8_t* vals, int nvals) {
    if (nvals <= 0 || nvals > 32) return false;
    for (int k = 0; k < nvals; ++k) {
      if (lens[k] < 1 || lens[k] > 16) return false;
      if (codes[k] >= (1u << lens[k])) return false;
      code[k] = codes[k];
      clen[k] = lens[k];
      value[k] = vals[k];
    }
    n = nvals;
    return true;
  }

  inline int decode(BitReader& br) const {
    uint32_t c = 0;
    int l = 0;
    while (l < 17) {
      c = (c << 1) | (uint32_t)br.get1();
      ++l;
      for (int k = 0; k < n; ++k)
        if (clen[k] == l && code[k] == c) return value[k];
      if (br.overrun) return -1;
    }
    return -1;
  }
};

// Nikon trees (format-defined constants; see dcraw nikon_tree / rawler):
// 16 length counts followed by leaf values. High nibble of a value is the
// "shl" pre-shift of the difference; low nibble is the bit count.
static const uint8_t kNikonTree[6][32] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,  // 12-bit lossy
     5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12},
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,  // 12-bit lossy post-split
     0x39, 0x5a, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12},
    {0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,  // 12-bit lossless
     5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12},
    {0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,  // 14-bit lossy
     5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14},
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0,  // 14-bit lossy post-split
     8, 0x5c, 0x4b, 0x3a, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14},
    {0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0,  // 14-bit lossless
     7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14},
};

static int tree_nvals(const uint8_t* counts) {
  int n = 0;
  for (int l = 0; l < 16; ++l) n += counts[l];
  return n;
}

// Nikon signed difference: value = huff leaf; len = low nibble, shl = high
// nibble. diff = (((getbits(len-shl) << 1) + 1) << shl) >> 1, sign-extended
// the JPEG way when the top bit is clear.
static inline int nikon_diff(BitReader& br, int leaf) {
  int len = leaf & 15;
  int shl = leaf >> 4;
  if (len == 0) return 0;
  int32_t diff = (int32_t)((((br.getbits(len - shl) << 1) + 1) << shl) >> 1);
  if ((diff & (1 << (len - 1))) == 0)
    diff -= (1 << len) - (shl ? 0 : 1);
  return diff;
}

// Standard JPEG difference (Pentax): ssss bits, sign-extend.
static inline int jpeg_diff(BitReader& br, int ssss) {
  if (ssss <= 0) return 0;
  if (ssss >= 16) return -32768;
  int32_t v = (int32_t)br.getbits(ssss);
  if ((v & (1 << (ssss - 1))) == 0) v -= (1 << ssss) - 1;
  return v;
}

}  // namespace

extern "C" int nikon_decode(const uint8_t* stream, long stream_len,
                            uint16_t* out, int width, int height, int tree,
                            int split, const uint16_t* vpred_in, int bits) {
  if (width <= 0 || height <= 0 || tree < 0 || tree > 5) return -1;
  Huff huff;
  if (!huff.build(kNikonTree[tree], kNikonTree[tree] + 16,
                  tree_nvals(kNikonTree[tree])))
    return -2;

  BitReader br(stream, stream_len);
  int32_t vpred[2][2] = {
      {(int32_t)vpred_in[0], (int32_t)vpred_in[1]},
      {(int32_t)vpred_in[2], (int32_t)vpred_in[3]},
  };
  int32_t hpred[2] = {0, 0};
  int32_t maxv = (1 << bits) - 1;

  for (int row = 0; row < height; ++row) {
    if (split && row == split) {
      // lossy type 2: switch to the post-split tree
      if (!huff.build(kNikonTree[tree + 1], kNikonTree[tree + 1] + 16,
                      tree_nvals(kNikonTree[tree + 1])))
        return -2;
    }
    for (int col = 0; col < width; ++col) {
      int leaf = huff.decode(br);
      if (leaf < 0) return -3;
      int32_t diff = nikon_diff(br, leaf);
      if (col < 2)
        hpred[col] = vpred[row & 1][col] += diff;
      else
        hpred[col & 1] += diff;
      int32_t v = hpred[col & 1];
      if (v < 0) v = 0;
      if (v > maxv) v = maxv;
      out[(long)row * width + col] = (uint16_t)v;
    }
  }
  return br.overrun ? -4 : 0;
}

// Pentax default tree (format-defined; dcraw pentax_tree): difference
// classes 0..12 with standard JPEG sign extension. PEFs can override the
// table via makernote 0x220; the default covers the common bodies.
static const uint8_t kPentaxCounts[16] = {0, 2, 3, 1, 1, 1, 1, 1,
                                          1, 2, 0, 0, 0, 0, 0, 0};
static const uint8_t kPentaxVals[13] = {3, 4, 2, 5, 1, 6, 0, 7, 8, 9, 10, 11, 12};

static int pentax_run(const Huff& huff, const uint8_t* stream,
                      long stream_len, uint16_t* out, int width, int height,
                      int bits) {
  BitReader br(stream, stream_len);
  int32_t vpred[2][2] = {{0, 0}, {0, 0}};
  int32_t hpred[2] = {0, 0};
  int32_t maxv = (1 << bits) - 1;

  for (int row = 0; row < height; ++row) {
    for (int col = 0; col < width; ++col) {
      int leaf = huff.decode(br);
      if (leaf < 0) return -3;
      int32_t diff = jpeg_diff(br, leaf);
      if (col < 2)
        hpred[col] = vpred[row & 1][col] += diff;
      else
        hpred[col & 1] += diff;
      int32_t v = hpred[col & 1];
      // deliberate deviation from dcraw: dcraw's derror() stores the
      // wrapped value and warns; this codebase's fuzz contract is that a
      // stream driving predictors out of range fails loudly (ValueError)
      if (v < 0 || v > maxv) return -5;
      out[(long)row * width + col] = (uint16_t)v;
    }
  }
  return br.overrun ? -4 : 0;
}

extern "C" int pentax_decode(const uint8_t* stream, long stream_len,
                             uint16_t* out, int width, int height, int bits) {
  if (width <= 0 || height <= 0) return -1;
  Huff huff;
  if (!huff.build(kPentaxCounts, kPentaxVals, 13)) return -2;
  return pentax_run(huff, stream, stream_len, out, width, height, bits);
}

// Table-driven variant: codes/lens/syms from makernote 0x220 (dcraw builds
// its table from that tag unconditionally; the default above is only the
// fallback when the tag is absent).
extern "C" int pentax_decode_table(const uint8_t* stream, long stream_len,
                                   uint16_t* out, int width, int height,
                                   int bits, const uint16_t* codes,
                                   const uint8_t* lens, const uint8_t* syms,
                                   int nvals) {
  if (width <= 0 || height <= 0) return -1;
  Huff huff;
  if (!huff.build_explicit(codes, lens, syms, nvals)) return -2;
  return pentax_run(huff, stream, stream_len, out, width, height, bits);
}
