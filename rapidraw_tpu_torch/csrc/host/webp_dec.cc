// WebP decoder for the LDR loader: the pixels libwebp 1.6.0 gives PIL's
// WebPAnimDecoder (MODE_RGBA, default options: fancy upsampling on, no
// dithering, in-loop filtering on).
//
//   * VP8L lossless (RFC 9649): the predictor, cross-colour, subtract-green
//     and colour-indexing transforms, the colour cache, meta prefix codes
//     and the LZ77 distance map; the same stream without a header is the
//     ALPH chunk's lossless coding;
//   * VP8 lossy key frames (RFC 6386): segments, coefficient probability
//     updates, 16x16 / 4x4 luma and 8x8 chroma intra prediction with the
//     127 / 129 frame borders, dequantisation, the inverse WHT and DCT,
//     the simple and normal loop filters in macroblock order, then YUV
//     4:2:0 to RGB through the "fancy" upsampler (9-3-3-1 weights, edges
//     mirrored) and the 14-bit fixed-point VP8YUVToR/G/B;
//   * ALPH: raw or lossless-coded alpha, and its horizontal, vertical and
//     gradient unfilters.
//
// The VP8 tables, transforms, predictors, loop filters and the upsampler
// live in vp8_common.h, shared with the encoder (webp_enc.cc); RFC 9649's
// distance map is here. Any bitstream error, and
// any read past the end of a partition or stream, fails the decode: libwebp
// returns no partial frame either.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8_common.h"

namespace {

enum Status { kOk = 0, kBadArgs = -1, kCorrupt = -3, kTruncated = -2 };

// ---------------------------------------------------------------- VP8L --

struct LBits {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;       // next byte to load
  uint64_t val = 0;     // loaded bits, LSB first
  int nbits = 0;        // bits in val
  uint64_t consumed = 0;

  LBits(const uint8_t* d, size_t n) : data(d), len(n) {}
  inline void fill() {
    while (nbits <= 56) {
      uint64_t b = pos < len ? data[pos] : 0;
      ++pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(val & ((1ull << n) - 1));
  }
  inline void skip(int n) {
    val >>= n;
    nbits -= n;
    consumed += n;
  }
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  // libwebp's end of stream: more bits used than the buffer holds (at
  // least the 64 bits its first load takes).
  bool overrun() const {
    uint64_t avail = 8ull * len;
    if (avail < 64) avail = 64;
    return consumed > avail;
  }
};

constexpr int kRootBits = 8;

struct Huff {
  // canonical code: a root table over the first 8 bits (LSB-first,
  // reversed), longer codes decoded bit by bit
  std::vector<uint32_t> root;  // (len << 16) | symbol; len 0xff: long
  int count[16] = {0};
  int first[16] = {0};
  int offset[16] = {0};
  std::vector<uint16_t> sorted;
  bool single = false;
  int single_sym = 0;

  bool build(const std::vector<int>& lens) {
    int n = (int)lens.size();
    int nonzero = 0;
    for (int i = 0; i < n; ++i) {
      if (lens[i] < 0 || lens[i] > 15) return false;
      if (lens[i]) { ++count[lens[i]]; ++nonzero; single_sym = i; }
    }
    if (nonzero == 1) {  // one symbol: a code of no bits
      single = true;
      return true;
    }
    if (nonzero == 0) return false;
    // the code must be complete (libwebp refuses incomplete and
    // over-subscribed codes)
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int code = 0, off = 0;
    for (int l = 1; l < 16; ++l) {
      code = (code + (l > 1 ? count[l - 1] : 0)) << 1;
      if (l == 1) code = 0;
      first[l] = code;
      offset[l] = off;
      off += count[l];
    }
    sorted.assign(nonzero, 0);
    int fill_at[16];
    for (int l = 0; l < 16; ++l) fill_at[l] = offset[l];
    for (int i = 0; i < n; ++i)
      if (lens[i]) sorted[fill_at[lens[i]]++] = (uint16_t)i;
    root.assign(1 << kRootBits, 0xff0000u);
    // canonical codes, assigned per length in symbol order
    for (int l = 1; l <= kRootBits; ++l) {
      for (int k = 0; k < count[l]; ++k) {
        int c = first[l] + k;
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> (l - 1 - b)) & 1) << b;
        uint32_t entry = ((uint32_t)l << 16) | sorted[offset[l] + k];
        for (int r = rev; r < (1 << kRootBits); r += 1 << l) root[r] = entry;
      }
    }
    return true;
  }

  inline int read(LBits& br) const {
    if (single) return single_sym;
    uint32_t e = root[br.peek(kRootBits)];
    if ((e >> 16) != 0xff) {
      br.skip((int)(e >> 16));
      return (int)(e & 0xffff);
    }
    int c = 0;
    for (int l = 1; l < 16; ++l) {
      c = (c << 1) | (int)br.read(1);
      if (c - first[l] < count[l] && c >= first[l]) return sorted[offset[l] + c - first[l]];
    }
    return -1;
  }
};

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct Group {
  Huff h[5];
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

class VP8LDecoder {
 public:
  explicit VP8LDecoder(LBits& br) : br_(br) {}

  bool read_code_lengths(const std::vector<int>& cl_lens, int num_symbols, std::vector<int>& lens) {
    Huff t;
    if (!t.build(cl_lens)) return false;
    int max_symbol;
    if (br_.read(1)) {
      int length_nbits = 2 + 2 * (int)br_.read(3);
      max_symbol = 2 + (int)br_.read(length_nbits);
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    lens.assign(num_symbols, 0);
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      int code_len = t.read(br_);
      if (code_len < 0) return false;
      if (code_len < 16) {
        lens[symbol++] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOff[3] = {3, 3, 11};
        int slot = code_len - 16;
        int repeat = (int)br_.read(kExtra[slot]) + kOff[slot];
        if (symbol + repeat > num_symbols) return false;
        int len = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lens[symbol++] = len;
      }
    }
    return true;
  }

  bool read_huffman(int alphabet, Huff& out) {
    std::vector<int> lens(alphabet, 0);
    if (br_.read(1)) {  // simple code
      int num = (int)br_.read(1) + 1;
      int first_bits = (int)br_.read(1);
      int s0 = (int)br_.read(first_bits == 0 ? 1 : 8);
      if (s0 < alphabet) lens[s0] = 1;
      if (num == 2) {
        int s1 = (int)br_.read(8);
        if (s1 < alphabet) lens[s1] = 1;
      }
    } else {
      std::vector<int> cl(19, 0);
      int num_codes = (int)br_.read(4) + 4;
      if (num_codes > 19) return false;
      for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = (int)br_.read(3);
      if (!read_code_lengths(cl, alphabet, lens)) return false;
    }
    if (br_.overrun()) return false;
    return out.build(lens);
  }

  // One image stream (RFC 9649 section 5): its transforms when level0, the
  // colour cache, the meta prefix codes when level0, the entropy-coded
  // pixels. out: xsize * ysize ARGB, after the inverse transforms.
  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    std::vector<Transform> transforms;
    int tx = xsize;
    unsigned seen = 0;
    if (level0) {
      while (br_.read(1)) {
        Transform t;
        t.type = (int)br_.read(2);
        if (seen & (1u << t.type)) return false;
        seen |= 1u << t.type;
        t.xsize = tx;
        t.ysize = ysize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = (int)br_.read(3) + 2;
          int sx = (tx + (1 << t.bits) - 1) >> t.bits;
          int sy = (ysize + (1 << t.bits) - 1) >> t.bits;
          if (!decode_stream(sx, sy, false, t.data)) return false;
        } else if (t.type == 3) {
          int num_colors = (int)br_.read(8) + 1;
          int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
          t.bits = bits;
          std::vector<uint32_t> pal;
          if (!decode_stream(num_colors, 1, false, pal)) return false;
          int final_n = 1 << (8 >> bits);
          t.data.assign(final_n, 0);
          uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
          const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
          for (int i = 0; i < 4; ++i) nd[i] = od[i];
          for (int i = 4; i < 4 * num_colors; ++i) nd[i] = (uint8_t)(od[i] + nd[i - 4]);
          tx = (tx + (1 << bits) - 1) >> bits;
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = (int)br_.read(4);
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    // meta prefix codes
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (level0 && br_.read(1)) {
      huff_bits = (int)br_.read(3) + 2;
      huff_xsize = (tx + (1 << huff_bits) - 1) >> huff_bits;
      int hy = (ysize + (1 << huff_bits) - 1) >> huff_bits;
      if (!decode_stream(huff_xsize, hy, false, huff_image)) return false;
      for (auto& v : huff_image) {
        v = (v >> 8) & 0xffff;
        if ((int)v + 1 > num_groups) num_groups = (int)v + 1;
      }
    }
    if (br_.overrun()) return false;
    std::vector<Group> groups(num_groups);
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    for (int g = 0; g < num_groups; ++g)
      for (int k = 0; k < 5; ++k)
        if (!read_huffman(alphabets[k], groups[g].h[k])) return false;

    // entropy-coded image
    std::vector<uint32_t> px((size_t)tx * ysize);
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int mask = huff_bits ? (1 << huff_bits) - 1 : -1;
    const size_t total = px.size();
    size_t i = 0, cached = 0;
    int col = 0, row = 0;
    const Group* grp = &groups[0];
    auto group_at = [&](int c, int r) -> const Group* {
      if (!huff_bits) return &groups[0];
      return &groups[huff_image[(size_t)(r >> huff_bits) * huff_xsize + (c >> huff_bits)]];
    };
    auto cache_insert = [&](uint32_t argb) {
      cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    while (i < total) {
      if ((col & mask) == 0) grp = group_at(col, row);
      int code = grp->h[0].read(br_);
      if (code < 0) return false;
      if (code < 256) {
        int red = grp->h[1].read(br_);
        int blue = grp->h[2].read(br_);
        int alpha = grp->h[3].read(br_);
        if (red < 0 || blue < 0 || alpha < 0) return false;
        px[i] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | (uint32_t)blue;
        ++i;
        ++col;
      } else if (code < 256 + 24) {
        int len_sym = code - 256;
        int length = copy_distance(len_sym);
        int dist_sym = grp->h[4].read(br_);
        if (dist_sym < 0) return false;
        int dist_code = copy_distance(dist_sym);
        size_t dist = plane_to_distance(tx, dist_code);
        if (dist > i || (size_t)length > total - i) return false;
        for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
        col += length;
        while (col >= tx) {
          col -= tx;
          ++row;
        }
        if (col & mask) grp = group_at(col, row);
      } else {
        if (!cache_size || code - 280 >= cache_size) return false;
        while (cached < i) cache_insert(px[cached++]);
        px[i] = cache[code - 280];
        ++i;
        ++col;
      }
      if (col >= tx) {
        col = 0;
        ++row;
      }
      if (cache_size)
        while (cached < i) cache_insert(px[cached++]);
      if (br_.overrun()) return false;
    }
    if (br_.overrun()) return false;

    // inverse transforms, last read first
    for (int k = (int)transforms.size() - 1; k >= 0; --k) {
      Transform& t = transforms[k];
      if (t.type == 3) {
        px = color_index_inverse(t, px);
      } else if (t.type == 2) {
        for (auto& v : px) {
          uint32_t g = (v >> 8) & 0xff;
          uint32_t r = (((v >> 16) & 0xff) + g) & 0xff;
          uint32_t b = ((v & 0xff) + g) & 0xff;
          v = (v & 0xff00ff00u) | (r << 16) | b;
        }
      } else if (t.type == 1) {
        cross_color_inverse(t, px);
      } else {
        predictor_inverse(t, px);
      }
    }
    out.swap(px);
    return true;
  }

 private:
  LBits& br_;

  int copy_distance(int sym) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + (int)br_.read(extra) + 1;
  }
  static size_t plane_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return (size_t)(plane_code - 120);
    int dc = kCodeToPlane[plane_code - 1];
    int yoff = dc >> 4, xoff = 8 - (dc & 0xf);
    long d = (long)yoff * xsize + xoff;
    return d >= 1 ? (size_t)d : 1;
  }

  static std::vector<uint32_t> color_index_inverse(const Transform& t, const std::vector<uint32_t>& src);
  static void cross_color_inverse(const Transform& t, std::vector<uint32_t>& px);
  static void predictor_inverse(const Transform& t, std::vector<uint32_t>& px);
};


inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(uint32_t a) { return a < 256 ? (int)a : (int)(~a >> 24); }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = clip255((uint32_t)(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) - ((c2 >> s) & 0xff)));
    out |= (uint32_t)v << s;
  }
  return out;
}
inline uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = avg2(c0, c1), out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= (uint32_t)clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

inline uint32_t predict(int mode, const uint32_t* out, size_t x, int width) {
  const uint32_t L = out[x - 1];
  const uint32_t* up = out + x - width;
  switch (mode) {
    case 1: return L;
    case 2: return up[0];
    case 3: return up[1];
    case 4: return up[-1];
    case 5: return avg2(avg2(L, up[1]), up[0]);
    case 6: return avg2(L, up[-1]);
    case 7: return avg2(L, up[0]);
    case 8: return avg2(up[-1], up[0]);
    case 9: return avg2(up[0], up[1]);
    case 10: return avg2(avg2(L, up[-1]), avg2(up[0], up[1]));
    case 11: return select_pred(up[0], L, up[-1]);
    case 12: return clamped_full(L, up[0], up[-1]);
    case 13: return clamped_half(L, up[0], up[-1]);
    default: return 0xff000000u;
  }
}

void VP8LDecoder::predictor_inverse(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  if (w <= 0 || h <= 0) return;
  uint32_t* p = px.data();
  p[0] = add_pixels(p[0], 0xff000000u);
  for (int x = 1; x < w; ++x) p[x] = add_pixels(p[x], p[x - 1]);
  const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
  for (int y = 1; y < h; ++y) {
    uint32_t* row = p + (size_t)y * w;
    row[0] = add_pixels(row[0], row[-w]);
    const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
    for (int x = 1; x < w; ++x) {
      int mode = (modes[x >> t.bits] >> 8) & 0xf;
      row[x] = add_pixels(row[x], predict(mode, row, x, w));
    }
  }
}

void VP8LDecoder::cross_color_inverse(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
  for (int y = 0; y < h; ++y) {
    uint32_t* row = px.data() + (size_t)y * w;
    const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
    for (int x = 0; x < w; ++x) {
      uint32_t code = codes[x >> t.bits];
      int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
             r2b = (int8_t)((code >> 16) & 0xff);
      uint32_t argb = row[x];
      int8_t green = (int8_t)(argb >> 8);
      int new_red = (argb >> 16) & 0xff;
      int new_blue = argb & 0xff;
      new_red += ((int)g2r * green) >> 5;
      new_red &= 0xff;
      new_blue += ((int)g2b * green) >> 5;
      new_blue += ((int)r2b * (int8_t)new_red) >> 5;
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
    }
  }
}

std::vector<uint32_t> VP8LDecoder::color_index_inverse(const Transform& t, const std::vector<uint32_t>& src) {
  const int w = t.xsize, h = t.ysize;
  std::vector<uint32_t> out((size_t)w * h);
  const int bits = t.bits;
  const int packed_w = (w + (1 << bits) - 1) >> bits;
  const uint32_t* map = t.data.data();
  if (bits == 0) {
    for (size_t i = 0; i < out.size(); ++i) out[i] = map[(src[i] >> 8) & 0xff];
    return out;
  }
  const int bpp = 8 >> bits, count_mask = (1 << bits) - 1, bit_mask = (1 << bpp) - 1;
  for (int y = 0; y < h; ++y) {
    const uint32_t* s = src.data() + (size_t)y * packed_w;
    uint32_t* d = out.data() + (size_t)y * w;
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & count_mask) == 0) packed = (*s++ >> 8) & 0xff;
      d[x] = map[packed & bit_mask];
      packed >>= bpp;
    }
  }
  return out;
}

// ------------------------------------------------------------- ALPH ----

void unfilter_rows(int filter, uint8_t* a, int w, int h) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = a + (size_t)y * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 1 || (prev == nullptr && filter != 0)) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) {
        row[x] = (uint8_t)(pred + row[x]);
        pred = row[x];
      }
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else if (filter == 3) {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        int g = left + top - top_left;
        int p = (g & ~0xff) == 0 ? g : (g < 0 ? 0 : 255);
        left = (uint8_t)(row[x] + p);
        top_left = top;
        row[x] = left;
      }
    }
  }
}

// ------------------------------------------------------------- VP8 -----

using namespace vp8;

// the boolean decoder, as libwebp's VP8BitReader (range kept as range-1),
// its end-of-data flag raised on the first read that needs a byte past the
// end
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  inline void load() {
    while (bits < 0) {
      if (buf < end) {
        bits += 8;
        value = (value << 8) | *buf++;
      } else if (!eof) {
        value <<= 8;
        bits += 8;
        eof = true;
      } else {
        bits = 0;
      }
    }
  }
  inline int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  inline int get_signed(int v) { return get_bit(0x80) ? -v : v; }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    int v = (int)get_value(n);
    return get_value(1) ? -v : v;
  }
};

struct MBInfo {
  uint8_t nz_y[4] = {0}, nz_u[2] = {0}, nz_v[2] = {0}, nz_dc = 0;
};

class VP8Decoder {
 public:
  int decode(const uint8_t* data, size_t n, uint8_t* out, int out_w, int out_h) {
    if (n < 10) return kTruncated;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t part_len = bits >> 5;
    if (!key || profile > 3 || !show) return kCorrupt;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kCorrupt;
    width_ = ((data[7] << 8) | data[6]) & 0x3fff;
    height_ = ((data[9] << 8) | data[8]) & 0x3fff;
    if (width_ != out_w || height_ != out_h || width_ == 0 || height_ == 0) return kCorrupt;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t size = n - 10;
    if (part_len > size) return kTruncated;
    br_.init(buf, part_len);
    buf += part_len;
    size -= part_len;
    br_.get_value(1);  // colour space
    br_.get_value(1);  // clamping type
    if (!parse_segment_header()) return kTruncated;
    if (!parse_filter_header()) return kTruncated;
    if (!parse_partitions(buf, size)) return kTruncated;
    parse_quant();
    br_.get_value(1);  // update_proba, ignored on key frames
    parse_proba();
    precompute_filter_strengths();
    return decode_frame(out);
  }

 private:
  BoolDec br_;
  BoolDec parts_[8];
  int num_parts_ = 1;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  int seg_proba_[3] = {255, 255, 255};
  // filter header
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;
  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  int use_skip_proba_ = 0, skip_p_ = 0;
  FInfo fstrengths_[4][2];

  bool parse_segment_header() {
    use_segment_ = br_.get_value(1);
    if (use_segment_) {
      update_map_ = br_.get_value(1);
      if (br_.get_value(1)) {
        absolute_delta_ = br_.get_value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get_value(1) ? br_.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.get_value(1) ? br_.get_signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) seg_proba_[s] = br_.get_value(1) ? (int)br_.get_value(8) : 255;
    } else {
      update_map_ = false;
    }
    return !br_.eof;
  }
  bool parse_filter_header() {
    simple_ = br_.get_value(1);
    level_ = br_.get_value(6);
    sharpness_ = br_.get_value(3);
    use_lf_delta_ = br_.get_value(1);
    if (use_lf_delta_ && br_.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.get_value(1)) ref_lf_delta_[i] = br_.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get_value(1)) mode_lf_delta_[i] = br_.get_signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    return !br_.eof;
  }
  bool parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* end = buf + size;
    num_parts_ = 1 << br_.get_value(2);
    const size_t last = num_parts_ - 1;
    if (size < 3 * last) return false;
    const uint8_t* start = buf + last * 3;
    size_t left = size - last * 3;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
      sz += 3;
    }
    parts_[last].init(start, left);
    return start < end;
  }
  void parse_quant() {
    const int base_q0 = br_.get_value(7);
    const int dqy1_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy2_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy2_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dquv_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dquv_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int delta[5] = {dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac};
    for (int i = 0; i < 4; ++i) {
      int q = base_q0;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      }
      dqm_[i] = quant_matrix(q, delta);
    }
  }
  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.get_bit(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br_.get_value(8)
                                                                             : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.get_value(1);
    if (use_skip_proba_) skip_p_ = br_.get_value(8);
  }
  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4) level += mode_lf_delta_[0];
        }
        fstrengths_[s][i4] = filter_info(level, sharpness_, i4);
      }
    }
  }

  // coefficient tokens of one 4x4 block (libwebp GetCoeffs); returns the
  // position after the last token read
  int get_coeffs(BoolDec& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.get_bit(p[0])) return n;
      while (!br.get_bit(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba_[type][kBands[n]][0];
      }
      int v;
      const int nb = kBands[n + 1];
      if (!br.get_bit(p[2])) {
        v = 1;
        p = proba_[type][nb][1];
      } else {
        if (!br.get_bit(p[3])) {
          if (!br.get_bit(p[4]))
            v = 2;
          else
            v = 3 + br.get_bit(p[5]);
        } else if (!br.get_bit(p[6])) {
          if (!br.get_bit(p[7])) {
            v = 5 + br.get_bit(159);
          } else {
            v = 7 + 2 * br.get_bit(165);
            v += br.get_bit(145);
          }
        } else {
          const int bit1 = br.get_bit(p[8]);
          const int bit0 = br.get_bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba_[type][nb][2];
      }
      out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  int decode_frame(uint8_t* out) {
    const int W = mb_w_ * 16, H = mb_h_ * 16;
    const int CW = mb_w_ * 8, CH = mb_h_ * 8;
    std::vector<uint8_t> Y((size_t)W * H), U((size_t)CW * CH), V((size_t)CW * CH);
    std::vector<uint8_t> intra_t(4 * mb_w_, B_DC);
    std::vector<MBInfo> top_nz(mb_w_);
    struct TopSamples {
      uint8_t y[16], u[8], v[8];
    };
    std::vector<TopSamples> yuv_t(mb_w_);
    std::vector<uint8_t> seg(mb_w_), skip(mb_w_), is_i4(mb_w_), uvmode(mb_w_);
    std::vector<uint8_t> imodes(16 * mb_w_);
    std::vector<FInfo> finfo((size_t)mb_w_ * mb_h_);
    constexpr int BPS = 32;
    uint8_t ybuf[BPS * 17 + 8], ubuf[BPS * 9 + 8], vbuf[BPS * 9 + 8];
    uint8_t* y_dst = ybuf + BPS + 8;
    uint8_t* u_dst = ubuf + BPS + 8;
    uint8_t* v_dst = vbuf + BPS + 8;
    int16_t coeffs[384];

    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      // intra modes of the row (first partition)
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        if (update_map_)
          seg[mb_x] = !br_.get_bit(seg_proba_[0]) ? br_.get_bit(seg_proba_[1])
                                                   : br_.get_bit(seg_proba_[2]) + 2;
        else
          seg[mb_x] = 0;
        skip[mb_x] = use_skip_proba_ ? br_.get_bit(skip_p_) : 0;
        uint8_t* top = &intra_t[4 * mb_x];
        is_i4[mb_x] = !br_.get_bit(145);
        uint8_t* modes = &imodes[16 * mb_x];
        if (!is_i4[mb_x]) {
          const int ymode = br_.get_bit(156) ? (br_.get_bit(128) ? B_TM : B_HE)
                                             : (br_.get_bit(163) ? B_VE : B_DC);
          modes[0] = (uint8_t)ymode;
          memset(top, ymode, 4);
          memset(intra_l, ymode, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* prob = kBModesProba[top[x]][ymode];
              int i = kYModesIntra4[br_.get_bit(prob[0])];
              while (i > 0) i = kYModesIntra4[2 * i + br_.get_bit(prob[i])];
              ymode = -i;
              top[x] = (uint8_t)ymode;
            }
            memcpy(modes + 4 * y, top, 4);
            intra_l[y] = (uint8_t)ymode;
          }
        }
        uvmode[mb_x] = !br_.get_bit(142) ? B_DC : !br_.get_bit(114) ? B_VE : br_.get_bit(183) ? B_TM : B_HE;
      }
      if (br_.eof) return kTruncated;

      BoolDec& tbr = parts_[mb_y & (num_parts_ - 1)];
      MBInfo left_nz;
      // reconstruction buffers: left column 129, top-left 129 below the
      // first row, the whole top row 127 on the first row
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        // residuals
        MBInfo& tnz = top_nz[mb_x];
        bool all_zero = true;
        // one bit per 4x4 block whose tokens carry coefficients (libwebp's
        // non-zero codes: more than one token, or a non-zero DC)
        uint32_t nz_blocks = 0;
        if (!skip[mb_x]) {
          memset(coeffs, 0, sizeof(coeffs));
          const QuantMatrix& q = dqm_[seg[mb_x]];
          int first, type;
          if (!is_i4[mb_x]) {
            int16_t dc[16] = {0};
            const int ctx = tnz.nz_dc + left_nz.nz_dc;
            const int nz = get_coeffs(tbr, 1, ctx, q.y2, 0, dc);
            tnz.nz_dc = left_nz.nz_dc = nz > 0;
            if (nz > 1) {
              transform_wht(dc, coeffs);
            } else {
              const int dc0 = (dc[0] + 3) >> 3;
              for (int i = 0; i < 256; i += 16) coeffs[i] = (int16_t)dc0;
            }
            first = 1;
            type = 0;
          } else {
            first = 0;
            type = 3;
          }
          for (int y = 0; y < 4; ++y) {
            int l = left_nz.nz_y[y];
            for (int x = 0; x < 4; ++x) {
              int16_t* dst = coeffs + 16 * (4 * y + x);
              const int ctx = l + tnz.nz_y[x];
              const int nz = get_coeffs(tbr, type, ctx, q.y1, first, dst);
              l = nz > first;
              tnz.nz_y[x] = (uint8_t)l;
              if (nz > 1 || dst[0] != 0) nz_blocks |= 1u << (4 * y + x);
            }
            left_nz.nz_y[y] = (uint8_t)l;
          }
          for (int ch = 0; ch < 2; ++ch) {
            uint8_t* tn = ch ? tnz.nz_v : tnz.nz_u;
            uint8_t* ln = ch ? left_nz.nz_v : left_nz.nz_u;
            for (int y = 0; y < 2; ++y) {
              int l = ln[y];
              for (int x = 0; x < 2; ++x) {
                int16_t* dst = coeffs + 256 + 64 * ch + 16 * (2 * y + x);
                const int ctx = l + tn[x];
                const int nz = get_coeffs(tbr, 2, ctx, q.uv, 0, dst);
                l = nz > 0;
                tn[x] = (uint8_t)l;
                if (nz > 1 || dst[0] != 0) nz_blocks |= 1u << (16 + 4 * ch + 2 * y + x);
              }
              ln[y] = (uint8_t)l;
            }
          }
          all_zero = nz_blocks == 0;
        } else {
          memset(tnz.nz_y, 0, 4);
          memset(tnz.nz_u, 0, 2);
          memset(tnz.nz_v, 0, 2);
          memset(left_nz.nz_y, 0, 4);
          memset(left_nz.nz_u, 0, 2);
          memset(left_nz.nz_v, 0, 2);
          if (!is_i4[mb_x]) tnz.nz_dc = left_nz.nz_dc = 0;
        }
        if (tbr.eof) return kTruncated;
        if (filter_type_ > 0) {
          FInfo f = fstrengths_[seg[mb_x]][is_i4[mb_x]];
          f.inner |= !(skip[mb_x] || all_zero);
          finfo[(size_t)mb_y * mb_w_ + mb_x] = f;
        }

        // reconstruction
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
          for (int j = -1; j < 8; ++j) {
            memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
            memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
          }
        }
        TopSamples* top = &yuv_t[mb_x];
        if (mb_y > 0) {
          memcpy(y_dst - BPS, top->y, 16);
          memcpy(u_dst - BPS, top->u, 8);
          memcpy(v_dst - BPS, top->v, 8);
        }
        const bool nonzero = !skip[mb_x];
        if (is_i4[mb_x]) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w_ - 1)
              memset(top_right, top->y[15], 4);
            else
              memcpy(top_right, yuv_t[mb_x + 1].y, 4);
          }
          for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
          const uint8_t* modes = &imodes[16 * mb_x];
          for (int n = 0; n < 16; ++n) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred4(modes[n], dst, BPS);
            if (nonzero && (nz_blocks >> n & 1)) transform_one(coeffs + 16 * n, dst, BPS);
          }
        } else {
          pred_block(imodes[16 * mb_x], y_dst, BPS, 16, mb_y > 0, mb_x > 0);
          if (nonzero)
            for (int n = 0; n < 16; ++n)
              if (nz_blocks >> n & 1)
                transform_one(coeffs + 16 * n, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
        }
        pred_block(uvmode[mb_x], u_dst, BPS, 8, mb_y > 0, mb_x > 0);
        pred_block(uvmode[mb_x], v_dst, BPS, 8, mb_y > 0, mb_x > 0);
        if (nonzero) {
          for (int n = 0; n < 4; ++n) {
            const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
            if (nz_blocks >> (16 + n) & 1) transform_one(coeffs + 256 + 16 * n, u_dst + off, BPS);
            if (nz_blocks >> (20 + n) & 1) transform_one(coeffs + 320 + 16 * n, v_dst + off, BPS);
          }
        }
        if (mb_y < mb_h_ - 1) {
          memcpy(top->y, y_dst + 15 * BPS, 16);
          memcpy(top->u, u_dst + 7 * BPS, 8);
          memcpy(top->v, v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          memcpy(&Y[(size_t)(mb_y * 16 + j) * W + mb_x * 16], y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          memcpy(&U[(size_t)(mb_y * 8 + j) * CW + mb_x * 8], u_dst + j * BPS, 8);
          memcpy(&V[(size_t)(mb_y * 8 + j) * CW + mb_x * 8], v_dst + j * BPS, 8);
        }
      }
    }

    // in-loop filter, macroblock by macroblock in raster order
    if (filter_type_ > 0)
      filter_rows(Y.data(), U.data(), V.data(), W, CW, finfo.data(), mb_w_, 0, mb_h_, filter_type_);
    // YUV 4:2:0 -> RGBA through the fancy upsampler (io_dec.c EmitFancyRGB)
    yuv420_to_rgba(Y.data(), U.data(), V.data(), W, CW, width_, height_, out);
    return kOk;
  }
};

}  // namespace

extern "C" {

// A VP8L bitstream (the chunk's payload, signature byte first) -> w*h ARGB
// words. Returns 0, or a negative Status.
int webp_vp8l_decode(const uint8_t* data, long n, uint32_t* out, int w, int h) {
  if (!data || !out || n < 5 || w <= 0 || h <= 0) return kBadArgs;
  if (data[0] != 0x2f) return kCorrupt;
  LBits br(data, (size_t)n);
  br.read(8);
  const int bw = (int)br.read(14) + 1, bh = (int)br.read(14) + 1;
  br.read(1);  // alpha hint
  if (br.read(3) != 0) return kCorrupt;
  if (bw != w || bh != h) return kCorrupt;
  std::vector<uint32_t> px;
  VP8LDecoder dec(br);
  if (!dec.decode_stream(w, h, true, px)) return br.overrun() ? kTruncated : kCorrupt;
  memcpy(out, px.data(), px.size() * 4);
  return kOk;
}

// An ALPH chunk's payload -> w*h alpha bytes (raw or lossless coding, then
// the unfilter of its header byte). Returns 0, or a negative Status.
int webp_alph_decode(const uint8_t* data, long n, uint8_t* out, int w, int h) {
  if (!data || !out || n < 1 || w <= 0 || h <= 0) return kBadArgs;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return kCorrupt;
  const size_t total = (size_t)w * h;
  if (method == 0) {
    if ((size_t)(n - 1) < total) return kTruncated;
    memcpy(out, data + 1, total);
  } else {
    LBits br(data + 1, (size_t)(n - 1));
    std::vector<uint32_t> px;
    VP8LDecoder dec(br);
    if (!dec.decode_stream(w, h, true, px)) return br.overrun() ? kTruncated : kCorrupt;
    for (size_t i = 0; i < total; ++i) out[i] = (uint8_t)(px[i] >> 8);
  }
  unfilter_rows(filter, out, w, h);
  return kOk;
}

// A VP8 key frame (the chunk's payload) -> w*h RGBA, alpha 255. Returns 0,
// or a negative Status.
int webp_vp8_decode(const uint8_t* data, long n, uint8_t* out, int w, int h) {
  if (!data || !out || n < 0 || w <= 0 || h <= 0) return kBadArgs;
  VP8Decoder dec;
  return dec.decode(data, (size_t)n, out, w, h);
}

}  // extern "C"
