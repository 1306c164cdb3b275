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
// The tables are RFC 6386's (coefficient probabilities and their update
// probabilities, the 4x4 mode probabilities in libwebp's mode order, the
// quantizer steps) and RFC 9649's distance map. Any bitstream error, and
// any read past the end of a partition or stream, fails the decode: libwebp
// returns no partial frame either.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

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

static const uint8_t kCoeffsProba0[4][8][3][11] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[10][10][9] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's mode numbers: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

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

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBInfo {
  uint8_t nz_y[4] = {0}, nz_u[2] = {0}, nz_v[2] = {0}, nz_dc = 0;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

void transform_one(const int16_t* in, uint8_t* dst, int stride) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]);
    const int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
    const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += stride;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

// 4x4 luma prediction at dst (stride s): dst[-s..] is the row above (8
// samples, the last 4 the top-right), dst[-1] the column to the left
void pred4(int mode, uint8_t* dst, int s) {
#define DST(x, y) dst[(x) + (y) * s]
  const uint8_t* top = dst - s;
  const int X = dst[-1 - s];
  const int I = dst[-1], J = dst[-1 + s], K = dst[-1 + 2 * s], L = dst[-1 + 3 * s];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * s];
      dc >>= 3;
      for (int y = 0; y < 4; ++y) memset(dst + y * s, dc, 4);
      break;
    }
    case B_TM:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip8(top[x] + dst[-1 + y * s] - X);
      break;
    case B_VE: {
      uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int y = 0; y < 4; ++y) memcpy(dst + y * s, v, 4);
      break;
    }
    case B_HE: {
      uint8_t v[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L), AVG3(K, L, L)};
      for (int y = 0; y < 4; ++y) memset(dst + y * s, v[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
  }
#undef DST
}

// 16x16 (n = 16) or 8x8 chroma (n = 8) prediction; mode DC with the
// frame-edge variants chosen by the macroblock's position
void pred_block(int mode, uint8_t* dst, int s, int n, bool has_top, bool has_left) {
  const uint8_t* top = dst - s;
  if (mode == B_DC) {
    int shift = n == 16 ? 4 : 3;
    int dc;
    if (has_top && has_left) {
      dc = n;
      for (int i = 0; i < n; ++i) dc += top[i] + dst[-1 + i * s];
      dc >>= shift + 1;
    } else if (has_left) {
      dc = n / 2;
      for (int i = 0; i < n; ++i) dc += dst[-1 + i * s];
      dc >>= shift;
    } else if (has_top) {
      dc = n / 2;
      for (int i = 0; i < n; ++i) dc += top[i];
      dc >>= shift;
    } else {
      dc = 0x80;
    }
    for (int y = 0; y < n; ++y) memset(dst + y * s, dc, n);
  } else if (mode == B_TM) {
    const int X = top[-1];
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) dst[x + y * s] = clip8(top[x] + dst[-1 + y * s] - X);
  } else if (mode == B_VE) {
    for (int y = 0; y < n; ++y) memcpy(dst + y * s, top, n);
  } else {  // B_HE
    for (int y = 0; y < n; ++y) memset(dst + y * s, dst[-1 + y * s], n);
  }
}

// ---- loop filters (libwebp dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline uint8_t uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = uclip(p0 + a2);
  p[0] = uclip(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = uclip(p1 + a3);
  p[-step] = uclip(p0 + a2);
  p[0] = uclip(q0 - a1);
  p[step] = uclip(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = uclip(p2 + a3);
  p[-2 * step] = uclip(p1 + a2);
  p[-step] = uclip(p0 + a1);
  p[0] = uclip(q0 - a1);
  p[step] = uclip(q1 - a2);
  p[2 * step] = uclip(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > t || std::abs(q1 - q0) > t;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      do_filter2(p, hstride);
    else if (edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

// ---- YUV -> RGB (libwebp yuv.h, 14-bit fixed point)
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline int yuv_clip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgba(int y, int u, int v, uint8_t* d) {
  d[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  d[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  d[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's fancy upsampler for one pair of output rows (UPSAMPLE_FUNC),
// per chroma channel
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bot_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bot_y) yuv_to_rgba(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + (2 * x) * 4);
    if (bot_y) {
      yuv_to_rgba(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bot_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bot_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bot_dst + (2 * x) * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                top_dst + (len - 1) * 4);
    if (bot_y)
      yuv_to_rgba(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                  bot_dst + (len - 1) * 4);
  }
}

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
    static const uint8_t kDc[128] = {
        4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,
        20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,
        35,  36,  37,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,
        52,  53,  54,  55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,
        71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,
        89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124,
        126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
    static const uint16_t kAc[128] = {
        4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,
        23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
        42,  43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,
        64,  66,  68,  70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100,
        102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149,
        152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217,
        221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    const int base_q0 = br_.get_value(7);
    const int dqy1_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy2_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy2_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dquv_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dquv_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else {
        if (i > 0) {
          dqm_[i] = dqm_[0];
          continue;
        }
        q = base_q0;
      }
      QuantMatrix& m = dqm_[i];
      m.y1[0] = kDc[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAc[clip(q, 127)];
      m.y2[0] = kDc[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAc[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDc[clip(q + dquv_dc, 117)];
      m.uv[1] = kAc[clip(q + dquv_ac, 127)];
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
        FInfo& f = fstrengths_[s][i4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * level + ilevel;
          f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
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
    if (filter_type_ > 0) {
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
          const FInfo& f = finfo[(size_t)mb_y * mb_w_ + mb_x];
          const int limit = f.limit;
          if (limit == 0) continue;
          uint8_t* yd = &Y[(size_t)mb_y * 16 * W + mb_x * 16];
          if (filter_type_ == 1) {
            if (mb_x > 0) simple_filter(yd, 1, W, 16, limit + 4);
            if (f.inner)
              for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, W, 16, limit);
            if (mb_y > 0) simple_filter(yd, W, 1, 16, limit + 4);
            if (f.inner)
              for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * W, W, 1, 16, limit);
          } else {
            uint8_t* ud = &U[(size_t)mb_y * 8 * CW + mb_x * 8];
            uint8_t* vd = &V[(size_t)mb_y * 8 * CW + mb_x * 8];
            const int il = f.ilevel, hv = f.hev;
            if (mb_x > 0) {
              filter_loop(yd, 1, W, 16, limit + 4, il, hv, true);
              filter_loop(ud, 1, CW, 8, limit + 4, il, hv, true);
              filter_loop(vd, 1, CW, 8, limit + 4, il, hv, true);
            }
            if (f.inner) {
              for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k, 1, W, 16, limit, il, hv, false);
              filter_loop(ud + 4, 1, CW, 8, limit, il, hv, false);
              filter_loop(vd + 4, 1, CW, 8, limit, il, hv, false);
            }
            if (mb_y > 0) {
              filter_loop(yd, W, 1, 16, limit + 4, il, hv, true);
              filter_loop(ud, CW, 1, 8, limit + 4, il, hv, true);
              filter_loop(vd, CW, 1, 8, limit + 4, il, hv, true);
            }
            if (f.inner) {
              for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k * W, W, 1, 16, limit, il, hv, false);
              filter_loop(ud + 4 * CW, CW, 1, 8, limit, il, hv, false);
              filter_loop(vd + 4 * CW, CW, 1, 8, limit, il, hv, false);
            }
          }
        }
      }
    }

    // YUV 4:2:0 -> RGBA through the fancy upsampler (io_dec.c EmitFancyRGB)
    const int w = width_, h = height_;
    const size_t stride = (size_t)w * 4;
    upsample_pair(&Y[0], nullptr, &U[0], &V[0], &U[0], &V[0], out, nullptr, w);
    for (int y = 1; y + 1 < h; y += 2) {
      const int cy = (y + 1) >> 1;
      upsample_pair(&Y[(size_t)y * W], &Y[(size_t)(y + 1) * W], &U[(size_t)(cy - 1) * CW],
                    &V[(size_t)(cy - 1) * CW], &U[(size_t)cy * CW], &V[(size_t)cy * CW],
                    out + y * stride, out + (y + 1) * stride, w);
    }
    if (h > 1 && !(h & 1)) {
      const int cy = (h - 1) >> 1;
      upsample_pair(&Y[(size_t)(h - 1) * W], nullptr, &U[(size_t)cy * CW], &V[(size_t)cy * CW],
                    &U[(size_t)cy * CW], &V[(size_t)cy * CW], out + (h - 1) * stride, nullptr, w);
    }
    for (size_t i = 0; i < (size_t)w * h; ++i) out[4 * i + 3] = 255;
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
