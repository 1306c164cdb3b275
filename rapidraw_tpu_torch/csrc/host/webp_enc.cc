// Lossy WebP encoder for the export: RGB u8 -> a RIFF / WEBP / "VP8 " file
// (the simple format, as libwebp writes it for PIL) holding one VP8 key
// frame (RFC 6386).
//
//   * colour: RGB to YUV 4:2:0 with libwebp's BT.601 limited-range 16-bit
//     fixed-point formulas, chroma from 2x2 sums; partial macroblocks and
//     odd sizes are padded by repeating the last row and column;
//   * prediction: every macroblock tries the four 16x16 luma modes, the
//     ten 4x4 modes per sub-block and the four chroma modes, each chosen by
//     256 x distortion (SSE) + lambda x rate, the rate being the mode's bits
//     and the coefficient tokens' cost under the coding probabilities
//     (1/256-bit units), lambda proportional to the square of the AC
//     quantizer step; 4x4 wins over 16x16 only when its summed score is
//     lower;
//   * transforms: the forward DCT and WHT of libvpx / libwebp, dead-zone
//     quantisation with libwebp's rounding biases; the reconstruction uses
//     the decoder's inverse transforms and predictors from vp8_common.h,
//     so it is what any VP8 decoder computes;
//   * one segment, the quantizer index given by the caller (io/webp.py maps
//     the quality to it), chroma DC delta -2 as libwebp writes it and
//     chroma AC delta -4;
//   * tokens: coefficient probabilities taken from the frame's own token
//     counts and sent where they pay for their update (libwebp's
//     FinalizeTokenProbas rule), the skip flag with its own probability;
//   * loop filter: the normal filter, sharpness 0, its level the one of
//     least squared error against the source on a sample of macroblock
//     rows (a grid of step 8 over 0..63, then halving steps around the
//     best);
//   * partition 0 kept under its 19-bit size: on large frames a per-macro-
//     block budget of 4x4 mode bits, halved and the frame encoded again if
//     the partition still does not fit.
//
// Integer arithmetic throughout, so the bytes do not depend on the host or
// the compiler. Macroblocks are coded on a wavefront (each row two
// macroblocks behind the one above) over up to `threads` threads; the
// decisions of a macroblock read only its left, top and top-right
// neighbours, so the bytes do not depend on the thread count either.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "vp8_common.h"

namespace {

using namespace vp8;

// failures, as libwebp's WebPEncodingError numbers them (negated)
enum Status { kOk = 0, kOutOfMemory = -1, kBadArgs = -3, kTooLarge = -5, kPartitionOverflow = -6 };

constexpr int kMaxDimension = 16383;
constexpr int kMaxLevel = 2047;
constexpr int kMaxVariableLevel = 67;  // from here on only cat-6 extra bits vary
constexpr uint32_t kPartition0Limit = (1u << 19) - 1;
constexpr int BPS = 32;

// chroma quantizer deltas: DC as libwebp writes it, AC finer by 4 steps
constexpr int kUvDcDelta = -2, kUvAcDelta = -4;
// lambdas, x q^2 / 64 with q the luma (chroma) AC step, in distortion per
// bit: 16x16 and 4x4 modes, the 16x16-or-4x4 choice, chroma modes
constexpr int kLambdaI16 = 2, kLambdaI4 = 2, kLambdaMode = 1, kLambdaUV = 1;
// the loop-filter search filters every 4th macroblock row of frames of 32
// rows or more
constexpr int kFilterSampleStep = 4;

// cost in 1/256 bit of a symbol of probability i/256 (i = 1..256), rounded
// -256 * log2(i / 256); i = 0 never occurs on a coded path
const uint16_t kBitCost[257] = {
    4096, 2048, 1792, 1642, 1536, 1454, 1386, 1329, 1280, 1236, 1198, 1162, 1130, 1101, 1073, 1048,
    1024, 1002, 980, 961, 942, 924, 906, 890, 874, 859, 845, 831, 817, 804, 792, 780,
    768, 757, 746, 735, 724, 714, 705, 695, 686, 676, 668, 659, 650, 642, 634, 626,
    618, 611, 603, 596, 589, 582, 575, 568, 562, 555, 549, 543, 537, 531, 525, 519,
    512, 507, 501, 496, 490, 485, 480, 474, 469, 464, 459, 455, 450, 445, 440, 436,
    431, 427, 422, 418, 414, 410, 405, 401, 397, 393, 389, 385, 381, 377, 374, 370,
    366, 362, 359, 355, 352, 348, 345, 341, 338, 334, 331, 328, 324, 321, 318, 315,
    312, 308, 305, 302, 299, 296, 293, 290, 287, 284, 281, 278, 275, 273, 270, 267,
    256, 253, 251, 248, 245, 243, 240, 237, 235, 232, 230, 227, 225, 222, 220, 217,
    215, 212, 210, 208, 205, 203, 201, 198, 196, 194, 191, 189, 187, 185, 182, 180,
    178, 176, 174, 172, 169, 167, 165, 163, 161, 159, 157, 155, 153, 151, 149, 147,
    145, 143, 141, 139, 137, 135, 133, 131, 129, 127, 126, 124, 122, 120, 118, 116,
    115, 113, 111, 109, 108, 106, 104, 102, 101, 99, 97, 96, 94, 92, 91, 89,
    87, 86, 84, 83, 81, 79, 78, 76, 75, 73, 72, 70, 69, 67, 66, 64,
    63, 61, 60, 58, 57, 55, 54, 52, 51, 50, 48, 47, 45, 44, 43, 41,
    40, 39, 37, 36, 35, 33, 32, 31, 29, 28, 27, 25, 24, 23, 22, 20,
    0,
};

// cost of coding `bit` with probability `prob` (of a zero) out of 256
inline int bit_cost(int bit, int prob) { return kBitCost[bit ? 256 - prob : prob]; }

// ---- the boolean encoder (RFC 6386 section 7.3)
struct BoolEnc {
  std::vector<uint8_t> out;
  uint32_t range = 255, bottom = 0;
  int bit_count = 24;

  void add_one() {
    size_t i = out.size();
    while (i > 0 && out[i - 1] == 255) out[--i] = 0;
    if (i > 0) ++out[i - 1];
  }
  void put(int bit, int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (bit) {
      bottom += split;
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & (1u << 31)) add_one();
      bottom <<= 1;
      if (!--bit_count) {
        out.push_back((uint8_t)(bottom >> 24));
        bottom &= (1u << 24) - 1;
        bit_count = 8;
      }
    }
  }
  void literal(uint32_t v, int n) {
    while (n-- > 0) put((v >> n) & 1, 128);
  }
  // a flag, then magnitude and sign when the value is not zero (the
  // header's optional signed fields)
  void optional_signed(int v, int n) {
    put(v != 0, 128);
    if (v) {
      literal((uint32_t)std::abs(v), n);
      put(v < 0, 128);
    }
  }
  void flush() {
    int c = bit_count;
    uint32_t v = bottom;
    if (v & (1u << (32 - c))) add_one();
    v <<= c & 7;
    c >>= 3;
    while (--c >= 0) v <<= 8;
    for (c = 0; c < 4; ++c) {
      out.push_back((uint8_t)(v >> 24));
      v <<= 8;
    }
  }
};

// counts of the zeros and ones coded with each coefficient probability
struct TokenStats {
  uint32_t n[4][8][3][11][2];
  void clear() { memset(n, 0, sizeof(n)); }
};

// a sink for the token coder: writes bits, or counts the ones that use an
// adaptive probability
struct StatSink {
  TokenStats* st;
  inline void token(int bit, int t, int b, int c, int p) { ++st->n[t][b][c][p][bit]; }
  inline void fixed(int, int) {}
};
struct WriteSink {
  BoolEnc* bw;
  const uint8_t (*proba)[8][3][11];
  inline void token(int bit, int t, int b, int c, int p) { bw->put(bit, proba[t][b][c][p]); }
  inline void fixed(int bit, int prob) { bw->put(bit, prob); }
};

// the tokens of one block (libwebp's PutCoeffs); levels in zigzag order,
// `last` the position of the last non-zero one or -1; returns whether any
// level is non-zero
template <class Sink>
int put_coeffs(Sink& s, int t, int ctx, int first, const int16_t* lv, int last) {
  int n = first;
  int b = kBands[n], c = ctx;
  s.token(last >= 0, t, b, c, 0);
  if (last < 0) return 0;
  while (n < 16) {
    const int v0 = lv[n++];
    const int sign = v0 < 0;
    int v = sign ? -v0 : v0;
    s.token(v != 0, t, b, c, 1);
    if (!v) {
      b = kBands[n];
      c = 0;
      continue;
    }
    s.token(v > 1, t, b, c, 2);
    if (v == 1) {
      c = 1;
    } else {
      s.token(v > 4, t, b, c, 3);
      if (v <= 4) {
        s.token(v != 2, t, b, c, 4);
        if (v != 2) s.token(v == 4, t, b, c, 5);
      } else {
        s.token(v > 10, t, b, c, 6);
        if (v <= 10) {
          s.token(v > 6, t, b, c, 7);
          if (v <= 6) {
            s.fixed(v == 6, 159);
          } else {
            s.fixed(v >= 9, 165);
            s.fixed(!(v & 1), 145);
          }
        } else {
          int mask;
          const uint8_t* tab;
          if (v < 3 + (8 << 1)) {
            s.token(0, t, b, c, 8);
            s.token(0, t, b, c, 9);
            v -= 3 + (8 << 0);
            mask = 1 << 2;
            tab = kCat3;
          } else if (v < 3 + (8 << 2)) {
            s.token(0, t, b, c, 8);
            s.token(1, t, b, c, 9);
            v -= 3 + (8 << 1);
            mask = 1 << 3;
            tab = kCat4;
          } else if (v < 3 + (8 << 3)) {
            s.token(1, t, b, c, 8);
            s.token(0, t, b, c, 10);
            v -= 3 + (8 << 2);
            mask = 1 << 4;
            tab = kCat5;
          } else {
            s.token(1, t, b, c, 8);
            s.token(1, t, b, c, 10);
            v -= 3 + (8 << 3);
            mask = 1 << 10;
            tab = kCat6;
          }
          for (; mask; mask >>= 1) s.fixed(!!(v & mask), *tab++);
        }
      }
      c = 2;
    }
    s.fixed(sign, 128);
    b = kBands[n];
    if (n == 16) return 1;
    s.token(n <= last, t, b, c, 0);
    if (n > last) return 1;
  }
  return 1;
}

// ---- rate tables
struct Costs {
  // level_cost[t][b][c][v]: the tokens of level v (0..67) at a position of
  // band b whose previous token left context c, the "not end of block"
  // bit included when c > 0, the sign and category extra bits included
  uint32_t level[4][8][3][kMaxVariableLevel + 1];
  uint16_t eob[4][8][3];       // "end of block" at band b, context c
  uint16_t not_eob[4][8][3];   // "not end of block"
  uint16_t cat6_extra[kMaxLevel - kMaxVariableLevel + 1];
  uint16_t mode_i4[10][10][10];  // [top][left][mode]
  uint16_t mode_i16[4], mode_uv[4], flag_i4;

  void build(const uint8_t proba[4][8][3][11]) {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c) {
          const uint8_t* p = proba[t][b][c];
          eob[t][b][c] = (uint16_t)bit_cost(0, p[0]);
          not_eob[t][b][c] = (uint16_t)bit_cost(1, p[0]);
          const int c0 = c > 0 ? bit_cost(1, p[0]) : 0;
          level[t][b][c][0] = (uint32_t)(c0 + bit_cost(0, p[1]));
          for (int v = 1; v <= kMaxVariableLevel; ++v)
            level[t][b][c][v] = (uint32_t)(c0 + bit_cost(1, p[1]) + 256 + nonzero_cost(v, p));
        }
    // the extra bits of category 6 past its first value; the category's own
    // bits sit in level[..][67]
    for (int v = kMaxVariableLevel; v <= kMaxLevel; ++v) {
      int cost = 0;
      const int e = v - (3 + (8 << 3));
      const uint8_t* tab = kCat6;
      for (int mask = 1 << 10; mask; mask >>= 1) cost += bit_cost(!!(e & mask), *tab++);
      cat6_extra[v - kMaxVariableLevel] = (uint16_t)cost;
    }
    const int base67 = cat6_extra[0];
    for (int v = kMaxVariableLevel; v <= kMaxLevel; ++v) cat6_extra[v - kMaxVariableLevel] -= base67;
    flag_i4 = (uint16_t)bit_cost(0, 145);
    const int i16 = bit_cost(1, 145);
    mode_i16[B_DC] = (uint16_t)(i16 + bit_cost(0, 156) + bit_cost(0, 163));
    mode_i16[B_VE] = (uint16_t)(i16 + bit_cost(0, 156) + bit_cost(1, 163));
    mode_i16[B_HE] = (uint16_t)(i16 + bit_cost(1, 156) + bit_cost(0, 128));
    mode_i16[B_TM] = (uint16_t)(i16 + bit_cost(1, 156) + bit_cost(1, 128));
    mode_uv[B_DC] = (uint16_t)bit_cost(0, 142);
    mode_uv[B_VE] = (uint16_t)(bit_cost(1, 142) + bit_cost(0, 114));
    mode_uv[B_TM] = (uint16_t)(bit_cost(1, 142) + bit_cost(1, 114) + bit_cost(1, 183));
    mode_uv[B_HE] = (uint16_t)(bit_cost(1, 142) + bit_cost(1, 114) + bit_cost(0, 183));
    for (int top = 0; top < 10; ++top)
      for (int left = 0; left < 10; ++left)
        for (int m = 0; m < 10; ++m) {
          int cost = 0;
          int node = 0, bit;
          const uint8_t* prob = kBModesProba[top][left];
          // walk kYModesIntra4 from the root to the leaf -m
          while (true) {
            int pick = -1;
            for (bit = 0; bit < 2; ++bit)
              if (subtree_has(2 * node + bit, m)) pick = bit;
            cost += bit_cost(pick, prob[node]);
            const int next = kYModesIntra4[2 * node + pick];
            if (next <= 0) break;
            node = next;
          }
          mode_i4[top][left][m] = (uint16_t)cost;
        }
  }

  static bool subtree_has(int slot, int mode) {
    const int v = kYModesIntra4[slot];
    if (v <= 0) return -v == mode;
    return subtree_has(2 * v, mode) || subtree_has(2 * v + 1, mode);
  }

  // the tree bits of a non-zero level (after the "zero" bit), without sign
  static int nonzero_cost(int v, const uint8_t* p) {
    if (v == 1) return bit_cost(0, p[2]);
    int cost = bit_cost(1, p[2]);
    if (v <= 4) {
      cost += bit_cost(0, p[3]);
      if (v == 2) return cost + bit_cost(0, p[4]);
      return cost + bit_cost(1, p[4]) + bit_cost(v == 4, p[5]);
    }
    cost += bit_cost(1, p[3]);
    if (v <= 10) {
      cost += bit_cost(0, p[6]);
      if (v <= 6) return cost + bit_cost(0, p[7]) + bit_cost(v == 6, 159);
      return cost + bit_cost(1, p[7]) + bit_cost(v >= 9, 165) + bit_cost(!(v & 1), 145);
    }
    cost += bit_cost(1, p[6]);
    int mask, e;
    const uint8_t* tab;
    if (v < 3 + (8 << 1)) {
      cost += bit_cost(0, p[8]) + bit_cost(0, p[9]);
      e = v - (3 + (8 << 0));
      mask = 1 << 2;
      tab = kCat3;
    } else if (v < 3 + (8 << 2)) {
      cost += bit_cost(0, p[8]) + bit_cost(1, p[9]);
      e = v - (3 + (8 << 1));
      mask = 1 << 3;
      tab = kCat4;
    } else if (v < 3 + (8 << 3)) {
      cost += bit_cost(1, p[8]) + bit_cost(0, p[10]);
      e = v - (3 + (8 << 2));
      mask = 1 << 4;
      tab = kCat5;
    } else {
      cost += bit_cost(1, p[8]) + bit_cost(1, p[10]);
      e = v - (3 + (8 << 3));
      mask = 1 << 10;
      tab = kCat6;
    }
    for (; mask; mask >>= 1) cost += bit_cost(!!(e & mask), *tab++);
    return cost;
  }

  // the rate of one block's tokens (libwebp's GetResidualCost)
  int block(int t, int ctx, int first, const int16_t* lv, int last) const {
    if (last < 0) return eob[t][kBands[first]][ctx];
    int cost = ctx == 0 ? not_eob[t][kBands[first]][0] : 0;
    int c = ctx;
    for (int n = first; n <= last; ++n) {
      const int v = std::abs(lv[n]);
      const uint32_t* tab = level[t][kBands[n]][c];
      if (v <= kMaxVariableLevel)
        cost += tab[v];
      else
        cost += tab[kMaxVariableLevel] + cat6_extra[v - kMaxVariableLevel];
      c = v >= 2 ? 2 : v;
    }
    if (last < 15) cost += eob[t][kBands[last + 1]][c];
    return cost;
  }
};

// ---- forward transforms
// libvpx's vp8_short_fdct4x4_c on src - ref (strides ss, rs)
inline void fdct4(const uint8_t* src, int ss, const uint8_t* ref, int rs, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += ss, ref += rs) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2], d3 = src[3] - ref[3];
    const int a1 = (d0 + d3) * 8, b1 = (d1 + d2) * 8;
    const int c1 = (d1 - d2) * 8, e1 = (d0 - d3) * 8;
    tmp[4 * i + 0] = a1 + b1;
    tmp[4 * i + 2] = a1 - b1;
    tmp[4 * i + 1] = (c1 * 2217 + e1 * 5352 + 14500) >> 12;
    tmp[4 * i + 3] = (e1 * 2217 - c1 * 5352 + 7500) >> 12;
  }
  for (int i = 0; i < 4; ++i) {
    const int a1 = tmp[i] + tmp[12 + i], b1 = tmp[4 + i] + tmp[8 + i];
    const int c1 = tmp[4 + i] - tmp[8 + i], d1 = tmp[i] - tmp[12 + i];
    out[i] = (int16_t)((a1 + b1 + 7) >> 4);
    out[8 + i] = (int16_t)((a1 - b1 + 7) >> 4);
    out[4 + i] = (int16_t)(((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0));
    out[12 + i] = (int16_t)((d1 * 2217 - c1 * 5352 + 51000) >> 16);
  }
}

// the forward WHT of the 16 luma DCs (dc[4 * row + col]), libwebp's
// FTransformWHT: the decoder's transform_wht inverts it up to rounding
inline void fwht(const int* dc, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int* in = dc + 4 * i;
    const int a0 = in[0] + in[2], a1 = in[1] + in[3];
    const int a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[4 * i + 0] = a0 + a1;
    tmp[4 * i + 1] = a3 + a2;
    tmp[4 * i + 2] = a3 - a2;
    tmp[4 * i + 3] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[i] - tmp[8 + i];
    out[i] = (int16_t)((a0 + a1) >> 1);
    out[4 + i] = (int16_t)((a3 + a2) >> 1);
    out[8 + i] = (int16_t)((a3 - a2) >> 1);
    out[12 + i] = (int16_t)((a0 - a1) >> 1);
  }
}

// ---- quantisation: dead zone with libwebp's rounding biases (QFIX 17)
struct QSide {
  int q[2], iq[2], bias[2], zthresh[2];
  void init(const int steps[2], int bias_dc, int bias_ac) {
    const int b[2] = {bias_dc, bias_ac};
    for (int i = 0; i < 2; ++i) {
      q[i] = steps[i];
      iq[i] = (1 << 17) / q[i];
      bias[i] = b[i] << 9;
      zthresh[i] = ((1 << 17) - 1 - bias[i]) / iq[i];
    }
  }
};

// coefficients in natural order -> levels in zigzag order and the
// dequantised coefficients in natural order; positions before `first`
// are left out; returns the zigzag position of the last non-zero level, -1
inline int quantize(const int16_t* in, int16_t* lv, int16_t* deq, const QSide& m, int first) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n];
    if (n < first) {
      lv[n] = 0;
      deq[j] = 0;
      continue;
    }
    const int i = n > 0;
    const int c = in[j];
    const uint32_t a = (uint32_t)(c < 0 ? -c : c);
    if ((int)a > m.zthresh[i]) {
      int level = (int)((a * (uint32_t)m.iq[i] + (uint32_t)m.bias[i]) >> 17);
      if (level > kMaxLevel) level = kMaxLevel;
      if (c < 0) level = -level;
      lv[n] = (int16_t)level;
      deq[j] = (int16_t)(level * m.q[i]);
      if (level) last = n;
    } else {
      lv[n] = 0;
      deq[j] = 0;
    }
  }
  return last;
}

inline int64_t sse(const uint8_t* a, int as, const uint8_t* b, int bs, int w, int h) {
  int64_t s = 0;
  for (int y = 0; y < h; ++y, a += as, b += bs) {
    int row = 0;  // at most 16383 * 255^2 < 2^31
    for (int x = 0; x < w; ++x) {
      const int d = a[x] - b[x];
      row += d * d;
    }
    s += row;
  }
  return s;
}

inline bool all_zero(const int16_t* v, int n) {
  for (int i = 0; i < n; ++i)
    if (v[i]) return false;
  return true;
}

// ---- per-macroblock results
struct NZ {
  uint8_t y[4], u[2], v[2], dc;
};

struct MB {
  uint8_t is_i4, ymode, uvmode, skip;
  uint8_t imodes[16];
  int8_t last[25];      // 0-15 luma, 16-19 U, 20-23 V, 24 Y2
  int16_t lv[25][16];   // zigzag levels
  NZ nz_bottom, nz_right;            // the contexts this macroblock hands on
  uint8_t modes_bottom[4], modes_right[4];
};

struct Params {
  int qindex;
  int lambda_i16, lambda_i4, lambda_uv, lambda_mode;
  int i4_header_cap;  // 1/256 bits of 4x4 modes a macroblock may spend
};

class Encoder {
 public:
  int w_ = 0, h_ = 0, mb_w_ = 0, mb_h_ = 0, W_ = 0, H_ = 0, CW_ = 0, CH_ = 0;
  std::vector<uint8_t> sy_, su_, sv_;  // source planes, padded
  std::vector<uint8_t> ry_, ru_, rv_;  // reconstruction, before the loop filter
  std::vector<MB> mbs_;
  Params prm_{};
  QSide qy1_{}, qy2_{}, quv_{};
  Costs costs_{};
  int filter_level_ = 0;
  int threads_ = 1;

  void import(const uint8_t* rgb, int w, int h, long stride) {
    w_ = w;
    h_ = h;
    mb_w_ = (w + 15) >> 4;
    mb_h_ = (h + 15) >> 4;
    W_ = mb_w_ * 16;
    H_ = mb_h_ * 16;
    CW_ = mb_w_ * 8;
    CH_ = mb_h_ * 8;
    sy_.assign((size_t)W_ * H_, 0);
    su_.assign((size_t)CW_ * CH_, 0);
    sv_.assign((size_t)CW_ * CH_, 0);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = rgb + (size_t)y * stride;
      uint8_t* dy = &sy_[(size_t)y * W_];
      for (int x = 0; x < w; ++x) {
        const int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
        dy[x] = (uint8_t)((16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16);
      }
      for (int x = w; x < W_; ++x) dy[x] = dy[w - 1];
    }
    for (int y = h; y < H_; ++y) memcpy(&sy_[(size_t)y * W_], &sy_[(size_t)(h - 1) * W_], W_);
    const int cw = (w + 1) >> 1, ch = (h + 1) >> 1;
    for (int cy = 0; cy < ch; ++cy) {
      const uint8_t* r0 = rgb + (size_t)(2 * cy) * stride;
      const uint8_t* r1 = rgb + (size_t)std::min(2 * cy + 1, h - 1) * stride;
      uint8_t* du = &su_[(size_t)cy * CW_];
      uint8_t* dv = &sv_[(size_t)cy * CW_];
      for (int cx = 0; cx < cw; ++cx) {
        const int x0 = 3 * (2 * cx), x1 = 3 * std::min(2 * cx + 1, w - 1);
        const int r = r0[x0] + r0[x1] + r1[x0] + r1[x1];
        const int g = r0[x0 + 1] + r0[x1 + 1] + r1[x0 + 1] + r1[x1 + 1];
        const int b = r0[x0 + 2] + r0[x1 + 2] + r1[x0 + 2] + r1[x1 + 2];
        du[cx] = clip_uv(-9719 * r - 19081 * g + 28800 * b);
        dv[cx] = clip_uv(28800 * r - 24116 * g - 4684 * b);
      }
      for (int cx = cw; cx < CW_; ++cx) {
        du[cx] = du[cw - 1];
        dv[cx] = dv[cw - 1];
      }
    }
    for (int cy = ch; cy < CH_; ++cy) {
      memcpy(&su_[(size_t)cy * CW_], &su_[(size_t)(ch - 1) * CW_], CW_);
      memcpy(&sv_[(size_t)cy * CW_], &sv_[(size_t)(ch - 1) * CW_], CW_);
    }
  }

  static uint8_t clip_uv(int v) {
    v = (v + (1 << 17) + (128 << 18)) >> 18;
    return (uint8_t)((v & ~0xff) == 0 ? v : v < 0 ? 0 : 255);
  }

  void setup(const Params& p) {
    prm_ = p;
    const int delta[5] = {0, 0, 0, kUvDcDelta, kUvAcDelta};
    const QuantMatrix qm = quant_matrix(p.qindex, delta);
    qy1_.init(qm.y1, 96, 110);
    qy2_.init(qm.y2, 96, 108);
    quv_.init(qm.uv, 110, 115);
    costs_.build(kCoeffsProba0);
  }

  // ---- one macroblock: choose its modes and levels, write its
  // reconstruction into ry_/ru_/rv_
  void encode_mb(int mb_x, int mb_y) {
    MB& mb = mbs_[(size_t)mb_y * mb_w_ + mb_x];
    const bool has_top = mb_y > 0, has_left = mb_x > 0;
    uint8_t ybuf[BPS * 17 + 8], ubuf[BPS * 9 + 8], vbuf[BPS * 9 + 8];
    uint8_t* yd = ybuf + BPS + 8;
    uint8_t* ud = ubuf + BPS + 8;
    uint8_t* vd = vbuf + BPS + 8;
    load_borders(mb_x, mb_y, yd, ud, vd);
    const uint8_t* sy = &sy_[(size_t)mb_y * 16 * W_ + mb_x * 16];
    const uint8_t* su = &su_[(size_t)mb_y * 8 * CW_ + mb_x * 8];
    const uint8_t* sv = &sv_[(size_t)mb_y * 8 * CW_ + mb_x * 8];

    static const NZ kZeroNZ = {{0, 0, 0, 0}, {0, 0}, {0, 0}, 0};
    const NZ& tnz = has_top ? mbs_[(size_t)(mb_y - 1) * mb_w_ + mb_x].nz_bottom : kZeroNZ;
    const NZ& lnz = has_left ? mbs_[(size_t)mb_y * mb_w_ + mb_x - 1].nz_right : kZeroNZ;
    static const uint8_t kDcModes[4] = {B_DC, B_DC, B_DC, B_DC};
    const uint8_t* tmodes = has_top ? mbs_[(size_t)(mb_y - 1) * mb_w_ + mb_x].modes_bottom : kDcModes;
    const uint8_t* lmodes = has_left ? mbs_[(size_t)mb_y * mb_w_ + mb_x - 1].modes_right : kDcModes;

    // -- 16x16 luma
    int16_t lv16[17][16], best_lv16[17][16];
    int last16[17], best_last16[17];
    uint8_t rec[256], best_rec16[256], pred[256];
    int64_t best16 = -1;
    int64_t best_D16 = 0;
    int best_mode16 = 0, best_R16 = 0;
    for (int mode = 0; mode < 4; ++mode) {
      pred_block(mode, yd, BPS, 16, has_top, has_left);
      for (int j = 0; j < 16; ++j) memcpy(pred + 16 * j, yd + j * BPS, 16);
      int16_t coef[16][16], deq[16][16];
      int dc[16];
      for (int n = 0; n < 16; ++n) {
        const int off = (n & 3) * 4 + (n >> 2) * 64;
        fdct4(sy + (n & 3) * 4 + (n >> 2) * 4 * W_, W_, pred + off, 16, coef[n]);
        dc[n] = coef[n][0];
      }
      int16_t y2[16], y2deq[16];
      fwht(dc, y2);
      last16[16] = quantize(y2, lv16[16], y2deq, qy2_, 0);
      for (int n = 0; n < 16; ++n) last16[n] = quantize(coef[n], lv16[n], deq[n], qy1_, 1);
      transform_wht(y2deq, &deq[0][0]);
      memcpy(rec, pred, 256);
      for (int n = 0; n < 16; ++n)
        if (!all_zero(deq[n], 16)) transform_one(deq[n], rec + (n & 3) * 4 + (n >> 2) * 64, 16);
      const int64_t D = sse(sy, W_, rec, 16, 16, 16);
      int R = costs_.mode_i16[mode];
      R += costs_.block(1, tnz.dc + lnz.dc, 0, lv16[16], last16[16]);
      uint8_t tn[4], ln[4];
      memcpy(tn, tnz.y, 4);
      memcpy(ln, lnz.y, 4);
      for (int n = 0; n < 16; ++n) {
        const int x = n & 3, y = n >> 2;
        R += costs_.block(0, tn[x] + ln[y], 1, lv16[n], last16[n]);
        tn[x] = ln[y] = last16[n] >= 0;
      }
      const int64_t score = 256 * D + (int64_t)R * prm_.lambda_i16;
      if (best16 < 0 || score < best16) {
        best16 = score;
        best_mode16 = mode;
        best_D16 = D;
        best_R16 = R;
        memcpy(best_rec16, rec, 256);
        memcpy(best_lv16, lv16, sizeof(lv16));
        memcpy(best_last16, last16, sizeof(last16));
      }
    }
    // the 16x16 choice rescored at the mode-decision lambda
    const int64_t score16 = 256 * best_D16 + (int64_t)best_R16 * prm_.lambda_mode;

    // -- 4x4 luma, abandoned as soon as its running score reaches the 16x16
    bool use_i4 = true;
    int16_t lv4[16][16];
    int last4[16];
    uint8_t modes4[16];
    {
      // the top-right samples of the sub-blocks on the right edge
      uint8_t* top_right = yd - BPS + 16;
      for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
      int64_t total = (int64_t)costs_.flag_i4 * prm_.lambda_mode;
      int header = costs_.flag_i4;
      uint8_t tn[4], ln[4];
      memcpy(tn, tnz.y, 4);
      memcpy(ln, lnz.y, 4);
      for (int n = 0; n < 16 && use_i4; ++n) {
        const int x = n & 3, y = n >> 2;
        uint8_t* dst = yd + 4 * x + 4 * y * BPS;
        const uint8_t* src = sy + 4 * x + 4 * y * W_;
        const int top = y ? modes4[n - 4] : tmodes[x];
        const int left = x ? modes4[n - 1] : lmodes[y];
        const uint16_t* mcost = costs_.mode_i4[top][left];
        const int ctx = tn[x] + ln[y];
        int64_t best = -1, best_D = 0;
        int best_R = 0, best_mode = 0;
        uint8_t best_rec[16];
        for (int mode = 0; mode < 10; ++mode) {
          pred4(mode, dst, BPS);
          uint8_t p4[16], r4[16];
          for (int j = 0; j < 4; ++j) memcpy(p4 + 4 * j, dst + j * BPS, 4);
          int16_t coef[16], deq[16], lv[16];
          fdct4(src, W_, p4, 4, coef);
          const int last = quantize(coef, lv, deq, qy1_, 0);
          memcpy(r4, p4, 16);
          if (last >= 0) transform_one(deq, r4, 4);
          const int64_t D = sse(src, W_, r4, 4, 4, 4);
          const int H = mcost[mode];
          const int64_t partial = 256 * D + (int64_t)H * prm_.lambda_i4;
          if (best >= 0 && partial >= best) continue;
          const int R = H + costs_.block(3, ctx, 0, lv, last);
          const int64_t score = 256 * D + (int64_t)R * prm_.lambda_i4;
          if (best < 0 || score < best) {
            best = score;
            best_D = D;
            best_R = R;
            best_mode = mode;
            memcpy(best_rec, r4, 16);
            memcpy(lv4[n], lv, sizeof(lv));
            last4[n] = last;
          }
        }
        for (int j = 0; j < 4; ++j) memcpy(dst + j * BPS, best_rec + 4 * j, 4);
        modes4[n] = (uint8_t)best_mode;
        tn[x] = ln[y] = last4[n] >= 0;
        total += 256 * best_D + (int64_t)best_R * prm_.lambda_mode;
        header += mcost[best_mode];
        if (total >= score16 || header > prm_.i4_header_cap) use_i4 = false;
      }
    }
    if (use_i4) {
      mb.is_i4 = 1;
      memcpy(mb.imodes, modes4, 16);
      for (int n = 0; n < 16; ++n) {
        memcpy(mb.lv[n], lv4[n], sizeof(lv4[n]));
        mb.last[n] = (int8_t)last4[n];
      }
      mb.last[24] = -1;
    } else {
      mb.is_i4 = 0;
      mb.ymode = (uint8_t)best_mode16;
      for (int j = 0; j < 16; ++j) memcpy(yd + j * BPS, best_rec16 + 16 * j, 16);
      for (int n = 0; n < 16; ++n) {
        memcpy(mb.lv[n], best_lv16[n], sizeof(best_lv16[n]));
        mb.last[n] = (int8_t)best_last16[n];
      }
      memcpy(mb.lv[24], best_lv16[16], sizeof(best_lv16[16]));
      mb.last[24] = (int8_t)best_last16[16];
      memset(mb.imodes, best_mode16, 16);
    }

    // -- chroma
    {
      int64_t best = -1;
      uint8_t best_u[64], best_v[64];
      int16_t lvc[8][16];
      int lastc[8];
      for (int mode = 0; mode < 4; ++mode) {
        pred_block(mode, ud, BPS, 8, has_top, has_left);
        pred_block(mode, vd, BPS, 8, has_top, has_left);
        uint8_t ru[64], rv[64];
        for (int j = 0; j < 8; ++j) {
          memcpy(ru + 8 * j, ud + j * BPS, 8);
          memcpy(rv + 8 * j, vd + j * BPS, 8);
        }
        int16_t lv[8][16];
        int last[8];
        for (int n = 0; n < 8; ++n) {
          uint8_t* r = (n < 4 ? ru : rv) + (n & 1) * 4 + ((n >> 1) & 1) * 32;
          const uint8_t* s = (n < 4 ? su : sv) + (n & 1) * 4 + ((n >> 1) & 1) * 4 * CW_;
          int16_t coef[16], deq[16];
          fdct4(s, CW_, r, 8, coef);
          last[n] = quantize(coef, lv[n], deq, quv_, 0);
          if (last[n] >= 0) transform_one(deq, r, 8);
        }
        const int64_t D = sse(su, CW_, ru, 8, 8, 8) + sse(sv, CW_, rv, 8, 8, 8);
        int R = costs_.mode_uv[mode];
        for (int ch = 0; ch < 2; ++ch) {
          uint8_t tn[2], ln[2];
          memcpy(tn, ch ? tnz.v : tnz.u, 2);
          memcpy(ln, ch ? lnz.v : lnz.u, 2);
          for (int k = 0; k < 4; ++k) {
            const int x = k & 1, y = k >> 1, n = 4 * ch + k;
            R += costs_.block(2, tn[x] + ln[y], 0, lv[n], last[n]);
            tn[x] = ln[y] = last[n] >= 0;
          }
        }
        const int64_t score = 256 * D + (int64_t)R * prm_.lambda_uv;
        if (best < 0 || score < best) {
          best = score;
          mb.uvmode = (uint8_t)mode;
          memcpy(best_u, ru, 64);
          memcpy(best_v, rv, 64);
          memcpy(lvc, lv, sizeof(lv));
          memcpy(lastc, last, sizeof(last));
        }
      }
      for (int n = 0; n < 8; ++n) {
        memcpy(mb.lv[16 + n], lvc[n], sizeof(lvc[n]));
        mb.last[16 + n] = (int8_t)lastc[n];
      }
      for (int j = 0; j < 8; ++j) {
        memcpy(&ru_[(size_t)(mb_y * 8 + j) * CW_ + mb_x * 8], best_u + 8 * j, 8);
        memcpy(&rv_[(size_t)(mb_y * 8 + j) * CW_ + mb_x * 8], best_v + 8 * j, 8);
      }
    }
    for (int j = 0; j < 16; ++j) memcpy(&ry_[(size_t)(mb_y * 16 + j) * W_ + mb_x * 16], yd + j * BPS, 16);

    // -- what the macroblock hands on
    bool any = false;
    for (int n = 0; n < 25; ++n) any |= mb.last[n] >= 0;
    mb.skip = !any;
    NZ out_b = tnz, out_r = lnz;
    for (int n = 0; n < 16; ++n) {
      const int x = n & 3, y = n >> 2;
      out_b.y[x] = out_r.y[y] = mb.last[n] >= 0;
    }
    for (int ch = 0; ch < 2; ++ch)
      for (int k = 0; k < 4; ++k) {
        const int x = k & 1, y = k >> 1, nz = mb.last[16 + 4 * ch + k] >= 0;
        (ch ? out_b.v : out_b.u)[x] = (uint8_t)nz;
        (ch ? out_r.v : out_r.u)[y] = (uint8_t)nz;
      }
    if (!mb.is_i4) out_b.dc = out_r.dc = mb.last[24] >= 0;
    mb.nz_bottom = out_b;
    mb.nz_right = out_r;
    for (int k = 0; k < 4; ++k) {
      mb.modes_bottom[k] = mb.imodes[12 + k];
      mb.modes_right[k] = mb.imodes[4 * k + 3];
    }
  }

  // the work buffers' borders, as the decoder fills them: 127 above the
  // first row, 129 left of the first column, the reconstruction elsewhere
  void load_borders(int mb_x, int mb_y, uint8_t* yd, uint8_t* ud, uint8_t* vd) const {
    for (int j = 0; j < 16; ++j)
      yd[j * BPS - 1] = mb_x > 0 ? ry_[(size_t)(mb_y * 16 + j) * W_ + mb_x * 16 - 1] : 129;
    for (int j = 0; j < 8; ++j) {
      ud[j * BPS - 1] = mb_x > 0 ? ru_[(size_t)(mb_y * 8 + j) * CW_ + mb_x * 8 - 1] : 129;
      vd[j * BPS - 1] = mb_x > 0 ? rv_[(size_t)(mb_y * 8 + j) * CW_ + mb_x * 8 - 1] : 129;
    }
    if (mb_y == 0) {
      memset(yd - BPS - 1, 127, 16 + 4 + 1);
      memset(ud - BPS - 1, 127, 8 + 1);
      memset(vd - BPS - 1, 127, 8 + 1);
      return;
    }
    const uint8_t* ya = &ry_[(size_t)(mb_y * 16 - 1) * W_ + mb_x * 16];
    const uint8_t* ua = &ru_[(size_t)(mb_y * 8 - 1) * CW_ + mb_x * 8];
    const uint8_t* va = &rv_[(size_t)(mb_y * 8 - 1) * CW_ + mb_x * 8];
    memcpy(yd - BPS, ya, 16);
    memcpy(ud - BPS, ua, 8);
    memcpy(vd - BPS, va, 8);
    yd[-BPS - 1] = mb_x > 0 ? ya[-1] : 129;
    ud[-BPS - 1] = mb_x > 0 ? ua[-1] : 129;
    vd[-BPS - 1] = mb_x > 0 ? va[-1] : 129;
    if (mb_x < mb_w_ - 1)
      memcpy(yd - BPS + 16, ya + 16, 4);
    else
      memset(yd - BPS + 16, ya[15], 4);
  }

  // every macroblock, on a wavefront over `threads` threads
  void encode_all(int threads) {
    threads_ = std::max(1, threads);
    mbs_.assign((size_t)mb_w_ * mb_h_, MB{});
    ry_.assign((size_t)W_ * H_, 0);
    ru_.assign((size_t)CW_ * CH_, 0);
    rv_.assign((size_t)CW_ * CH_, 0);
    threads = std::max(1, std::min(threads, mb_h_));
    if (threads == 1) {
      for (int y = 0; y < mb_h_; ++y)
        for (int x = 0; x < mb_w_; ++x) encode_mb(x, y);
      return;
    }
    std::vector<std::atomic<int>> done(mb_h_);
    for (auto& d : done) d.store(0);
    auto work = [&](int t) {
      for (int y = t; y < mb_h_; y += threads) {
        for (int x = 0; x < mb_w_; ++x) {
          if (y > 0) {
            const int need = std::min(x + 2, mb_w_);
            while (done[y - 1].load(std::memory_order_acquire) < need) std::this_thread::yield();
          }
          encode_mb(x, y);
          done[y].store(x + 1, std::memory_order_release);
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < threads; ++t) pool.emplace_back(work, t);
    work(0);
    for (auto& th : pool) th.join();
  }

  // ---- loop filter
  FInfo mb_filter(const MB& mb, int level) const { return filter_info(level, 0, mb.is_i4 || !mb.skip); }

  // squared error against the source after filtering every `step`-th
  // macroblock row (with the 3 rows above it that its top edge changes) at
  // `level`; the rows are filtered in copies, each on its own, spread over
  // the encoder's threads (integer sums: the total does not depend on them)
  int64_t filter_error(int level, int step) const {
    std::vector<int> rows;
    for (int mb_y = step > 1 ? 1 : 0; mb_y < mb_h_; mb_y += step) rows.push_back(mb_y);
    const int n_threads = std::max(1, std::min<int>(threads_, (int)rows.size()));
    std::vector<int64_t> err(n_threads, 0);
    auto work = [&](int t) {
      std::vector<uint8_t> ty((size_t)32 * W_), tu((size_t)16 * CW_), tv((size_t)16 * CW_);
      std::vector<FInfo> fi((size_t)2 * mb_w_);
      for (size_t i = t; i < rows.size(); i += n_threads) {
        const int mb_y = rows[i];
        const int top = mb_y > 0 ? 1 : 0;
        // macroblock rows mb_y - top .. mb_y into the copies
        memcpy(ty.data(), &ry_[(size_t)(mb_y - top) * 16 * W_], (size_t)(16 + 16 * top) * W_);
        memcpy(tu.data(), &ru_[(size_t)(mb_y - top) * 8 * CW_], (size_t)(8 + 8 * top) * CW_);
        memcpy(tv.data(), &rv_[(size_t)(mb_y - top) * 8 * CW_], (size_t)(8 + 8 * top) * CW_);
        for (int x = 0; x < mb_w_; ++x)
          fi[(size_t)top * mb_w_ + x] = mb_filter(mbs_[(size_t)mb_y * mb_w_ + x], level);
        filter_rows(ty.data(), tu.data(), tv.data(), W_, CW_, fi.data(), mb_w_, top, top + 1, 2);
        // the rows the edge filters reach: 3 above the macroblock row
        const int ly0 = top ? 13 : 0, cy0 = top ? 5 : 0;
        const size_t sy0 = (size_t)(mb_y * 16 - (top ? 3 : 0));
        const size_t sc0 = (size_t)(mb_y * 8 - (top ? 3 : 0));
        const int ny = 16 + (top ? 3 : 0), nc = 8 + (top ? 3 : 0);
        err[t] += sse(&sy_[sy0 * W_], W_, &ty[(size_t)ly0 * W_], W_, W_, ny);
        err[t] += sse(&su_[sc0 * CW_], CW_, &tu[(size_t)cy0 * CW_], CW_, CW_, nc);
        err[t] += sse(&sv_[sc0 * CW_], CW_, &tv[(size_t)cy0 * CW_], CW_, CW_, nc);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(work, t);
    work(0);
    for (auto& th : pool) th.join();
    int64_t total = 0;
    for (int64_t e : err) total += e;
    return total;
  }

  // the level of least error: a grid of step 8 over 0..63, then halving
  // steps around the best
  void choose_filter_level() {
    const int step = mb_h_ >= 32 ? kFilterSampleStep : 1;
    std::vector<int64_t> err(64, -1);
    auto eval = [&](int level) {
      level = std::max(0, std::min(63, level));
      if (err[level] < 0) err[level] = filter_error(level, step);
      return err[level];
    };
    int best = 0;
    for (int level = 0; level <= 64; level += 8) {
      const int l = std::min(level, 63);
      if (eval(l) < eval(best)) best = l;
    }
    for (int d = 4; d >= 1; d >>= 1) {
      const int c = best;
      for (int l : {c - d, c + d}) {
        if (l < 0 || l > 63) continue;
        if (eval(l) < eval(best) || (eval(l) == eval(best) && l < best)) best = l;
      }
    }
    filter_level_ = best;
  }

  // the loop-filtered reconstruction as RGBA, as a decoder outputs it
  void reconstruction(uint8_t* rgba) const {
    std::vector<uint8_t> y = ry_, u = ru_, v = rv_;
    if (filter_level_ > 0) {
      std::vector<FInfo> fi(mbs_.size());
      for (size_t i = 0; i < mbs_.size(); ++i) fi[i] = mb_filter(mbs_[i], filter_level_);
      filter_rows(y.data(), u.data(), v.data(), W_, CW_, fi.data(), mb_w_, 0, mb_h_, 2);
    }
    yuv420_to_rgba(y.data(), u.data(), v.data(), W_, CW_, w_, h_, rgba);
  }

  // ---- the bitstream
  // the tokens of macroblock rows [y0, y1); the contexts above row y0 are
  // the ones its top neighbours handed on (what a decoder holds there)
  template <class Sink>
  void put_tokens(Sink& s, bool use_skip, int y0, int y1) const {
    std::vector<NZ> top(mb_w_);
    for (int x = 0; x < mb_w_; ++x)
      if (y0 > 0)
        top[x] = mbs_[(size_t)(y0 - 1) * mb_w_ + x].nz_bottom;
      else
        memset(&top[x], 0, sizeof(NZ));
    for (int mb_y = y0; mb_y < y1; ++mb_y) {
      NZ left;
      memset(&left, 0, sizeof(left));
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MB& mb = mbs_[(size_t)mb_y * mb_w_ + mb_x];
        NZ& t = top[mb_x];
        if (use_skip && mb.skip) {
          memset(t.y, 0, 4);
          memset(t.u, 0, 2);
          memset(t.v, 0, 2);
          memset(left.y, 0, 4);
          memset(left.u, 0, 2);
          memset(left.v, 0, 2);
          if (!mb.is_i4) t.dc = left.dc = 0;
          continue;
        }
        int first = 0, type = 3;
        if (!mb.is_i4) {
          t.dc = left.dc = (uint8_t)put_coeffs(s, 1, t.dc + left.dc, 0, mb.lv[24], mb.last[24]);
          first = 1;
          type = 0;
        }
        for (int n = 0; n < 16; ++n) {
          const int x = n & 3, y = n >> 2;
          t.y[x] = left.y[y] = (uint8_t)put_coeffs(s, type, t.y[x] + left.y[y], first, mb.lv[n], mb.last[n]);
        }
        for (int ch = 0; ch < 2; ++ch) {
          uint8_t* tn = ch ? t.v : t.u;
          uint8_t* ln = ch ? left.v : left.u;
          for (int k = 0; k < 4; ++k) {
            const int x = k & 1, y = k >> 1, n = 16 + 4 * ch + k;
            tn[x] = ln[y] = (uint8_t)put_coeffs(s, 2, tn[x] + ln[y], 0, mb.lv[n], mb.last[n]);
          }
        }
      }
    }
  }

  // the coefficient probabilities worth sending (libwebp's
  // FinalizeTokenProbas rule)
  void token_probas(const TokenStats& st, uint8_t proba[4][8][3][11], bool update[4][8][3][11]) const {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const uint64_t n0 = st.n[t][b][c][p][0], n1 = st.n[t][b][c][p][1];
            const uint64_t total = n0 + n1;
            const int old_p = kCoeffsProba0[t][b][c][p];
            const int new_p = n1 ? (int)(255 - n1 * 255 / total) : 255;
            const int up = kCoeffsUpdateProba[t][b][c][p];
            const uint64_t old_cost = n1 * bit_cost(1, old_p) + n0 * bit_cost(0, old_p) + bit_cost(0, up);
            const uint64_t new_cost =
                n1 * bit_cost(1, new_p) + n0 * bit_cost(0, new_p) + bit_cost(1, up) + 8 * 256;
            update[t][b][c][p] = old_cost > new_cost;
            proba[t][b][c][p] = (uint8_t)(update[t][b][c][p] ? new_p : old_p);
          }
  }

  std::vector<uint8_t> bitstream(bool& overflow) const {
    // skip flag: used when some macroblock has no coefficients
    int n_skip = 0;
    for (const MB& mb : mbs_) n_skip += mb.skip;
    const int total = (int)mbs_.size();
    const bool use_skip = n_skip > 0;
    const int skip_p = use_skip ? (total - n_skip) * 255 / total : 0;

    // the token counts, in bands of rows over the threads
    const int n_threads = std::max(1, std::min(threads_, mb_h_));
    std::vector<TokenStats> parts(n_threads);
    auto count = [&](int t) {
      parts[t].clear();
      StatSink ss{&parts[t]};
      put_tokens(ss, use_skip, mb_h_ * t / n_threads, mb_h_ * (t + 1) / n_threads);
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(count, t);
    count(0);
    for (auto& th : pool) th.join();
    TokenStats& st = parts[0];
    for (int t = 1; t < n_threads; ++t)
      for (size_t i = 0; i < sizeof(st.n) / sizeof(uint32_t); ++i)
        (&st.n[0][0][0][0][0])[i] += (&parts[t].n[0][0][0][0][0])[i];
    uint8_t proba[4][8][3][11];
    bool update[4][8][3][11];
    token_probas(st, proba, update);

    BoolEnc p0;
    p0.literal(0, 1);  // colour space
    p0.literal(0, 1);  // clamping type
    p0.literal(0, 1);  // no segmentation
    p0.literal(0, 1);  // normal loop filter
    p0.literal((uint32_t)filter_level_, 6);
    p0.literal(0, 3);  // sharpness
    p0.literal(0, 1);  // no loop-filter deltas
    p0.literal(0, 2);  // one token partition
    p0.literal((uint32_t)prm_.qindex, 7);
    p0.optional_signed(0, 4);  // y1 DC
    p0.optional_signed(0, 4);  // y2 DC
    p0.optional_signed(0, 4);  // y2 AC
    p0.optional_signed(kUvDcDelta, 4);
    p0.optional_signed(kUvAcDelta, 4);
    p0.literal(0, 1);  // refresh_entropy_probs
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            p0.put(update[t][b][c][p], kCoeffsUpdateProba[t][b][c][p]);
            if (update[t][b][c][p]) p0.literal(proba[t][b][c][p], 8);
          }
    p0.literal(use_skip, 1);
    if (use_skip) p0.literal((uint32_t)skip_p, 8);
    std::vector<uint8_t> tmodes(4 * mb_w_, B_DC);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t lmodes[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MB& mb = mbs_[(size_t)mb_y * mb_w_ + mb_x];
        uint8_t* top = &tmodes[4 * mb_x];
        if (use_skip) p0.put(mb.skip, skip_p);
        p0.put(!mb.is_i4, 145);
        if (!mb.is_i4) {
          const int m = mb.ymode;
          if (m == B_TM || m == B_HE) {
            p0.put(1, 156);
            p0.put(m == B_TM, 128);
          } else {
            p0.put(0, 156);
            p0.put(m == B_VE, 163);
          }
          memset(top, m, 4);
          memset(lmodes, m, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int left = lmodes[y];
            for (int x = 0; x < 4; ++x) {
              const int m = mb.imodes[4 * y + x];
              put_i4_mode(p0, kBModesProba[top[x]][left], m);
              left = m;
              top[x] = (uint8_t)m;
            }
            lmodes[y] = (uint8_t)left;
          }
        }
        const int uv = mb.uvmode;
        p0.put(uv != B_DC, 142);
        if (uv != B_DC) {
          p0.put(uv != B_VE, 114);
          if (uv != B_VE) p0.put(uv == B_TM, 183);
        }
      }
    }
    p0.flush();

    BoolEnc p1;
    WriteSink ws{&p1, proba};
    put_tokens(ws, use_skip, 0, mb_h_);
    p1.flush();

    overflow = p0.out.size() > kPartition0Limit;
    std::vector<uint8_t> vp8;
    const uint32_t size0 = (uint32_t)p0.out.size();
    const uint32_t tag = 0 | (0 << 1) | (1 << 4) | (size0 << 5);  // key frame, profile 0, shown
    vp8.push_back((uint8_t)tag);
    vp8.push_back((uint8_t)(tag >> 8));
    vp8.push_back((uint8_t)(tag >> 16));
    vp8.push_back(0x9d);
    vp8.push_back(0x01);
    vp8.push_back(0x2a);
    vp8.push_back((uint8_t)w_);
    vp8.push_back((uint8_t)(w_ >> 8));  // scale 0
    vp8.push_back((uint8_t)h_);
    vp8.push_back((uint8_t)(h_ >> 8));
    vp8.insert(vp8.end(), p0.out.begin(), p0.out.end());
    vp8.insert(vp8.end(), p1.out.begin(), p1.out.end());
    return vp8;
  }

  static void put_i4_mode(BoolEnc& bw, const uint8_t* prob, int mode) {
    int node = 0;
    while (true) {
      const int bit = Costs::subtree_has(2 * node + 1, mode) ? 1 : 0;
      bw.put(bit, prob[node]);
      const int next = kYModesIntra4[2 * node + bit];
      if (next <= 0) return;
      node = next;
    }
  }
};

void put_le32(std::vector<uint8_t>& v, uint32_t x) {
  for (int i = 0; i < 4; ++i) v.push_back((uint8_t)(x >> (8 * i)));
}

}  // namespace

extern "C" {

// RGB u8 (h rows of `stride` bytes, 3 bytes a pixel) -> a WebP file in a
// buffer from malloc (*out, freed with webp_enc_free), its size returned;
// with `recon` not null (w * h * 4 bytes), the frame a decoder
// reconstructs from it as RGBA. qindex is the VP8 quantizer index
// (0..127); `threads` the most threads the wavefront may use. Returns a
// negative Status on failure: kTooLarge past 16383 pixels on a side,
// kPartitionOverflow when even 16x16 modes alone overflow partition 0.
long webp_encode(const uint8_t* rgb, int w, int h, long stride, int qindex, int threads,
                 uint8_t** out, uint8_t* recon) {
  if (!rgb || !out || w <= 0 || h <= 0 || qindex < 0 || qindex > 127) return kBadArgs;
  if (w > kMaxDimension || h > kMaxDimension) return kTooLarge;
  Encoder enc;
  enc.import(rgb, w, h, stride);
  Params p{};
  p.qindex = qindex;
  const int delta[5] = {0, 0, 0, kUvDcDelta, kUvAcDelta};
  const QuantMatrix m = quant_matrix(qindex, delta);
  const int64_t q = m.y1[1], quv = m.uv[1];
  p.lambda_i16 = (int)std::max<int64_t>(1, (q * q * kLambdaI16) >> 6);
  p.lambda_i4 = (int)std::max<int64_t>(1, (q * q * kLambdaI4) >> 6);
  p.lambda_mode = (int)std::max<int64_t>(1, (q * q * kLambdaMode) >> 6);
  p.lambda_uv = (int)std::max<int64_t>(1, (quv * quv * kLambdaUV) >> 6);
  const int64_t n_mb = (int64_t)((w + 15) >> 4) * ((h + 15) >> 4);
  // partition 0's budget per macroblock, less what the skip flag, the
  // 16x16/4x4 flag and the chroma mode may take; a macroblock may spend
  // twice its share on 4x4 modes, as most take 16x16 (halved again if the
  // partition overflows)
  const int64_t budget = ((int64_t)(kPartition0Limit - 8192) * 8 * 256) / n_mb - 8 * 256;
  p.i4_header_cap = (int)std::max<int64_t>(0, std::min<int64_t>(2 * budget, 1 << 30));
  std::vector<uint8_t> vp8;
  for (;;) {
    enc.setup(p);
    enc.encode_all(threads);
    enc.choose_filter_level();
    bool overflow = false;
    vp8 = enc.bitstream(overflow);
    if (!overflow) break;
    if (p.i4_header_cap == 0) return kPartitionOverflow;
    p.i4_header_cap /= 2;
  }
  std::vector<uint8_t> file;
  file.insert(file.end(), {'R', 'I', 'F', 'F'});
  const uint32_t chunk = (uint32_t)vp8.size();
  const uint32_t padded = chunk + (chunk & 1);
  put_le32(file, 4 + 8 + padded);
  file.insert(file.end(), {'W', 'E', 'B', 'P', 'V', 'P', '8', ' '});
  put_le32(file, chunk);
  file.insert(file.end(), vp8.begin(), vp8.end());
  if (chunk & 1) file.push_back(0);
  *out = (uint8_t*)malloc(file.size());
  if (!*out) return kOutOfMemory;
  memcpy(*out, file.data(), file.size());
  if (recon) enc.reconstruction(recon);
  return (long)file.size();
}

void webp_enc_free(uint8_t* p) { free(p); }

}  // extern "C"
