// Block-compressed (BCn) texture decoder for DDS files: the pixels PIL
// 12.1's "bcn" decoder gives.
//
//   * BC1 (DXT1): 5:6:5 endpoints widened by bit replication, the 4-colour
//     mode's thirds and the 3-colour mode's half in integer division, and
//     the 3-colour mode's transparent black; BC2 and BC3 colour blocks
//     always take the 4-colour mode;
//   * BC2 explicit 4-bit alpha (x 0x11), BC3 / BC4 / BC5 interpolated
//     8-bit channels (7 or 5 steps, the 5-step mode's 0 and 255), BC5's
//     signed form shifted by 128; BC5's blue is 0, or 128 when signed;
//   * BC6H (UF16 and SF16): the 14 modes' endpoint bit layouts, sign
//     extension, the delta transform (its sums masked to the endpoint
//     precision and, as in PIL, not sign-extended again), unquantisation,
//     interpolation (no rounding term) with
//     the BC7 weights, the x31/64 (x31/32 signed) finish to half float, and
//     the half's clamp to [0, 1] times 255, truncated; reserved modes give
//     black;
//   * BC7: the 8 modes, partitions and anchors for two and three subsets,
//     p-bits, rotation and index selection; a first byte of 0 gives opaque
//     black.
//
// The partition and anchor tables are the BC7 specification's.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

namespace {

struct RGBA {
  uint8_t r, g, b, a;
};

inline int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }
inline int get_bits(const uint8_t* src, int bit, int count) {
  int v = 0;
  for (int i = 0; i < count; ++i) v |= get_bit(src, bit + i) << i;
  return v;
}

RGBA decode_565(uint16_t x) {
  RGBA c;
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  c.r = (uint8_t)r;
  c.g = (uint8_t)g;
  c.b = (uint8_t)b;
  c.a = 0xff;
  return c;
}

void decode_bc1_color(RGBA* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = src[0] | (src[1] << 8), c1 = src[2] | (src[3] << 8);
  const uint32_t lut = src[4] | (src[5] << 8) | (src[6] << 16) | ((uint32_t)src[7] << 24);
  RGBA p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3), (uint8_t)((2 * b0 + b1) / 3), 0xff};
    p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3), (uint8_t)((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3-style alpha block into byte `o` of 16 pixels of `stride` bytes
void decode_bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0, a1;
  if (sign) {
    a0 = (int8_t)src[0] + 128;
    a1 = (int8_t)src[1] + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  const int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  const int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  uint8_t a[8];
  a[0] = (uint8_t)a0;
  a[1] = (uint8_t)a1;
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; ++k) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; ++n) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// ---- BC7
struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                              {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                              {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                              {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
const uint16_t kP2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22,
};
const uint32_t kP3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
};
const uint8_t kAnchor3a[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
};
const uint8_t kAnchor3b[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
};
const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) { return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4; }

int subset(int ns, int partition, int n) {
  if (ns == 2) return (kP2[partition] >> n) & 1;
  if (ns == 3) return (kP3[partition] >> (2 * n)) & 3;
  return 0;
}
bool is_anchor(int ns, int partition, int n) {
  if (n == 0) return true;
  if (ns == 2) return kAnchor2[partition] == n;
  if (ns == 3) return kAnchor3a[partition] == n || kAnchor3b[partition] == n;
  return false;
}

uint8_t expand_quantized(uint8_t v, int bits) {
  v = (uint8_t)(v << (8 - bits));
  return (uint8_t)(v | (v >> bits));
}

void bc7_lerp(RGBA* dst, const RGBA* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = (uint8_t)((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = (uint8_t)((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = (uint8_t)((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = (uint8_t)((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void decode_bc7_block(RGBA* col, const uint8_t* src) {
  int mode = src[0];
  if (!mode) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(mode & (1 << bit++))) {
  }
  mode = bit - 1;
  const Bc7Mode& info = kBc7Modes[mode];
  int cb = info.cb, ab = info.ab;
  const uint8_t* cw = weights(info.ib);
  const uint8_t* aw = weights((ab && info.ib2) ? info.ib2 : info.ib);
  const int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  const int rotation = get_bits(src, bit, info.rb);
  bit += info.rb;
  const int index_sel = get_bits(src, bit, info.isb);
  bit += info.isb;
  const int numep = info.ns << 1;
  RGBA ep[6];
  for (int i = 0; i < numep; ++i, bit += cb) ep[i].r = (uint8_t)get_bits(src, bit, cb);
  for (int i = 0; i < numep; ++i, bit += cb) ep[i].g = (uint8_t)get_bits(src, bit, cb);
  for (int i = 0; i < numep; ++i, bit += cb) ep[i].b = (uint8_t)get_bits(src, bit, cb);
  for (int i = 0; i < numep; ++i) {
    uint8_t v = 0xff;
    if (ab) {
      v = (uint8_t)get_bits(src, bit, ab);
      bit += ab;
    }
    ep[i].a = v;
  }
  auto assign_p = [](uint8_t& x, int v) { x = (uint8_t)((x << 1) | v); };
  if (info.epb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; ++i) {
      const int v = get_bit(src, bit++);
      assign_p(ep[i].r, v);
      assign_p(ep[i].g, v);
      assign_p(ep[i].b, v);
      if (ab) assign_p(ep[i].a, v);
    }
  }
  if (info.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      const int v = get_bit(src, bit++);
      for (int j = 0; j < 2; ++j) {
        assign_p(ep[i + j].r, v);
        assign_p(ep[i + j].g, v);
        assign_p(ep[i + j].b, v);
        if (ab) assign_p(ep[i + j].a, v);
      }
    }
  }
  for (int i = 0; i < numep; ++i) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit;
  int aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = subset(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (is_anchor(info.ns, partition, i)) ib--;
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && info.ib2) {
      int ib2 = info.ib2;
      if (i == 0) ib2--;
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    uint8_t t;
    if (rotation == 1) {
      t = col[i].r; col[i].r = col[i].a; col[i].a = t;
    } else if (rotation == 2) {
      t = col[i].g; col[i].g = col[i].a; col[i].a = t;
    } else if (rotation == 3) {
      t = col[i].b; col[i].b = col[i].a; col[i].a = t;
    }
  }
}

// ---- BC6H
struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {{2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
                               {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
                               {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
                               {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
                               {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
// each mode's endpoint bits in stream order: (endpoint * 3 + channel) << 4 | bit
const uint8_t kBc6Packing[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

void bc6_sign_extend(uint16_t* v, int prec) {
  int x = *v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  *v = (uint16_t)x;
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = (int16_t)v;
  if (prec >= 16) return x;
  bool s = false;
  if (x < 0) {
    s = true;
    x = -x;
  }
  if (x != 0) {
    if (x >= (1 << (prec - 1)) - 1)
      x = 0x7fff;
    else
      x = ((x << 15) + 0x4000) >> (prec - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (uint32_t)(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float((uint16_t)(0x8000 | (((-v) * 31) / 32)));
    return half_to_float((uint16_t)((v * 31) / 32));
  }
  return half_to_float((uint16_t)((v * 31) / 64));
}

uint8_t bc6_clamp(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return (uint8_t)(value * 255.0f);
}

void bc6_lerp(RGBA* col, const int* e0, const int* e1, int s, bool sign) {
  const int t = 64 - s;
  col->r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void decode_bc6_block(RGBA* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f;
  int bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {  // reserved
    memset(col, 0, 16 * sizeof(RGBA));
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  const uint8_t* cw = weights(ib);
  const int numep = info.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    const int d = kBc6Packing[mode][i];
    ep[d >> 4] |= (uint16_t)(get_bit(src, bit + i) << (d & 15));
  }
  bit += epbits;
  const int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  const int mask = (1 << info.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) bc6_sign_extend(&ep[c], info.epb);
  if (sign || info.tr)
    for (int i = 3; i < numep; i += 3) {
      bc6_sign_extend(&ep[i], info.rb);
      bc6_sign_extend(&ep[i + 1], info.gb);
      bc6_sign_extend(&ep[i + 2], info.bb);
    }
  if (info.tr) {
    for (int i = 3; i < numep; i += 3)
      for (int c = 0; c < 3; ++c) ep[i + c] = (uint16_t)((ep[i + c] + ep[c]) & mask);
  }
  int ueps[12];
  for (int i = 0; i < numep; ++i) ueps[i] = bc6_unquantize(ep[i], info.epb, sign);
  for (int i = 0; i < 16; ++i) {
    const int s = subset(info.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0 || (info.ns == 2 && i == kAnchor2[partition])) ib2--;
    const int i0 = get_bits(src, bit, ib2);
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

}  // namespace

extern "C" {

// `data` holds ceil(w/4) * ceil(h/4) blocks of format n (1-7; BC5 and BC6H
// signed when `sign`). out: w*h*C bytes, C = 4 for BC1/2/3/7, 3 for BC5 and
// BC6H, 1 for BC4. Returns 0, or -2 when `data` is short.
int bcn_decode(const uint8_t* data, long n_bytes, int n, int sign, int w, int h, uint8_t* out) {
  if (!data || !out || w <= 0 || h <= 0 || n < 1 || n > 7) return -1;
  const int bsize = (n == 1 || n == 4) ? 8 : 16;
  const int C = (n == 4) ? 1 : (n == 5 || n == 6) ? 3 : 4;
  const int bw = (w + 3) / 4, bh = (h + 3) / 4;
  if ((long)bw * bh * bsize > n_bytes) return -2;
  const uint8_t* src = data;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx, src += bsize) {
      RGBA col[16];
      memset(col, 0, sizeof(col));
      uint8_t lum[16];
      switch (n) {
        case 1: decode_bc1_color(col, src, false); break;
        case 2:
          decode_bc1_color(col, src + 8, true);
          for (int k = 0; k < 16; ++k) {
            int av = 0xf & (src[(k * 4) >> 3] >> ((k * 4) & 7));
            col[k].a = (uint8_t)((av << 4) | av);
          }
          break;
        case 3:
          decode_bc1_color(col, src + 8, true);
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 3, false);
          break;
        case 4: decode_bc3_alpha(lum, src, 1, 0, false); break;
        case 5:
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 0, sign);
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), src + 8, 4, 1, sign);
          if (sign)
            for (int k = 0; k < 16; ++k) col[k].b = 128;
          break;
        case 6: decode_bc6_block(col, src, sign); break;
        case 7: decode_bc7_block(col, src); break;
      }
      for (int j = 0; j < 4; ++j) {
        const int y = by * 4 + j;
        if (y >= h) break;
        for (int i = 0; i < 4; ++i) {
          const int x = bx * 4 + i;
          if (x >= w) break;
          uint8_t* d = out + ((size_t)y * w + x) * C;
          const int k = j * 4 + i;
          if (C == 1) {
            d[0] = lum[k];
          } else {
            d[0] = col[k].r;
            d[1] = col[k].g;
            d[2] = col[k].b;
            if (C == 4) d[3] = col[k].a;
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
