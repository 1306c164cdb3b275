// Baseline JPEG encoder (ITU-T T.81 process 1, 8-bit, Huffman, YCbCr 4:2:0,
// and one-component grey)
// for the export writers: what libjpeg-turbo writes with jpeg_set_defaults,
// jpeg_set_quality(q, force_baseline = TRUE) and JDCT_ISLOW, which is what
// PIL's `Image.save(path, "JPEG", quality=q)` asks of it (mode "RGB" by
// jpeg_encode_rgb, mode "L" by jpeg_encode_gray).
//
//   * file layout: SOI, JFIF APP0 (1.01, density 1:1, unit 0), one DQT per
//     table, SOF0, one DHT per table (DC0, AC0, DC1, AC1), SOS, the scan
//     with no restart markers, EOI;
//   * quantization: the Annex K tables scaled as jpeg_quality_scaling and
//     jpeg_add_quant_table scale them, clamped to [1, 255]; the ISLOW
//     divisors (quantval << 3) applied through libjpeg-turbo's reciprocal
//     multiply (compute_reciprocal, 16-bit DCTELEM);
//   * colour: libjpeg's fixed-point RGB -> YCbCr (16 fraction bits, the
//     0.5 - epsilon rounding of Cb and Cr);
//   * sampling: luma at full size, chroma by h2v2_downsample (the 2x2 mean
//     with the alternating 1, 2 bias); the right edge replicated to whole
//     blocks before sampling, the bottom to whole rows of sampled data, and
//     the blocks that pad a partial MCU made as libjpeg makes them (the DC
//     of their neighbour, no AC);
//   * the integer forward DCT of jfdctint.c and the standard Huffman tables.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const unsigned kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const unsigned kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};

const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];
};

// jpeg_make_c_derived_tbl: canonical codes from the counts per length.
void derive(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  std::memset(t, 0, sizeof(*t));
  unsigned code = 0;
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i, ++p) {
      t->code[vals[p]] = static_cast<uint16_t>(code++);
      t->size[vals[p]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
}

// The quantization table of jpeg_add_quant_table (force_baseline) at a
// jpeg_quality_scaling factor, in natural order.
void scale_table(const unsigned* basic, int quality, unsigned* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (basic[i] * scale + 50L) / 100L;
    if (v <= 0) v = 1;
    if (v > 32767) v = 32767;
    if (v > 255) v = 255;
    out[i] = static_cast<unsigned>(v);
  }
}

// libjpeg-turbo's compute_reciprocal for a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq & 0xFFFF, c & 0xFFFF, r - 16};
}

// jfdctint.c (the IJG 6b integer DCT libjpeg-turbo keeps), in place.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;      // element stride inside a row / column
    const int next = pass == 0 ? 8 : 1;      // stride between rows / columns
    const int shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* d = data + ctr * next;
      int32_t tmp0 = d[0] + d[7 * step];
      int32_t tmp7 = d[0] - d[7 * step];
      int32_t tmp1 = d[1 * step] + d[6 * step];
      int32_t tmp6 = d[1 * step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step];
      int32_t tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step];
      int32_t tmp4 = d[3 * step] - d[4 * step];

      int32_t tmp10 = tmp0 + tmp3;
      int32_t tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2;
      int32_t tmp12 = tmp1 - tmp2;

      if (pass == 0) {
        d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        d[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        d[0] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * 4433;                  // FIX_0_541196100
      d[2 * step] = descale(z1 + tmp13 * 6270, shift);      // FIX_0_765366865
      d[6 * step] = descale(z1 + tmp12 * -15137, shift);    // FIX_1_847759065

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6;
      int32_t z3 = tmp4 + tmp6;
      int32_t z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * 9633;                        // FIX_1_175875602
      tmp4 *= 2446;                                         // FIX_0_298631336
      tmp5 *= 16819;                                        // FIX_2_053119869
      tmp6 *= 25172;                                        // FIX_3_072711026
      tmp7 *= 12299;                                        // FIX_1_501321110
      z1 *= -7373;                                          // FIX_0_899976223
      z2 *= -20995;                                         // FIX_2_562915447
      z3 *= -16069;                                         // FIX_1_961570560
      z4 *= -3196;                                          // FIX_0_390180644
      z3 += z5;
      z4 += z5;
      d[7 * step] = descale(tmp4 + z1 + z3, shift);
      d[5 * step] = descale(tmp5 + z2 + z4, shift);
      d[3 * step] = descale(tmp6 + z2 + z3, shift);
      d[1 * step] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;  // pending bits, right-aligned
  int nacc = 0;

  void byte(uint8_t b) { out.push_back(b); }
  void word(unsigned v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v & 0xFF));
  }
  void bits(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nacc += size;
    while (nacc >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nacc - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nacc -= 8;
    }
    acc &= (1u << nacc) - 1;
  }
  void flush() {
    if (nacc > 0) bits(0x7F, 7);  // pad the last byte with ones
    nacc = 0;
    acc = 0;
  }
};

void put_dqt(Writer& w, const unsigned* table, int index) {
  w.word(0xFFDB);
  w.word(64 + 1 + 2);
  w.byte(static_cast<uint8_t>(index));
  for (int i = 0; i < 64; ++i) w.byte(static_cast<uint8_t>(table[kNatural[i]]));
}

void put_dht(Writer& w, const uint8_t* bits, const uint8_t* vals, int index) {
  int n = 0;
  for (int i = 1; i <= 16; ++i) n += bits[i];
  w.word(0xFFC4);
  w.word(n + 2 + 1 + 16);
  w.byte(static_cast<uint8_t>(index));
  for (int i = 1; i <= 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < n; ++i) w.byte(vals[i]);
}

struct Component {
  const Divisor* div;
  const HuffTable* dc;
  const HuffTable* ac;
  int last_dc = 0;
};

// DCT + quantization of one 8x8 block of samples (row stride `stride`).
void quantized_block(const uint8_t* src, int stride, const Divisor* div, int16_t* coef) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = static_cast<int32_t>(src[y * stride + x]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int32_t t = static_cast<int16_t>(ws[i]);  // DCTELEM is 16 bits in libjpeg-turbo
    const Divisor& d = div[i];
    uint32_t mag = static_cast<uint16_t>(t < 0 ? -t : t);
    uint32_t q = ((mag + d.corr) & 0xFFFF) * d.recip;
    int32_t v = static_cast<int16_t>(q >> (d.shift + 16));
    coef[i] = static_cast<int16_t>(t < 0 ? -v : v);
  }
}

void encode_block(Writer& w, const int16_t* coef, Component& c) {
  int temp = coef[0] - c.last_dc;
  int temp2 = temp;
  c.last_dc = coef[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  w.bits(c.dc->code[nbits], c.dc->size[nbits]);
  if (nbits) w.bits(static_cast<uint32_t>(temp2), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = coef[kNatural[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(c.ac->code[0xF0], c.ac->size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    int sym = (run << 4) + nbits;
    w.bits(c.ac->code[sym], c.ac->size[sym]);
    w.bits(static_cast<uint32_t>(temp2), nbits);
    run = 0;
  }
  if (run > 0) w.bits(c.ac->code[0], c.ac->size[0]);
}

// A block that pads a partial MCU: jccoefct.c's dummy block, the DC of the
// block before it and no AC.
void encode_dummy(Writer& w, int16_t dc, Component& c) {
  int16_t coef[64] = {0};
  coef[0] = dc;
  encode_block(w, coef, c);
}

thread_local Writer t_writer;

}  // namespace

extern "C" {

// Encode (height, width, 3) RGB u8 rows (row stride `stride` bytes) as a
// baseline JPEG at `quality`. Returns the file's length, or -1 on bad
// arguments; the file stays in this thread's buffer until jpeg_fetch.
long jpeg_encode_rgb(const uint8_t* rgb, int width, int height, long stride, int quality) {
  if (!rgb || width <= 0 || height <= 0 || width > 65535 || height > 65535 ||
      stride < 3L * width)
    return -1;
  unsigned qt[2][64];
  scale_table(kLumaQuant, quality, qt[0]);
  scale_table(kChromaQuant, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<uint16_t>(qt[t][i] << 3));
  HuffTable dc0, ac0, dc1, ac1;
  derive(kDcLumaBits, kDcVals, &dc0);
  derive(kAcLumaBits, kAcLumaVals, &ac0);
  derive(kDcChromaBits, kDcVals, &dc1);
  derive(kAcChromaBits, kAcChromaVals, &ac1);

  Writer& w = t_writer;
  w = Writer();
  w.out.reserve(static_cast<size_t>(width) * height / 2 + 1024);
  w.word(0xFFD8);
  const uint8_t jfif[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) w.byte(b);
  put_dqt(w, qt[0], 0);
  put_dqt(w, qt[1], 1);
  w.word(0xFFC0);
  w.word(8 + 3 * 3);
  w.byte(8);
  w.word(static_cast<unsigned>(height));
  w.word(static_cast<unsigned>(width));
  w.byte(3);
  const uint8_t comps[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (const auto& c : comps) {
    w.byte(c[0]);
    w.byte(c[1]);
    w.byte(c[2]);
  }
  put_dht(w, kDcLumaBits, kDcVals, 0x00);
  put_dht(w, kAcLumaBits, kAcLumaVals, 0x10);
  put_dht(w, kDcChromaBits, kDcVals, 0x01);
  put_dht(w, kAcChromaBits, kAcChromaVals, 0x11);
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (uint8_t b : sos) w.byte(b);

  // jccolor.c's rgb_ycc_convert, folded into three weighted sums
  const int32_t half = 1 << 15;
  const int32_t cbcr_off = (128 << 16) + half - 1;

  const int y_blocks_w = (width + 7) / 8;        // luma width_in_blocks
  const int y_blocks_h = (height + 7) / 8;
  const int mcu_w = (width + 15) / 16;
  const int mcu_h = (height + 15) / 16;
  const int c_rows = (height + 1) / 2;            // chroma rows of real data
  const int pw = mcu_w * 16;                      // padded luma / chroma-input width
  std::vector<uint8_t> ybuf(static_cast<size_t>(16) * pw), cbbuf(8 * pw / 2), crbuf(8 * pw / 2);
  std::vector<int32_t> cb2(2 * static_cast<size_t>(pw)), cr2(2 * static_cast<size_t>(pw));

  Component comp[3] = {{div[0], &dc0, &ac0}, {div[1], &dc1, &ac1}, {div[1], &dc1, &ac1}};

  for (int my = 0; my < mcu_h; ++my) {
    // luma rows: the last image row replicated below, the last column right
    for (int r = 0; r < 16; ++r) {
      int sy = my * 16 + r;
      if (sy > height - 1) sy = height - 1;
      const uint8_t* row = rgb + static_cast<long>(sy) * stride;
      uint8_t* yo = &ybuf[static_cast<size_t>(r) * pw];
      for (int x = 0; x < pw; ++x) {
        int sx = x < width ? x : width - 1;
        int32_t R = row[3 * sx], G = row[3 * sx + 1], B = row[3 * sx + 2];
        yo[x] = static_cast<uint8_t>((19595 * R + 38470 * G + 7471 * B + half) >> 16);
      }
    }
    // chroma rows: downsampled from row pairs (the last row doubled for an
    // odd height), then the last sampled row replicated below
    for (int r = 0; r < 8; ++r) {
      int k = my * 8 + r;
      if (k > c_rows - 1) k = c_rows - 1;
      for (int p = 0; p < 2; ++p) {
        int sy = 2 * k + p;
        if (sy > height - 1) sy = height - 1;
        const uint8_t* row = rgb + static_cast<long>(sy) * stride;
        for (int x = 0; x < pw; ++x) {
          int sx = x < width ? x : width - 1;
          int32_t R = row[3 * sx], G = row[3 * sx + 1], B = row[3 * sx + 2];
          cb2[static_cast<size_t>(p) * pw + x] = (-11059 * R - 21709 * G + 32768 * B + cbcr_off) >> 16;
          cr2[static_cast<size_t>(p) * pw + x] = (32768 * R - 27439 * G - 5329 * B + cbcr_off) >> 16;
        }
      }
      uint8_t* cbo = &cbbuf[static_cast<size_t>(r) * (pw / 2)];
      uint8_t* cro = &crbuf[static_cast<size_t>(r) * (pw / 2)];
      int bias = 1;
      for (int x = 0; x < pw / 2; ++x) {
        cbo[x] = static_cast<uint8_t>(
            (cb2[2 * x] + cb2[2 * x + 1] + cb2[pw + 2 * x] + cb2[pw + 2 * x + 1] + bias) >> 2);
        cro[x] = static_cast<uint8_t>(
            (cr2[2 * x] + cr2[2 * x + 1] + cr2[pw + 2 * x] + cr2[pw + 2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int mx = 0; mx < mcu_w; ++mx) {
      int16_t coef[4][64];
      for (int by = 0; by < 2; ++by) {
        for (int bx = 0; bx < 2; ++bx) {
          int n = by * 2 + bx;
          bool real_row = my * 2 + by < y_blocks_h;
          bool real_col = mx * 2 + bx < y_blocks_w;
          if (real_row && real_col) {
            quantized_block(&ybuf[static_cast<size_t>(by) * 8 * pw + mx * 16 + bx * 8], pw,
                            comp[0].div, coef[n]);
            encode_block(w, coef[n], comp[0]);
          } else {
            // a right pad block copies its left neighbour's DC; a bottom
            // one the DC of the last block of the row above
            int16_t dc = real_row ? coef[n - 1][0] : coef[1][0];
            std::memset(coef[n], 0, sizeof(coef[n]));
            coef[n][0] = dc;
            encode_dummy(w, dc, comp[0]);
          }
        }
      }
      int16_t cc[64];
      quantized_block(&cbbuf[mx * 8], pw / 2, comp[1].div, cc);
      encode_block(w, cc, comp[1]);
      quantized_block(&crbuf[mx * 8], pw / 2, comp[2].div, cc);
      encode_block(w, cc, comp[2]);
    }
  }
  w.flush();
  w.word(0xFFD9);
  return static_cast<long>(w.out.size());
}

// Encode (height, width) grey u8 rows (row stride `stride` bytes) as a
// baseline one-component JPEG at `quality`: what libjpeg-turbo writes for
// JCS_GRAYSCALE (PIL's mode "L"): SOF0 with one component (id 1, 1x1
// sampling, table 0), the luminance table and the DC0/AC0 Huffman tables
// only, and a non-interleaved scan of 8x8 blocks, the right column and the
// bottom row replicated to whole blocks (no dummy blocks). Returns the
// file's length, or -1 on bad arguments; fetch it with jpeg_fetch.
long jpeg_encode_gray(const uint8_t* grey, int width, int height, long stride, int quality) {
  if (!grey || width <= 0 || height <= 0 || width > 65535 || height > 65535 || stride < width)
    return -1;
  unsigned qt[64];
  scale_table(kLumaQuant, quality, qt);
  Divisor div[64];
  for (int i = 0; i < 64; ++i) div[i] = reciprocal(static_cast<uint16_t>(qt[i] << 3));
  HuffTable dc0, ac0;
  derive(kDcLumaBits, kDcVals, &dc0);
  derive(kAcLumaBits, kAcLumaVals, &ac0);

  Writer& w = t_writer;
  w = Writer();
  w.out.reserve(static_cast<size_t>(width) * height / 4 + 1024);
  w.word(0xFFD8);
  const uint8_t jfif[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) w.byte(b);
  put_dqt(w, qt, 0);
  w.word(0xFFC0);
  w.word(8 + 3 * 1);
  w.byte(8);
  w.word(static_cast<unsigned>(height));
  w.word(static_cast<unsigned>(width));
  w.byte(1);
  w.byte(1);
  w.byte(0x11);
  w.byte(0);
  put_dht(w, kDcLumaBits, kDcVals, 0x00);
  put_dht(w, kAcLumaBits, kAcLumaVals, 0x10);
  const uint8_t sos[] = {0xFF, 0xDA, 0, 8, 1, 1, 0x00, 0, 63, 0};
  for (uint8_t b : sos) w.byte(b);

  const int bw = (width + 7) / 8;
  const int bh = (height + 7) / 8;
  const int pw = bw * 8;
  std::vector<uint8_t> rows(static_cast<size_t>(8) * pw);
  Component comp{div, &dc0, &ac0};
  for (int by = 0; by < bh; ++by) {
    for (int r = 0; r < 8; ++r) {
      int sy = by * 8 + r;
      if (sy > height - 1) sy = height - 1;
      const uint8_t* row = grey + static_cast<long>(sy) * stride;
      uint8_t* o = &rows[static_cast<size_t>(r) * pw];
      for (int x = 0; x < pw; ++x) o[x] = row[x < width ? x : width - 1];
    }
    for (int bx = 0; bx < bw; ++bx) {
      int16_t coef[64];
      quantized_block(&rows[bx * 8], pw, comp.div, coef);
      encode_block(w, coef, comp);
    }
  }
  w.flush();
  w.word(0xFFD9);
  return static_cast<long>(w.out.size());
}

// Copy the calling thread's last encoded file (`n` bytes, as
// jpeg_encode_rgb returned) to `out` and release it. Returns 0, or -1 when
// `n` is not that length.
int jpeg_fetch(uint8_t* out, long n) {
  Writer& w = t_writer;
  if (!out || n != static_cast<long>(w.out.size())) return -1;
  std::memcpy(out, w.out.data(), w.out.size());
  w = Writer();
  return 0;
}

}  // extern "C"
