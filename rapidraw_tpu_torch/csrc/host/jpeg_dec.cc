// JPEG decoder (ITU-T T.81) for the LDR loader: the pixels libjpeg-turbo
// gives PIL's `Image.open(p)` at its defaults (JDCT_ISLOW,
// do_fancy_upsampling, no DCT scaling, out_color_space RGB, grey or CMYK),
// and the strips libjpeg decodes for libtiff's JPEG codec.
//
//   * coding: baseline and extended sequential (SOF0, SOF1) and progressive
//     (SOF2: spectral selection, successive approximation, DC and AC first
//     scans and refinements, EOB runs), interleaved and single-component
//     scans, restart intervals, any Huffman tables (4 per class) and 8- or
//     16-bit quantization tables;
//   * arithmetic coding (SOF9 sequential, SOF10 progressive) as jdarith.c
//     decodes it: the QM coder over T.81 Table D.2, the DAC segment's
//     conditioning (defaults L 0, U 1, Kx 5), the statistics and DC
//     predictions reset at each restart, restart markers out of order
//     resynchronised as jpeg_resync_to_restart does; a bad code (a
//     magnitude or a run past the block) leaves the rest of the scan's
//     blocks as they are, as libjpeg does after JWRN_ARITH_BAD_CODE.
//     SOF11 (arithmetic lossless) is refused, as libjpeg-turbo refuses it;
//     PIL's JPEG reader hands libjpeg 64 KB at a time and the arithmetic
//     decoder cannot suspend, so with `pil` a scan that reads past what PIL
//     has read fails as it fails there;
//   * 12-bit frames of one component for libtiff (jidctint.c built with
//     PASS1_BITS 1, 12-bit lossless), which PIL's JPEG reader turns away;
//   * lossless (SOF3) at 8 bits as libjpeg-turbo 3 decodes it: predictors
//     1-7 (jdlossls.c's undifferencers, the first row and the row after a
//     restart predicted from the left), the point transform, restart
//     intervals of whole MCU rows, 16-bit differences (ssss 16); colour
//     is never converted: three components are RGB unless a JFIF APP0 or
//     an Adobe transform other than 0 says YCbCr, which libjpeg refuses;
//   * colour: one component (grey), three (YCbCr, or RGB when an Adobe
//     APP14 says transform 0 and no JFIF APP0 is present, or when the
//     component ids are 'R', 'G', 'B') converted with jdcolor.c's
//     fixed-point tables (16 fraction bits), or four: CMYK as stored, or
//     YCCK (Adobe transform 2, or any transform but 0) through the same
//     tables and inverted (ycck_cmyk_convert). A caller may ask for the
//     components as stored (libtiff's JCS_UNKNOWN) or for YCbCr -> RGB
//     whatever the markers say (libtiff's JPEGCOLORMODE_RGB);
//   * the inverse DCT of jidctint.c (jpeg_idct_islow) as libjpeg-turbo's
//     x86 SIMD build computes it for 8-bit samples (16-bit lanes: past 16
//     bits the dequantization and sums wrap, each pass saturates, samples
//     clamp; `idct_islow_simd`), and jidctint.c itself with its range-limit
//     table for 12-bit samples;
//   * upsampling as jdsample.c chooses it: h2v1 and h2v2 "fancy" (triangle)
//     when the component is wider than 2 samples, h1v2 fancy, and the
//     replicating upsamplers for every other integral factor; the rows
//     above and below the component are its first and last rows, as
//     jdmainct.c's context pointers make them.
//
// PIL's JPEG reader turns away a frame of other than 8 bits or of other
// than 1, 3 or 4 components while it opens the file (kUnidentified); what
// libjpeg refuses as it decodes (fractional sampling factors, hierarchical
// frames, colour conversions of lossless data, arithmetic lossless frames,
// a second scan after a frame's single scan, the JPG, DHP, EXP, JPGn and
// reserved markers) is kBroken; a DNL segment is skipped. Truncated data
// raises (kTruncated). Corrupt Huffman-coded data in a DCT scan decodes as
// libjpeg decodes it with its warnings (jdhuff.c, jdphuff.c): a code in no
// table reads as 0 after 17 bits, a marker inside a segment gives zeros and
// leaves the segment's later MCUs as they are, restart markers out of order
// are resynchronised; in a lossless scan it raises (kCorrupt). A
// progressive frame whose scans leave AC coefficients 1-9 unrefined is
// smoothed as libjpeg-turbo smooths it (jdcoefct.c's 5x5 window).
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status {
  kOk = 0, kBadArgs = -1, kTruncated = -2, kCorrupt = -3, kUnidentified = -5, kBroken = -6
};

// how the caller wants colour: as libjpeg infers it, the components as
// stored, YCbCr -> RGB whatever the markers say, or each component's
// samples as libjpeg's raw_data_out hands them over (not upsampled)
enum Colour { kInfer = 0, kRaw = 1, kYCbCr = 2, kPlanes = 3 };

struct Failure {
  int code;
  std::string what;
};

thread_local std::string t_error;

[[noreturn]] void fail(int code, const std::string& what) { throw Failure{code, what}; }

struct Finished {};  // PIL has every row and stops reading

// zig-zag index -> natural index, with libjpeg's 16 guard entries for the
// run lengths of corrupt data
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;
constexpr long kWindow = 65536;  // PIL's ImageFile.MAXBLOCK

// jaricom.c jpeg_aritab: T.81 Table D.2 as (Qe << 16) | (Next_Index_MPS << 8)
// | (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed 0.5 bin
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdmarker.c jpeg_resync_to_restart's choice for the marker found where RST
// `desired` was due: 1 discard it and go on, 2 scan to the next marker and
// choose again, 3 leave it (the segment reads as empty)
int resync_action(int marker, int desired) {
  if (marker < 0xC0) return 2;
  if (marker < 0xD0 || marker > 0xD7) return 3;
  if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) return 3;
  if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) return 2;
  return 1;
}

// jdarith.c's QM decoder over one scan's bytes: C holds the interval's base
// and the bits read ahead, CT counts those bits (-16 before the first two
// bytes, -1 after a bad code, when the scan's blocks are left as they are).
// At a marker the reader supplies zeros, as libjpeg does.
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  const uint8_t* limit;  // PIL's window: reading here fails
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = 0;  // libjpeg's unread_marker

  int get_byte() {
    if (p >= limit) {
      if (limit < end) fail(kBroken, "broken data stream when reading image file");
      fail(kTruncated, "image file is truncated");
    }
    return *p++;
  }
  void restart() {
    c = 0;
    a = 0;
    ct = -16;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d = 0;
        if (!marker) {
          d = get_byte();
          if (d == 0xFF) {
            do d = get_byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              marker = d;
              d = 0;
            }
          }
        }
        c = static_cast<int64_t>((static_cast<uint64_t>(c) << 8) | static_cast<uint64_t>(d));
        if ((ct += 8) < 0) {
          if (++ct == 0) a = 0x8000;
        }
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    uint8_t nl = qe & 0xFF;
    qe >>= 8;
    uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp = static_cast<int64_t>(static_cast<uint64_t>(temp) << (ct & 63));
    if (c >= temp) {
      c -= temp;
      if (a < static_cast<int64_t>(qe)) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < static_cast<int64_t>(qe)) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Huffman {
  bool defined = false;
  // lookahead: (code length << 8) | symbol, or 0 when the code is longer
  uint16_t look[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int maxsym = 0;  // a DC table's largest symbol: 15 for DCT scans, 16 lossless
};

// jdhuff.c jpeg_make_d_derived_tbl, with its checks
void derive(const uint8_t bits[17], const uint8_t* vals, int nvals, bool dc, Huffman* t) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  }
  if (p != nvals || p > 256) fail(kCorrupt, "bad Huffman table");
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail(kCorrupt, "bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0x7FFFFFFF;
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 1; i <= bits[l]; ++i, ++p) {
      int look = huffcode[p] << (kLookBits - l);
      for (int c = 1 << (kLookBits - l); c > 0; --c) {
        t->look[look++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
  }
  std::memcpy(t->vals, vals, nvals);
  t->maxsym = 0;
  if (dc) {
    for (int i = 0; i < nvals; ++i) t->maxsym = std::max<int>(t->maxsym, vals[i]);
  }
  t->defined = true;
}

// Entropy-coded bits: 0xFF00 unstuffed, fill bytes skipped; at a marker the
// reader stops and supplies zeros. Consuming one of those is libjpeg's
// "insufficient data": with `recover` (a DCT scan, as jdhuff.c and
// jdphuff.c go on: the rest of the segment's MCUs are left as they are) it
// is noted, else it is corrupt data. Running out of bytes before a marker
// is a truncated file.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;      // bits in acc
  int real = 0;   // of which came from the file
  int marker = -1;
  bool recover = false, insufficient = false;

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (marker < 0) {
        if (p >= end) fail(kTruncated, "image file is truncated");
        b = *p++;
        if (b == 0xFF) {
          for (;;) {
            if (p >= end) fail(kTruncated, "image file is truncated");
            uint8_t c = *p++;
            if (c == 0xFF) continue;
            if (c != 0) {
              marker = c;
              b = 0;
            }
            break;
          }
        }
        if (marker < 0) real += 8;
      }
      acc |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  void consume(int k) {
    if (k > real) {
      if (!recover) fail(kCorrupt, "corrupt JPEG data: premature end of data segment");
      insufficient = true;  // JWRN_HIT_MARKER
      real = k;
    }
    acc <<= k;
    n -= k;
    real -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 17) fill();
    uint32_t look = static_cast<uint32_t>(acc >> (64 - kLookBits));
    uint16_t e = t.look[look];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) {
        // jpeg_huff_decode: JWRN_HUFF_BAD_CODE, 17 bits read, a zero faked
        if (!recover) fail(kCorrupt, "corrupt JPEG data: bad Huffman code");
        consume(17);
        return 0;
      }
      code = static_cast<int32_t>(acc >> (64 - l));
    }
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // drop the bits of the current byte and whatever was read ahead
  void reset() {
    acc = 0;
    n = 0;
    real = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks stored (the MCU grid)
  int wblocks = 0, hblocks = 0;  // blocks of a single-component scan
  int dw = 0, dh = 0;          // downsampled_width / _height
  bool latched = false;
  uint16_t quant[64];
  // jdinput.c's coef_bits (-1: never coded) and the values before the last
  // scan that coded each coefficient, for block smoothing
  int coef_bits[64], prev_bits[64];
  std::vector<int16_t> coef;
  std::vector<uint16_t> lossless;  // a lossless frame's undifferenced samples (dw x dh)
  int al = 0;                       // and its point transform
};

struct Decoder {
  Decoder(const uint8_t* d, size_t n, long win = 0) : data(d), size(n), window(win) {
    // jdmarker.c get_soi: the DAC defaults
    std::memset(arith_dc_L, 0, sizeof(arith_dc_L));
    std::memset(arith_dc_U, 1, sizeof(arith_dc_U));
    std::memset(arith_ac_K, 5, sizeof(arith_ac_K));
  }
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, precision = 8;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  // PIL's JPEG reader (its SOF checks, its 64 KB window) or libtiff's JPEG
  // codec, which hands libjpeg a whole strip or tile of 8 or 12 bits
  bool pil = true;
  bool progressive = false, lossless = false, arith = false, have_frame = false;
  bool jfif = false, adobe = false;
  // PIL's JPEG reader hands libjpeg the file 64 KB at a time, and the
  // arithmetic decoder cannot suspend: the end of what PIL has read so
  // far (0: the whole stream is there, as libtiff hands a strip over)
  long window = 0;
  // after the one scan of a single-scan frame, the rows are PIL's:
  // jpeg_finish_decompress may suspend at the window's end, and PIL keeps
  // what it has (Finished)
  bool finishing = false;
  int scans = 0;
  bool multi_scan = false;  // jdinput.c has_multiple_scans
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  int adobe_transform = -1;
  int restart = 0;
  int eob_run = 0;
  int last_good = 0;  // jdmaster's last_good_iMCU_row
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];

  uint8_t byte() {
    if (pos >= size) fail(kTruncated, "image file is truncated");
    // the marker reader suspends at the end of the window, and PIL reads on
    while (window && static_cast<long>(pos) >= window) {
      if (finishing) throw Finished{};
      window += kWindow;
    }
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // the next marker code (fill bytes and stray data before it skipped, as
  // libjpeg's next_marker does)
  int next_marker() {
    for (;;) {
      uint8_t c = byte();
      if (c != 0xFF) continue;
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  // a marker segment's payload [start, start + len)
  size_t segment(int* len) {
    int l = word();
    if (l < 2) fail(kCorrupt, "bad marker length");
    if (pos + (l - 2) > size) fail(kTruncated, "image file is truncated");
    *len = l - 2;
    size_t start = pos;
    pos += l - 2;
    while (window && static_cast<long>(pos) > window) {
      if (finishing) throw Finished{};
      window += kWindow;
    }
    return start;
  }

  // jdmarker.c get_dac: conditioning of the arithmetic coder's tables
  void read_dac() {
    int len;
    size_t s = segment(&len);
    for (int k = 0; k + 1 < len; k += 2) {
      int index = data[s + k], val = data[s + k + 1];
      if (index >= 32) fail(kBroken, "broken data stream when reading image file");
      if (index >= 16) {
        arith_ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        arith_dc_L[index] = static_cast<uint8_t>(val & 15);
        arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index])
          fail(kBroken, "broken data stream when reading image file");
      }
    }
    if (len & 1) fail(kBroken, "broken data stream when reading image file");
  }

  void read_dqt() {
    int len;
    size_t s = segment(&len);
    size_t e = s + len;
    while (s < e) {
      int pq = data[s] >> 4, tq = data[s] & 15;
      ++s;
      if (tq > 3 || pq > 1) fail(kCorrupt, "bad quantization table");
      int need = pq ? 128 : 64;
      if (s + need > e) fail(kCorrupt, "bad quantization table length");
      for (int i = 0; i < 64; ++i) {
        int v = pq ? (data[s + 2 * i] << 8) | data[s + 2 * i + 1] : data[s + i];
        qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
      s += need;
    }
  }

  void read_dht() {
    int len;
    size_t s = segment(&len);
    size_t e = s + len;
    while (s < e) {
      if (s + 17 > e) fail(kCorrupt, "bad Huffman table length");
      int tc = data[s] >> 4, th = data[s] & 15;
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = data[s + i];
        count += bits[i];
      }
      s += 17;
      if (tc > 1 || th > 3 || count > 256 || s + count > e) fail(kCorrupt, "bad Huffman table");
      derive(bits, data + s, count, tc == 0, tc ? &ac[th] : &dc[th]);
      s += count;
    }
  }

  // PIL's SOF handler first (its SyntaxErrors), then libjpeg's
  void read_sof(int marker, bool header_only = false) {
    if (have_frame) fail(kCorrupt, "more than one frame");
    int len;
    size_t s = segment(&len);
    if (len < 6) fail(kUnidentified, "bad SOF marker");
    precision = data[s];
    height = (data[s + 1] << 8) | data[s + 2];
    width = (data[s + 3] << 8) | data[s + 4];
    ncomp = data[s + 5];
    if (pil && precision != 8)
      fail(kUnidentified, "cannot handle " + std::to_string(precision) + "-bit layers");
    if (pil && ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(kUnidentified, "cannot handle " + std::to_string(ncomp) + "-layer images");
    // libjpeg-turbo 3 through libtiff: 8- or 12-bit samples (jpeg12_*)
    if (!pil && ((precision != 8 && precision != 12) || ncomp < 1 || ncomp > 4))
      fail(kBroken, "unsupported JPEG data precision or component count");
    if (header_only) {
      have_frame = true;
      return;
    }
    if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD)
      fail(kBroken, "broken data stream when reading image file");
    if (height == 0) fail(kCorrupt, "JPEG height 0 (DNL) not supported");
    if (width == 0) fail(kCorrupt, "empty JPEG image");
    if (len != 6 + 3 * ncomp) fail(kCorrupt, "bad SOF length");
    progressive = marker == 0xC2 || marker == 0xCA;
    lossless = marker == 0xC3 || marker == 0xCB;
    arith = marker >= 0xC9;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = data[s + 6 + 3 * i];
      c.h = data[s + 7 + 3 * i] >> 4;
      c.v = data[s + 7 + 3 * i] & 15;
      c.tq = data[s + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(kCorrupt, "bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, 0);
      if (lossless) {
        c.lossless.assign(static_cast<size_t>(c.dw) * c.dh, 0);
      } else {
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      }
    }
    have_frame = true;
  }

  void read_app(int marker) {
    int len;
    size_t s = segment(&len);
    if (marker == 0xE0 && len >= 5 && std::memcmp(data + s, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(data + s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[s + 11];
    }
  }

  // one scan: SOS header, then its entropy-coded segment(s)
  void read_scan() {
    if (!have_frame) fail(kCorrupt, "scan before frame header");
    int len;
    size_t s = segment(&len);
    int ns = len >= 1 ? data[s] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail(kCorrupt, "bad SOS marker");
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int id = data[s + 1 + 2 * i];
      int k = 0;
      while (k < ncomp && comp[k].id != id) ++k;
      if (k == ncomp) fail(kCorrupt, "SOS names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[j] == &comp[k]) fail(kCorrupt, "SOS names a component twice");
      sc[i] = &comp[k];
      td[i] = data[s + 2 + 2 * i] >> 4;
      ta[i] = data[s + 2 + 2 * i] & 15;
    }
    int ss = data[s + 1 + 2 * ns], se = data[s + 2 + 2 * ns];
    int ah = data[s + 3 + 2 * ns] >> 4, al = data[s + 3 + 2 * ns] & 15;
    // jdinput.c: a frame whose first scan holds every component is read as
    // one scan, and a second SOS is JERR_EOI_EXPECTED
    if (scans++ == 0) {
      multi_scan = ns < ncomp || progressive;
    } else if (!multi_scan) {
      fail(kBroken, "broken data stream when reading image file");
    }
    // jdmaster.c: libjpeg-turbo has no arithmetic lossless decoder
    // (JERR_ARITH_NOTIMPL)
    if (lossless && arith) fail(kBroken, "broken data stream when reading image file");
    if (lossless) {
      // jdlhuff.c start_pass_lhuff_decoder: Ss is the predictor, Al the
      // point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        fail(kBroken, "broken data stream when reading image file");
      for (int i = 0; i < ns; ++i) {
        if (td[i] > 3 || !dc[td[i]].defined) fail(kCorrupt, "Huffman table not defined");
        if (dc[td[i]].maxsym > 16) fail(kCorrupt, "bad Huffman table");
        sc[i]->latched = true;
        sc[i]->al = al;
      }
      lossless_scan(sc, ns, td, ss, al);
      return;
    }
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kCorrupt, "bad progression parameters");
      // start_pass_phuff_decoder / jdarith.c start_pass: the coefficients'
      // bits, and what they were before this scan
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          sc[i]->prev_bits[k] = scans > 1 ? cb[k] : 0;
        for (int k = ss; k <= se; ++k) cb[k] = al;
      }
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    // latch each component's quantization table at its first scan
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail(kCorrupt, "quantization table not defined");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      if (arith) continue;
      // jpeg_make_d_derived_tbl on the tables the scan uses (of 4; the
      // arithmetic coder's 16 conditioning tables need no check)
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0 && (!progressive || ss > 0);
      if (need_dc && (td[i] > 3 || !dc[td[i]].defined))
        fail(kCorrupt, "Huffman table not defined");
      if (need_dc && dc[td[i]].maxsym > 15) fail(kCorrupt, "bad Huffman table");
      if (need_ac && (ta[i] > 3 || !ac[ta[i]].defined))
        fail(kCorrupt, "Huffman table not defined");
    }
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; ++i) blocks_per_mcu += sc[i]->h * sc[i]->v;
    if (ns > 1 && blocks_per_mcu > 10) fail(kCorrupt, "too many blocks in an MCU");
    if (arith) {
      arith_scan(sc, ns, td, ta, ss, se, ah, al);
      finishing = window && !multi_scan;
      return;
    }

    Bits bits{data + pos, data + size};
    bits.recover = true;
    int pred[4] = {0, 0, 0, 0};
    eob_run = 0;
    int next_rst = 0;
    long mcus, per_row;
    if (ns == 1) {
      per_row = sc[0]->wblocks;
      mcus = per_row * sc[0]->hblocks;
    } else {
      per_row = mcux;
      mcus = static_cast<long>(mcux) * mcuy;
    }
    auto block_at = [&](Component& c, int by, int bx) {
      return &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
    };
    auto decode = [&](int i, int16_t* blk) {
      if (!progressive) {
        seq_block(bits, dc[td[i]], ac[ta[i]], blk, &pred[i]);
      } else if (ss == 0) {
        if (ah == 0) {
          int t = bits.decode(dc[td[i]]);
          int diff = t ? extend(bits.get(t), t) : 0;
          pred[i] += diff;
          blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred[i]) << al));
        } else if (bits.get(1)) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(bits, ac[ta[i]], blk, ss, se, al);
      } else {
        ac_refine(bits, ac[ta[i]], blk, ss, se, al);
      }
    };
    // a DC refinement reads its bits whatever (zeros change nothing)
    const bool dc_refine = progressive && ss == 0 && ah != 0;
    for (long m = 0; m < mcus; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        huff_restart(bits, &next_rst);
        for (int i = 0; i < 4; ++i) pred[i] = 0;
        eob_run = 0;
      }
      if (!bits.insufficient)
        last_good = ns == 1 ? static_cast<int>(m / per_row) / sc[0]->v
                            : static_cast<int>(m / per_row);
      if (bits.insufficient && !dc_refine) continue;
      if (ns == 1) {
        int by = static_cast<int>(m / per_row), bx = static_cast<int>(m % per_row);
        decode(0, block_at(*sc[0], by, bx));
      } else {
        int my = static_cast<int>(m / per_row), mx = static_cast<int>(m % per_row);
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int y = 0; y < c.v; ++y)
            for (int x = 0; x < c.h; ++x) decode(i, block_at(c, my * c.v + y, mx * c.h + x));
        }
      }
    }
    resume(bits);
  }

  // An arithmetic-coded scan as jdarith.c decodes it: the statistics of
  // the scan's tables zeroed at its start and at each restart, with the DC
  // predictions and contexts; a bad code (a magnitude or a run past the
  // block) leaves the rest of the scan's blocks as they are. Restart
  // markers out of order are resynchronised as jdmarker.c's
  // jpeg_resync_to_restart does.
  void arith_scan(Component** sc, int ns, const int* td, const int* ta, int ss, int se,
                  int ah, int al) {
    const uint8_t* limit = data + size;
    if (window && window < static_cast<long>(size)) limit = data + window;
    Arith e{data + pos, data + size, limit};
    std::vector<uint8_t> dc_stats(16 * 64), ac_stats(16 * 256);
    uint8_t fixed = 113;
    int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
    const bool dc_scan = !progressive || (ss == 0 && ah == 0);
    const bool ac_scan = !progressive || ss != 0;
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (dc_scan) {
          std::memset(&dc_stats[td[i] * 64], 0, 64);
          last_dc[i] = 0;
          dc_ctx[i] = 0;
        }
        if (ac_scan) std::memset(&ac_stats[ta[i] * 256], 0, 256);
      }
    };
    reset_stats();
    int next_rst = 0;
    long mcus, per_row;
    if (ns == 1) {
      per_row = sc[0]->wblocks;
      mcus = per_row * sc[0]->hblocks;
    } else {
      per_row = mcux;
      mcus = static_cast<long>(mcux) * mcuy;
    }
    // Figures F.19 to F.24: a DC difference; false after a bad code
    auto dc_diff = [&](int i, int* v) {
      uint8_t* st0 = &dc_stats[td[i] * 64];
      uint8_t* st = st0 + dc_ctx[i];
      if (e.decode(st) == 0) {
        dc_ctx[i] = 0;
        *v = 0;
        return true;
      }
      int sign = e.decode(st + 1);
      st += 2 + sign;
      int m = e.decode(st);
      if (m) {
        st = st0 + 20;
        while (e.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            e.ct = -1;
            return false;
          }
          st += 1;
        }
      }
      if (m < ((1 << arith_dc_L[td[i]]) >> 1)) {
        dc_ctx[i] = 0;
      } else if (m > ((1 << arith_dc_U[td[i]]) >> 1)) {
        dc_ctx[i] = 12 + sign * 4;
      } else {
        dc_ctx[i] = 4 + sign * 4;
      }
      int v2 = m;
      st += 14;
      while (m >>= 1)
        if (e.decode(st)) v2 |= m;
      v2 += 1;
      *v = sign ? -v2 : v2;
      return true;
    };
    // Figure F.20: the AC coefficients k0..k1; false after a bad code
    auto ac_first = [&](int i, int16_t* blk, int k0, int k1, int shift) {
      uint8_t* st0 = &ac_stats[ta[i] * 256];
      for (int k = k0; k <= k1; ++k) {
        uint8_t* st = st0 + 3 * (k - 1);
        if (e.decode(st)) break;
        while (e.decode(st + 1) == 0) {
          st += 3;
          if (++k > k1) {
            e.ct = -1;
            return false;
          }
        }
        int sign = e.decode(&fixed);
        st += 2;
        int m = e.decode(st);
        if (m && e.decode(st)) {
          m <<= 1;
          st = st0 + (k <= arith_ac_K[ta[i]] ? 189 : 217);
          while (e.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              e.ct = -1;
              return false;
            }
            st += 1;
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (e.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << shift));
      }
      return true;
    };
    auto ac_refine = [&](int i, int16_t* blk) {
      uint8_t* st0 = &ac_stats[ta[i] * 256];
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      int kex = se;
      for (; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = st0 + 3 * (k - 1);
        if (k > kex && e.decode(st)) break;
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {
            if (e.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (e.decode(st + 1)) {
            *coef = static_cast<int16_t>(e.decode(&fixed) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se) {
            e.ct = -1;
            return;
          }
        }
      }
    };
    auto block_at = [&](Component& c, int by, int bx) {
      return &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
    };
    auto decode_block = [&](int i, int16_t* blk) {
      if (!progressive) {
        int v;
        if (!dc_diff(i, &v)) return false;
        last_dc[i] = (last_dc[i] + v) & 0xFFFF;
        blk[0] = static_cast<int16_t>(last_dc[i]);
        return ac_first(i, blk, 1, 63, 0);
      }
      if (ss == 0 && ah == 0) {
        int v;
        if (!dc_diff(i, &v)) return false;
        last_dc[i] += v;
        blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(last_dc[i]) << al));
        return true;
      }
      if (ss == 0) {
        if (e.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        return true;
      }
      if (ah == 0) return ac_first(i, blk, ss, se, al);
      ac_refine(i, blk);
      return e.ct != -1;
    };
    const bool dc_refine = progressive && ss == 0 && ah != 0;
    long to_go = restart;
    for (long m = 0; m < mcus; ++m) {
      if (restart) {
        if (to_go == 0) {
          arith_restart(e, &next_rst);
          reset_stats();
          e.restart();
          to_go = restart;
        }
        --to_go;
      }
      last_good = ns == 1 ? static_cast<int>(m / per_row) / sc[0]->v
                          : static_cast<int>(m / per_row);
      if (e.ct == -1 && !dc_refine) continue;
      if (ns == 1) {
        int by = static_cast<int>(m / per_row), bx = static_cast<int>(m % per_row);
        decode_block(0, block_at(*sc[0], by, bx));
        continue;
      }
      int my = static_cast<int>(m / per_row), mx = static_cast<int>(m % per_row);
      bool ok = true;
      for (int i = 0; i < ns && ok; ++i) {
        Component& c = *sc[i];
        for (int y = 0; y < c.v && ok; ++y)
          for (int x = 0; x < c.h && ok; ++x)
            ok = decode_block(i, block_at(c, my * c.v + y, mx * c.h + x));
      }
    }
    if (e.marker) {
      pos = static_cast<size_t>(e.p - data) - 2;
    } else {
      pos = static_cast<size_t>(e.p - data);
    }
  }

  // jdmarker.c read_restart_marker with jpeg_resync_to_restart, over the
  // arithmetic decoder's bytes
  void arith_restart(Arith& e, int* next_rst) {
    auto next_marker = [&]() {
      for (;;) {
        int c = e.get_byte();
        while (c != 0xFF) c = e.get_byte();
        do c = e.get_byte();
        while (c == 0xFF);
        if (c != 0) {
          e.marker = c;
          return;
        }
      }
    };
    if (!e.marker) next_marker();
    const int desired = *next_rst;
    if (e.marker != 0xD0 + desired) {
      for (;;) {
        const int action = resync_action(e.marker, desired);
        if (action == 1) {
          e.marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    } else {
      e.marker = 0;
    }
    *next_rst = (*next_rst + 1) & 7;
  }

  // resume header parsing at the marker that ended the segment (its 0xFF
  // is the byte before its code)
  void resume(const Bits& bits) {
    if (bits.marker >= 0) {
      pos = static_cast<size_t>(bits.p - data) - 2;
    } else {
      pos = static_cast<size_t>(bits.p - data);
    }
  }

  // jdhuff.c process_restart: what is left of the segment discarded, RSTn
  // read (resynchronised as jpeg_resync_to_restart does), and the data
  // flagged sufficient again unless a marker was left unread
  void huff_restart(Bits& bits, int* next_rst) {
    bits.reset();
    auto next_marker = [&]() {
      while (bits.marker < 0) {
        if (bits.p >= bits.end) fail(kTruncated, "image file is truncated");
        if (*bits.p++ != 0xFF) continue;
        while (bits.p < bits.end && *bits.p == 0xFF) ++bits.p;
        if (bits.p >= bits.end) fail(kTruncated, "image file is truncated");
        if (*bits.p) bits.marker = *bits.p;
        ++bits.p;
      }
    };
    next_marker();
    const int desired = *next_rst;
    for (;;) {
      const int action = bits.marker == 0xD0 + desired ? 1 : resync_action(bits.marker, desired);
      if (action == 1) bits.marker = -1;
      if (action != 2) break;
      bits.marker = -1;
      next_marker();
    }
    *next_rst = (desired + 1) & 7;
    if (bits.marker < 0) bits.insufficient = false;
  }

  // libjpeg discards what is left of the segment and reads RSTn
  void read_restart(Bits& bits, int* next_rst) {
    if (bits.marker < 0) {
      bits.reset();
      while (bits.marker < 0) {
        if (bits.p >= bits.end) fail(kTruncated, "image file is truncated");
        if (*bits.p++ != 0xFF) continue;
        while (bits.p < bits.end && *bits.p == 0xFF) ++bits.p;
        if (bits.p >= bits.end) fail(kTruncated, "image file is truncated");
        if (*bits.p) bits.marker = *bits.p;
        ++bits.p;
      }
    }
    if (bits.marker != 0xD0 + *next_rst) fail(kCorrupt, "corrupt JPEG data: bad restart marker");
    *next_rst = (*next_rst + 1) & 7;
    bits.marker = -1;
    bits.reset();
  }

  // A lossless scan: the differences of a row of MCUs (dummy samples past
  // a component's edge decoded and dropped), then each component's rows
  // undifferenced as jddiffct.c / jdlossls.c do. A component's first row,
  // and its first after each restart, predicts its first sample from
  // 1 << (7 - Al) and the rest from the left; later rows predict their
  // first sample from above. Restarts come every whole number of MCU rows.
  void lossless_scan(Component** sc, int ns, const int* td, int psv, int al) {
    const int per_row = ns == 1 ? sc[0]->dw : (width + hmax - 1) / hmax;
    const int mcu_rows = ns == 1 ? sc[0]->dh : (height + vmax - 1) / vmax;
    if (restart && restart % per_row) fail(kBroken, "broken data stream when reading image file");
    int hs[4], vs[4];
    std::vector<int> diff[4];
    for (int i = 0; i < ns; ++i) {
      hs[i] = ns == 1 ? 1 : sc[i]->h;
      vs[i] = ns == 1 ? 1 : sc[i]->v;
      diff[i].assign(static_cast<size_t>(per_row) * hs[i] * vs[i], 0);
    }
    Bits bits{data + pos, data + size};
    int next_rst = 0;
    bool first[4] = {true, true, true, true};
    for (int r = 0; r < mcu_rows; ++r) {
      if (restart && r > 0 && (static_cast<long>(r) * per_row) % restart == 0) {
        read_restart(bits, &next_rst);
        for (int i = 0; i < 4; ++i) first[i] = true;
      }
      for (int m = 0; m < per_row; ++m) {
        for (int i = 0; i < ns; ++i) {
          const int rw = per_row * hs[i];
          for (int yy = 0; yy < vs[i]; ++yy)
            for (int xx = 0; xx < hs[i]; ++xx) {
              int t = bits.decode(dc[td[i]]);
              int d = 0;
              if (t == 16) {
                d = 32768;
              } else if (t) {
                d = extend(bits.get(t), t);
              }
              diff[i][static_cast<size_t>(yy) * rw + m * hs[i] + xx] = d;
            }
        }
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        const int w = c.dw, rw = per_row * hs[i];
        for (int yy = 0; yy < vs[i]; ++yy) {
          const int y = r * vs[i] + yy;
          if (y >= c.dh) break;
          uint16_t* row = &c.lossless[static_cast<size_t>(y) * w];
          const uint16_t* up = row - w;
          const int* df = &diff[i][static_cast<size_t>(yy) * rw];
          if (first[i]) {
            row[0] = static_cast<uint16_t>((df[0] + (1 << (precision - 1 - al))) & 0xFFFF);
            for (int x = 1; x < w; ++x)
              row[x] = static_cast<uint16_t>((df[x] + row[x - 1]) & 0xFFFF);
            first[i] = false;
            continue;
          }
          row[0] = static_cast<uint16_t>((df[0] + up[0]) & 0xFFFF);
          for (int x = 1; x < w; ++x) {
            int ra = row[x - 1], rb = up[x], rc = up[x - 1], p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            row[x] = static_cast<uint16_t>((df[x] + p) & 0xFFFF);
          }
        }
      }
    }
    resume(bits);
  }

  void seq_block(Bits& b, const Huffman& dct, const Huffman& act, int16_t* blk, int* pred) {
    int t = b.decode(dct);
    int diff = t ? extend(b.get(t), t) : 0;
    *pred += diff;
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      int rs = b.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void ac_first(Bits& b, const Huffman& t, int16_t* blk, int ss, int se, int al) {
    if (eob_run > 0) {
      --eob_run;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = b.decode(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(b.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eob_run = 1 << r;
        if (r) eob_run += b.get(r);
        --eob_run;
        break;
      }
    }
  }

  void ac_refine(Bits& b, const Huffman& t, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eob_run == 0) {
      for (; k <= se; ++k) {
        int rs = b.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eob_run = 1 << r;
          if (r) eob_run += b.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (b.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eob_run > 0) {
      for (; k <= se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0 && b.get(1) && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eob_run;
    }
  }

  void parse() {
    try {
      parse_markers();
    } catch (const Finished&) {
    }
  }

  void parse_markers() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          read_sof(m);
          break;
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xCC:
          read_dac();
          break;
        case 0xDD: {
          int len;
          size_t s = segment(&len);
          if (len != 2) fail(kCorrupt, "bad DRI marker");
          restart = (data[s] << 8) | data[s + 1];
          break;
        }
        case 0xDA:
          read_scan();
          scanned = true;
          break;
        case 0xD9:
          if (!scanned) fail(kCorrupt, "JPEG without image data");
          return;
        case 0xD8:
          fail(kCorrupt, "unexpected SOI marker");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;  // a stray RSTn: libjpeg skips it
          if (m == 0x01) break;                // TEM has no length
          if ((m & 0xF0) == 0xE0) {
            read_app(m);
          } else if (m == 0xFE || m == 0xDC) {  // COM; DNL, which libjpeg ignores
            int len;
            segment(&len);
          } else {
            // JPG, DHP, EXP, JPGn and RESn: JERR_SOF_UNSUPPORTED,
            // JERR_UNKNOWN_MARKER
            fail(kBroken, "broken data stream when reading image file");
          }
          break;
      }
    }
  }

  // the colour space libjpeg infers (jdapimin.c default_decompress_parms)
  bool rgb_source() const {
    if (ncomp != 3 || jfif) return false;
    if (adobe) return adobe_transform == 0;
    return lossless || (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
  }
  // jdapimin.c: a four-component frame is YCCK under an Adobe marker whose
  // transform is not 0
  bool ycck_source() const { return ncomp == 4 && adobe && adobe_transform != 0; }
};

// jidctint.c jpeg_idct_islow, with its range-limit table, for 12-bit
// samples (PASS1_BITS 1, as libjpeg-turbo's 12-bit build); 8-bit samples
// take libjpeg-turbo's SIMD build of it (idct_islow_simd)
constexpr int kConstBits = 13;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

// jdmaster.c prepare_range_limit_table as the IDCT indexes it: x modulo 4N
// read as signed, plus CENTERJSAMPLE, clamped (N = MAXJSAMPLE + 1 = 4096)
struct RangeLimit12 {
  static constexpr int N = 1 << 12, kMask = 4 * N - 1;
  uint16_t t[4 * N];
  RangeLimit12() {
    for (int i = 0; i < 4 * N; ++i) {
      int v = (i < 2 * N ? i : i - 4 * N) + N / 2;
      t[i] = static_cast<uint16_t>(v < 0 ? 0 : v > N - 1 ? N - 1 : v);
    }
  }
};
const RangeLimit12 kRange12;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void idct_islow12(const int16_t* in, const uint16_t* q, uint16_t* out, int stride) {
  constexpr int kPass1Bits = 1;
  const auto& range = kRange12.t;
  constexpr int kMask = RangeLimit12::kMask;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(static_cast<int64_t>(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int>(descale(t10 + tmp3, sh));
    ws[7 * 8 + c] = static_cast<int>(descale(t10 - tmp3, sh));
    ws[1 * 8 + c] = static_cast<int>(descale(t11 + tmp2, sh));
    ws[6 * 8 + c] = static_cast<int>(descale(t11 - tmp2, sh));
    ws[2 * 8 + c] = static_cast<int>(descale(t12 + tmp1, sh));
    ws[5 * 8 + c] = static_cast<int>(descale(t12 - tmp1, sh));
    ws[3 * 8 + c] = static_cast<int>(descale(t13 + tmp0, sh));
    ws[4 * 8 + c] = static_cast<int>(descale(t13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint16_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint16_t v = range[static_cast<int>(descale(w[0], kPass1Bits + 3)) & kMask];
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range[static_cast<int>(descale(t10 + tmp3, sh)) & kMask];
    o[7] = range[static_cast<int>(descale(t10 - tmp3, sh)) & kMask];
    o[1] = range[static_cast<int>(descale(t11 + tmp2, sh)) & kMask];
    o[6] = range[static_cast<int>(descale(t11 - tmp2, sh)) & kMask];
    o[2] = range[static_cast<int>(descale(t12 + tmp1, sh)) & kMask];
    o[5] = range[static_cast<int>(descale(t12 - tmp1, sh)) & kMask];
    o[3] = range[static_cast<int>(descale(t13 + tmp0, sh)) & kMask];
    o[4] = range[static_cast<int>(descale(t13 - tmp0, sh)) & kMask];
  }
}

// libjpeg-turbo's x86 SIMD build of the same inverse DCT (jidctint-sse2 /
// -avx2, which libjpeg-turbo uses for 8-bit samples on hosts that have
// them): jidctint.c's arithmetic in 16-bit lanes. It equals jidctint.c
// wherever the values fit; past that the dequantization and the butterflies'
// 16-bit sums wrap, each pass's results saturate to 16 bits, the samples to
// [0, 255], and a block whose AC rows are all zero takes the DC path with a
// 16-bit shift.
inline int16_t wrap16(int64_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF)); }
inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}
inline int32_t wrap32(uint32_t v) { return static_cast<int32_t>(v); }
// pmaddwd: a0 b0 + a1 b1, the sum in 32 wrapping bits
inline int32_t madd(int16_t a0, int32_t b0, int16_t a1, int32_t b1) {
  return wrap32(static_cast<uint32_t>(a0 * b0) + static_cast<uint32_t>(a1 * b1));
}

// One 1-D pass over in[0..7] (16-bit), descaled by `shift` into 32 bits.
void simd_pass(const int16_t* in, int shift, int32_t* out) {
  const int32_t tmp3 = madd(in[2], F0541 + F0765, in[6], F0541);
  const int32_t tmp2 = madd(in[2], F0541, in[6], F0541 - F1847);
  const int32_t tmp0 = static_cast<int32_t>(wrap16(in[0] + in[4])) * (1 << kConstBits);
  const int32_t tmp1 = static_cast<int32_t>(wrap16(in[0] - in[4])) * (1 << kConstBits);
  const uint32_t t10 = static_cast<uint32_t>(tmp0) + static_cast<uint32_t>(tmp3),
                 t13 = static_cast<uint32_t>(tmp0) - static_cast<uint32_t>(tmp3),
                 t11 = static_cast<uint32_t>(tmp1) + static_cast<uint32_t>(tmp2),
                 t12 = static_cast<uint32_t>(tmp1) - static_cast<uint32_t>(tmp2);
  const int16_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
  const int32_t zz3 = madd(z3, F1175 - F1961, z4, F1175);
  const int32_t zz4 = madd(z3, F1175, z4, F1175 - F0390);
  const uint32_t o0 = static_cast<uint32_t>(madd(in[7], F0298 - F0899, in[1], -F0899)) +
                      static_cast<uint32_t>(zz3);
  const uint32_t o3 = static_cast<uint32_t>(madd(in[7], -F0899, in[1], F1501 - F0899)) +
                      static_cast<uint32_t>(zz4);
  const uint32_t o1 = static_cast<uint32_t>(madd(in[5], F2053 - F2562, in[3], -F2562)) +
                      static_cast<uint32_t>(zz4);
  const uint32_t o2 = static_cast<uint32_t>(madd(in[5], -F2562, in[3], F3072 - F2562)) +
                      static_cast<uint32_t>(zz3);
  const uint32_t round = 1u << (shift - 1);
  auto desc = [&](uint32_t v) { return wrap32(v + round) >> shift; };
  out[0] = desc(t10 + o3);
  out[7] = desc(t10 - o3);
  out[1] = desc(t11 + o2);
  out[6] = desc(t11 - o2);
  out[2] = desc(t12 + o1);
  out[5] = desc(t12 - o1);
  out[3] = desc(t13 + o0);
  out[4] = desc(t13 - o0);
}

void idct_islow_simd(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  constexpr int kPass1Bits = 2;
  int16_t ws[64];
  bool ac = false;
  for (int k = 8; k < 64 && !ac; ++k) ac = in[k] != 0;
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16(static_cast<int32_t>(wrap16(in[c] * q[c])) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        // what the full pass gives a column of one value: 4 x, saturated
        const int16_t v = sat16(static_cast<int32_t>(wrap16(ip[0] * q[c])) * (1 << kPass1Bits));
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
        continue;
      }
      int16_t col[8];
      int32_t res[8];
      for (int r = 0; r < 8; ++r) col[r] = wrap16(in[r * 8 + c] * q[r * 8 + c]);
      simd_pass(col, kConstBits - kPass1Bits, res);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(res[r]);
    }
  }
  auto sample = [](int32_t v) {
    v = sat16(v);
    return static_cast<uint8_t>((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
  };
  for (int r = 0; r < 8; ++r) {
    const int16_t* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      // what the full pass gives a row of one value
      std::memset(o, sample((w[0] + 16) >> 5), 8);
      continue;
    }
    int32_t res[8];
    simd_pass(w, kConstBits + kPass1Bits + 3, res);
    for (int x = 0; x < 8; ++x) o[x] = sample(res[x]);
  }
}

// A component's samples (stride bw * 8) -> a full-size (height, width)
// plane, upsampled as jdsample.c does (never "fancy" for a lossless frame,
// whose min_DCT_scaled_size is 1).
void upsample(const Component& c, const uint8_t* src, int hmax, int vmax, int width, int height,
              uint8_t* dst, bool fancy) {
  const int stride = c.bw * 8;
  const int he = hmax / c.h, ve = vmax / c.v;
  if (hmax % c.h || vmax % c.v) fail(kBroken, "broken data stream when reading image file");
  auto row = [&](int y) {
    y = y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y;
    return src + static_cast<size_t>(y) * stride;
  };
  const int dw = c.dw;
  std::vector<int> cs(dw);
  std::vector<uint8_t> line(static_cast<size_t>(dw) * 2 + 2);
  for (int y = 0; y < height; ++y) {
    uint8_t* o = dst + static_cast<size_t>(y) * width;
    if (he == 1 && ve == 1) {
      std::memcpy(o, row(y), width);
    } else if (fancy && he == 2 && ve == 1 && dw > 2) {
      const uint8_t* a = row(y);
      uint8_t* l = line.data();
      l[0] = a[0];
      l[1] = static_cast<uint8_t>((a[0] * 3 + a[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = a[i] * 3;
        l[2 * i] = static_cast<uint8_t>((v + a[i - 1] + 1) >> 2);
        l[2 * i + 1] = static_cast<uint8_t>((v + a[i + 1] + 2) >> 2);
      }
      l[2 * dw - 2] = static_cast<uint8_t>((a[dw - 1] * 3 + a[dw - 2] + 1) >> 2);
      l[2 * dw - 1] = a[dw - 1];
      std::memcpy(o, l, width);
    } else if (fancy && he == 1 && ve == 2) {
      int iy = y >> 1;
      const uint8_t* a = row(iy);
      const uint8_t* b = (y & 1) ? row(iy + 1) : row(iy - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((a[x] * 3 + b[x] + bias) >> 2);
    } else if (fancy && he == 2 && ve == 2 && dw > 2) {
      int iy = y >> 1;
      const uint8_t* a = row(iy);
      const uint8_t* b = (y & 1) ? row(iy + 1) : row(iy - 1);
      for (int i = 0; i < dw; ++i) cs[i] = a[i] * 3 + b[i];
      uint8_t* l = line.data();
      l[0] = static_cast<uint8_t>((cs[0] * 4 + 8) >> 4);
      l[1] = static_cast<uint8_t>((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        l[2 * i] = static_cast<uint8_t>((cs[i] * 3 + cs[i - 1] + 8) >> 4);
        l[2 * i + 1] = static_cast<uint8_t>((cs[i] * 3 + cs[i + 1] + 7) >> 4);
      }
      l[2 * dw - 2] = static_cast<uint8_t>((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
      l[2 * dw - 1] = static_cast<uint8_t>((cs[dw - 1] * 4 + 7) >> 4);
      std::memcpy(o, l, width);
    } else {
      // replication: h2v1_upsample, h2v2_upsample, int_upsample
      const uint8_t* a = src + static_cast<size_t>(y / ve) * stride;
      for (int x = 0; x < width; ++x) o[x] = a[x / he];
    }
  }
}

// jdcolor.c's YCbCr -> RGB tables
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Image {
  int width = 0, height = 0, channels = 0;
};

Image header(const uint8_t* data, long n, bool pil, int* precision = nullptr) {
  Decoder d{data, static_cast<size_t>(n)};
  d.pil = pil;
  // parse up to the frame header only, as PIL's JPEG reader opens a file
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG file");
  d.pos = 2;
  while (!d.have_frame) {
    int m = d.next_marker();
    if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
        (m >= 0xCD && m <= 0xCF)) {
      d.read_sof(m, true);
    } else if (m == 0xDA || m == 0xD9 || m == 0xD8) {
      fail(kCorrupt, "JPEG without a supported frame header");
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      continue;
    } else {
      int len;
      d.segment(&len);
    }
  }
  if (precision) *precision = d.precision;
  return Image{d.width, d.height, d.ncomp};
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo's 5x5 window): in a
// progressive frame whose AC coefficients 1-9 are not all coded to full
// precision, each block's still-zero ones are estimated from the DC values
// of the 24 blocks around it (and with none of them coded at all, the DC
// too), before the inverse DCT.
bool smoothing_ok(const Decoder& d) {
  static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  if (!d.progressive) return false;
  bool useful = false;
  for (int ci = 0; ci < d.ncomp; ++ci) {
    const Component& c = d.comp[ci];
    if (!c.latched) return false;
    for (int k = 0; k < 10; ++k)
      if (c.quant[kQ[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

void smooth_block(const int* bits, bool change_dc, const uint16_t* q, const int dcv[25],
                  int16_t* ws) {
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2],
                Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  const int DC01 = dcv[0], DC02 = dcv[1], DC03 = dcv[2], DC04 = dcv[3], DC05 = dcv[4],
            DC06 = dcv[5], DC07 = dcv[6], DC08 = dcv[7], DC09 = dcv[8], DC10 = dcv[9],
            DC11 = dcv[10], DC12 = dcv[11], DC13 = dcv[12], DC14 = dcv[13], DC15 = dcv[14],
            DC16 = dcv[15], DC17 = dcv[16], DC18 = dcv[17], DC19 = dcv[18], DC20 = dcv[19],
            DC21 = dcv[20], DC22 = dcv[21], DC23 = dcv[22], DC24 = dcv[23], DC25 = dcv[24];
  auto estimate = [&](int k, int pos, int64_t qk, int64_t num) {
    const int al = bits[k];
    if (al == 0 || ws[pos] != 0) return;
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    ws[pos] = static_cast<int16_t>(pred);
  };
  estimate(1, 1, Q01, Q00 * (change_dc ?
      (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
       3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 +
       3 * DC20 - DC21 - DC22 + DC24 + DC25) :
      (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
  estimate(2, 8, Q10, Q00 * (change_dc ?
      (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
       13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
       3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
      (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
  estimate(3, 16, Q20, Q00 * (change_dc ?
      (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
       2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
      (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
  estimate(4, 9, Q11, Q00 * (change_dc ?
      (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
      (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
       10 * DC07 - 10 * DC09)));
  estimate(5, 2, Q02, Q00 * (change_dc ?
      (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
       2 * DC17 - 5 * DC18 + 2 * DC19) :
      (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
  if (!change_dc) return;
  estimate(6, 3, Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
  estimate(7, 10, Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
  estimate(8, 17, Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
  estimate(9, 24, Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
  const int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
      6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
      152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
      6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
  int pred = static_cast<int>(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
  ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// One component's blocks through decompress_smooth_data's sliding DC
// registers (the columns clamped at the right edge), then `idct`.
template <typename Sample, typename Idct>
void smooth_component(const Decoder& d, const Component& c, Sample* plane, int stride,
                      Idct idct) {
  const int rows = std::min(c.bh, (c.dh + 7) / 8), cols = std::min(c.bw, (c.dw + 7) / 8);
  const int last_col = c.wblocks - 1, hb = c.hblocks;
  int prev_latch[10];
  for (int k = 1; k < 10; ++k) prev_latch[k] = d.scans > 1 ? c.prev_bits[k] : -1;
  auto dc_at = [&](int by, int bx) {
    return static_cast<int>(c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]);
  };
  int16_t ws[64];
  for (int by = 0; by < rows; ++by) {
    const int imcu = by / c.v;
    const int* bits = imcu > d.last_good ? prev_latch : c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    // the block row's place as jdcoefct.c reckons it from its iMCU row's
    // count of block rows (past the last real row in an iMCU row that is
    // not the last, the MCU's dummy row)
    const int block_rows = imcu + 1 < d.mcuy ? c.v : (hb % c.v ? hb % c.v : c.v);
    const int row = imcu * block_rows + by % c.v, nrows = block_rows * d.mcuy;
    const int prev = row > 0 ? by - 1 : by;
    const int pprev = row > 1 ? by - 2 : prev;
    const int next = row < nrows - 1 ? by + 1 : by;
    const int nnext = row < nrows - 2 ? by + 2 : next;
    const int rr[5] = {pprev, prev, by, next, nnext};
    int reg[5][5];
    for (int r = 0; r < 5; ++r)
      for (int k = 0; k < 5; ++k) reg[r][k] = dc_at(rr[r], 0);
    for (int bx = 0; bx < cols; ++bx) {
      std::memcpy(ws, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], sizeof(ws));
      if (bx == 0 && bx < last_col)
        for (int r = 0; r < 5; ++r) reg[r][3] = dc_at(rr[r], bx + 1);
      for (int r = 0; r < 5; ++r) reg[r][4] = dc_at(rr[r], std::min(bx + 2, last_col));
      int dcv[25];
      for (int r = 0; r < 5; ++r)
        for (int k = 0; k < 5; ++k) dcv[r * 5 + k] = reg[r][k];
      smooth_block(bits, change_dc, c.quant, dcv, ws);
      idct(ws, c.quant, plane + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
      for (int r = 0; r < 5; ++r)
        for (int k = 0; k < 4; ++k) reg[r][k] = reg[r][k + 1];
    }
  }
}

// A 12-bit frame of one component (libtiff's "I;12" greyscale) -> u16
void decode12(Decoder& d, uint16_t* out) {
  Component& c = d.comp[0];
  if (d.ncomp != 1) fail(kBroken, "a 12-bit JPEG of more than one component");
  if (!c.latched) fail(kCorrupt, "a component with no scan");
  const int w = d.width, h = d.height, stride = c.bw * 8;
  if (d.lossless) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        out[static_cast<size_t>(y) * w + x] =
            static_cast<uint16_t>((c.lossless[static_cast<size_t>(y) * c.dw + x] << c.al) & 0xFFF);
    return;
  }
  std::vector<uint16_t> plane(static_cast<size_t>(stride) * c.bh * 8);
  int rows = std::min(c.bh, (c.dh + 7) / 8), cols = std::min(c.bw, (c.dw + 7) / 8);
  if (smoothing_ok(d)) {
    smooth_component(d, c, plane.data(), stride, idct_islow12);
  } else {
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx)
        idct_islow12(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                     &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  }
  for (int y = 0; y < h; ++y)
    std::memcpy(out + static_cast<size_t>(y) * w, &plane[static_cast<size_t>(y) * stride],
                sizeof(uint16_t) * w);
}

void decode(const uint8_t* data, long n, uint8_t* out, int colour, bool pil,
            long out_size = 0) {
  Decoder d{data, static_cast<size_t>(n), pil ? kWindow : 0};
  d.pil = pil;
  d.parse();
  if (d.have_frame && d.precision == 12) {
    decode12(d, reinterpret_cast<uint16_t*>(out));
    return;
  }
  if (!d.have_frame) fail(kCorrupt, "JPEG without a frame header");
  const int w = d.width, h = d.height, nc = d.ncomp;
  if (colour == kInfer && d.lossless && (d.ncomp == 3 ? !d.rgb_source() : d.ycck_source()))
    fail(kBroken, "broken data stream when reading image file");  // JERR_CONVERSION_NOTIMPL
  std::vector<std::vector<uint8_t>> full(nc);
  const bool smooth = !d.lossless && smoothing_ok(d);
  for (int ci = 0; ci < nc; ++ci) {
    Component& c = d.comp[ci];
    if (!c.latched) fail(kCorrupt, "a component with no scan");
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
    if (d.lossless) {
      // jdlossls.c's scaler: the sample shifted back by Al, cut to 8 bits
      for (int y = 0; y < c.dh; ++y)
        for (int x = 0; x < c.dw; ++x)
          plane[static_cast<size_t>(y) * stride + x] =
              static_cast<uint8_t>(c.lossless[static_cast<size_t>(y) * c.dw + x] << c.al);
      std::vector<uint16_t>().swap(c.lossless);
    } else {
      // blocks past the component's own rows and columns are never read
      int rows = std::min(c.bh, (c.dh + 7) / 8), cols = std::min(c.bw, (c.dw + 7) / 8);
      if (smooth) {
        smooth_component(d, c, plane.data(), stride, idct_islow_simd);
      } else {
        for (int by = 0; by < rows; ++by)
          for (int bx = 0; bx < cols; ++bx)
            idct_islow_simd(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                            &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      }
      std::vector<int16_t>().swap(c.coef);
    }
    if (colour == kPlanes) {
      // raw_data_out: the component's blocks (width_in_blocks x
      // height_in_blocks), the MCU's dummy blocks left out
      const int pw = c.wblocks * 8, ph = c.hblocks * 8;
      if (static_cast<long>(pw) * ph > out_size) fail(kBadArgs, "planes buffer too small");
      for (int y = 0; y < ph; ++y)
        std::memcpy(out + static_cast<size_t>(y) * pw, &plane[static_cast<size_t>(y) * stride], pw);
      out += static_cast<size_t>(pw) * ph;
      out_size -= static_cast<long>(pw) * ph;
      continue;
    }
    if (nc == 1) {
      upsample(c, plane.data(), d.hmax, d.vmax, w, h, out, !d.lossless);
      return;
    }
    full[ci].resize(static_cast<size_t>(w) * h);
    upsample(c, plane.data(), d.hmax, d.vmax, w, h, full[ci].data(), !d.lossless);
  }
  if (colour == kPlanes) return;
  const size_t npx = static_cast<size_t>(w) * h;
  const uint8_t* p[4] = {full[0].data(), full[1].data(), full[2].data(),
                         nc == 4 ? full[3].data() : nullptr};
  bool convert = colour == kYCbCr ||
                 (colour == kInfer && (nc == 3 ? !d.rgb_source() : d.ycck_source()));
  if (!convert || nc < 3) {
    for (size_t i = 0; i < npx; ++i)
      for (int k = 0; k < nc; ++k) out[nc * i + k] = p[k][i];
    return;
  }
  // ycc_rgb_convert, or ycck_cmyk_convert: the same tables, inverted, K as
  // stored
  const int inv = nc == 4 ? 255 : 0;
  for (size_t i = 0; i < npx; ++i) {
    int y = p[0][i], cb = p[1][i], cr = p[2][i];
    out[nc * i] = static_cast<uint8_t>(inv ^ clamp8(y + kColor.cr_r[cr]));
    out[nc * i + 1] = static_cast<uint8_t>(
        inv ^ clamp8(y + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16)));
    out[nc * i + 2] = static_cast<uint8_t>(inv ^ clamp8(y + kColor.cb_b[cb]));
    if (nc == 4) out[nc * i + 3] = p[3][i];
  }
}

}  // namespace

extern "C" {

// The image's size, components (1 grey, 3 colour, 4 CMYK) and sample
// precision, as PIL's JPEG reader opens the file (`pil`) or as libjpeg
// reads a TIFF's strip for libtiff (8 or 12 bits). Returns 0 or a negative
// Status; jpeg_dec_error() says why.
int jpeg_dec_info(const uint8_t* data, long n, int* width, int* height, int* channels,
                  int* precision, int pil) {
  if (!data || n < 0 || !width || !height || !channels || !precision) return kBadArgs;
  try {
    Image im = header(data, n, pil != 0, precision);
    *width = im.width;
    *height = im.height;
    *channels = im.channels;
    return kOk;
  } catch (const Failure& f) {
    t_error = f.what;
    return f.code;
  }
}

// Decode into `out`, (height, width, channels) samples as jpeg_dec_info
// gave them (`out_size` bytes: u8, or u16 for a 12-bit frame of one
// component), colour as `colour` (a Colour) asks. With `pil`, PIL's JPEG
// reader: its SOF checks, and an arithmetic-coded scan that reads past what
// it has handed libjpeg (64 KB more at each suspension of the marker
// reader) fails as it fails there. Returns 0 or a negative Status.
int jpeg_dec_decode(const uint8_t* data, long n, uint8_t* out, long out_size, int colour,
                    int pil) {
  if (!data || n < 0 || !out || colour < kInfer || colour > kYCbCr) return kBadArgs;
  try {
    int precision = 8;
    Image im = header(data, n, pil != 0, &precision);
    if (out_size != static_cast<long>(im.width) * im.height * im.channels * (precision > 8 ? 2 : 1))
      return kBadArgs;
    decode(data, n, out, colour, pil != 0);
    return kOk;
  } catch (const Failure& f) {
    t_error = f.what;
    return f.code;
  } catch (const std::bad_alloc&) {
    t_error = "out of memory";
    return kCorrupt;
  }
}

// Each component's samples of an 8-bit DCT frame as libjpeg's raw_data_out
// gives them to libtiff's old-style JPEG codec: component by component,
// (height_in_blocks * 8) rows of (width_in_blocks * 8) u8, the blocks'
// inverse DCT as they are, into `out` (`out_size` bytes). Returns 0 or a
// negative Status.
int jpeg_dec_planes(const uint8_t* data, long n, uint8_t* out, long out_size) {
  if (!data || n < 0 || !out || out_size < 0) return kBadArgs;
  try {
    int precision = 8;
    header(data, n, false, &precision);
    if (precision != 8) fail(kBroken, "old-style JPEG of other than 8 bits");
    decode(data, n, out, kPlanes, false, out_size);
    return kOk;
  } catch (const Failure& f) {
    t_error = f.what;
    return f.code;
  } catch (const std::bad_alloc&) {
    t_error = "out of memory";
    return kCorrupt;
  }
}

// The calling thread's last failure.
const char* jpeg_dec_error() { return t_error.c_str(); }

}  // extern "C"
