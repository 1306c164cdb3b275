// JPEG decoder (ITU-T T.81, 8-bit, Huffman) for the LDR loader: the pixels
// libjpeg-turbo gives PIL's `Image.open(p)` at its defaults (JDCT_ISLOW,
// do_fancy_upsampling, no DCT scaling, out_color_space RGB, grey or CMYK).
//
//   * coding: baseline and extended sequential (SOF0, SOF1) and progressive
//     (SOF2: spectral selection, successive approximation, DC and AC first
//     scans and refinements, EOB runs), interleaved and single-component
//     scans, restart intervals, any Huffman tables (4 per class) and 8- or
//     16-bit quantization tables;
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
//   * the inverse DCT of jidctint.c (jpeg_idct_islow) with its range-limit
//     table;
//   * upsampling as jdsample.c chooses it: h2v1 and h2v2 "fancy" (triangle)
//     when the component is wider than 2 samples, h1v2 fancy, and the
//     replicating upsamplers for every other integral factor; the rows
//     above and below the component are its first and last rows, as
//     jdmainct.c's context pointers make them.
//
// PIL's JPEG reader turns away a frame of other than 8 bits or of other
// than 1, 3 or 4 components while it opens the file (kUnidentified); what
// libjpeg refuses as it decodes (fractional sampling factors, hierarchical
// frames, colour conversions of lossless data) is kBroken. What libjpeg
// would decode but this file refuses is arithmetic coding (kUnsupported).
// Truncated data and corrupt entropy-coded data raise (kTruncated,
// kCorrupt); libjpeg recovers from the latter with a warning, this file
// returns no partial image.
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
  kOk = 0, kBadArgs = -1, kTruncated = -2, kCorrupt = -3, kUnsupported = -4, kUnidentified = -5,
  kBroken = -6
};

// how the caller wants colour: as libjpeg infers it, the components as
// stored, or YCbCr -> RGB whatever the markers say
enum Colour { kInfer = 0, kRaw = 1, kYCbCr = 2 };

struct Failure {
  int code;
  std::string what;
};

thread_local std::string t_error;

[[noreturn]] void fail(int code, const std::string& what) { throw Failure{code, what}; }

// zig-zag index -> natural index, with libjpeg's 16 guard entries for the
// run lengths of corrupt data
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

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
// reader stops and supplies zeros, and consuming one of those is corrupt
// data. Running out of bytes before a marker is a truncated file.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;      // bits in acc
  int real = 0;   // of which came from the file
  int marker = -1;

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
    if (k > real) fail(kCorrupt, "corrupt JPEG data: premature end of data segment");
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
    if (n < 16) fill();
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
      if (l > 16) fail(kCorrupt, "corrupt JPEG data: bad Huffman code");
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
  std::vector<int16_t> coef;
  std::vector<uint16_t> lossless;  // a lossless frame's undifferenced samples (dw x dh)
  int al = 0;                       // and its point transform
};

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, lossless = false, have_frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int eob_run = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];

  uint8_t byte() {
    if (pos >= size) fail(kTruncated, "image file is truncated");
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
    return start;
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
    int precision = data[s];
    height = (data[s + 1] << 8) | data[s + 2];
    width = (data[s + 3] << 8) | data[s + 4];
    ncomp = data[s + 5];
    if (precision != 8)
      fail(kUnidentified, "cannot handle " + std::to_string(precision) + "-bit layers");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(kUnidentified, "cannot handle " + std::to_string(ncomp) + "-layer images");
    if (header_only) {
      have_frame = true;
      return;
    }
    if (marker >= 0xC9 && marker <= 0xCB) fail(kUnsupported, "arithmetic-coded JPEG");
    if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD)
      fail(kBroken, "broken data stream when reading image file");
    if (height == 0) fail(kCorrupt, "JPEG height 0 (DNL) not supported");
    if (width == 0) fail(kCorrupt, "empty JPEG image");
    if (len != 6 + 3 * ncomp) fail(kCorrupt, "bad SOF length");
    progressive = marker == 0xC2;
    lossless = marker == 0xC3;
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
      if (td[i] > 3 || ta[i] > 3) fail(kCorrupt, "bad Huffman table selector");
    }
    int ss = data[s + 1 + 2 * ns], se = data[s + 2 + 2 * ns];
    int ah = data[s + 3 + 2 * ns] >> 4, al = data[s + 3 + 2 * ns] & 15;
    if (lossless) {
      // jdlhuff.c start_pass_lhuff_decoder: Ss is the predictor, Al the
      // point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        fail(kBroken, "broken data stream when reading image file");
      for (int i = 0; i < ns; ++i) {
        if (!dc[td[i]].defined) fail(kCorrupt, "Huffman table not defined");
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
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0 && (!progressive || ss > 0);
      if (need_dc && !dc[td[i]].defined) fail(kCorrupt, "Huffman table not defined");
      if (need_dc && dc[td[i]].maxsym > 15) fail(kCorrupt, "bad Huffman table");
      if (need_ac && !ac[ta[i]].defined) fail(kCorrupt, "Huffman table not defined");
    }
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; ++i) blocks_per_mcu += sc[i]->h * sc[i]->v;
    if (ns > 1 && blocks_per_mcu > 10) fail(kCorrupt, "too many blocks in an MCU");

    Bits bits{data + pos, data + size};
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
    for (long m = 0; m < mcus; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        read_restart(bits, &next_rst);
        for (int i = 0; i < 4; ++i) pred[i] = 0;
        eob_run = 0;
      }
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

  // resume header parsing at the marker that ended the segment (its 0xFF
  // is the byte before its code)
  void resume(const Bits& bits) {
    if (bits.marker >= 0) {
      pos = static_cast<size_t>(bits.p - data) - 2;
    } else {
      pos = static_cast<size_t>(bits.p - data);
    }
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
            row[0] = static_cast<uint16_t>((df[0] + (1 << (7 - al))) & 0xFFFF);
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
        case 0xDC:
          fail(kCorrupt, "DNL marker is not supported");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;  // a stray RSTn: libjpeg skips it
          if (m == 0x01) break;                // TEM has no length
          if ((m & 0xF0) == 0xE0) {
            read_app(m);
          } else {
            int len;
            segment(&len);
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

// jidctint.c jpeg_idct_islow, with its range-limit table
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i : i - 1024;
      v += 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
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
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      std::memset(o, v, 8);
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
    o[0] = kRange.t[static_cast<int>(descale(t10 + tmp3, sh)) & 1023];
    o[7] = kRange.t[static_cast<int>(descale(t10 - tmp3, sh)) & 1023];
    o[1] = kRange.t[static_cast<int>(descale(t11 + tmp2, sh)) & 1023];
    o[6] = kRange.t[static_cast<int>(descale(t11 - tmp2, sh)) & 1023];
    o[2] = kRange.t[static_cast<int>(descale(t12 + tmp1, sh)) & 1023];
    o[5] = kRange.t[static_cast<int>(descale(t12 - tmp1, sh)) & 1023];
    o[3] = kRange.t[static_cast<int>(descale(t13 + tmp0, sh)) & 1023];
    o[4] = kRange.t[static_cast<int>(descale(t13 - tmp0, sh)) & 1023];
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

Image header(const uint8_t* data, long n) {
  Decoder d{data, static_cast<size_t>(n)};
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
  return Image{d.width, d.height, d.ncomp};
}

void decode(const uint8_t* data, long n, uint8_t* out, int colour) {
  Decoder d{data, static_cast<size_t>(n)};
  d.parse();
  if (!d.have_frame) fail(kCorrupt, "JPEG without a frame header");
  const int w = d.width, h = d.height, nc = d.ncomp;
  if (colour == kInfer && d.lossless && (d.ncomp == 3 ? !d.rgb_source() : d.ycck_source()))
    fail(kBroken, "broken data stream when reading image file");  // JERR_CONVERSION_NOTIMPL
  std::vector<std::vector<uint8_t>> full(nc);
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
      for (int by = 0; by < rows; ++by)
        for (int bx = 0; bx < cols; ++bx)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                     &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      std::vector<int16_t>().swap(c.coef);
    }
    if (nc == 1) {
      upsample(c, plane.data(), d.hmax, d.vmax, w, h, out, !d.lossless);
      return;
    }
    full[ci].resize(static_cast<size_t>(w) * h);
    upsample(c, plane.data(), d.hmax, d.vmax, w, h, full[ci].data(), !d.lossless);
  }
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

// The image's size and components (1 grey, 3 colour, 4 CMYK), as PIL's
// JPEG reader opens the file. Returns 0 or a negative Status;
// jpeg_dec_error() says why.
int jpeg_dec_info(const uint8_t* data, long n, int* width, int* height, int* channels) {
  if (!data || n < 0 || !width || !height || !channels) return kBadArgs;
  try {
    Image im = header(data, n);
    *width = im.width;
    *height = im.height;
    *channels = im.channels;
    return kOk;
  } catch (const Failure& f) {
    t_error = f.what;
    return f.code;
  }
}

// Decode into `out`, (height, width, channels) u8 as jpeg_dec_info gave
// them (`out_size` bytes), colour as `colour` (a Colour) asks. Returns 0 or
// a negative Status.
int jpeg_dec_decode(const uint8_t* data, long n, uint8_t* out, long out_size, int colour) {
  if (!data || n < 0 || !out || colour < kInfer || colour > kYCbCr) return kBadArgs;
  try {
    Image im = header(data, n);
    if (out_size != static_cast<long>(im.width) * im.height * im.channels) return kBadArgs;
    decode(data, n, out, colour);
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
