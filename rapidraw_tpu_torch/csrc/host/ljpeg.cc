// Lossless JPEG (ITU-T T.81 process 14, SOF3) decoder for DNG raw tiles.
//
// The reference decodes Compression=7 DNGs through its Rust rawler fork
// (raw_processing.rs:15-30 -> rawler's ljpeg92 module); this is a fresh
// C++ implementation of the same wire format, exposed over a C ABI and
// loaded via ctypes (no pybind11 in the image).
//
// Scope: baseline lossless scans as emitted by DNG writers —
//   * SOF3 frame, 2-16 bit precision, 1-4 components,
//   * one SOS covering all components, predictors 1-7, point transform,
//   * byte-stuffed (0xFF 0x00) entropy stream, DNU markers skipped.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t bits = 0;   // left-aligned buffer
  int nbits = 0;
  bool bad = false;

  BitReader(const uint8_t* data, const uint8_t* stop) : p(data), end(stop) {}

  void fill() {
    while (nbits <= 24) {
      if (p >= end) {
        // past the end: feed zeros (trailing pad bits are 1s per spec, but
        // a well-formed stream never reads past its own payload)
        bits |= 0u << (24 - nbits);
        nbits += 8;
        continue;
      }
      uint8_t b = *p++;
      if (b == 0xFF) {
        if (p < end && *p == 0x00) {
          ++p;  // byte stuffing
        } else {
          // a real marker: stop consuming, feed zeros
          --p;
          b = 0;
          bits |= uint32_t(b) << (24 - nbits);
          nbits += 8;
          continue;
        }
      }
      bits |= uint32_t(b) << (24 - nbits);
      nbits += 8;
    }
  }

  // read n bits (n <= 16)
  uint32_t get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    uint32_t v = bits >> (32 - n);
    bits <<= n;
    nbits -= n;
    return v;
  }

  uint32_t peek16() {
    if (nbits < 16) fill();
    return bits >> 16;
  }

  void drop(int n) {
    bits <<= n;
    nbits -= n;
  }
};

// Huffman table expanded into a 16-bit lookup: for each 16-bit prefix,
// (value, code length). DC tables have <= 17 symbols so this is tiny to
// build and O(1) to decode.
struct Huff {
  uint8_t len[1 << 16];
  uint8_t val[1 << 16];
  bool ok = false;

  // Returns false for non-canonical tables (over-subscribed prefix space):
  // an attacker-controlled DHT with e.g. counts[0] = 255 would otherwise
  // drive `code << (16 - l)` past 1 << 16 and write out of bounds.
  bool build(const uint8_t counts[16], const uint8_t* symbols) {
    uint32_t code = 0;
    int k = 0;
    std::memset(len, 0, sizeof(len));
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i) {
        if (code >= (1u << l)) return false;  // canonical-code overflow
        uint32_t lo = code << (16 - l);
        uint32_t hi = lo + (1u << (16 - l));
        for (uint32_t c = lo; c < hi; ++c) {
          len[c] = uint8_t(l);
          val[c] = symbols[k];
        }
        ++code;
        ++k;
      }
      code <<= 1;
    }
    ok = true;
    return true;
  }
};

inline int32_t extend(uint32_t v, int ssss) {
  // ITU T.81 F.2.2.1 EXTEND
  if (ssss == 0) return 0;
  if (ssss == 16) return -32768;  // DNG/lossless convention: 32768 diff
  if (v < (1u << (ssss - 1))) return int32_t(v) - (1 << ssss) + 1;
  return int32_t(v);
}

inline uint16_t rd16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }

}  // namespace

extern "C" {

// Decodes one lossless-JPEG stream.
//   data/len : the complete stream (SOI..EOI)
//   out      : caller buffer of out_cap uint16 samples
//   out_w/out_h/out_comps : decoded geometry (per-component width)
// Returns 0 on success, negative error codes otherwise:
//   -1 malformed stream   -2 unsupported feature   -3 buffer too small
int ljpeg_decode(const uint8_t* data, long length, uint16_t* out, long out_cap,
                 int* out_w, int* out_h, int* out_comps) {
  const uint8_t* p = data;
  const uint8_t* end = data + length;
  if (length < 4 || rd16(p) != 0xFFD8) return -1;
  p += 2;

  Huff tables[4];
  int precision = 0, height = 0, width = 0, ncomp = 0;
  int comp_dc[4] = {0, 0, 0, 0};
  int predictor = 1, pt = 0;
  const uint8_t* scan = nullptr;

  while (p + 4 <= end) {
    if (p[0] != 0xFF) return -1;
    int marker = p[1];
    p += 2;
    if (marker == 0xD8) continue;           // stray SOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (p + 2 > end) return -1;
    int seglen = rd16(p);
    if (p + seglen > end || seglen < 2) return -1;
    const uint8_t* seg = p + 2;
    int segbytes = seglen - 2;

    if (marker == 0xC3) {  // SOF3: lossless frame
      if (segbytes < 6) return -1;
      precision = seg[0];
      height = rd16(seg + 1);
      width = rd16(seg + 3);
      ncomp = seg[5];
      if (ncomp < 1 || ncomp > 4) return -2;
      if (precision < 2 || precision > 16) return -2;
      if (segbytes < 6 + 3 * ncomp) return -1;
      for (int c = 0; c < ncomp; ++c) {
        int hv = seg[6 + 3 * c + 1];
        if (hv != 0x11) return -2;  // subsampled lossless not used by DNG
      }
    } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
               marker != 0xC8 && marker != 0xCC) {
      return -2;  // some other (lossy) frame type
    } else if (marker == 0xC4) {  // DHT
      const uint8_t* q = seg;
      while (q + 17 <= seg + segbytes) {
        int tc_th = *q++;
        int tc = tc_th >> 4, th = tc_th & 15;
        uint8_t counts[16];
        int total = 0;
        for (int i = 0; i < 16; ++i) {
          counts[i] = q[i];
          total += q[i];
        }
        q += 16;
        if (q + total > seg + segbytes) return -1;
        if (tc == 0 && th < 4) {
          if (!tables[th].build(counts, q)) return -1;
        }
        q += total;
      }
    } else if (marker == 0xDA) {  // SOS
      if (segbytes < 1) return -1;
      int ns = seg[0];
      if (ns != ncomp || segbytes < 1 + 2 * ns + 3) return -2;
      for (int c = 0; c < ns; ++c) {
        comp_dc[c] = seg[1 + 2 * c + 1] >> 4;
        if (comp_dc[c] > 3 || !tables[comp_dc[c]].ok) return -1;
      }
      predictor = seg[1 + 2 * ns];      // Ss
      pt = seg[1 + 2 * ns + 2] & 15;    // Al = point transform
      if (predictor < 1 || predictor > 7) return -2;
      scan = p + seglen;
      break;
    }
    p += seglen;
  }

  if (!scan || !width || !height || !ncomp) return -1;
  long need = long(width) * height * ncomp;
  if (need > out_cap) return -3;
  *out_w = width;
  *out_h = height;
  *out_comps = ncomp;

  BitReader br(scan, end);
  const int default_pred = 1 << (precision - 1 - pt);
  const int rowstride = width * ncomp;
  const int maxval = 0xFFFF;

  for (int y = 0; y < height; ++y) {
    uint16_t* row = out + long(y) * rowstride;
    const uint16_t* prev = row - rowstride;
    for (int x = 0; x < width; ++x) {
      for (int c = 0; c < ncomp; ++c) {
        const Huff& h = tables[comp_dc[c]];
        uint32_t prefix = br.peek16();
        int l = h.len[prefix];
        if (l == 0) return -1;
        br.drop(l);
        int ssss = h.val[prefix];
        if (ssss > 16) return -1;
        int32_t diff = extend(br.get(ssss > 15 ? 0 : ssss), ssss);

        int32_t pred;
        if (y == 0 && x == 0) {
          pred = default_pred;
        } else if (y == 0) {
          pred = row[(x - 1) * ncomp + c];  // only Ra exists
        } else if (x == 0) {
          pred = prev[c];  // first column predicts from Rb
        } else {
          int32_t ra = row[(x - 1) * ncomp + c];
          int32_t rb = prev[x * ncomp + c];
          int32_t rc = prev[(x - 1) * ncomp + c];
          switch (predictor) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            case 7: pred = (ra + rb) >> 1; break;
            default: return -2;
          }
        }
        int32_t v = (pred + diff) & maxval;
        row[x * ncomp + c] = uint16_t(v);
      }
    }
  }

  if (pt > 0) {  // undo point transform (values were scaled down)
    for (long i = 0; i < need; ++i) out[i] = uint16_t(out[i] << pt);
  }
  return 0;
}

}  // extern "C"
