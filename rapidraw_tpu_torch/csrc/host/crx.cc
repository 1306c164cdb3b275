// crx-class codec for Canon CR3 raw payloads (lossless path).
//
// The reference decodes CR3 through rawler's crx implementation
// (src-tauri/Cargo.toml:27, raw_processing.rs:15-30).
// Canon never published the format; everything known is reverse
// engineering (libraw's crx.cpp, dnglab's crx module and its write-ups).
// This module implements the publicly documented *structure* of the
// lossless codec from scratch:
//
//   sample  := tile(0xff01) { plane(0xff02) { band(0xff03) payload } }
//   payload := MSB-first bitstream of adaptive Golomb-Rice coded,
//              MED-predicted residuals, one line at a time, per CFA
//              subplane (4 planes at half resolution for RGGB).
//
// Field packing beyond the marker+size scheme and the exact entropy
// details (K adaptation constants, run mode) are NOT verifiable offline —
// no real CR3 sample and no rawler source were at hand when it was written — so
// headers are validated strictly and any mismatch returns an error; the
// Python caller (io/cr3.py) then falls back to its precise refusal with
// the embedded PRVW preview still served. Round-trip conformance against
// this module's own encoder is pinned by tests/test_crx.py; bit-exact
// conformance with Canon's encoder is documented as pending real-sample
// validation.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxK = 24;
constexpr int kEscapeQ = 40;   // unary quotients beyond this use a raw escape
constexpr int kAdaptReset = 64;

// ------------------------------------------------------------ bit streams

struct BitReader {
  const uint8_t* p;
  long long size;
  long long byte = 0;
  int bit = 0;  // next bit index (MSB-first) within p[byte]
  bool overrun = false;

  int read1() {
    if (byte >= size) {
      overrun = true;
      return 0;
    }
    int v = (p[byte] >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
    return v;
  }

  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | (uint32_t)read1();
    return v;
  }
};

struct BitWriter {
  uint8_t* p;
  long long cap;
  long long byte = 0;
  int bit = 0;
  bool overrun = false;

  void write1(int v) {
    if (byte >= cap) {
      overrun = true;
      return;
    }
    if (bit == 0) p[byte] = 0;
    if (v) p[byte] |= (uint8_t)(1u << (7 - bit));
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
  }

  void write(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) write1((int)((v >> i) & 1u));
  }

  long long flush() {
    if (bit != 0) {
      ++byte;
      bit = 0;
    }
    return byte;
  }
};

// ------------------------------------------------- adaptive Golomb-Rice

struct Adapt {
  uint32_t a = 4;  // running magnitude sum (small prior avoids k=0 bursts)
  uint32_t n = 1;

  int k() const {
    int k = 0;
    while (k < kMaxK && ((uint64_t)n << k) < a) ++k;
    return k;
  }

  void update(uint32_t u) {
    a += u;
    n += 1;
    if (n >= kAdaptReset) {
      a >>= 1;
      n >>= 1;
      if (n == 0) n = 1;
    }
  }
};

inline uint32_t rice_decode(BitReader& br, int k) {
  int q = 0;
  while (br.read1() == 0) {
    if (br.overrun) return 0;
    if (++q > kEscapeQ) {  // 41 zeros = escape form: consume the 1, raw 32
      br.read1();
      return br.read(32);
    }
  }
  return ((uint32_t)q << k) | br.read(k);
}

inline void rice_encode(BitWriter& bw, int k, uint32_t u) {
  uint32_t q = u >> k;
  if (q > (uint32_t)kEscapeQ) {
    for (int i = 0; i <= kEscapeQ; ++i) bw.write1(0);
    bw.write1(1);
    bw.write(u, 32);
    return;
  }
  for (uint32_t i = 0; i < q; ++i) bw.write1(0);
  bw.write1(1);
  bw.write(u, k);
}

inline int32_t med(int32_t a, int32_t b, int32_t c) {
  // JPEG-LS median edge detector
  int32_t mx = a > b ? a : b;
  int32_t mn = a < b ? a : b;
  if (c >= mx) return mn;
  if (c <= mn) return mx;
  return a + b - c;
}

inline uint32_t zigzag(int32_t v) {
  return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
}

inline int32_t unzigzag(uint32_t u) {
  return (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
}

// 16-byte big-endian headers: u16 marker, u16 index, u32 payload size,
// u32 param, u32 reserved.
inline void put_hdr(uint8_t* p, uint16_t marker, uint16_t idx, uint32_t size,
                    uint32_t param) {
  p[0] = (uint8_t)(marker >> 8);
  p[1] = (uint8_t)marker;
  p[2] = (uint8_t)(idx >> 8);
  p[3] = (uint8_t)idx;
  p[4] = (uint8_t)(size >> 24);
  p[5] = (uint8_t)(size >> 16);
  p[6] = (uint8_t)(size >> 8);
  p[7] = (uint8_t)size;
  p[8] = (uint8_t)(param >> 24);
  p[9] = (uint8_t)(param >> 16);
  p[10] = (uint8_t)(param >> 8);
  p[11] = (uint8_t)param;
  p[12] = p[13] = p[14] = p[15] = 0;
}

inline bool get_hdr(const uint8_t* p, long long avail, uint16_t want,
                    uint16_t* idx, uint32_t* size, uint32_t* param) {
  if (avail < 16) return false;
  uint16_t marker = (uint16_t)((p[0] << 8) | p[1]);
  if (marker != want) return false;
  *idx = (uint16_t)((p[2] << 8) | p[3]);
  *size = ((uint32_t)p[4] << 24) | ((uint32_t)p[5] << 16) |
          ((uint32_t)p[6] << 8) | (uint32_t)p[7];
  *param = ((uint32_t)p[8] << 24) | ((uint32_t)p[9] << 16) |
           ((uint32_t)p[10] << 8) | (uint32_t)p[11];
  return true;
}

// one band: MED-predicted, zigzag-mapped, adaptive-Rice line coding
bool decode_band(const uint8_t* data, long long size, int pw, int ph,
                 uint16_t* out) {
  BitReader br{data, size};
  Adapt ad;
  for (int y = 0; y < ph; ++y) {
    uint16_t* cur = out + (long long)y * pw;
    const uint16_t* prev = y > 0 ? cur - pw : nullptr;
    for (int x = 0; x < pw; ++x) {
      int32_t a = x > 0 ? cur[x - 1] : (prev ? prev[0] : 0);
      int32_t b = prev ? prev[x] : a;
      int32_t c = (x > 0 && prev) ? prev[x - 1] : b;
      uint32_t u = rice_decode(br, ad.k());
      if (br.overrun) return false;
      cur[x] = (uint16_t)(med(a, b, c) + unzigzag(u));
      ad.update(u);
    }
  }
  return true;
}

long long encode_band(const uint16_t* in, int pw, int ph, uint8_t* out,
                      long long cap) {
  BitWriter bw{out, cap};
  Adapt ad;
  for (int y = 0; y < ph; ++y) {
    const uint16_t* cur = in + (long long)y * pw;
    const uint16_t* prev = y > 0 ? cur - pw : nullptr;
    for (int x = 0; x < pw; ++x) {
      int32_t a = x > 0 ? cur[x - 1] : (prev ? prev[0] : 0);
      int32_t b = prev ? prev[x] : a;
      int32_t c = (x > 0 && prev) ? prev[x - 1] : b;
      uint32_t u = zigzag((int32_t)cur[x] - med(a, b, c));
      rice_encode(bw, ad.k(), u);
      if (bw.overrun) return -1;
      ad.update(u);
    }
  }
  return bw.flush();
}

}  // namespace

extern "C" {

// Decode one crx tile sample into planar out[planes][ph*pw].
// Returns 0, or a negative error: -1 args, -2 tile header, -3 plane
// header, -4 band header, -5 bitstream, -6 size mismatch.
int crx_decode(const uint8_t* data, long long size, int planes, int pw,
               int ph, uint16_t* out) {
  if (!data || !out || planes < 1 || planes > 4 || pw < 1 || ph < 1)
    return -1;
  uint16_t idx;
  uint32_t tsize, param;
  if (!get_hdr(data, size, 0xff01, &idx, &tsize, &param)) return -2;
  long long pos = 16;
  if ((long long)tsize + 16 > size) return -6;
  for (int pi = 0; pi < planes; ++pi) {
    uint32_t psize, bsize;
    if (!get_hdr(data + pos, size - pos, 0xff02, &idx, &psize, &param))
      return -3;
    if (idx != (uint16_t)pi) return -3;
    pos += 16;
    long long plane_end = pos + psize;
    if (plane_end > size) return -6;
    if (!get_hdr(data + pos, size - pos, 0xff03, &idx, &bsize, &param))
      return -4;
    pos += 16;
    if (pos + bsize > (unsigned long long)size) return -6;
    if (!decode_band(data + pos, bsize, pw, ph, out + (long long)pi * pw * ph))
      return -5;
    pos = plane_end;
  }
  return 0;
}

// Encode planar in[planes][ph*pw] as one crx tile sample. Returns bytes
// written or a negative error (-1 args, -2 capacity).
long long crx_encode(const uint16_t* in, int planes, int pw, int ph,
                     uint8_t* out, long long cap) {
  if (!in || !out || planes < 1 || planes > 4 || pw < 1 || ph < 1) return -1;
  long long pos = 16;  // tile header patched at the end
  for (int pi = 0; pi < planes; ++pi) {
    if (pos + 32 > cap) return -2;
    long long band_pos = pos + 32;  // plane hdr + band hdr
    long long n = encode_band(in + (long long)pi * pw * ph, pw, ph,
                              out + band_pos, cap - band_pos);
    if (n < 0) return -2;
    put_hdr(out + pos, 0xff02, (uint16_t)pi, (uint32_t)(n + 16), 0);
    put_hdr(out + pos + 16, 0xff03, 0, (uint32_t)n, 0);
    pos = band_pos + n;
  }
  put_hdr(out, 0xff01, 0, (uint32_t)(pos - 16), 0);
  return pos;
}

}  // extern "C"
