// Zstandard decoder (RFC 8878) for the TIFF reader's ZSTD strips and tiles
// (compression 50000), as libtiff's tif_zstd.c reads them for PIL: one
// ZSTD_decompressStream loop over the chunk, which ends with the first
// frame (a skippable frame included) or once the output is full.
//
//   * frames: the header (single-segment frames, window sizes up to
//     libzstd's default limit of 2^27 bytes, frame content sizes, no
//     dictionary: a frame naming one fails as libzstd fails it), raw, RLE
//     and compressed blocks (at most 128 KiB each), the XXH64 content
//     checksum checked when the frame is decoded to its end;
//   * literals: raw, RLE, Huffman-compressed in one or four streams (the
//     tree's weights direct or FSE-compressed) and treeless, which reuses
//     the frame's last tree;
//   * sequences: predefined, RLE, FSE-compressed and repeated tables for
//     literal lengths, match lengths and offsets; the three repeat offsets.
//
// A decoder error (corrupt data, a match before the start of the frame, a
// checksum that differs) returns an error code; libtiff zeroes the strip
// and reports it, and PIL raises.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = -1, kBadArgs = -2, kTooLarge = -3, kChecksum = -4, kDict = -5 };

struct Error {
  int code;
};

[[noreturn]] void fail(int code = kCorrupt) { throw Error{code}; }

inline uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}
inline uint64_t le64(const uint8_t* p) {
  return static_cast<uint64_t>(le32(p)) | static_cast<uint64_t>(le32(p + 4)) << 32;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---- XXH64 ----------------------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (static_cast<uint64_t>(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit streams ----------------------------------------------------------------------------

// A backward bit stream (RFC 8878 4.1): read from its last byte, whose
// highest set bit marks the start, towards its first. `bits` counts what is
// left; reading past the first byte gives zeros and leaves it negative.
struct BackBits {
  const uint8_t* src;
  int64_t bits;
  int64_t limit;  // the stream's bytes
  BackBits(const uint8_t* s, size_t n) : src(s), limit(static_cast<int64_t>(n)) {
    if (n == 0 || s[n - 1] == 0) fail();
    bits = static_cast<int64_t>(n) * 8 - 8 + highbit(s[n - 1]);
  }
  uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t p = bits - n;
    int shift = 0;
    if (p < 0) {
      shift = static_cast<int>(-p);
      p = 0;
      if (shift >= n) return 0;
    }
    const int take = n - shift;
    const int64_t b0 = p >> 3;
    uint64_t v;
    if (take <= 56 && b0 + 8 <= limit) {
      std::memcpy(&v, src + b0, 8);  // little-endian hosts
    } else {
      v = 0;
      for (int64_t b = (p + take - 1) >> 3; b >= b0; --b) v = (v << 8) | src[b];
    }
    v >>= (p & 7);
    v &= (take == 64) ? ~0ULL : ((1ULL << take) - 1);
    return v << shift;
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    bits -= n;
    return v;
  }
};

// ---- FSE --------------------------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// FSE_buildDTable from normalized counts (-1: "less than one")
void build_fse(const int16_t* counts, int nsym, int log, FseTable* out) {
  const int size = 1 << log;
  out->log = log;
  out->t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (counts[s] == -1) {
      out->t[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(counts[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      out->t[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail();
  for (int u = 0; u < size; ++u) {
    FseEntry& e = out->t[u];
    uint32_t ns = next[e.symbol]++;
    e.nbits = static_cast<uint8_t>(log - highbit(ns));
    e.base = static_cast<uint16_t>((ns << e.nbits) - size);
  }
}

// FSE_readNCount: a table description at the start of `p` (forward, little
// endian bits); returns the bytes it used
size_t read_fse(const uint8_t* p, size_t n, int max_sym, int max_log, FseTable* out) {
  if (n < 1) fail();
  uint64_t pos = 0;  // in bits
  auto bit = [&](int k) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      uint64_t q = pos + i;
      if ((q >> 3) >= n) fail();
      v |= static_cast<uint32_t>((p[q >> 3] >> (q & 7)) & 1) << i;
    }
    return v;
  };
  const int log = static_cast<int>(bit(4)) + 5;
  pos += 4;
  if (log > max_log) fail();
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int16_t counts[256];
  int s = 0;
  while (remaining > 1 && s <= max_sym) {
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = bit(nbits - 1);
    if (static_cast<int>(low) < max) {
      count = static_cast<int>(low);
      pos += nbits - 1;
    } else {
      count = static_cast<int>(bit(nbits));
      if (count >= threshold) count -= max;
      pos += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts[s++] = static_cast<int16_t>(count);
    if (count == 0) {
      for (;;) {
        uint32_t rep = bit(2);
        pos += 2;
        for (uint32_t r = 0; r < rep; ++r) {
          if (s > max_sym) fail();
          counts[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || s > max_sym + 1) fail();
  build_fse(counts, s, log, out);
  return static_cast<size_t>((pos + 7) >> 3);
}

// ---- Huffman ----------------------------------------------------------------------------------

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;  // indexed by the next max_bits bits
};

// the tree description (RFC 8878 4.2.1); returns the bytes it used
size_t read_huffman(const uint8_t* p, size_t n, Huffman* h) {
  if (n < 1) fail();
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  const int head = p[0];
  if (head >= 128) {
    nw = head - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) fail();
    for (int i = 0; i < nw; ++i)
      weights[i] = static_cast<uint8_t>(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
  } else {
    used = 1 + static_cast<size_t>(head);
    if (used > n || head == 0) fail();
    FseTable t;
    size_t desc = read_fse(p + 1, head, 255, 6, &t);
    if (desc >= static_cast<size_t>(head)) fail();
    BackBits b(p + 1 + desc, head - desc);
    uint32_t s1 = static_cast<uint32_t>(b.read(t.log)), s2 = static_cast<uint32_t>(b.read(t.log));
    for (;;) {
      if (nw > 253) fail();
      const FseEntry& e1 = t.t[s1];
      weights[nw++] = static_cast<uint8_t>(e1.symbol);
      s1 = e1.base + static_cast<uint32_t>(b.read(e1.nbits));
      if (b.bits < 0) {
        weights[nw++] = static_cast<uint8_t>(t.t[s2].symbol);
        break;
      }
      if (nw > 253) fail();
      const FseEntry& e2 = t.t[s2];
      weights[nw++] = static_cast<uint8_t>(e2.symbol);
      s2 = e2.base + static_cast<uint32_t>(b.read(e2.nbits));
      if (b.bits < 0) {
        weights[nw++] = static_cast<uint8_t>(t.t[s1].symbol);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail();
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail();
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail();
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail();
  weights[nw++] = static_cast<uint8_t>(highbit(rest) + 1);
  h->max_bits = max_bits;
  h->sym.assign(1u << max_bits, 0);
  h->nbits.assign(1u << max_bits, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      const uint32_t span = 1u << (w - 1);
      std::memset(&h->sym[pos], s, span);
      std::memset(&h->nbits[pos], max_bits + 1 - w, span);
      pos += span;
    }
  }
  if (pos != (1u << max_bits)) fail();
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits b(p, n);
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = static_cast<uint32_t>(b.peek(h.max_bits));
    out[i] = h.sym[v];
    b.bits -= h.nbits[v];
    if (b.bits < 0) fail();
  }
  if (b.bits != 0) fail();
}

// ---- sequences --------------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  std::vector<uint8_t> out;  // the frame's content so far
  Huffman huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  size_t window = 0;
};

// one sequence table of a compressed block: its mode, and the bytes used
size_t read_table(int mode, const uint8_t* p, size_t n, const int16_t* def, int def_n,
                  int def_log, int max_sym, int max_log, FseTable* t, bool* have) {
  switch (mode) {
    case 0:
      build_fse(def, def_n, def_log, t);
      *have = true;
      return 0;
    case 1: {
      if (n < 1 || p[0] > max_sym) fail();
      t->log = 0;
      t->t.assign(1, FseEntry{p[0], 0, 0});
      *have = true;
      return 1;
    }
    case 2: {
      size_t used = read_fse(p, n, max_sym, max_log, t);
      *have = true;
      return used;
    }
    default:
      if (!*have) fail();
      return 0;
  }
}

void compressed_block(Frame& f, const uint8_t* p, size_t n) {
  // literals section
  if (n < 1) fail();
  const int ltype = p[0] & 3, lfmt = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (ltype < 2) {
    if (lfmt == 0 || lfmt == 2) {
      regen = p[0] >> 3;
      hdr = 1;
    } else if (lfmt == 1) {
      if (n < 2) fail();
      regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) fail();
      regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4) + (static_cast<size_t>(p[2]) << 12);
      hdr = 3;
    }
  } else {
    if (lfmt <= 1) {
      if (n < 3) fail();
      uint32_t v = p[0] | p[1] << 8 | p[2] << 16;
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
      hdr = 3;
      streams = lfmt == 0 ? 1 : 4;
    } else if (lfmt == 2) {
      if (n < 4) fail();
      uint32_t v = le32(p);
      regen = (v >> 4) & 0x3FFF;
      csize = v >> 18;
      hdr = 4;
      streams = 4;
    } else {
      if (n < 5) fail();
      uint32_t v = le32(p);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) | (static_cast<size_t>(p[4]) << 10);
      hdr = 5;
      streams = 4;
    }
  }
  if (regen > (128 << 10)) fail();
  std::vector<uint8_t> lit(regen);
  size_t at = hdr;
  if (ltype == 0) {
    if (at + regen > n) fail();
    if (regen) std::memcpy(lit.data(), p + at, regen);
    at += regen;
  } else if (ltype == 1) {
    if (at + 1 > n) fail();
    if (regen) std::memset(lit.data(), p[at], regen);
    at += 1;
  } else {
    if (at + csize > n) fail();
    const uint8_t* q = p + at;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = read_huffman(q, qn, &f.huf);
      f.have_huf = true;
      q += used;
      qn -= used;
    } else if (!f.have_huf) {
      fail();
    }
    if (streams == 1) {
      huffman_stream(f.huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 10 || regen < 6) fail();  // a jump table and a byte a stream
      size_t s1 = q[0] | q[1] << 8, s2 = q[2] | q[3] << 8, s3 = q[4] | q[5] << 8;
      if (6 + s1 + s2 + s3 > qn) fail();
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      const uint8_t* r = q + 6;
      huffman_stream(f.huf, r, s1, lit.data(), seg);
      huffman_stream(f.huf, r + s1, s2, lit.data() + seg, seg);
      huffman_stream(f.huf, r + s1 + s2, s3, lit.data() + 2 * seg, seg);
      if (regen < 3 * seg) fail();
      huffman_stream(f.huf, r + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
    at += csize;
  }
  // sequences section
  if (at >= n) fail();
  size_t nseq = p[at++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (at >= n) fail();
      nseq = ((nseq - 128) << 8) + p[at++];
    } else {
      if (at + 2 > n) fail();
      nseq = p[at] + (static_cast<size_t>(p[at + 1]) << 8) + 0x7F00;
      at += 2;
    }
  }
  size_t lpos = 0;
  if (nseq == 0) {
    if (at != n) fail();
    f.out.insert(f.out.end(), lit.begin(), lit.end());
    return;
  }
  if (at >= n) fail();
  const int modes = p[at++];
  if (modes & 3) fail();
  at += read_table(modes >> 6, p + at, n - at, kLLDefault, 36, 6, 35, 9, &f.ll, &f.have_ll);
  if (at > n) fail();
  at += read_table((modes >> 4) & 3, p + at, n - at, kOFDefault, 29, 5, 31, 8, &f.of, &f.have_of);
  if (at > n) fail();
  at += read_table((modes >> 2) & 3, p + at, n - at, kMLDefault, 53, 6, 52, 9, &f.ml, &f.have_ml);
  if (at >= n) fail();
  BackBits b(p + at, n - at);
  uint32_t sll = static_cast<uint32_t>(b.read(f.ll.log));
  uint32_t sof = static_cast<uint32_t>(b.read(f.of.log));
  uint32_t sml = static_cast<uint32_t>(b.read(f.ml.log));
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& eo = f.of.t[sof];
    const FseEntry& em = f.ml.t[sml];
    const FseEntry& el = f.ll.t[sll];
    const int ocode = eo.symbol;
    if (ocode > 31 || em.symbol > 52 || el.symbol > 35) fail();
    uint64_t offval = (1ULL << ocode) + b.read(ocode);
    size_t ml = kMLBase[em.symbol] + static_cast<size_t>(b.read(kMLBits[em.symbol]));
    size_t ll = kLLBase[el.symbol] + static_cast<size_t>(b.read(kLLBits[el.symbol]));
    if (b.bits < 0) fail();
    uint64_t offset;
    if (offval > 3) {
      offset = offval - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = static_cast<uint32_t>(offset);
    } else {
      int idx = static_cast<int>(offval) - (ll == 0 ? 0 : 1);  // 0..3
      if (idx == 0) {
        offset = f.rep[0];
      } else {
        offset = idx == 3 ? static_cast<uint64_t>(f.rep[0]) - 1 : f.rep[idx];
        if (offset == 0) fail();
        if (idx > 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = static_cast<uint32_t>(offset);
      }
    }
    if (lpos + ll > regen) fail();
    const size_t at0 = f.out.size();
    if (offset > at0 + ll) fail();
    f.out.resize(at0 + ll + ml);
    uint8_t* o = f.out.data();
    if (ll) std::memcpy(o + at0, lit.data() + lpos, ll);
    lpos += ll;
    const size_t to = at0 + ll, from = to - static_cast<size_t>(offset);
    if (offset >= ml) {
      std::memcpy(o + to, o + from, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) o[to + k] = o[from + k];
    }
    if (i + 1 < nseq) {
      sll = el.base + static_cast<uint32_t>(b.read(el.nbits));
      sml = em.base + static_cast<uint32_t>(b.read(em.nbits));
      sof = eo.base + static_cast<uint32_t>(b.read(eo.nbits));
      if (b.bits < 0) fail();
    }
  }
  if (b.bits != 0) fail();
  f.out.insert(f.out.end(), lit.begin() + static_cast<long>(lpos), lit.end());
}

// The first frame of `p` into `out` (at most `cap` bytes are kept), as one
// ZSTD_decompressStream call gives it to libtiff; returns the bytes written.
long first_frame(const uint8_t* p, size_t n, uint8_t* out, size_t cap) {
  if (n < 4) fail();
  const uint32_t magic = le32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // a skippable frame ends the call
    if (n < 8 || le32(p + 4) > n - 8) fail();
    return 0;
  }
  if (magic != 0xFD2FB528u) fail();
  size_t at = 4;
  if (at >= n) fail();
  const int fhd = p[at++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (fhd & 8) fail();
  Frame f;
  f.out.reserve(cap + (128u << 10));
  if (!single) {
    if (at >= n) fail();
    const int wd = p[at++];
    const int wlog = 10 + (wd >> 3);
    const uint64_t base = 1ULL << wlog;
    f.window = static_cast<size_t>(base + (base / 8) * (wd & 7));
  }
  const int did_size[4] = {0, 1, 2, 4};
  uint32_t did = 0;
  if (at + did_size[did_flag] > n) fail();
  for (int i = 0; i < did_size[did_flag]; ++i) did |= static_cast<uint32_t>(p[at + i]) << (8 * i);
  at += did_size[did_flag];
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (at + fcs_size > n) fail();
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= static_cast<uint64_t>(p[at + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  at += fcs_size;
  if (single) f.window = static_cast<size_t>(fcs);
  if (did) fail(kDict);
  if (f.window > (1u << 27)) fail(kTooLarge);
  const size_t block_max = f.window < (128u << 10) ? (f.window ? f.window : 1) : (128u << 10);
  bool extra_block = false;  // the output filled exactly: libzstd decodes one block more
  for (;;) {
    if (at + 3 > n) fail();
    const uint32_t bh = p[at] | p[at + 1] << 8 | p[at + 2] << 16;
    at += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail();
    const size_t before = f.out.size();
    if (type == 0) {
      if (size > block_max || at + size > n) fail();
      f.out.insert(f.out.end(), p + at, p + at + size);
      at += size;
    } else if (type == 1) {
      if (size > block_max || at + 1 > n) fail();
      f.out.insert(f.out.end(), size, p[at]);
      at += 1;
    } else {
      if (size > block_max || at + size > n) fail();
      compressed_block(f, p + at, size);
      at += size;
      if (f.out.size() - before > (128u << 10)) fail();
    }
    if (single && f.out.size() > fcs) fail();
    if (extra_block) break;
    if (last) {
      if (fcs_size && f.out.size() != fcs) fail();
      if (checksum && f.out.size() <= cap) {
        if (at + 4 > n) fail();
        if (le32(p + at) != static_cast<uint32_t>(xxh64(f.out.data(), f.out.size())))
          fail(kChecksum);
      }
      break;
    }
    if (f.out.size() > cap) break;
    if (f.out.size() == cap) extra_block = true;
  }
  const size_t keep = f.out.size() < cap ? f.out.size() : cap;
  if (keep) std::memcpy(out, f.out.data(), keep);
  return static_cast<long>(keep);
}

}  // namespace

extern "C" {

// Decode a ZSTD strip or tile `src` (n bytes) into `out` (cap bytes) as
// libtiff's ZSTDDecode reads it: the first frame, cut at `cap`. Returns the
// bytes written (fewer than cap: libtiff's "Not enough data") or a
// negative Status.
long zstd_decode_first(const uint8_t* src, long n, uint8_t* out, long cap) {
  if (!src || n < 0 || !out || cap < 0) return kBadArgs;
  try {
    return first_frame(src, static_cast<size_t>(n), out, static_cast<size_t>(cap));
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kTooLarge;
  }
}

}  // extern "C"
