// TIFF strip and tile decompressors for the LDR loader (io/tiff.py): LZW
// (TIFF 6.0 section 13, MSB-first codes of 9 to 12 bits with the early
// code-width change, ClearCode 256, EndOfInformation 257) and PackBits
// (section 9). Deflate goes through Python's zlib.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxCodes = 4096;

}  // namespace

extern "C" {

// Decode one LZW strip into `out` (capacity `cap`). Returns the bytes
// written (at most `cap`: a strip that decodes to more is cut, as libtiff
// cuts it), -1 for a code that is not in the table, -2 for bad arguments.
long tiff_lzw_decode(const uint8_t* src, long n, uint8_t* out, long cap) {
  if (!src || !out || n < 0 || cap < 0) return -2;
  static thread_local uint16_t prefix[kMaxCodes];
  static thread_local uint8_t suffix[kMaxCodes], first[kMaxCodes];
  static thread_local uint16_t length[kMaxCodes];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  uint64_t acc = 0;
  int bits = 0;
  long pos = 0, w = 0;
  int width = 9, next = kFirst, prev = -1;
  for (;;) {
    while (bits < width) {
      if (pos >= n) return w;  // out of data without EOI: what was decoded
      acc = (acc << 8) | src[pos++];
      bits += 8;
    }
    int code = static_cast<int>((acc >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    int emit;
    uint8_t head;
    if (code < next && (code < 256 || code >= kFirst)) {
      emit = code;
      head = first[code];
    } else if (code == next && prev >= 0) {
      emit = -1;  // KwKwK: the previous string plus its own first byte
      head = first[prev];
    } else {
      return -1;
    }
    // write the string backwards from its end
    int len = emit >= 0 ? length[emit] : length[prev] + 1;
    long end = w + len;
    long keep = end <= cap ? len : cap - w;
    if (keep > 0) {
      long at = end - 1;
      int c = emit;
      if (emit < 0) {
        if (at < cap) out[at] = head;
        --at;
        c = prev;
      }
      while (c != 0xFFFF && c >= 0) {
        if (at < cap) out[at] = suffix[c];
        --at;
        c = prefix[c];
      }
    }
    w = end <= cap ? end : cap;
    if (prev >= 0 && next < kMaxCodes) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = first[prev];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
    }
    prev = emit >= 0 ? emit : next - 1;
    if (next + 1 >= (1 << width) && width < 12) ++width;
    if (w >= cap) break;
  }
  return w;
}

// Decode one PackBits strip into `out` (capacity `cap`). Returns the bytes
// written, or -2 for bad arguments.
long tiff_packbits_decode(const uint8_t* src, long n, uint8_t* out, long cap) {
  if (!src || !out || n < 0 || cap < 0) return -2;
  long pos = 0, w = 0;
  while (pos < n && w < cap) {
    int c = static_cast<int8_t>(src[pos++]);
    if (c >= 0) {
      long k = c + 1;
      if (pos + k > n) k = n - pos;
      if (w + k > cap) k = cap - w;
      std::memcpy(out + w, src + pos, k);
      pos += c + 1;
      w += k;
    } else if (c != -128) {
      if (pos >= n) break;
      long k = 1 - c;
      if (w + k > cap) k = cap - w;
      std::memset(out + w, src[pos++], k);
      w += k;
    }
  }
  return w;
}

}  // extern "C"
