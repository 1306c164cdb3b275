// TIFF strip and tile decompressors for the LDR loader (io/tiff.py): LZW
// (TIFF 6.0 section 13, MSB-first codes of 9 to 12 bits with the early
// code-width change, ClearCode 256, EndOfInformation 257), the old-style
// LZW libtiff still reads (LZWDecodeCompat: LSB-first codes, the width
// changing one code later), PackBits (section 9) and ThunderScan (4-bit
// grey, libtiff's tif_thunder.c: runs, 2- and 3-bit deltas and raw
// pixels, each row exactly as wide as the image). Deflate and LZMA go
// through Python's zlib and lzma.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxCodes = 4096;
constexpr int kCompatCodes = 4096 + 1024;  // libtiff's CSIZE

}  // namespace

extern "C" {

// Decode one LZW strip into `out` (capacity `cap`). Returns the bytes
// written (at most `cap`: a strip that decodes to more is cut, as libtiff
// cuts it), -1 for a code that is not in the table, -2 for bad arguments.
long tiff_lzw_decode(const uint8_t* src, long n, uint8_t* out, long cap) {
  if (!src || !out || n < 0 || cap < 0) return -2;
  // the tables live per thread; plain pointers keep TLS lookups out of the loop
  static thread_local uint16_t t_prefix[kMaxCodes], t_length[kMaxCodes];
  static thread_local uint8_t t_suffix[kMaxCodes], t_first[kMaxCodes];
  uint16_t *prefix = t_prefix, *length = t_length;
  uint8_t *suffix = t_suffix, *first = t_first;
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
    if (bits < width) {
      while (bits <= 56 && pos < n) {
        acc = (acc << 8) | src[pos++];
        bits += 8;
      }
      if (bits < width) return w;  // out of data without EOI: what was decoded
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
    if (code < 256) {  // a literal: one byte, the common case
      out[w++] = static_cast<uint8_t>(code);
      if (prev >= 0 && next < kMaxCodes) {
        prefix[next] = static_cast<uint16_t>(prev);
        suffix[next] = static_cast<uint8_t>(code);
        first[next] = first[prev];
        length[next] = static_cast<uint16_t>(length[prev] + 1);
        ++next;
      }
      prev = code;
      if (next + 1 >= (1 << width) && width < 12) ++width;
      if (w >= cap) break;
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

// Decode one old-style LZW strip as libtiff's LZWDecodeCompat does: codes
// LSB first, a table entry added before the code's string is written, the
// width growing once the next entry passes the widest code. Returns the
// bytes written (at most `cap`; the data running out ends the strip as an
// EOI would), -1 for a code that is not in the table, -2 for bad arguments.
long tiff_lzw_decode_compat(const uint8_t* src, long n, uint8_t* out, long cap) {
  if (!src || !out || n < 0 || cap < 0) return -2;
  static thread_local uint16_t t_prefix[kCompatCodes], t_length[kCompatCodes];
  static thread_local uint8_t t_suffix[kCompatCodes], t_first[kCompatCodes];
  uint16_t *prefix = t_prefix, *length = t_length;
  uint8_t *suffix = t_suffix, *first = t_first;
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  uint64_t acc = 0;
  int bits = 0;
  long pos = 0, w = 0;
  int width = 9, next = kFirst, prev = -1;
  auto code_at = [&](int* code) {
    while (bits < width) {
      if (pos >= n) return false;
      acc |= static_cast<uint64_t>(src[pos++]) << bits;
      bits += 8;
    }
    *code = static_cast<int>(acc & ((1u << width) - 1));
    acc >>= width;
    bits -= width;
    return true;
  };
  int code;
  while (w < cap && code_at(&code)) {
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      do {
        if (!code_at(&code)) return w;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return -1;
      out[w++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (prev < 0 || next >= kCompatCodes || code > next || (code >= 256 && code < kFirst))
      return -1;
    // the new entry: the previous string and the first byte of this one
    prefix[next] = static_cast<uint16_t>(prev);
    first[next] = first[prev];
    length[next] = static_cast<uint16_t>(length[prev] + 1);
    suffix[next] = code < next ? first[code] : first[prev];
    if (++next > (1 << width) - 1 && width < 12) ++width;
    prev = code;
    int len = length[code];
    long end = w + len, at = end - 1;
    for (int c = code; c != 0xFFFF; c = prefix[c], --at)
      if (at < cap) out[at] = suffix[c];
    w = end <= cap ? end : cap;
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

// Decode one ThunderScan strip of `rows` rows of `width` 4-bit pixels into
// `out` (rows of (width + 1) / 2 bytes) as ThunderDecodeRow does. Returns
// 0, -1 for a row whose codes give too many or too few pixels (libtiff's
// "Not enough data" / "Too much data"), -2 for bad arguments.
int tiff_thunder_decode(const uint8_t* src, long n, uint8_t* out, int width, int rows) {
  if (!src || !out || n < 0 || width <= 0 || rows < 0) return -2;
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const long stride = (static_cast<long>(width) + 1) / 2;
  const uint8_t* bp = src;
  long cc = n;
  for (int r = 0; r < rows; ++r) {
    uint8_t* op = out + stride * r;
    unsigned lastpixel = 0;
    long npixels = 0;
    const long maxpixels = width;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xF;
      if (npixels < maxpixels) {
        if (npixels++ & 1) {
          *op++ |= static_cast<uint8_t>(lastpixel);
        } else {
          op[0] = static_cast<uint8_t>(lastpixel << 4);
        }
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int c = *bp++;
      --cc;
      int delta;
      switch (c & 0xC0) {
        case 0x00: {  // a run of the last pixel, c & 0x3F long
          int k = c & 0x3F;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(lastpixel);
            lastpixel = *op++;
            ++npixels;
            --k;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= maxpixels) {
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(lastpixel);
          }
          if (k == -1) *--op &= 0xF0;
          lastpixel &= 0xF;
          break;
        }
        case 0x40:  // three 2-bit deltas, 2 = skip
          if ((delta = (c >> 4) & 3) != 2) setpixel(lastpixel + kTwo[delta]);
          if ((delta = (c >> 2) & 3) != 2) setpixel(lastpixel + kTwo[delta]);
          if ((delta = c & 3) != 2) setpixel(lastpixel + kTwo[delta]);
          break;
        case 0x80:  // two 3-bit deltas, 4 = skip
          if ((delta = (c >> 3) & 7) != 4) setpixel(lastpixel + kThree[delta]);
          if ((delta = c & 7) != 4) setpixel(lastpixel + kThree[delta]);
          break;
        default:  // a raw pixel
          setpixel(static_cast<unsigned>(c));
          break;
      }
    }
    if (npixels != maxpixels) return -1;
  }
  return 0;
}

}  // extern "C"
