// Per-pixel loops of the LDR container decoders: GIF's LZW, QOI, TGA's RLE
// and BMP's RLE8 / RLE4, each with the behaviour of PIL 12.1's decoder for
// that format (GifDecode.c, QoiImagePlugin, TgaRleDecode.c and
// BmpImagePlugin's BmpRleDecoder), quirks included.
//
// Build: g++ -O2 -shared -fPIC -std=c++17, at first use, by
// rapidraw_tpu_torch/native.py (host_library) into rapidraw_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kBadArgs = -1,
  kTruncated = -2,  // OSError: image file is truncated
  kBroken = -3,     // OSError: broken data stream
  kIndexError = -4,
  kValueError = -5,
};

}  // namespace

extern "C" {

// GIF image data -> the frame's (fh, fw) pixels written at (x0, y0) of a
// `stride`-wide canvas, rows in interlaced order when `interlace`. `data`
// holds the bytes after the LZW minimum code size `bits` to the end of the
// file: sub-blocks of a size byte and that many bytes, zero-sized ones
// skipped as PIL skips them; a block the file cuts short is not decoded.
// Returns 0 once every pixel is written, kTruncated when the codes end
// first, kBroken on an invalid code.
int gif_lzw_decode(const uint8_t* data, long n, int bits, int interlace, uint8_t* canvas,
                   int stride, int x0, int y0, int fw, int fh) {
  if (!data || !canvas || bits < 0 || bits > 12 || fw <= 0 || fh <= 0) return kBadArgs;
  constexpr int kTable = 4096;
  std::vector<uint8_t> suffix(kTable), stack(kTable + 1);
  std::vector<uint16_t> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2;  // 2: first code after a clear, 3: decoding
  int lastcode = 0, lastdata = 0;
  uint32_t bitbuf = 0;
  int bitcount = 0;
  long pos = 0, block_left = 0;
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;

  auto newline = [&]() -> bool {  // false: image complete
    x = 0;
    y += step;
    while (y >= fh) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    return true;
  };

  for (;;) {
    while (bitcount < codesize) {
      if (block_left > 0) {
        bitbuf |= (uint32_t)data[pos++] << bitcount;
        bitcount += 8;
        --block_left;
      } else {
        if (pos >= n) return kTruncated;
        const int c = data[pos];
        if (pos + 1 + c > n) return kTruncated;
        block_left = c;
        ++pos;
      }
    }
    int c = (int)(bitbuf & (uint32_t)codemask);
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
      continue;
    }
    if (c == end) return kTruncated;
    int len = 0;
    if (state == 2) {
      if (c > clear) return kBroken;
      lastdata = lastcode = c;
      stack[0] = (uint8_t)c;
      len = 1;
      state = 3;
    } else {
      const int thiscode = c;
      if (c > next) return kBroken;
      int sp = kTable + 1;
      if (c == next) {
        stack[--sp] = (uint8_t)lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (sp <= 0 || c >= kTable) return kBroken;
        stack[--sp] = suffix[c];
        c = link[c];
      }
      if (sp <= 0) return kBroken;
      stack[--sp] = (uint8_t)c;
      lastdata = c;
      if (next < kTable) {
        suffix[next] = (uint8_t)c;
        link[next] = (uint16_t)lastcode;
        if (next == codemask && codesize < 12) {
          codesize++;
          codemask = (1 << codesize) - 1;
        }
        next++;
      }
      lastcode = thiscode;
      len = kTable + 1 - sp;
      memmove(stack.data(), stack.data() + sp, len);
    }
    for (int k = 0; k < len; ++k) {
      canvas[(size_t)(y0 + y) * stride + x0 + x] = stack[k];
      if (++x >= fw && !newline()) return kOk;
    }
  }
}

// QOI pixel data (after the 14-byte header) -> w*h*channels bytes, as
// PIL's QoiDecoder reads it: the index table starts empty (misses give
// 0,0,0,0), runs add no index entry, the end marker is not read. Returns
// kIndexError where PIL reads past the end for an op byte, kValueError
// where a colour op's bytes are cut short.
int qoi_decode(const uint8_t* data, long n, uint8_t* out, int w, int h, int channels) {
  if (!data || !out || w <= 0 || h <= 0 || (channels != 3 && channels != 4)) return kBadArgs;
  uint8_t index[64][4];
  memset(index, 0, sizeof(index));
  uint8_t prev[4] = {0, 0, 0, 255};
  const size_t dest = (size_t)w * h * channels;
  size_t o = 0;
  long pos = 0;
  auto put = [&](const uint8_t* v) {
    for (int c = 0; c < channels && o < dest; ++c) out[o++] = v[c];
  };
  while (o < dest) {
    if (pos >= n) return kIndexError;
    const int byte = data[pos++];
    uint8_t v[4];
    if (byte == 0xfe) {
      if (pos + 3 > n) return kValueError;
      memcpy(v, data + pos, 3);
      v[3] = prev[3];
      pos += 3;
    } else if (byte == 0xff) {
      if (pos + 4 > n) return kValueError;
      memcpy(v, data + pos, 4);
      pos += 4;
    } else {
      const int op = byte >> 6;
      if (op == 0) {
        memcpy(v, index[byte & 0x3f], 4);
      } else if (op == 1) {
        v[0] = (uint8_t)(prev[0] + ((byte >> 4) & 3) - 2);
        v[1] = (uint8_t)(prev[1] + ((byte >> 2) & 3) - 2);
        v[2] = (uint8_t)(prev[2] + (byte & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (pos >= n) return kIndexError;
        const int second = data[pos++];
        const int dg = (byte & 0x3f) - 32;
        const int dr = ((second >> 4) & 0xf) - 8, db = (second & 0xf) - 8;
        v[0] = (uint8_t)(prev[0] + dg + dr);
        v[1] = (uint8_t)(prev[1] + dg);
        v[2] = (uint8_t)(prev[2] + dg + db);
        v[3] = prev[3];
      } else {
        const int run = (byte & 0x3f) + 1;
        for (int r = 0; r < run; ++r) put(prev);
        continue;
      }
    }
    memcpy(prev, v, 4);
    memcpy(index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    put(v);
  }
  return kOk;
}

// TGA RLE packets -> h rows of `row_bytes` in file order (the caller flips
// them), pixels of `depth` bytes. A run packet that crosses a row's end is
// an overrun, a literal one carries on into the next rows (TgaRleDecode.c).
int tga_rle_decode(const uint8_t* data, long n, uint8_t* out, int row_bytes, int h, int depth) {
  if (!data || !out || row_bytes <= 0 || h <= 0 || depth <= 0) return kBadArgs;
  const size_t total = (size_t)row_bytes * h;
  size_t o = 0;
  long pos = 0;
  while (o < total) {
    if (pos >= n) return kTruncated;
    const int head = data[pos];
    const size_t cnt = (size_t)depth * ((head & 0x7f) + 1);
    const size_t x = o % row_bytes;
    if (head & 0x80) {
      if (pos + 1 + depth > n) return kTruncated;
      if (x + cnt > (size_t)row_bytes) return kBroken;
      for (size_t i = 0; i < cnt; i += depth) memcpy(out + o + i, data + pos + 1, depth);
      pos += 1 + depth;
      o += cnt;
    } else {
      if (pos + 1 + (long)cnt > n) return kTruncated;
      const size_t take = cnt < total - o ? cnt : total - o;
      memcpy(out + o, data + pos + 1, take);
      pos += 1 + cnt;
      o += take;
    }
  }
  return kOk;
}

// BMP RLE8 / RLE4 -> at most w*h indices in file row order, as PIL's
// BmpRleDecoder builds them (its delta escape reads two bytes it ignores,
// then right and up; an odd RLE4 literal loses its last pixel; literals
// align to even positions of the file, `base` being data[0]'s). *got: the
// pixels produced. Returns kValueError where PIL's unpacking of a cut-short
// delta fails.
int bmp_rle_decode(const uint8_t* data, long n, long base, int rle4, int w, int h, uint8_t* out,
                   long* got) {
  if (!data || !out || !got || w <= 0 || h <= 0) return kBadArgs;
  const size_t dest = (size_t)w * h;
  std::vector<uint8_t> buf;
  buf.reserve(dest);
  long pos = 0;
  long x = 0;
  while (buf.size() < dest) {
    if (pos + 2 > n) break;
    int num = data[pos], byte = data[pos + 1];
    pos += 2;
    if (num) {
      if (x + num > w) num = (int)(w - x > 0 ? w - x : 0);
      for (int i = 0; i < num; ++i) buf.push_back(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 0x0f) : byte);
      x += num;
    } else if (byte == 0) {
      while (buf.size() % w != 0) buf.push_back(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return kValueError;
      const int right = data[pos], up = data[pos + 1];
      pos += 2;
      buf.insert(buf.end(), (size_t)right + (size_t)up * w, 0);
      x = (long)(buf.size() % w);
    } else {
      const long count = rle4 ? byte / 2 : byte;
      const long have = pos + count <= n ? count : (n > pos ? n - pos : 0);
      for (long i = 0; i < have; ++i) {
        const int b = data[pos + i];
        if (rle4) {
          buf.push_back((uint8_t)(b >> 4));
          buf.push_back((uint8_t)(b & 0x0f));
        } else {
          buf.push_back((uint8_t)b);
        }
      }
      pos += have;
      if (have < count) break;
      x += byte;
      if ((base + pos) % 2 != 0) pos += 1;
    }
  }
  const size_t k = buf.size() < dest ? buf.size() : dest;
  memcpy(out, buf.data(), k);
  *got = (long)k;
  return kOk;
}

}  // extern "C"
