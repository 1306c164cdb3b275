"""The last decode paths of ROADMAP A.10d-b against PIL 12.1 (libjpeg-turbo
3.1.3, libtiff 4.7.1) and the JAX package, on the CPU.

- Arithmetic-coded JPEG (csrc/host/jpeg_dec.cc's QM decoder): SOF9 and
  SOF10 frames written by this file's own QM-coder encoder (`QM`,
  `arith_jpeg`: jcarith.c's coding over T.81 Table D.2, which the test
  reads from PIL's libjpeg) in grey, 4:4:4, 4:2:0 and CMYK, with and
  without restarts and DAC conditioning; the SOF0 -> SOF9/SOF10 patched
  Huffman files and random coefficients past 16 bits (libjpeg-turbo's x86
  SIMD inverse DCT, which PIL runs here); SOF11, which libjpeg-turbo
  refuses; PIL's 64 KB window
  (its JPEG reader feeds libjpeg 64 KB at a time and the arithmetic
  decoder cannot wait for more); arithmetic streams in JPEG-compressed
  TIFFs, 12-bit ones among them.
- TIFF (io/tiff.py, csrc/host/zstd_dec.cc, ccitt_dec.cc, tiff_codec.cc):
  ZSTD written by PIL (every mode, Predictor 1, 2 and 3) and by the
  zstandard module (strips, tiles, several frames, skippable frames,
  checksums, raw and RLE blocks, long windows); CCITT RLE-W written by
  PIL at even and odd offsets; ThunderScan written by this file's encoder;
  12-bit samples; a subsampled YCbCr frame under Predictor 2; old-style
  JPEG (compression 6) in its interchange-format, header-and-strips and
  tables-in-tags layouts; WebP and SGILog, which PIL's libtiff does not
  decode.
- `load_image` and `read_tiff16_rgb` against the JAX package, and
  chip_smoke's phase-24 builders (the 24 MP files made from the committed
  fixtures) read back as the fixtures hold them.

`like_pil` (tests/test_torch_ldr_variants.py) holds the port to PIL's mode,
samples and conversions, or to the exception class PIL raises.
"""

from __future__ import annotations

import ctypes
import glob
import io
import os
import re
import struct
from pathlib import Path

import jax
import numpy as np
import pytest
import zstandard
from PIL import Image

import chip_smoke
from chip_smoke import ljpeg_encode, ycbcr_blocks
from chip_smoke import tiff_chunks as make_tiff
from rapidraw_tpu.io import encode as jencode
from rapidraw_tpu.io import loader as jloader
from rapidraw_tpu.utils.settings import AppSettings as JAppSettings
from rapidraw_tpu_torch.io import jpeg, loader, tiff
from rapidraw_tpu_torch.io.image_decode import open_image
from rapidraw_tpu_torch.utils.settings import AppSettings
from tests.test_torch_ldr import lzw_encode
from tests.test_torch_ldr_variants import like_pil, photo, pil_save

jax.config.update("jax_platforms", "cpu")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "ldr"

# ---- a QM-coder JPEG encoder (T.81 Annex D, after jcarith.c) -----------------------------------


def _aritab() -> list:
    """jpeg_aritab (Table D.2) as PIL's libjpeg holds it."""
    import PIL

    lib = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                 "libjpeg*"))[0]
    return list((ctypes.c_long * 114).in_dll(ctypes.CDLL(lib), "jpeg_aritab"))


ARITAB = _aritab()
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])


class QM:
    """jcarith.c's arith_encode and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += b"\0" * self.zc
        self.zc = 0

    def _byte(self, b):
        self._zeros()
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _settle(self, temp):
        """A byte is ready: carry into the stacked 0xFF bytes or emit them."""
        if temp > 0xFF:
            if self.buffer >= 0:
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._settle(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            self._settle(0)  # flush the buffer and the stacked bytes
        if self.c & 0x7FFF800:
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


def _dc(qm, st, ctx, i, v, lo, hi):
    """Figures F.4 to F.9: a DC difference under conditioning (lo, hi)."""
    s0 = ctx[i]
    if v == 0:
        qm.encode(st, s0, 0)
        ctx[i] = 0
        return
    qm.encode(st, s0, 1)
    qm.encode(st, s0 + 1, int(v < 0))
    k, ctx[i] = s0 + 2 + int(v < 0), 8 if v < 0 else 4
    _magnitude(qm, st, k, abs(v), 20)
    m = 1 << (abs(v) - 1).bit_length() >> 1 if abs(v) > 1 else 0
    if m < (1 << lo) >> 1:
        ctx[i] = 0
    elif m > (1 << hi) >> 1:
        ctx[i] += 8


def _magnitude(qm, st, k, v, x1, ac=False):
    """Figures F.8 and F.9: v >= 1 from the bin at k; the magnitude bins
    from x1 (an AC value's second decision stays at k)."""
    v -= 1
    m = 0
    if v:
        qm.encode(st, k, 1)
        m, v2 = 1, v >> 1
        if ac and v2:
            qm.encode(st, k, 1)
            m, v2 = 2, v2 >> 1
        k = x1 if not ac or m == 2 else k
        if not ac or m == 2:
            while v2:
                qm.encode(st, k, 1)
                m <<= 1
                k += 1
                v2 >>= 1
    qm.encode(st, k, 0)
    k += 14
    m >>= 1
    while m:
        qm.encode(st, k, int(bool(m & v)))
        m >>= 1


def _shifted(v, al):
    return (abs(v) >> al) * (1 if v >= 0 else -1)


def _scan_units(comps, sampling, cis, width, height):
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if len(cis) == 1:
        h, v = sampling[cis[0]]
        wb = -(-(-(-width * h // hmax)) // 8)
        hb = -(-(-(-height * v // vmax)) // 8)
        return [[(0, cis[0], by, bx)] for by in range(hb) for bx in range(wb)]
    units = []
    for my in range(-(-height // (8 * vmax))):
        for mx in range(-(-width // (8 * hmax))):
            units.append([(si, c, my * sampling[c][1] + y, mx * sampling[c][0] + x)
                          for si, c in enumerate(cis)
                          for y in range(sampling[c][1]) for x in range(sampling[c][0])])
    return units


def encode_scan(comps, sampling, scan, restart, cond, tables, width, height, progressive):
    """One scan's entropy-coded bytes, RSTn markers included."""
    cis, ss, se, ah, al = scan[:5]
    lo, hi, kx = cond
    qm = QM()
    dc_st = [bytearray(64) for _ in range(16)]
    ac_st = [bytearray(256) for _ in range(16)]
    fixed = bytearray([113])
    last, ctx = [0] * 4, [0] * 4
    dc_scan = not progressive or (ss == 0 and ah == 0)
    rst = 0
    for n, unit in enumerate(_scan_units(comps, sampling, cis, width, height)):
        if restart and n and n % restart == 0:
            qm.finish()
            qm.out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            qm.reset()
            for si, c in enumerate(cis):
                if dc_scan:
                    dc_st[tables[c][0]][:] = bytes(64)
                    last[si] = ctx[si] = 0
                if not progressive or se:
                    ac_st[tables[c][1]][:] = bytes(256)
        for si, c, by, bx in unit:
            blk = comps[c][by, bx]
            td, ta = tables[c]
            if dc_scan:
                dcv = int(blk[0]) >> al
                _dc(qm, dc_st[td], ctx, si, dcv - last[si], lo[td], hi[td])
                last[si] = dcv
            elif ss == 0:
                qm.encode(fixed, 0, (int(blk[0]) >> al) & 1)
            if progressive and ss == 0:
                continue
            st = ac_st[ta]
            zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
            k0, k1 = (1, 63) if not progressive else (ss, se)
            ke = k1
            while ke > 0 and _shifted(zz[ke], al) == 0:
                ke -= 1
            refine = progressive and ah > 0
            kex = ke
            while refine and kex > 0 and _shifted(zz[kex], ah) == 0:
                kex -= 1
            k = k0
            while k <= ke:
                i = 3 * (k - 1)
                if not refine or k > kex:
                    qm.encode(st, i, 0)
                while True:
                    v = _shifted(zz[k], al)
                    if v:
                        if refine and abs(v) >> 1:
                            qm.encode(st, i + 2, abs(v) & 1)
                        else:
                            qm.encode(st, i + 1, 1)
                            qm.encode(fixed, 0, int(v < 0))
                            if not refine:
                                _magnitude(qm, st, i + 2, abs(v),
                                           189 if k <= kx[ta] else 217, ac=True)
                        break
                    qm.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                k += 1
            if k <= k1:
                qm.encode(st, 3 * (k - 1), 1)
    qm.finish()
    return bytes(qm.out)


def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def arith_jpeg(comps, width, height, sampling, quant, scans=None, restart=0, dac=None,
               progressive=False, app=b"", precision=8, sof=None) -> bytes:
    """A JPEG of quantized blocks comps[c] (by, bx, 64, natural order) coded
    with the QM coder. scans: (components, Ss, Se, Ah, Al[, restart]), a
    DRI before each scan whose interval differs; dac: {index: value}."""
    nc = len(comps)
    tables = [(0, 0) if c == 0 else (1, 1) for c in range(nc)]
    lo, hi, kx = [0] * 16, [1] * 16, [5] * 16
    for idx, val in (dac or {}).items():
        if idx >= 16:
            kx[idx - 16] = val
        else:
            lo[idx], hi[idx] = val & 15, val >> 4
    scans = scans or [(tuple(range(nc)), 0, 63, 0, 0)]
    out = bytearray(b"\xff\xd8") + app
    for t, q in enumerate(quant):
        out += _seg(0xDB, bytes([t]) + bytes(int(q[ZIGZAG[k]]) for k in range(64)))
    marker = sof if sof is not None else (0xCA if progressive else 0xC9)
    out += _seg(marker, struct.pack(">BHHB", precision, height, width, nc) + b"".join(
        bytes([c + 1, (sampling[c][0] << 4) | sampling[c][1], min(c, len(quant) - 1)])
        for c in range(nc)))
    if dac:
        out += _seg(0xCC, b"".join(bytes([i, v]) for i, v in dac.items()))
    current = None
    for scan in scans:
        interval = scan[5] if len(scan) > 5 else restart
        if interval != current and (interval or current):
            out += _seg(0xDD, struct.pack(">H", interval))
            current = interval
        cis, ss, se, ah, al = scan[:5]
        out += _seg(0xDA, bytes([len(cis)]) + b"".join(
            bytes([c + 1, (tables[c][0] << 4) | tables[c][1]]) for c in cis) +
            bytes([ss, se, (ah << 4) | al]))
        out += encode_scan(comps, sampling, scan, interval, (lo, hi, kx), tables, width,
                           height, progressive)
    return bytes(out + b"\xff\xd9")


_N = np.arange(8)
DCT = np.cos((2 * _N[None, :] + 1) * _N[:, None] * np.pi / 16) * np.where(
    _N == 0, np.sqrt(1 / 8), 0.5)[:, None]


def coefficients(img, sampling, quant, bits: int = 8, ycc: bool = True) -> list:
    """Forward DCT and quantization of (H, W, C) samples (YCbCr from RGB
    when C is 3 and `ycc`) -> per component (by, bx, 64) int blocks over the
    MCU grid."""
    img = np.asarray(img, np.float64)
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    if nc == 3 and ycc:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        img = np.stack([y, 128 + (b - y) / 1.772, 128 + (r - y) / 1.402], -1)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = []
    for c in range(nc):
        fh, fv = hmax // sampling[c][0], vmax // sampling[c][1]
        ph, pw = my * 8 * vmax, mx * 8 * hmax
        plane = np.pad(img[..., c], ((0, ph - h), (0, pw - w)), mode="edge")
        plane = plane.reshape(ph // fv, fv, pw // fh, fh).mean((1, 3)) - (1 << (bits - 1))
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        coef = DCT @ plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) @ DCT.T
        q = np.asarray(quant[min(c, len(quant) - 1)], np.float64).reshape(8, 8)
        out.append(np.round(coef / q).astype(np.int64).reshape(bh, bw, 64))
    return out


QUANT = [np.full(64, 4), np.full(64, 6)]
SAMPLINGS = {"grey": [(1, 1)], "444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
             "cmyk": [(1, 1)] * 4}


def progression(nc: int, restart: int = 0) -> list:
    """A successive-approximation script: DC first (Al 1), AC bands, the
    refinements."""
    comps = tuple(range(nc))
    return ([(comps, 0, 0, 0, 1, restart), ((0,), 1, 5, 0, 2, restart)] +
            [((c,), 1, 63, 0, 1, restart) for c in range(1, nc)] +
            [((0,), 6, 63, 0, 2, restart), ((0,), 1, 63, 2, 1, restart)] +
            [((c,), 1, 63, 1, 0, restart) for c in range(1, nc)] +
            [((0,), 1, 63, 1, 0, restart), (comps, 0, 0, 1, 0, restart)])


def arith_file(layout: str, coding: str, h: int = 37, w: int = 53, seed: int = 0) -> bytes:
    samp = SAMPLINGS[layout]
    img = photo(h, w, len(samp), seed)
    co = coefficients(img[..., 0] if len(samp) == 1 else img, samp, QUANT,
                      ycc=layout != "cmyk")
    restart = 3 if coding.endswith("rst") else 0
    dac = {0: 0x52, 16: 2, 1: 0x10, 17: 20} if coding.endswith("rst") else None
    prog = coding.startswith("prog")
    return arith_jpeg(co, w, h, samp, QUANT, scans=progression(len(samp), restart) if prog
                      else None, restart=restart, dac=dac, progressive=prog)


# ---- arithmetic-coded JPEG ---------------------------------------------------------------------


@pytest.mark.parametrize("coding", ["seq", "seq-rst", "prog", "prog-rst"])
@pytest.mark.parametrize("layout", sorted(SAMPLINGS))
def test_arithmetic_jpeg_matches_pil(layout, coding):
    """SOF9 and SOF10 from the test encoder; "-rst": a restart every 3
    MCUs and DAC conditioning other than the defaults."""
    like_pil(arith_file(layout, coding), ("RGB", "L"))


def _patched(marker: int, base: str, size: tuple) -> bytes:
    h, w = size
    rng = np.random.default_rng(h)
    data = pil_save(Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)), "JPEG",
                    quality=85, progressive=base == "progressive")
    at = data.index(b"\xff\xc2" if base == "progressive" else b"\xff\xc0")
    return data[:at + 1] + bytes([marker]) + data[at + 2:]


_MARKERS = pytest.mark.parametrize("marker", [0xC9, 0xCA, 0xCB], ids=["sof9", "sof10", "sof11"])
_BASES = pytest.mark.parametrize("base", ["baseline", "progressive"])


@_MARKERS
@_BASES
def test_patched_huffman_files_match_pil(marker, base):
    """A Huffman file whose SOF says arithmetic coding: libjpeg decodes the
    bytes as QM-coded data (a bad code leaves the rest of the scan's
    blocks as they are), a progressive script under SOF9 stops at its
    second SOS (JERR_EOI_EXPECTED), a baseline scan under SOF10 fails
    libjpeg's progression checks, SOF11 is refused."""
    like_pil(_patched(marker, base, (16, 16)), ("RGB", "L"))


@_MARKERS
@_BASES
def test_patched_large_files_match_pil(marker, base):
    """The same at 200x300, where garbage decoded as QM-coded data gives
    coefficients past 16 bits: libjpeg-turbo's x86 SIMD inverse DCT (which
    PIL's libjpeg runs here) wraps the dequantization and its butterflies'
    sums, saturates each pass and clamps the samples, and so does the
    port's `idct_islow_simd`."""
    like_pil(_patched(marker, base, (200, 300)), ("RGB", "L"))


@pytest.mark.parametrize("scale", [30, 3000, 20000])
@pytest.mark.parametrize("layout", ["grey", "444"])
def test_overflowing_coefficients_match_pil(layout, scale):
    """Random coefficient blocks up to 15 bits under random quantization
    tables (and a DC-only block, and one whose AC rows are zero, which the
    SIMD IDCT sends down its DC path with a 16-bit shift) decode to PIL's
    samples."""
    rng = np.random.default_rng(scale + len(layout))
    nc = len(SAMPLINGS[layout])
    comps = []
    for _ in range(nc):
        co = np.clip(np.round(rng.laplace(0, scale, (4, 6, 64))), -32767, 32767).astype(np.int64)
        co[..., 0] = np.clip(co[..., 0], -16000, 16000)
        co[0, 0, 8:] = 0
        co[1, 1, 1:] = 0
        comps.append(co)
    quant = [rng.integers(1, 256, 64), np.full(64, 255)][:max(1, min(nc, 2))]
    like_pil(arith_jpeg(comps, 48, 32, SAMPLINGS[layout], quant), ("RGB", "L"))


@pytest.mark.parametrize("restarts", [0, 2], ids=["no-restarts", "restarts"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_corrupt_huffman_data_matches_pil(progressive, restarts):
    """Three bytes changed anywhere after the first SOS (entropy-coded data,
    later headers, markers): libjpeg's Huffman decoders go on as the port's
    do, a code in no table read as 0 after 17 bits, a marker met inside a
    segment giving zeros and leaving the segment's later MCUs as they are,
    restart markers resynchronised, a scan lost to a damaged header leaving
    the blocks to the smoothing; PIL's pixels, or its class where it
    fails."""
    rng = np.random.default_rng(2 * restarts + progressive)
    for trial in range(12):
        kw = {"quality": 85, "progressive": progressive}
        if restarts:
            kw["restart_marker_blocks"] = restarts
        data = bytearray(pil_save(Image.fromarray(photo(48, 64, 3, trial)), "JPEG", **kw))
        first = bytes(data).index(b"\xff\xda")
        for k in rng.integers(first + 20, len(data) - 2, 3):
            data[k] ^= int(rng.integers(1, 256))
        like_pil(bytes(data), ("RGB",))


@pytest.mark.parametrize("size", [(48, 64), (37, 53), (16, 16), (40, 13)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "grey"])
def test_incomplete_progression_matches_pil(sub, size):
    """A progressive JPEG cut after each of its scans (an EOI in place of
    the rest): libjpeg-turbo smooths each block's still-unknown AC
    coefficients 1-9 from the DC values of the 5x5 blocks around it, and
    with none of them coded the DC too (jdcoefct.c decompress_smooth_data),
    the rows and columns at the edges as it reckons them."""
    h, w = size
    img = photo(h, w, 3, h + w)
    kw = {"quality": 85, "progressive": True}
    if sub != "grey":
        kw["subsampling"] = sub
    data = pil_save(Image.fromarray(img[..., 0] if sub == "grey" else img), "JPEG", **kw)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for k in range(1, len(sos)):
        like_pil(data[:sos[k]] + b"\xff\xd9", ("RGB",))


def test_incomplete_12bit_progression_matches_pil():
    """The same smoothing on a 12-bit progressive strip of a TIFF."""
    h, w = 24, 40
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(x * 60 + y * 40 + np.random.default_rng(3).normal(0, 80, (h, w)), 0, 4095)
    stream = _jpeg12(img, "prog")
    sos = [i for i in range(len(stream) - 1) if stream[i:i + 2] == b"\xff\xda"]
    for k in range(1, len(sos)):
        cut = stream[:sos[k]] + b"\xff\xd9"
        like_pil(make_tiff(w, h, [cut], {258: (3, [12]), 259: (3, [7]), 262: (3, [1]),
                                          277: (3, [1])}), ("L",))


@pytest.mark.parametrize("marker", [0xC8, 0xDE, 0x77, 0xDC])
def test_markers_libjpeg_refuses_or_skips_match_pil(marker):
    """After the first scan libjpeg fails at JPG, DHP and the reserved
    markers (JERR_SOF_UNSUPPORTED, JERR_UNKNOWN_MARKER) and skips a DNL
    segment."""
    data = pil_save(Image.fromarray(photo(24, 32, 3, 2)), "JPEG", quality=85, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    seg = bytes([0xFF, marker, 0, 4, 0, 24])
    like_pil(data[:sos[2]] + seg + data[sos[2]:], ("RGB",))


_GREY = {}


def _grey_arith(w: int) -> bytes:
    if w not in _GREY:
        img = np.random.default_rng(5).integers(0, 256, (64, w)).astype(np.uint8)
        _GREY[w] = arith_jpeg(coefficients(img, [(1, 1)], [np.full(64, 2)]), w, 64, [(1, 1)],
                              [np.full(64, 2)])
    return _GREY[w]


@pytest.mark.parametrize("case", ["64k-3", "64k", "64k+1", "64k+9", "header-past-64k"])
def test_pil_64k_window_matches_pil(case):
    """PIL's JPEG reader hands libjpeg the file 64 KB at a time; libjpeg's
    arithmetic decoder cannot suspend for more, so a scan whose bytes run
    past what PIL has read fails (OSError), while the marker reader
    suspends and PIL reads on. The same stream in a TIFF strip decodes."""
    w = 320 if case == "header-past-64k" else 960
    base = _grey_arith(w)
    if case == "header-past-64k":
        pad = _seg(0xE5, bytes(60000)) * 2
    else:
        want = 65536 + {"64k-3": -3, "64k": 0, "64k+1": 1, "64k+9": 9}[case]
        pad = _seg(0xFE, bytes(want - len(base) - 4))
    data = base[:2] + pad + base[2:]
    assert case == "header-past-64k" or len(data) == want
    like_pil(data, ("L",))
    strip = make_tiff(w, 64, [data], {258: (3, [8]), 259: (3, [7]), 262: (3, [1]),
                                      277: (3, [1])})
    like_pil(strip, ("L",))


def test_sof11_is_refused_as_pil_refuses_it():
    """libjpeg-turbo has no arithmetic lossless decoder: OSError."""
    from tests.test_torch_ldr_variants import ljpeg8

    data = ljpeg8(photo(16, 16, 3))
    at = data.index(b"\xff\xc3")
    like_pil(data[:at + 1] + b"\xcb" + data[at + 2:], ("RGB",))


@pytest.mark.parametrize("layout", ["rgb-seq", "rgb-prog", "ycbcr22-seq", "ycbcr22-prog",
                                    "ycbcr11-seq", "big-rgb"])
def test_arithmetic_jpeg_in_tiff_matches_pil(layout):
    """Arithmetic streams as JPEG-compressed TIFF strips (libtiff hands
    libjpeg the whole strip: no 64 KB window)."""
    h, w = (400, 600) if layout == "big-rgb" else (40, 56)
    img = photo(h, w, 3, 2)
    samp = [(2, 2), (1, 1), (1, 1)] if "22" in layout else [(1, 1)] * 3
    prog = layout.endswith("prog")
    co = coefficients(img, samp, QUANT, ycc=layout.startswith("ycbcr"))
    stream = arith_jpeg(co, w, h, samp, QUANT, progressive=prog, restart=5,
                        scans=progression(3) if prog else None)
    tags = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6 if "ycbcr" in layout else 2]),
            277: (3, [3]), 278: (4, [h])}
    if "ycbcr" in layout:
        tags[530] = (3, list(samp[0]))
    if layout == "big-rgb":
        assert len(stream) > 65536
    like_pil(make_tiff(w, h, [stream], tags), ("RGB",))


def test_no_refusal_names_a10d_b():
    """No refusal of the port names ROADMAP A.10d-b any more."""
    root = Path(__file__).resolve().parent.parent / "rapidraw_tpu_torch"
    hits = [p for p in root.rglob("*") if p.suffix in (".py", ".cc", ".cu", ".h")
            and "A.10d-b" in p.read_text(errors="replace")]
    assert hits == []


# ---- ZSTD -------------------------------------------------------------------------------------

_ZSTD_MODES = [("L", None), ("L", 2), ("RGB", None), ("RGB", 2), ("RGBA", 2), ("CMYK", 2),
               ("LA", 2), ("I;16", None), ("I;16", 2), ("F", None), ("F", 2), ("F", 3),
               ("I", 2), ("1", None), ("P", None)]


def _pil_image(mode: str, h: int = 37, w: int = 53) -> Image.Image:
    rng = np.random.default_rng(len(mode))
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
    if mode == "F":
        return Image.fromarray(rng.normal(0, 100, (h, w)).astype(np.float32))
    if mode == "I":
        return Image.fromarray(rng.integers(-2**31, 2**31, (h, w)).astype(np.int32))
    if mode == "1":
        return Image.fromarray(photo(h, w, 1)[..., 0] > 100)
    if mode == "P":
        return Image.fromarray(photo(h, w, 3)).convert("P")
    if mode in ("RGBA", "CMYK"):
        return Image.fromarray(photo(h, w, 4), mode)
    return Image.fromarray(photo(h, w, 3)).convert(mode)


@pytest.mark.parametrize("mode,predictor", _ZSTD_MODES, ids=lambda v: str(v))
def test_pil_written_zstd_tiff_matches_pil(mode, predictor):
    """What PIL's libtiff writes with compression="zstd": one frame a
    strip, no checksum, Predictor 2 and 3 run after the codec."""
    kw = {"compression": "zstd"}
    if predictor:
        kw["tiffinfo"] = {317: predictor}
    data = pil_save(_pil_image(mode), "TIFF", **kw)
    assert tiff.Frame(data).compression == 50000
    like_pil(data, ("RGB", "L") if mode not in ("I", "F") else ("L",), samples=mode != "P")


def _zstd(data: bytes, **kw) -> bytes:
    return zstandard.ZstdCompressor(**kw).compress(data)


def _zstd_files() -> dict:
    h, w = 40, 64
    raw = photo(h, w, 3, 1).tobytes()
    half = len(raw) // 2
    tags = {258: (3, [8, 8, 8]), 259: (3, [50000]), 262: (3, [2]), 277: (3, [3])}

    def one(chunk, rows=h):
        return make_tiff(w, h, chunk if isinstance(chunk, list) else [chunk],
                         {**tags, 278: (4, [rows])})

    bad = bytearray(_zstd(raw, write_checksum=True))
    bad[-1] ^= 1
    dict_frame = bytearray(_zstd(raw, write_content_size=False))
    dict_frame[4] |= 1  # a one-byte dictionary ID after the window byte
    dict_frame = bytes(dict_frame[:6]) + b"\x07" + bytes(dict_frame[6:])
    noise = np.random.default_rng(0).integers(0, 256, len(raw), dtype=np.uint8).tobytes()
    big = photo(400, 640, 3, 2)
    diff = np.diff(np.concatenate([np.zeros((400, 1, 3), np.int16), big.astype(np.int16)], 1),
                   axis=1).astype(np.uint8)
    pad = np.zeros((416, 640, 3), np.uint8)
    pad[:400] = big
    tiles = [_zstd(np.ascontiguousarray(pad[ty:ty + 32, tx:tx + 64]).tobytes())
             for ty in range(0, 400, 32) for tx in range(0, 640, 64)]

    def large(chunks, rows=400, extra=None):
        t = {**tags, **(extra or {})}
        if rows:
            t[278] = (4, [rows])
        return make_tiff(640, 400, chunks, t, tile=None if rows else (64, 32))

    return {
        "one-frame": one(_zstd(raw)),
        "strips-level19": one([_zstd(raw[i * w * 24:(i + 1) * w * 24], level=19)
                               for i in range(5)], 8),
        "checksum": one(_zstd(raw, write_checksum=True)),
        "bad-checksum": one(bytes(bad)),
        "no-content-size": one(_zstd(raw, write_content_size=False)),
        "two-frames": one(_zstd(raw[:half]) + _zstd(raw[half:])),
        "trailing-frame": one(_zstd(raw) + _zstd(b"junk")),
        "skippable-first": one(struct.pack("<II", 0x184D2A50, 4) + b"abcd" + _zstd(raw)),
        "skippable-after": one(_zstd(raw) + struct.pack("<II", 0x184D2A53, 4) + b"abcd"),
        "short": one(_zstd(raw[:-10])),
        "long": one(_zstd(raw + b"x" * 100)),
        "truncated": one(_zstd(raw)[:-5]),
        "dictionary-id": one(dict_frame),
        "raw-blocks": one(_zstd(noise)),
        "rle-block": one(_zstd(bytes(len(raw)))),
        "multi-block": large([_zstd(big.tobytes(), level=3)]),
        "level22": large([_zstd(big.tobytes(), level=22)]),
        "predictor2": large([_zstd(diff.tobytes(), level=5)], extra={317: (3, [2])}),
        "tiles": large(tiles, rows=0),
        "16bit": make_tiff(w, h, [_zstd(np.random.default_rng(3).integers(
            0, 65536, (h, w, 3), dtype=np.uint16).tobytes())],
            {**tags, 258: (3, [16] * 3), 278: (4, [h])}),
    }


ZSTD_FILES = _zstd_files()


@pytest.mark.parametrize("name", sorted(ZSTD_FILES))
def test_zstd_chunks_match_pil(name):
    """Frames from the zstandard module: libtiff reads the first frame of
    each chunk (a skippable frame first, or a frame shorter than the
    chunk, fails; a frame longer is cut), checks the checksum of a frame
    read to its end and refuses a frame naming a dictionary."""
    like_pil(ZSTD_FILES[name], ("RGB", "L"))


def test_zstd_decoder_against_the_zstandard_module():
    """Frames of every block and literal kind the zstandard module writes,
    with checksums (XXH64), decode to their content."""
    lib = tiff._zstd()
    rng = np.random.default_rng(11)
    text = b" ".join(rng.choice([b"alpha", b"beta", b"gamma", b"delta", b"pi"], 20000))
    for data in (b"", b"a", text, text[:1000], rng.integers(0, 4, 300000, dtype=np.uint8).tobytes(),
                 photo(300, 400, 3, 5).tobytes()):
        for level in (1, 3, 9, 19):
            frame = _zstd(data, level=level, write_checksum=True)
            out = np.empty(len(data), np.uint8)
            n = lib.zstd_decode_first(frame, len(frame), out.ctypes.data, len(data))
            assert n == len(data) and out.tobytes() == data, level


# ---- CCITT RLE-W, ThunderScan -----------------------------------------------------------------


def _move_strip(data: bytes, by: int) -> bytes:
    """The single strip of a make_tiff file moved `by` bytes later."""
    off = tiff.Frame(data).chunks()[0][6]
    out = bytearray(data[:off] + bytes(by) + data[off:])
    at = bytes(out).find(struct.pack("<HHII", 273, 4, 1, off))
    struct.pack_into("<I", out, at + 8, off + by)
    return bytes(out)


@pytest.mark.parametrize("odd", [False, True], ids=["even-offset", "odd-offset"])
@pytest.mark.parametrize("size", [(1, 16), (5, 16), (9, 53), (40, 333), (3, 1000)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rlew_tiff_matches_pil(size, odd):
    """Compression 32771 as PIL's libtiff writes it (tiff_raw_16), read at
    the strip's offset and one byte later: Fax3DecodeRLE aligns rows to the
    file's 16-bit words and can start a row on the encoder's pad byte."""
    rng = np.random.default_rng(size[1])
    for p in (0.5, 0.9, 0.1):
        data = pil_save(Image.fromarray(rng.random(size) > p), "TIFF", compression="tiff_raw_16")
        f = tiff.Frame(data)
        _, _, _, _, _, _, off, cnt = f.chunks()[0]
        built = make_tiff(size[1], size[0], [data[off:off + cnt]],
                          {258: (3, [1]), 259: (3, [32771]), 262: (3, [0]), 277: (3, [1])})
        like_pil(_move_strip(built, 1) if odd else built, ("L", "RGB"))


def thunder_row(px, rng) -> bytes:
    """ThunderScan codes for one row of 4-bit pixels: runs of the last
    pixel, 2- and 3-bit deltas and raw pixels, chosen at random."""
    out, last, i, w = [], 0, 0, len(px)
    while i < w:
        n = 0
        while i + n < w and px[i + n] == last and n < 63:
            n += 1
        if n >= 2:
            out.append(n)
            i += n
            continue
        deltas = [(int(px[i + k]) - int(px[i + k - 1] if k else last)) & 15
                  for k in range(min(3, w - i))]
        if rng.random() < 0.4 and len(deltas) == 3 and all(d in (0, 1, 15) for d in deltas):
            c = [{0: 0, 1: 1, 15: 3}[d] for d in deltas]
            out.append(0x40 | c[0] << 4 | c[1] << 2 | c[2])
            last, i = int(px[i + 2]), i + 3
            continue
        three = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
        if rng.random() < 0.7 and len(deltas) >= 2 and all(d in three for d in deltas[:2]):
            out.append(0x80 | three[deltas[0]] << 3 | three[deltas[1]])
            last, i = int(px[i + 1]), i + 2
            continue
        out.append(0xC0 | int(px[i]))
        last, i = int(px[i]), i + 1
    return bytes(out)


def _thunder(h, w, photometric=1, rows=None, codes=None, bits=4, tile=False):
    rng = np.random.default_rng(w)
    px = (np.cumsum(rng.integers(-1, 2, (h, w)), 1) % 16).astype(np.uint8)
    px[h // 3:h // 2, w // 4:] = 7
    rows = rows or h
    chunks = codes or [b"".join(thunder_row(r, rng) for r in px[k:k + rows])
                       for k in range(0, h, rows)]
    tags = {258: (3, [bits]), 259: (3, [32809]), 262: (3, [photometric]), 277: (3, [1])}
    if not tile:
        tags[278] = (4, [rows])
    return make_tiff(w, h, chunks, tags, tile=(16, 16) if tile else None)


THUNDER = {
    "one-strip": lambda: _thunder(21, 37),
    "strips": lambda: _thunder(21, 37, rows=8),
    "min-is-white": lambda: _thunder(21, 37, photometric=0, rows=8),
    "runs-end-rows": lambda: _thunder(3, 8, codes=[bytes([0xC5, 0x07, 0xC3, 0x06, 0xC4,
                                                          0xC9, 0x05, 0x89])]),
    "odd-width-runs": lambda: _thunder(3, 7, codes=[bytes([0xC5, 0x06, 0xC3, 0x00, 0x05,
                                                           0xC4, 0x06, 0xC1])]),
    "skips": lambda: _thunder(1, 5, codes=[bytes([0x45, 0x4F, 0x9C])]),
    "too-much": lambda: _thunder(2, 8, codes=[bytes([0xC5, 0x09, 0xC1, 0x07])]),
    "not-enough": lambda: _thunder(2, 8, codes=[bytes([0xC5, 0x03])]),
    "8-bit": lambda: _thunder(4, 8, bits=8, codes=[bytes(40)]),
    "tiles": lambda: _thunder(16, 16, tile=True, codes=[bytes([0xC1, 0x0F] * 16)]),
}


@pytest.mark.parametrize("case", sorted(THUNDER))
def test_thunderscan_tiff_matches_pil(case):
    """Compression 32809 written here (libtiff has no encoder): 4-bit grey
    rows of runs, deltas (with their skip codes) and raw pixels; a row with
    too many or too few pixels, other sample sizes and tiles fail."""
    like_pil(THUNDER[case](), ("L", "RGB"))


# ---- 12-bit samples, the YCbCr predictor ------------------------------------------------------


def pack12(a: np.ndarray) -> bytes:
    """Rows of 12-bit samples, two in three bytes, most significant first."""
    h, w = a.shape
    b = np.zeros((h, w + (w & 1)), np.uint16)
    b[:, :w] = a
    hi, lo = b[:, 0::2], b[:, 1::2]
    out = np.stack([hi >> 4, ((hi & 15) << 4) | (lo >> 8), lo & 255], -1).astype(np.uint8)
    return out.reshape(h, -1)[:, :(w * 12 + 7) // 8].tobytes()


@pytest.mark.parametrize("endian", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", [1, 5, 32773, 50000])
def test_12bit_tiff_matches_pil(compression, predictor, endian):
    """PIL's (II, 1, (1,), 1, (12,), ()) layout, "I;16" through its "I;12"
    unpacker; big-endian files are unidentified; Predictor 2 refuses 12-bit
    samples."""
    from tests.test_torch_ldr import packbits_encode

    v = np.random.default_rng(compression).integers(0, 4096, (13, 19)).astype(np.uint16)
    raw = pack12(v)
    chunk = {1: raw, 5: lzw_encode(raw), 32773: packbits_encode(raw),
             50000: _zstd(raw)}[compression]
    data = make_tiff(19, 13, [chunk], {258: (3, [12]), 259: (3, [compression]),
                                       262: (3, [1]), 277: (3, [1]), 317: (3, [predictor])},
                     endian=endian)
    like_pil(data, ("L", "RGB"))
    if endian == "<" and (predictor == 1 or compression in (1, 32773)):
        assert np.array_equal(tiff.decode_tiff(data)[0], v)


def _jpeg12(img: np.ndarray, kind: str) -> bytes:
    h, w = img.shape
    if kind == "lossless":
        return ljpeg_encode(img.astype(np.uint16), precision=12)
    co = coefficients(img, [(1, 1)], [np.full(64, 4)], bits=12)
    prog = kind == "prog"
    return arith_jpeg(co, w, h, [(1, 1)], [np.full(64, 4)], precision=12, progressive=prog,
                      scans=[((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 1), ((0,), 1, 63, 1, 0)]
                      if prog else None)


@pytest.mark.parametrize("size", [(16, 24), (40, 64), (13, 19)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["seq", "prog", "lossless", "12-in-8"])
def test_12bit_jpeg_in_tiff_matches_pil(kind, size):
    """12-bit JPEG strips (libjpeg-turbo's 12-bit decoder through libtiff:
    jidctint.c with PASS1_BITS 1, 12-bit lossless), packed back into 12-bit
    samples; a 12-bit stream in an 8-bit TIFF fails. tif_jpeg.c packs the
    samples in pairs and never writes the last one of an odd row: PIL's
    sample there is whatever its strip buffer held, the port's is 0
    (ROADMAP Known differences), so odd widths compare the rest."""
    h, w = size
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(x * 50 + y * 30 + np.random.default_rng(w).normal(0, 100, (h, w)), 0, 4095)
    bits = 8 if kind == "12-in-8" else 12
    data = make_tiff(w, h, [_jpeg12(img, "seq" if kind == "12-in-8" else kind)],
                     {258: (3, [bits]), 259: (3, [7]), 262: (3, [1]), 277: (3, [1])})
    if w % 2 == 0 or kind == "12-in-8":
        like_pil(data, ("L", "RGB"))
        return
    want = np.asarray(Image.open(io.BytesIO(data)))
    got, mode = tiff.decode_tiff(data)
    assert mode == "I;16" and got.dtype == np.uint16
    assert np.array_equal(got[:, :-1], want[:, :-1]) and not got[:, -1].any()


def _hdiff(raw: bytes, rowsize: int) -> bytes:
    """Horizontal differencing with a stride of 3 over rows of `rowsize`."""
    a = np.frombuffer(raw, np.uint8).copy()
    if rowsize % 3 or len(a) % rowsize:
        return raw
    r = a.reshape(-1, rowsize // 3, 3).astype(np.int16)
    return np.diff(np.concatenate([np.zeros_like(r[:, :1]), r], 1), axis=1).astype(
        np.uint8).tobytes()


@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("sub", [(2, 2), (2, 1), (1, 2), (4, 4), (4, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_subsampled_ycbcr_with_predictor_matches_pil(sub, tiled):
    """libtiff runs Predictor 2 over the sampling blocks in "rows" of
    TIFFScanlineSize (strips) or TIFFTileRowSize (tiles) bytes with a
    stride of 3; where those sizes do not divide, its RGBA reader (PIL's,
    stoponerr 0) goes on with the undifferenced blocks. A 4x4 tile cut at
    the right edge is read with putcontig8bitYCbCr44tile's 10-byte skew."""
    hs, vs = sub
    for h, w in ((13, 14), (8, 12)) if tiled else ((16, 24), (13, 18)):
        img = photo(h, w, 3, 3)
        th, tw = (16, 16) if tiled else (h, w)
        bv, bh = -(-th // vs), -(-tw // hs)
        y = np.zeros((th, tw), np.uint8)
        y[:h, :w] = img[..., 0]
        cb = np.zeros((bv, bh), np.uint8)
        cr = np.zeros((bv, bh), np.uint8)
        cb[:-(-h // vs), :-(-w // hs)] = img[::vs, ::hs, 1]
        cr[:-(-h // vs), :-(-w // hs)] = img[::vs, ::hs, 2]
        blocks = ycbcr_blocks(y, cb, cr, hs, vs)
        rowsize = tw * 3 if tiled else (bh * (hs * vs + 2)) // vs
        for predictor in (1, 2):
            chunk = blocks if predictor == 1 else _hdiff(blocks, rowsize)
            tags = {258: (3, [8] * 3), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]),
                    530: (3, [hs, vs]), 317: (3, [predictor])}
            if not tiled:
                tags[278] = (4, [h])
            like_pil(make_tiff(w, h, [lzw_encode(chunk)], tags,
                               tile=(16, 16) if tiled else None), ("RGB",))


# ---- what PIL's libtiff does not decode ---------------------------------------------------------


@pytest.mark.parametrize("case", ["webp", "sgilog-rgb", "sgilog24-grey", "sgilog-logluv",
                                  "sgilog-logl"])
def test_undecodable_codecs_raise_as_pil(case):
    """WebP (PIL's libtiff is built without it) and SGILog (libtiff takes it
    only under a LogLuv or LogL photometric, which PIL does not open)."""
    comp, photometric, spp, bits = {
        "webp": (50001, 2, 3, 8), "sgilog-rgb": (34676, 2, 3, 8),
        "sgilog24-grey": (34677, 1, 1, 8), "sgilog-logluv": (34676, 32844, 3, 16),
        "sgilog-logl": (34676, 32845, 1, 16)}[case]
    data = make_tiff(16, 8, [b"RIFF\0\0\0\0WEBPVP8L" + bytes(40)],
                     {258: (3, [bits] * spp), 259: (3, [comp]), 262: (3, [photometric]),
                      277: (3, [spp]), 278: (4, [8])})
    like_pil(data, ("RGB",))


def _segs(stream: bytes) -> list:
    """(marker, payload) of a JPEG's segments, then ("data", the scan)."""
    pos, out = 2, []
    while True:
        marker, ln = stream[pos + 1], struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        out.append((marker, stream[pos + 4:pos + 2 + ln]))
        if marker == 0xDA:
            return out + [("data", stream[pos + 2 + ln:-2])]
        pos += 2 + ln


def ojpeg_tags(stream: bytes) -> dict:
    """A JPEG's tables as old-style JPEG tags: JPEGProc, each component's
    JPEGQTables, JPEGDCTables and JPEGACTables entry, JPEGRestartInterval."""
    segs = _segs(stream)
    qt, dc, ac = {}, {}, {}
    for marker, p in segs:
        i = 0
        while marker == 0xDB and i < len(p):
            qt[p[i] & 15] = p[i + 1:i + 65]
            i += 65
        while marker == 0xC4 and i < len(p):
            n = sum(p[i + 1:i + 17])
            (ac if p[i] >> 4 else dc)[p[i] & 15] = p[i + 1:i + 17 + n]
            i += 17 + n
    sof = next(p for m, p in segs if m == 0xC0)
    sos = next(p for m, p in segs if m == 0xDA)
    nc = sof[5]
    tags = {512: (3, [1]), 519: (4, ("blobs", [qt[sof[8 + 3 * k]] for k in range(nc)])),
            520: (4, ("blobs", [dc[sos[2 + 2 * k] >> 4] for k in range(nc)])),
            521: (4, ("blobs", [ac[sos[2 + 2 * k] & 15] for k in range(nc)]))}
    dri = [p for m, p in segs if m == 0xDD]
    if dri:
        tags[515] = (3, [struct.unpack(">H", dri[0])[0]])
    return tags


def ojpeg_file(h: int, w: int, sub: str, layout: str, restarts: bool = False, seed: int = 1,
               grey: bool = False) -> bytes:
    """An old-style JPEG TIFF of a PIL JPEG: "jif" (JPEGInterchangeFormat
    holding the whole stream), "jif-header" (it ends at the SOS; the strips
    hold the scan), "tables" (the tables in tags, the strips the scan) or
    "stream" (one strip holding the whole stream); with `restarts`, a
    restart every MCU row and a strip a MCU row, the markers left out of
    the strips (libtiff writes them between strips)."""
    img = photo(h, w, 3, seed)
    kw = {"quality": 90}
    if not grey:
        kw["subsampling"] = sub
    if restarts:
        kw["restart_marker_rows"] = 1
    stream = pil_save(Image.fromarray(img[..., 0] if grey else img), "JPEG", **kw)
    segs = _segs(stream)
    sof = next(p for m, p in segs if m == 0xC0)
    hs, vs = sof[7] >> 4, sof[7] & 15
    data = segs[-1][1]
    chunks = [data]
    if restarts:
        chunks = re.split(rb"\xff[\xd0-\xd7]", data)
    spp = 1 if grey else 3
    tags = {258: (3, [8] * spp), 259: (3, [6]), 262: (3, [1 if grey else 6]),
            277: (3, [spp]), 278: (4, [8 * vs if restarts else h])}
    if not grey:
        tags[530] = (3, [hs, vs])
    sos_end = stream.index(b"\xff\xda") + 2 + struct.unpack(">H", stream[stream.index(
        b"\xff\xda") + 2:][:2])[0]
    if layout == "jif":
        tags.update({513: (4, ("blobs", [stream])), 514: (4, [len(stream)])})
    elif layout == "jif-header":
        tags.update({513: (4, ("blobs", [stream[:sos_end]])), 514: (4, [sos_end])})
    elif layout == "tables":
        tags.update(ojpeg_tags(stream))
    else:
        chunks = [stream]
    return make_tiff(w, h, chunks, tags)


@pytest.mark.parametrize("layout,restarts", [
    ("jif", False), ("jif", True), ("jif-header", False), ("jif-header", True),
    ("tables", False), ("tables", True), ("stream", False)],
    ids=lambda v: {True: "strips", False: "one-strip"}.get(v, v) if isinstance(v, bool) else v)
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "grey"])
def test_old_style_jpeg_matches_pil(sub, layout, restarts):
    """Compression 6 as libtiff's tif_ojpeg.c reads it for PIL's RGBA
    reader: the stream's raw component samples (no upsampling) through
    libtiff's YCbCr tables in sampling blocks, the subsampling the SOF's;
    the JPEGInterchangeFormat stream, or a header (its own, or one written
    from the tables in the tags) before the strips' data with a restart
    marker written between strips."""
    for h, w in ((40, 64), (37, 53)):
        like_pil(ojpeg_file(h, w, sub, layout, restarts, grey=sub == "grey"), ("RGB", "L"))


@pytest.mark.parametrize("case", ["progressive", "refbw", "photometric-rgb", "subsampling-tag"])
def test_old_style_jpeg_variants_match_pil(case):
    """A progressive stream fails as in libtiff; ReferenceBlackWhite sets
    the conversion; a photometric of RGB is read as YCbCr; the subsampling
    comes from the SOF, whatever YCbCrSubsampling says."""
    h, w = 40, 64
    img = photo(h, w, 3, 2)
    stream = pil_save(Image.fromarray(img), "JPEG", quality=90, subsampling="4:2:0",
                      progressive=case == "progressive")
    tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [2 if case == "photometric-rgb" else 6]),
            277: (3, [3]), 278: (4, [h]), 530: (3, [1, 1] if case == "subsampling-tag" else [2, 2]),
            513: (4, ("blobs", [stream])), 514: (4, [len(stream)])}
    if case == "refbw":
        tags[532] = (5, [(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])
    like_pil(make_tiff(w, h, [stream], tags), ("RGB", "L"))


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
def test_old_style_jpeg_strips_without_restarts_match_pil(sub):
    """Several strips after a header without a restart interval: libtiff
    runs one libjpeg session a strip, each strip's data after the whole
    frame's header, so a strip cut anywhere in the scan decodes from its
    own first bit (a marker-free cut: libjpeg and the port fill the rest
    with what its recovery gives)."""
    h, w = 40, 64
    stream = pil_save(Image.fromarray(photo(h, w, 3, 4)), "JPEG", quality=90, subsampling=sub)
    data = _segs(stream)[-1][1]
    vs = 2 if sub == "4:2:0" else 1
    n = -(-h // (8 * vs))
    cuts = [data[k * len(data) // n:(k + 1) * len(data) // n] for k in range(n)]
    tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            530: (3, [vs, vs]), 278: (4, [8 * vs]), **ojpeg_tags(stream)}
    like_pil(make_tiff(w, h, cuts, tags), ("RGB",))


@pytest.mark.parametrize("case", ["strips-of-part-mcu-rows", "tiles"])
def test_old_style_jpeg_refusals_name_a10d_c(case):
    """What of old-style JPEG stays refused names ROADMAP A.10d-c: strips
    of other than whole MCU rows without a restart interval, and tiles."""
    stream = pil_save(Image.fromarray(photo(32, 32, 3, 3)), "JPEG", quality=90)
    data = _segs(stream)[-1][1]
    tags = {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]), 530: (3, [2, 2]),
            **ojpeg_tags(stream)}
    if case == "tiles":
        built = make_tiff(32, 32, [data], tags, tile=(32, 32))
    else:
        built = make_tiff(32, 32, [data[k * len(data) // 4:(k + 1) * len(data) // 4]
                                   for k in range(4)], {**tags, 278: (4, [8])})
    with pytest.raises(NotImplementedError, match="A.10d-c"):
        tiff.decode_tiff(built)


# ---- load_image and read_tiff16_rgb against JAX ---------------------------------------------


def _family() -> dict:
    img = photo(24, 40, 3, 9)
    return {
        "arith.jpg": arith_file("420", "prog-rst", 24, 40, 9),
        "zstd.tif": pil_save(Image.fromarray(img), "TIFF", compression="zstd",
                             tiffinfo={317: 2}),
        "rlew.tif": pil_save(Image.fromarray(img[..., 0] > 120), "TIFF",
                             compression="tiff_raw_16"),
        "thunder.tif": _thunder(24, 40, rows=8),
        "twelve.tif": make_tiff(40, 24, [lzw_encode(pack12(img[..., 0].astype(np.uint16) * 16))],
                                {258: (3, [12]), 259: (3, [5]), 262: (3, [1]), 277: (3, [1])}),
        "ycbcr-pred.tif": make_tiff(40, 24, [lzw_encode(_hdiff(ycbcr_blocks(
            img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2], 2, 2), 60))],
            {258: (3, [8] * 3), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]),
             530: (3, [2, 2]), 317: (3, [2])}),
        "ojpeg.tif": ojpeg_file(24, 40, "4:2:0", "jif-header", restarts=True, seed=9),
    }


@pytest.mark.parametrize("name", sorted(_family()))
def test_load_image_matches_jax(name, tmp_path):
    """max |d| 0 against JAX's load_image run op by op, one file a family."""
    path = tmp_path / name
    path.write_bytes(_family()[name])
    with jax.disable_jit():
        want, want_raw = jloader.load_image(path, app_settings=JAppSettings({}))
    got, raw = loader.load_image(path, app_settings=AppSettings({}), device="cpu")
    assert raw is want_raw is False
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) == 0.0


@pytest.mark.parametrize("compression", [50000, 32809, 32771, 34676, 50001])
def test_read_tiff16_rgb_matches_jax(compression, tmp_path):
    """A 16-bit RGB file in each new codec: cv2 5.0's libtiff has no ZSTD
    or WebP and fails the rest at 16 bits, so JAX's read is None (its
    loader then reads 8 bits through PIL), and so is the port's."""
    a16 = np.random.default_rng(4).integers(0, 65536, (8, 16, 3), dtype=np.uint16)
    chunk = _zstd(a16.tobytes()) if compression == 50000 else bytes(100)
    data = make_tiff(16, 8, [chunk], {258: (3, [16] * 3), 259: (3, [compression]),
                                      262: (3, [2]), 277: (3, [3]), 278: (4, [8])})
    (tmp_path / "a.tif").write_bytes(data)
    assert jencode.read_tiff16_rgb(tmp_path / "a.tif") is None
    assert tiff.read_tiff16_rgb(data) is None


# ---- chip_smoke phase 24's builders ---------------------------------------------------------


@pytest.mark.parametrize("name", chip_smoke.LDR_B_TALL)
def test_phase24_builders_read_as_written(name):
    """The tall files of phase 24 (`chip_smoke.tall_variant_b`) repeat a
    committed fixture's restart intervals (each resets the QM coder's
    statistics and DC predictions) or name its strip again: at 5 repeats
    PIL reads them (a JPEG as the strip of a JPEG-compressed YCbCr TIFF,
    where libtiff hands libjpeg the whole stream) as the port does, the
    ZSTD file is the fixture stacked 5 times, and a JPEG's bands of
    LDR_B_ROWS rows after the first and before the last are alike (fancy
    upsampling reads across each band's edges), as phase 24 checks."""
    fixture = (FIXTURES / name).read_bytes()
    data = chip_smoke.tall_variant_b(name, fixture, 5)
    one = open_image(fixture).convert("RGB")
    rows = one.shape[0]
    if name.endswith(".tif"):
        got = open_image(data).convert("RGB")
        assert np.array_equal(got, np.concatenate([one] * 5, 0))
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), got)
        return
    got = jpeg.jpeg_components(data, pil=False)
    w = got.shape[1]
    strip = make_tiff(w, rows * 5, [data], {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]),
                                            277: (3, [3]), 530: (3, [2, 2])})
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(strip))), got)
    bands = got.reshape(5, rows, w, 3)
    assert all(np.array_equal(bands[k], bands[1]) for k in (2, 3))
    assert np.array_equal(bands[0][:rows - 1], one[:rows - 1])
