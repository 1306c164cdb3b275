"""The JPEG and TIFF variants of ROADMAP A.10d's first half against PIL 12.1
(libjpeg-turbo, libtiff 4.7.1, littlecms 2.17) and the JAX package, on the
CPU.

- JPEG (csrc/host/jpeg_dec.cc through io/jpeg.py): CMYK, YCCK and Adobe
  transform variants, 8-bit lossless (SOF3) at every predictor, point
  transform, restart interval and sampling, and the frames PIL turns away
  or libjpeg refuses (12-bit, two components, fractional sampling, a
  lossless frame in YCbCr), each raising PIL's exception class.
- TIFF (io/tiff.py, io/tiff_photometric.py, csrc/host/ccitt_dec.cc and
  tiff_codec.cc): every compression PIL writes for CMYK, YCbCr, Lab, RGB,
  L and 1; CCITT (2, 3 in 1-D and 2-D with and without fill bits, 4) in
  both photometric senses and fill orders; YCbCr subsampled in every way
  libtiff's RGBA interface reads, with ReferenceBlackWhite; JPEG strips and
  tiles after JPEGTables; old-style LZW; FillOrder 2; float, int32,
  signed 8- and 16-bit samples with predictors 1-3 in both byte orders;
  the planar layouts; Lab's conversion over all 2^24 values.
- `load_image` against the JAX loader (max |d| 0) on one file of each
  family; a HALD LUT stored in a 12-bit JPEG dropped by the export as JAX
  drops it; the fixtures of tests/fixtures/ldr against their digests.

`like_pil` holds the port to PIL: the mode, the samples `np.asarray` gives
and `convert(m)` for each mode asked, or the exception class PIL raises
(UnidentifiedImageError and `image_decode.Unidentified` are OSErrors).
"""

from __future__ import annotations

import hashlib
import io
import json
import lzma
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

import chip_smoke
from chip_smoke import float_predicted, ycbcr_blocks
from chip_smoke import tiff_chunks as make_tiff
from rapidraw_tpu.io import loader as jloader
from rapidraw_tpu.utils.settings import AppSettings as JAppSettings
from rapidraw_tpu_torch.io import jpeg, loader, tiff
from rapidraw_tpu_torch.io.image_decode import Unidentified, open_image
from rapidraw_tpu_torch.utils.settings import AppSettings
from tests.test_torch_ldr import lzw_encode, packbits_encode, tiff_bytes

jax.config.update("jax_platforms", "cpu")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "ldr"
REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def like_pil(data: bytes, modes=("RGB", "L"), samples: bool = True) -> None:
    """The port opens `data` as PIL does: the same mode, samples (unless
    `samples` is False: a TIFF palette image, which the port gives through
    its palette) and conversions, or the exception class PIL raises."""
    try:
        im = Image.open(io.BytesIO(data))
        im.load()
        want = (im.mode, np.asarray(im), {m: np.asarray(im.convert(m)) for m in modes})
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        want = e
    if isinstance(want, Exception):
        with pytest.raises(Exception) as got:
            frame = open_image(data)
            for m in modes:
                frame.convert(m)
        if isinstance(want, (UnidentifiedImageError, OSError)):
            assert isinstance(got.value, OSError), (repr(want), repr(got.value))
        else:
            assert isinstance(got.value, type(want)), (repr(want), repr(got.value))
        return
    mode, px, conv = want
    frame = open_image(data)
    for m in modes:
        assert np.array_equal(frame.convert(m), conv[m]), m
    if not samples:
        return
    assert frame.mode == mode
    got = frame.px if mode != "1" else frame.px > 0
    assert got.shape == px.shape and np.array_equal(got, px, equal_nan=px.dtype.kind == "f")


def photo(h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    """(h, w, c) u8: gradients, edges and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3 + 40 * k) % 256 for k in range(c)], -1).astype(float)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def pil_save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ---- writers -------------------------------------------------------------------------


def lzw_compat_encode(data: bytes) -> bytes:
    """Old-style TIFF LZW, as libtiff's LZWDecodeCompat reads it: codes LSB
    first, the width growing once the decoder's next entry passes the
    widest code, a Clear before the table fills."""
    out, acc, nacc, width = bytearray(), 0, 0, 9

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    table, nxt, dec_next, count = None, 0, 0, 0

    def reset():
        nonlocal table, nxt, dec_next, count, width
        table, nxt, dec_next, count, width = {bytes([i]): i for i in range(256)}, 258, 258, 0, 9

    def code(c):
        nonlocal dec_next, count, width
        emit(c)
        count += 1
        if count >= 2:  # the decoder adds an entry from the second code on
            dec_next += 1
            if dec_next > (1 << width) - 1 and width < 12:
                width += 1

    reset()
    emit(256)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        code(table[w])
        table[wc] = nxt
        nxt += 1
        w = bytes([ch])
        if dec_next >= 4000:
            code(table[w])
            w = b""
            emit(256)
            reset()
    if w:
        code(table[w])
    emit(257)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def ljpeg8(px: np.ndarray, psv: int = 1, pt: int = 0, restart_rows: int = 0,
           app: bytes = b"", se: int = 0, hv=None, ids=None) -> bytes:
    """An 8-bit lossless JPEG (SOF3, one interleaved scan) of (H, W, C) u8,
    predictor `psv`, point transform `pt`, a restart every `restart_rows`
    MCU rows, sampling `hv` per component; Huffman codes of 5 bits, the
    code the category."""
    px = np.asarray(px)
    px = px[..., None] if px.ndim == 2 else px
    h, w, nc = px.shape
    hv = hv or [0x11] * nc
    hs, vs = [v >> 4 for v in hv], [v & 15 for v in hv]
    hmax, vmax = max(hs), max(vs)
    # each component at its own size: the top-left of the frame's samples
    comps = [px[:-(-h * vs[c] // vmax), :-(-w * hs[c] // hmax), c].astype(np.int64) >> pt
             for c in range(nc)]
    per_row, mcu_rows = -(-w // hmax), -(-h // vmax)

    def predict(s, y, x, first):
        if first:
            return (1 << (7 - pt)) if x == 0 else s[y, x - 1]
        if x == 0:
            return s[y - 1, 0]
        ra, rb, rc = s[y, x - 1], s[y - 1, x], s[y - 1, x - 1]
        return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]

    chunks, words = [], []
    for r in range(mcu_rows):
        if restart_rows and r and r % restart_rows == 0:
            chunks.append(words)
            words = []
        for m in range(per_row):
            for c in range(nc):
                s = comps[c]
                for yy in range(vs[c]):
                    for xx in range(hs[c]):
                        y, x = r * vs[c] + yy, m * hs[c] + xx
                        d = 0
                        if y < s.shape[0] and x < s.shape[1]:
                            first = y == 0 or bool(restart_rows and y % (restart_rows * vs[c]) == 0)
                            d = int((s[y, x] - predict(s, y, x, first)) & 0xFFFF)
                        d = d - 0x10000 if d >= 0x8000 else d
                        if d == -32768:
                            words.append((16, 5))
                            continue
                        cat = abs(d).bit_length()
                        words.append((cat, 5))
                        if cat:
                            words.append((d if d > 0 else d + (1 << cat) - 1, cat))
    chunks.append(words)

    def pack(ws):
        out, acc, n = bytearray(), 0, 0
        for v, ln in ws:
            acc, n = (acc << ln) | (v & ((1 << ln) - 1)), n + ln
            while n >= 8:
                n -= 8
                out.append((acc >> n) & 0xFF)
                if out[-1] == 0xFF:
                    out.append(0)
        if n:
            out.append(((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 0xFF)
            if out[-1] == 0xFF:
                out.append(0)
        return bytes(out)

    data = b"".join((bytes([0xFF, 0xD0 + (i - 1) % 8]) if i else b"") + pack(c)
                    for i, c in enumerate(chunks))

    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    ids = ids or list(range(1, nc + 1))
    dht = bytes([0x00] + [0, 0, 0, 0, 17] + [0] * 11 + list(range(17)))
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(bytes([ids[c], hv[c], 0])
                                                        for c in range(nc))
    sos = bytes([nc]) + b"".join(bytes([ids[c], 0]) for c in range(nc)) + bytes([psv, se, pt])
    dri = seg(0xFFDD, struct.pack(">H", restart_rows * per_row)) if restart_rows else b""
    return (b"\xff\xd8" + app + seg(0xFFC4, dht) + dri + seg(0xFFC3, sof) + seg(0xFFDA, sos)
            + data + b"\xff\xd9")


ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def with_adobe(data: bytes, transform: int | None) -> bytes:
    """`data` with its Adobe APP14 segment's transform set, or removed
    (None), or one added after SOI."""
    at = data.find(b"Adobe") - 4
    if at >= 0 and data[at:at + 2] == b"\xff\xee":
        ln = struct.unpack(">H", data[at + 2:at + 4])[0]
        if transform is None:
            return data[:at] + data[at + 2 + ln:]
        b = bytearray(data)
        b[at + 4 + 11] = transform
        return bytes(b)
    return data if transform is None else data[:2] + ADOBE + bytes([transform]) + data[2:]


# ---- JPEG: CMYK, YCCK, lossless and C.1 ---------------------------------------------------


@pytest.mark.parametrize("adobe", ["as-written", "ycck", "transform1", "none"])
@pytest.mark.parametrize("sub", [0, 1, 2])
def test_cmyk_jpeg_matches_pil(sub, adobe):
    """Four components: CMYK as libjpeg gives it, YCCK through its YCC
    tables; PIL inverts every CMYK JPEG ("CMYK;I"), Adobe marker or not."""
    data = pil_save(Image.fromarray(photo(37, 29, 4, sub), "CMYK"), "JPEG", quality=80,
                    subsampling=sub)
    data = with_adobe(data, {"as-written": 0, "ycck": 2, "transform1": 1, "none": None}[adobe])
    like_pil(data, ("RGB", "RGBA", "L"))


def test_lossless_jpeg_chip_smoke_encoder_matches_pil():
    """chip_smoke.ljpeg_encode at 8 bits (component ids 0, 1, 2, 3), for
    one, three and four components."""
    rng = np.random.default_rng(3)
    for nc in (1, 3, 4):
        s = rng.integers(0, 256, (6, 9 * nc)).astype(np.uint16)
        data = chip_smoke.ljpeg_encode(s, precision=8, ncomp=nc)
        like_pil(data, ("RGB", "L"))
        px = jpeg.decode_jpeg(data)
        want = s.reshape(px.shape) if nc < 4 else 255 - s.reshape(px.shape)
        assert np.array_equal(px, want)


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_jpeg_predictors_match_pil(psv, pt, nc):
    px = photo(11, 13, nc, psv)
    data = ljpeg8(px, psv, pt)
    like_pil(data)
    assert np.array_equal(jpeg.decode_jpeg(data), ((px >> pt) << pt).squeeze())


@pytest.mark.parametrize("case", ["restart1", "restart3", "restart5", "sub21", "sub22", "sub12",
                                  "sub-mixed", "sub22-restart", "rgb-ids", "adobe0", "cmyk"])
def test_lossless_jpeg_layouts_match_pil(case):
    """Restart intervals of whole MCU rows, subsampled components (libjpeg
    replicates them: no fancy upsampling for a lossless frame), RGB ids and
    Adobe transform 0."""
    px = photo(11, 13, 3, 1)
    kw = {"restart1": {"restart_rows": 1}, "restart3": {"restart_rows": 3},
          "restart5": {"restart_rows": 5}, "sub21": {"hv": [0x21, 0x11, 0x11]},
          "sub22": {"hv": [0x22, 0x11, 0x11]}, "sub12": {"hv": [0x12, 0x11, 0x11]},
          "sub-mixed": {"hv": [0x11, 0x21, 0x12]},
          "sub22-restart": {"hv": [0x22, 0x11, 0x11], "restart_rows": 2},
          "rgb-ids": {"ids": [82, 71, 66]}, "adobe0": {"app": ADOBE + b"\x00"},
          "cmyk": {}}[case]
    if case == "cmyk":
        px = photo(7, 10, 4, 2)
    like_pil(ljpeg8(px, 4, 0, **kw), ("RGB", "L"))


@pytest.mark.parametrize("case", ["jfif", "adobe1", "adobe2-cmyk", "se1", "psv0", "psv8",
                                  "restart-not-rows", "pt8"])
def test_lossless_jpeg_refusals_match_pil(case):
    """What libjpeg refuses in a lossless frame: colour conversion (JFIF or
    an Adobe transform other than 0), Se != 0, predictors outside 1-7, a
    restart interval that is not whole MCU rows, Al >= 8."""
    px = photo(6, 8, 3, 2)
    if case == "jfif":
        data = ljpeg8(px, app=JFIF)
    elif case == "adobe1":
        data = ljpeg8(px, app=ADOBE + b"\x01")
    elif case == "adobe2-cmyk":
        data = ljpeg8(photo(6, 8, 4, 2), app=ADOBE + b"\x02")
    elif case == "se1":
        data = ljpeg8(px, se=1)
    elif case in ("psv0", "psv8", "pt8"):
        data = bytearray(ljpeg8(px))
        at = bytes(data).index(b"\xff\xda") + 4 + 1 + 2 * 3
        if case == "pt8":
            data[at + 2] = 8
        else:
            data[at] = 0 if case == "psv0" else 8
        data = bytes(data)
    else:
        data = ljpeg8(px, restart_rows=2)
        at = data.index(b"\xff\xdd")
        data = data[:at + 4] + struct.pack(">H", 5) + data[at + 6:]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(OSError):
        jpeg.decode_jpeg(data)


def _sof_patched(data: bytes, at: int, value: int) -> bytes:
    b = bytearray(data)
    b[data.index(b"\xff\xc0") + at] = value
    return bytes(b)


@pytest.mark.parametrize("case", ["12-bit", "16-bit", "2-components", "5-components",
                                  "fraction-3/2", "fraction-1/3", "fraction-v", "integral-3x1"])
def test_c1_frames_raise_pil_exception(case):
    """Fault C.1: a frame other than 8 bits, or of 2 or 5 components, is
    one PIL's reader turns away while opening (UnidentifiedImageError, the
    port's Unidentified); fractional sampling factors are a libjpeg error
    ("broken data stream"); an integral 3x1 decodes."""
    base = pil_save(Image.fromarray(photo(16, 16, 3)), "JPEG", quality=85)
    data = {"12-bit": _sof_patched(base, 4, 12), "16-bit": _sof_patched(base, 4, 16),
            "2-components": _sof_patched(base, 9, 2), "5-components": _sof_patched(base, 9, 5),
            "fraction-3/2": _sof_patched(_sof_patched(base, 11, 0x22), 14, 0x31),
            "fraction-1/3": _sof_patched(_sof_patched(base, 11, 0x12), 14, 0x13),
            "fraction-v": _sof_patched(base, 17, 0x13),
            "integral-3x1": _sof_patched(_sof_patched(base, 11, 0x11), 14, 0x11)}[case]
    if case.startswith(("12", "16", "2-", "5-")):
        with pytest.raises(UnidentifiedImageError):
            Image.open(io.BytesIO(data))
        with pytest.raises(Unidentified):
            open_image(data)
        with pytest.raises(Unidentified):
            jpeg.decode_jpeg(data)
        return
    like_pil(data)


def test_arithmetic_jpeg_names_a10d_b():
    """Huffman data under SOF9 and SOF10 reads as PIL reads it (libjpeg's
    QM decoder on it); PIL's SOF checks come first."""
    base = pil_save(Image.fromarray(photo(16, 16, 3)), "JPEG", quality=85)
    for marker in (0xC9, 0xCA):
        data = _sof_patched(base, 1, marker)
        like_pil(data)
    # PIL's header checks come first: a 12-bit arithmetic frame is unidentified
    with pytest.raises(Unidentified):
        jpeg.decode_jpeg(_sof_patched(_sof_patched(base, 4, 12), 1, 0xC9))


# ---- TIFF: what PIL writes ---------------------------------------------------------------------

_PIL_COMPRESSIONS = [None, "tiff_lzw", "packbits", "tiff_adobe_deflate", "jpeg", "lzma"]


def _pil_image(mode: str, h: int = 19, w: int = 23, seed: int = 0) -> Image.Image:
    a = photo(h, w, 4, seed)
    if mode == "1":
        return Image.fromarray(a[..., 0] > 128)
    if mode in ("L", "RGB", "CMYK", "YCbCr", "LAB"):
        n = {"L": 1, "RGB": 3, "CMYK": 4, "YCbCr": 3, "LAB": 3}[mode]
        return Image.frombytes(mode, (w, h), np.ascontiguousarray(a[..., :n]).tobytes())
    raise ValueError(mode)


@pytest.mark.parametrize("compression", _PIL_COMPRESSIONS, ids=str)
@pytest.mark.parametrize("mode", ["CMYK", "YCbCr", "LAB", "RGB", "L"])
def test_pil_written_tiff_matches_pil(mode, compression):
    """CMYK, YCbCr (PIL fails its own uncompressed file: "image file is
    truncated"), Lab (no convert("L") in PIL), RGB and L, every compression
    PIL writes, JPEG among them."""
    data = pil_save(_pil_image(mode), "TIFF", compression=compression)
    like_pil(data, ("RGB", "RGBA", "L"))


def _runs(h: int, w: int, longest: int, seed: int) -> np.ndarray:
    """Rows of alternating runs of random lengths below `longest`."""
    rng = np.random.default_rng(seed)
    a = np.zeros((h, w), bool)
    for y in range(h):
        x, c = 0, bool(rng.integers(2))
        while x < w:
            n = int(rng.integers(0, longest))
            a[y, x:x + n] = c
            x, c = x + n, not c
    return a


CCITT_IMAGES = {
    "noise": lambda: np.random.default_rng(1).random((40, 77)) > 0.5,
    "long-runs": lambda: _runs(24, 3000, 2700, 2),  # the make-up codes past 1728
    "short-runs": lambda: _runs(60, 300, 70, 3),
    "similar-rows": lambda: np.repeat(_runs(1, 500, 40, 4), 30, 0)
    ^ (np.random.default_rng(5).random((30, 500)) > 0.97),
    "white": lambda: np.ones((5, 9), bool),
    "black": lambda: np.zeros((5, 9), bool),
}
CCITT_CODINGS = {"g3-1d": ("group3", {}), "g3-2d": ("group3", {292: 1}),
                 "g3-2d-fill": ("group3", {292: 5}), "g3-1d-fill": ("group3", {292: 4}),
                 "g4": ("group4", {}), "mh": ("tiff_ccitt", {})}


def _set_tag(data: bytes, tag: int, value: int) -> bytes:
    """`data` with IFD0's short `tag` set in place."""
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", data[4:8])
    (n,) = struct.unpack(e + "H", data[ifd:ifd + 2])
    b = bytearray(data)
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack(e + "H", data[at:at + 2])[0] == tag:
            struct.pack_into(e + "H", b, at + 8, value)
            return bytes(b)
    raise KeyError(tag)


@pytest.mark.parametrize("sense", ["min-is-black", "min-is-white"])
@pytest.mark.parametrize("coding", sorted(CCITT_CODINGS))
@pytest.mark.parametrize("image", sorted(CCITT_IMAGES))
def test_ccitt_tiff_matches_pil(image, coding, sense):
    """libtiff's fax codecs (written by libtiff through PIL); white runs are
    0 bits whatever the photometric says, which PIL's "1" and "1;I" raw
    modes then read."""
    comp, info = CCITT_CODINGS[coding]
    data = pil_save(Image.fromarray(CCITT_IMAGES[image]()), "TIFF", compression=comp,
                    tiffinfo=info)
    if sense == "min-is-white":
        data = _set_tag(data, 262, 0)
    like_pil(data)


@pytest.mark.parametrize("coding", ["g3-2d", "g4", "mh"])
def test_ccitt_fill_order_2_matches_pil(coding):
    """FillOrder 2: the strip's bits reversed, which libtiff's fax decoder
    reads least significant first."""
    comp, info = CCITT_CODINGS[coding]
    data = pil_save(Image.fromarray(CCITT_IMAGES["short-runs"]()), "TIFF", compression=comp,
                    tiffinfo=info)
    t = Image.open(io.BytesIO(data)).tag_v2
    strips = [bytes(REVERSED[b] for b in data[o:o + c]) for o, c in zip(t[273], t[279])]
    tags = {259: (3, [t[259]]), 262: (3, [1]), 266: (3, [2]), 278: (4, [t[278]])}
    if 292 in t:
        tags[292] = (4, [t[292]])
    like_pil(make_tiff(t[256], t[257], strips, tags))


# ---- TIFF: YCbCr, JPEG strips and tiles, hand-written codecs --------------------------


REFBW_STUDIO = [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]


@pytest.mark.parametrize("refbw", ["default", "studio"])
@pytest.mark.parametrize("size", [(8, 8), (7, 11), (1, 3), (12, 10)], ids=str)
@pytest.mark.parametrize("sub", [(2, 2), (2, 1), (1, 2), (4, 4), (4, 2), (4, 1), (1, 1), (1, 4),
                                 (2, 4)], ids=str)
def test_ycbcr_tiff_matches_pil(sub, size, refbw):
    """libtiff's RGBA interface: chroma per sampling block, its tables from
    ReferenceBlackWhite, 4x4 strips whose last odd block loses its chroma,
    1x4 and 2x4 refused; LZW (3 strips at 12 rows) and Deflate."""
    rng = np.random.default_rng(sum(sub) + size[0])
    h, w = size
    hs, vs = sub
    rps = 4 if h == 12 else h
    chunks = []
    for comp, enc in ((5, lzw_encode), (8, zlib.compress)):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        cb = rng.integers(0, 256, (-(-h // vs), -(-w // hs)), dtype=np.uint8)
        cr = rng.integers(0, 256, cb.shape, dtype=np.uint8)
        chunks = [enc(ycbcr_blocks(y[r:r + rps], cb[r // vs:], cr[r // vs:], hs, vs))
                  for r in range(0, h, rps)]
        tags = {258: (3, [8, 8, 8]), 259: (3, [comp]), 262: (3, [6]), 277: (3, [3]),
                278: (4, [rps]), 530: (3, [hs, vs])}
        if refbw == "studio":
            tags[532] = (5, REFBW_STUDIO)
        like_pil(make_tiff(w, h, chunks, tags), ("RGB", "L"))


@pytest.mark.parametrize("case", ["tail-0", "tail-20", "tail-200", "spp1", "spp1-lzw",
                                  "planar-lzw", "planar-raw", "coefficients"])
def test_ycbcr_tiff_edge_cases_match_pil(case):
    """PIL's "RGBX" raw mode on an uncompressed YCbCr file (4 bytes a pixel,
    past the strip when the file goes on), one-sample YCbCr (raw "L", and
    libtiff's refusal when compressed), planar (libtiff at 1x1; PIL's raw
    "R", "G", "B"), YCbCrCoefficients."""
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    base = {258: (3, [8, 8, 8]), 262: (3, [6]), 277: (3, [3]), 530: (3, [1, 1])}
    if case.startswith("tail"):
        tail = rng.bytes(int(case[5:]))
        data = make_tiff(5, 4, [px.tobytes() + tail], {**base, 259: (3, [1])})
    elif case.startswith("spp1"):
        comp = 5 if case.endswith("lzw") else 1
        raw = bytes(range(20))
        data = make_tiff(5, 4, [lzw_encode(raw) if comp == 5 else raw],
                         {258: (3, [8]), 259: (3, [comp]), 262: (3, [6]), 277: (3, [1])})
    elif case.startswith("planar"):
        comp = 5 if case.endswith("lzw") else 1
        planes = [px[..., k].tobytes() for k in range(3)]
        data = make_tiff(5, 4, [lzw_encode(p) if comp == 5 else p for p in planes],
                         {**base, 259: (3, [comp]), 284: (3, [2])})
    else:
        data = make_tiff(5, 4, [lzw_encode(px.tobytes())],
                         {**base, 259: (3, [5]), 529: (5, [(2126, 10000), (7152, 10000),
                                                           (722, 10000)])})
    like_pil(data)


def _jpeg_parts(px: np.ndarray, **kw) -> tuple[bytes, bytes]:
    """A PIL JPEG of `px` cut into the JPEGTables (SOI, DQT, DHT, EOI) and
    an abbreviated stream (SOI, SOF, SOS and data, EOI)."""
    data = pil_save(Image.fromarray(px), "JPEG", **kw)
    pos, tables, body = 2, bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    while True:
        marker = data[pos + 1]
        ln = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + ln]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif marker != 0xE0:
            body += seg if marker != 0xDA else data[pos:]
        if marker == 0xDA:
            break
        pos += 2 + ln
    return bytes(tables + b"\xff\xd9"), bytes(body)


@pytest.mark.parametrize("layout", ["strips", "tiles", "ycbcr-22-strips", "ycbcr-22-tiles",
                                    "grey-tiles", "no-tables"])
def test_jpeg_in_tiff_matches_pil(layout):
    """Compression 7 written here: strips and tiles (partial at the right
    and bottom edges) as abbreviated streams after JPEGTables, YCbCr 2x2
    converted by libjpeg (JPEGCOLORMODE_RGB, fancy upsampling within each
    strip or tile), RGB and grey as stored."""
    h, w = 37, 45
    img = photo(h, w, 3, 4)
    ycc = layout.startswith("ycbcr")
    grey = layout == "grey-tiles"
    src = img[..., 0] if grey else img
    photometric = 6 if ycc else (1 if grey else 2)
    spp = 1 if grey else 3
    kw = {"quality": 85, "subsampling": "4:2:0" if ycc else "4:4:4"}
    if layout.endswith("tiles"):
        tw = tl = 16
        parts = [_jpeg_parts(np.ascontiguousarray(
            np.pad(src, [(0, 48 - h), (0, 48 - w)] + [(0, 0)] * (src.ndim - 2), mode="edge")
            [ty:ty + tl, tx:tx + tw]), **kw) for ty in range(0, h, tl) for tx in range(0, w, tw)]
        tile = (tw, tl)
    else:
        parts = [_jpeg_parts(np.ascontiguousarray(src[r:r + 16]), **kw) for r in range(0, h, 16)]
        tile = None
    tags = {258: (3, [8] * spp), 259: (3, [7]), 262: (3, [photometric]), 277: (3, [spp]),
            347: (7, parts[0][0])}
    if tile is None:
        tags[278] = (4, [16])
    if ycc:
        tags[530] = (3, [2, 2])
    chunks = [p[1] for p in parts]
    if layout == "no-tables":  # full streams, no tag 347
        del tags[347]
        chunks = [pil_save(Image.fromarray(np.ascontiguousarray(img[r:r + 16])), "JPEG",
                           quality=70) for r in range(0, h, 16)]
    like_pil(make_tiff(w, h, chunks, tags, tile=tile))


def _packed(px: np.ndarray, bits: int) -> bytes:
    return np.packbits(((px[..., None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
                       .reshape(px.shape[0], -1), axis=1).tobytes()


@pytest.mark.parametrize("case", ["rgb8", "grey8", "grey16", "grey4", "pal8", "strips"])
def test_old_style_lzw_matches_pil(case):
    """LSB-first LZW (libtiff's LZWDecodeCompat) with a real string table:
    widths 9 to 12, a Clear when full, KwKwK codes."""
    rng = np.random.default_rng(11)
    h, w = 40, 64
    if case == "grey16":
        raw = (rng.integers(0, 8, (h, w)) * 4000).astype("<u2").tobytes()
        tags = {258: (3, [16]), 262: (3, [1])}
    elif case == "grey4":
        raw = _packed(rng.integers(0, 4, (h, w)).astype(np.uint8) * 5, 4)
        tags = {258: (3, [4]), 262: (3, [1])}
    else:
        spp = 3 if case == "rgb8" else 1
        px = (rng.integers(0, 6, (h, w, spp)) * 40).astype(np.uint8)
        px[h // 2:] = px[h // 2 - 1]  # long repeats: strings past 4096 codes
        raw = px.tobytes()
        tags = {258: (3, [8] * spp), 262: (3, [2 if spp == 3 else (3 if case == "pal8" else 1)]),
                277: (3, [spp])}
        if case == "pal8":
            tags[320] = (3, list(rng.integers(0, 65536, 768)))
    tags[259] = (3, [5])
    if case == "strips":
        row = len(raw) // h
        chunks = [lzw_compat_encode(raw[r * row:(r + 7) * row]) for r in range(0, h, 7)]
        tags[278] = (4, [7])
    else:
        chunks = [lzw_compat_encode(raw)]
    assert chunks[0][0] == 0 and chunks[0][1] & 1  # what libtiff detects
    like_pil(make_tiff(w, h, chunks, tags), samples=case != "pal8")


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 34925])
@pytest.mark.parametrize("case", ["rgb8", "grey8", "grey1", "grey16", "grey2"])
def test_fill_order_2_matches_pil(case, compression):
    """FillOrder 2: libtiff reverses each byte of a compressed strip before
    decoding it; PIL's ";R" raw modes reverse an uncompressed one (PIL has
    no such raw mode for 2-bit grey, so it does not open that file)."""
    rng = np.random.default_rng(12)
    h, w = 9, 21
    bits = {"rgb8": 8, "grey8": 8, "grey1": 1, "grey16": 16, "grey2": 2}[case]
    spp = 3 if case == "rgb8" else 1
    px = rng.integers(0, 1 << bits, (h, w, spp))
    if bits == 16:
        raw = px.astype("<u2").tobytes()
    elif bits == 8:
        raw = px.astype(np.uint8).tobytes()
    else:
        raw = _packed(px[..., 0].astype(np.uint8), bits)
    enc = {1: bytes, 5: lzw_encode, 8: zlib.compress, 32773: packbits_encode,
           34925: lzma.compress}[compression](raw)
    tags = {258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [2 if spp == 3 else 1]),
            277: (3, [spp]), 266: (3, [2])}
    like_pil(make_tiff(w, h, [bytes(REVERSED[b] for b in enc)], tags))


SAMPLE_CASES = {  # (bits, sample format, numpy type, photometric)
    "float32": (32, 3, "f4", 1), "float32-min-is-white": (32, 3, "f4", 0),
    "int32": (32, 2, "i4", 1), "uint32": (32, 1, "u4", 1), "int16": (16, 2, "i2", 1),
    "int8": (8, 2, "i1", 1),
}


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("predictor", [1, 2, 3])
@pytest.mark.parametrize("compression", [1, 5, 8, 34925])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_formats_match_pil(case, compression, predictor, endian):
    """Mode F, I and signed L samples, converted by clipping; predictors 2
    and 3 under the codecs libtiff predicts; a big-endian compressed file's
    "I;16BS", "I;32BS" and "F;32BF" samples byte-swapped as PIL reads them
    from libtiff's native order; the refusals (predictor 3 on integers)."""
    bits, fmt, typ, photometric = SAMPLE_CASES[case]
    rng = np.random.default_rng(len(case) + compression)
    h, w = 7, 9
    if typ == "f4":
        px = rng.normal(128, 120, (h, w, 1)).astype(np.float32)
        px[0, :4, 0] = [np.inf, -np.inf, 300.5, -0.0]
    else:
        info = np.iinfo(typ)
        px = rng.integers(max(info.min, -(1 << 31)), min(info.max, (1 << 31) - 1) + 1, (h, w, 1),
                          dtype=np.int64).astype(typ)
        px[0, :3, 0] = [0, 100, min(info.max, 255)]
    if predictor == 3:
        if typ != "f4":
            raw = px.astype(endian + typ).tobytes()
        else:
            raw = float_predicted(px)
    elif predictor == 2:
        u = px.view(f"u{np.dtype(typ).itemsize}").astype(np.int64)
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        raw = (d & ((1 << bits) - 1)).astype(f"u{bits // 8}").astype(
            endian + f"u{bits // 8}").tobytes()
    else:
        raw = px.astype(endian + typ).tobytes()
    enc = {1: bytes, 5: lzw_encode, 8: zlib.compress, 34925: lzma.compress}[compression](raw)
    tags = {258: (3, [bits]), 259: (3, [compression]), 262: (3, [photometric]),
            339: (3, [fmt]), 317: (3, [predictor])}
    like_pil(make_tiff(w, h, [enc], tags, endian), ("RGB", "L"))


@pytest.mark.parametrize("case", ["sub-byte-predictor", "lzma-rgb-predictor", "lzma-tiles",
                                  "predictor-4", "cmyk16", "cmykx"])
def test_tiff_codec_edge_cases_match_pil(case):
    rng = np.random.default_rng(13)
    if case == "sub-byte-predictor":  # libtiff: no horizontal differencing below 8 bits
        data = tiff_bytes(rng.integers(0, 16, (9, 12, 1)).astype(np.uint8), 4, 1, 5, 2)
    elif case == "lzma-rgb-predictor":
        px = rng.integers(0, 256, (9, 12, 3)).astype(np.uint8)
        d = px.astype(np.int64)
        d[:, 1:] -= px[:, :-1]
        data = make_tiff(12, 9, [lzma.compress((d & 255).astype(np.uint8).tobytes())],
                         {258: (3, [8, 8, 8]), 259: (3, [34925]), 262: (3, [2]),
                          277: (3, [3]), 317: (3, [2])})
    elif case == "lzma-tiles":
        px = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
        tiles = [lzma.compress(px[y:y + 16, x:x + 16].tobytes()) for y in (0, 16) for x in (0, 16)]
        data = make_tiff(30, 20, tiles, {258: (3, [8, 8, 8]), 259: (3, [34925]),
                                         262: (3, [2]), 277: (3, [3])}, tile=(16, 16))
    elif case == "predictor-4":
        data = tiff_bytes(rng.integers(0, 256, (9, 12, 1)).astype(np.uint8), 8, 1, 5, 4)
    elif case == "cmyk16":
        px = rng.integers(0, 65536, (9, 12, 4)).astype(np.uint16)
        data = make_tiff(12, 9, [lzw_encode(px.astype(">u2").tobytes())],
                         {258: (3, [16] * 4), 259: (3, [5]), 262: (3, [5]), 277: (3, [4])},
                         endian=">")
    else:
        px = rng.integers(0, 256, (9, 12, 5)).astype(np.uint8)
        data = make_tiff(12, 9, [px.tobytes()], {258: (3, [8] * 5), 259: (3, [1]),
                                                 262: (3, [5]), 277: (3, [5]), 338: (3, [0])})
    like_pil(data, ("RGB", "RGBA", "L"))


# (bits, photometric, samples, ExtraSamples)
PLANAR_LAYOUTS = [(8, 2, 3, ()), (8, 2, 4, (2,)), (8, 2, 4, (1,)), (8, 2, 4, (0,)),
                  (8, 2, 4, ()), (8, 1, 2, (2,)), (16, 2, 3, ()), (16, 2, 4, (2,)),
                  (8, 5, 4, ()), (8, 8, 3, ()), (16, 5, 4, ())]


@pytest.mark.parametrize("layout", PLANAR_LAYOUTS, ids=lambda v: "-".join(map(str, v)))
def test_planar_layouts_match_pil(layout):
    """Planar files as PIL reads them, wrong or not: uncompressed planes
    through the layer's one-letter raw mode (16-bit planes as bytes,
    "a" and "X" planes a ValueError), compressed planes in the bands of
    the mode (an LA file's alpha lost, more planes than bands an error)."""
    bits, photometric, spp, extra = layout
    rng = np.random.default_rng(bits + spp)
    px = rng.integers(0, 1 << bits, (13, 21, spp)).astype(np.uint16 if bits == 16 else np.uint8)
    if extra == (1,):
        px[..., :3] = np.minimum(px[..., :3], px[..., 3:4])
    for comp in (1, 5, 8, 32773):
        for tile in (None, (16, 16)):
            for endian in "<>":
                data = tiff_bytes(px, bits, photometric, comp, 1, 2, tile, 5, endian, extra)
                like_pil(data, ("RGB", "RGBA") if photometric != 8 else ("RGB",))


def test_compressed_planar_tiff16_names_a10d_b():
    """cv2 reads a compressed planar 16-bit RGB file through a strip buffer
    it does not clear: JAX's read of such a file is not a function of the
    file's bytes, so the port refuses it, naming ROADMAP's Known
    differences."""
    px = np.random.default_rng(1).integers(0, 65536, (13, 21, 3)).astype(np.uint16)
    with pytest.raises(NotImplementedError, match="Known differences"):
        tiff.read_tiff16_rgb(tiff_bytes(px, 16, 2, 5, 1, 2, None, 5))


def test_unopened_tiff_is_unidentified():
    """A first frame PIL's reader does not open (no OPEN_INFO layout) is
    UnidentifiedImageError for PIL and Unidentified here."""
    data = tiff_bytes(np.zeros((4, 5, 2), np.uint16), 16, 1, 1, 1, 1, None, None, "<", (2,))
    with pytest.raises(UnidentifiedImageError):
        Image.open(io.BytesIO(data))
    with pytest.raises(Unidentified):
        open_image(data)


def test_lab_conversion_matches_pil_on_every_value():
    """LAB -> RGB (io/lab.py, littlecms's sampled transform) equals PIL's
    ImageCms conversion on all 2^24 Lab values."""
    from rapidraw_tpu_torch.io.lab import lab_to_srgb

    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    lab = lab.reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes()).convert("RGB"))
    assert np.array_equal(lab_to_srgb(lab), want)


# ---- load_image against the JAX loader, the export's HALD LUT, the fixtures ----------------


def _family_files() -> dict[str, bytes]:
    img = photo(24, 40, 4, 9)
    return {
        "cmyk.jpg": pil_save(Image.fromarray(img, "CMYK"), "JPEG", quality=85),
        "ycck.jpg": with_adobe(pil_save(Image.fromarray(img, "CMYK"), "JPEG", quality=85), 2),
        "lossless.jpg": ljpeg8(img[..., :3], 5),
        "ccitt.tif": pil_save(Image.fromarray(img[..., 0] > 128), "TIFF", compression="group4"),
        "jpeg.tif": pil_save(Image.fromarray(img[..., :3]).convert("YCbCr"), "TIFF",
                             compression="jpeg"),
        "lzma.tif": pil_save(Image.fromarray(img[..., :3]), "TIFF", compression="lzma"),
        "cmyk.tif": pil_save(Image.fromarray(img, "CMYK"), "TIFF", compression="tiff_lzw"),
        "ycbcr.tif": make_tiff(40, 24, [lzw_encode(ycbcr_blocks(
            img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2], 2, 2))],
            {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]),
             530: (3, [2, 2])}),
        "lab.tif": pil_save(Image.frombytes("LAB", (40, 24), img[..., :3].tobytes()), "TIFF",
                            compression="tiff_adobe_deflate"),
        "float.tif": make_tiff(40, 24, [zlib.compress(float_predicted(
            img[..., :1].astype(np.float32) * 1.7 - 60))],
            {258: (3, [32]), 259: (3, [8]), 262: (3, [1]), 339: (3, [3]), 317: (3, [3])}),
        "oldlzw.tif": make_tiff(40, 24, [lzw_compat_encode(img[..., :3].tobytes())],
                                {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [2]),
                                 277: (3, [3])}),
    }


@pytest.fixture(scope="module")
def family_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldr_variants")
    out = {}
    for name, data in _family_files().items():
        (root / name).write_bytes(data)
        out[name] = root / name
    return out


@pytest.mark.parametrize("name", sorted(_family_files()))
def test_load_image_matches_jax(name, family_files):
    """max |d| 0 against JAX's load_image run op by op."""
    path = family_files[name]
    with jax.disable_jit():
        want, want_raw = jloader.load_image(path, app_settings=JAppSettings({}))
    got, raw = loader.load_image(path, app_settings=AppSettings({}), device="cpu")
    want = np.asarray(want)
    assert raw is want_raw is False
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) == 0.0


def test_hald_lut_in_12bit_jpeg_is_dropped_as_jax_drops_it(tmp_path):
    """Fault C.1 at the export: a HALD LUT stored as a 12-bit JPEG is a file
    PIL does not open, so JAX's prepare drops the LUT and develops the
    image; the port's prepare does the same instead of failing it."""
    from rapidraw_tpu_torch.io.lut import parse_lut_file
    from rapidraw_tpu_torch.pipeline import export as ex

    hald = np.zeros((64, 64, 3), np.uint8)
    hald[...] = np.arange(64, dtype=np.uint8)[:, None, None] * 4
    data = _sof_patched(pil_save(Image.fromarray(hald), "JPEG", quality=95), 4, 12)
    lut_path = tmp_path / "hald.jpg"
    lut_path.write_bytes(data)
    with pytest.raises(OSError):
        parse_lut_file(lut_path)
    from rapidraw_tpu.pipeline import export as jex

    src = tmp_path / "img.png"
    Image.fromarray(photo(16, 24, 3, 1)).save(src)
    (tmp_path / "img.png.rrdata").write_text(json.dumps(
        {"version": 1, "adjustments": {"lutPath": str(lut_path), "lutIntensity": 100,
                                       "exposure": 0.3}}))
    want = jex._prepare_one(str(src), jex.ExportSettings())
    got = ex._prepare_one(str(src), ex.ExportSettings(), device="cpu")
    assert want[4] is None and not want[3].has_lut
    assert got[4] is None and not got[3].has_lut
    assert got[2] is not None
    # the size probe drops it the same way: the estimate of the document
    # without its lutPath
    with_lut = ex.estimate_export_sizes([str(src)], ex.ExportSettings(), device="cpu")
    (tmp_path / "img.png.rrdata").write_text(json.dumps(
        {"version": 1, "adjustments": {"exposure": 0.3}}))
    assert with_lut == ex.estimate_export_sizes([str(src)], ex.ExportSettings(), device="cpu")


DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
VARIANT_FIXTURES = sorted(n for n in DIGESTS if "samples" in DIGESTS[n])


@pytest.mark.parametrize("name", VARIANT_FIXTURES)
def test_variant_fixtures_match_their_digests(name):
    """The PIL-made variant fixtures: the port's mode and samples hash to
    PIL's, as chip_smoke's [ldr-var] part checks without PIL."""
    data = (FIXTURES / name).read_bytes()
    entry = DIGESTS[name]
    im = Image.open(io.BytesIO(data))
    frame = open_image(data)
    assert im.mode == frame.mode == entry["mode"]
    px, pil = frame.px, np.asarray(im)
    if frame.mode == "1":  # PIL's bool array holds 0 and 255: hash 0 and 1
        px, pil = (px != 0).astype(np.uint8), (pil != 0).astype(np.uint8)
    want = hashlib.sha256(np.ascontiguousarray(pil).tobytes()).hexdigest()
    got = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
    assert got == want == entry["samples"]
    assert len(data) <= 100 * 1024


@pytest.mark.parametrize("size", [(40, 64), (37, 53)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_chip_smoke_variant_writers_read_as_written(size, tmp_path):
    """Phase 22's writers (no PIL on the card's machine): PIL reads each
    file as what it holds, and so does the port."""
    paths, held = chip_smoke.write_ldr_variants(tmp_path, *size, 5, rows=16)
    assert sorted(paths) == sorted(chip_smoke.LDR_VAR_FILES)
    for name, p in paths.items():
        data = p.read_bytes()
        mode, want = held[name]
        im = Image.open(io.BytesIO(data))
        assert im.mode == mode, name
        pil = np.asarray(im if mode != "RGB" else im.convert("RGB"))
        assert np.array_equal(pil, want), name
        like_pil(data, ("RGB",))


def test_jpeg_tables_split_rejoins():
    """chip_smoke.jpeg_tables_split: the tables and the abbreviated stream
    decode, spliced, as the whole stream does."""
    from rapidraw_tpu_torch import native

    stream = native.jpeg_encode(photo(24, 40, 3, 3), 80)
    tables, body = chip_smoke.jpeg_tables_split(stream)
    assert tables.startswith(b"\xff\xd8") and tables.endswith(b"\xff\xd9")
    assert b"\xff\xdb" not in body[:body.index(b"\xff\xda")]
    assert np.array_equal(jpeg.decode_jpeg(tables[:-2] + body[2:]), jpeg.decode_jpeg(stream))
