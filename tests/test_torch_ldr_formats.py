"""The port's LDR-format decoders (io/image_decode.py's dispatcher and
io/webp.py, gif.py, bmp.py, tga.py, ico.py, dds.py, qoi.py, pnm.py with
csrc/host/webp_dec.cc, bcn_dec.cc and ldr_dec.cc) against PIL 12.1 and the
JAX package, on the CPU.

- Files PIL writes, in every mode it writes for each format (WebP lossless
  and lossy at q10/75/100, with and without alpha): `open_image(...)`'s
  `.size` and `convert(mode)` equal to PIL's for "RGB", "RGBA" and "L",
  byte for byte.
- Hand-built files for what PIL does not write: BMP RLE4/RLE8, OS/2
  headers, bit fields, top-down rows, short palettes; TGA colour maps,
  16-bit colour, every origin, RLE; GIF interlace, local palettes, offset
  frames, code sizes 2-8, codes past 4095 with a deferred clear; PNM plain
  formats, maxvals and comments; an animated WebP; ICO with PNG and BMP
  entries; DDS of random BC1-BC7 blocks.
- Truncated and malformed files raise PIL's exception class.
- `load_image` against JAX's (max |d| 0, the enhance pass off and on), the
  committed fixtures against their digests, and chip_smoke phase 21's
  writers against PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from rapidraw_tpu.io import loader as jloader
from rapidraw_tpu.utils.settings import AppSettings as JAppSettings
from rapidraw_tpu_torch.io import loader
from rapidraw_tpu_torch.io.image_decode import decode_image, open_image
from rapidraw_tpu_torch.utils.settings import AppSettings

jax.config.update("jax_platforms", "cpu")

MODES = ("RGB", "RGBA", "L")
SIZES = [(1, 1), (9, 17), (17, 9), (33, 2)]
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "ldr"


def photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 4) u8: gradients, edges, noise and a varying alpha."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256, ((x ^ y) * 5) % 256,
                     (x * 11 + y * 5) % 256], -1).astype(float)
    base[..., :3] += rng.normal(0, 20, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _pil(data: bytes):
    """(size, {mode: pixels}) PIL gives, or the exception it raises."""
    try:
        im = Image.open(io.BytesIO(data))
        return im.size, {m: np.asarray(im.convert(m)) for m in MODES}
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return e


def assert_like_pil(data: bytes) -> None:
    """The port's size and pixels equal PIL's in every mode, or the port
    raises the class PIL raises (UnidentifiedImageError: an OSError)."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(Exception) as got:
            frame = open_image(data)
            for m in MODES:
                frame.convert(m)
        if isinstance(want, UnidentifiedImageError):
            assert isinstance(got.value, OSError), (repr(want), repr(got.value))
        else:
            assert type(got.value) is type(want), (repr(want), repr(got.value))
        return
    size, px = want
    frame = open_image(data)
    assert frame.size == size
    for m in MODES:
        got = frame.convert(m)
        assert got.shape == px[m].shape and np.array_equal(got, px[m]), m


def pil_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ---- files PIL writes ----------------------------------------------------------

WRITERS = {  # name -> (PIL format, save options)
    "bmp": ("BMP", {}),
    "tga": ("TGA", {}),
    "tga-rle": ("TGA", {"compression": "tga_rle"}),
    "gif": ("GIF", {}),
    "ico-png": ("ICO", {}),
    "ico-bmp": ("ICO", {"bitmap_format": "bmp"}),
    "qoi": ("QOI", {}),
    "ppm": ("PPM", {}),
    "ppm-maxval1000": ("PPM", {"maxval": 1000}),
    "dds": ("DDS", {}),
    "dds-dxt1": ("DDS", {"pixel_format": "DXT1"}),
    "dds-dxt3": ("DDS", {"pixel_format": "DXT3"}),
    "dds-dxt5": ("DDS", {"pixel_format": "DXT5"}),
    "dds-bc5": ("DDS", {"pixel_format": "BC5"}),
    "webp-lossless": ("WEBP", {"lossless": True}),
}
SOURCE_MODES = ("RGB", "RGBA", "L", "LA", "P", "1", "I")


def _source(mode: str, h: int, w: int) -> Image.Image:
    a = photo(h, w, h * 31 + w)
    if mode == "I":
        return Image.fromarray(a[..., 0].astype(np.int32) * 257, "I")
    return Image.fromarray(a, "RGBA").convert(mode)


def _writable(name: str, mode: str) -> bool:
    fmt, kw = WRITERS[name]
    try:
        pil_bytes(_source(mode, 4, 4), fmt, **kw)
    except Exception:  # noqa: BLE001 - PIL does not write this mode
        return False
    return True


PIL_CASES = [(n, m) for n in WRITERS for m in SOURCE_MODES if _writable(n, m)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", PIL_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_pil_written_files_match_pil(case, size):
    name, mode = case
    fmt, kw = WRITERS[name]
    assert_like_pil(pil_bytes(_source(mode, *size), fmt, **kw))


@pytest.mark.parametrize("name", ["bmp", "tga-rle", "gif", "qoi", "ppm", "dds-dxt5",
                                  "webp-lossless"])
def test_pil_written_767x1023_matches_pil(name):
    fmt, kw = WRITERS[name]
    mode = "RGBA" if name in ("qoi", "dds-dxt5", "webp-lossless") else "RGB"
    assert_like_pil(pil_bytes(_source(mode, 767, 1023), fmt, **kw))


WEBP_OPTIONS = {"lossless": {"lossless": True}, "lossless-exact": {"lossless": True, "exact": True},
                "q10": {"quality": 10}, "q75": {"quality": 75}, "q100": {"quality": 100},
                "q75-m0": {"quality": 75, "method": 0}, "q75-alpha30": {"quality": 75,
                                                                       "alpha_quality": 30}}


WEBP_CASES = [(o, m, s) for o in sorted(WEBP_OPTIONS) for m in ("RGB", "RGBA")
              for s in SIZES + [(64, 48)]] + [(o, m, (767, 1023)) for o in ("lossless", "q75",
                                                                           "q75-alpha30")
                                              for m in ("RGB", "RGBA")]


@pytest.mark.parametrize("opt,mode,size", WEBP_CASES,
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_webp_matches_pil(opt, mode, size):
    """Lossless (RGB under alpha 0 kept) and lossy at q10/75/100 with and
    without alpha: segments, skipped macroblocks, the loop filter, the fancy
    upsampler's edges and odd sizes, filtered lossy alpha."""
    a = photo(*size, seed=size[0])
    if mode == "RGBA":
        a[::3, ::2, 3] = 0  # alpha 0 over colour
    assert_like_pil(pil_bytes(Image.fromarray(a, "RGBA").convert(mode), "WEBP",
                              **WEBP_OPTIONS[opt]))


@pytest.mark.parametrize("kind", ["lossless", "lossy"])
def test_animated_webp_frame_0(kind):
    """PIL shows frame 0 composited on the canvas cleared to transparent."""
    frames = [Image.fromarray(photo(30, 40, s), "RGBA") for s in range(3)]
    kw = {"lossless": True} if kind == "lossless" else {"quality": 60}
    assert_like_pil(pil_bytes(frames[0], "WEBP", save_all=True, append_images=frames[1:],
                              duration=50, **kw))


def _riff(chunks: list[tuple[bytes, bytes]]) -> bytes:
    body = b"WEBP" + b"".join(t + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
                              for t, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _webp_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, (n,) = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def test_animated_webp_small_first_frame_on_its_canvas():
    """A first frame smaller than the canvas and off its origin: the rest of
    the canvas is transparent black (RGB 0 where PIL drops alpha)."""
    frame = pil_bytes(Image.fromarray(photo(10, 14, 3), "RGBA"), "WEBP", lossless=True)
    still = _webp_chunks(frame)
    for alpha_flag in (0x10, 0):
        vp8x = struct.pack("<B3x", 0x02 | alpha_flag) + (31).to_bytes(3, "little") + (
            23).to_bytes(3, "little")
        anmf = (b"".join((v).to_bytes(3, "little") for v in (2, 3, 13, 9, 100)) + b"\x00"
                + b"".join(t + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
                           for t, p in still))
        data = _riff([(b"VP8X", vp8x), (b"ANIM", bytes(6)), (b"ANMF", anmf)])
        assert_like_pil(data)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_webp_exif_orientation(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    a = photo(12, 20, 2)
    data = pil_bytes(Image.fromarray(a[..., :3]), "WEBP", quality=80, exif=ex.tobytes())
    assert open_image(data).orientation == Image.open(io.BytesIO(data)).getexif().get(
        0x0112, 1) == orientation


# ---- BMP -------------------------------------------------------------------------


def bmp(w: int, h: int, bits: int, rows: bytes, palette: bytes = b"", compression: int = 0,
        header: int = 40, masks: tuple = (), colors: int = 0, top_down: bool = False) -> bytes:
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = (2**32 - h) if top_down else h
        info = struct.pack("<IiIHHIIiiII", header, w, hh, 1, bits, compression, len(rows), 2835,
                           2835, colors, 0)
        extra = b"".join(struct.pack("<I", m) for m in masks)
        info += extra[:header - 40] if header > 40 else b""
        info += bytes(max(0, header - len(info)))
        if header == 40 and compression == 3:
            info += extra[:12]
    off = 14 + len(info) + len(palette)
    return b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + info + palette + rows


def _rows(px: np.ndarray, bits: int, bottom_up: bool = True) -> bytes:
    """Pack (h, w) samples or (h, w, C) bytes into padded BMP rows."""
    h = px.shape[0]
    if bits < 8:
        per = 8 // bits
        w = px.shape[1]
        pad = np.zeros((h, -(-w // per) * per), np.uint8)
        pad[:, :w] = px
        shifts = np.arange(8 - bits, -1, -bits)
        rows = (pad.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    else:
        rows = px.reshape(h, -1)
    stride = (rows.shape[1] + 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :rows.shape[1]] = rows
    return (out[::-1] if bottom_up else out).tobytes()


def _pal(n: int, seed: int = 0, quad: bool = True) -> bytes:
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (n, 4 if quad else 3), dtype=np.uint8)
    if quad:
        p[:, 3] = 0
    return p.tobytes()


def _rle8(idx: np.ndarray) -> bytes:
    """RLE8 with encoded runs, absolute runs (odd and even), a delta escape
    and end-of-line escapes."""
    out = bytearray()
    h, w = idx.shape
    for y in range(h - 1, -1, -1):
        row = idx[y]
        x = 0
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, row[x]])
                x += n
            else:
                k = min(w - x, 5 if y % 2 else 4)
                out += bytes([0, k]) + row[x:x + k].tobytes() + (b"\x00" if k % 2 else b"")
                x += k
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(idx: np.ndarray) -> bytes:
    out = bytearray()
    h, w = idx.shape
    for y in range(h - 1, -1, -1):
        row = idx[y]
        x = 0
        while x < w:
            if (w - x) >= 4 and y % 2:
                k = min(w - x, 6)
                vals = list(row[x:x + k]) + [0]
                packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, k, 2))
                out += bytes([0, k]) + packed + (b"\x00" if len(packed) % 2 else b"")
                x += k
            else:
                n = min(w - x, 5)
                a = row[x]
                b = row[x + 1] if x + 1 < w else 0
                out += bytes([n, (a << 4) | b])
                x += n if n == 1 else 2
                if n > 2:
                    x -= 0
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _bmp_cases() -> dict:
    rng = np.random.default_rng(7)
    h, w = 9, 17
    rgb = photo(h, w, 1)[..., :3]
    idx8 = rng.integers(0, 6, (h, w)).astype(np.uint8)
    idx8[:, 3:9] = 2
    idx4 = rng.integers(0, 16, (h, w)).astype(np.uint8)
    v565 = rng.integers(0, 65536, (h, w)).astype("<u2")
    bgra = photo(h, w, 2)
    c = {}
    c["rle8"] = bmp(w, h, 8, _rle8(idx8), _pal(6), compression=1, colors=6)
    c["rle8-delta"] = bmp(w, h, 8, b"\x03\x01\x00\x02\x00\x00\x02\x01" + _rle8(idx8),
                          _pal(6), compression=1, colors=6)
    c["rle8-short"] = bmp(w, h, 8, _rle8(idx8)[:40] + b"\x00\x01", _pal(6), compression=1,
                          colors=6)
    c["rle4"] = bmp(w, h, 4, _rle4(idx4), _pal(16), compression=2)
    c["os2-24"] = bmp(w, h, 24, _rows(rgb[..., ::-1], 24), header=12)
    c["os2-8"] = bmp(w, h, 8, _rows(idx8, 8), _pal(256, 3, quad=False), header=12)
    c["top-down-24"] = bmp(w, h, 24, _rows(rgb[..., ::-1], 24, bottom_up=False), top_down=True)
    c["bitfields-565"] = bmp(w, h, 16, _rows(v565.view(np.uint8).reshape(h, w, 2), 16),
                             compression=3, masks=(0xF800, 0x7E0, 0x1F))
    c["bitfields-555-v4"] = bmp(w, h, 16, _rows(v565.view(np.uint8).reshape(h, w, 2), 16),
                                compression=3, masks=(0x7C00, 0x3E0, 0x1F, 0), header=108)
    c["raw-16"] = bmp(w, h, 16, _rows(v565.view(np.uint8).reshape(h, w, 2), 16))
    c["bitfields-bgra-v5"] = bmp(w, h, 32, _rows(bgra, 32), compression=3,
                                 masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=124)
    c["bitfields-rgba-56"] = bmp(w, h, 32, _rows(bgra, 32), compression=3,
                                 masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), header=56)
    c["bitfields-zero-52"] = bmp(w, h, 32, _rows(bgra, 32), compression=3, masks=(0, 0, 0),
                                 header=52)
    c["bitfields-bad"] = bmp(w, h, 32, _rows(bgra, 32), compression=3,
                             masks=(0xFF00, 0xFF, 0xFF0000, 0), header=56)
    c["raw-32-header64"] = bmp(w, h, 32, _rows(bgra, 32), header=64)
    c["short-palette-4bit"] = bmp(w, h, 4, _rows(idx4, 4), _pal(3), colors=3)
    c["1bit"] = bmp(w, h, 1, _rows(idx4 & 1, 1), _pal(2, 9))
    c["1bit-black-white"] = bmp(w, h, 1, _rows(idx4 & 1, 1), bytes([0, 0, 0, 0, 255, 255, 255,
                                                                    0]))
    c["grey-ramp-8bit"] = bmp(w, h, 8, _rows(idx8 * 40, 8), np.repeat(
        np.arange(256, dtype=np.uint8)[:, None], 4, 1).tobytes())
    c["2bit-refused"] = bmp(w, h, 2, _rows(idx4 & 3, 2), _pal(4))
    c["jpeg-refused"] = bmp(w, h, 24, b"\xff\xd8\xff" + bytes(50), compression=4)
    c["png-refused"] = bmp(w, h, 24, b"\x89PNG" + bytes(50), compression=5)
    c["header-20-refused"] = b"BM" + struct.pack("<IHHII", 60, 0, 0, 40, 20) + bytes(40)
    c["truncated-rows"] = bmp(w, h, 24, _rows(rgb[..., ::-1], 24))[:-30]
    return c


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("name", sorted(BMP_CASES))
def test_hand_built_bmp_matches_pil(name):
    assert_like_pil(BMP_CASES[name])


# ---- TGA -------------------------------------------------------------------------


def tga(w: int, h: int, itype: int, depth: int, body: bytes, flags: int = 0, ident: bytes = b"",
        cmap: tuple | None = None) -> bytes:
    """cmap: (first entry, entries, entry bits, bytes)."""
    if cmap:
        first, n, bits, data = cmap
        cm = struct.pack("<BHHB", 1, first, n, bits)
    else:
        cm, data = bytes(6), b""
    head = bytes([len(ident)]) + cm[:1] + bytes([itype]) + cm[1:] + struct.pack(
        "<HHHHBB", 0, 0, w, h, depth, flags)
    return head + ident + data + body


def _tga_rle(px: np.ndarray, across: bool = False) -> bytes:
    """RLE of (h, w, B) pixels: runs of equal pixels and literals; with
    `across`, literals run on across rows."""
    h, w, nb = px.shape
    seq = [px.reshape(-1, nb)] if across else [px[y] for y in range(h)]
    out = bytearray()
    for row in seq:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < 128 and (row[x + n] == row[x]).all():
                n += 1
            if n >= 2:
                out += bytes([0x80 | (n - 1)]) + row[x].tobytes()
                x += n
            else:
                k = min(len(row) - x, 7)
                out += bytes([k - 1]) + row[x:x + k].tobytes()
                x += k
    return bytes(out)


def _tga_cases() -> dict:
    rng = np.random.default_rng(11)
    h, w = 9, 17
    rgb = photo(h, w, 4)
    idx = rng.integers(4, 20, (h, w)).astype(np.uint8)
    idx[2:5, 3:12] = 7
    v16 = rng.integers(0, 65536, (h, w)).astype("<u2").view(np.uint8).reshape(h, w, 2)
    grey = rgb[..., 0]
    c = {}
    for flags in (0x00, 0x10, 0x20, 0x30):
        c[f"rgb24-origin{flags:02x}"] = tga(w, h, 2, 24, rgb[..., 2::-1].tobytes(), flags)
    c["rgb32-id"] = tga(w, h, 2, 32, rgb[..., [2, 1, 0, 3]].tobytes(), 0x28, ident=b"abc" * 5)
    c["rgb16"] = tga(w, h, 2, 16, v16.tobytes())
    c["rgb16-rle"] = tga(w, h, 10, 16, _tga_rle(v16), 0x20)
    c["rgb24-rle"] = tga(w, h, 10, 24, _tga_rle(rgb[..., 2::-1]))
    c["rgb24-rle-literals-across-rows"] = tga(w, h, 10, 24, _tga_rle(rgb[..., 2::-1], True))
    run_across = bytes([0x80 | (w + 2)]) + b"\x01\x02\x03"
    c["rgb24-rle-run-across-rows"] = tga(w, h, 10, 24, run_across * h)
    for bits in (16, 24, 32):
        entries = rng.integers(0, 256, (16, bits // 8), dtype=np.uint8).tobytes()
        c[f"cmap{bits}-first4"] = tga(w, h, 1, 8, idx.tobytes(), 0x20, cmap=(4, 16, bits, entries))
        c[f"cmap{bits}-rle"] = tga(w, h, 9, 8, _tga_rle(idx[..., None]), 0,
                                   cmap=(4, 16, bits, entries))
    c["cmap-index-past-map"] = tga(w, h, 1, 8, (idx + 30).tobytes(), 0,
                                   cmap=(0, 8, 24, bytes(range(24))))
    c["grey8"] = tga(w, h, 3, 8, grey.tobytes(), 0x20)
    c["grey8-rle"] = tga(w, h, 11, 8, _tga_rle(grey[..., None]))
    c["grey16-la"] = tga(w, h, 3, 16, rgb[..., :2].tobytes())
    c["depth15-refused"] = tga(w, h, 2, 15, v16.tobytes())
    c["type1-without-map"] = tga(w, h, 1, 8, idx.tobytes())  # ICO's magic: PIL falls to TGA
    c["truncated"] = tga(w, h, 2, 24, rgb[..., 2::-1].tobytes())[:-10]
    c["rle-truncated"] = tga(w, h, 10, 24, _tga_rle(rgb[..., 2::-1]))[:-5]
    return c


TGA_CASES = _tga_cases()


@pytest.mark.parametrize("name", sorted(TGA_CASES))
def test_hand_built_tga_matches_pil(name):
    assert_like_pil(TGA_CASES[name])


def test_tga_is_found_without_its_extension():
    """PIL tries the TGA reader on bytes nothing else claims; so does the
    dispatcher."""
    data = TGA_CASES["rgb24-origin20"]
    assert np.array_equal(decode_image(data), np.asarray(Image.open(io.BytesIO(data))
                                                         .convert("RGB")))


# ---- GIF -------------------------------------------------------------------------


def gif_lzw(idx: np.ndarray, min_code: int, clear_when_full: bool = False,
            clear_every: int = 0) -> bytes:
    """GIF LZW of the indices with a real string table, codes widened as a
    decoder widens them; a full table is kept (deferred clear) unless
    `clear_when_full`; `clear_every` emits a clear after that many codes."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    codes = []
    state = {}

    def reset():
        state.update(size=min_code + 1, count=0, dec_next=end + 1, enc_next=end + 1,
                     table={(i,): i for i in range(clear)})

    def emit(code):
        codes.append((code, state["size"]))
        if code == clear:
            reset()
            return
        if state["count"] >= 1 and state["dec_next"] < 4096:
            if state["dec_next"] == (1 << state["size"]) - 1 and state["size"] < 12:
                state["size"] += 1
            state["dec_next"] += 1
        state["count"] += 1

    reset()
    emit(clear)
    seq = [int(v) for v in idx.reshape(-1)]
    cur = (seq[0],)
    for c in seq[1:]:
        nxt = cur + (c,)
        if nxt in state["table"]:
            cur = nxt
            continue
        emit(state["table"][cur])
        if state["enc_next"] < 4096:
            state["table"][nxt] = state["enc_next"]
            state["enc_next"] += 1
        elif clear_when_full:
            emit(clear)
        if clear_every and state["count"] >= clear_every:
            emit(clear)
        cur = (c,)
    emit(state["table"][cur])
    emit(end)
    acc = nbits = 0
    out = bytearray()
    for code, size in codes:
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes([min_code]) + b"".join(bytes([len(out[k:k + 255])]) + out[k:k + 255]
                                         for k in range(0, len(out), 255)) + b"\x00"


def gif(w: int, h: int, frames: list, global_pal: bytes | None = None,
        transparency: int | None = None) -> bytes:
    """frames: (x0, y0, indices, local palette or None, interlace, min code,
    LZW options)."""
    flags = 0
    if global_pal is not None:
        flags = 0x80 | 0x70 | (len(global_pal) // 3).bit_length() - 2
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags, 0, 0) + (global_pal or b"")
    for x0, y0, idx, local, interlace, min_code, opts in frames:
        if transparency is not None:
            out += b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\x00"
        fh, fw = idx.shape
        lf = (0x80 | (len(local) // 3).bit_length() - 2 if local else 0) | (0x40 if interlace
                                                                             else 0)
        rows = idx
        if interlace:
            order = list(range(0, fh, 8)) + list(range(4, fh, 8)) + list(range(2, fh, 4)) + list(
                range(1, fh, 2))
            rows = idx[order]
        out += b"," + struct.pack("<HHHHB", x0, y0, fw, fh, lf) + (local or b"")
        out += gif_lzw(rows, min_code, **opts)
    return out + b";"


def _gif_cases() -> dict:
    rng = np.random.default_rng(13)
    h, w = 17, 23
    idx = rng.integers(0, 16, (h, w)).astype(np.uint8)
    idx[3:9, :] = 5
    pal = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    big = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    ramp = bytes(np.repeat(np.arange(16, dtype=np.uint8), 3))
    c = {}
    c["plain"] = gif(w, h, [(0, 0, idx, None, False, 4, {})], pal)
    c["interlaced"] = gif(w, h, [(0, 0, idx, None, True, 4, {})], pal)
    c["local-palette"] = gif(w, h, [(0, 0, idx, big[:48], False, 4, {})], pal)
    c["local-over-none"] = gif(w, h, [(0, 0, idx, big[:48], False, 4, {})])
    c["no-palette-is-L"] = gif(w, h, [(0, 0, idx, None, False, 4, {})])
    c["grey-ramp-is-L"] = gif(w, h, [(0, 0, idx, None, False, 4, {})], ramp)
    c["transparency"] = gif(w, h, [(0, 0, idx, None, False, 4, {})], pal, transparency=5)
    c["transparency-L"] = gif(w, h, [(0, 0, idx, None, False, 4, {})], ramp, transparency=5)
    c["small-offset-frame"] = gif(w + 9, h + 5, [(4, 3, idx, None, False, 4, {})], pal)
    c["small-offset-frame-transparent"] = gif(w + 9, h + 5, [(4, 3, idx, None, True, 4, {})],
                                              pal, transparency=9)
    c["frame-past-screen"] = gif(10, 8, [(6, 2, idx, None, False, 4, {})], pal)
    c["index-past-palette"] = gif(w, h, [(0, 0, idx, None, False, 4, {})], pal[:12])
    for code in range(2, 9):
        v = rng.integers(0, 1 << code, (h, w)).astype(np.uint8)
        c[f"min-code-{code}"] = gif(w, h, [(0, 0, v, None, code % 2 == 1, code, {})], big)
    noise = rng.integers(0, 256, (96, 120)).astype(np.uint8)
    c["past-4095-deferred-clear"] = gif(120, 96, [(0, 0, noise, None, False, 8, {})], big)
    c["past-4095-clear"] = gif(120, 96, [(0, 0, noise, None, False, 8,
                                          {"clear_when_full": True})], big)
    c["clear-every-40"] = gif(w, h, [(0, 0, idx, None, False, 4, {"clear_every": 40})], pal)
    c["two-frames"] = gif(w, h, [(0, 0, idx, None, False, 4, {}),
                                 (2, 2, idx[:5, :5], None, False, 4, {})], pal)
    c["truncated"] = c["plain"][:len(c["plain"]) * 2 // 3]
    c["no-image"] = b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b";"
    c["header-only"] = b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0)
    bad = bytearray(gif(w, h, [(0, 0, idx, None, False, 4, {})], pal))
    at = bad.index(b",") + 10
    bad[at + 3] = 0xFF  # a code past the table after the first
    c["invalid-code"] = bytes(bad)
    return c


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("name", sorted(GIF_CASES))
def test_hand_built_gif_matches_pil(name):
    assert_like_pil(GIF_CASES[name])


# ---- PNM -------------------------------------------------------------------------


def _pnm_cases() -> dict:
    rng = np.random.default_rng(17)
    h, w = 5, 7
    c = {}
    bits = rng.integers(0, 2, (h, w))
    c["p1-plain"] = b"P1\n# a comment\n%d %d\n" % (w, h) + b"\n".join(
        b" ".join(b"%d" % v for v in row) for row in bits) + b"\n"
    c["p1-plain-packed"] = b"P1 %d %d " % (w, h) + b"".join(b"%d" % v for v in bits.reshape(-1))
    c["p1-bad-token"] = b"P1 2 2 0 1 2 0"
    c["p4"] = b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()
    for maxval in (1, 15, 255, 4095, 65535):
        g = rng.integers(0, maxval + 1, (h, w))
        rgb = rng.integers(0, maxval + 1, (h, w, 3))
        c[f"p2-max{maxval}"] = b"P2\n%d %d\n# c\n%d\n" % (w, h, maxval) + b" ".join(
            b"%d" % v for v in g.reshape(-1))
        c[f"p3-max{maxval}"] = b"P3 %d %d %d\n" % (w, h, maxval) + b"\n".join(
            b"%d" % v for v in rgb.reshape(-1))
        dt = ">u2" if maxval > 255 else np.uint8
        c[f"p5-max{maxval}"] = b"P5\n%d %d\n%d\n" % (w, h, maxval) + g.astype(dt).tobytes()
        c[f"p6-max{maxval}"] = b"P6\n%d #x\n%d\n%d\n" % (w, h, maxval) + rgb.astype(dt).tobytes()
    c["p6-truncated"] = c["p6-max255"][:-7]
    c["p6-max1000-truncated"] = c["p6-max4095"][:-7]
    c["p5-value-past-maxval"] = b"P5 2 2 100\n" + bytes([0, 50, 200, 255])
    c["p2-value-past-maxval"] = b"P2 2 2 100\n0 50 200 99"
    c["p2-short"] = b"P2 3 3 255\n1 2 3"
    c["maxval-0"] = b"P5 2 2 0\n" + bytes(4)
    c["token-too-long"] = b"P6 123456789012 2 255\n"
    c["header-eof"] = b"P6 12"
    return c


PNM_CASES = _pnm_cases()


@pytest.mark.parametrize("name", sorted(PNM_CASES))
def test_hand_built_pnm_matches_pil(name):
    assert_like_pil(PNM_CASES[name])


# ---- ICO -------------------------------------------------------------------------


def _dib_entry(rgb: np.ndarray, bits: int, mask: np.ndarray, seed: int) -> bytes:
    """An icon's BMP entry: a 40-byte header with the doubled height, the
    XOR rows, the 1-bit AND mask rows (bottom-up, 32-bit aligned)."""
    h, w = rgb.shape[:2]
    if bits == 32:
        xor = _rows(rgb[..., [2, 1, 0, 3]], 32)
        pal = b""
    else:
        idx = (rgb[..., 0] // (256 >> bits)).astype(np.uint8)
        xor = _rows(idx, bits)
        pal = _pal(1 << bits, seed)
    mrow = -(-w // 32) * 4
    mpad = np.zeros((h, mrow * 8), np.uint8)
    mpad[:, :w] = mask
    andm = np.packbits(mpad, axis=1)[::-1].tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, len(xor) + len(andm), 0, 0, 0, 0)
    return info + pal + xor + andm


def ico(entries: list) -> bytes:
    """entries: (w, h, bpp, payload)."""
    head = struct.pack("<HHH", 0, 1, len(entries))
    off = 6 + 16 * len(entries)
    dirs, body = b"", b""
    for w, h, bpp, payload in entries:
        dirs += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bpp, len(payload),
                            off + len(body))
        body += payload
    return head + dirs + body


def _ico_cases() -> dict:
    rng = np.random.default_rng(19)
    c = {}

    def img(n, s):
        return photo(n, n, s)

    def png(n, s, mode="RGBA"):
        return pil_bytes(Image.fromarray(img(n, s), "RGBA").convert(mode), "PNG")

    def dib(n, bits, s):
        return _dib_entry(img(n, s), bits, rng.integers(0, 2, (n, n)).astype(np.uint8), s)

    c["bmp48-32bit-largest"] = ico([(16, 16, 8, dib(16, 8, 1)), (32, 32, 32, png(32, 2)),
                                    (48, 48, 32, dib(48, 32, 3))])
    c["png48-largest"] = ico([(16, 16, 4, dib(16, 4, 4)), (48, 48, 32, png(48, 5)),
                              (32, 32, 8, dib(32, 8, 6))])
    c["png-palette-trns"] = ico([(24, 24, 8, pil_bytes(
        Image.fromarray(img(24, 7), "RGBA").convert("P"), "PNG", transparency=3))])
    c["equal-size-lowest-depth"] = ico([(32, 32, 32, dib(32, 32, 8)), (32, 32, 8, dib(32, 8, 9)),
                                        (32, 32, 4, dib(32, 4, 10))])
    c["bmp-1bit-odd-width"] = ico([(21, 21, 1, _dib_entry(img(21, 11), 1, rng.integers(
        0, 2, (21, 21)).astype(np.uint8), 11))])
    c["256-as-0"] = ico([(256, 256, 32, png(256, 12, "RGB"))])
    c["size-mismatch"] = ico([(40, 40, 32, png(32, 13))])
    c["truncated-entry"] = ico([(16, 16, 8, dib(16, 8, 14))])[:-40]
    c["truncated-directory"] = ico([(16, 16, 8, dib(16, 8, 15))])[:12]
    return c


ICO_CASES = _ico_cases()


@pytest.mark.parametrize("name", sorted(ICO_CASES))
def test_hand_built_ico_matches_pil(name):
    assert_like_pil(ICO_CASES[name])


# ---- DDS -------------------------------------------------------------------------


def dds(w: int, h: int, body: bytes, fourcc: bytes = b"", dxgi: int | None = None,
        pfflags: int = 0x4, bitcount: int = 0, masks: tuple = ()) -> bytes:
    hdr = bytearray(128)
    hdr[:4] = b"DDS "
    struct.pack_into("<IIII", hdr, 4, 124, 0x1007, h, w)
    struct.pack_into("<IIII", hdr, 76, 32, pfflags, struct.unpack("<I", (fourcc or bytes(4)))[0],
                     bitcount)
    for k, m in enumerate(masks):
        struct.pack_into("<I", hdr, 92 + 4 * k, m)
    ext = struct.pack("<IIIII", dxgi, 3, 0, 1, 0) if fourcc == b"DX10" else b""
    return bytes(hdr) + ext + body


BCN = {"bc1": (b"DXT1", None, 8), "bc2": (b"DXT3", None, 16), "bc3": (b"DXT5", None, 16),
       "bc4": (b"ATI1", None, 8), "bc4u": (b"BC4U", None, 8), "bc5": (b"ATI2", None, 16),
       "bc5s": (b"BC5S", None, 16), "bc6h-uf16": (b"DX10", 95, 16),
       "bc6h-sf16": (b"DX10", 96, 16), "bc7": (b"DX10", 98, 16), "bc1-dx10": (b"DX10", 71, 8),
       "bc3-dx10": (b"DX10", 77, 16), "bc7-srgb": (b"DX10", 99, 16)}


@pytest.mark.parametrize("size", [(64, 64), (9, 17), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", sorted(BCN))
def test_dds_random_blocks_match_pil(fmt, size):
    """PIL decodes any 8- or 16-byte block: every mode, partition and
    reserved code of BC6H and BC7 comes up among random blocks."""
    fourcc, dxgi, bs = BCN[fmt]
    w, h = size
    rng = np.random.default_rng(w * 7 + len(fmt))
    blocks = rng.bytes(((w + 3) // 4) * ((h + 3) // 4) * bs)
    assert_like_pil(dds(w, h, blocks, fourcc, dxgi))


def _dds_cases() -> dict:
    rng = np.random.default_rng(23)
    w, h = 9, 6
    c = {}
    c["rgb565-masks"] = dds(w, h, rng.bytes(w * h * 2), pfflags=0x40, bitcount=16,
                            masks=(0xF800, 0x7E0, 0x1F))
    c["argb4444-masks"] = dds(w, h, rng.bytes(w * h * 2), pfflags=0x41, bitcount=16,
                              masks=(0xF00, 0xF0, 0xF, 0xF000))
    c["bgr24-masks"] = dds(w, h, rng.bytes(w * h * 3), pfflags=0x40, bitcount=24,
                           masks=(0xFF0000, 0xFF00, 0xFF))
    c["rgba32-masks-short"] = dds(w, h, rng.bytes(w * h * 4 - 9), pfflags=0x41, bitcount=32,
                                  masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    c["l8"] = dds(w, h, rng.bytes(w * h), pfflags=0x20000, bitcount=8)
    c["la16"] = dds(w, h, rng.bytes(w * h * 2), pfflags=0x20001, bitcount=16)
    c["l16-refused"] = dds(w, h, rng.bytes(w * h * 2), pfflags=0x20000, bitcount=16)
    c["p8"] = dds(w, h, rng.bytes(1024 + w * h), pfflags=0x20, bitcount=8)
    c["r8g8b8a8-dx10"] = dds(w, h, rng.bytes(w * h * 4), b"DX10", 28)
    c["dxgi-unimplemented"] = dds(w, h, rng.bytes(64), b"DX10", 2)
    c["fourcc-unimplemented"] = dds(w, h, rng.bytes(64), b"DXT2")
    c["bc1-truncated"] = dds(16, 16, rng.bytes(16 * 8 - 3), b"DXT1")
    c["header-size"] = b"DDS " + struct.pack("<I", 100) + bytes(120)
    c["header-short"] = b"DDS " + struct.pack("<I", 124) + bytes(60)
    return c


DDS_CASES = _dds_cases()


@pytest.mark.parametrize("name", sorted(DDS_CASES))
def test_hand_built_dds_matches_pil(name):
    assert_like_pil(DDS_CASES[name])


# ---- QOI -------------------------------------------------------------------------


def _qoi_cases() -> dict:
    """Every op, the index op on hits and misses, and cuts inside each op."""
    ops = bytearray()
    ops += b"\xfe\x10\x20\x30"  # RGB
    ops += bytes([0x40 | 0b111001])  # DIFF
    ops += bytes([0x80 | 40, 0x5A])  # LUMA
    ops += bytes([0xC0 | 5])  # RUN of 6
    ops += b"\xff\x01\x02\x03\x80"  # RGBA
    ops += bytes([0x00 | 7, 0x00 | 53])  # INDEX (a hit or a miss)
    ops += bytes([0xC0 | 61])  # RUN of 62
    ops += bytes([(0x10 * 3 + 0x20 + 0x30 * 5 + 0xFF * 11) % 64])
    body = bytes(ops) * 3
    c = {}
    for ch in (3, 4, 7):
        c[f"ops-{ch}ch"] = b"qoif" + struct.pack(">IIBB", 9, 10, ch, 0) + body + bytes(7) + b"\x01"
    full = c["ops-4ch"]
    for cut in (15, 17, 20, 22, 25):
        c[f"cut-{cut}"] = full[:cut]
    c["zero-width"] = b"qoif" + struct.pack(">IIBB", 0, 4, 3, 0) + bytes(8)
    c["short-header"] = b"qoif" + bytes(5)
    return c


QOI_CASES = _qoi_cases()


@pytest.mark.parametrize("name", sorted(QOI_CASES))
def test_hand_built_qoi_matches_pil(name):
    assert_like_pil(QOI_CASES[name])


# ---- truncated files, every format --------------------------------------------------


def _truncation_sources() -> dict:
    a = Image.fromarray(photo(13, 21, 5), "RGBA")
    return {"webp-lossy": pil_bytes(a, "WEBP", quality=70),
            "webp-lossless": pil_bytes(a, "WEBP", lossless=True),
            "gif": pil_bytes(a.convert("P"), "GIF"),
            "bmp": pil_bytes(a.convert("RGB"), "BMP"),
            "tga-rle": pil_bytes(a, "TGA", compression="tga_rle"),
            "ico": pil_bytes(a, "ICO"), "qoi": pil_bytes(a, "QOI"),
            "ppm": pil_bytes(a.convert("RGB"), "PPM"),
            "dds": pil_bytes(a, "DDS", pixel_format="DXT5")}


TRUNC = _truncation_sources()


@pytest.mark.parametrize("frac", [0.1, 0.3, 0.6, 0.9, 0.99])
@pytest.mark.parametrize("name", sorted(TRUNC))
def test_truncated_files_fail_as_pil_fails(name, frac):
    data = TRUNC[name]
    assert_like_pil(data[:max(1, int(len(data) * frac))])


@pytest.mark.parametrize("name", sorted(TRUNC))
def test_corrupt_payload_fails_or_decodes_as_pil(name):
    b = bytearray(TRUNC[name])
    rng = np.random.default_rng(len(name))
    for k in rng.integers(len(b) // 2, len(b), 12):
        b[k] ^= 0x5A
    assert_like_pil(bytes(b))


def test_unidentified_bytes_raise_oserror():
    for data in (b"", b"hello world, not an image", b"RIFF\x00\x00\x00\x00WEBPVP9 "):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data))
        with pytest.raises(OSError):
            decode_image(data)


def test_refused_jpeg_and_tiff_name_a10d():
    """The JPEG codings and TIFF codecs A.10d-b added read as PIL reads
    them: Huffman data under SOF9 (decoded as QM-coded data), and LZW data
    under ZSTD's compression tag (a frame that is not one: PIL's class);
    a CMYK TIFF decodes as PIL decodes it."""
    from rapidraw_tpu_torch.io import jpeg, tiff

    base = pil_bytes(Image.fromarray(photo(16, 16)[..., :3]), "JPEG", quality=85)
    at = base.index(b"\xff\xc0")
    arith = base[:at + 1] + b"\xc9" + base[at + 2:]
    assert_like_pil(arith)
    assert np.array_equal(jpeg.decode_jpeg(arith), np.asarray(Image.open(io.BytesIO(arith))))
    buf = io.BytesIO()
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(buf, "TIFF")
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    assert np.array_equal(tiff.decode_tiff_rgb(buf.getvalue()), want)
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (10, 20, 30)).save(buf, "TIFF", compression="tiff_lzw")
    zstd = bytearray(buf.getvalue())
    at = bytes(zstd).index(struct.pack("<HHI", 259, 3, 1))
    struct.pack_into("<H", zstd, at + 8, 50000)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(zstd))).load()
    with pytest.raises(OSError):
        tiff.decode_tiff_rgb(bytes(zstd))
    assert_like_pil(bytes(zstd))


# ---- load_image against JAX -----------------------------------------------------------


def _load_files(root: Path) -> dict:
    a = photo(24, 40, 9)
    ex = Image.Exif()
    ex[0x0112] = 6
    files = {
        "lossy.webp": pil_bytes(Image.fromarray(a[..., :3]), "WEBP", quality=80,
                                exif=ex.tobytes()),
        "alpha.webp": pil_bytes(Image.fromarray(a, "RGBA"), "WEBP", lossless=True),
        "pal.gif": GIF_CASES["transparency"],
        "rle8.bmp": BMP_CASES["rle8"],
        "cmap.tga": TGA_CASES["cmap16-first4"],
        "mixed.ico": ICO_CASES["bmp48-32bit-largest"],
        "bc7.dds": dds(40, 24, np.random.default_rng(3).bytes(10 * 6 * 16), b"DX10", 98),
        "rgba.qoi": pil_bytes(Image.fromarray(a, "RGBA"), "QOI"),
        "deep.pgm": PNM_CASES["p5-max4095"],
        "plain.pbm": PNM_CASES["p1-plain"],
        "rgb.ppm": pil_bytes(Image.fromarray(a[..., :3]), "PPM"),
        "any.pnm": PNM_CASES["p3-max15"],
    }
    out = {}
    for name, data in files.items():
        (root / name).write_bytes(data)
        out[name] = root / name
    return out


@pytest.fixture(scope="module")
def load_files(tmp_path_factory):
    return _load_files(tmp_path_factory.mktemp("ldr_formats"))


@pytest.mark.parametrize("enhance", [False, True])
@pytest.mark.parametrize("name", ["lossy.webp", "alpha.webp", "pal.gif", "rle8.bmp", "cmap.tga",
                                  "mixed.ico", "bc7.dds", "rgba.qoi", "deep.pgm", "plain.pbm",
                                  "rgb.ppm", "any.pnm"])
def test_load_image_matches_jax(name, enhance, load_files):
    """max |d| 0 against JAX's load_image run op by op, the non-RAW enhance
    off and on; the WebP's EXIF Orientation 6 turns both."""
    doc = {"applyPreprocessingToNonRaws": True} if enhance else {}
    path = load_files[name]
    with jax.disable_jit():
        want, want_raw = jloader.load_image(path, app_settings=JAppSettings(doc))
    got, raw = loader.load_image(path, app_settings=AppSettings(doc), device="cpu")
    want = np.asarray(want)
    assert raw is want_raw is False
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) == 0.0
    if name == "lossy.webp":
        assert want.shape == (3, 40, 24)


# ---- the callers: AI mask data URLs and HALD images -------------------------------------


@pytest.mark.parametrize("fmt", ["WEBP", "GIF", "BMP", "TGA", "QOI", "PPM"])
def test_ai_mask_data_url_matches_jax(fmt):
    """An AI mask's data URL in any format PIL opens decodes to JAX's "L"."""
    import base64

    from rapidraw_tpu.masks import parametric as jparametric
    from rapidraw_tpu_torch.masks import parametric

    mode = "RGB" if fmt in ("QOI", "PPM") else "RGBA"
    url = "data:image/x;base64," + base64.b64encode(pil_bytes(
        Image.fromarray(photo(20, 30, 6), "RGBA").convert(mode), fmt)).decode()
    want = jparametric._decode_data_url_gray(url)
    got = parametric._decode_data_url_gray(url)
    assert want is not None and np.array_equal(got, want)
    assert parametric._decode_data_url_gray("data:image/x;base64,AAAA") is None


@pytest.mark.parametrize("fmt", ["WEBP", "BMP", "GIF"])
def test_hald_lut_in_another_format_matches_jax(fmt, tmp_path):
    """A HALD image named .png whose bytes are another format: PIL (JAX)
    opens it by its content, and so does the port."""
    from rapidraw_tpu.io import lut as jlut
    from rapidraw_tpu_torch.io import lut

    size = 4
    r, g, b = np.meshgrid(*[np.linspace(0, 255, size * size)] * 3, indexing="ij")
    hald = np.stack([b, g, r], -1).reshape(size ** 3, size ** 3, 3)[:64, :64]
    im = Image.fromarray(hald.astype(np.uint8)[: 16 * 4, : 16 * 4])
    kw = {"lossless": True} if fmt == "WEBP" else {}
    (tmp_path / "hald.png").write_bytes(pil_bytes(im.convert("P") if fmt == "GIF" else im, fmt,
                                                  **kw))
    want = jlut.parse_lut_file(tmp_path / "hald.png")
    got = lut.parse_lut_file(tmp_path / "hald.png")
    assert got.shape == want.shape and np.array_equal(got, want)


# ---- the committed fixtures and chip_smoke phase 21's writers -----------------------------


DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_match_their_digests(name):
    """The port's decode (and PIL's) in each mode hashes to digests.json,
    which chip_smoke phase 21 checks on the card's machine without PIL."""
    data = (FIXTURES / name).read_bytes()
    im = Image.open(io.BytesIO(data))
    assert list(im.size) == DIGESTS[name]["size"]
    for mode in (m for m in MODES if m in DIGESTS[name]):  # a LAB file has no "L"
        got = decode_image(data, mode)
        want = hashlib.sha256(np.ascontiguousarray(np.asarray(im.convert(mode))).tobytes())
        assert hashlib.sha256(got.tobytes()).hexdigest() == want.hexdigest() == DIGESTS[name][mode]


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 400 * 1024


@pytest.mark.parametrize("size", [(40, 64), (36, 52)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_chip_smoke_ldr_format_writers_read_as_written(size, tmp_path):
    """Phase 21's writers (no PIL on the card's machine): PIL reads each
    file as the samples written, and so does the port."""
    import chip_smoke

    paths, samples = chip_smoke.write_ldr_formats(tmp_path, *size, 5)
    assert sorted(paths) == sorted(chip_smoke.LDR_FMT_FILES)
    for name, p in paths.items():
        want = samples[name]
        mode = "RGBA" if want.shape[-1] == 4 else "RGB"
        assert np.array_equal(np.asarray(Image.open(p).convert(mode)), want), name
        assert np.array_equal(decode_image(p.read_bytes(), mode), want), name
        assert_like_pil(p.read_bytes())


def test_chip_smoke_qoi_writer_uses_every_op_but_index():
    """The QOI writer emits run, diff, luma, RGB and RGBA ops."""
    import chip_smoke

    rgba = photo(30, 50, 4)
    rgba[:4] = (40, 90, 160, 255)
    rgba[10:12, :, 3] = 128
    smooth = np.cumsum(np.ones((30, 50, 3), np.int16), 1).astype(np.uint8)
    rgba[14:20, :, :3] = smooth[14:20] // 7
    rgba[14:20, :, 3] = 255
    data = chip_smoke.qoi_bytes(rgba)
    assert np.array_equal(decode_image(data, "RGBA"), rgba)
    body = data[14:-8]
    tags = set()
    pos = 0
    while pos < len(body):
        b = body[pos]
        if b in (0xFE, 0xFF):
            tags.add(b)
            pos += 4 if b == 0xFE else 5
        else:
            tags.add(b >> 6)
            pos += 2 if b >> 6 == 2 else 1
    assert tags >= {1, 2, 3, 0xFE, 0xFF}
    assert zlib.crc32(data) == zlib.crc32(chip_smoke.qoi_bytes(rgba))


# ---- sizes from the header alone -----------------------------------------------------


def _pil_size(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return im.size
    except Exception:  # noqa: BLE001 - a file PIL does not open has no size to match
        return None


def _size_cases() -> dict:
    lossy = pil_bytes(Image.fromarray(photo(37, 53, 6)), "WEBP", quality=50)
    cases = {f"{family}-{k}": v for family, table in (
        ("bmp", BMP_CASES), ("tga", TGA_CASES), ("gif", GIF_CASES), ("pnm", PNM_CASES),
        ("ico", ICO_CASES), ("dds", DDS_CASES), ("qoi", QOI_CASES), ("trunc", TRUNC))
        for k, v in table.items()}
    cases["webp-lossy"] = lossy
    return {k: v for k, v in cases.items() if _pil_size(v) is not None}


SIZE_CASES = _size_cases()


@pytest.mark.parametrize("name", sorted(SIZE_CASES))
def test_image_size_from_the_head_matches_pil(name):
    """`image_size` (the catalog's dimension read) gives PIL's `.size`
    from the file's first bytes; a lossy WebP's size from its first 40
    bytes, the rest of the frame unread."""
    from rapidraw_tpu_torch.io.image_decode import image_size

    data = SIZE_CASES[name]
    head = data[:40] if name == "webp-lossy" else data[:64 * 1024]
    assert image_size(head, lambda: data) == _pil_size(data)


# ---- no stand-in for a decoder that does not build ----------------------------------


def _without_host_builds(monkeypatch):
    from rapidraw_tpu_torch import native

    def fail(name, *a, **k):
        raise native.KernelBuildError(f"g++ failed on {name}.cc")

    monkeypatch.setattr(native, "host_library", fail)
    return native.KernelBuildError


def _data_url(fmt: str, img: np.ndarray) -> str:
    import base64

    return (f"data:image/{fmt.lower()};base64,"
            + base64.b64encode(pil_bytes(Image.fromarray(img), fmt)).decode())


@pytest.mark.parametrize("fmt", ["GIF", "WEBP", "QOI"])
def test_patch_with_an_unbuilt_decoder_raises(fmt, monkeypatch):
    """A patch whose decoder does not build fails the composite; it is not
    skipped as undecodable data is."""
    import torch

    from rapidraw_tpu_torch.masks import patches

    url = _data_url(fmt, photo(24, 32, 1))
    err = _without_host_builds(monkeypatch)
    with pytest.raises(err):
        patches.composite_patches_on_image(torch.zeros(3, 24, 32), {"aiPatches": [
            {"id": "a", "patchData": {"color": url, "mask": url}}]})


@pytest.mark.parametrize("fmt", ["GIF", "WEBP", "QOI"])
def test_ai_mask_with_an_unbuilt_decoder_raises(fmt, monkeypatch):
    """An AI mask whose decoder does not build raises KernelBuildError
    instead of giving no mask."""
    from rapidraw_tpu_torch.masks import parametric

    url = _data_url(fmt, photo(24, 32, 2))
    assert parametric.generate_ai_mask({"maskDataBase64": url}, 32, 24, 1.0, (0, 0)) is not None
    err = _without_host_builds(monkeypatch)
    with pytest.raises(err):
        parametric.generate_ai_mask({"maskDataBase64": url}, 32, 24, 1.0, (0, 0))


def test_tagging_walk_with_an_unbuilt_decoder_raises(tmp_path, monkeypatch):
    """The tagging walk stops on a decoder that does not build, as on a
    missing checkpoint; it does not skip the file."""
    from rapidraw_tpu_torch.ai import tagging

    Image.fromarray(photo(24, 32, 3)).save(tmp_path / "a.gif")
    err = _without_host_builds(monkeypatch)
    with pytest.raises(err):
        tagging.index_folder_tags(str(tmp_path), device="cpu")


@pytest.mark.parametrize("site", ["service", "bake"])
def test_hald_lut_with_an_unbuilt_decoder_raises(site, tmp_path, monkeypatch):
    """A HALD image (GIF bytes in a .png) whose decoder does not build
    fails the render or the bake; the LUT is not dropped."""
    import types

    from rapidraw_tpu_torch.pipeline import service, watermark

    hald = np.zeros((8, 8, 3), np.uint8)
    Image.fromarray(hald).save(tmp_path / "hald.png", format="GIF")
    adj = {"lutPath": str(tmp_path / "hald.png")}
    err = _without_host_builds(monkeypatch)
    with pytest.raises(err):
        if site == "service":
            service.RenderService(device="cpu")._load_lut(adj, types.SimpleNamespace(has_lut=True))
        else:
            watermark.export_adjustments_as_lut(adj, lut_size=2, device="cpu")
