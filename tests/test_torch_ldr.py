"""The port's LDR loader (io/jpeg.py, io/tiff.py, io/encode.py's PNG views,
io/float_images.py, io/loader.py) against PIL, cv2 and the JAX package.

- JPEG: csrc/host/jpeg_dec.cc equals PIL's pixels (libjpeg-turbo, ISLOW,
  fancy upsampling) at every sampling PIL and cv2 write (4:4:4, 4:2:2,
  4:2:0, 4:4:0, 4:1:1), grey, progressive, optimized tables, restart
  markers, odd sizes and 1024 x 1536; truncated files fail where PIL
  fails; Huffman data under an arithmetic-coding SOF, and a 12-bit or CMYK
  file, read as PIL reads them (tests/test_torch_ldr_variants.py and
  tests/test_torch_ldr_variants_b.py hold the rest).
- TIFF: files written here (`tiff_bytes`: every compression, predictor,
  strips and tiles, chunky and planar, both byte orders) and by PIL and
  cv2, read as PIL's convert("RGB") and as the JAX package's 16-bit read.
- PNG at 16 bits, as the JAX package's `_load_deep_u16` reads it through
  cv2.
- EXIF orientation of JPEG (APP1), PNG (eXIf) and TIFF (IFD0) files.
- `load_image` against JAX's `load_image` run op by op, every format, with
  and without the non-RAW enhance: max |d| 0.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest

# ---- writers -----------------------------------------------------------------


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, early change, a Clear before the table
    fills) with a real string table."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8

    def reset():
        nonlocal width
        width = 9
        return {bytes([i]): i for i in range(256)}, 258

    table, nxt = reset()
    emit(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= 4093:
            emit(256)
            table, nxt = reset()
        elif nxt >= (1 << width):
            width += 1
        w = bytes([c])
    if w:
        emit(table[w])
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and (j + 1 >= n or data[j + 1] != data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
             32773: packbits_encode}


def tiff_bytes(px: np.ndarray, bits: int = 8, photo: int = 2, compression: int = 1,
               predictor: int = 1, planar: int = 1, tile: tuple | None = None,
               rows_per_strip: int | None = None, endian: str = "<", extra: tuple = (),
               colormap=None, orientation: int | None = None, spp_tag: bool = True) -> bytes:
    """(H, W, spp) samples -> a TIFF file. Sub-byte samples are packed MSB
    first, rows padded to whole bytes; 16-bit samples in `endian` order."""
    px = np.asarray(px)
    h, w, spp = px.shape
    planes = [px[..., i:i + 1] for i in range(spp)] if planar == 2 else [px]

    def chunk_bytes(a: np.ndarray) -> bytes:
        a = a.astype(np.int64)
        if predictor == 2:
            a = a.copy()
            a[:, 1:] = a[:, 1:] - a[:, :-1]
            a &= (1 << bits) - 1
        if bits == 16:
            return a.astype(endian + "u2").tobytes()
        if bits == 8:
            return a.astype(np.uint8).tobytes()
        rows = a.reshape(a.shape[0], -1)
        per = 8 // bits
        pad = (-rows.shape[1]) % per
        rows = np.pad(rows, ((0, 0), (0, pad))).reshape(rows.shape[0], -1, per)
        shifts = np.arange(8 - bits, -1, -bits)
        return (rows << shifts).sum(-1).astype(np.uint8).tobytes()

    chunks = []
    for p in planes:
        if tile:
            tw, tl = tile
            padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw, p.shape[2]), p.dtype)
            padded[:h, :w] = p
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    chunks.append(_COMPRESS[compression](chunk_bytes(padded[y:y + tl, x:x + tw])))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                chunks.append(_COMPRESS[compression](chunk_bytes(p[y:y + rps])))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photo]), 284: (3, [planar])}
    if spp_tag:
        tags[277] = (3, [spp])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in colormap])
    if orientation is not None:
        tags[274] = (3, [orientation])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
        tags[324], tags[325] = (4, [0] * len(chunks)), (4, [len(c) for c in chunks])
    else:
        tags[278] = (4, [rows_per_strip or h])
        tags[273], tags[279] = (4, [0] * len(chunks)), (4, [len(c) for c in chunks])
    e = endian
    n = len(tags)
    ifd_size = 2 + 12 * n + 4
    data_at = 8 + ifd_size
    blobs = bytearray()
    # pixel data first (after the IFD and its overflow values)
    overflow = {t: struct.pack(e + ("H" if typ == 3 else "L") * len(v), *v)
                for t, (typ, v) in tags.items()}
    over_size = sum(len(b) + (len(b) & 1) for b in overflow.values() if len(b) > 4)
    pix_at = data_at + over_size
    offs, at = [], pix_at
    for c in chunks:
        offs.append(at)
        at += len(c)
    key = 324 if tile else 273
    tags[key] = (4, offs)
    overflow[key] = struct.pack(e + "L" * len(offs), *offs)
    entries = bytearray()
    at = data_at
    for t in sorted(tags):
        typ, v = tags[t]
        b = overflow[t]
        if len(b) <= 4:
            entries += struct.pack(e + "HHL", t, typ, len(v)) + b.ljust(4, b"\0")
        else:
            entries += struct.pack(e + "HHLL", t, typ, len(v), at)
            blobs += b + (b"\0" if len(b) & 1 else b"")
            at += len(b) + (len(b) & 1)
    head = (b"II*\0" if e == "<" else b"MM\0*") + struct.pack(e + "L", 8)
    body = struct.pack(e + "H", n) + entries + struct.pack(e + "L", 0)
    return head + body + bytes(blobs) + b"".join(chunks)


# ---- JPEG ------------------------------------------------------------------------

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from rapidraw_tpu.io import encode as jencode  # noqa: E402
from rapidraw_tpu.io import loader as jloader  # noqa: E402
from rapidraw_tpu.utils.settings import AppSettings as JAppSettings  # noqa: E402
from rapidraw_tpu_torch.io import encode, jpeg, loader, tiff  # noqa: E402
from rapidraw_tpu_torch.io.exif import image_orientation  # noqa: E402
from rapidraw_tpu_torch.utils.settings import AppSettings  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Gradients, edges and noise: every code of u8 appears at larger sizes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2) % 256, ((x ^ y) * 5) % 256], -1).astype(float)
    return np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)


def pil_jpeg(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(a: np.ndarray, sampling: str, progressive: bool = False) -> bytes:
    import cv2

    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, enc = cv2.imencode(".jpg", a[..., ::-1], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                                                   cv2.IMWRITE_JPEG_QUALITY, 80,
                                                   cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return enc.tobytes()


JPEG_CASES = {
    **{f"pil{s}{name}": (lambda a, s=s, kw=kw: pil_jpeg(a, quality=85, subsampling=s, **kw))
       for s in ("4:4:4", "4:2:2", "4:2:0")
       for name, kw in (("", {}), ("-progressive", {"progressive": True}),
                        ("-optimize", {"optimize": True}),
                        ("-restart-rows", {"restart_marker_rows": 1}),
                        ("-restart-blocks", {"restart_marker_blocks": 3}))},
    "grey": lambda a: pil_jpeg(a[..., 0], quality=90),
    "grey-progressive": lambda a: pil_jpeg(a[..., 0], quality=90, progressive=True),
    "q100": lambda a: pil_jpeg(a, quality=100, subsampling=0),
    "q5": lambda a: pil_jpeg(a, quality=5),
    "cv2-4:1:1": lambda a: cv2_jpeg(a, "411"),
    "cv2-4:4:0": lambda a: cv2_jpeg(a, "440"),
    "cv2-4:4:0-progressive": lambda a: cv2_jpeg(a, "440", True),
    "cv2-4:2:0-progressive": lambda a: cv2_jpeg(a, "420", True),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
@pytest.mark.parametrize("size", [(1, 1), (9, 17), (17, 9), (33, 2), (2, 33), (767, 1023)])
def test_jpeg_matches_pil(case, size):
    """Every pixel equal to PIL's (libjpeg-turbo), in both of PIL's modes and
    convert("L"); the narrow sizes take the replicating upsamplers."""
    data = JPEG_CASES[case](photo(*size, seed=size[0]))
    im = Image.open(io.BytesIO(data))
    want = np.asarray(im)
    got = jpeg.decode_jpeg(data)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert np.array_equal(jpeg.decode_jpeg_rgb(data), np.asarray(im.convert("RGB")))
    assert np.array_equal(jpeg.decode_jpeg_gray(data), np.asarray(im.convert("L")))


def test_jpeg_1024x1536_matches_pil():
    data = pil_jpeg(photo(1024, 1536, 3), quality=90)
    assert np.array_equal(jpeg.decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))))
    assert jpeg.jpeg_info(data) == (1536, 1024, 3)


@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_jpeg_fails_where_pil_fails(progressive):
    data = pil_jpeg(photo(40, 56, 1), quality=85, progressive=progressive)
    for cut in (1, 2, 3, 10, len(data) // 2, len(data) - 300, len(data) - 20, len(data) - 2):
        part = data[:len(data) - cut]
        with pytest.raises(OSError):
            Image.open(io.BytesIO(part)).convert("RGB")
        with pytest.raises(OSError):
            jpeg.decode_jpeg(part)


def _patched(data: bytes, marker: int, offset: int = 0, value: int | None = None) -> bytes:
    """`data` with its SOF0 marker code replaced (or a byte of its segment)."""
    at = data.index(b"\xff\xc0")
    b = bytearray(data)
    if value is None:
        b[at + 1] = marker
    else:
        b[at + 4 + offset] = value
    return bytes(b)


def test_refused_jpeg_codings_name_a10c():
    """Huffman data under an arithmetic-coding SOF (SOF9, SOF10) decodes as
    libjpeg decodes it for PIL (as QM-coded data), or fails where PIL
    fails; a 12-bit frame is one PIL does not open (UnidentifiedImageError,
    an OSError), and a CMYK file and a lossless one decode as PIL decodes
    them."""
    from PIL import UnidentifiedImageError

    base = pil_jpeg(photo(16, 16), quality=85)
    for data in (_patched(base, 0xC9), _patched(base, 0xCA)):
        try:
            want = np.asarray(Image.open(io.BytesIO(data)))
        except OSError:
            with pytest.raises(OSError):
                jpeg.decode_jpeg(data)
        else:
            assert np.array_equal(jpeg.decode_jpeg(data), want)
    twelve = _patched(base, 0, offset=0, value=12)
    with pytest.raises(UnidentifiedImageError):
        Image.open(io.BytesIO(twelve))
    with pytest.raises(OSError):
        jpeg.decode_jpeg(twelve)
    cmyk = io.BytesIO()
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(cmyk, "JPEG")
    im = Image.open(io.BytesIO(cmyk.getvalue()))
    assert np.array_equal(jpeg.decode_jpeg(cmyk.getvalue()), np.asarray(im))
    assert np.array_equal(jpeg.decode_jpeg_rgb(cmyk.getvalue()), np.asarray(im.convert("RGB")))
    lossless = _patched(base, 0xC3)  # DCT data read as lossless: what PIL makes of it
    try:
        want = np.asarray(Image.open(io.BytesIO(lossless)).convert("RGB"))
    except OSError:
        with pytest.raises(OSError):
            jpeg.decode_jpeg_rgb(lossless)
    else:
        assert np.array_equal(jpeg.decode_jpeg_rgb(lossless), want)


# ---- TIFF --------------------------------------------------------------------

# (bits, photometric, samples, ExtraSamples)
TIFF_LAYOUTS = [(8, 2, 3, ()), (8, 2, 4, (2,)), (8, 2, 4, (1,)), (8, 2, 4, (0,)), (8, 2, 4, ()),
                (8, 1, 1, ()), (8, 0, 1, ()), (1, 1, 1, ()), (1, 0, 1, ()), (2, 1, 1, ()),
                (4, 1, 1, ()), (2, 0, 1, ()), (4, 0, 1, ()), (16, 1, 1, ()), (16, 0, 1, ()),
                (8, 1, 2, (2,)), (16, 2, 3, ()), (16, 2, 4, (2,)), (8, 3, 1, ()), (4, 3, 1, ()),
                (16, 1, 2, (2,))]


def _layout_samples(bits, photo_, spp, extra, seed=0, h=13, w=21):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint16 if bits == 16 else np.uint8)
    if extra == (1,):  # associated alpha: colour <= alpha
        px[..., :3] = np.minimum(px[..., :3], px[..., 3:4])
    cmap = rng.integers(0, 65536, 3 * (1 << bits)) if photo_ == 3 else None
    return px, cmap


@pytest.mark.parametrize("layout", TIFF_LAYOUTS, ids=lambda v: "-".join(map(str, v)))
def test_tiff_matches_pil(layout):
    """convert("RGB") as PIL's for each compression, predictor, strips and
    tiles, chunky and planar, both byte orders; the planar layouts as PIL
    reads them, wrong or not (16-bit uncompressed planes read as bytes, an
    LA file's alpha lost), and the class of the error where PIL fails."""
    bits, photo_, spp, extra = layout
    px, cmap = _layout_samples(*layout)
    for comp in (1, 5, 8, 32773):
        for pred in ((1, 2) if bits >= 8 else (1,)):
            for planar in ((1, 2) if spp > 1 else (1,)):
                for tile in (None, (16, 16)):
                    for endian in "<>":
                        data = tiff_bytes(px, bits, photo_, comp, pred, planar, tile, 5,
                                          endian, extra, cmap)
                        try:
                            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                        except (OSError, ValueError) as e:  # PIL cannot read it: nor the port
                            with pytest.raises(OSError if isinstance(e, OSError) else ValueError):
                                tiff.decode_tiff_rgb(data)
                            continue
                        got = tiff.decode_tiff_rgb(data)
                        assert np.array_equal(got, want), (comp, pred, planar, tile, endian)


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "1", "P", "LA"])
def test_pil_written_tiff_matches_pil(compression, mode):
    a = photo(37, 29, 4)
    im = Image.fromarray(a).convert(mode) if mode != "P" else Image.fromarray(a).quantize(40)
    if mode == "RGBA":
        im.putalpha(Image.fromarray(a[..., 1]))
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression)
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(tiff.decode_tiff_rgb(data), want)


def _cv2_tiff(a16, compression, predictor, rows=None) -> bytes:
    import cv2

    params = [cv2.IMWRITE_TIFF_COMPRESSION, compression, cv2.IMWRITE_TIFF_PREDICTOR, predictor]
    if rows:
        params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
    ok, enc = cv2.imencode(".tif", a16[..., ::-1], params)
    assert ok
    return enc.tobytes()


@pytest.mark.parametrize("source", ["here", "cv2"])
def test_tiff16_matches_jax(source, tmp_path):
    """The full-depth 16-bit RGB read equals JAX's read_tiff16_rgb (its strip
    reader, or cv2 for compressed files), None where it is None; compressed
    planar files, which cv2 reads through a strip buffer it does not clear
    (two reads of one file differ), are refused naming ROADMAP's Known
    differences."""
    rng = np.random.default_rng(9)
    a16 = rng.integers(0, 65536, (13, 21, 3), dtype=np.uint16)
    files = []
    if source == "cv2":
        for comp in (1, 5, 8, 32773):
            for pred in (1, 2):
                files.append((_cv2_tiff(a16, comp, pred, rows=4), False))
    else:
        for spp, extra in ((3, ()), (4, (2,)), (1, ())):
            px = rng.integers(0, 65536, (13, 21, spp), dtype=np.uint16)
            for comp in (1, 5, 8, 32773):
                for pred in (1, 2):
                    for planar in ((1, 2) if spp > 1 else (1,)):
                        for tile in (None, (16, 16)):
                            for endian in "<>":
                                data = tiff_bytes(px, 16, 2 if spp > 1 else 1, comp, pred,
                                                  planar, tile, 5, endian, extra)
                                files.append((data, planar == 2 and comp != 1 and spp == 3))
    for data, refused in files:
        p = tmp_path / "a.tif"
        p.write_bytes(data)
        if refused:
            with pytest.raises(NotImplementedError, match="Known differences"):
                tiff.read_tiff16_rgb(data)
            continue
        want, got = jencode.read_tiff16_rgb(p), tiff.read_tiff16_rgb(data)
        assert (want is None) == (got is None)
        if want is not None:
            assert want.dtype == got.dtype and np.array_equal(want, got)


# ---- PNG at 16 bits ----------------------------------------------------------------


def _jax_deep(tmp_path, data: bytes, ext: str):
    p = tmp_path / f"x.{ext}"
    p.write_bytes(data)
    out = jloader._load_deep_u16(p, ext)
    return None if out is None else out[0]


def test_png16_view_matches_jax(tmp_path):
    """decode_png_u16 equals cv2's read through JAX's _load_deep_u16: grey,
    RGB, grey + alpha, RGBA, with tRNS, interlaced; None for 8-bit and for
    malformed files."""
    from test_torch_encode import make_png, random_png

    rng = np.random.default_rng(2)
    datas = [random_png(ct, 16, il, 9, 14, 3 + ct) for ct in (0, 2, 4, 6) for il in (False, True)]
    s = rng.integers(0, 65536, (5, 7, 3))
    datas.append(make_png(s, 16, 2, False, rng, trns=struct.pack(">HHH", *map(int, s[0, 0]))))
    datas.append(make_png(s[..., :1], 16, 0, False, rng, trns=struct.pack(">H", int(s[0, 0, 0]))))
    datas += [random_png(2, 8, False, 5, 5, 1), random_png(0, 8, False, 5, 5, 1)]
    bad = bytearray(datas[0])
    bad[40:60] = bytes(20)  # a corrupt IDAT
    datas += [bytes(bad), datas[0][:60]]
    for data in datas:
        want, got = _jax_deep(tmp_path, data, "png"), encode.decode_png_u16(data)
        assert (want is None) == (got is None)
        if want is not None:
            assert np.array_equal(want, got)
    assert sum(encode.decode_png_u16(d) is not None for d in datas) == 10


def test_png_bytes_writes_grey_as_pil_reads_it():
    """The mask alpha PNGs: (H, W) u8 as colour type 0, read back by PIL
    as mode "L" with the same values."""
    a = photo(19, 33)[..., 0]
    data = encode.png_bytes(a)
    im = Image.open(io.BytesIO(data))
    assert im.mode == "L" and np.array_equal(np.asarray(im), a)
    assert data[25] == 0  # IHDR colour type


# ---- EXIF orientation ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "TIFF"])
def test_orientation_matches_pil(fmt):
    a = photo(6, 9)
    for o in (None, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 300):
        ex = Image.Exif()
        if o is not None:
            ex[0x0112] = o
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, fmt, exif=ex.tobytes() if o is not None else b"")
        data = buf.getvalue()
        assert image_orientation(data) == (Image.open(io.BytesIO(data)).getexif()
                                           .get(0x0112, 1) or 1), o
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, fmt, xmp=b"<x><tiff:Orientation>3</tiff:Orientation></x>")
    data = buf.getvalue()
    assert image_orientation(data) == (Image.open(io.BytesIO(data)).getexif()
                                       .get(0x0112, 1) or 1)


# ---- load_image against JAX -------------------------------------------------------------


def _write_sources(root) -> dict:
    """One file per format the port loads, each oriented where it can be."""
    import cv2

    from rapidraw_tpu.io.float_images import write_hdr
    from rapidraw_tpu_torch.io.jxl import encode_jxl

    a = photo(24, 40, 5)
    a.reshape(-1)[:256] = np.arange(256)  # every u8 code
    rng = np.random.default_rng(6)
    a16 = rng.integers(0, 65536, (24, 40, 3), dtype=np.uint16)
    a16.reshape(-1)[:6] = [0, 1, 255, 256, 65534, 65535]
    ex = Image.Exif()
    ex[0x0112] = 6
    out = {}

    def put(name, data):
        (root / name).write_bytes(data)
        out[name] = root / name

    put("q90.jpg", pil_jpeg(a, quality=90, exif=ex.tobytes()))
    put("prog.jpeg", pil_jpeg(a, quality=75, progressive=True, subsampling=1))
    put("grey.jpg", pil_jpeg(a[..., 0], quality=80))
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG", exif=ex.tobytes())
    put("rgb8.png", buf.getvalue())
    ok, enc = cv2.imencode(".png", a16[..., ::-1])
    put("rgb16.png", enc.tobytes())
    ok, enc = cv2.imencode(".png", a16[..., 0])
    put("grey16.png", enc.tobytes())
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "TIFF", compression="tiff_lzw", exif=ex.tobytes())
    put("lzw8.tif", buf.getvalue())
    put("pal.tiff", tiff_bytes(a[..., :1] // 64, 8, 3, 8, colormap=rng.integers(0, 65536, 768)))
    put("rgb16.tif", tiff_bytes(a16, 16, 2, 1, orientation=8))
    put("lzw16.tif", _cv2_tiff(a16, 5, 2))
    # orientation quirks (ROADMAP queue C): cv2 turns a compressed 16-bit
    # TIFF at 2-4 and refuses it at 5-8; PIL turns TIFFs as it loads them
    put("orient3-lzw16.tif", tiff_bytes(a16, 16, 2, 5, orientation=3))
    put("orient6-lzw16.tif", tiff_bytes(a16, 16, 2, 5, orientation=6))
    put("orient5-8bit.tif", tiff_bytes(a, 8, 2, 32773, orientation=5))
    put("packbits16.tif", tiff_bytes(a16, 16, 2, 32773, tile=(16, 16)))
    put("grey16.tif", tiff_bytes(a16[..., :1], 16, 1, 8))
    put("scene.hdr", write_hdr(a.astype(np.float32) / 200.0))
    put("pix.ff", b"farbfeld" + struct.pack(">II", 40, 24)
        + np.concatenate([a16, a16[..., :1]], axis=2).astype(">u2").tobytes())
    put("pix.pam", b"P7\nWIDTH 40\nHEIGHT 24\nDEPTH 3\nMAXVAL 65535\nENDHDR\n"
        + a16.astype(">u2").tobytes())
    from test_float_images import _build_exr

    put("scene.exr", _build_exr(a.astype(np.float32) / 128.0, 3))
    put("lossless.jxl", encode_jxl(a, 100))
    return out


LOAD_FILES = ["q90.jpg", "prog.jpeg", "grey.jpg", "rgb8.png", "rgb16.png", "grey16.png",
              "lzw8.tif", "pal.tiff", "rgb16.tif", "lzw16.tif", "packbits16.tif",
              "orient3-lzw16.tif", "orient6-lzw16.tif", "orient5-8bit.tif",
              "grey16.tif", "scene.hdr", "pix.ff", "pix.pam", "scene.exr", "lossless.jxl"]


@pytest.fixture(scope="module")
def ldr_sources(tmp_path_factory):
    return _write_sources(tmp_path_factory.mktemp("ldr"))


@pytest.mark.parametrize("enhance", [False, True])
@pytest.mark.parametrize("name", LOAD_FILES)
def test_load_image_matches_jax(name, enhance, ldr_sources):
    """max |d| 0 against JAX's load_image run op by op (its jitted enhance
    fuses arithmetic the port runs op by op), with and without the non-RAW
    enhance (applyPreprocessingToNonRaws)."""
    doc = {"applyPreprocessingToNonRaws": True} if enhance else {}
    path = ldr_sources[name]
    with jax.disable_jit():
        want, want_raw = jloader.load_image(path, app_settings=JAppSettings(doc))
    got, raw = loader.load_image(f"{path}?vc=1", app_settings=AppSettings(doc), device="cpu")
    want = np.asarray(want)
    assert raw is want_raw is False
    assert got.dtype == torch_f32() and tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) == 0.0


def torch_f32():
    import torch

    return torch.float32


def test_u8_and_u16_scaling_is_exact():
    """Every u8 code and a spread of u16 codes divide as float32 true
    divisions (JAX's / 255.0, / 65535.0)."""
    import jax.numpy as jnp

    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, axis=2)
    u16 = np.linspace(0, 65535, 4096).astype(np.uint16).reshape(64, 64, 1).repeat(3, axis=2)
    for arr, scale in ((u8, 255.0), (u16, 65535.0)):
        want = np.asarray(jnp.transpose(jnp.asarray(arr).astype(jnp.float32), (2, 0, 1)) / scale)
        got = loader.upload_scaled(arr, scale, "cpu").numpy()
        assert np.array_equal(got, want)


def test_big_endian_tiff16_loads_where_jax_raises(tmp_path):
    """JAX's strip reader hands jnp.asarray a '>u2' array, which it refuses
    (ROADMAP queue C); the port swaps to native order and loads the same
    values as the little-endian file."""
    rng = np.random.default_rng(4)
    a16 = rng.integers(0, 65536, (8, 12, 3), dtype=np.uint16)
    (tmp_path / "be.tif").write_bytes(tiff_bytes(a16, 16, 2, 1, endian=">"))
    (tmp_path / "le.tif").write_bytes(tiff_bytes(a16, 16, 2, 1, endian="<"))
    with pytest.raises(TypeError):
        jloader.load_image(tmp_path / "be.tif")
    be, _ = loader.load_image(tmp_path / "be.tif", device="cpu", fast=True)
    le, _ = loader.load_image(tmp_path / "le.tif", device="cpu", fast=True)
    assert np.array_equal(be.numpy(), le.numpy())
    with jax.disable_jit():
        want = np.asarray(jloader.load_image(tmp_path / "le.tif", fast=True)[0])
    assert np.array_equal(le.numpy(), want)


def test_unknown_bytes_fail_as_pil_fails(tmp_path):
    (tmp_path / "x.jpg").write_bytes(b"not an image at all")
    with pytest.raises(OSError):
        jloader.load_image(tmp_path / "x.jpg")
    with pytest.raises(OSError):
        loader.load_image(tmp_path / "x.jpg", device="cpu")


def test_ldr_load_defaults_to_the_card(ldr_sources):
    """Without `device=` the image goes to CUDA: on a machine without a card
    the upload raises rather than falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        loader.load_image(ldr_sources["q90.jpg"])


def test_chip_smoke_ldr_sources_load_as_jax(tmp_path):
    """chip_smoke phase 15's files (the port's own writers, the literal-code
    LZW TIFF among them) load on the CPU as JAX loads them, and PIL reads
    the LZW strip as the samples written."""
    import chip_smoke

    paths = chip_smoke.write_ldr_sources(tmp_path, 40, 64, 3)
    rgb8 = (chip_smoke.ldr_rgb16(40, 64, 3) >> 8).astype(np.uint8)
    assert np.array_equal(np.asarray(Image.open(paths["lzw.tif"])), rgb8)
    for name, p in paths.items():
        with jax.disable_jit():
            want = np.asarray(jloader.load_image(p)[0])
        got = loader.load_image(p, device="cpu")[0].numpy()
        assert got.shape == want.shape and np.array_equal(got, want), name
    assert loader.load_image(paths["shot.jpg"], device="cpu")[0].shape == (3, 64, 40)
