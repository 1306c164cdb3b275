"""Output encoding on the host: JPEG, PNG, TIFF, WebP, AVIF and JPEG XL.

Port of `rapidraw_tpu/io/encode.py` (export_processing.rs:388-469, the
format dispatch and quality) with writers of the port's own in place of
PIL and cv2:
  * JPEG: the baseline encoder csrc/host/jpeg_enc.cc (`native.jpeg_encode`),
    which writes what PIL's libjpeg-turbo writes at the same quality;
  * PNG: zlib + struct here (cv2's zlib settings), 16-bit for float or u16
    renders and 8-bit for u8 sources, as the JAX package decides (its
    16-bit PNG comes from cv2);
  * TIFF: 16-bit RGB, one strip, its directory serialized by io/exif.py's
    `TiffDir` as PIL's ImageFileDirectory_v2 serializes the JAX package's;
  * WebP: the lossy VP8 encoder csrc/host/webp_enc.cc through io/webp.py,
    at the quantizer libwebp gives the quality (its own bytes, not
    libwebp's);
  * AVIF: the system libavif through io/avif.py, with PIL's settings;
  * JPEG XL: the system libjxl through io/jxl.py.
Without a libavif (or libjxl) the format raises the JAX package's "not
supported by this PIL build" ValueError, as PIL without the plugin does.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from rapidraw_tpu_torch.io.exif import TiffDir, tiff_first_ifd

# the PNG writer's zlib settings: cv2's defaults (level 1, run-length strategy)
PNG_LEVEL = 1
PNG_STRATEGY = zlib.Z_RLE


def write_tiff16(
    path: str | Path, arr16: np.ndarray, extra_tags: dict | None = None
) -> None:
    """Write (H, W, 3) u16 as an uncompressed baseline 16-bit RGB TIFF.

    The directory (including any extra_tags, e.g. flattened EXIF) is
    serialized as PIL's ImageFileDirectory_v2 does the JAX package's:
    extra tags typed on their values, an untypable one skipped, and
    StripOffsets moved to land right after the directory block."""
    arr16 = np.ascontiguousarray(arr16, dtype=np.uint16)
    h, w, _ = arr16.shape
    ifd = TiffDir("<")
    for tag, value in (extra_tags or {}).items():
        try:
            ifd[tag] = value
        except Exception:  # noqa: BLE001 — untypable foreign tag, skip it
            continue
    ifd[256] = w  # ImageWidth
    ifd[257] = h  # ImageLength
    ifd[258] = (16, 16, 16)  # BitsPerSample
    ifd[259] = 1  # Compression: none
    ifd[262] = 2  # Photometric: RGB
    ifd[273] = (0,)  # StripOffsets — moved by tobytes to the end of the IFD
    ifd[277] = 3  # SamplesPerPixel
    ifd[278] = h  # RowsPerStrip (single strip)
    ifd[279] = (h * w * 6,)  # StripByteCounts
    data = ifd.tobytes(8)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8))
        f.write(data)
        f.write(arr16.astype("<u2").tobytes())


def read_tiff16_rgb(path: str | Path) -> np.ndarray | None:
    """(H, W, 3) u16 from an uncompressed 16-bit RGB TIFF, or None when the
    file is not one (8-bit, other sample counts, compressed, or not a TIFF).
    Raises ValueError on a TIFF whose first frame a reader cannot open, as
    the JAX package's PIL does. Big-endian strips come back as a '>u2'
    array and PlanarConfiguration = 2 is read as interleaved, as in JAX."""
    with open(path, "rb") as f:
        data = f.read()
    first = tiff_first_ifd(data)
    if first is None:
        return None
    endian, t = first
    bits = t.get(258)
    if isinstance(bits, (tuple, list)):
        bits = bits[0] if bits else 0
    if bits != 16 or t.get(277, 3) != 3:
        return None
    h, w = int(t[257]), int(t[256])
    if int(t.get(259, 1)) != 1:
        return None  # compressed: the JAX package decodes these through cv2
    offsets = t.get(273) or ()
    counts = t.get(279) or ()
    if not isinstance(offsets, (tuple, list)):
        offsets = (offsets,)
    if not isinstance(counts, (tuple, list)):
        counts = (counts,)
    raw = b"".join(data[int(off):int(off) + int(cnt)] for off, cnt in zip(offsets, counts))
    arr = np.frombuffer(raw, dtype=endian + "u2")
    if arr.size != h * w * 3:
        return None
    return arr.reshape(h, w, 3)


def _png_chunk(ctype: bytes, payload: bytes) -> bytes:
    body = ctype + payload
    return struct.pack(">I", len(payload)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def png_bytes(hwc: np.ndarray) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA, u8 or u16 -> a PNG of
    that depth (non-interlaced, every row with the Sub filter, zlib as
    PNG_LEVEL and PNG_STRATEGY say)."""
    if hwc.ndim == 2:
        hwc = hwc[..., None]
    h, w, c = hwc.shape
    if c not in (1, 3, 4) or hwc.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png_bytes expects (H, W) or (H, W, 3 or 4) u8 or u16, got "
                         f"{hwc.dtype} {hwc.shape}")
    depth = 8 * hwc.dtype.itemsize
    rows = np.ascontiguousarray(hwc, dtype=">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, w * c * depth // 8)
    bpp = c * depth // 8
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 1  # Sub: each byte minus the byte one pixel to its left
    filtered[:, 1:bpp + 1] = rows[:, :bpp]
    np.subtract(rows[:, bpp:], rows[:, :-bpp], out=filtered[:, bpp + 1:])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    z = zlib.compressobj(PNG_LEVEL, zlib.DEFLATED, 15, 9, PNG_STRATEGY)
    idat = z.compress(filtered) + z.flush()
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", idat)
            + _png_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (row_bytes + 1):
        raise ValueError("truncated PNG image data")
    rows = data[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    out = np.zeros((h + 1, row_bytes + bpp), np.int32)  # a zero row above, zero bytes left
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        prior = out[y, bpp:]
        cur = out[y + 1]
        if ftype == 0:
            cur[bpp:] = line
        elif ftype == 2:
            cur[bpp:] = (line + prior) & 0xFF
        elif ftype == 1:  # each byte lane a running sum
            lanes = line.reshape(-1, bpp) if row_bytes % bpp == 0 else None
            cur[bpp:] = (np.cumsum(lanes, axis=0).reshape(-1) & 0xFF) if lanes is not None \
                else line
        elif ftype in (3, 4):
            up_left = out[y]
            for x in range(row_bytes):
                a, b, c = cur[x], prior[x], up_left[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[bpp + x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return out[1:, bpp:].astype(np.uint8)


# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# the bit depths each colour type allows (PNG spec 11.2.2)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# PIL's scale of a 1-, 2- or 4-bit grey sample to 8 bits
_GREY_SCALE = {1: 255, 2: 85, 4: 17}


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, row bytes) -> (h, w, channels) samples: u16 from
    big-endian pairs for 16-bit, u8 otherwise, sub-byte samples MSB first."""
    h, n = rows.shape[0], w * channels
    if depth == 16:
        pairs = rows[:, :2 * n].reshape(h, n, 2).astype(np.uint16)
        return ((pairs[..., 0] << 8) | pairs[..., 1]).reshape(h, w, channels)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
    return rows[:, :n].reshape(h, w, channels)


def _decode_png(data: bytes) -> tuple[np.ndarray, int, int, np.ndarray | None]:
    """A PNG -> ((H, W, C) samples as stored, colour type, bit depth,
    palette or None), interlaced or not. Raises ValueError on data that is
    not a valid PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, palette, head = 8, [], None, None
    while pos + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        ctype, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad PNG IHDR")
            head = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if len(body) % 3:
                raise ValueError("bad PNG palette")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + ln
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = head
    if (ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace not in (0, 1)
            or w == 0 or h == 0):
        raise ValueError(f"bad PNG header: colour type {ctype}, depth {depth}, "
                         f"interlace {interlace}, {w}x{h}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"bad PNG image data: {e}") from e
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)

    def pass_samples(pw: int, ph: int, at: int) -> tuple[np.ndarray, int]:
        row_bytes = (pw * channels * depth + 7) // 8
        rows = _unfilter(raw[at:], ph, row_bytes, bpp)
        return _samples(rows, pw, channels, depth), at + ph * (row_bytes + 1)

    if not interlace:
        px, _ = pass_samples(w, h, 0)
    else:
        px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:  # an empty pass has no bytes, not even filter bytes
                px[y0::dy, x0::dx], at = pass_samples(pw, ph, at)
    return px, ctype, depth, palette


def _grey8(grey: np.ndarray, depth: int) -> np.ndarray:
    """Grey samples as PIL opens them, then to 8 bits: 1/2/4-bit scaled to
    0..255, 16-bit ("I;16") clamped to 255 by convert("L") / ("RGB")."""
    if depth == 16:
        return np.minimum(grey, 255).astype(np.uint8)
    return (grey * _GREY_SCALE[depth]).astype(np.uint8) if depth < 8 else grey


def _rgb8(data: bytes) -> tuple[np.ndarray, bool]:
    """(samples as PIL's 8-bit modes hold them, grey?): grey (H, W) or
    (H, W, 3) colour; 16-bit colour and grey-with-alpha keep their high
    byte, palette indices look up PLTE (padded with black to 256)."""
    px, ctype, depth, palette = _decode_png(data)
    if ctype == 0:
        return _grey8(px[..., 0], depth), True
    if ctype == 4:
        g = px[..., 0]
        return (g >> 8).astype(np.uint8) if depth == 16 else g, True
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        return lut[px[..., 0]], False
    rgb = px[..., :3]
    return ((rgb >> 8).astype(np.uint8) if depth == 16 else rgb), False


def decode_png_rgb(data: bytes) -> np.ndarray:
    """A PNG -> (H, W, 3) uint8, as PIL's `Image.open(...).convert("RGB")`
    gives it: grey replicated, palette looked up, alpha dropped."""
    px, grey = _rgb8(data)
    return np.repeat(px[..., None], 3, axis=2) if grey else np.ascontiguousarray(px)


def decode_png_gray(data: bytes) -> np.ndarray:
    """A PNG -> (H, W) uint8, as PIL's `convert("L")` gives it: grey as
    stored, colour through PIL's fixed-point ITU-R 601 luma."""
    px, grey = _rgb8(data)
    return np.ascontiguousarray(px) if grey else rgb_to_l(px)


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of (H, W, 3) u8: ITU-R 601 luma in 16-bit fixed
    point."""
    px = rgb.astype(np.uint32)
    return ((px[..., 0] * 19595 + px[..., 1] * 38470 + px[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _cmyk_table() -> np.ndarray:
    """(256 * 256,) u8: Convert.c cmyk2rgb's channel of (c, k), indexed
    c * 256 + k: (255 - k) - c * (255 - k) / 255, the division MULDIV255's."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    nk = 255 - k
    t = c * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8).reshape(-1)


_CMYK_TABLE = _cmyk_table()


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of (..., 4) CMYK u8 (Convert.c cmyk2rgb)."""
    k = cmyk[..., 3:4].astype(np.uint16)
    return _CMYK_TABLE[(cmyk[..., :3].astype(np.uint16) << 8) | k]


def decode_png_u16(data: bytes) -> np.ndarray | None:
    """(H, W, 3) u16 of a 16-bit PNG as the JAX package's `_load_deep_u16`
    reads it through cv2's IMREAD_UNCHANGED: grey stacked to three
    channels, colour (and grey with alpha, which cv2 gives as BGRA) to RGB,
    alpha dropped. None where that returns None: byte 24 (the IHDR bit
    depth) is not 16, or the file does not decode."""
    if len(data) < 26 or data[24] != 16:
        return None
    try:
        px, ctype, depth, _ = _decode_png(data)
    except ValueError:
        return None
    if depth != 16:
        return None
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _png_trns(data: bytes) -> bytes | None:
    """The tRNS chunk's payload, if the PNG has one before its IDAT."""
    pos = 8
    while pos + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        if ctype == b"tRNS":
            return bytes(data[pos + 8:pos + 8 + ln])
        if ctype in (b"IDAT", b"IEND"):
            return None
        pos += 12 + ln
    return None


def decode_png_rgba(data: bytes) -> np.ndarray:
    """A PNG -> (H, W, 4) uint8, as PIL's `convert("RGBA")` gives it: grey
    and colour opaque except where an 8-bit tRNS colour key matches (alpha
    0), grey with alpha replicated, palette entries with their tRNS alpha
    (255 past its end), 16-bit samples at their high byte."""
    px, ctype, depth, palette = _decode_png(data)
    h, w = px.shape[:2]
    alpha = np.full((h, w), 255, np.uint8)
    trns = _png_trns(data)
    if ctype == 3:
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[:min(len(palette), 256), :3] = palette[:256]
        if trns:
            a = np.frombuffer(trns[:256], np.uint8)
            lut[:len(a), 3] = a
        return lut[px[..., 0]]
    if ctype in (4, 6):
        hi = (px >> 8).astype(np.uint8) if depth == 16 else px
        rgb = np.repeat(hi[..., :1], 3, axis=2) if ctype == 4 else hi[..., :3]
        return np.concatenate([rgb, hi[..., -1:]], axis=-1)
    if ctype == 0:
        if trns and len(trns) >= 2 and depth == 8:
            alpha[px[..., 0] == struct.unpack(">H", trns[:2])[0]] = 0
        rgb = np.repeat(_grey8(px[..., :1], depth), 3, axis=2)
    else:
        rgb = (px >> 8).astype(np.uint8) if depth == 16 else px
        if trns and len(trns) >= 6 and depth == 8:
            alpha[(px == np.array(struct.unpack(">HHH", trns[:6]))).all(axis=-1)] = 0
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def _write_deep(arr16: np.ndarray, path: Path, fmt: str) -> None:
    """Write (H, W, 3) u16 as a 16-bit TIFF or PNG."""
    if fmt in ("tif", "tiff"):
        write_tiff16(path, arr16)
    else:
        path.write_bytes(png_bytes(arr16))


def encode_image(
    planar: np.ndarray,
    path: str | Path,
    fmt: str | None = None,
    quality: int = 90,
) -> None:
    """Write planar (3, H, W) float [0,1] (or u8 / u16, planar or (H, W, 3))
    to disk."""
    from rapidraw_tpu_torch.io.loader import to_uint8_hwc

    path = Path(path)
    fmt = (fmt or path.suffix.lstrip(".")).lower()
    # PNG from a float render and TIFF (always) are 16-bit in the reference:
    # f32 sources encode as Rgb16 (export_processing.rs:446-462), and u8
    # sources upgrade x*257 for TIFF while PNG keeps them 8-bit
    deep = fmt in ("png", "tif", "tiff")

    if planar.ndim == 3 and planar.shape[0] == 3:
        hwc = planar.transpose(1, 2, 0)
    elif planar.ndim == 3 and planar.shape[-1] == 3:
        hwc = planar
    else:
        raise ValueError(f"unsupported image array shape {planar.shape}")

    if deep:
        arr16 = None
        if hwc.dtype == np.uint16:
            arr16 = hwc
        elif hwc.dtype != np.uint8:
            # image crate f32 -> u16: (x.clamp(0,1) * 65535).round()
            arr16 = np.floor(
                np.clip(hwc.astype(np.float32), 0.0, 1.0) * 65535.0 + 0.5
            ).astype(np.uint16)
        elif fmt != "png":
            # TIFF upgrades u8 sources too (to_rgb16 scales by 257);
            # PNG leaves u8 sources 8-bit (image.clone())
            arr16 = hwc.astype(np.uint16) * 257
        if arr16 is not None:
            _write_deep(arr16, path, fmt)
            return

    if hwc.dtype == np.uint8:
        arr = hwc
    elif hwc.dtype == np.uint16:
        arr = np.floor(hwc.astype(np.float32) / 257.0 + 0.5).astype(np.uint8)
    elif planar.ndim == 3 and planar.shape[0] == 3:
        arr = to_uint8_hwc(planar)
    else:
        # interleaved floats scale like the planar branch
        arr = (np.clip(hwc, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    arr = np.ascontiguousarray(arr)

    if fmt in ("jpg", "jpeg"):
        from rapidraw_tpu_torch import native

        path.write_bytes(native.jpeg_encode(arr, quality))
    elif fmt == "png":
        path.write_bytes(png_bytes(arr))
    elif fmt == "jxl":
        # lossless at q == 100, else distance (100 - q) / 10
        # (export_processing.rs:396-430), through the system libjxl
        from rapidraw_tpu_torch.io.jxl import available, encode_jxl

        if not available():
            raise ValueError("format 'jxl' not supported by this PIL build: "
                             "no libjxl found for rapidraw_tpu_torch.io.jxl")
        path.write_bytes(encode_jxl(arr, quality))
    elif fmt == "webp":
        from rapidraw_tpu_torch.io.webp import encode_webp

        path.write_bytes(encode_webp(arr, quality))
    elif fmt == "avif":
        # lossy at the quality, 100 at and above it (export_processing.rs:
        # 388-469), as the JAX package asks PIL
        from rapidraw_tpu_torch.io.avif import available, encode_avif

        if not available():
            raise ValueError("format 'avif' not supported by this PIL build: "
                             "no libavif found for rapidraw_tpu_torch.io.avif")
        try:
            data = encode_avif(arr, 100 if quality >= 100 else quality)
        except OSError as e:
            raise ValueError(f"format 'avif' not supported by this PIL build: {e}") from e
        path.write_bytes(data)
    else:
        raise ValueError(f"unsupported export format: {fmt}")


def encode_jpeg_bytes(planar: np.ndarray, quality: int = 85) -> bytes:
    """In-memory JPEG (the interactive preview reply path, lib.rs:560-582)."""
    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch.io.loader import to_uint8_hwc

    return native.jpeg_encode(np.ascontiguousarray(to_uint8_hwc(planar)), quality)
