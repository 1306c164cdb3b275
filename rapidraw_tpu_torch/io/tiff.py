"""The port's TIFF reader: the first frame of a TIFF as the JAX package's
loader reads it (PIL for 8-bit pixels, its own strip reader or cv2 for
16-bit RGB, `rapidraw_tpu/io/encode.py:54-95`).

PIL reads an uncompressed frame with its own raw decoder and every other
frame through libtiff; this reader follows each:

  * codecs: none, LZW (and the old LSB-first LZW libtiff still reads),
    PackBits and ThunderScan (csrc/host/tiff_codec.cc), Deflate (zlib),
    LZMA (Python's lzma), ZSTD (csrc/host/zstd_dec.cc: the first frame of
    each chunk, as tif_zstd.c's one ZSTD_decompressStream loop reads it),
    CCITT Modified Huffman, RLE-W, T.4 1-D and 2-D and T.6
    (csrc/host/ccitt_dec.cc) and JPEG (each strip or tile a JPEG stream
    after the JPEGTables, csrc/host/jpeg_dec.cc, Huffman- or
    arithmetic-coded, 8- or 12-bit: YCbCr converted to RGB as libtiff's
    JPEGCOLORMODE_RGB asks, any other photometric as stored); FillOrder 2;
    Predictor 2 at 8, 16 and 32 bits and 3 (floating point) after LZW,
    Deflate, LZMA and ZSTD; strips and tiles; chunky and planar samples;
  * samples: 1, 2, 4, 8, 12 (PIL's "I;12") and 16 bits, signed 8 and 16
    bits, 32-bit integer and floating point, as PIL's
    TiffImagePlugin.OPEN_INFO maps them to a mode
    (io/exif_tags.OPEN_MODES), in PIL's own unpacking, quirks kept: a
    big-endian compressed file's "I;16BS", "I;32BS" and "F;32BF" samples
    come back byte-swapped (libtiff hands PIL native order), an
    uncompressed planar file reads each plane with the one-letter raw mode
    of its layer (16-bit planes as bytes), a compressed planar file puts
    plane k in band k (an LA file's alpha plane is lost);
  * photometrics (`decode_tiff`'s mode): grey, palette, RGB, RGBA, LA,
    CMYK, CIELab ("LAB": L, and a and b signed, as PIL's LAB images give
    their bytes)
    and YCbCr (io/tiff_photometric.py: libtiff's RGBA interface for a
    compressed file, PIL's "RGBX" raw mode for an uncompressed one).

`decode_tiff_rgb` gives PIL's `Image.open(p).convert("RGB")` (Lab through
io/lab.py). `read_tiff16_rgb` gives the JAX package's full-depth 16-bit RGB
read: its uncompressed strip reader with its quirks (io/encode.py) and, for
a compressed file, what cv2's IMREAD_UNCHANGED gives (chunky 16-bit RGB).

The first directory is read by io/exif.py's `tiff_first_ifd`: a file whose
first frame PIL would not open raises `image_decode.Unidentified`, as
`Image.open` fails. What PIL's libtiff opens but cannot decode (WebP, which
it is built without; SGILog, which libtiff takes only under a LogLuv or
LogL photometric that PIL does not open) raises OSError as PIL does.
Old-style JPEG (compression 6) is io/tiff_photometric.py's `ojpeg`; the
layouts of it no file has needed yet raise NotImplementedError naming
ROADMAP A.10d-c. cv2's read of a compressed planar 16-bit RGB file, which
is not a function of the file's bytes, raises NotImplementedError naming
ROADMAP's Known differences.
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np

from rapidraw_tpu_torch.io.exif import tiff_first_ifd

NONE, CCITT_RLE, CCITT_T4, CCITT_T6, LZW, OJPEG, JPEG, ADOBE_DEFLATE = 1, 2, 3, 4, 5, 6, 7, 8
PACKBITS, DEFLATE, LZMA = 32773, 32946, 34925
CCITT_RLEW, THUNDERSCAN, SGILOG, SGILOG24, ZSTD, WEBP = 32771, 32809, 34676, 34677, 50000, 50001
_CODECS = {NONE, CCITT_RLE, CCITT_T4, CCITT_T6, LZW, JPEG, ADOBE_DEFLATE, PACKBITS, DEFLATE, LZMA,
           CCITT_RLEW, THUNDERSCAN, ZSTD}  # and OJPEG, which io/tiff_photometric.py reads
_CCITT = {CCITT_RLE, CCITT_T4, CCITT_T6, CCITT_RLEW}
# the codecs libtiff runs a predictor after
_PREDICTED = {LZW, ADOBE_DEFLATE, DEFLATE, LZMA, ZSTD}
# the codecs cv2 5.0's libtiff reads a 16-bit RGB frame with (no ZSTD, WebP or
# old-style JPEG; CCITT, ThunderScan and SGILog fail at 16 bits)
_CV2_CODECS = {LZW, ADOBE_DEFLATE, DEFLATE, PACKBITS}
# PIL's raw modes that libtiff's native-order samples are read with unrenamed
_SWAPPED = {"I;16BS", "I;32BS", "F;32BF"}
REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _codec():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("tiff_codec")
    if not getattr(lib, "_rr_typed", False):
        for fn in (lib.tiff_lzw_decode, lib.tiff_lzw_decode_compat, lib.tiff_packbits_decode):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        lib.tiff_thunder_decode.restype = ctypes.c_int
        lib.tiff_thunder_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_int]
        lib._rr_typed = True
    return lib


def _ccitt():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("ccitt_dec")
    if not getattr(lib, "_rr_typed", False):
        lib.ccitt_decode.restype = ctypes.c_int
        lib.ccitt_decode.argtypes = [ctypes.c_char_p, ctypes.c_long] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_long]
        lib._rr_typed = True
    return lib


def _zstd():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("zstd_dec")
    if not getattr(lib, "_rr_typed", False):
        lib.zstd_decode_first.restype = ctypes.c_long
        lib.zstd_decode_first.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                          ctypes.c_long]
        lib._rr_typed = True
    return lib


def _tuple(v) -> tuple:
    if v is None:
        return ()
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def _decompress(chunk: bytes, compression: int, size: int, width: int = 0, rows: int = 0,
                t4options: int = 0, offset: int = 0) -> np.ndarray:
    """One strip or tile -> `size` bytes (short data raises OSError); a
    CCITT chunk -> `rows` packed rows of `width` pixels (`offset`: where the
    chunk lies in the file, which RLE-W aligns its rows to), a ThunderScan
    one -> `rows` rows of `width` 4-bit pixels."""
    if compression == NONE:
        out = np.frombuffer(chunk[:size], np.uint8)
    elif compression in (DEFLATE, ADOBE_DEFLATE):
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(chunk, size), np.uint8)
        except zlib.error as e:
            raise OSError(f"bad Deflate data in TIFF: {e}") from e
    elif compression == LZMA:
        import lzma

        try:
            out = np.frombuffer(lzma.LZMADecompressor().decompress(chunk, size), np.uint8)
        except lzma.LZMAError as e:
            raise OSError(f"bad LZMA data in TIFF: {e}") from e
    elif compression == ZSTD:
        out = np.empty(size, np.uint8)
        n = _zstd().zstd_decode_first(chunk, len(chunk), out.ctypes.data, size)
        if n < 0:
            raise OSError(f"Error in ZSTD_decompressStream() (code {n})")
        if n < size:  # libtiff: "Not enough data"
            raise OSError("image file is truncated (ZSTD strip or tile too short)")
    elif compression in _CCITT:
        out = np.empty(size, np.uint8)
        rc = _ccitt().ccitt_decode(chunk, len(chunk), width, rows, compression, t4options,
                                   out.ctypes.data, offset)
        if rc < 0:
            raise OSError(f"corrupt CCITT data in TIFF (code {rc})")
    elif compression == THUNDERSCAN:
        out = np.zeros(size, np.uint8)
        if _codec().tiff_thunder_decode(chunk, len(chunk), out.ctypes.data, width, rows):
            raise OSError("ThunderScan data gives too many or too few pixels in a row")
    else:
        buf = np.empty(size, np.uint8)
        lib = _codec()
        if compression == LZW:
            # libtiff's LZWPreDecode: a strip that opens with an LSB-first
            # Clear code is old-style LZW
            old = len(chunk) > 1 and chunk[0] == 0 and chunk[1] & 1
            fn = lib.tiff_lzw_decode_compat if old else lib.tiff_lzw_decode
        else:
            fn = lib.tiff_packbits_decode
        n = fn(chunk, len(chunk), buf.ctypes.data, size)
        if n < 0:
            raise OSError("corrupt LZW data in TIFF")
        out = buf[:n]
    if out.size < size:
        raise OSError("image file is truncated (TIFF strip or tile too short)")
    return out


def check_codec(f: "Frame") -> None:
    """What libtiff refuses before it decodes a strip or tile (PIL then
    raises OSError): codecs PIL's libtiff has no decoder for or that need
    other samples, predictors the samples cannot take."""
    c, bits = f.compression, f.bits
    if c == WEBP:
        raise OSError("WEBP compression support is not configured")
    if c in (SGILOG, SGILOG24):  # PIL opens these with no LogLuv or LogL photometric
        raise OSError(f"Inappropriate photometric interpretation {f.photo} for SGILog "
                      "compression")
    if c not in _CODECS:
        raise OSError(f"TIFF compression {c} is not supported")
    if c in _CCITT and bits != 1:
        raise OSError("Bits/sample must be 1 for Group 3/4 encoding/decoding")
    if c == THUNDERSCAN and bits != 4:
        raise OSError("Thunder decoder only supports 4 bits per sample")
    if c == THUNDERSCAN and 322 in f.tags and 324 in f.tags:
        raise OSError("ThunderScan tiles are not supported")
    if c in _PREDICTED:
        if f.predictor not in (1, 2, 3):
            raise OSError(f"Predictor {f.predictor} is not supported")
        if f.predictor == 2 and bits not in (8, 16, 32):
            raise OSError(f"horizontal differencing is not supported with {bits}-bit "
                          "samples")
        if f.predictor == 3 and f.sample_format[0] != 3:
            raise OSError("floating point predictor needs floating point samples")


class Frame:
    """The first frame's layout, from its directory, and PIL's mode and
    raw mode for it."""

    def __init__(self, data):
        from rapidraw_tpu_torch.io.exif_tags import OPEN_MODES

        try:
            found = tiff_first_ifd(data)
        except ValueError as e:
            from rapidraw_tpu_torch.io.image_decode import Unidentified

            raise Unidentified(str(e)) from e
        if found is None:
            raise ValueError("not a TIFF file")
        self.endian, t = found
        self.tags = t
        self.width, self.height = int(t[256]), int(t[257])
        self.compression = int(t.get(259, 1))
        self.photo = 6 if self.compression == 6 else int(t.get(262, 0))
        self.spp = int(t.get(277, 3 if self.compression == 6 and self.photo in (2, 6) else 1))
        bps = _tuple(t.get(258, (1,)))
        if self.spp < len(bps):
            bps = bps[:self.spp]
        elif self.spp > len(bps) and len(bps) == 1:
            bps = bps * self.spp
        self.bps = bps
        self.extra = _tuple(t.get(338))
        self.planar = int(t.get(284, 1))
        self.predictor = int(t.get(317, 1))
        self.fill_order = int(t.get(266, 1))
        sf = _tuple(t.get(339, (1,)))
        if len(sf) > 1 and max(sf) == min(sf) == 1:
            sf = (1,)
        self.sample_format = sf
        fill = self.fill_order if self.compression == NONE else 1
        key = (b"II" if self.endian == "<" else b"MM", self.photo, sf, fill, bps, self.extra)
        self.mode, self.rawmode = OPEN_MODES[key]
        if self.compression != NONE and self.rawmode.endswith((";16B", ";16L")):
            self.rawmode = self.rawmode[:-1] + "N"  # libtiff hands PIL native order
        self.sub = tuple(int(v) for v in _tuple(t.get(530, (2, 2))))[:2]
        self._jpeg_sub = None  # a JPEG frame's YCbCr sampling, from its first chunk

    @property
    def bits(self) -> int:
        return self.bps[0]

    def chunks(self):
        """(plane, y0, x0, rows decoded, rows kept, chunk width, offset,
        byte count) of every strip or tile, plane by plane."""
        t, w, h = self.tags, self.width, self.height
        planes = self.spp if self.planar == 2 else 1
        if 322 in t and 324 in t:
            tw, tl = int(t[322]), int(t[323])
            offsets, counts = _tuple(t[324]), _tuple(t.get(325))
            across, down = -(-w // tw), -(-h // tl)
        else:
            rps = min(int(t.get(278, h)), h) or h
            offsets, counts = _tuple(t.get(273)), _tuple(t.get(279))
            tw, tl, across, down = w, rps, 1, -(-h // rps)
        tiled = 322 in t and 324 in t
        if len(offsets) < planes * across * down:
            raise OSError("TIFF has fewer strips or tiles than its size needs")
        if len(counts) < len(offsets):
            counts = counts + (1 << 62,) * (len(offsets) - len(counts))
        out, k = [], 0
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    y0, x0 = ty * tl, tx * tw
                    rows = tl if tiled else min(tl, h - y0)
                    out.append((p, y0, x0, rows, min(rows, h - y0), tw, int(offsets[k]),
                                int(counts[k])))
                    k += 1
        return out

    def samples(self, data) -> np.ndarray:
        """(H, W, spp) samples as libtiff hands them to PIL (or, for an
        uncompressed chunky frame, as stored): u8 for up to 8 bits (sub-byte
        samples unpacked MSB first), native 16- and 32-bit integers and
        floats as the sample format says; a JPEG frame's components as its
        colour mode gives them."""
        bits = self.bits
        if len(set(self.bps)) != 1 or bits not in (1, 2, 4, 8, 12, 16, 32):
            raise OSError(f"TIFF samples of {self.bps} bits")
        check_codec(self)
        if self.compression == JPEG and bits not in (8, 12):
            raise OSError(f"JPEG-compressed TIFF of {bits}-bit samples")
        planes = self.spp if self.planar == 2 else 1
        per = 1 if self.planar == 2 else self.spp
        if self.compression == JPEG:
            dtype = np.uint16 if bits == 12 else np.uint8
        elif bits == 32:
            dtype = {1: np.uint32, 2: np.int32, 3: np.float32}.get(self.sample_format[0],
                                                                   np.uint32)
        elif bits == 16:
            dtype = np.int16 if self.sample_format[0] == 2 else np.uint16
        elif bits == 12:
            dtype = np.uint16
        else:
            dtype = np.uint8
        out = np.empty((planes, self.height, self.width, per), dtype)
        for p, y0, x0, rows, keep, tw, off, cnt in self.chunks():
            chunk = bytes(data[off:off + cnt])
            if self.fill_order == 2 and self.compression != JPEG:  # JPEG: TIFF_NOBITREV
                chunk = REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
            if self.compression == JPEG:
                block = self._jpeg_chunk(chunk, rows, tw, per)
            else:
                row_bytes = (tw * per * bits + 7) // 8
                raw = _decompress(chunk, self.compression, rows * row_bytes, tw, rows,
                                  int(self.tags.get(292, 0)), off)
                block = self._unpack(raw, rows, row_bytes, tw, per, bits, dtype)
            nx = min(tw, self.width - x0)
            out[p, y0:y0 + keep, x0:x0 + nx] = block[:keep, :nx]
        if planes > 1:
            return np.ascontiguousarray(out[..., 0].transpose(1, 2, 0))
        return out[0]

    def _jpeg_chunk(self, chunk: bytes, rows: int, tw: int, per: int) -> np.ndarray:
        """One JPEG strip or tile, after the JPEGTables (tag 347), colour as
        libtiff's JPEGPreDecode asks for it."""
        from rapidraw_tpu_torch.io import jpeg

        tables = self.tags.get(347)
        if isinstance(tables, (bytes, bytearray)) and len(tables) > 4 and chunk[:2] == b"\xff\xd8":
            tables = bytes(tables)
            end = tables.rfind(b"\xff\xd9")
            chunk = (tables[:end] if end > 0 else tables) + chunk[2:]
        rgb = self.photo == 6 and self.planar == 1
        # JPEGPreDecode: the first component sampled as YCbCrSubsampling
        # says (which JPEGFixupTags sets from the first strip or tile),
        # every other component, and any component of another photometric
        # or plane, 1x1
        factors = jpeg.sampling_factors(chunk)
        if rgb:
            if self._jpeg_sub is None:
                self._jpeg_sub = factors[0]
            bad = factors[0] != self._jpeg_sub or any(f != (1, 1) for f in factors[1:])
        else:
            bad = any(f != (1, 1) for f in factors)
        if bad:
            raise OSError("improper JPEG sampling factors in a JPEG-compressed TIFF")
        if jpeg.frame_info(chunk, pil=False)[3] != self.bits:
            raise OSError("Improper JPEG data precision")
        px = jpeg.jpeg_components(chunk, jpeg.YCBCR if rgb else jpeg.RAW, pil=False)
        px = px.reshape(px.shape[0], px.shape[1], -1)
        if px.shape[2] != per:
            raise OSError("JPEG strip or tile with the wrong number of components")
        if px.shape[0] > rows or px.shape[1] > tw:
            raise OSError("JPEG strip or tile size exceeds expected dimensions")
        if self.bits == 12 and px.shape[1] * px.shape[2] % 2:
            # tif_jpeg.c packs 12-bit samples in pairs and never writes the
            # last sample of an odd row (PIL reads whatever its buffer held)
            px = px.copy()
            px[:, -1, -1] = 0
        if px.shape[:2] != (rows, tw):  # libtiff warns and leaves the rest
            full = np.zeros((rows, tw, per), px.dtype)
            full[:px.shape[0], :px.shape[1]] = px
            px = full
        return px

    def _unpack(self, raw, rows, row_bytes, tw, per, bits, dtype) -> np.ndarray:
        rowsb = raw[:rows * row_bytes].reshape(rows, row_bytes)
        predict = self.predictor if self.compression in _PREDICTED else 1
        if predict == 3:
            return _float_predictor(rowsb, tw, per, bits, dtype)
        if bits >= 16:
            file_dt = np.dtype(dtype).newbyteorder(self.endian)
            px = rowsb.view(file_dt).astype(dtype).reshape(rows, tw, per)
        elif bits == 12:  # PIL's "I;12": pairs of samples in three bytes, MSB first
            b = np.zeros((rows, 3 * (-(-tw * per // 2))), np.uint16)
            b[:, :row_bytes] = rowsb
            hi = (b[:, 0::3] << 4) | (b[:, 1::3] >> 4)
            lo = ((b[:, 1::3] & 15) << 8) | b[:, 2::3]
            px = np.stack([hi, lo], -1).reshape(rows, -1)[:, :tw * per].reshape(rows, tw, per)
        elif bits == 8:
            px = rowsb.reshape(rows, tw, per)
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            px = ((rowsb[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
            px = px[:, :tw * per].reshape(rows, tw, per)
        if predict == 2:  # sums modulo 2^bits, as the samples' own type wraps
            udt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
            px = np.cumsum(px.view(udt), axis=1, dtype=udt).view(px.dtype)
        return px


def _float_predictor(rowsb: np.ndarray, tw: int, per: int, bits: int, dtype) -> np.ndarray:
    """libtiff's fpAcc: each row's bytes summed with a stride of `per`, then
    its byte planes (most significant first) gathered into native values."""
    rows, n = rowsb.shape[0], tw * per
    nb = bits // 8
    b = rowsb[:, :n * nb].reshape(rows, n * nb // per, per)
    b = np.cumsum(b, axis=1, dtype=np.uint8).reshape(rows, nb, n)  # sums modulo 256
    return np.ascontiguousarray(b[:, ::-1].transpose(0, 2, 1)).view(dtype).reshape(rows, tw, per)


def _premultiplied_to_straight(rgba: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacker: c * 255 // a clipped to 255, 0 where a = 0."""
    a = rgba[..., 3:4].astype(np.int32)
    c = rgba[..., :3].astype(np.int32)
    straight = np.minimum(c * 255 // np.maximum(a, 1), 255)
    straight = np.where(a == 255, c, np.where(a == 0, 0, straight))
    return np.concatenate([straight, a], axis=-1).astype(np.uint8)


_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}
# the bands of PIL's modes, for a compressed planar frame's planes
_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1, "I;16B": 1, "LA": 2, "PA": 2,
          "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def decode_tiff(data) -> tuple[np.ndarray, str]:
    """The first frame as PIL holds it once loaded: (the samples, the mode),
    the mode one of "1" (given as 0 and 255), "L", "I;16" and "I;16B" (u16),
    "LA", "P" given through its palette as "RGB", "RGB", "RGBA", "CMYK",
    "LAB", "I" (int32) or "F" (float32). PIL's TIFF reader
    turns the pixels by their EXIF orientation as it loads them
    (ImageOps.exif_transpose in TiffImageFile.load_end), so this does too."""
    from rapidraw_tpu_torch.io.exif import image_orientation
    from rapidraw_tpu_torch.io.loader import _apply_exif_orientation

    px, mode = _decode_tiff(data)
    return np.ascontiguousarray(_apply_exif_orientation(px, image_orientation(data))), mode


def _decode_tiff(data) -> tuple[np.ndarray, str]:
    from rapidraw_tpu_torch.io import tiff_photometric as photometric

    f = Frame(data)
    if f.compression == OJPEG:
        return photometric.ojpeg(f, data)
    if f.compression != NONE:
        check_codec(f)
    if f.photo == 6 and f.spp != 3 and f.compression != NONE:
        raise OSError("libtiff reads YCbCr only with three samples")
    if f.photo == 6 and f.mode == "RGB" and not (f.compression == JPEG and f.planar == 1):
        return photometric.ycbcr_rgb(f, data), "RGB"
    if f.planar == 2 and f.spp > 1 and f.compression == NONE:
        return photometric.raw_planar(f, data)
    px = f.samples(data)
    if f.compression != NONE and f.rawmode in _SWAPPED:
        px = px.byteswap()  # PIL reads libtiff's native order with a big-endian raw mode
    if f.planar == 2 and f.spp > 1:
        px = _planes_in_bands(f, px)
    return _pil_mode(f, px)


def _planes_in_bands(f: Frame, px: np.ndarray) -> np.ndarray:
    """PIL's libtiff decoder puts plane k of a planar frame in band k of
    the image: more planes than the mode has bands is an error in strips
    (tiles read the mode's bands alone), and an LA image's alpha plane
    lands in a byte its mode does not show."""
    if f.spp > _BANDS.get(f.mode, 1) and not (322 in f.tags and 324 in f.tags):
        raise OSError("decoder error -2")
    if f.mode == "LA":
        px = px.copy()
        px[..., 1] = 0
    return px


def _pil_mode(f: Frame, px: np.ndarray) -> tuple[np.ndarray, str]:
    """Samples as PIL's raw mode unpacks them -> (pixels, mode)."""
    photo, bits, mode, raw = f.photo, f.bits, f.mode, f.rawmode
    if mode in ("1", "L", "I;16", "I;16B"):
        g = px[..., 0]
        if bits in (12, 16):  # "I;16" for both zero senses; convert() clamps to 8 bits
            return g.astype(np.uint16), mode
        g8 = (g * _GREY_SCALE[bits]).astype(np.uint8)
        if photo == 0:  # the "I" raw modes: zero is white
            g8 = 255 - g8
        return g8, mode
    if mode in ("I", "F"):
        return px[..., 0].astype(np.int32 if mode == "I" else np.float32), mode
    if mode == "LA":
        return px[..., :2].astype(np.uint8), "LA"
    if mode in ("RGB", "RGBA", "CMYK"):
        n = {"RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
        px8 = (px[..., :n] >> 8).astype(np.uint8) if bits == 16 else px[..., :n]
        # associated alpha; a compressed planar file is read so unless its
        # ExtraSamples says unassociated
        assoc = f.extra[:1] == (1,) or (f.planar == 2 and f.compression != NONE
                                        and f.extra[:1] != (2,))
        if mode == "RGBA" and assoc:
            return _premultiplied_to_straight(px8), "RGBA"
        return np.ascontiguousarray(px8), mode
    if mode == "LAB":
        lab = np.ascontiguousarray(px[..., :3])
        if f.planar == 2:
            # the planes go through PIL's one-band "A" and "B" unpackers,
            # which do not make a and b signed as its "LAB" unpacker does
            lab = lab.copy()
            lab[..., 1:] ^= 128
        return lab, "LAB"
    if mode == "P" and f.spp == 1:
        cmap = np.asarray(_tuple(f.tags.get(320)), np.int64)
        n = 1 << bits
        if cmap.size != 3 * n:
            raise OSError("TIFF palette image without a valid ColorMap")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = (cmap.reshape(3, n).T // 256).astype(np.uint8)
        return pal[px[..., 0]], "RGB"
    raise OSError(f"TIFF mode {mode} (raw mode {raw}) that PIL's decoder cannot unpack")


def decode_tiff_rgb(data) -> np.ndarray:
    """(H, W, 3) u8 as PIL's convert("RGB") gives the first frame."""
    from rapidraw_tpu_torch.io.image_decode import Frame as Image

    px, mode = decode_tiff(data)
    return Image(mode, px).convert("RGB")


def read_tiff16_rgb(data) -> np.ndarray | None:
    """(H, W, 3) u16 of a 16-bit RGB TIFF, or None where the JAX package's
    read_tiff16_rgb returns None (then its loader reads 8 bits through
    PIL). Uncompressed: its own strip reader, quirks kept (a big-endian
    file comes back as a '>u2' array, planar samples read as interleaved).
    Compressed: what cv2's IMREAD_UNCHANGED gives, chunky 16-bit RGB."""
    f = Frame(data)
    bits = f.tags.get(258)
    bits = _tuple(bits)[0] if _tuple(bits) else 0
    if bits != 16 or f.tags.get(277, 3) != 3:
        return None
    if f.compression == NONE:
        offsets, counts = _tuple(f.tags.get(273)), _tuple(f.tags.get(279))
        raw = b"".join(bytes(data[int(o):int(o) + int(c)]) for o, c in zip(offsets, counts))
        if len(raw) != f.height * f.width * 6:
            return None
        return np.frombuffer(raw, f.endian + "u2").reshape(f.height, f.width, 3)
    if f.photo != 2 or f.compression not in _CV2_CODECS or f.predictor not in (1, 2):
        return None
    if f.planar == 2:
        # cv2 reads each plane's strip into a chunky strip buffer and leaves
        # the rest of the buffer as it was: reads of one file differ
        raise NotImplementedError(
            "rapidraw_tpu_torch does not read a compressed planar 16-bit RGB TIFF as cv2 "
            "does: cv2's read is not a function of the file's bytes (ROADMAP Known "
            "differences, cv2 planar reads)")
    # cv2 turns the pixels by IFD0's Orientation 2-4 and fails to read the
    # file at 5-8 (None: the JAX package then reads it through PIL)
    orientation = f.tags.get(274, 1)
    if orientation in (5, 6, 7, 8):
        return None
    arr = f.samples(data)
    if orientation in (2, 3, 4):
        from rapidraw_tpu_torch.io.loader import _apply_exif_orientation

        arr = np.ascontiguousarray(_apply_exif_orientation(arr, orientation))
    return arr
