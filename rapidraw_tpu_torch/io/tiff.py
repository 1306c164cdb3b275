"""The port's TIFF reader: the first frame of a TIFF as the JAX package's
loader reads it (PIL for 8-bit pixels, its own strip reader or cv2 for
16-bit RGB, `rapidraw_tpu/io/encode.py:54-95`).

  * Compression none, LZW and PackBits (csrc/host/tiff_codec.cc) and
    Deflate (zlib); Predictor 2 (horizontal differencing) at 8 and 16
    bits; strips and tiles; chunky and planar samples.
  * `decode_tiff_rgb` gives PIL's `Image.open(p).convert("RGB")`: RGB,
    RGBA (associated alpha un-premultiplied as PIL's "RGBa" unpacker does),
    grey with black or white zero at 1, 2, 4 and 8 bits, 16-bit grey
    clamped to 255 (PIL's "I;16" -> "RGB"), grey with alpha, palette
    (ColorMap >> 8) and 16-bit colour at its high byte.
  * `read_tiff16_rgb` gives the JAX package's full-depth 16-bit RGB read:
    its uncompressed strip reader with its quirks (io/encode.py) and, for a
    compressed file, what cv2's IMREAD_UNCHANGED gives (chunky 16-bit RGB).

The first directory is read by io/exif.py's `tiff_first_ifd`, which
refuses a file whose first frame PIL would not open. Layouts PIL opens but
this reader does not decode (CCITT, JPEG-in-TIFF, CMYK, YCbCr, Lab, float
samples, FillOrder 2, old-style LZW) raise NotImplementedError naming
ROADMAP A.10c.
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np

from rapidraw_tpu_torch.io.exif import tiff_first_ifd

NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 32946, 8, 32773
_CODECS = {NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS}


def _deferred(what: str) -> NotImplementedError:
    return NotImplementedError(f"rapidraw_tpu_torch does not decode {what} yet (ROADMAP A.10c)")


def _codec():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("tiff_codec")
    if not getattr(lib, "_rr_typed", False):
        for fn in (lib.tiff_lzw_decode, lib.tiff_packbits_decode):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        lib._rr_typed = True
    return lib


def _tuple(v) -> tuple:
    if v is None:
        return ()
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def _decompress(chunk: bytes, compression: int, size: int) -> np.ndarray:
    """One strip or tile -> `size` bytes (short data raises OSError)."""
    if compression == NONE:
        out = np.frombuffer(chunk[:size], np.uint8)
    elif compression in (DEFLATE, ADOBE_DEFLATE):
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(chunk, size), np.uint8)
        except zlib.error as e:
            raise OSError(f"bad Deflate data in TIFF: {e}") from e
    else:
        if compression == LZW and len(chunk) > 1 and chunk[0] == 0 and chunk[1] & 1:
            raise _deferred("old-style (LSB-first) LZW TIFF")
        buf = np.empty(size, np.uint8)
        fn = _codec().tiff_lzw_decode if compression == LZW else _codec().tiff_packbits_decode
        n = fn(chunk, len(chunk), buf.ctypes.data, size)
        if n < 0:
            raise OSError("corrupt LZW data in TIFF")
        out = buf[:n]
    if out.size < size:
        raise OSError("image file is truncated (TIFF strip or tile too short)")
    return out


class Frame:
    """The first frame's layout, from its directory."""

    def __init__(self, data):
        found = tiff_first_ifd(data)
        if found is None:
            raise ValueError("not a TIFF file")
        self.endian, t = found
        self.tags = t
        self.width, self.height = int(t[256]), int(t[257])
        self.compression = int(t.get(259, 1))
        self.photo = int(t.get(262, 0))
        self.spp = int(t.get(277, 1))
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
        self.sample_format = _tuple(t.get(339, (1,)))

    def samples(self, data) -> np.ndarray:
        """(H, W, spp) samples as stored: u8 for up to 8 bits (sub-byte
        samples unpacked MSB first), native u16 for 16 bits."""
        bits = self.bps[0]
        if len(set(self.bps)) != 1 or bits not in (1, 2, 4, 8, 16):
            raise _deferred(f"TIFF samples of {self.bps} bits")
        if self.compression not in _CODECS:
            raise _deferred(f"TIFF compression {self.compression}")
        if self.fill_order != 1:
            raise _deferred("TIFF FillOrder 2")
        if any(f != 1 for f in self.sample_format):
            raise _deferred("TIFF float or signed samples")
        if self.predictor not in (1, 2) or (self.predictor == 2 and bits < 8
                                             and self.compression in (LZW, DEFLATE, ADOBE_DEFLATE)):
            raise _deferred(f"TIFF predictor {self.predictor} at {bits} bits")
        if self.planar == 2 and self.spp > 1 and not (
                self.spp == 3 and (bits == 8 or self.compression != NONE)):
            raise _deferred(f"planar TIFF with {self.spp} samples of {bits} bits")
        t, w, h = self.tags, self.width, self.height
        planes = self.spp if self.planar == 2 else 1
        per = 1 if self.planar == 2 else self.spp  # samples per pixel in one plane
        tiled = 322 in t and 324 in t
        if tiled:
            tw, tl = int(t[322]), int(t[323])
            offsets, counts = _tuple(t[324]), _tuple(t.get(325))
            across, down = -(-w // tw), -(-h // tl)
        else:
            rps = min(int(t.get(278, h)), h) or h
            offsets, counts = _tuple(t.get(273)), _tuple(t.get(279))
            tw, tl, across, down = w, rps, 1, -(-h // rps)
        if len(offsets) < planes * across * down:
            raise OSError("TIFF has fewer strips or tiles than its size needs")
        if len(counts) < len(offsets):
            counts = counts + (len(data),) * (len(offsets) - len(counts))
        row_bytes = (tw * per * bits + 7) // 8
        dt = np.dtype(self.endian + "u2") if bits == 16 else np.dtype(np.uint8)
        out = np.empty((planes, h, w, per), np.uint16 if bits == 16 else np.uint8)
        k = 0
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    off, cnt = int(offsets[k]), int(counts[k])
                    k += 1
                    y0, x0 = ty * tl, tx * tw
                    rows = tl if tiled else min(tl, h - y0)
                    raw = _decompress(bytes(data[off:off + cnt]), self.compression,
                                      rows * row_bytes)
                    block = self._unpack(raw, rows, row_bytes, tw, per, bits, dt)
                    ny, nx = min(rows, h - y0), min(tw, w - x0)
                    out[p, y0:y0 + ny, x0:x0 + nx] = block[:ny, :nx]
        if planes > 1:
            return np.ascontiguousarray(out[..., 0].transpose(1, 2, 0))
        return out[0]

    def _unpack(self, raw, rows, row_bytes, tw, per, bits, dt) -> np.ndarray:
        rowsb = raw[:rows * row_bytes].reshape(rows, row_bytes)
        if bits == 16:
            px = rowsb.view(dt).astype(np.uint16).reshape(rows, tw, per)
        elif bits == 8:
            px = rowsb.reshape(rows, tw, per)
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            px = ((rowsb[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
            px = px[:, :tw * per].reshape(rows, tw, per)
        if self.predictor == 2 and self.compression in (LZW, DEFLATE, ADOBE_DEFLATE):
            wide = px.astype(np.uint32)
            px = (np.cumsum(wide, axis=1) & (0xFFFF if bits == 16 else 0xFF)).astype(px.dtype)
        return px


def _premultiplied_to_straight(rgba: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacker: c * 255 // a clipped to 255, 0 where a = 0."""
    a = rgba[..., 3:4].astype(np.int32)
    c = rgba[..., :3].astype(np.int32)
    straight = np.minimum(c * 255 // np.maximum(a, 1), 255)
    straight = np.where(a == 255, c, np.where(a == 0, 0, straight))
    return np.concatenate([straight, a], axis=-1).astype(np.uint8)


_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


def decode_tiff(data) -> tuple[np.ndarray, str]:
    """The first frame as PIL's 8-bit mode holds it once loaded: ((H, W)
    'L', (H, W, 2) 'LA', (H, W, 3) 'RGB' or (H, W, 4) 'RGBA'; the mode).
    PIL's TIFF reader turns the pixels by their EXIF orientation as it
    loads them (ImageOps.exif_transpose in TiffImageFile.load_end), so this
    does too."""
    from rapidraw_tpu_torch.io.exif import image_orientation
    from rapidraw_tpu_torch.io.loader import _apply_exif_orientation

    px, mode = _decode_tiff(data)
    return np.ascontiguousarray(_apply_exif_orientation(px, image_orientation(data))), mode


def _decode_tiff(data) -> tuple[np.ndarray, str]:
    f = Frame(data)
    photo, bits, spp = f.photo, f.bps[0], f.spp
    px = f.samples(data)
    if photo in (0, 1):
        g = px[..., 0]
        if bits == 16:
            # "I;16" for both zero senses; convert() clamps to 8 bits
            g8 = np.minimum(g, 255).astype(np.uint8)
        else:
            g8 = (g * _GREY_SCALE[bits]).astype(np.uint8)
            if photo == 0:
                g8 = 255 - g8
        if spp == 1:
            return g8, "L"
        if spp == 2 and bits in (8, 16):
            a = px[..., 1]
            a8 = (a >> 8).astype(np.uint8) if bits == 16 else a
            return np.stack([g8, a8], axis=-1), "LA"
    elif photo == 2 and spp in (3, 4) and bits in (8, 16):
        px8 = (px >> 8).astype(np.uint8) if bits == 16 else px
        if spp == 3:
            return px8, "RGB"
        if f.extra[:1] == (1,):
            return _premultiplied_to_straight(px8), "RGBA"
        return px8, "RGBA"
    elif photo == 3 and spp == 1 and bits <= 8:
        cmap = np.asarray(_tuple(f.tags.get(320)), np.int64)
        n = 1 << bits
        if cmap.size != 3 * n:
            raise OSError("TIFF palette image without a valid ColorMap")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = (cmap.reshape(3, n).T // 256).astype(np.uint8)
        return pal[px[..., 0]], "RGB"
    raise _deferred(f"TIFF photometric {photo} with {spp} samples of {bits} bits")


def decode_tiff_rgb(data) -> np.ndarray:
    """(H, W, 3) u8 as PIL's convert("RGB") gives the first frame."""
    px, mode = decode_tiff(data)
    if mode == "L":
        return np.repeat(px[..., None], 3, axis=2)
    if mode == "LA":
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


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
    if f.photo != 2 or f.compression not in _CODECS or f.predictor not in (1, 2):
        return None
    if f.planar == 2:
        # cv2 reads these as if chunky and returns scrambled values
        raise _deferred("compressed planar 16-bit RGB TIFF")
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
