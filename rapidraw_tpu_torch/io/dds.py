"""DDS decoding as PIL 12.1's DdsImagePlugin does it: uncompressed RGB(A)
by bit masks (each channel scaled as PIL's float arithmetic scales it, data
past the end read as zeros), luminance L and LA, 8-bit palette, the
FourCC formats DXT1/3/5, ATI1/BC4U, ATI2/BC5U, BC5S and the DX10 header's
BC1-BC7 and R8G8B8A8, the blocks decoded by csrc/host/bcn_dec.cc. A
format PIL does not implement raises NotImplementedError, as PIL does; a
bad header OSError."""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from rapidraw_tpu_torch.io.image_decode import Frame, Unidentified, palette_from, unpack_raw

_ALPHAPIXELS, _FOURCC, _PAL8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def _cc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


# FourCC -> (BCn number, signed, mode)
_FOURCCS = {_cc(b"DXT1"): (1, 0, "RGBA"), _cc(b"DXT3"): (2, 0, "RGBA"),
            _cc(b"DXT5"): (3, 0, "RGBA"), _cc(b"BC4U"): (4, 0, "L"), _cc(b"ATI1"): (4, 0, "L"),
            _cc(b"BC5S"): (5, 1, "RGB"), _cc(b"BC5U"): (5, 0, "RGB"), _cc(b"ATI2"): (5, 0, "RGB")}
# DXGI format -> (BCn number, signed, mode); 0: raw RGBA
_DXGI = {70: (1, 0, "RGBA"), 71: (1, 0, "RGBA"), 73: (2, 0, "RGBA"), 74: (2, 0, "RGBA"),
         76: (3, 0, "RGBA"), 77: (3, 0, "RGBA"), 79: (4, 0, "L"), 80: (4, 0, "L"),
         82: (5, 0, "RGB"), 83: (5, 0, "RGB"), 84: (5, 1, "RGB"), 95: (6, 0, "RGB"),
         96: (6, 1, "RGB"), 97: (7, 0, "RGBA"), 98: (7, 0, "RGBA"), 99: (7, 0, "RGBA"),
         27: (0, 0, "RGBA"), 28: (0, 0, "RGBA"), 29: (0, 0, "RGBA")}


def _bcn_lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("bcn_dec")
    if not getattr(lib, "_rr_typed", False):
        lib.bcn_decode.restype = ctypes.c_int
        lib.bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib._rr_typed = True
    return lib


def bcn_decode(blocks: bytes, n: int, signed: int, w: int, h: int) -> np.ndarray:
    """(h, w[, C]) pixels of BCn blocks; short data raises OSError."""
    c = 1 if n == 4 else 3 if n in (5, 6) else 4
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    rc = _bcn_lib().bcn_decode(blocks, len(blocks), n, signed, w, h, out.ctypes.data)
    if rc:
        raise OSError("image file is truncated")
    return out


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """PIL's DdsRgbDecoder: int(((v & mask) >> shift) / (mask >> shift) * 255)."""
    nb = bitcount // 8
    need = w * h * nb
    raw = np.frombuffer(data[pos:pos + need], np.uint8)
    if len(raw) < need:
        raw = np.concatenate([raw, np.zeros(need - len(raw), np.uint8)])
    v = np.zeros(w * h, np.uint64)
    for k in range(nb):
        v |= raw[k::nb].astype(np.uint64) << np.uint64(8 * k)
    chans = []
    for mask in masks:
        shift = 0
        if mask:
            while mask >> (shift + 1) << (shift + 1) == mask:
                shift += 1
        total = mask >> shift
        if not total:
            chans.append(np.zeros(w * h, np.uint8))
            continue
        val = ((v & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        chans.append((val / total * 255).astype(np.uint8))
    return np.stack(chans, -1).reshape(h, w, len(masks))


def dds_header(data: bytes) -> tuple[int, int]:
    """(width, height) of a DDS header, as PIL's `.size`."""
    if len(data) < 8 or data[:4] != b"DDS ":
        raise Unidentified()
    if _cc(data[4:8]) != 124:
        raise OSError(f"Unsupported header size {_cc(data[4:8])!r}")
    if len(data) < 128:
        raise OSError(f"Incomplete header: {len(data) - 8} bytes")
    height, width = struct.unpack_from("<II", data, 12)
    return width, height


def decode_dds(data: bytes) -> Frame:
    data = bytes(data)
    width, height = dds_header(data)
    if width <= 0 or height <= 0:
        raise Unidentified()
    pfflags, fourcc, bitcount = struct.unpack_from("<III", data, 80)
    pos = 128
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", data, 92)
        px = _masked(data, pos, width, height, bitcount, masks)
        return Frame("RGBA" if n == 4 else "RGB", px)
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            rows = unpack_raw(data, pos, width, height, 8)
            return Frame("L", np.ascontiguousarray(rows))
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            rows = unpack_raw(data, pos, width, height, 16)
            return Frame("LA", np.ascontiguousarray(rows.reshape(height, width, 2)))
        raise OSError(f"Unsupported bitcount {bitcount} for {pfflags}")
    if pfflags & _PAL8:
        pal = np.frombuffer(data[pos:pos + 1024], np.uint8)
        pos += 1024
        pal = pal[:len(pal) // 4 * 4].reshape(-1, 4)
        rows = unpack_raw(data, pos, width, height, 8)
        return Frame("P", np.ascontiguousarray(rows), palette=palette_from(pal, alpha=True))
    if not pfflags & _FOURCC:
        raise NotImplementedError(f"Unknown pixel format flags {pfflags}")
    if fourcc == _cc(b"DX10"):
        if len(data) < pos + 20:
            raise Unidentified()
        (dxgi,) = struct.unpack_from("<I", data, pos)
        pos += 20
        if dxgi not in _DXGI:
            raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
        n, signed, mode = _DXGI[dxgi]
    elif fourcc in _FOURCCS:
        n, signed, mode = _FOURCCS[fourcc]
    else:
        raise NotImplementedError(f"Unimplemented pixel format {fourcc!r}")
    if n == 0:
        rows = unpack_raw(data, pos, width, height, 32)
        return Frame("RGBA", np.ascontiguousarray(rows.reshape(height, width, 4)))
    return Frame(mode, bcn_decode(data[pos:], n, signed, width, height))
