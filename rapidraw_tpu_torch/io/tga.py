"""TGA decoding as PIL 12.1's TgaImagePlugin does it: image types 1, 2,
3, 9, 10 and 11 at depths 1, 8, 16, 24 and 32 (PIL identifies no other),
colour maps of 16 or 24 bits from their first-entry offset (PIL refuses a
32-bit map with ValueError), the image
ID skipped, the origin bits honoured (bottom-up rows, and the horizontal
flip), 16-bit colour as PIL's "BGRA;15Z" (five bits widened by x255/31,
the top bit set meaning alpha 0). RLE packets go through
csrc/host/ldr_dec.cc. TGA has no magic: a file PIL would not take raises
OSError."""

from __future__ import annotations

import numpy as np

from rapidraw_tpu_torch.io.image_decode import (
    Frame, Unidentified, ldr_lib, palette_from, raise_status, unpack_bits, unpack_raw)

_TYPES = (1, 2, 3, 9, 10, 11)


def _header(data: bytes):
    if len(data) < 18:
        raise Unidentified()
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w = data[12] | data[13] << 8
    h = data[14] | data[15] << 8
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise Unidentified()
    if itype not in _TYPES or (flags & 0x30) not in (0, 0x10, 0x20, 0x30):
        raise Unidentified()
    return id_len, cmap_type, itype, w, h, depth, flags


def looks_like_tga(data: bytes) -> bool:
    """Whether PIL's TGA reader would take the header."""
    try:
        _header(bytes(data[:18]))
    except OSError:
        return False
    return True


def tga_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the header, as PIL's `.size`."""
    _, _, _, w, h, _, _ = _header(bytes(data[:18]))
    return w, h


def _bgra15z(raw: np.ndarray) -> np.ndarray:
    """(N, 2) little-endian 5:5:5:1 -> (N, 4) RGBA as PIL's "BGRA;15Z"."""
    v = raw[..., 0].astype(np.uint32) | raw[..., 1].astype(np.uint32) << 8
    out = np.empty(v.shape + (4,), np.uint8)
    out[..., 0] = ((v >> 10) & 31) * 255 // 31
    out[..., 1] = ((v >> 5) & 31) * 255 // 31
    out[..., 2] = (v & 31) * 255 // 31
    out[..., 3] = np.where(v & 0x8000, 0, 255)
    return out


def decode_tga(data: bytes) -> Frame:
    data = bytes(data)
    id_len, cmap_type, itype, w, h, depth, flags = _header(data)
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start = data[3] | data[4] << 8
        size = data[5] | data[6] << 8
        mapdepth = data[7]
        if mapdepth not in (16, 24, 32):
            raise Unidentified()
        if mapdepth == 32:  # PIL has no "BGRA" palette unpacker
            raise ValueError("unrecognized raw mode")
        nb = mapdepth // 8
        raw = np.frombuffer(data[pos:pos + nb * size], np.uint8)
        pos += nb * size
        raw = raw[:len(raw) // nb * nb].reshape(-1, nb)
        if mapdepth == 16:
            cols = _bgra15z(raw)
        else:
            cols = raw[:, [2, 1, 0]]
        cols = np.concatenate([np.zeros((start, cols.shape[1]), np.uint8), cols])
        palette = palette_from(cols, alpha=mapdepth == 16)
    kind = itype & 7
    if kind in (3,):
        mode = {1: "1", 8: "L", 16: "LA"}.get(depth, "L")
    elif kind == 1:
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    supported = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}
    if (kind, depth) not in supported:
        raise OSError("cannot load this image")
    if kind == 1 and not cmap_type:  # mode "L" from raw mode "P"
        raise ValueError("unknown raw mode for given image mode")
    bottom_up = (flags & 0x20) == 0
    row_bytes = (w * depth + 7) // 8
    if itype & 8:
        if depth < 8:  # PIL's RLE reader takes depth // 8 bytes a pixel: none
            raise OSError("image file is truncated")
        rows = np.empty((h, row_bytes), np.uint8)
        raise_status(ldr_lib().tga_rle_decode(data[pos:], len(data) - pos, rows.ctypes.data,
                                              row_bytes, h, (depth + 7) // 8))
        if bottom_up:
            rows = rows[::-1]
    else:
        rows = unpack_raw(data, pos, w, h, depth, bottom_up=bottom_up)
    if depth == 1:
        px = unpack_bits(rows, w, 1) * np.uint8(255)
    elif depth == 8:
        px = rows[:, :w]
    elif depth == 16 and kind == 3:
        px = rows.reshape(h, w, 2)
    elif depth == 16:
        px = _bgra15z(rows.reshape(h, w, 2))
    else:
        nb = depth // 8
        bgr = rows.reshape(h, w, nb)
        px = bgr[..., [2, 1, 0, 3]] if nb == 4 else bgr[..., [2, 1, 0]]
    if flags & 0x10:
        px = px[:, ::-1]
    return Frame(mode, np.ascontiguousarray(px), palette=palette)
