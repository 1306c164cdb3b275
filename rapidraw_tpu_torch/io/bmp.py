"""BMP decoding as PIL 12.1's BmpImagePlugin does it.

  * headers: OS/2 v1 (12 bytes) and Windows 40, 52, 56, 64, 108 and 124;
    rows bottom-up, or top-down where the height's top byte is 0xFF;
  * depths 1, 4 and 8 through the palette (BGR or BGRX entries, as many as
    the header counts; a palette that is PIL's grey ramp gives mode "1" or
    "L"), 16 as 5:5:5 and 24 / 32 as BGR / BGRX; BITFIELDS with the masks
    PIL knows (16-bit 5:6:5 and 5:5:5, the 32-bit orders with and without
    alpha); RLE8 and RLE4 through csrc/host/ldr_dec.cc;
  * refused with PIL's OSError: other depths (2 among them), other masks,
    and the JPEG and PNG compressions.

`decode_dib(data, pos)` reads a headerless bitmap at `pos`, as PIL's
DibImageFile does for an icon's entry.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from rapidraw_tpu_torch.io.image_decode import (
    Frame, Unidentified, ldr_lib, palette_from, raise_status, unpack_bits, unpack_raw)

_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BIT_MODES = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
              24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}


def _i16(b, o):
    return struct.unpack_from("<H", b, o)[0]


def _i32(b, o):
    return struct.unpack_from("<I", b, o)[0]


def _unpack_rgb(rows: np.ndarray, w: int, raw: str) -> tuple[np.ndarray, str]:
    """PIL's raw unpacker of `raw` mode over (h, row) bytes -> pixels."""
    h = rows.shape[0]
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].reshape(h, w, 2)
        v = v[..., 0].astype(np.uint32) | v[..., 1].astype(np.uint32) << 8
        out = np.empty((h, w, 3), np.uint8)
        if raw == "BGR;15":
            out[..., 0] = ((v >> 10) & 31) * 255 // 31
            out[..., 1] = ((v >> 5) & 31) * 255 // 31
        else:
            out[..., 0] = ((v >> 11) & 31) * 255 // 31
            out[..., 1] = ((v >> 5) & 63) * 255 // 63
        out[..., 2] = (v & 31) * 255 // 31
        return out, "RGB"
    nb = len(raw.replace("X", "A")) if raw != "BGR" else 3
    px = rows[:, :nb * w].reshape(h, w, nb)
    order = {c: i for i, c in enumerate(raw)}
    if "A" in raw:
        return px[..., [order["R"], order["G"], order["B"], order["A"]]], "RGBA"
    return px[..., [order["R"], order["G"], order["B"]]], "RGB"


def _info(data: bytes, pos: int):
    """The info header at `pos`, read and checked as PIL's
    BmpImageFile._bitmap reads it: (header size, where PIL's file pointer
    then stands, row direction, bit-field masks or None, width, height,
    bits, compression, colours, palette entry size)."""
    if len(data) < pos + 4:
        raise Unidentified()
    header_size = _i32(data, pos)
    hd = data[pos + 4:pos + header_size]
    if len(hd) < header_size - 4:
        raise OSError("Truncated File Read")
    rd = pos + header_size  # where PIL's file pointer stands
    direction = -1
    masks = None
    if header_size == 12:
        width, height, bits = _i16(hd, 0), _i16(hd, 2), _i16(hd, 6)
        compression, colors, padding = 0, 0, 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        direction = 1 if y_flip else -1
        width = _i32(hd, 0)
        height = _i32(hd, 4) if not y_flip else 2**32 - _i32(hd, 4)
        bits, compression, colors = _i16(hd, 10), _i32(hd, 12), _i32(hd, 28)
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = [_i32(hd, 36 + 4 * i) for i in range(n)] + [0] * (4 - n)
            else:
                if len(data) < rd + 12:
                    raise Unidentified()
                masks = [_i32(data, rd + 4 * i) for i in range(3)] + [0]
                rd += 12
    else:
        raise OSError(f"Unsupported BMP header type ({header_size})")
    if width <= 0 or height <= 0 or width >= 2**31 or height >= 2**31:
        raise Unidentified()
    return header_size, rd, direction, masks, width, height, bits, compression, colors, padding


def bmp_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the headers, as PIL's `.size`."""
    if len(data) < 14 or data[:2] != b"BM":
        raise Unidentified()
    return _info(bytes(data), 14)[4:6]


def _bitmap(data: bytes, pos: int, offset: int, halve: bool = False) -> tuple[Frame, int]:
    """PIL's BmpImageFile._bitmap + load from the info header at `pos`;
    `offset` is the file header's pixel offset (0 for a headerless bitmap).
    `halve`: decode the top half of the rows' count only, as PIL's icon
    reader does. Returns (frame, where the pixel rows start)."""
    (header_size, rd, direction, masks, width, height, bits, compression, colors,
     padding) = _info(data, pos)
    colors = colors if colors else 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT_MODES:
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    mode, raw = _BIT_MODES[bits]
    rle = False
    if compression == 3:
        key_rgba = (bits, tuple(masks))
        key_rgb = (bits, tuple(masks[:3]))
        if bits == 32 and key_rgba in _MASK_MODES:
            raw = _MASK_MODES[key_rgba]
            mode = "RGBA" if "A" in raw else mode
        elif bits in (24, 16) and key_rgb in _MASK_MODES:
            raw = _MASK_MODES[key_rgb]
        else:
            raise OSError("Unsupported BMP bitfields layout")
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise OSError(f"Unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise OSError(f"Unsupported BMP Palette size ({colors})")
        pal = np.frombuffer(data[rd:rd + padding * colors], np.uint8)
        rd += padding * colors
        pal = pal[:len(pal) // padding * padding].reshape(-1, padding)
        ramp = [0, 255] if colors == 2 else list(range(colors))
        grey = len(pal) == colors and all(
            pal[i, 0] == v and pal[i, 1] == v and pal[i, 2] == v for i, v in enumerate(ramp)
            if v < 256)
        grey = grey and colors <= 256
        if grey:
            mode = "1" if colors == 2 else "L"
            raw = mode
        else:
            palette = palette_from(pal[:, [2, 1, 0]])
    start = offset or rd
    if halve:
        height = int(height / 2)
        if height <= 0:
            raise Unidentified()
    bottom_up = direction == -1
    if rle:
        idx = _rle(data, start, compression == 2, width, height)
        idx = idx[::-1] if bottom_up else idx
        if mode == "1":
            raise ValueError("unrecognized raw mode")
        return Frame(mode, idx, palette=palette), start
    stride = ((width * bits + 31) >> 3) & ~3
    if raw == "L" and bits < 8:
        # PIL reads a grey-ramp palette's indices as 8-bit samples
        if width > stride:
            raise OSError("decoder error -8")
        rows = unpack_raw(data, start, width, height, 8, stride, bottom_up)
    else:
        rows = unpack_raw(data, start, width, height, bits, stride, bottom_up)
    if raw == "1":
        px = unpack_bits(rows, width, 1) * np.uint8(255)
    elif raw in ("P;1", "P;4"):
        px = unpack_bits(rows, width, int(raw[2]))
    elif raw in ("P", "L"):
        px = rows[:, :width]
    else:
        px, mode = _unpack_rgb(rows, width, raw)
    return Frame(mode, np.ascontiguousarray(px), palette=palette), start


def _rle(data: bytes, start: int, rle4: bool, w: int, h: int) -> np.ndarray:
    out = np.empty((h, w), np.uint8)
    got = ctypes.c_long(0)
    rc = ldr_lib().bmp_rle_decode(data[start:], max(len(data) - start, 0), start, int(rle4), w,
                                  h, out.ctypes.data, ctypes.byref(got))
    raise_status(rc)
    if got.value < w * h:
        raise ValueError("not enough image data")
    return out


def decode_bmp(data: bytes) -> Frame:
    data = bytes(data)
    if len(data) < 14 or data[:2] != b"BM":
        raise Unidentified()
    return _bitmap(data, 14, _i32(data, 10))[0]


def decode_dib(data: bytes, pos: int) -> tuple[Frame, int]:
    """The headerless bitmap of an icon entry at `pos`, its rows' count
    halved as PIL's icon reader halves it: (frame, where its rows start)."""
    return _bitmap(data, pos, 0, halve=True)
