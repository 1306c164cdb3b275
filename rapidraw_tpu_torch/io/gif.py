"""GIF decoding: the first frame as PIL 12.1's GifImagePlugin loads it, the
LZW codes in csrc/host/ldr_dec.cc.

  * mode "P" with the frame's palette (its local colour table, else the
    global one), or "L" where the table is absent or is the grey ramp PIL
    reads as no palette; entries past the table are black;
  * the logical screen grows to hold a frame that reaches past it; around
    the frame the canvas holds index 0, or the transparency index when the
    frame has one; that index (the graphic control extension's) gives
    alpha 0 in RGBA;
  * interlaced rows, minimum code sizes 0-12, clear codes anywhere, no
    table growth past 4095 codes (a deferred clear);
  * a file without an image descriptor, a header PIL cannot parse, codes
    that end before the frame is full and an invalid code raise OSError, as
    PIL raises them.
"""

from __future__ import annotations

import struct

import numpy as np

from rapidraw_tpu_torch.io.image_decode import Frame, Unidentified, ldr_lib, palette_from, raise_status


def _palette_needed(p: bytes) -> bool:
    """PIL's GifImageFile._is_palette_needed: anything but the grey ramp."""
    n = len(p) // 3
    pal = np.frombuffer(p[:3 * n], np.uint8).reshape(n, 3)
    return not (pal == np.arange(n, dtype=np.uint8)[:, None]).all() or len(p) % 3 != 0


def _data(data: bytes, pos: int) -> tuple[bytes | None, int]:
    """PIL's GifImageFile.data(): one sub-block, None at a zero size."""
    if pos < len(data) and data[pos]:
        n = data[pos]
        return data[pos + 1:pos + 1 + n], pos + 1 + n
    return None, min(pos + 1, len(data))


def _first_frame(data: bytes) -> dict:
    """PIL's GifImageFile._open up to the first image descriptor: the
    logical screen grown to hold the first frame (PIL's `.size`), the
    palettes, the transparency index and where the LZW data starts."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise Unidentified()
    w, h = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_pal = None
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += 3 << ((flags & 7) + 1)
        if _palette_needed(p):
            global_pal = p
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            # PIL's EOFError in _open becomes an UnidentifiedImageError
            raise Unidentified()
        s = data[pos]
        pos += 1
        if s == 0x21:  # extension, read as PIL reads it
            if pos >= len(data):
                raise Unidentified()
            label = data[pos]
            block, pos = _data(data, pos + 1)
            if label == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise Unidentified()
                if block[0] & 1:
                    transparency = block[3]
            elif label == 254:
                while block:
                    block, pos = _data(data, pos)
                continue
            elif label == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                block, pos = _data(data, pos)
            while True:
                block, pos = _data(data, pos)
                if not block:
                    break
        elif s == 0x2C:  # image descriptor
            if pos + 9 > len(data):
                raise Unidentified()
            x0, y0, fw, fh = struct.unpack_from("<HHHH", data, pos)
            fflags = data[pos + 8]
            pos += 9
            x1, y1 = x0 + fw, y0 + fh
            w, h = max(x1, w), max(y1, h)
            interlace = bool(fflags & 64)
            local = None
            if fflags & 128:
                p = data[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += 3 << ((fflags & 7) + 1)
                local = p if _palette_needed(p) else False
            if pos >= len(data):
                raise Unidentified()
            bits = data[pos]
            pos += 1
            break
    if w <= 0 or h <= 0:
        raise Unidentified()
    return dict(size=(w, h), global_pal=global_pal, local=local, transparency=transparency,
                rect=(x0, y0, fw, fh), interlace=interlace, bits=bits, pos=pos)


def gif_size(data: bytes) -> tuple[int, int]:
    """(width, height) as PIL's `.size`: the logical screen, grown to hold
    the first frame."""
    return _first_frame(bytes(data))["size"]


def decode_gif(data: bytes) -> Frame:
    data = bytes(data)
    f = _first_frame(data)
    (w, h), (x0, y0, fw, fh), pos, bits = f["size"], f["rect"], f["pos"], f["bits"]
    local, global_pal, transparency = f["local"], f["global_pal"], f["transparency"]
    frame_pal = local if local is not None else global_pal
    fill = transparency if transparency is not None else 0
    canvas = np.full((h, w), fill, np.uint8)
    if bits > 12:
        raise OSError("decoder error -8")
    if fw > 0 and fh > 0:
        rc = ldr_lib().gif_lzw_decode(data[pos:], len(data) - pos, bits, int(f["interlace"]),
                                      canvas.ctypes.data, w, x0, y0, fw, fh)
        raise_status(rc)
    if frame_pal:
        n = len(frame_pal) // 3
        cols = np.frombuffer(frame_pal[:3 * n], np.uint8).reshape(n, 3)
        return Frame("P", canvas, palette=palette_from(cols), transparency=transparency)
    return Frame("L", canvas, transparency=transparency)
