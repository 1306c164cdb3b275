"""The port's JPEG decoder: csrc/host/jpeg_dec.cc over ctypes.

`decode_jpeg` gives the samples libjpeg-turbo gives PIL's `Image.open`
(mode "L" for one component, "RGB" for three, "CMYK" for four, inverted
as PIL's "CMYK;I" raw mode always inverts them); `decode_jpeg_rgb` and
`decode_jpeg_gray` add PIL's `convert("RGB")` and `convert("L")`.
`jpeg_components` gives libjpeg's output for the TIFF reader, which asks
for the components as stored or for YCbCr -> RGB, as libtiff asks. The
library builds with g++ at first use (`native.host_library`); a failed
build raises, and nothing stands in for it. The calls release the GIL, so
the export's prepare threads decode at once.

Baseline, extended, progressive and 8-bit lossless (SOF3) frames decode,
Huffman- or arithmetic-coded (SOF9, SOF10: the QM decoder of libjpeg's
jdarith.c, DAC conditioning, a bad code leaving the rest of the scan as
it is); CMYK and YCCK (Adobe transform 2) too. A frame PIL's reader turns
away (other than 8 bits, or of 2 or more than 4 components) raises
`image_decode.Unidentified`, as `Image.open` does before it tries its other
readers; what libjpeg refuses while it decodes (fractional sampling
factors, hierarchical frames, a lossless frame in YCbCr, arithmetic
lossless SOF11, a second scan after a frame's single scan) raises OSError
("broken data stream when reading image file"), as PIL does, and so does
an arithmetic-coded scan that reads past what PIL's reader has handed
libjpeg (64 KB at a time: the arithmetic decoder cannot wait for more).
A truncated file raises OSError, as PIL does ("image file is truncated");
corrupt Huffman-coded data decodes as libjpeg decodes it with its
warnings (a lossless scan's raises OSError), and a progressive JPEG whose
scans stop early is smoothed as libjpeg-turbo smooths it.
For the TIFF reader (`pil=False`, as libtiff hands libjpeg a whole strip)
12-bit frames of one component decode too.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rapidraw_tpu_torch.io.encode import cmyk_to_rgb, rgb_to_l

_TRUNCATED, _CORRUPT, _UNIDENTIFIED, _BROKEN = -2, -3, -5, -6
# jpeg_dec.cc's Colour: as libjpeg infers it, as stored, YCbCr -> RGB
INFER, RAW, YCBCR = 0, 1, 2


def _lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("jpeg_dec")
    if not getattr(lib, "_rr_typed", False):
        lib.jpeg_dec_info.restype = ctypes.c_int
        lib.jpeg_dec_info.argtypes = [ctypes.c_char_p, ctypes.c_long] + [
            ctypes.POINTER(ctypes.c_int)] * 4 + [ctypes.c_int]
        lib.jpeg_dec_decode.restype = ctypes.c_int
        lib.jpeg_dec_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.jpeg_dec_planes.restype = ctypes.c_int
        lib.jpeg_dec_planes.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long]
        lib.jpeg_dec_error.restype = ctypes.c_char_p
        lib._rr_typed = True
    return lib


def _raise(lib, rc: int):
    msg = lib.jpeg_dec_error().decode(errors="replace")
    if rc == _UNIDENTIFIED:
        from rapidraw_tpu_torch.io.image_decode import Unidentified

        raise Unidentified(msg)
    if rc in (_TRUNCATED, _CORRUPT, _BROKEN):
        raise OSError(msg)
    raise ValueError(f"jpeg decode failed (code {rc})")


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(width, height, channels) of a JPEG as PIL's JPEG reader opens it:
    channels 1 (grey), 3 or 4."""
    return frame_info(data)[:3]


def frame_info(data: bytes, pil: bool = True) -> tuple[int, int, int, int]:
    """(width, height, channels, bits) of a JPEG as PIL's JPEG reader opens
    it (`pil`: 8 bits) or as libjpeg reads a TIFF's strip for libtiff (8 or
    12 bits)."""
    lib = _lib()
    w, h, c, p = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.jpeg_dec_info(bytes(data), len(data), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c), ctypes.byref(p), int(pil))
    if rc:
        _raise(lib, rc)
    return w.value, h.value, c.value, p.value


def sampling_factors(data: bytes) -> list[tuple[int, int]]:
    """(h, v) of each component of the first frame header, from the
    markers alone ([] where there is none)."""
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xFF, 0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 1 if marker == 0xFF else 2
            continue
        ln = (data[pos + 2] << 8) | data[pos + 3]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            nc = data[pos + 9] if pos + 9 < n else 0
            return [(data[pos + 11 + 3 * i] >> 4, data[pos + 11 + 3 * i] & 15)
                    for i in range(nc) if pos + 11 + 3 * i < n]
        if marker in (0xDA, 0xD9):
            break
        pos += 2 + ln
    return []


def jpeg_components(data: bytes, colour: int = INFER, pil: bool = True) -> np.ndarray:
    """libjpeg's output: (H, W) or (H, W, C) uint8, C the frame's 3 or 4
    components, colour converted as `colour` asks (INFER: RGB, or CMYK
    from YCCK, as libjpeg infers from the markers). `pil`: as PIL's JPEG
    reader decodes the file, its SOF checks first and an arithmetic-coded
    scan failed where it fails (libjpeg's arithmetic decoder cannot wait
    for the next 64 KB PIL reads); without it, as libtiff's JPEG codec
    decodes a strip or tile it hands over whole, 12-bit frames of one
    component among them ((H, W) uint16)."""
    data = bytes(data)
    lib = _lib()
    w, h, c, bits = frame_info(data, pil)
    out = np.empty((h, w) if c == 1 else (h, w, c), np.uint16 if bits > 8 else np.uint8)
    rc = lib.jpeg_dec_decode(data, len(data), out.ctypes.data, out.nbytes, colour, int(pil))
    if rc:
        _raise(lib, rc)
    return out


def jpeg_planes(data: bytes) -> list[np.ndarray]:
    """Each component of an 8-bit DCT frame as libjpeg's raw_data_out hands
    it to libtiff (not upsampled, no colour conversion): (height_in_blocks *
    8, width_in_blocks * 8) u8 arrays, the blocks' inverse DCT past the
    component's edge included."""
    data = bytes(data)
    w, h, c, _ = frame_info(data, pil=False)
    factors = sampling_factors(data)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    shapes = [(-(-(-(-h * fv // vmax)) // 8) * 8, -(-(-(-w * fh // hmax)) // 8) * 8)
              for fh, fv in factors]
    out = np.empty(sum(a * b for a, b in shapes), np.uint8)
    lib = _lib()
    rc = lib.jpeg_dec_planes(data, len(data), out.ctypes.data, out.size)
    if rc:
        _raise(lib, rc)
    planes, at = [], 0
    for a, b in shapes:
        planes.append(out[at:at + a * b].reshape(a, b))
        at += a * b
    return planes


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG -> (H, W) "L", (H, W, 3) "RGB" or (H, W, 4) "CMYK" uint8, as
    PIL opens it."""
    px = jpeg_components(data)
    if px.ndim == 3 and px.shape[2] == 4:
        np.subtract(255, px, out=px)
    return px


def decode_jpeg_rgb(data: bytes) -> np.ndarray:
    """A JPEG -> (H, W, 3) uint8, as PIL's convert("RGB") gives it."""
    px = decode_jpeg(data)
    if px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=2)
    return cmyk_to_rgb(px) if px.shape[2] == 4 else px


def decode_jpeg_gray(data: bytes) -> np.ndarray:
    """A JPEG -> (H, W) uint8, as PIL's convert("L") gives it."""
    px = decode_jpeg(data)
    if px.ndim == 2:
        return px
    return rgb_to_l(cmyk_to_rgb(px) if px.shape[2] == 4 else px)
