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

Baseline, extended, progressive and 8-bit lossless (SOF3) frames decode;
CMYK and YCCK (Adobe transform 2) too. A frame PIL's reader turns away
(other than 8 bits, or of 2 or more than 4 components) raises
`image_decode.Unidentified`, as `Image.open` does before it tries its other
readers; what libjpeg refuses while it decodes (fractional sampling
factors, hierarchical frames, a lossless frame in YCbCr) raises OSError
("broken data stream when reading image file"), as PIL does. Arithmetic
coding raises NotImplementedError (ROADMAP A.10d-b). A truncated file
raises OSError, as PIL does ("image file is truncated"); so does corrupt
entropy-coded data, which libjpeg decodes with a warning.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rapidraw_tpu_torch.io.encode import cmyk_to_rgb, rgb_to_l

_TRUNCATED, _CORRUPT, _UNSUPPORTED, _UNIDENTIFIED, _BROKEN = -2, -3, -4, -5, -6
# jpeg_dec.cc's Colour: as libjpeg infers it, as stored, YCbCr -> RGB
INFER, RAW, YCBCR = 0, 1, 2


def _lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("jpeg_dec")
    if not getattr(lib, "_rr_typed", False):
        lib.jpeg_dec_info.restype = ctypes.c_int
        lib.jpeg_dec_info.argtypes = [ctypes.c_char_p, ctypes.c_long] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.jpeg_dec_decode.restype = ctypes.c_int
        lib.jpeg_dec_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long, ctypes.c_int]
        lib.jpeg_dec_error.restype = ctypes.c_char_p
        lib._rr_typed = True
    return lib


def _raise(lib, rc: int):
    msg = lib.jpeg_dec_error().decode(errors="replace")
    if rc == _UNSUPPORTED:
        raise NotImplementedError(
            f"rapidraw_tpu_torch does not decode {msg} yet (ROADMAP A.10d-b)")
    if rc == _UNIDENTIFIED:
        from rapidraw_tpu_torch.io.image_decode import Unidentified

        raise Unidentified(msg)
    if rc in (_TRUNCATED, _CORRUPT, _BROKEN):
        raise OSError(msg)
    raise ValueError(f"jpeg decode failed (code {rc})")


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(width, height, channels) of a JPEG: channels 1 (grey), 3 or 4."""
    lib = _lib()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.jpeg_dec_info(bytes(data), len(data), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c))
    if rc:
        _raise(lib, rc)
    return w.value, h.value, c.value


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


def jpeg_components(data: bytes, colour: int = INFER) -> np.ndarray:
    """libjpeg's output: (H, W) or (H, W, C) uint8, C the frame's 3 or 4
    components, colour converted as `colour` asks (INFER: RGB, or CMYK
    from YCCK, as libjpeg infers from the markers)."""
    data = bytes(data)
    lib = _lib()
    w, h, c = jpeg_info(data)
    out = np.empty((h, w) if c == 1 else (h, w, c), np.uint8)
    rc = lib.jpeg_dec_decode(data, len(data), out.ctypes.data, out.size, colour)
    if rc:
        _raise(lib, rc)
    return out


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
