"""AVIF encode and decode through ctypes bindings to a system libavif.

The JAX package writes AVIF through PIL 12.1 (`Image.save(..., "AVIF",
quality=100 if q >= 100 else q)`); PIL's `_avif` module drives libavif.
This module drives a system libavif the same way, as io/jxl.py binds
libjxl: 4:2:0, 8-bit, full range, encoder speed 6, autotiling, as many
threads as the process may use, and the nclx colour box PIL writes
(primaries BT.709, transfer sRGB, matrix BT.601, full range). The quality
goes to libavif 1.x's `quality`; libavif 0.11 has none, and gets the min and
max quantizer 1.x derives from it, ((100 - q) * 63 + 50) / 100.

The struct layouts are libavif's public ABI (avif.h), transcribed for the
two versions, 0.11.x and 1.x, and chosen by `avifVersion()`; at load they
are checked against the defaults the library itself writes into a fresh
encoder, image and RGB image. Any other version, a library whose defaults
do not sit where the layout says, or no library at all, leaves
`available()` False, and io/encode.py then refuses the format with the
JAX package's "not supported by this PIL build" ValueError, as PIL without
AVIF support does. `load_library(path)` opens a given library file.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from functools import lru_cache

import numpy as np

# ---- avif.h enum values
AVIF_RESULT_OK = 0
AVIF_PIXEL_FORMAT_YUV420 = 3
AVIF_RANGE_FULL = 1
AVIF_RGB_FORMAT_RGB = 0
AVIF_RGB_FORMAT_RGBA = 1
AVIF_ADD_IMAGE_FLAG_SINGLE = 2
# the nclx box PIL writes without an ICC profile (BT.709 primaries, sRGB
# transfer, BT.601 matrix)
COLOR_PRIMARIES, TRANSFER_CHARACTERISTICS, MATRIX_COEFFICIENTS = 1, 13, 6
SPEED = 6


class _RWData(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t)]


class _Layout:
    """Byte offsets of the fields this module reads or writes."""

    def __init__(self, name, enc, rgb, rgb_size):
        self.name = name
        self.enc = enc  # avifEncoder field -> offset
        self.rgb = rgb  # avifRGBImage field -> offset
        self.rgb_size = rgb_size


# avifImage: the same prefix in 0.11.x and 1.x (width, height, depth,
# yuvFormat, yuvRange, yuvChromaSamplePosition, yuvPlanes[3],
# yuvRowBytes[3], imageOwnsYUVPlanes, alphaPlane, alphaRowBytes,
# imageOwnsAlphaPlane, alphaPremultiplied, icc, then the CICP as uint16)
_IMAGE = {"width": 0, "height": 4, "depth": 8, "yuvRange": 16, "colorPrimaries": 104,
          "transferCharacteristics": 106, "matrixCoefficients": 108}

# avifEncoder 0.11.x: codecChoice, maxThreads, speed, keyframeInterval,
# timescale (uint64), minQuantizer, maxQuantizer, minQuantizerAlpha,
# maxQuantizerAlpha, tileRowsLog2, tileColsLog2, autoTiling;
# avifRGBImage: width, height, depth, format, chromaUpsampling,
# chromaDownsampling, avoidLibYUV, ignoreAlpha, alphaPremultiplied, isFloat,
# pixels, rowBytes
_V011 = _Layout(
    "0.11",
    {"maxThreads": 4, "speed": 8, "timescale": 16, "minQuantizer": 24, "maxQuantizer": 28,
     "autoTiling": 48},
    {"format": 12, "pixels": 40, "rowBytes": 48}, 56)
# 1.x adds repetitionCount, extraLayerCount, quality and qualityAlpha after
# timescale (and scalingMode after autoTiling), and maxThreads before the
# RGB image's pixels
_V1 = _Layout(
    "1.x",
    {"maxThreads": 4, "speed": 8, "timescale": 16, "quality": 32, "minQuantizer": 40,
     "maxQuantizer": 44, "autoTiling": 64},
    {"format": 12, "pixels": 48, "rowBytes": 56}, 64)


def _i32(addr: int, off: int) -> ctypes.c_int32:
    return ctypes.c_int32.from_address(addr + off)


def _u16(addr: int, off: int) -> ctypes.c_uint16:
    return ctypes.c_uint16.from_address(addr + off)


def _ptr(addr: int, off: int) -> ctypes.c_void_p:
    return ctypes.c_void_p.from_address(addr + off)


def quality_to_quantizer(quality: int) -> int:
    """libavif 1.x's quantizer for a quality (avifQualityToQuantizer)."""
    return ((100 - quality) * 63 + 50) // 100


def _threads() -> int:
    """PIL's default: the CPUs this process may run on."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


class Libavif:
    """One loaded libavif and its layout."""

    def __init__(self, lib: ctypes.CDLL):
        vp = ctypes.c_void_p
        lib.avifVersion.restype = ctypes.c_char_p
        lib.avifVersion.argtypes = []
        self.version = lib.avifVersion().decode()
        self.layout = self._layout_for(self.version)
        if self.layout is None:
            raise OSError(f"libavif {self.version}: no struct layout for this version")
        lib.avifEncoderCreate.restype = vp
        lib.avifEncoderCreate.argtypes = []
        lib.avifEncoderDestroy.restype = None
        lib.avifEncoderDestroy.argtypes = [vp]
        lib.avifEncoderAddImage.restype = ctypes.c_int
        lib.avifEncoderAddImage.argtypes = [vp, vp, ctypes.c_uint64, ctypes.c_uint32]
        lib.avifEncoderFinish.restype = ctypes.c_int
        lib.avifEncoderFinish.argtypes = [vp, ctypes.POINTER(_RWData)]
        lib.avifImageCreate.restype = vp
        lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
        lib.avifImageCreateEmpty.restype = vp
        lib.avifImageCreateEmpty.argtypes = []
        lib.avifImageDestroy.restype = None
        lib.avifImageDestroy.argtypes = [vp]
        lib.avifImageRGBToYUV.restype = ctypes.c_int
        lib.avifImageRGBToYUV.argtypes = [vp, vp]
        lib.avifImageYUVToRGB.restype = ctypes.c_int
        lib.avifImageYUVToRGB.argtypes = [vp, vp]
        lib.avifRGBImageSetDefaults.restype = None
        lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
        lib.avifRWDataFree.restype = None
        lib.avifRWDataFree.argtypes = [ctypes.POINTER(_RWData)]
        lib.avifDecoderCreate.restype = vp
        lib.avifDecoderCreate.argtypes = []
        lib.avifDecoderDestroy.restype = None
        lib.avifDecoderDestroy.argtypes = [vp]
        lib.avifDecoderReadMemory.restype = ctypes.c_int
        lib.avifDecoderReadMemory.argtypes = [vp, vp, ctypes.c_char_p, ctypes.c_size_t]
        lib.avifResultToString.restype = ctypes.c_char_p
        lib.avifResultToString.argtypes = [ctypes.c_int]
        self.lib = lib
        self._check_layout()

    @staticmethod
    def _layout_for(version: str) -> _Layout | None:
        major, minor = (int(v) for v in version.split(".")[:2])
        if (major, minor) == (0, 11):
            return _V011
        return _V1 if major == 1 else None

    def _check_layout(self) -> None:
        """The library's own defaults where the layout puts them: a fresh
        encoder's maxThreads 1, speed -1 and timescale 1 (1.x: quality -1
        and maxQuantizer 63), an image's size, full range and unspecified
        CICP (2), an RGB image's RGBA format."""
        lay, lib = self.layout, self.lib
        enc = lib.avifEncoderCreate()
        if not enc:
            raise OSError("avifEncoderCreate failed")
        try:
            ok = (_i32(enc, lay.enc["maxThreads"]).value == 1
                  and _i32(enc, lay.enc["speed"]).value == -1
                  and ctypes.c_uint64.from_address(enc + lay.enc["timescale"]).value == 1)
            if lay is _V1:
                ok = ok and (_i32(enc, lay.enc["quality"]).value == -1
                             and _i32(enc, lay.enc["maxQuantizer"]).value == 63)
        finally:
            lib.avifEncoderDestroy(enc)
        img = lib.avifImageCreate(17, 9, 8, AVIF_PIXEL_FORMAT_YUV420)
        try:
            ok = ok and (_i32(img, _IMAGE["width"]).value == 17
                         and _i32(img, _IMAGE["height"]).value == 9
                         and _i32(img, _IMAGE["yuvRange"]).value == AVIF_RANGE_FULL
                         and all(_u16(img, _IMAGE[k]).value == 2 for k in (
                             "colorPrimaries", "transferCharacteristics", "matrixCoefficients")))
            rgb = (ctypes.c_uint8 * 128)()
            lib.avifRGBImageSetDefaults(rgb, img)
            a = ctypes.addressof(rgb)
            ok = ok and (_i32(a, 0).value == 17 and _i32(a, lay.rgb["format"]).value
                         == AVIF_RGB_FORMAT_RGBA and not _ptr(a, lay.rgb["pixels"]).value
                         and not any(rgb[lay.rgb_size:]))
        finally:
            lib.avifImageDestroy(img)
        if not ok:
            raise OSError(f"libavif {self.version}: its structs do not match the {lay.name} layout")

    def _fail(self, what: str, result: int) -> None:
        if result != AVIF_RESULT_OK:
            raise OSError(f"{what}: {self.lib.avifResultToString(result).decode()}")

    def encode(self, rgb_u8_hwc: np.ndarray, quality: int, quantizer: int | None = None) -> bytes:
        """(H, W, 3) uint8 -> an AVIF file at `quality` (0..100); with
        `quantizer`, that min and max quantizer and no quality (what 0.11
        always gets)."""
        lay, lib = self.layout, self.lib
        rgb_u8_hwc = np.ascontiguousarray(rgb_u8_hwc, dtype=np.uint8)
        h, w = rgb_u8_hwc.shape[:2]
        img = lib.avifImageCreate(w, h, 8, AVIF_PIXEL_FORMAT_YUV420)
        enc = None
        try:
            _i32(img, _IMAGE["yuvRange"]).value = AVIF_RANGE_FULL
            _u16(img, _IMAGE["colorPrimaries"]).value = COLOR_PRIMARIES
            _u16(img, _IMAGE["transferCharacteristics"]).value = TRANSFER_CHARACTERISTICS
            _u16(img, _IMAGE["matrixCoefficients"]).value = MATRIX_COEFFICIENTS
            rgb = (ctypes.c_uint8 * 128)()
            lib.avifRGBImageSetDefaults(rgb, img)
            a = ctypes.addressof(rgb)
            _i32(a, lay.rgb["format"]).value = AVIF_RGB_FORMAT_RGB
            _ptr(a, lay.rgb["pixels"]).value = rgb_u8_hwc.ctypes.data
            ctypes.c_uint32.from_address(a + lay.rgb["rowBytes"]).value = w * 3
            self._fail("avifImageRGBToYUV", lib.avifImageRGBToYUV(img, rgb))
            enc = lib.avifEncoderCreate()
            _i32(enc, lay.enc["maxThreads"]).value = _threads()
            _i32(enc, lay.enc["speed"]).value = SPEED
            _i32(enc, lay.enc["autoTiling"]).value = 1
            if quantizer is None and "quality" in lay.enc:
                _i32(enc, lay.enc["quality"]).value = quality
            else:
                qz = quality_to_quantizer(quality) if quantizer is None else quantizer
                _i32(enc, lay.enc["minQuantizer"]).value = qz
                _i32(enc, lay.enc["maxQuantizer"]).value = qz
            out = _RWData()
            self._fail("avifEncoderAddImage",
                       lib.avifEncoderAddImage(enc, img, 1, AVIF_ADD_IMAGE_FLAG_SINGLE))
            self._fail("avifEncoderFinish", lib.avifEncoderFinish(enc, ctypes.byref(out)))
            try:
                return ctypes.string_at(out.data, out.size)
            finally:
                lib.avifRWDataFree(ctypes.byref(out))
        finally:
            if enc:
                lib.avifEncoderDestroy(enc)
            lib.avifImageDestroy(img)

    def decode(self, data: bytes) -> np.ndarray:
        """An AVIF file -> (H, W, 3) uint8 through libavif's own YUV -> RGB."""
        lay, lib = self.layout, self.lib
        dec = lib.avifDecoderCreate()
        img = lib.avifImageCreateEmpty()
        try:
            self._fail("avifDecoderReadMemory", lib.avifDecoderReadMemory(dec, img, data, len(data)))
            w, h = _i32(img, _IMAGE["width"]).value, _i32(img, _IMAGE["height"]).value
            if _i32(img, _IMAGE["depth"]).value != 8:
                raise OSError("only 8-bit AVIF decodes here")
            out = np.empty((h, w, 3), np.uint8)
            rgb = (ctypes.c_uint8 * 128)()
            lib.avifRGBImageSetDefaults(rgb, img)
            a = ctypes.addressof(rgb)
            _i32(a, lay.rgb["format"]).value = AVIF_RGB_FORMAT_RGB
            _ptr(a, lay.rgb["pixels"]).value = out.ctypes.data
            ctypes.c_uint32.from_address(a + lay.rgb["rowBytes"]).value = w * 3
            self._fail("avifImageYUVToRGB", lib.avifImageYUVToRGB(img, rgb))
            return out
        finally:
            lib.avifImageDestroy(img)
            lib.avifDecoderDestroy(dec)


def load_library(path: str) -> Libavif:
    """The libavif at `path` (a name the loader finds, or a file), or
    OSError when it does not load or has no layout here."""
    try:
        return Libavif(ctypes.CDLL(path))
    except (AttributeError, ValueError) as e:
        raise OSError(f"{path}: not a usable libavif ({e})") from e


@lru_cache(maxsize=1)
def _default() -> Libavif | None:
    for name in ("libavif.so.16", "libavif.so.15", "libavif.so", ctypes.util.find_library("avif")):
        if not name:
            continue
        try:
            return load_library(name)
        except OSError:
            continue
    return None


def available() -> bool:
    return _default() is not None


def version() -> str | None:
    """The bound libavif's version, or None without one."""
    lib = _default()
    return lib.version if lib is not None else None


def encode_avif(rgb_u8_hwc: np.ndarray, quality: int) -> bytes:
    """(H, W, 3) uint8 -> an AVIF file, with PIL 12.1's settings (module
    docstring); quality 100 and above encode at 100, as the JAX package
    asks PIL."""
    if not isinstance(quality, (int, np.integer)) or quality < 0:
        raise ValueError("Invalid quality setting")  # PIL's AvifImagePlugin
    lib = _default()
    if lib is None:
        raise OSError("no libavif found for rapidraw_tpu_torch.io.avif")
    return lib.encode(rgb_u8_hwc, min(int(quality), 100))


def decode_avif(data: bytes) -> np.ndarray:
    """An AVIF file -> (H, W, 3) uint8 (the card's round trip; the loader
    reads no AVIF, as the JAX package's does not)."""
    lib = _default()
    if lib is None:
        raise OSError("no libavif found for rapidraw_tpu_torch.io.avif")
    return lib.decode(bytes(data))
