"""JPEG XL encode/decode via ctypes bindings to the system libjxl.

A copy of `rapidraw_tpu/io/jxl.py` (it imports neither JAX nor PIL). The
reference ships lossless + lossy JXL export through jpegxl-rs
(export_processing.rs:396-430: lossless when quality == 100, otherwise
Butteraugli distance = max((100 - q) / 10, 0.01)); the C API of a system
libjxl is bound directly. Where no libjxl is found, `available()` is False
and io/encode.py refuses the format.

Struct layouts follow the libjxl 0.7 public ABI (codestream_header.h,
types.h, color_encoding.h), transcribed here and validated by the
encode->decode round trip (tests/test_jxl.py for the JAX copy): a wrong
offset anywhere makes the encoder reject the basic info or the decoder
mis-read dimensions.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

# ---- libjxl 0.7 enum values (types.h, encode.h, decode.h) ----------------
JXL_TYPE_UINT8 = 2
JXL_NATIVE_ENDIAN = 0
JXL_ENC_SUCCESS = 0
JXL_ENC_NEED_MORE_OUTPUT = 2
JXL_DEC_SUCCESS = 0
JXL_DEC_ERROR = 1
JXL_DEC_BASIC_INFO = 0x40
JXL_DEC_FULL_IMAGE = 0x1000
JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5


class _JxlPreviewHeader(ctypes.Structure):
    _fields_ = [("xsize", ctypes.c_uint32), ("ysize", ctypes.c_uint32)]


class _JxlAnimationHeader(ctypes.Structure):
    _fields_ = [
        ("tps_numerator", ctypes.c_uint32),
        ("tps_denominator", ctypes.c_uint32),
        ("num_loops", ctypes.c_uint32),
        ("have_timecodes", ctypes.c_int32),
    ]


class _JxlBasicInfo(ctypes.Structure):
    """codestream_header.h JxlBasicInfo, libjxl 0.7 (204 bytes)."""

    _fields_ = [
        ("have_container", ctypes.c_int32),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("exponent_bits_per_sample", ctypes.c_uint32),
        ("intensity_target", ctypes.c_float),
        ("min_nits", ctypes.c_float),
        ("relative_to_max_display", ctypes.c_int32),
        ("linear_below", ctypes.c_float),
        ("uses_original_profile", ctypes.c_int32),
        ("have_preview", ctypes.c_int32),
        ("have_animation", ctypes.c_int32),
        ("orientation", ctypes.c_int32),
        ("num_color_channels", ctypes.c_uint32),
        ("num_extra_channels", ctypes.c_uint32),
        ("alpha_bits", ctypes.c_uint32),
        ("alpha_exponent_bits", ctypes.c_uint32),
        ("alpha_premultiplied", ctypes.c_int32),
        ("preview", _JxlPreviewHeader),
        ("animation", _JxlAnimationHeader),
        ("intrinsic_xsize", ctypes.c_uint32),
        ("intrinsic_ysize", ctypes.c_uint32),
        ("padding", ctypes.c_uint8 * 100),
    ]


class _JxlPixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int32),
        ("endianness", ctypes.c_int32),
        ("align", ctypes.c_size_t),
    ]


class _JxlColorEncoding(ctypes.Structure):
    _fields_ = [
        ("color_space", ctypes.c_int32),
        ("white_point", ctypes.c_int32),
        ("white_point_xy", ctypes.c_double * 2),
        ("primaries", ctypes.c_int32),
        ("primaries_red_xy", ctypes.c_double * 2),
        ("primaries_green_xy", ctypes.c_double * 2),
        ("primaries_blue_xy", ctypes.c_double * 2),
        ("transfer_function", ctypes.c_int32),
        ("gamma", ctypes.c_double),
        ("rendering_intent", ctypes.c_int32),
    ]


@lru_cache(maxsize=1)
def _lib():
    for name in ("libjxl.so.0.7", "libjxl.so", ctypes.util.find_library("jxl")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            _declare(lib)
        except (OSError, AttributeError):
            # AttributeError: a pre-0.7 libjxl missing the frame-settings
            # API — available() must report False, not crash the exporter
            continue
        return lib
    return None


def _declare(lib) -> None:
    P = ctypes.POINTER
    lib.JxlEncoderCreate.restype = ctypes.c_void_p
    lib.JxlEncoderCreate.argtypes = [ctypes.c_void_p]
    lib.JxlEncoderDestroy.argtypes = [ctypes.c_void_p]
    lib.JxlEncoderInitBasicInfo.argtypes = [P(_JxlBasicInfo)]
    lib.JxlEncoderSetBasicInfo.restype = ctypes.c_int
    lib.JxlEncoderSetBasicInfo.argtypes = [ctypes.c_void_p, P(_JxlBasicInfo)]
    lib.JxlColorEncodingSetToSRGB.argtypes = [P(_JxlColorEncoding), ctypes.c_int]
    lib.JxlEncoderSetColorEncoding.restype = ctypes.c_int
    lib.JxlEncoderSetColorEncoding.argtypes = [ctypes.c_void_p, P(_JxlColorEncoding)]
    lib.JxlEncoderFrameSettingsCreate.restype = ctypes.c_void_p
    lib.JxlEncoderFrameSettingsCreate.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.JxlEncoderSetFrameLossless.restype = ctypes.c_int
    lib.JxlEncoderSetFrameLossless.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlEncoderSetFrameDistance.restype = ctypes.c_int
    lib.JxlEncoderSetFrameDistance.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.JxlEncoderAddImageFrame.restype = ctypes.c_int
    lib.JxlEncoderAddImageFrame.argtypes = [
        ctypes.c_void_p, P(_JxlPixelFormat), ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.JxlEncoderCloseInput.argtypes = [ctypes.c_void_p]
    lib.JxlEncoderProcessOutput.restype = ctypes.c_int
    lib.JxlEncoderProcessOutput.argtypes = [
        ctypes.c_void_p, P(P(ctypes.c_uint8)), P(ctypes.c_size_t),
    ]
    lib.JxlDecoderCreate.restype = ctypes.c_void_p
    lib.JxlDecoderCreate.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderDestroy.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderSubscribeEvents.restype = ctypes.c_int
    lib.JxlDecoderSubscribeEvents.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlDecoderSetInput.restype = ctypes.c_int
    lib.JxlDecoderSetInput.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.JxlDecoderCloseInput.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderProcessInput.restype = ctypes.c_int
    lib.JxlDecoderProcessInput.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderGetBasicInfo.restype = ctypes.c_int
    lib.JxlDecoderGetBasicInfo.argtypes = [ctypes.c_void_p, P(_JxlBasicInfo)]
    lib.JxlDecoderImageOutBufferSize.restype = ctypes.c_int
    lib.JxlDecoderImageOutBufferSize.argtypes = [
        ctypes.c_void_p, P(_JxlPixelFormat), P(ctypes.c_size_t),
    ]
    lib.JxlDecoderSetImageOutBuffer.restype = ctypes.c_int
    lib.JxlDecoderSetImageOutBuffer.argtypes = [
        ctypes.c_void_p, P(_JxlPixelFormat), ctypes.c_void_p, ctypes.c_size_t,
    ]


def available() -> bool:
    """True when a loadable libjxl with the 0.7 ABI is present."""
    return _lib() is not None


def encode_jxl(arr: np.ndarray, quality: int = 90) -> bytes:
    """Encode an (H, W, 1|3|4) uint8 array to JPEG XL bytes (1 = grayscale).

    quality == 100 → mathematically lossless (matches the reference's
    LosslessConfig path); otherwise distance = max((100 - q)/10, 0.01)
    (export_processing.rs:415-416).
    """
    lib = _lib()
    if lib is None:
        raise ValueError("format 'jxl': libjxl shared library not found")
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError("encode_jxl expects (H, W, 1|3|4) uint8")
    h, w, c = arr.shape
    lossless = quality >= 100

    enc = lib.JxlEncoderCreate(None)
    if not enc:
        raise ValueError("JxlEncoderCreate failed")
    try:
        info = _JxlBasicInfo()
        lib.JxlEncoderInitBasicInfo(ctypes.byref(info))
        info.xsize, info.ysize = w, h
        info.bits_per_sample = 8
        info.num_color_channels = 1 if c == 1 else 3
        if c == 4:
            info.num_extra_channels = 1
            info.alpha_bits = 8
        # lossless requires encoding in the original (sRGB) profile
        info.uses_original_profile = 1 if lossless else 0
        if lib.JxlEncoderSetBasicInfo(enc, ctypes.byref(info)) != JXL_ENC_SUCCESS:
            raise ValueError("JxlEncoderSetBasicInfo rejected (ABI mismatch?)")
        ce = _JxlColorEncoding()
        lib.JxlColorEncodingSetToSRGB(ctypes.byref(ce), 1 if c == 1 else 0)
        if lib.JxlEncoderSetColorEncoding(enc, ctypes.byref(ce)) != JXL_ENC_SUCCESS:
            raise ValueError("JxlEncoderSetColorEncoding failed")
        fs = lib.JxlEncoderFrameSettingsCreate(enc, None)
        if lossless:
            lib.JxlEncoderSetFrameDistance(fs, 0.0)
            lib.JxlEncoderSetFrameLossless(fs, 1)
        else:
            lib.JxlEncoderSetFrameDistance(fs, max((100.0 - quality) / 10.0, 0.01))
        fmt = _JxlPixelFormat(c, JXL_TYPE_UINT8, JXL_NATIVE_ENDIAN, 0)
        if (
            lib.JxlEncoderAddImageFrame(
                fs, ctypes.byref(fmt), arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes
            )
            != JXL_ENC_SUCCESS
        ):
            raise ValueError("JxlEncoderAddImageFrame failed")
        lib.JxlEncoderCloseInput(enc)

        out = bytearray()
        chunk = (ctypes.c_uint8 * (1 << 20))()
        status = JXL_ENC_NEED_MORE_OUTPUT
        while status == JXL_ENC_NEED_MORE_OUTPUT:
            next_out = ctypes.cast(chunk, ctypes.POINTER(ctypes.c_uint8))
            avail = ctypes.c_size_t(len(chunk))
            status = lib.JxlEncoderProcessOutput(
                enc, ctypes.byref(next_out), ctypes.byref(avail)
            )
            if status not in (JXL_ENC_SUCCESS, JXL_ENC_NEED_MORE_OUTPUT):
                raise ValueError(f"JxlEncoderProcessOutput failed ({status})")
            out += bytes(chunk[: len(chunk) - avail.value])
        return bytes(out)
    finally:
        lib.JxlEncoderDestroy(enc)


def decode_jxl(data: bytes) -> np.ndarray:
    """Decode JPEG XL bytes to an (H, W, C) uint8 array."""
    lib = _lib()
    if lib is None:
        raise ValueError("format 'jxl': libjxl shared library not found")
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        raise ValueError("JxlDecoderCreate failed")
    try:
        lib.JxlDecoderSubscribeEvents(dec, JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE)
        lib.JxlDecoderSetInput(dec, data, len(data))
        lib.JxlDecoderCloseInput(dec)
        info = _JxlBasicInfo()
        buf = None
        fmt = None
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(dec, ctypes.byref(info)) != JXL_DEC_SUCCESS:
                    raise ValueError("JxlDecoderGetBasicInfo failed")
                # request the stream's own color channel count (grayscale
                # streams reject a 3-channel format); gray expands below
                c = (info.num_color_channels or 3) + (1 if info.alpha_bits else 0)
                fmt = _JxlPixelFormat(c, JXL_TYPE_UINT8, JXL_NATIVE_ENDIAN, 0)
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                if fmt is None:
                    raise ValueError("JXL decoder requested a buffer before basic info")
                size = ctypes.c_size_t()
                # unchecked failures here would leave the decoder returning
                # NEED_IMAGE_OUT_BUFFER forever — an infinite loop
                if lib.JxlDecoderImageOutBufferSize(
                    dec, ctypes.byref(fmt), ctypes.byref(size)
                ) != JXL_DEC_SUCCESS or not size.value:
                    raise ValueError("JxlDecoderImageOutBufferSize failed")
                buf = np.empty(size.value, np.uint8)
                if lib.JxlDecoderSetImageOutBuffer(
                    dec, ctypes.byref(fmt), buf.ctypes.data_as(ctypes.c_void_p), size.value
                ) != JXL_DEC_SUCCESS:
                    raise ValueError("JxlDecoderSetImageOutBuffer failed")
            elif status == JXL_DEC_FULL_IMAGE:
                pass  # frame complete; keep draining until SUCCESS
            elif status == JXL_DEC_SUCCESS:
                break
            else:
                raise ValueError(f"JxlDecoderProcessInput failed ({status})")
        if buf is None or fmt is None:
            raise ValueError("JXL stream contained no image")
        arr = buf.reshape(info.ysize, info.xsize, fmt.num_channels)
        if info.num_color_channels == 1:
            # expand grayscale to the documented RGB(+A) contract
            arr = np.concatenate(
                [np.repeat(arr[..., :1], 3, axis=-1), arr[..., 1:]], axis=-1
            )
        return arr
    finally:
        lib.JxlDecoderDestroy(dec)
