"""Sigma X3F (Foveon) container parser — metadata + embedded previews.

Copy of `rapidraw_tpu/io/x3f.py` (host Python; no decode), whose only
port caller is the dimension query (`io/containers.raw_dimensions`).

An X3F file is "FOVb" + header, a sequence of sections, and a directory
("SECd") whose file offset sits in the last 4 bytes. Directory entries
point at image sections ("IMAG"/"IMA2", each with a type/format/dims
header) and a property list ("SECp", UTF-16 name/value pairs). Layout
implemented from the publicly documented x3f_tools format description.

The reference app routes .x3f to the rawler crate
(src-tauri/src/formats.rs:66, Cargo.toml:27), which has
no Foveon decoder — decode errors surface to the user. Here the container
is parsed for library metadata (dimensions, camera properties) and the
full-size embedded JPEG preview serves thumbnails/browse; RAW develop
refuses precisely (the Foveon color pipeline needs the CAMF calibration
sections, which are camera-encoded — see io/containers.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from rapidraw_tpu_torch.io.dng import DngError

_MAGIC = b"FOVb"
_SECD = b"SECd"
_SECI = b"SECi"
_SECP = b"SECp"

# image-section data formats (x3f_tools)
FORMAT_JPEG = 18
FORMAT_RAW_UNCOMPRESSED = 3
FORMAT_RAW_HUFFMAN = 6
FORMAT_RAW_TRUE = 30
FORMAT_RAW_TRUE2 = 35


@dataclass
class X3fInfo:
    version: tuple[int, int]
    columns: int
    rows: int
    rotation: int  # degrees clockwise: 0/90/180/270
    white_balance: str = ""
    props: dict = field(default_factory=dict)
    preview_jpeg: bytes | None = None
    raw_format: int | None = None  # data format code of the raw IMA2


def _parse_props(data: bytes, off: int, size: int) -> dict:
    """SECp: num_props (name_off, value_off) pairs into UTF-16LE data."""
    end = off + size
    if data[off : off + 4] != _SECP or off + 24 > end:
        return {}
    num, char_fmt, _reserved, total_len = struct.unpack_from("<IIII", data, off + 8)
    if char_fmt != 0 or num > 4096:  # 0 = CHAR16 (the only defined format)
        return {}
    table = off + 24
    strings = table + 8 * num
    if strings > end:
        return {}
    out: dict = {}
    max_chars = min(total_len, (end - strings) // 2)

    def read_str(char_off: int) -> str | None:
        if char_off >= max_chars:
            return None
        pos = strings + 2 * char_off
        raw = data[pos : strings + 2 * max_chars]
        s = raw.decode("utf-16-le", "replace")
        nul = s.find("\x00")
        return s if nul < 0 else s[:nul]

    for i in range(num):
        name_off, value_off = struct.unpack_from("<II", data, table + 8 * i)
        name = read_str(name_off)
        value = read_str(value_off)
        if name:
            out[name] = value or ""
    return out


def parse_x3f_info(data: bytes) -> X3fInfo:
    if len(data) < 40 or data[:4] != _MAGIC:
        raise DngError("not an X3F file (no FOVb magic)")
    (version,) = struct.unpack_from("<I", data, 4)
    major, minor = version >> 16, version & 0xFFFF
    # header: magic(4) version(4) unique_id(16) mark_bits(4) cols(4)
    # rows(4) rotation(4) [+ white-balance string for version >= 2.1]
    mark, cols, rows, rot = struct.unpack_from("<IIII", data, 24)
    del mark
    if not (0 < cols <= 65535 and 0 < rows <= 65535):
        raise DngError("implausible X3F dimensions")
    if rot not in (0, 90, 180, 270):
        rot = 0
    wb = ""
    if (major, minor) >= (2, 1) and len(data) >= 72:
        wb = data[40:72].split(b"\0")[0].decode("ascii", "replace")

    (dir_off,) = struct.unpack_from("<I", data, len(data) - 4)
    if dir_off + 12 > len(data) or data[dir_off : dir_off + 4] != _SECD:
        raise DngError("X3F directory not found")
    (n_entries,) = struct.unpack_from("<I", data, dir_off + 8)
    if n_entries > 64 or dir_off + 12 + 12 * n_entries > len(data):
        raise DngError("implausible X3F directory")

    info = X3fInfo(
        version=(major, minor), columns=int(cols), rows=int(rows),
        rotation=int(rot), white_balance=wb,
    )
    best_preview = b""
    for i in range(n_entries):
        off, size, typ = struct.unpack_from(
            "<II4s", data, dir_off + 12 + 12 * i
        )
        if off + size > len(data) or size < 8:
            raise DngError("X3F section out of range")
        if typ == b"PROP":
            info.props.update(_parse_props(data, off, size))
        elif typ in (b"IMAG", b"IMA2"):
            if data[off : off + 4] != _SECI or size < 28:
                continue
            _sec_ver, img_type, img_fmt, c, r, stride = struct.unpack_from(
                "<IIIIII", data, off + 4
            )
            del img_type, stride
            payload = data[off + 28 : off + size]
            if img_fmt == FORMAT_JPEG:
                # keep the LARGEST embedded JPEG (files carry a small
                # thumbnail and a full-size preview)
                if payload[:2] == b"\xff\xd8" and len(payload) > len(best_preview):
                    best_preview = payload
            elif img_fmt in (
                FORMAT_RAW_UNCOMPRESSED, FORMAT_RAW_HUFFMAN,
                FORMAT_RAW_TRUE, FORMAT_RAW_TRUE2,
            ):
                info.raw_format = int(img_fmt)
                if c and r:
                    info.columns, info.rows = int(c), int(r)
    if best_preview:
        info.preview_jpeg = best_preview
    return info


def x3f_dimensions(data: bytes) -> tuple[int, int]:
    info = parse_x3f_info(data)
    if info.rotation in (90, 270):
        return info.rows, info.columns
    return info.columns, info.rows


def x3f_exif_tags(data: bytes) -> dict:
    """Human-readable tag dict from the PROP section (library metadata)."""
    info = parse_x3f_info(data)
    out: dict = {}
    prop_map = {
        "CAMMANUF": "Make", "CAMMODEL": "Model", "CAMSERIAL": "SerialNumber",
        "SHUTTER": "ExposureTime", "APERTURE": "FNumber",
        "ISO": "ISOSpeedRatings", "FLENGTH": "FocalLength",
        "LENSARANGE": "LensInfo", "TIME": "DateTime",
        "FIRMVERS": "Software",
    }
    for k, v in info.props.items():
        name = prop_map.get(k)
        if name and v:
            out[name] = str(v)[:500]
    return out
