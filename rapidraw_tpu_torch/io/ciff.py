"""Canon CIFF (.crw) container parser — metadata + embedded previews.

Copy of `rapidraw_tpu/io/ciff.py` (host Python; no decode), whose only
port caller is the dimension query (`io/containers.raw_dimensions`).

A CRW file is a 26-byte header ("II"/"MM", header length, "HEAPCCDR")
followed by a heap: records live anywhere in the heap, and the last 4
bytes of the heap hold the offset of a directory of 10-byte records
(u16 type, u32 length, u32 offset). The type word encodes storage
location (bits 0xc000: 0 = in heap, 0x4000 = the 8 length/offset bytes
ARE the value) and data kind (bits 0x3800: 0x2800/0x3000 = a sub-heap to
recurse into). Layout implemented from the publicly documented CIFF
specification (dcraw parse_ciff semantics).

The reference app routes .crw to the rawler crate
(src-tauri/src/formats.rs:12, Cargo.toml:27), which has
no CIFF decoder — decode errors surface to the user. Here the container
is parsed for library metadata (sensor dimensions, make/model) and the
embedded JPEG preview serves thumbnails/browse; the compressed RAW
develop refuses precisely (the bitstream needs Canon's fixed decoder
tables, selected by tag 0x1835 — see io/containers.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from rapidraw_tpu_torch.io.dng import DngError

# record type id (type & 0x3fff) of interest
_TAG_RAW = 0x2005
_TAG_JPEG = 0x2007  # full-size preview JPEG
_TAG_THUMB = 0x2008  # thumbnail JPEG
_TAG_SENSOR = 0x1031  # u16[8]: [1]=width, [2]=height
_TAG_MAKE_MODEL = 0x080A  # two NUL-terminated strings
_TAG_DECODER = 0x1835  # decoder table selector (compressed bitstream)
_TAG_CAPTURED_TIME = 0x180E

_SUBHEAP_KINDS = (0x2800, 0x3000)


@dataclass
class CrwInfo:
    width: int = 0
    height: int = 0
    make: str = ""
    model: str = ""
    preview_jpeg: bytes | None = None
    thumbnail_jpeg: bytes | None = None
    decoder_table: int | None = None
    raw_offset: int = 0
    raw_length: int = 0


def _walk_heap(data: bytes, e: str, start: int, length: int, info: CrwInfo,
               depth: int = 0) -> None:
    if depth > 6 or length < 4 or start + length > len(data):
        return
    (dir_off,) = struct.unpack_from(e + "I", data, start + length - 4)
    pos = start + dir_off
    if pos + 2 > start + length:
        raise DngError("CIFF directory offset out of range")
    (count,) = struct.unpack_from(e + "H", data, pos)
    pos += 2
    if count > 1024 or pos + 10 * count > len(data):
        raise DngError("implausible CIFF directory")
    for _ in range(count):
        typ, rec_len, rec_off = struct.unpack_from(e + "HII", data, pos)
        pos += 10
        storage = typ & 0xC000
        kind = typ & 0x3800
        tag = typ & 0x3FFF
        if storage & 0x4000:
            # dcraw: ANY type with bit 0x4000 set stores its value in the
            # 8 length/offset bytes of the record (so 0xC000-class records
            # — e.g. a decoder-table or timestamp variant — are read, not
            # silently skipped)
            if tag == _TAG_DECODER:
                info.decoder_table = int(rec_len)
            continue
        if storage != 0x0000:
            continue
        abs_off = start + rec_off
        if abs_off + rec_len > len(data):
            raise DngError("CIFF record out of range")
        if kind in _SUBHEAP_KINDS:
            _walk_heap(data, e, abs_off, rec_len, info, depth + 1)
            continue
        if tag == _TAG_JPEG:
            blob = data[abs_off : abs_off + rec_len]
            if blob[:2] == b"\xff\xd8":
                info.preview_jpeg = blob
        elif tag == _TAG_THUMB:
            blob = data[abs_off : abs_off + rec_len]
            if blob[:2] == b"\xff\xd8":
                info.thumbnail_jpeg = blob
        elif tag == _TAG_SENSOR and rec_len >= 6:
            vals = struct.unpack_from(e + "HHH", data, abs_off)
            info.width, info.height = int(vals[1]), int(vals[2])
        elif tag == _TAG_MAKE_MODEL:
            parts = data[abs_off : abs_off + rec_len].split(b"\0")
            if parts:
                info.make = parts[0].decode("ascii", "replace").strip()
            if len(parts) > 1:
                info.model = parts[1].decode("ascii", "replace").strip()
        elif tag == _TAG_RAW:
            info.raw_offset, info.raw_length = int(abs_off), int(rec_len)


def parse_crw_info(data: bytes) -> CrwInfo:
    if len(data) < 30 or data[6:14] != b"HEAPCCDR":
        raise DngError("not a CRW file (no HEAPCCDR signature)")
    e = "<" if data[:2] == b"II" else ">"
    (hlen,) = struct.unpack_from(e + "I", data, 2)
    if not (14 <= hlen <= 0x10000) or hlen >= len(data):
        raise DngError("implausible CIFF header length")
    info = CrwInfo()
    _walk_heap(data, e, hlen, len(data) - hlen, info)
    return info


def crw_dimensions(data: bytes) -> tuple[int, int]:
    info = parse_crw_info(data)
    if not (info.width and info.height):
        raise DngError("CRW missing sensor dimensions")
    return info.width, info.height


def crw_exif_tags(data: bytes) -> dict:
    info = parse_crw_info(data)
    out: dict = {}
    if info.make:
        out["Make"] = info.make
    if info.model:
        out["Model"] = info.model
    return out
