"""Canon CR3 container (ISO base media file) parsing (a copy of
`rapidraw_tpu/io/cr3.py`).

The reference decodes CR3 through rawler's crx codec (Cargo.toml:27,
formats.rs:14). The crx bitstream is an unpublished format known only
through reverse engineering; without that source available offline a
bit-exact decoder cannot be written responsibly, so this module parses
the CONTAINER completely — box tree, Canon CMT1/CMT2 metadata (TIFF IFDs
holding EXIF), sensor dimensions and track layout — and raises a precise
UnsupportedRawFormat naming the crx payload for the raw image itself.
Callers (thumbnails, library listing, culling) still get dimensions and
full EXIF out of CR3 files.

Layout (public ISO/IEC 14496-12 + Canon's documented uuid):
  ftyp('crx ') / moov [ uuid 85c0...(canon) [ CNCV, CCTP,
  CMT1 (TIFF: IFD0 EXIF), CMT2 (TIFF: ExifIFD), CMT3 (makernotes),
  CMT4 (GPS) ], trak x4 (thumb jpeg / preview jpeg / raw crx / meta) ]
  mdat(payloads).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

CANON_UUID = bytes.fromhex("85c0b687820f11e08111f4ce462b6a48")


@dataclass
class Cr3Info:
    width: int = 0
    height: int = 0
    exif: dict = field(default_factory=dict)
    preview_jpeg: bytes | None = None
    tracks: list = field(default_factory=list)  # (codec, w, h)
    # raw Canon makernote tags from CMT3 ({tag: value}) — WB/ColorData
    makernote: dict = field(default_factory=dict)
    # CRAW track details for the crx decode attempt
    raw_cmp1: bytes | None = None  # CMP1 box payload from the stsd entry
    raw_sample: tuple | None = None  # (offset, size) of the first sample


def _boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        (size,) = struct.unpack_from(">I", data, pos)
        btype = data[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield btype, pos + hdr, pos + size
        pos += size


def _tiff_tags(blob: bytes) -> dict:
    """Flatten one embedded TIFF's IFD0 (+ chained) into {tag: value}."""
    from rapidraw_tpu_torch.io.dng import _read_ifd

    if blob[:2] not in (b"II", b"MM"):
        return {}
    endian = "<" if blob[:2] == b"II" else ">"
    try:
        _, first = struct.unpack_from(endian + "HI", blob, 2)
    except struct.error:
        return {}
    out: dict = {}
    off = first
    seen = set()
    while off and off not in seen and off < len(blob):
        seen.add(off)
        try:
            entries, off = _read_ifd(blob, off, endian)
        except struct.error:
            break
        out.update(entries)
    return out


_EXIF_NAMES = {
    271: "Make", 272: "Model", 306: "DateTime", 315: "Artist",
    33434: "ExposureTime", 33437: "FNumber", 34855: "ISOSpeedRatings",
    36867: "DateTimeOriginal", 36868: "DateTimeDigitized",
    37386: "FocalLength", 42036: "LensModel", 274: "Orientation",
}


def _named(tags: dict) -> dict:
    out = {}
    for tag, name in _EXIF_NAMES.items():
        if tag in tags:
            v = tags[tag]
            if isinstance(v, (bytes, bytearray)):
                v = bytes(v).split(b"\0")[0].decode(errors="replace")
            elif isinstance(v, list) and len(v) == 1:
                v = v[0]
            out[name] = v
    return out


def _find_cmp1(data: bytes, start: int, end: int) -> bytes | None:
    """Locate the CMP1 box inside a CRAW sample entry.

    The entry's post-dimension fields vary between container writers, so
    the box is found by scanning for a plausible size+'CMP1' pair rather
    than assuming a fixed offset."""
    pos = data.find(b"CMP1", start, end)
    while pos != -1:
        if pos >= start + 4:
            (size,) = struct.unpack_from(">I", data, pos - 4)
            if 8 <= size <= end - (pos - 4):
                return data[pos + 4 : pos - 4 + size]
        pos = data.find(b"CMP1", pos + 4, end)
    return None


def parse_cr3_info(data: bytes) -> Cr3Info:
    """Walk the box tree; returns container metadata (no raw decode)."""
    info = Cr3Info()
    if len(data) < 16 or data[4:8] != b"ftyp":
        raise ValueError("not an ISO-BMFF file")

    def walk(start, end, depth=0, trak=None):
        for btype, b0, b1 in _boxes(data, start, end):
            if btype == b"trak":
                # track-scoped state so stsz/co64 pair with THIS trak's stsd
                t = {"codec": "", "cmp1": None, "sizes": [], "offsets": []}
                walk(b0, b1, depth + 1, trak=t)
                if t["codec"] == "CRAW" and t["cmp1"] and t["offsets"]:
                    size = t["sizes"][0] if t["sizes"] else 0
                    if size > 0:
                        info.raw_cmp1 = t["cmp1"]
                        info.raw_sample = (t["offsets"][0], size)
            elif btype in (b"moov", b"mdia", b"minf", b"stbl"):
                walk(b0, b1, depth + 1, trak=trak)
            elif btype == b"uuid" and data[b0 : b0 + 16] == CANON_UUID:
                walk(b0 + 16, b1, depth + 1, trak=trak)
            elif btype in (b"CMT1", b"CMT2", b"CMT3", b"CMT4"):
                tags = _tiff_tags(data[b0:b1])
                info.exif.update(_named(tags))
                if btype == b"CMT3":
                    info.makernote.update(tags)
            elif btype == b"stsz" and trak is not None:
                try:
                    _, uniform, count = struct.unpack_from(">III", data, b0)
                    if uniform:
                        trak["sizes"] = [uniform]
                    elif count:
                        trak["sizes"] = [
                            struct.unpack_from(">I", data, b0 + 12 + 4 * i)[0]
                            for i in range(min(count, 4))
                        ]
                except struct.error:
                    pass
            elif btype in (b"stco", b"co64") and trak is not None:
                try:
                    (count,) = struct.unpack_from(">I", data, b0 + 4)
                    fmt, step = (">I", 4) if btype == b"stco" else (">Q", 8)
                    trak["offsets"] = [
                        struct.unpack_from(fmt, data, b0 + 8 + step * i)[0]
                        for i in range(min(count, 4))
                    ]
                except struct.error:
                    pass
            elif btype == b"stsd":
                # sample description: version/flags u32, count u32, then
                # entries: size u32, codec 4cc, 6 reserved, data-ref u16,
                # then (video) 16 bytes pre-defined, w u16, h u16
                try:
                    (count,) = struct.unpack_from(">I", data, b0 + 4)
                    pos = b0 + 8
                    for _ in range(min(count, 8)):
                        (esize,) = struct.unpack_from(">I", data, pos)
                        codec = data[pos + 4 : pos + 8].decode("ascii", "replace")
                        if esize >= 0x24:
                            w, h = struct.unpack_from(">HH", data, pos + 0x20)
                        else:
                            w = h = 0
                        info.tracks.append((codec.strip(), w, h))
                        if codec == "CRAW":
                            if w * h > info.width * info.height:
                                info.width, info.height = w, h
                            if trak is not None:
                                trak["codec"] = "CRAW"
                                trak["cmp1"] = _find_cmp1(
                                    data, pos, pos + max(esize, 8)
                                )
                        pos += max(esize, 8)
                except struct.error:
                    pass
            elif btype == b"PRVW":
                # preview box: 4 unknown, u16 unknown, u16 w, u16 h, u16
                # unknown, u32 jpeg_size, jpeg bytes
                try:
                    jl = struct.unpack_from(">I", data, b0 + 12)[0]
                    jpeg = data[b0 + 16 : b0 + 16 + jl]
                    if jpeg[:2] == b"\xff\xd8":
                        info.preview_jpeg = jpeg
                except struct.error:
                    pass
            elif btype == b"uuid":
                walk(b0 + 16, b1, depth + 1)  # other uuid wrappers (PRVW lives in one)

    walk(0, len(data))
    return info


def _raw_file_from_crx(data: bytes, info: Cr3Info):
    """Attempt the crx lossless decode of the CRAW track; None when the
    track is absent or the CMP1 header is implausible, ValueError when the
    payload doesn't match the implemented lossless structure."""
    import numpy as np

    from rapidraw_tpu_torch.io import crx
    from rapidraw_tpu_torch.io.dng import RawFile
    from rapidraw_tpu_torch.io.makers import _CANON_WB_OFFSET, _shift_pattern

    if not (info.raw_cmp1 and info.raw_sample):
        return None
    cmp1 = crx.parse_cmp1(info.raw_cmp1)
    if cmp1 is None:
        return None
    off, size = info.raw_sample
    if off + size > len(data):
        raise ValueError("crx sample extends past end of file")
    mosaic = crx.decode_raw(data[off : off + size], cmp1)

    # active area + black level from the masked sensor border, Canon
    # SensorInfo (makernote 0xe0: [_, w, h, _, _, left, top, right, bottom])
    h, w = mosaic.shape
    top = left = 0
    black = 0.0
    si = info.makernote.get(0xE0)
    if si and len(si) >= 9:
        left, top, right, bottom = si[5], si[6], si[7], si[8]
        if 0 < left < w and 0 < top < h and left >= 4:
            black = float(np.mean(mosaic[top:, : left - 2]))
        if 0 < right <= w and 0 < bottom <= h and right > left and bottom > top:
            mosaic = mosaic[top : bottom + 1, left : right + 1]
        else:
            top = left = 0

    # as-shot WB from ColorData (makernote 0x4001), same layout as CR2
    wb = np.ones(3, np.float32)
    cd = info.makernote.get(0x4001)
    if cd:
        woff = _CANON_WB_OFFSET.get(len(cd), 63)
        if woff + 4 <= len(cd):
            r, g1, g2, b = (float(v) for v in cd[woff : woff + 4])
            g = (g1 + g2) / 2.0 or 1.0
            wb = np.array([r / g, 1.0, b / g], np.float32)

    orient = info.exif.get("Orientation", 1)
    return RawFile(
        cfa=mosaic,
        pattern=_shift_pattern(crx.cfa_pattern(cmp1), top, left),
        black_level=black,
        white_level=float((1 << cmp1.n_bits) - 1),
        wb=wb,
        xyz_to_cam=None,
        orientation=int(orient) if isinstance(orient, (int, float)) else 1,
    )


def parse_cr3(data: bytes):
    """Raw decode entry: parses the container, decodes the crx lossless
    payload when it matches the implemented structure (io/crx.py +
    csrc/host/crx.cc), and otherwise refuses precisely naming the payload
    (the embedded preview and metadata keep working either way)."""
    from rapidraw_tpu_torch.io.containers import UnsupportedRawFormat

    info = parse_cr3_info(data)
    detail = ""
    try:
        raw = _raw_file_from_crx(data, info)
        if raw is not None:
            return raw
    except ValueError as e:
        detail = f"; decode attempt: {e}"
    dims = f"{info.width}x{info.height}" if info.width else "unknown dims"
    raise UnsupportedRawFormat(
        "cr3",
        f"Canon crx raw payload ({dims}, tracks: "
        f"{[t[0] for t in info.tracks] or 'none'}) — bitstream did not match "
        "the implemented lossless crx structure; container metadata and the "
        f"embedded preview are available via parse_cr3_info{detail}",
    )
