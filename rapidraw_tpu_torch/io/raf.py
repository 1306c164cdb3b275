"""Fujifilm RAF container parser (a copy of `rapidraw_tpu/io/raf.py`).

The reference decodes RAF through rawler (Cargo.toml:27); this is a fresh
parser of the publicly documented container layout (libopenraw/exiftool
FujiFilm.pm):

  bytes 0-15   "FUJIFILMCCD-RAW " magic
  0x54/0x58    u32 BE jpeg offset / length (embedded preview)
  0x5C/0x60    u32 BE CFA header offset / length
  0x64/0x68    u32 BE CFA data offset / length

CFA header: u32 BE record count, then records of (u16 BE tag, u16 BE
size, payload). Tags used here: 0x0100 raw height/width (u16 pairs),
0x0131 X-Trans 6x6 layout (36 bytes of 0/1/2), 0x2ff0 WB coefficients
(G R B ... u16). CFA data is either a bare little-endian 16-bit sample
block or an embedded TIFF whose FujiIFD tags (0xf001-0xf00a, exiftool
FujiIFD) carry dims/strip/black level; Fuji's lossless compression is
detected and refused with an actionable error.
"""

from __future__ import annotations

import struct

import numpy as np

from rapidraw_tpu_torch.io.dng import DngError, RawFile, _collect_ifds

_MAGIC = b"FUJIFILMCCD-RAW "

# FujiIFD (embedded TIFF) tags, exiftool FujiFilm::IFD
_F_WIDTH = 0xF001
_F_HEIGHT = 0xF002
_F_BPS = 0xF003
_F_STRIP_OFF = 0xF007
_F_STRIP_CNT = 0xF008
_F_BLACK = 0xF00A
_F_WB = 0xF00E


def _cfa_records(data: bytes, off: int, length: int) -> dict:
    out: dict = {}
    try:
        (count,) = struct.unpack_from(">I", data, off)
        pos = off + 4
        for _ in range(min(count, 512)):
            tag, size = struct.unpack_from(">HH", data, pos)
            out[tag] = data[pos + 4 : pos + 4 + size]
            pos += 4 + size
            if pos > off + length:
                break
    except struct.error:
        pass
    return out


def parse_raf(data: bytes) -> RawFile:
    from rapidraw_tpu_torch.io.containers import UnsupportedRawFormat
    from rapidraw_tpu_torch.raw.xtrans import DEFAULT_XTRANS

    if data[:16] != _MAGIC:
        raise DngError("not a RAF file")
    try:
        cfa_hdr_off, cfa_hdr_len = struct.unpack_from(">II", data, 0x5C)
        cfa_off, cfa_len = struct.unpack_from(">II", data, 0x64)
    except struct.error as e:
        raise DngError("truncated RAF directory") from e

    recs = _cfa_records(data, cfa_hdr_off, cfa_hdr_len) if cfa_hdr_off else {}

    height = width = 0
    if 0x0100 in recs and len(recs[0x0100]) >= 4:
        height, width = struct.unpack_from(">HH", recs[0x0100], 0)

    xtrans = None
    if 0x0131 in recs and len(recs[0x0131]) >= 36:
        vals = np.frombuffer(recs[0x0131][-36:], np.uint8).astype(np.int32)
        if set(vals.tolist()) <= {0, 1, 2}:
            xtrans = vals.reshape(6, 6)
    if xtrans is None:
        xtrans = DEFAULT_XTRANS

    wb = np.ones(3, np.float32)
    if 0x2FF0 in recs and len(recs[0x2FF0]) >= 8:
        g, r, b = struct.unpack_from(">HHH", recs[0x2FF0], 0)[:3]
        if g and r and b:
            wb = np.array([r / g, 1.0, b / g], np.float32)

    black = 0.0
    bits = 14
    plane = None

    if cfa_off + 4 <= len(data) and data[cfa_off : cfa_off + 2] in (b"II", b"MM"):
        # embedded TIFF (newer bodies)
        endian = "<" if data[cfa_off : cfa_off + 2] == b"II" else ">"
        sub = data[cfa_off : cfa_off + cfa_len if cfa_len else len(data)]
        try:
            first = struct.unpack_from(endian + "HI", sub, 2)[1]
            ifds = _collect_ifds(sub, endian, first)
        except struct.error as e:
            raise DngError("malformed RAF embedded TIFF") from e
        fifd = None
        for i in ifds:
            if _F_STRIP_OFF in i and _F_WIDTH in i and _F_HEIGHT in i:
                fifd = i
                break
        if fifd is None:
            raise DngError("no FujiIFD raw pointers in RAF")
        width = fifd[_F_WIDTH][0]
        height = fifd[_F_HEIGHT][0]
        bits = fifd.get(_F_BPS, [14])[0]
        if not (8 <= bits <= 16):
            raise DngError(f"implausible RAF BitsPerSample {bits}")
        offs = fifd[_F_STRIP_OFF]
        off = offs[0]
        cnts = fifd.get(_F_STRIP_CNT, [len(sub) - off])
        cnt = sum(cnts)
        if len(offs) > 1:
            # multiple strips: only a contiguous layout reads correctly
            # from the first offset; anything else must refuse, not decode
            # garbage rows
            contiguous = all(
                offs[i + 1] == offs[i] + cnts[i]
                for i in range(min(len(offs), len(cnts)) - 1)
            ) and len(cnts) >= len(offs)
            if not contiguous:
                raise UnsupportedRawFormat(
                    "raf", "non-contiguous multi-strip RAF layout is not "
                    "supported"
                )
        blk = fifd.get(_F_BLACK)
        if blk:
            black = float(np.mean(blk))
        fwb = fifd.get(_F_WB)
        if fwb and len(fwb) >= 3 and all(v > 0 for v in fwb[:3]):
            g, r, b = fwb[0], fwb[1], fwb[2]
            wb = np.array([r / g, 1.0, b / g], np.float32)
        if cnt < width * height * 2:
            raise UnsupportedRawFormat(
                "raf", "Fujifilm lossless-compressed RAF is not supported; "
                "uncompressed RAF decodes"
            )
        plane = np.frombuffer(
            sub, endian + "u2", count=width * height, offset=off
        ).reshape(height, width)
    else:
        if not (width and height):
            raise DngError("RAF CFA dimensions missing (tag 0x0100)")
        if cfa_len and cfa_len < width * height * 2:
            raise UnsupportedRawFormat(
                "raf", "Fujifilm compressed RAF is not supported; "
                "uncompressed RAF decodes"
            )
        plane = np.frombuffer(
            data, "<u2", count=width * height, offset=cfa_off
        ).reshape(height, width)

    return RawFile(
        cfa=plane.astype(np.uint16, copy=False),
        pattern="RGGB",  # unused for X-Trans
        black_level=black,
        white_level=float((1 << bits) - 1),
        wb=wb,
        xyz_to_cam=None,
        orientation=1,
        xtrans=np.asarray(xtrans, np.int32),
    )


def raf_dimensions(data: bytes) -> tuple[int, int]:
    """(width, height) from the CFA header records / FujiIFD — metadata
    only, no sample decode (dimension queries, lib.rs:232-238)."""
    if data[:16] != _MAGIC:
        raise DngError("not a RAF file")
    try:
        cfa_hdr_off, cfa_hdr_len = struct.unpack_from(">II", data, 0x5C)
        cfa_off, cfa_len = struct.unpack_from(">II", data, 0x64)
    except struct.error as e:
        raise DngError("truncated RAF directory") from e
    recs = _cfa_records(data, cfa_hdr_off, cfa_hdr_len) if cfa_hdr_off else {}
    # embedded-TIFF CFA block FIRST: parse_raf decodes the FujiIFD shape
    # for these files, so the dimension query must agree with the raster
    # it will actually produce (the 0x0100 record can carry the sensor
    # full size instead)
    if cfa_off and data[cfa_off : cfa_off + 2] in (b"II", b"MM"):
        endian = "<" if data[cfa_off : cfa_off + 2] == b"II" else ">"
        sub = data[cfa_off : cfa_off + cfa_len if cfa_len else len(data)]
        try:
            first = struct.unpack_from(endian + "HI", sub, 2)[1]
            ifds = _collect_ifds(sub, endian, first)
        except struct.error as e:
            raise DngError("malformed RAF embedded TIFF") from e
        for i in ifds:
            if _F_WIDTH in i and _F_HEIGHT in i:
                return int(i[_F_WIDTH][0]), int(i[_F_HEIGHT][0])
    if 0x0100 in recs and len(recs[0x0100]) >= 4:
        height, width = struct.unpack_from(">HH", recs[0x0100], 0)
        if width and height:
            return int(width), int(height)
    raise DngError("RAF missing raw dimensions")
