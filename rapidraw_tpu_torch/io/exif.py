"""EXIF engine of the export: read, and copy through with the GPS strip.

Port of `rapidraw_tpu/io/exif.py` (exif_processing.rs): the metadata read
(`read_exif_tags`, `read_exif_bytes`, `get_creation_date`,
`effective_exif_tags`) and the export write-through (`copy_exif`: GPS
stripped, Orientation reset to 1, spliced into JPEG / PNG / WebP files or
merged into a 16-bit TIFF's IFD0).

The JAX package reads and rewrites EXIF through PIL. This module keeps no
PIL: a TIFF directory codec of its own reads, types and serializes tags as
PIL's `ImageFileDirectory_v2` and `Image.Exif` do (which tags load, the
value each holds, the type a rewritten tag takes, the layout of a
re-serialized payload), on the tag tables of io/exif_tags.py. A source is
read where PIL opens it: TIFF-based files whose first frame PIL's TIFF
reader accepts, JPEG, PNG and WebP, and CR3 through io/cr3.py. The RAW
containers whose first IFD is the CFA itself, RAF, ORF, RW2, MRW and IIQ
give no EXIF there, so none here either. X3F and CRW (read through their
JAX-only parsers) give none yet.
"""

from __future__ import annotations

import json
import mmap
import re
import struct
from fractions import Fraction
from pathlib import Path

from rapidraw_tpu_torch.io import exif_tags as tables

_EXIF_IFD_TAG = 0x8769
_GPS_IFD_TAG = 0x8825
_INTEROP_IFD_TAG = 0xA005
_MAX_VALUE_LEN = 500
RREXIF_EXT = ".rrexif"

BYTE, ASCII, SHORT, LONG, RATIONAL = 1, 2, 3, 4, 5
UNDEFINED, SIGNED_SHORT, SIGNED_LONG, SIGNED_RATIONAL, DOUBLE = 7, 8, 9, 10, 12
_FORMATS = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d", 13: "L", 16: "Q"}
_UNIT = {1: 1, 2: 1, 5: 8, 7: 1, 10: 8, **{t: struct.calcsize("<" + f) for t, f in _FORMATS.items()}}
_MAX_IMAGE_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # PIL's decompression-bomb limit
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a")


class Rational:
    """A TIFF rational as PIL's IFDRational holds it: numerator and
    denominator as given, the value as a Fraction (NaN for a zero
    denominator), printed as the float of that value."""

    __slots__ = ("numerator", "denominator", "value")

    def __init__(self, value, denominator=1):
        if isinstance(value, Rational):
            self.numerator, self.denominator, self.value = (
                value.numerator, value.denominator, value.value)
            return
        if isinstance(value, Fraction):
            self.numerator, self.denominator = value.numerator, value.denominator
        else:
            self.numerator, self.denominator = value, denominator
        if denominator == 0:
            self.value = float("nan")
        elif denominator == 1:
            self.value = Fraction(value)
        elif int(value) == value:
            self.value = Fraction(int(value), denominator)
        else:
            self.value = Fraction(value / denominator)

    def __repr__(self) -> str:
        return str(float(self.value))

    def __float__(self) -> float:
        return float(self.value)

    def __int__(self) -> int:
        return int(self.value)

    def __lt__(self, other) -> bool:
        return self.value < other

    def limit(self, max_denominator: int) -> tuple:
        if self.denominator == 0:
            return self.numerator, self.denominator
        f = self.value.limit_denominator(max_denominator)
        return f.numerator, f.denominator


def _lookup(tag: int, group: int | None):
    """(type, count, enum) PIL declares for `tag` in `group`, or
    (None, None, {}) for an undeclared one."""
    if group is not None:
        info, enum = tables.GROUP_INFO.get(group, {}).get(tag), {}
    else:
        info, enum = tables.TAG_INFO.get(tag), tables.TAG_ENUMS.get(tag, {})
    return (info[0], info[1], enum) if info else (None, None, {})


def _is_scalar(value) -> bool:
    return isinstance(value, (int, float, Fraction, Rational, bytes, str))


def _decode(typ: int, data: bytes, endian: str):
    """PIL's loader of type `typ` on the tag's bytes."""
    if typ in (BYTE, UNDEFINED):
        return bytes(data)
    if typ == ASCII:
        if data.endswith(b"\0"):
            data = data[:-1]
        return bytes(data).decode("latin-1", "replace")
    if typ in (RATIONAL, SIGNED_RATIONAL):
        vals = struct.unpack(f"{endian}{len(data) // 4}{'L' if typ == RATIONAL else 'l'}", data)
        return tuple(Rational(a, b) for a, b in zip(vals[::2], vals[1::2]))
    return struct.unpack(f"{endian}{len(data) // _UNIT[typ]}{_FORMATS[typ]}", data)


def _settle(tag: int, typ: int, value, group: int | None):
    """The value PIL stores for `tag` of type `typ` (ImageFileDirectory_v2.
    _setitem): one element where the tag is declared single, is BYTE or is
    undeclared with one value, else a tuple; a dict is a nested IFD."""
    _, length, enum = _lookup(tag, group)
    values = [value] if _is_scalar(value) else value
    if typ == UNDEFINED:
        values = [v.encode("ascii", "replace") if isinstance(v, str) else v for v in values]
    elif typ == RATIONAL:
        values = [float(v) if isinstance(v, int) else v for v in values]
    is_ifd = typ == LONG and isinstance(values, dict)
    if is_ifd:
        return values
    values = tuple(enum.get(v, v) if isinstance(v, str) and enum else v for v in values)
    if length == 1 or typ == BYTE or (length is None and len(values) == 1):
        return values[0]
    return values


def _infer_type(value) -> int:
    """The type PIL gives an undeclared tag from its value."""
    values = [value] if _is_scalar(value) else value
    if all(isinstance(v, Rational) for v in values):
        return SIGNED_RATIONAL if any(v < 0 for v in values) else RATIONAL
    if all(isinstance(v, int) for v in values):
        if all(0 <= v < 2**16 for v in values):
            return SHORT
        if all(-(2**15) < v < 2**15 for v in values):
            return SIGNED_SHORT
        return LONG if all(v >= 0 for v in values) else SIGNED_LONG
    if all(isinstance(v, float) for v in values):
        return DOUBLE
    if all(isinstance(v, str) for v in values):
        return ASCII
    if all(isinstance(v, bytes) for v in values):
        return BYTE
    return UNDEFINED


def _fixup(value):
    """Image.Exif's unwrapping of one-element tuples."""
    if isinstance(value, tuple) and len(value) == 1:
        return value[0]
    return value


class _Short(Exception):
    pass


def _load_dir(buf, offset: int, endian: str) -> tuple[dict, int | None]:
    """PIL's ImageFileDirectory_v2.load of the directory at `offset`:
    tag -> (type, bytes). Entries of an unknown type or with short data are
    skipped; a short read ends the directory with what was read."""
    if offset < 0:
        raise ValueError("negative seek value")
    entries: dict = {}
    pos = offset

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(buf):
            raise _Short
        out = buf[pos:pos + n]
        pos += n
        return out

    try:
        (count,) = struct.unpack(endian + "H", take(2))
        for _ in range(count):
            tag, typ, n, data = struct.unpack(endian + "HHL4s", take(12))
            unit = _UNIT.get(typ)
            if unit is None:
                continue
            size = n * unit
            if size > 4:
                (at,) = struct.unpack(endian + "L", data)
                data = bytes(buf[at:at + size])
            else:
                data = data[:size]
            if len(data) != size or not data:
                continue
            entries[tag] = (typ, data)
        (nxt,) = struct.unpack(endian + "L", take(4))
    except _Short:
        return entries, None
    return entries, nxt


def _limit_rational(val, max_val: int) -> tuple:
    inv = abs(val.value if isinstance(val, Rational) else val) > 1
    if inv:
        val = 1 / (val.value if isinstance(val, Rational) else val)
    n_d = Rational(val).limit(max_val)
    return n_d[::-1] if inv else n_d


def _limit_signed_rational(val, max_val: int, min_val: int) -> tuple:
    # Fraction() of an IFDRational keeps its numerator and denominator as
    # given, unreduced
    if isinstance(val, Rational):
        n_d = val.numerator, val.denominator
    else:
        frac = Fraction(val)
        n_d = frac.numerator, frac.denominator
    if min(float(i) for i in n_d) < min_val:
        n_d = _limit_rational(val, abs(min_val))
    f = tuple(float(i) for i in n_d)
    if max(f) > max_val:
        n_d = _limit_rational(f[0] / f[1], max_val)
    return n_d


def _write(typ: int, values: tuple, endian: str) -> bytes:
    """PIL's writer of type `typ` on the stored values."""
    if typ in (BYTE, ASCII, UNDEFINED):
        if len(values) != 1:
            raise TypeError(f"type {typ} takes one value, got {len(values)}")
        (v,) = values
        if typ == ASCII:
            if isinstance(v, int):
                v = str(v)
            if isinstance(v, str):
                v = v.encode("ascii", "replace")
            if not isinstance(v, bytes):
                raise TypeError(f"cannot write {type(v).__name__} as ASCII")
            return v + b"\0"
        if isinstance(v, Rational):
            v = int(v)
        if isinstance(v, int):
            v = bytes((v,)) if typ == BYTE else str(v).encode("ascii", "replace")
        if not isinstance(v, bytes):
            raise TypeError(f"cannot write {type(v).__name__} as type {typ}")
        return v
    if typ == RATIONAL:
        return b"".join(struct.pack(endian + "2L", *_limit_rational(v, 2**32 - 1))
                        for v in values)
    if typ == SIGNED_RATIONAL:
        return b"".join(struct.pack(endian + "2l", *_limit_signed_rational(v, 2**31 - 1, -(2**31)))
                        for v in values)
    return struct.pack(f"{endian}{len(values)}{_FORMATS[typ]}", *values)


class TiffDir:
    """A directory being written, as a fresh ImageFileDirectory_v2: each
    tag typed on its first set (PIL's declared type, else inferred from the
    value), serialized in tag order with PIL's layout (values past 4 bytes
    after the entries, each padded to an even length; a dict as a nested
    directory there; StripOffsets moved past the data)."""

    def __init__(self, endian: str = "<", group: int | None = None):
        self.endian, self.group = endian, group
        self.types: dict = {}
        self.values: dict = {}

    def __setitem__(self, tag: int, value) -> None:
        if tag not in self.types:
            declared = _lookup(tag, self.group)[0]
            self.types[tag] = declared if declared else _infer_type(value)
        self.values[tag] = _settle(tag, self.types[tag], value, self.group)

    def tobytes(self, offset: int = 0) -> bytes:
        e = self.endian
        offset += 2 + len(self.values) * 12 + 4
        entries = []
        strip = None
        for tag, value in sorted(self.values.items()):
            if tag == 273:
                strip = len(entries)
            typ = self.types[tag]
            is_ifd = typ == LONG and isinstance(value, dict)
            if is_ifd:
                sub = TiffDir(e, group=tag)
                for k, v in value.items():
                    sub[k] = v
                data = sub.tobytes(offset)
                count = 1
            else:
                vals = value if isinstance(value, tuple) else (value,)
                data = _write(typ, vals, e)
                count = len(data) if typ in (BYTE, ASCII, UNDEFINED) else len(vals)
            if len(data) <= 4:
                entries.append([tag, typ, count, data.ljust(4, b"\0"), b""])
            else:
                entries.append([tag, typ, count, struct.pack(e + "L", offset), data])
                offset += (len(data) + 1) // 2 * 2
        if strip is not None:
            tag, typ, count, value, data = entries[strip]
            if data:
                vals = tuple(v + offset for v in _decode(typ, data, e))
                entries[strip][4] = _write(typ, vals, e)
            else:
                entries[strip][3] = struct.pack(e + "L", struct.unpack(e + "L", value)[0] + offset)
        out = bytearray(struct.pack(e + "H", len(entries)))
        for tag, typ, count, value, _ in entries:
            out += struct.pack(e + "HHL", tag, typ, count) + value
        out += b"\0\0\0\0"
        for *_, data in entries:
            out += data + (b"\0" if len(data) & 1 else b"")
        return bytes(out)


class Exif:
    """PIL's Image.Exif over a TIFF structure: IFD0's tags decoded on first
    access, the Exif, GPS and Interop directories on request, and
    `tobytes` re-serializing IFD0 with those directories nested, as PIL's
    does (types re-declared, the layout recomputed)."""

    def __init__(self, buf=b"", ifd0: int | None = None, endian: str = ">"):
        # a fresh Exif (no data) serializes big-endian, as PIL's does
        self.buf, self.endian = buf, endian
        self._raw: dict = {}
        self._data: dict = {}
        self._ifds: dict = {}
        self.empty = ifd0 is None
        if ifd0 is not None:
            self._raw, _ = _load_dir(buf, ifd0, endian)

    @classmethod
    def from_payload(cls, data: bytes) -> "Exif":
        """Image.Exif().load(data): a TIFF payload, with or without the
        'Exif\\0\\0' prefix."""
        while data and data.startswith(b"Exif\x00\x00"):
            data = data[6:]
        if not data:
            return cls()
        head = data[:8]
        endian = {b"II": "<", b"MM": ">"}.get(bytes(head[:2]))
        if endian is None or head[:4] not in _TIFF_PREFIXES:
            raise SyntaxError(f"not a TIFF file (header {bytes(head)!r} not valid)")
        if len(head) < 8:
            raise struct.error("truncated TIFF header")
        return cls(data, struct.unpack(endian + "L", head[4:8])[0], endian)

    def keys(self) -> set:
        # PIL's Exif.__iter__: set(_data), then its directory's keys added
        # one by one from `set(_tagdata) | set(_tags_v2)`. The same set
        # operations give the same iteration order, so a tag dict (and the
        # sidecar written from it) lists its keys as PIL's does
        keys = set(self._data)
        keys.update(iter(set(self._raw) | set()))
        return keys

    def __contains__(self, tag) -> bool:
        return tag in self._data or tag in self._raw

    def __len__(self) -> int:
        return len(self.keys())

    def __getitem__(self, tag: int):
        if tag in self._raw and tag not in self._data:
            typ, data = self._raw.pop(tag)
            self._data[tag] = _fixup(_settle(tag, typ, _decode(typ, data, self.endian), None))
        return self._data[tag]

    def get(self, tag: int, default=None):
        return self[tag] if tag in self else default

    def __setitem__(self, tag: int, value) -> None:
        self._raw.pop(tag, None)
        self._data[tag] = value

    def __delitem__(self, tag: int) -> None:
        if tag in self._raw:
            del self._raw[tag]
        else:
            del self._data[tag]
            self._ifds.pop(tag, None)

    def items(self) -> dict:
        return {tag: self[tag] for tag in self.keys()}

    def _ifd_dict(self, offset, group: int) -> dict | None:
        if self.empty:
            raise AttributeError("this Exif holds no TIFF data to read a directory from")
        if not isinstance(offset, int):
            return None
        entries, _ = _load_dir(self.buf, offset, self.endian)
        # PIL's dict(ImageFileDirectory_v2): keys in the order of
        # set(_tagdata) | set(_tags_v2)
        out = {}
        for tag in set(entries) | set():
            typ, data = entries[tag]
            out[tag] = _fixup(_settle(tag, typ, _decode(typ, data, self.endian), group))
        return out

    def get_ifd(self, tag: int) -> dict:
        if tag not in self._ifds:
            if tag in (_EXIF_IFD_TAG, _GPS_IFD_TAG):
                offset = self.get(tag)
                if offset is not None:
                    ifd = self._ifd_dict(offset, tag)
                    if ifd is not None:
                        self._ifds[tag] = ifd
            elif tag == _INTEROP_IFD_TAG:
                if _EXIF_IFD_TAG not in self._ifds:
                    self.get_ifd(_EXIF_IFD_TAG)
                ifd = self._ifd_dict(self._ifds[_EXIF_IFD_TAG][tag], tag)
                if ifd is not None:
                    self._ifds[tag] = ifd
        return self._ifds.setdefault(tag, {})

    def tobytes(self) -> bytes:
        """Image.Exif.tobytes(): 'Exif\\0\\0' + the TIFF header + IFD0."""
        head = (b"II\x2a\x00" + struct.pack("<L", 8) if self.endian == "<"
                else b"MM\x00\x2a" + struct.pack(">L", 8))
        ifd = TiffDir(self.endian)
        for tag, sub in self._ifds.items():
            if tag not in self:
                ifd[tag] = sub
        for tag in self.keys():
            value = self[tag]
            if tag in (_EXIF_IFD_TAG, _GPS_IFD_TAG) and not isinstance(value, dict):
                value = self.get_ifd(tag)
                if (tag == _EXIF_IFD_TAG and _INTEROP_IFD_TAG in value
                        and not isinstance(value[_INTEROP_IFD_TAG], dict)):
                    value = dict(value)
                    value[_INTEROP_IFD_TAG] = self.get_ifd(_INTEROP_IFD_TAG)
            ifd[tag] = value
        return b"Exif\x00\x00" + head + ifd.tobytes(8)


# ---- which files PIL opens, and their EXIF ---------------------------------

def _tiff_first_frame_opens(entries: dict, endian: str) -> bool:
    """TiffImageFile._setup's checks on the first frame: PIL opens the file
    only if they all pass."""
    def tag(t, default=None):
        if t not in entries:
            return default
        typ, data = entries[t]
        return _settle(t, typ, _decode(typ, data, endian), None)

    if 0xBC01 in entries:
        return False
    compression = tag(259, 1)
    if compression not in tables.COMPRESSIONS:
        return False
    photo = 6 if compression == 6 else tag(262, 0)
    fillorder = tag(266, 1)
    xsize, ysize = tag(256), tag(257)
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        return False
    sample_format = tag(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = tag(258, (1,))
    extra = tag(338, ())
    spp = tag(277, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp > max(len(k[4]) for k in tables.OPEN_LAYOUTS):
        return False
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        return False
    prefix = b"II" if endian == "<" else b"MM"
    if (prefix, photo, sample_format, fillorder, bps, extra) not in tables.OPEN_LAYOUTS:
        return False
    if compression == 1:
        if 273 not in entries:
            if 324 not in entries:
                return False
            if not isinstance(tag(322), int) or not isinstance(tag(323), int):
                return False
    elif fillorder == 2 and (prefix, photo, sample_format, 1, bps, extra) not in tables.OPEN_LAYOUTS:
        return False
    return max(1, xsize) * max(1, ysize) <= _MAX_IMAGE_PIXELS


def tiff_first_ifd(data) -> tuple[str, dict] | None:
    """(byte order, {tag: value as PIL's tag_v2 holds it}) of a TIFF's
    first directory; None for a file that is no TIFF. Raises ValueError
    where PIL's TIFF reader would not open the first frame."""
    if bytes(data[:4]) not in _TIFF_PREFIXES:
        return None
    endian = "<" if data[:2] == b"II" else ">"
    (ifd0,) = struct.unpack(endian + "L", data[4:8])
    entries = _load_dir(data, ifd0, endian)[0] if ifd0 else {}
    if not ifd0 or not _tiff_first_frame_opens(entries, endian):
        raise ValueError("cannot identify image file: its first TIFF frame does not open")
    return endian, {tag: _settle(tag, typ, _decode(typ, raw, endian), None)
                    for tag, (typ, raw) in entries.items()}


def _jpeg_exif(buf) -> bytes | None:
    """The first APP1 'Exif' segment's payload (PIL's info['exif'])."""
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if marker in (0xD8, 0x01, 0xFF) or 0xD0 <= marker <= 0xD7:
            pos += 1 if marker == 0xFF else 2
            continue
        if marker in (0xDA, 0xD9):
            break
        (ln,) = struct.unpack_from(">H", buf, pos + 2)
        seg = bytes(buf[pos + 4:pos + 2 + ln])
        if marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            return seg
        pos += 2 + ln
    return None


def _png_exif(buf) -> bytes | None:
    pos = 8
    while pos + 8 <= len(buf):
        (ln,) = struct.unpack_from(">I", buf, pos)
        if bytes(buf[pos + 4:pos + 8]) == b"eXIf":
            return b"Exif\x00\x00" + bytes(buf[pos + 8:pos + 8 + ln])
        pos += 12 + ln
    return None


def _webp_exif(buf) -> bytes | None:
    pos = 12
    while pos + 8 <= len(buf):
        (ln,) = struct.unpack_from("<I", buf, pos + 4)
        if bytes(buf[pos:pos + 4]) == b"EXIF":
            return bytes(buf[pos + 8:pos + 8 + ln])
        pos += 8 + ln + (ln & 1)
    return None


def _open_exif(buf) -> tuple[Exif | None, bytes | None]:
    """What `Image.open(...)` gives for the file's bytes: (its getexif(),
    its info['exif'] block as stored), or (None, None) where PIL would not
    open the file."""
    head = bytes(buf[:16])
    if head[:4] in _TIFF_PREFIXES:
        try:
            endian, _ = tiff_first_ifd(buf)
        except ValueError:
            return None, None
        return Exif(buf, struct.unpack(endian + "L", head[4:8])[0], endian), None
    if head[:3] == b"\xff\xd8\xff":
        block = _jpeg_exif(buf)
    elif head[:8] == b"\x89PNG\r\n\x1a\n":
        block = _png_exif(buf)
    elif head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        block = _webp_exif(buf)
    else:
        return None, None
    return (Exif.from_payload(block) if block else Exif()), block


_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')
_XMP_JPEG = b"http://ns.adobe.com/xap/1.0/\x00"


def _xmp(buf) -> bytes | None:
    """The XMP packet PIL keeps in `info`: a JPEG's APP1 XMP segment, a
    PNG's "XML:com.adobe.xmp" iTXt chunk, a TIFF's tag 700."""
    head = bytes(buf[:8])
    if head[:3] == b"\xff\xd8\xff":
        pos = 2
        while pos + 4 <= len(buf) and buf[pos] == 0xFF:
            marker = buf[pos + 1]
            if marker in (0xDA, 0xD9):
                break
            (ln,) = struct.unpack_from(">H", buf, pos + 2)
            seg = bytes(buf[pos + 4:pos + 2 + ln])
            if marker == 0xE1 and seg.startswith(_XMP_JPEG):
                return seg[len(_XMP_JPEG):]
            pos += 2 + ln
    elif head == b"\x89PNG\r\n\x1a\n":
        pos = 8
        while pos + 8 <= len(buf):
            (ln,) = struct.unpack_from(">I", buf, pos)
            if bytes(buf[pos + 4:pos + 8]) == b"iTXt":
                body = bytes(buf[pos + 8:pos + 8 + ln])
                key, _, rest = body.partition(b"\x00")
                if key == b"XML:com.adobe.xmp" and len(rest) >= 2 and rest[0] == 0:
                    # flag, method, language\0, translated keyword\0, text
                    return rest[2:].split(b"\x00", 2)[-1]
            pos += 12 + ln
    elif head[:4] in _TIFF_PREFIXES:
        found = tiff_first_ifd(buf)
        value = found[1].get(700) if found else None
        return value if isinstance(value, bytes) else None
    return None


def image_orientation(buf) -> int:
    """PIL's `Image.open(f).getexif().get(0x0112, 1) or 1` for a JPEG, PNG
    or TIFF file's bytes: IFD0's Orientation, else the XMP packet's
    tiff:Orientation (as PIL's getexif falls back to it), else 1; 1 where
    PIL would not open the file or its EXIF does not parse."""
    try:
        exif, _ = _open_exif(buf)
        if exif is None:
            return 1
        if 0x0112 not in exif:
            xmp = _xmp(buf)
            match = _XMP_ORIENTATION.search(xmp) if xmp else None
            return int(match[2]) if match else 1
        return int(exif.get(0x0112, 1) or 1)
    except Exception:  # noqa: BLE001 — an unreadable EXIF reads as orientation 1
        return 1


def _read_file(path, fn):
    """fn(the file's bytes), the file mapped rather than read."""
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # an empty file
            return fn(b"")
        try:
            return fn(mm)
        finally:
            mm.close()


def _stringify(value) -> str | None:
    if isinstance(value, bytes):
        try:
            return value.decode("utf-8", "replace").strip("\x00")
        except Exception:
            return None
    if isinstance(value, (list, tuple)):
        return ", ".join(str(v) for v in value)
    return str(value)


def read_exif_tags(path: str | Path) -> dict:
    """Human-readable tag dict (auto-healed to <=500 chars per value)."""
    low = str(path).lower()
    if low.endswith(".cr3"):
        # the container parser extracts CMT metadata
        try:
            from rapidraw_tpu_torch.io.cr3 import parse_cr3_info

            info = parse_cr3_info(Path(path).read_bytes())
            return {k: str(v)[:_MAX_VALUE_LEN] for k, v in info.exif.items()}
        except Exception:
            return {}

    def tags(buf) -> dict:
        exif, _ = _open_exif(buf)
        if exif is None:
            return {}
        merged = exif.items()
        try:
            merged.update(exif.get_ifd(_EXIF_IFD_TAG))
        except Exception:
            pass
        gps = {}
        try:
            gps = dict(exif.get_ifd(_GPS_IFD_TAG))
        except Exception:
            pass
        out: dict = {}
        for tag, value in merged.items():
            sv = _stringify(value)
            if sv is not None:
                out[tables.EXIF_TAGS.get(tag, f"Tag{tag:04X}")] = sv[:_MAX_VALUE_LEN]
        for tag, value in gps.items():
            sv = _stringify(value)
            if sv is not None:
                out["GPS" + tables.GPS_TAGS.get(tag, f"Tag{tag:04X}")] = sv[:_MAX_VALUE_LEN]
        return out

    try:
        return _read_file(path, tags)
    except Exception:
        return {}


def read_exif_bytes(path: str | Path) -> bytes | None:
    """Raw EXIF payload of a file (for the lossless copy): a JPEG, PNG or
    WebP file's own block as stored, a TIFF-based file's IFD0 re-serialized
    with its Exif and GPS directories nested (as PIL's Exif.tobytes)."""
    def payload(buf):
        try:
            exif, block = _open_exif(buf)
        except Exception:  # a JPEG / PNG / WebP block PIL keeps unparsed
            return None
        if block:
            return block
        if exif is not None and len(exif):
            return exif.tobytes()
        return None

    try:
        return _read_file(path, payload)
    except Exception:
        return None


def _tobytes_raw(exif: Exif) -> bytes:
    """Exif.tobytes() without the 'Exif\\0\\0' prefix: the module's
    convention is raw TIFF payloads."""
    raw = exif.tobytes()
    return raw[6:] if raw.startswith(b"Exif\x00\x00") else raw


def strip_gps(exif_payload: bytes) -> bytes:
    """Remove the GPS IFD from an EXIF payload. GPS-less payloads return
    UNCHANGED (no re-serialization, which would rewrite MakerNote offsets)."""
    try:
        exif = Exif.from_payload(exif_payload)
    except Exception:
        return exif_payload
    if _GPS_IFD_TAG not in exif:
        return exif_payload
    del exif[_GPS_IFD_TAG]
    try:
        return _tobytes_raw(exif)
    except Exception:
        return exif_payload


def _reset_orientation(exif_payload: bytes) -> bytes:
    """Patch IFD0's Orientation (0x0112) to 1 IN PLACE (byte-level, no
    re-serialization): exported pixels already have the orientation baked
    in (io/loader apply-orientation), so carrying the source value makes
    EXIF-aware viewers rotate a second time. The reference does the same
    (exif_processing.rs:1064 sets Orientation = 1 on every export)."""
    try:
        endian = {"II": "<", "MM": ">"}.get(exif_payload[:2].decode("ascii", "ignore"))
        if endian is None:
            return exif_payload
        (ifd0,) = struct.unpack_from(endian + "I", exif_payload, 4)
        (count,) = struct.unpack_from(endian + "H", exif_payload, ifd0)
        buf = bytearray(exif_payload)
        pos = ifd0 + 2
        for _ in range(count):
            tag, typ, n = struct.unpack_from(endian + "HHI", buf, pos)
            if tag == 0x0112 and typ == 3 and n == 1:
                struct.pack_into(endian + "H", buf, pos + 8, 1)
                return bytes(buf)
            pos += 12
        return exif_payload
    except (struct.error, IndexError):
        return exif_payload


def splice_exif_into_jpeg(jpeg_path: str | Path, exif_payload: bytes) -> None:
    """Insert/replace the APP1 Exif segment of an encoded JPEG in place —
    lossless metadata write-through."""
    p = Path(jpeg_path)
    data = p.read_bytes()
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    if not exif_payload.startswith(b"Exif\x00\x00"):
        exif_payload = b"Exif\x00\x00" + exif_payload
    if len(exif_payload) + 2 > 0xFFFF:  # APP1 16-bit length limit
        raise ValueError(
            f"EXIF payload {len(exif_payload)}B exceeds the 64KB APP1 limit"
        )
    seg = b"\xff\xe1" + struct.pack(">H", len(exif_payload) + 2) + exif_payload

    # walk segments after SOI; drop any existing APP1-Exif, insert ours first
    out = [data[:2], seg]
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xDA:  # start of scan: copy the rest verbatim
            break
        (ln,) = struct.unpack_from(">H", data, pos + 2)
        segment = data[pos : pos + 2 + ln]
        is_exif_app1 = marker == 0xE1 and segment[4:10] == b"Exif\x00\x00"
        if not is_exif_app1:
            out.append(segment)
        pos += 2 + ln
    out.append(data[pos:])
    p.write_bytes(b"".join(out))


def splice_exif_into_png(png_path: str | Path, exif_payload: bytes) -> None:
    """Insert/replace the PNG eXIf chunk (PNG 1.5 extension) in place —
    chunk payload is the raw TIFF EXIF structure."""
    import zlib

    p = Path(png_path)
    data = p.read_bytes()
    sig = b"\x89PNG\r\n\x1a\n"
    if data[:8] != sig:
        raise ValueError("not a PNG file")
    chunk = b"eXIf" + exif_payload
    exif_chunk = (
        struct.pack(">I", len(exif_payload)) + chunk
        + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF)
    )
    out = [sig]
    pos = 8
    inserted = False
    while pos + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4 : pos + 8]
        seg = data[pos : pos + 12 + ln]
        if ctype != b"eXIf":  # drop any existing eXIf
            out.append(seg)
        pos += 12 + ln
        if ctype == b"IHDR" and not inserted:
            out.append(exif_chunk)
            inserted = True
    p.write_bytes(b"".join(out))


def splice_exif_into_webp(webp_path: str | Path, exif_payload: bytes) -> None:
    """Insert/replace the RIFF 'EXIF' chunk in place, creating/patching the
    VP8X header with the EXIF flag (WebP container spec) — no re-encode.
    A file without VP8X takes one sized from its VP8 / VP8L frame header
    (the JAX package asks PIL for the size)."""
    p = Path(webp_path)
    data = p.read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")

    # collect existing chunks
    chunks = []
    pos = 12
    while pos + 8 <= len(data):
        tag = data[pos : pos + 4]
        (ln,) = struct.unpack_from("<I", data, pos + 4)
        payload = data[pos + 8 : pos + 8 + ln]
        chunks.append((tag, payload))
        pos += 8 + ln + (ln & 1)

    chunks = [(t, c) for t, c in chunks if t != b"EXIF"]
    vp8x = None
    rest = []
    for t, c in chunks:
        if t == b"VP8X":
            vp8x = bytearray(c)
        else:
            rest.append((t, c))
    if vp8x is None:
        w, h, has_alpha = _webp_frame_size(rest)
        vp8x = bytearray(10)
        vp8x[4:7] = struct.pack("<I", w - 1)[:3]
        vp8x[7:10] = struct.pack("<I", h - 1)[:3]
        if has_alpha or any(t == b"ALPH" for t, _ in rest):
            # preserve transparency visibility when synthesizing the
            # header (readers trust the VP8X alpha bit)
            vp8x[0] |= 0x10
    vp8x[0] |= 0x08  # EXIF flag
    ordered = [(b"VP8X", bytes(vp8x))] + rest + [(b"EXIF", exif_payload)]

    body = bytearray(b"WEBP")
    for t, c in ordered:
        body += t + struct.pack("<I", len(c)) + c
        if len(c) & 1:
            body += b"\0"
    p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + bytes(body))


def _webp_frame_size(chunks) -> tuple[int, int, bool]:
    """(width, height, alpha) from a simple WebP's VP8 or VP8L header."""
    for t, c in chunks:
        if t == b"VP8 " and len(c) >= 10:
            w, h = struct.unpack_from("<HH", c, 6)
            return w & 0x3FFF, h & 0x3FFF, False
        if t == b"VP8L" and len(c) >= 5:
            (bits,) = struct.unpack_from("<I", c, 1)
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)
    raise ValueError("WebP file has no VP8 / VP8L frame")


def merge_exif_into_tiff(tiff_path: str | Path, exif_payload: bytes) -> None:
    """Write EXIF tags into an exported 16-bit TIFF with a merged IFD0:
    main-IFD and Exif-IFD tags flattened into IFD0 (legal per TIFF/EP; the
    reference writes through little_exif, exif_processing.rs:669-1073),
    the file rewritten through io.encode.write_tiff16. The port's TIFF
    exports are always 16-bit; an 8-bit TIFF (which the JAX package
    re-saves through PIL) raises."""
    exif = Exif.from_payload(exif_payload)
    p = Path(tiff_path)
    merged = exif.items()
    try:
        merged.update(exif.get_ifd(_EXIF_IFD_TAG))
    except Exception:
        pass
    # never carry over structural tags describing the SOURCE encoding
    skip = {0x8769, _GPS_IFD_TAG, 0x0100, 0x0101, 0x0102, 0x0103,
            0x0106, 0x0111, 0x0115, 0x0116, 0x0117, 0x011C}
    tags = {
        tag: value
        for tag, value in merged.items()
        if tag not in skip and not isinstance(value, dict)
    }
    tags[0x0112] = 1  # pixels are upright (exif_processing.rs:1064)

    from rapidraw_tpu_torch.io.encode import read_tiff16_rgb, write_tiff16

    arr16 = read_tiff16_rgb(p)
    if arr16 is None:
        raise ValueError(f"{p}: not a 16-bit RGB TIFF; the port writes no 8-bit TIFF")
    write_tiff16(p, arr16, extra_tags=tags)


def _coerce_tag_value(tag_id: int, value):
    """Convert a sidecar-stringified value back to the tag's declared TIFF
    type (read_exif_tags stores everything through _stringify: ints as
    "6", rationals as "1/100", tuples as "a, b")."""
    if not isinstance(value, str):
        return value
    info = tables.TAG_INFO.get(tag_id)
    if info is None or info[0] == 2:  # ASCII / unknown: keep the string
        return value
    s = value.strip()
    parts = [p.strip() for p in s.split(",")] if "," in s else [s]
    t = info[0]
    if t in (1, 3, 4, 6, 8, 9):  # BYTE/SHORT/LONG/SBYTE/SSHORT/SLONG
        vals = tuple(int(float(p)) for p in parts)
    elif t in (5, 10):  # RATIONAL / SRATIONAL
        def rat(p: str):
            if "/" in p:
                num, den = p.split("/", 1)
                return Rational(int(num), int(den))
            return Rational(float(p))

        vals = tuple(rat(p) for p in parts)
    elif t in (11, 12):  # FLOAT / DOUBLE
        vals = tuple(float(p) for p in parts)
    elif t == 7:  # UNDEFINED
        return s.encode("utf-8", "replace")
    else:
        return value
    return vals[0] if len(vals) == 1 else vals


def _payload_from_tag_dict(tags: dict) -> bytes | None:
    """Serialize a human-readable tag dict (the sidecar's exif block) into
    a binary EXIF payload — the export write-through for user-EDITED
    metadata (the reference prefers the sidecar map over the file's own
    EXIF, exif_processing.rs:708). Values are coerced back to their
    declared TIFF types and probed per tag, so one untypable value drops
    THAT tag, not the whole edited payload."""
    name_to_id = {v: k for k, v in tables.EXIF_TAGS.items()}
    exif = Exif()
    wrote = False
    for name, value in tags.items():
        tag_id = name_to_id.get(str(name))
        if tag_id is None:
            continue
        try:
            coerced = _coerce_tag_value(tag_id, value)
        except (ValueError, TypeError, ZeroDivisionError):
            coerced = value
        probe = Exif()
        try:
            probe[tag_id] = coerced
            probe.tobytes()
        except Exception:  # noqa: BLE001 — untypable value for this tag
            continue
        exif[tag_id] = coerced
        wrote = True
    if not wrote:
        return None
    try:
        return _tobytes_raw(exif)
    except Exception:  # noqa: BLE001
        return None


def copy_exif(
    src: str | Path, dst: str | Path, strip_gps_data: bool = True, software: str | None = None
) -> bool:
    """Copy EXIF from src onto an exported dst: lossless segment/chunk
    splice for JPEG/PNG/WebP, merged-IFD rewrite for TIFF; Orientation is
    reset to 1 (the pixels are upright — exif_processing.rs:1064).

    Mirrors export_processing.rs:297-303 + :669-1073. AVIF/JXL return
    False (no metadata writer).
    """
    payload = read_exif_bytes(src)
    # user-EDITED metadata lives in the sidecar's exif dict; when it differs
    # from the file's own tags, the edited values win on export
    # (exif_processing.rs:708 prefers the sidecar map)
    try:
        from rapidraw_tpu_torch.io.sidecar import load_sidecar

        side = load_sidecar(src).get("exif")
        if isinstance(side, dict) and side and side != read_exif_tags(src):
            built = _payload_from_tag_dict(side)
            if built is not None:
                payload = built
    except Exception:  # noqa: BLE001 — sidecar issues never fail the copy
        pass
    if payload is None:
        return False
    if payload.startswith(b"Exif\x00\x00"):
        payload = payload[6:]
    if strip_gps_data:
        payload = strip_gps(payload)
    payload = _reset_orientation(payload)
    if software:
        try:
            exif = Exif.from_payload(payload)
            exif[0x0131] = software  # Software tag
            payload = _tobytes_raw(exif)
        except Exception:
            pass
    dstp = Path(dst)
    ext = dstp.suffix.lower()
    try:
        if ext in (".jpg", ".jpeg"):
            splice_exif_into_jpeg(dstp, payload)
        elif ext == ".png":
            splice_exif_into_png(dstp, payload)
        elif ext == ".webp":
            splice_exif_into_webp(dstp, payload)
        elif ext in (".tif", ".tiff"):
            merge_exif_into_tiff(dstp, payload)
        else:
            return False
        return True
    except Exception:
        return False


def persist_exif_if_missing(image_path: str | Path) -> None:
    """Store the source's EXIF tag dict into its .rrdata sidecar on first
    load (exif_processing.rs:1151-1200 / image_loader.rs:81): EXIF then
    survives even if another tool later strips the source. Migrates a
    legacy .rrexif sidecar when present; no-op when the sidecar already
    carries exif or the source has none. Never raises (read-only dirs,
    malformed files)."""
    try:
        from rapidraw_tpu_torch.io.sidecar import load_sidecar, save_sidecar

        meta = load_sidecar(image_path)
        if meta.get("exif"):
            return
        legacy = load_rrexif_sidecar(image_path)
        tags = (legacy or {}).get("exif") or read_exif_tags(image_path)
        if not tags:
            return
        meta["exif"] = tags
        save_sidecar(image_path, meta)
        if legacy is not None:
            Path(str(image_path) + RREXIF_EXT).unlink(missing_ok=True)
    except Exception:  # noqa: BLE001 — preservation is best-effort
        return


def load_rrexif_sidecar(derived_file: str | Path) -> dict | None:
    sidecar = Path(str(derived_file) + RREXIF_EXT)
    if not sidecar.exists():
        return None
    try:
        return json.loads(sidecar.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def get_creation_date(path: str | Path):
    """Capture datetime: EXIF DateTimeOriginal, falling back through
    DateTimeDigitized/DateTime to the filesystem mtime
    (exif_processing.rs get_creation_date_from_path)."""
    import datetime as _dt

    tags = read_exif_tags(path)
    for key in ("DateTimeOriginal", "DateTimeDigitized", "DateTime"):
        raw = tags.get(key)
        if not raw:
            continue
        try:
            return _dt.datetime.strptime(raw.strip(), "%Y:%m:%d %H:%M:%S")
        except ValueError:
            continue
    try:
        return _dt.datetime.fromtimestamp(Path(path).stat().st_mtime)
    except OSError:
        return _dt.datetime.now()


def effective_exif_tags(path: str | Path) -> dict:
    """The tags a user actually sees: the sidecar's exif block (where
    edits persist, file_management.rs:235-277) takes precedence, then the
    .rrexif companion, then the file's own EXIF."""
    from rapidraw_tpu_torch.io.sidecar import load_sidecar

    exif = load_sidecar(path).get("exif")
    if isinstance(exif, dict):
        return dict(exif)
    rr = load_rrexif_sidecar(path)
    if rr and isinstance(rr.get("exif"), dict):
        return dict(rr["exif"])
    return read_exif_tags(path)


def update_exif_fields(paths: list[str | Path], updates: dict[str, str]) -> None:
    """Field-level EXIF edits persisted to the .rrdata sidecar
    (file_management.rs:235-277; JAX io/exif.py:550): seed the dict from the
    sidecar's exif block, else the .rrexif companion, else the file's own
    EXIF; apply `updates` (trimmed; an empty value deletes the key); write
    back."""
    from rapidraw_tpu_torch.io.sidecar import load_sidecar, save_sidecar

    for path in paths:
        meta = load_sidecar(path)
        exif = meta.get("exif")
        if not isinstance(exif, dict):
            rr = load_rrexif_sidecar(path)
            if rr and isinstance(rr.get("exif"), dict):
                exif = dict(rr["exif"])
            else:
                exif = read_exif_tags(path)
        for k, v in updates.items():
            trimmed = str(v).strip()
            if not trimmed:
                exif.pop(k, None)
            else:
                exif[k] = trimmed
        meta["exif"] = exif
        save_sidecar(path, meta)
