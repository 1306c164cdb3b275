"""RAW container detection and decode dispatch.

Port of `rapidraw_tpu/io/containers.py` (host Python). Each container has a
host parser producing a `RawFile` (io/dng.py), as in the JAX package:
  TIFF-family: DNG/TIFF (io/dng.py), CR2/NEF/PEF/ARW/ORF/RW2 (io/makers.py,
  with the Olympus predictive and Panasonic 12-bit bitstreams decoded by
  csrc/host/pana_oly.cc), plus the generic vendor TIFF-CFA tail
  (ERF/MEF/MOS/FFF/3FR/KDC/DCR/DCS/SRW, parse_tiff_cfa).
  Block-chain: MRW (Minolta, parse_mrw). RAF (Fujifilm, io/raf.py).
  CR3 (ISO BMFF): io/cr3.py + io/crx.py decode the lossless crx dialect
  (csrc/host/crx.cc); payloads that do not match refuse precisely.
  IIQ (Phase One): io/iiq.py + csrc/host/phase_one.cc.
X3F, CRW, ARRIRAW, bare BMFF and the extension tail are refused as the JAX
package refuses them. `raw_dimensions` reads width and height from the
container's metadata with no decode, X3F (io/x3f.py) and CRW (io/ciff.py)
included, for the catalog's dimension query.
"""

from __future__ import annotations

import struct

from rapidraw_tpu_torch.io.dng import DngError, RawFile, parse_dng

SUPPORTED_FORMATS = (
    "dng", "tiff", "cr2", "cr3", "nef", "nrw", "pef", "arw", "srf", "sr2",
    "orf", "rw2", "rwl", "raf", "mrw", "iiq",
    # generic vendor TIFF-CFA path (io/makers.py parse_tiff_cfa)
    "erf", "mef", "mos", "fff", "3fr", "kdc", "dcr", "dcs", "srw",
)

# Make-prefix -> the generic TIFF-CFA path (formats.rs:4-71's vendor list)
_TIFF_CFA_MAKES = (
    "EPSON", "SEIKO EPSON", "MAMIYA", "LEAF", "HASSELBLAD", "SAMSUNG",
    "KODAK", "EASTMAN KODAK",
)
# k25/bay/pro: the formats.rs:4-71 extension tail (Kodak DC25 / Casio /
# Kodak ProBack eras). When such a file is TIFF-shaped it rides the
# generic TIFF-CFA path; the non-TIFF proprietary bitstreams (identified
# by file-size tables in dcraw, not by magic) get a precise refusal in
# parse_raw instead of the generic "unrecognized container".
_TIFF_CFA_EXTS = (
    "erf", "mef", "mos", "fff", "3fr", "kdc", "dcr", "dcs", "srw",
    "k25", "bay", "pro",
)

# extensions whose non-TIFF payloads we can NAME precisely even though the
# bitstream is not decoded (the X3F/CRW refusal treatment, formats.rs tail)
_REFUSAL_TAIL = {
    "k25": "Kodak DC25 bitstream (identified by size table, not magic)",
    "bay": "Casio BAY bitstream (identified by size table, not magic)",
    "pro": "Kodak ProBack bitstream",
    "ptx": "non-TIFF Pentax PTX payload",
    "raw": "bare .raw that is neither a Panasonic (IIU\\0 magic) nor a "
           "TIFF-family container",
}


class UnsupportedRawFormat(ValueError):
    """Raised for containers we can detect but not decode."""

    def __init__(self, fmt: str, detail: str = ""):
        self.format = fmt
        msg = f"RAW format {fmt!r} is not yet supported"
        if detail:
            msg += f" ({detail})"
        msg += f"; supported: {', '.join(SUPPORTED_FORMATS)}"
        super().__init__(msg)


_TAG_DNG_VERSION = 50706


def _tiff_ifd0_hints(data: bytes) -> tuple[str, bool]:
    """(Make tag 271, DNGVersion tag 50706 present) from IFD0 of a
    TIFF-family file; ('', False) on any parse problem — dispatch hints
    only. DNGVersion must win over Make: DNGs converted from vendor RAWs
    retain Make='NIKON CORPORATION' etc. but must route to parse_dng."""
    make = ""
    is_dng = False
    try:
        endian = "<" if data[:2] == b"II" else ">"
        _, first = struct.unpack_from(endian + "HI", data, 2)
        (count,) = struct.unpack_from(endian + "H", data, first)
        pos = first + 2
        for _ in range(count):
            tag, typ, n = struct.unpack_from(endian + "HHI", data, pos)
            if tag == 271 and typ == 2:
                if n <= 4:
                    raw = data[pos + 8 : pos + 8 + n]
                else:
                    (off,) = struct.unpack_from(endian + "I", data, pos + 8)
                    raw = data[off : off + n]
                make = raw.split(b"\0")[0].decode(errors="replace").strip()
            elif tag == _TAG_DNG_VERSION:
                is_dng = True
            pos += 12
    except (struct.error, IndexError):
        pass
    return make, is_dng


def sniff_container(data: bytes, ext: str = "") -> str:
    """Identify the RAW container from magic bytes (ext is only a hint)."""
    ext = ext.lower().lstrip(".")
    if len(data) < 16:
        return "unknown"
    # ISO base media file (CR3): size + 'ftyp' + brand
    if data[4:8] == b"ftyp":
        return "cr3" if b"crx " in data[8:24] else "bmff"
    if data[:15] == b"FUJIFILMCCD-RAW"[:15]:
        return "raf"
    if data[:4] == b"FOVb":
        return "x3f"
    if data[:4] == b"ARRI":  # ARRIRAW (.ari): LE header, dims at 20/24
        return "ari"
    if data[:4] == b"\x00MRM":
        return "mrw"
    if data[:4] in (b"IIRO", b"IIRS", b"MMOR"):  # Olympus magics 0x4f52/0x5352
        return "orf"
    if data[:4] == b"IIU\0":  # Panasonic RW2 magic 85
        return "rw2"
    if data[:2] in (b"II", b"MM"):
        if data[6:14] == b"HEAPCCDR":  # Canon CIFF (.crw)
            return "crw"
        try:
            endian = "<" if data[:2] == b"II" else ">"
            (magic,) = struct.unpack_from(endian + "H", data, 2)
        except struct.error:
            return "unknown"
        if magic != 42:
            return "unknown"
        if data[8:10] == b"CR":  # CR2 extra magic at offset 8
            return "cr2"
        make_raw, is_dng = _tiff_ifd0_hints(data)
        if is_dng or ext == "dng":
            return "tiff"
        make = make_raw.upper()
        if make.startswith("NIKON"):
            return "nef"
        if make.startswith("SONY"):
            return "arw"
        if make.startswith("PENTAX") or make.startswith("RICOH"):
            return "pef"
        if make.startswith(_TIFF_CFA_MAKES) or ext in _TIFF_CFA_EXTS:
            return "tiffcfa"
        if make.startswith("PHASE ONE") or ext == "iiq":
            return "iiq"
        if ext in ("nef", "nrw"):
            return "nef"
        if ext in ("arw", "srf", "sr2"):
            return "arw"
        if ext in ("pef", "ptx"):  # PTX is the Pentax PEF sibling extension
            return "pef"
        return "tiff"
    return "unknown"


def _dispatch(kind: str, data: bytes) -> RawFile | None:
    if kind == "tiff":
        return parse_dng(data)
    if kind in _MAKER_PARSERS:
        from rapidraw_tpu_torch.io import makers

        return getattr(makers, _MAKER_PARSERS[kind])(data)
    if kind == "raf":
        from rapidraw_tpu_torch.io.raf import parse_raf

        return parse_raf(data)
    if kind == "cr3":
        from rapidraw_tpu_torch.io.cr3 import parse_cr3

        return parse_cr3(data)  # structured parse; raises with metadata
    if kind == "iiq":
        from rapidraw_tpu_torch.io.iiq import parse_iiq

        return parse_iiq(data)
    return None


# sniff_container kind -> its parser in io/makers.py
_MAKER_PARSERS = {
    "cr2": "parse_cr2", "nef": "parse_nef", "pef": "parse_pef", "arw": "parse_arw",
    "orf": "parse_orf", "rw2": "parse_rw2", "mrw": "parse_mrw", "tiffcfa": "parse_tiff_cfa",
}


def parse_raw(data: bytes, ext: str = "") -> RawFile:
    """Decode any supported RAW container to a RawFile.

    Contract (the reference gets this from rawler's fuzz-hardened Result
    path): arbitrary bytes either decode or raise ValueError — internal
    parser slips on malformed input (KeyError/IndexError/struct.error/
    OverflowError/TypeError) are converted, never propagated."""
    kind = sniff_container(data, ext)
    if kind not in ("unknown", "x3f", "bmff"):
        try:
            raw = _dispatch(kind, data)
        except (KeyError, IndexError, struct.error, OverflowError, TypeError) as e:
            raise DngError(
                f"malformed {kind} file: {type(e).__name__}: {e}"
            ) from e
        if raw is not None:
            return raw
    if kind == "x3f":
        raise UnsupportedRawFormat(
            "x3f",
            "Foveon develop needs the camera-encoded CAMF calibration "
            "sections; the embedded full-size JPEG preview is served for "
            "browse/thumbnails (io/x3f.py)",
        )
    if kind == "crw":
        raise UnsupportedRawFormat(
            "crw",
            "CIFF compressed bitstream not decoded; the embedded JPEG "
            "preview is served for browse/thumbnails (io/ciff.py)",
        )
    if kind == "ari":
        w, h = _ari_dimensions_or_zero(data)
        raise UnsupportedRawFormat(
            "ari",
            f"ARRIRAW bitstream not decoded (container metadata parsed: "
            f"{w}x{h}, make ARRI)",
        )
    if kind == "bmff":
        raise UnsupportedRawFormat(kind)
    tail = _REFUSAL_TAIL.get(ext.lower().lstrip("."))
    if tail is not None:
        raise UnsupportedRawFormat(ext.lower().lstrip("."), tail)
    raise DngError(
        f"unrecognized RAW container (extension {ext or '?'}); "
        f"supported: {', '.join(SUPPORTED_FORMATS)}"
    )


def _ari_dimensions_or_zero(data: bytes) -> tuple[int, int]:
    """ARRIRAW header: LE, width at offset 20, height at 24 (the dcraw
    'ARRI' identify path). (0, 0) on truncated headers."""
    try:
        w, h = struct.unpack_from("<II", data, 20)
        if 0 < w < 65536 and 0 < h < 65536:
            return int(w), int(h)
    except struct.error:
        pass
    return 0, 0


def raw_dimensions(data: bytes, ext: str = "") -> tuple[int, int]:
    """(width, height) from container METADATA only — no pixel decode.

    Serves dimension queries (lib.rs:232-238) cheaply: a CR2/NEF/ARW
    bitstream decode takes seconds per 24MP file, and CR3 dims live in the
    stsd box even though the crx payload may be refused."""
    kind = sniff_container(data, ext)
    if kind == "bmff":
        raise UnsupportedRawFormat(kind)
    try:
        if kind == "ari":
            w, h = _ari_dimensions_or_zero(data)
            if w and h:
                return w, h
            raise DngError("ARRIRAW header truncated")
        if kind == "x3f":
            from rapidraw_tpu_torch.io.x3f import x3f_dimensions

            return x3f_dimensions(data)
        if kind == "crw":
            from rapidraw_tpu_torch.io.ciff import crw_dimensions

            return crw_dimensions(data)
        if kind == "iiq":
            from rapidraw_tpu_torch.io.iiq import iiq_dimensions

            return iiq_dimensions(data)
        if kind == "cr3":
            from rapidraw_tpu_torch.io.cr3 import parse_cr3_info

            info = parse_cr3_info(data)
            if info.width and info.height:
                return int(info.width), int(info.height)
            raise DngError("CR3 missing raw dimensions")
        if kind == "raf":
            from rapidraw_tpu_torch.io.raf import raf_dimensions

            return raf_dimensions(data)
        if kind == "mrw":
            # PRD sensor descriptor fields (io/makers.py parse_mrw layout)
            (hdr_len,) = struct.unpack_from(">I", data, 4)
            pos = 8
            while pos + 8 <= min(8 + hdr_len, len(data)):
                name = data[pos : pos + 4]
                (blen,) = struct.unpack_from(">I", data, pos + 4)
                if name == b"\x00PRD" and pos + 24 <= len(data):
                    ch, cw, ih, iw = struct.unpack_from(">HHHH", data, pos + 16)
                    w, h = (iw or cw), (ih or ch)
                    if w and h:
                        return int(w), int(h)
                pos += 8 + blen
            raise DngError("MRW missing PRD sensor descriptor")
        if kind == "unknown":
            raise DngError(
                f"unrecognized RAW container (extension {ext or '?'})"
            )
        # TIFF-family (incl. ORF/RW2 magics): IFD dims. RW2 uses vendor
        # sensor-border tags; everything else reports the largest
        # ImageWidth x ImageLength among all IFDs (the raw plane).
        endian = "<" if data[:2] == b"II" else ">"
        from rapidraw_tpu_torch.io.dng import _collect_ifds, _T

        first = struct.unpack_from(endian + "HI", data, 2)[1]
        ifds = _collect_ifds(data, endian, first)
        if kind == "rw2":
            ifd0 = ifds[0] if ifds else {}
            borders = [ifd0.get(t, [0])[0] for t in (0x0004, 0x0005, 0x0006, 0x0007)]
            top, left, bottom, right = borders
            if right > left and bottom > top:
                return int(right - left), int(bottom - top)
            w = ifd0.get(0x0002, [0])[0]
            h = ifd0.get(0x0003, [0])[0]
            if w and h:
                return int(w), int(h)
            raise DngError("RW2 missing sensor dimensions")
        best = (0, 0)
        for i in ifds:
            w = i.get(_T["ImageWidth"], [0])
            h = i.get(_T["ImageLength"], [0])
            if w and h and w[0] * h[0] > best[0] * best[1]:
                best = (int(w[0]), int(h[0]))
        if best[0] and best[1]:
            return best
        raise DngError("no dimensioned IFD found")
    except (KeyError, IndexError, struct.error, OverflowError, TypeError) as e:
        raise DngError(f"malformed {kind} file: {type(e).__name__}: {e}") from e
