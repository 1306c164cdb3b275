"""TIFF-family RAW container reader and the RAW load onto the device.

Port of `rapidraw_tpu/io/dng.py`. The host half is a copy (pure Python +
NumPy): DNG/TIFF uncompressed (Compression=1) 8/16-bit and bit-packed
10/12/14-bit, lossless-JPEG (Compression=7, the C++ decoder in
csrc/host/ljpeg.cc), strip or tile layout, CFA and LinearRaw. Container
detection and dispatch live in io/containers.py.

The device half is PyTorch: `upload_cfa` copies the CFA to the device once
in its own dtype (u16 for most containers: half the bytes of f32), and
`develop_raw` runs normalize, white balance, demosaic, camera matrix,
highlight compression and EXIF orientation there (rapidraw_tpu_torch.raw).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

# TIFF tags
_T = {
    "NewSubfileType": 254,
    "ImageWidth": 256,
    "ImageLength": 257,
    "BitsPerSample": 258,
    "Compression": 259,
    "Photometric": 262,
    "StripOffsets": 273,
    "Orientation": 274,
    "SamplesPerPixel": 277,
    "RowsPerStrip": 278,
    "StripByteCounts": 279,
    "SubIFDs": 330,
    "TileWidth": 322,
    "TileLength": 323,
    "TileOffsets": 324,
    "TileByteCounts": 325,
    "CFARepeatPatternDim": 33421,
    "CFAPattern": 33422,
    "BlackLevel": 50714,
    "WhiteLevel": 50717,
    "ColorMatrix1": 50721,
    "ColorMatrix2": 50722,
    "AsShotNeutral": 50728,
}

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}


@dataclass
class RawFile:
    cfa: np.ndarray  # (H, W) uint16 (or (H, W, C) for LinearRaw)
    pattern: str  # e.g. "RGGB"
    black_level: float
    white_level: float
    wb: np.ndarray  # (3,) multipliers, green-normalized
    xyz_to_cam: np.ndarray | None  # (3,3) ColorMatrix (prefer CM2)
    orientation: int = 1
    is_linear: bool = False
    tags: dict = field(default_factory=dict)
    # (6, 6) int 0/1/2 sensor layout for X-Trans sensors (RAF); when set,
    # `pattern` is ignored and the X-Trans demosaic runs instead
    xtrans: "np.ndarray | None" = None


class DngError(ValueError):
    pass


def _read_ifd(buf: bytes, offset: int, endian: str) -> tuple[dict, int]:
    (count,) = struct.unpack_from(endian + "H", buf, offset)
    entries = {}
    pos = offset + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", buf, pos)
        size = _TYPE_SIZE.get(typ, 1) * n
        if size <= 4:
            raw = buf[pos + 8 : pos + 8 + size]
        else:
            (val_off,) = struct.unpack_from(endian + "I", buf, pos + 8)
            raw = buf[val_off : val_off + size]
        entries[tag] = _decode_values(raw, typ, n, endian)
        pos += 12
    (next_ifd,) = struct.unpack_from(endian + "I", buf, pos)
    return entries, next_ifd


def _decode_values(raw: bytes, typ: int, n: int, endian: str):
    if typ in (1, 6, 7):
        return list(raw[:n])
    if typ == 2:
        return raw.split(b"\0")[0].decode(errors="replace")
    if typ == 3:
        return list(struct.unpack_from(endian + f"{n}H", raw))
    if typ == 4:
        return list(struct.unpack_from(endian + f"{n}I", raw))
    if typ == 8:
        return list(struct.unpack_from(endian + f"{n}h", raw))
    if typ == 9:
        return list(struct.unpack_from(endian + f"{n}i", raw))
    if typ == 5:
        vals = struct.unpack_from(endian + f"{2 * n}I", raw)
        return [a / b if b else 0.0 for a, b in zip(vals[::2], vals[1::2])]
    if typ == 10:
        vals = struct.unpack_from(endian + f"{2 * n}i", raw)
        return [a / b if b else 0.0 for a, b in zip(vals[::2], vals[1::2])]
    if typ == 11:
        return list(struct.unpack_from(endian + f"{n}f", raw))
    if typ == 12:
        return list(struct.unpack_from(endian + f"{n}d", raw))
    return list(raw)


def _collect_ifds(buf: bytes, endian: str, first: int) -> list[dict]:
    ifds = []
    seen = set()
    stack = [first]
    while stack:
        off = stack.pop()
        if off == 0 or off in seen or off >= len(buf):
            continue
        seen.add(off)
        try:
            entries, nxt = _read_ifd(buf, off, endian)
        except struct.error:
            continue
        ifds.append(entries)
        if nxt:
            stack.append(nxt)
        for sub in entries.get(_T["SubIFDs"], []) or []:
            stack.append(sub)
    return ifds


def _unpack_msb(raw: bytes, bits: int, row_samples: int, n_rows: int) -> np.ndarray:
    """MSB-first bit-packed samples -> (n_rows, row_samples) uint16.

    TIFF 6.0 packing for BitsPerSample 10/12/14 (DNG packed CFA): bits fill
    bytes high-to-low, each ROW padded to a byte boundary.
    """
    row_bytes = (row_samples * bits + 7) // 8
    buf = np.frombuffer(raw, np.uint8, count=row_bytes * n_rows)
    # each sample reads a 32-bit big-endian window at its start byte and
    # shifts its field out — O(output) memory (an unpackbits expansion to
    # (rows, samples, bits) u32 cost ~25x the packed size per strip)
    p = np.pad(buf.reshape(n_rows, row_bytes), ((0, 0), (0, 3)))
    bitpos = np.arange(row_samples, dtype=np.int64) * bits
    starts = (bitpos >> 3).astype(np.intp)
    sh = (32 - bits - (bitpos & 7)).astype(np.uint32)
    w = p[:, starts].astype(np.uint32)
    for k in (1, 2, 3):
        w <<= np.uint32(8)
        w |= p[:, starts + k]
    return ((w >> sh) & np.uint32((1 << bits) - 1)).astype(np.uint16)


def _unpack_12le(raw: bytes, row_samples: int, n_rows: int) -> np.ndarray:
    """Nikon-style little-endian 12-bit packing: 2 samples per 3 bytes,
    p0 = b0 | (b1 & 0xF) << 8, p1 = b1 >> 4 | b2 << 4 (rawler decode_12le)."""
    row_bytes = (row_samples * 12 + 7) // 8
    buf = np.frombuffer(raw, np.uint8, count=row_bytes * n_rows).astype(np.uint16)
    buf = buf.reshape(n_rows, row_bytes)
    pairs = row_samples // 2
    b0 = buf[:, 0 : pairs * 3 : 3]
    b1 = buf[:, 1 : pairs * 3 : 3]
    b2 = buf[:, 2 : pairs * 3 : 3]
    out = np.empty((n_rows, pairs * 2), np.uint16)
    out[:, 0::2] = b0 | ((b1 & 0xF) << 8)
    out[:, 1::2] = (b1 >> 4) | (b2 << 4)
    if row_samples % 2:
        # odd trailing sample spans bytes 3k, 3k+1
        t0 = buf[:, pairs * 3]
        t1 = buf[:, pairs * 3 + 1]
        out = np.concatenate([out, (t0 | ((t1 & 0xF) << 8))[:, None]], axis=1)
    return out


def _pattern_string(ifd: dict) -> str:
    pat = ifd.get(_T["CFAPattern"])
    if not pat:
        return "RGGB"
    names = {0: "R", 1: "G", 2: "B"}
    return "".join(names.get(v, "G") for v in pat[:4])


def parse_dng(data: bytes) -> RawFile:
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise DngError("not a TIFF/DNG file")
    magic, first = struct.unpack_from(endian + "HI", data, 2)
    if magic != 42:
        raise DngError(f"bad TIFF magic {magic}")

    ifds = _collect_ifds(data, endian, first)
    # pick the raw IFD: CFA (32803) or LinearRaw (34892), else largest area
    raw_ifds = [i for i in ifds if i.get(_T["Photometric"], [0])[0] in (32803, 34892)]
    if not raw_ifds:
        raise DngError("no raw IFD (CFA/LinearRaw) found")
    ifd = max(
        raw_ifds,
        key=lambda i: (i.get(_T["ImageWidth"], [0])[0] * i.get(_T["ImageLength"], [0])[0]),
    )

    if _T["ImageWidth"] not in ifd or _T["ImageLength"] not in ifd:
        raise DngError("raw IFD missing ImageWidth/ImageLength")
    width = ifd[_T["ImageWidth"]][0]
    height = ifd[_T["ImageLength"]][0]
    if not (0 < width <= 65535 and 0 < height <= 65535) or width * height > 1 << 28:
        raise DngError(f"implausible raw dimensions {width}x{height}")
    bits = ifd.get(_T["BitsPerSample"], [16])[0]
    compression = ifd.get(_T["Compression"], [1])[0]
    photometric = ifd.get(_T["Photometric"], [32803])[0]
    spp = ifd.get(_T["SamplesPerPixel"], [1])[0]
    # spp scales the allocation: cap it (CFA=1, LinearRaw<=4 in practice)
    # so a crafted file can't request width*65535 columns
    if not (1 <= spp <= 8) or width * height * spp > 1 << 30:
        raise DngError(f"implausible SamplesPerPixel {spp}")
    if compression not in (1, 7):
        raise DngError(f"unsupported DNG compression {compression}")
    if compression == 1 and bits not in (8, 10, 12, 14, 16):
        raise DngError(f"unsupported bit depth {bits}")

    dtype = np.uint16 if (bits > 8 or compression == 7) else np.uint8
    plane = np.zeros((height, width * spp), dtype)

    def _uncompressed(off: int, cnt: int, row_samples: int, n_rows: int) -> np.ndarray:
        if bits in (8, 16):
            return np.frombuffer(
                data, dtype=endian + ("u2" if bits == 16 else "u1"),
                count=n_rows * row_samples, offset=off,
            ).reshape(n_rows, row_samples)
        return _unpack_msb(data[off : off + cnt], bits, row_samples, n_rows)

    def _ljpeg(off: int, cnt: int) -> np.ndarray:
        # lossless-JPEG tile/strip (native C++ decoder, native/ljpeg.cc);
        # decoded rows are (sof_w * ncomp) samples = the tile's CFA columns
        from rapidraw_tpu_torch.native import ljpeg_decode

        return ljpeg_decode(bytes(data[off : off + cnt]))

    if _T["TileOffsets"] in ifd:
        if _T["TileWidth"] not in ifd or _T["TileLength"] not in ifd:
            raise DngError("tiled raw IFD missing TileWidth/TileLength")
        tw = ifd[_T["TileWidth"]][0]
        tl = ifd[_T["TileLength"]][0]
        if tw <= 0 or tl <= 0:
            raise DngError(f"implausible tile dimensions {tw}x{tl}")
        offsets = ifd[_T["TileOffsets"]]
        counts = ifd.get(_T["TileByteCounts"])
        if not counts or len(counts) < len(offsets):
            # short/absent counts: same synthesis as the strip path (a
            # short list would IndexError below)
            counts = [0] * len(offsets)
        tiles_x = -(-width // tw)
        tiles_y = -(-height // tl)
        if len(offsets) > tiles_x * tiles_y:
            raise DngError(
                f"{len(offsets)} tile offsets exceed the "
                f"{tiles_x}x{tiles_y} tile grid"
            )
        for idx, off in enumerate(offsets):
            if compression == 7:
                tile = _ljpeg(off, counts[idx] or (len(data) - off))
                if tile.size != tl * tw * spp:
                    raise DngError(
                        f"tile {idx}: decoded {tile.shape} != {tl}x{tw * spp}"
                    )
                tile = tile.reshape(tl, tw * spp)
            else:
                tile = _uncompressed(off, counts[idx] or (len(data) - off), tw * spp, tl)
            ty, tx = divmod(idx, tiles_x)
            y0, x0 = ty * tl, tx * tw * spp
            h = min(tl, height - y0)
            w = min(tw * spp, width * spp - x0)
            plane[y0 : y0 + h, x0 : x0 + w] = tile[:h, :w]
    else:
        if _T["StripOffsets"] not in ifd:
            raise DngError("raw IFD missing StripOffsets")
        offsets = ifd[_T["StripOffsets"]]
        counts = ifd.get(_T["StripByteCounts"])
        if not counts or len(counts) < len(offsets):
            # synthesize from consecutive offsets — a short default list
            # would silently truncate the strip loop (zip) to black rows
            counts = [
                (offsets[i + 1] if i + 1 < len(offsets) else len(data)) - offsets[i]
                for i in range(len(offsets))
            ]
        rps = ifd.get(_T["RowsPerStrip"], [height])[0]
        if rps <= 0:
            raise DngError("implausible RowsPerStrip")
        row = 0
        for off, cnt in zip(offsets, counts):
            n_rows = min(rps, height - row)
            if compression == 7:
                strip = _ljpeg(off, cnt)
                if strip.size != n_rows * width * spp:
                    raise DngError(
                        f"strip: decoded {strip.shape} != {n_rows}x{width * spp}"
                    )
                strip = strip.reshape(n_rows, width * spp)
            else:
                strip = _uncompressed(off, cnt, width * spp, n_rows)
            plane[row : row + n_rows] = strip
            row += n_rows

    black = float(np.mean(ifd.get(_T["BlackLevel"], [0])))
    white = float(ifd.get(_T["WhiteLevel"], [(1 << bits) - 1])[0])

    neutral = ifd.get(_T["AsShotNeutral"]) or _first(ifds, _T["AsShotNeutral"]) or [1.0, 1.0, 1.0]
    if len(neutral) < 3:  # short tag would give wb.shape=(2,) and crash develop
        neutral = [1.0, 1.0, 1.0]
    neutral = np.asarray(neutral[:3], np.float64)
    neutral[neutral <= 0] = 1.0
    from rapidraw_tpu_torch.raw.color import normalize_wb

    wb = normalize_wb(1.0 / neutral)

    cm = _first(ifds, _T["ColorMatrix2"]) or _first(ifds, _T["ColorMatrix1"])
    xyz_to_cam = np.asarray(cm, np.float32).reshape(3, 3) if cm and len(cm) >= 9 else None
    orientation = (_first(ifds, _T["Orientation"]) or [1])[0]

    is_linear = photometric == 34892
    if is_linear and spp >= 3:
        cfa = plane.reshape(height, width, spp)[:, :, :3]
    elif is_linear:
        # monochrome LinearRaw (spp 1, e.g. Leica M Monochrom): replicate
        # to 3 channels so the linear develop path gets its (H, W, 3)
        cfa = np.repeat(plane[:, :width, None], 3, axis=2)
    else:
        cfa = plane[:, :width]

    return RawFile(
        cfa=cfa,
        pattern=_pattern_string(ifd),
        black_level=black,
        white_level=white,
        wb=wb,
        xyz_to_cam=xyz_to_cam,
        orientation=int(orientation),
        is_linear=is_linear,
    )


def _first(ifds: list[dict], tag: int):
    for i in ifds:
        if tag in i:
            return i[tag]
    return None


def upload_cfa(raw: RawFile, device=None) -> torch.Tensor:
    """raw.cfa on `device` in its own dtype (uint16 or uint8), cast on the
    device by `develop_raw`; `device` is the CUDA device unless the caller
    asks for another. A LinearRaw CFA is a strided view of its
    plane and a RAF block can be a read-only buffer: both are copied to a
    contiguous, writable, native-order array first."""
    arr = np.ascontiguousarray(raw.cfa)
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device or "cuda")


def develop_raw(
    cfa: torch.Tensor,
    raw: RawFile,
    highlight_compression: float = 2.5,
    linear_mode: str = "default",
    fast: bool = False,
) -> torch.Tensor:
    """The device part of the RAW load (JAX `load_raw_file`'s jitted
    `_develop`, :390-446): the uploaded CFA -> planar (3, H, W) float32
    scene-linear sRGB on the CFA's device, oriented per EXIF.

    highlight_compression / linear_mode mirror the settings the reference
    threads into develop_raw_image (image_loader.rs:69-70,
    raw_processing.rs:81-86). `fast` is the thumbnail path
    (use_fast_raw_dev): speed demosaic and a clamp to 1.0
    (raw_processing.rs:113-115, 130-134).
    """
    from rapidraw_tpu_torch.raw.color import camera_to_srgb_matrix
    from rapidraw_tpu_torch.raw.develop import (
        develop_cfa,
        develop_cfa_xtrans,
        develop_linear_raw,
    )

    if raw.xyz_to_cam is not None:
        cam2srgb = camera_to_srgb_matrix(raw.xyz_to_cam)
    else:
        cam2srgb = np.eye(3, dtype=np.float32)
    clamp_limit = 1.0 if fast else None
    black, white = raw.black_level, raw.white_level
    if raw.is_linear:
        apply_calibration = linear_mode not in ("skip_calib", "gamma_skip_calib")
        out = develop_linear_raw(
            cfa.permute(2, 0, 1).to(torch.float32), black, white,
            apply_ungamma=linear_mode in ("gamma", "gamma_skip_calib"),
            highlight_compression=highlight_compression,
            cam_matrix=(
                cam2srgb if apply_calibration and raw.xyz_to_cam is not None else None
            ),
            clamp_limit=clamp_limit,
        )
    elif raw.xtrans is not None:
        out = develop_cfa_xtrans(
            cfa.to(torch.float32), black, white, raw.wb, cam2srgb, raw.xtrans,
            highlight_compression=highlight_compression, clamp_limit=clamp_limit,
        )
    else:
        out = develop_cfa(
            cfa.to(torch.float32), black, white, raw.wb, cam2srgb,
            pattern=raw.pattern,
            algorithm="speed" if fast else "malvar",
            highlight_compression=highlight_compression,
            clamp_limit=clamp_limit,
        )
    return _orient_planar(out, int(raw.orientation)).contiguous()


def load_raw_file(
    path: str | Path,
    highlight_compression: float = 2.5,
    linear_mode: str = "default",
    fast: bool = False,
    device=None,
) -> torch.Tensor:
    """Decode and develop a RAW file to planar (3, H, W) scene-linear
    float32 on `device` (the CUDA device unless the caller asks for
    another): container decode on the host (`parse_raw`), one upload of
    the CFA in its own dtype (`upload_cfa`), the develop on the device
    (`develop_raw`). The result stays on the device."""
    from rapidraw_tpu_torch.io.containers import parse_raw

    p = Path(path)
    raw = parse_raw(p.read_bytes(), ext=p.suffix)
    return develop_raw(upload_cfa(raw, device), raw, highlight_compression, linear_mode, fast)


def _orient_planar(arr: torch.Tensor, orientation: int) -> torch.Tensor:
    """EXIF orientation 1-8 on planar (3, H, W), on the device
    (image_loader.rs:169-212; the mapping of loader._apply_exif_orientation)."""
    if orientation == 2:
        return torch.flip(arr, (2,))
    if orientation == 3:
        return torch.flip(arr, (1, 2))
    if orientation == 4:
        return torch.flip(arr, (1,))
    if orientation == 5:
        return torch.flip(torch.rot90(arr, k=-1, dims=(1, 2)), (2,))
    if orientation == 6:
        return torch.rot90(arr, k=-1, dims=(1, 2))
    if orientation == 7:
        return torch.flip(torch.rot90(arr, k=1, dims=(1, 2)), (2,))
    if orientation == 8:
        return torch.rot90(arr, k=1, dims=(1, 2))
    return arr
