"""Canon crx raw payload handling for CR3 (lossless path); a copy of
`rapidraw_tpu/io/crx.py`.

CMP1 box layout follows the public reverse engineering of the format
(libraw crx.cpp / dnglab's Cmp1Box): dimensions, tile grid, bit depth,
plane count + CFA layout, encoding type + wavelet level count. The tile
payload is decoded by csrc/host/crx.cc — a from-scratch implementation of
the publicly documented lossless structure (ff01/ff02/ff03 framing,
line-based MED prediction, adaptive Golomb-Rice). Everything validates
strictly; a stream that does not match raises ValueError and io/cr3.py
falls back to its precise UnsupportedRawFormat refusal (the embedded
PRVW preview keeps working), so real-camera files whose bit-level details
deviate from this implementation degrade gracefully rather than decode to
garbage. Round-trip conformance is pinned by tests/test_crx.py; bit-exact
conformance with Canon's own encoder is pending a real sample.

The reference gets this decode from rawler (Cargo.toml:27,
raw_processing.rs:15-30).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Cmp1:
    f_width: int
    f_height: int
    tile_width: int
    tile_height: int
    n_bits: int
    n_planes: int
    cfa_layout: int
    enc_type: int
    image_levels: int
    mdat_hdr_size: int = 0


# The real (libraw crxParseImageHeader / dnglab Cmp1Box) byte layout:
# i16 unknown @0, u16 headerSize @2, u16 version @4, u16 versionSub @6,
# u32 f_width @8, f_height @12, tileWidth @16, tileHeight @20,
# u8 nBits @24, u8 planes<<4|cfa @25, u8 encType<<4|levels @26,
# u8 tileFlags @27, u32 mdatHdrSize @28 — 32 bytes, padded to headerSize.
_CMP1_FMT = ">hHHHIIIIBBBBI"


def parse_cmp1(payload: bytes) -> Cmp1 | None:
    """Parse a CMP1 box payload; None when implausible (wrong dialect)."""
    if len(payload) < struct.calcsize(_CMP1_FMT):
        return None
    try:
        (_, _hdr_size, ver, _ver_sub, fw, fh, tw, th, bits, pb, el,
         _tiles, mdat_hdr) = struct.unpack_from(_CMP1_FMT, payload, 0)
    except struct.error:
        return None
    if ver not in (0x100, 0x200):  # the only versions cameras write
        return None
    cmp1 = Cmp1(
        f_width=fw, f_height=fh, tile_width=tw, tile_height=th,
        n_bits=bits, n_planes=pb >> 4, cfa_layout=pb & 0xF,
        enc_type=el >> 4, image_levels=el & 0xF, mdat_hdr_size=mdat_hdr,
    )
    if not (0 < fw <= 65535 and 0 < fh <= 65535):
        return None
    if not (8 <= cmp1.n_bits <= 16 and 1 <= cmp1.n_planes <= 4):
        return None
    if cmp1.tile_width <= 0 or cmp1.tile_height <= 0:
        return None
    return cmp1


def build_cmp1(cmp1: Cmp1) -> bytes:
    """Serialize (fixture builder + archival writer)."""
    body = struct.pack(
        _CMP1_FMT, -1, 0x30, 0x100, 0, cmp1.f_width, cmp1.f_height,
        cmp1.tile_width, cmp1.tile_height, cmp1.n_bits,
        (cmp1.n_planes << 4) | cmp1.cfa_layout,
        (cmp1.enc_type << 4) | cmp1.image_levels, 0, cmp1.mdat_hdr_size,
    )
    return body + b"\0" * (0x30 - len(body) if len(body) < 0x30 else 0)


# CFA subplane placement per cfa_layout: ((row, col) of each plane in the
# 2x2 Bayer cell). Layout 0 = RGGB is the only one observed in CR3s.
_CFA_PLACEMENTS = {
    0: ((0, 0), (0, 1), (1, 0), (1, 1)),  # R G / G B
    1: ((0, 1), (0, 0), (1, 1), (1, 0)),  # G R / B G
    2: ((1, 0), (1, 1), (0, 0), (0, 1)),  # G B / R G mirrored vertically
    3: ((1, 1), (1, 0), (0, 1), (0, 0)),
}
_CFA_PATTERNS = {0: "RGGB", 1: "GRBG", 2: "GBRG", 3: "BGGR"}


def cfa_pattern(cmp1: Cmp1) -> str:
    return _CFA_PATTERNS.get(cmp1.cfa_layout, "RGGB")


def decode_raw(sample: bytes, cmp1: Cmp1) -> np.ndarray:
    """Decode one crx sample -> (f_height, f_width) uint16 Bayer mosaic.

    Raises ValueError on unsupported modes (lossy wavelet levels, partial
    tiles) or any framing/bitstream mismatch.
    """
    if cmp1.enc_type != 0 or cmp1.image_levels != 0:
        raise ValueError(
            f"crx lossy path (encType {cmp1.enc_type}, levels "
            f"{cmp1.image_levels}) not supported; lossless only"
        )
    if cmp1.n_planes != 4:
        raise ValueError(f"crx with {cmp1.n_planes} planes not supported")
    if (cmp1.tile_width, cmp1.tile_height) != (cmp1.f_width, cmp1.f_height):
        raise ValueError("crx multi-tile layout not supported")
    if cmp1.f_width % 2 or cmp1.f_height % 2:
        raise ValueError("crx frame dims must be even (2x2 CFA cells)")
    if not (0 <= cmp1.mdat_hdr_size < len(sample)):
        raise ValueError(
            f"crx mdat header size {cmp1.mdat_hdr_size} outside the "
            f"{len(sample)}-byte sample"
        )
    from rapidraw_tpu_torch.native import crx_decode

    pw, ph = cmp1.f_width // 2, cmp1.f_height // 2
    body = sample[cmp1.mdat_hdr_size :] if cmp1.mdat_hdr_size else sample
    planes = crx_decode(bytes(body), 4, pw, ph)
    out = np.empty((cmp1.f_height, cmp1.f_width), np.uint16)
    placement = _CFA_PLACEMENTS.get(cmp1.cfa_layout, _CFA_PLACEMENTS[0])
    for plane, (r, c) in zip(planes, placement):
        out[r::2, c::2] = plane
    return out


def encode_raw(bayer: np.ndarray, n_bits: int = 14, cfa_layout: int = 0):
    """(sample_bytes, Cmp1) from a (H, W) uint16 mosaic — fixture builder
    and CR3-style archival encode (the inverse of decode_raw)."""
    h, w = bayer.shape
    if h % 2 or w % 2:
        raise ValueError("mosaic dims must be even")
    placement = _CFA_PLACEMENTS.get(cfa_layout, _CFA_PLACEMENTS[0])
    planes = np.stack([bayer[r::2, c::2] for r, c in placement])
    from rapidraw_tpu_torch.native import crx_encode

    sample = crx_encode(planes)
    cmp1 = Cmp1(
        f_width=w, f_height=h, tile_width=w, tile_height=h,
        n_bits=n_bits, n_planes=4, cfa_layout=cfa_layout,
        enc_type=0, image_levels=0,
    )
    return sample, cmp1
