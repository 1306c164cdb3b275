"""3D LUT file parsing: .cube, .3dl, HALD images (host NumPy).

A copy of `rapidraw_tpu/io/lut.py` (lut_processing.rs:22-187, identity and
export helpers :285-328), with its two documented .3dl divergences.
Returned arrays are (L, L, L, 3) float32 indexed [r, g, b], the layout
`ops/lut3d.py` and the grade kernel sample (.cube's fastest axis, red, is
the texture x axis). A HALD image (a .png, .jpg, .jpeg or .tiff file, in
whatever format its bytes hold) is read by the port's decoders as PIL's
convert("RGB") reads it, at 8 bits (io/loader.decode_rgb8).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class LutError(ValueError):
    pass


def _data_to_cube(data: np.ndarray, size: int) -> np.ndarray:
    # flat triples in .cube order (r fastest, then g, then b)
    return data.reshape(size, size, size, 3).transpose(2, 1, 0, 3).copy()


def parse_cube(text: str) -> np.ndarray:
    size = None
    vals: list[float] = []
    for line_num, line in enumerate(text.splitlines(), 1):
        t = line.strip()
        if not t or t.startswith("#"):
            continue
        parts = t.split()
        head = parts[0].upper()
        if head in ("TITLE", "DOMAIN_MIN", "DOMAIN_MAX"):
            continue
        if head == "LUT_3D_SIZE":
            if len(parts) < 2:
                raise LutError(f"Malformed LUT_3D_SIZE on line {line_num}")
            size = int(parts[1])
            continue
        if size is not None:
            if len(parts) < 3:
                raise LutError(f"Invalid data line {line_num}: expected 3 floats")
            vals.extend(float(p) for p in parts[:3])
    if size is None:
        raise LutError("LUT_3D_SIZE not found in .cube file")
    data = np.asarray(vals, np.float32)
    if data.size != size**3 * 3:
        raise LutError(
            f"LUT data size mismatch: expected {size**3 * 3} values, found {data.size}"
        )
    return _data_to_cube(data, size)


def parse_3dl(text: str) -> np.ndarray:
    vals: list[float] = []
    mesh: list[float] | None = None
    for line in text.splitlines():
        t = line.strip()
        if not t or t.startswith("#"):
            continue
        parts = t.split()
        if len(parts) == 3:
            try:
                vals.extend(float(p) for p in parts)
            except ValueError:
                continue
        elif len(parts) > 3 and mesh is None:
            # the input-mesh header line (e.g. 17 values "0 64 ... 1023"):
            # its last value is the format's true full scale
            try:
                mesh = [float(p) for p in parts]
            except ValueError:
                continue
    if not vals:
        raise LutError("No data found in 3DL file")
    n = len(vals) // 3
    size = int(round(n ** (1 / 3)))
    if size**3 != n:
        raise LutError(f"Invalid 3DL LUT: {n} entries is not a perfect cube")
    data = np.asarray(vals, np.float32)
    # .3dl stores INTEGER code values (Autodesk/Lustre: 10/12/16-bit);
    # normalize by the input mesh's full scale when present, else by the
    # peak's implied bit depth. Documented divergence from the reference,
    # whose parse_3dl (lut_processing.rs:120-155) feeds the raw integers to
    # the sampler and blows out every real-world .3dl.
    if mesh and mesh[-1] > 2.0:
        data = data / float(mesh[-1])
    else:
        peak = float(data.max())
        if peak > 2.0:
            bits = max(int(np.ceil(np.log2(peak + 1.0))), 2)
            data = data / float((1 << bits) - 1)
    # .3dl entry order is BLUE fastest / red slowest (OCIO FileFormat3DL),
    # so the reshape is already [r][g][b] — no .cube-style transpose.
    # (Second documented divergence: the reference uploads the raw order
    # and renders .3dl with red/blue lattice axes exchanged.)
    return data.reshape(size, size, size, 3).copy()


def parse_hald(image: np.ndarray) -> np.ndarray:
    """HALD CLUT image (H == W, pixels form a perfect cube). image: (H,W,3) u8."""
    h, w = image.shape[:2]
    if h != w:
        raise LutError(f"HALD image must be square, got {w}x{h}")
    total = h * w
    size = int(round(total ** (1 / 3)))
    if size**3 != total:
        raise LutError(f"Invalid HALD dimensions: {total} pixels is not a perfect cube")
    data = image.reshape(-1, 3).astype(np.float32) / 255.0
    return _data_to_cube(data.reshape(-1), size)


def parse_lut_file(path: str | Path) -> np.ndarray:
    path = Path(path)
    ext = path.suffix.lower().lstrip(".")
    if ext == "cube":
        return parse_cube(path.read_text(errors="replace"))
    if ext == "3dl":
        return parse_3dl(path.read_text(errors="replace"))
    if ext in ("png", "jpg", "jpeg", "tiff"):
        from rapidraw_tpu_torch.io.loader import decode_rgb8

        return parse_hald(decode_rgb8(path.read_bytes()))
    raise LutError(f"Unsupported LUT file format: {ext}")


def identity_lut(size: int) -> np.ndarray:
    """(L, L, L, 3) identity cube (lut_processing.rs:285-303)."""
    ax = np.linspace(0.0, 1.0, size, dtype=np.float32)
    r, g, b = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([r, g, b], axis=-1)


def lut_to_cube_text(lut: np.ndarray) -> str:
    """Serialize an (L, L, L, 3) cube back to .cube (rs:305-328)."""
    size = lut.shape[0]
    lines = [f"LUT_3D_SIZE {size}", "DOMAIN_MIN 0.0 0.0 0.0", "DOMAIN_MAX 1.0 1.0 1.0"]
    # .cube order: r fastest
    flat = lut.transpose(2, 1, 0, 3).reshape(-1, 3)
    for r, g, b in flat:
        lines.append(f"{r:.6f} {g:.6f} {b:.6f}")
    return "\n".join(lines) + "\n"
