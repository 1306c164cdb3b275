"""Image loading: file -> planar (3, H, W) float32 in input space, on the
device.

Port of `rapidraw_tpu/io/loader.py` (image_loader.rs:62-150): the RAW
branch (container decode on the host, the develop and the RAW enhance
pass on the device) and EXIF orientation. The LDR branch (PIL, the float
images, JPEG XL and 16-bit PNG/TIFF) is not ported yet: a non-RAW path
raises NotImplementedError.

Virtual-copy paths ("photo.jpg?vc=2") share the source file
(file_management.rs:165-196).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# the reference's full RAW extension list, formats.rs:4-71
RAW_EXTENSIONS = {
    "dng", "pro", "ari", "crw", "cr2", "cr3", "bay", "raw", "erf", "raf",
    "3fr", "fff", "iiq", "kdc", "k25", "dcs", "dcr", "mos", "rwl", "mef",
    "mrw", "nef", "nrw", "orf", "rw2", "pef", "ptx", "srw", "x3f", "arw",
    "srf", "sr2",
}


def parse_virtual_path(path: str) -> tuple[str, int | None]:
    """'photo.jpg?vc=2' -> ('photo.jpg', 2) (file_management.rs:165-196)."""
    if "?vc=" in path:
        base, _, vc = path.rpartition("?vc=")
        try:
            return base, int(vc)
        except ValueError:
            return path, None
    return path, None


def is_raw_file(path: str | Path) -> bool:
    return Path(str(path)).suffix.lower().lstrip(".") in RAW_EXTENSIONS


def _apply_exif_orientation(arr: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 on (H, W, 3) (image_loader.rs:169-212)."""
    if orientation == 2:
        return arr[:, ::-1]
    if orientation == 3:
        return arr[::-1, ::-1]
    if orientation == 4:
        return arr[::-1, :]
    if orientation == 5:
        return np.rot90(arr, k=-1, axes=(0, 1))[:, ::-1]
    if orientation == 6:
        return np.rot90(arr, k=-1, axes=(0, 1))
    if orientation == 7:
        return np.rot90(arr, k=1, axes=(0, 1))[:, ::-1]
    if orientation == 8:
        return np.rot90(arr, k=1, axes=(0, 1))
    return arr


def load_image(path: str | Path, app_settings=None, fast: bool = False,
               device=None) -> tuple[torch.Tensor, bool]:
    """Load a RAW file. Returns (planar float32 (3, H, W), is_raw), the
    image on `device`: the CUDA device unless the caller asks for another.

    Mirrors load_base_image_from_bytes (image_loader.rs:62-150):
      * the RAW develop honours rawHighlightCompression / linearRawMode;
      * the RAW enhance pass (chroma NR and gentle sharpen,
        raw/enhance.py) runs per the rawPreprocessing* settings, on by
        default (0.5 -> inverse sigma 14.0, sharpening 0.35;
        app_settings.rs:517-518);
      * `fast` is the thumbnail path (use_fast_raw_dev): speed demosaic,
        clamp to 1.0, no enhance.

    app_settings=None uses the reference's shipped defaults.
    """
    from rapidraw_tpu_torch.utils.settings import DEFAULTS, AppSettings

    s = app_settings if app_settings is not None else AppSettings(DEFAULTS)
    real, _vc = parse_virtual_path(str(path))
    if not is_raw_file(real):
        raise NotImplementedError(
            f"{real}: only RAW files load in rapidraw_tpu_torch so far; the LDR "
            "loader (PIL, float images, JPEG XL, 16-bit PNG/TIFF) comes with slice A.10b"
        )
    from rapidraw_tpu_torch.io.dng import load_raw_file
    from rapidraw_tpu_torch.raw.enhance import remove_raw_artifacts_and_enhance

    img = load_raw_file(
        real,
        highlight_compression=s.raw_highlight_compression,
        linear_mode=s.linear_raw_mode,
        fast=fast,
        device=device,
    )
    nr_amount, sharpening = s.preprocessing_amounts()
    if not fast and (nr_amount > 0.0 or sharpening > 0.0):
        img = remove_raw_artifacts_and_enhance(img, nr_amount, sharpening)
    return img, True


def to_uint8_hwc(planar) -> np.ndarray:
    """Planar f32 [0,1] (or already-quantized u8) -> (H, W, 3) u8 for
    encoding. u8 inputs come from device-side quantization (`device_u8`);
    its formula matches this one exactly, so the encoded bytes are
    identical either way."""
    if isinstance(planar, torch.Tensor):
        planar = planar.cpu().numpy()
    planar = np.asarray(planar)
    if planar.dtype == np.uint8:
        return planar.transpose(1, 2, 0)
    return (np.clip(planar, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
