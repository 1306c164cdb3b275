"""Image loading: file -> planar (3, H, W) float32 in input space, on the
device.

Port of `rapidraw_tpu/io/loader.py` (image_loader.rs:62-150): the RAW
branch (container decode on the host, the develop and the RAW enhance
pass on the device), the LDR branch and EXIF orientation. The JAX package
decodes LDR files through PIL and cv2; the port has decoders of its own
(io/image_decode.py's dispatcher over io/jpeg.py, io/tiff.py, io/encode.py's
PNG views, io/webp.py, io/gif.py, io/bmp.py, io/tga.py, io/ico.py,
io/dds.py, io/qoi.py and io/pnm.py; io/float_images.py; io/jxl.py) that
give the same samples, and uploads them as u8 or u16 to be scaled on the
device.

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


FLOAT_EXTENSIONS = {"hdr", "exr", "ff", "pam"}


def upload_scaled(hwc: np.ndarray, scale: float, device) -> torch.Tensor:
    """(H, W, 3) u8 or u16 host -> (3, H, W) float32 [0, 1] on `device`:
    the integer samples upload (a quarter or half the bytes of float32),
    the cast, transpose and division by `scale` run on the device. The
    division is a true float32 division (a same-device divisor: CUDA's
    division by a Python scalar multiplies by the reciprocal), as the JAX
    package's `/ 255.0` and `/ 65535.0` round."""
    from rapidraw_tpu_torch.ops.common import true_div

    arr = np.ascontiguousarray(hwc)
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))  # a big-endian TIFF's '>u2' array
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr).to(device)
    return true_div(t.permute(2, 0, 1).to(torch.float32), scale).contiguous()


def _load_deep_u16(data: bytes, ext: str) -> np.ndarray | None:
    """(H, W, 3) u16 of a 16-bit PNG or TIFF, as JAX `_load_deep_u16`
    (loader.py:110-146) reads it (cv2 for PNG and compressed TIFF, its own
    strip reader for uncompressed TIFF), else None: the 8-bit path."""
    if ext in ("tif", "tiff"):
        from rapidraw_tpu_torch.io.tiff import read_tiff16_rgb

        try:
            return read_tiff16_rgb(data)
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 — malformed deep file: the 8-bit path
            return None
    from rapidraw_tpu_torch.io.encode import decode_png_u16

    return decode_png_u16(data)


def decode_rgb8(data: bytes) -> np.ndarray:
    """(H, W, 3) u8 of any LDR file the port decodes, as PIL's
    `Image.open(...).convert("RGB")` gives it; the format is sniffed from
    the bytes, as PIL sniffs it."""
    from rapidraw_tpu_torch.io.image_decode import decode_image

    return decode_image(data, "RGB")


def load_ldr(path: str | Path, device=None) -> torch.Tensor:
    """Decode an LDR file to planar (3, H, W) float32 sRGB-encoded [0, 1] on
    `device` (the CUDA device unless the caller asks for another), as JAX
    `load_ldr` (loader.py:61-107): the float images clamped to [0, 1],
    JPEG XL through libjxl, 16-bit PNG and TIFF at full depth, every other
    file through io/image_decode.py, as PIL's `convert("RGB")` gives it;
    EXIF orientation, as PIL's `getexif()` finds it, applied on the host."""
    from rapidraw_tpu_torch.io.exif import image_orientation

    device = device if device is not None else "cuda"
    ext = Path(str(path)).suffix.lower().lstrip(".")
    if ext in FLOAT_EXTENSIONS:
        from rapidraw_tpu_torch.io.float_images import load_float_image

        arr = np.clip(load_float_image(path), 0.0, 1.0)
        return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1))).to(device)
    data = Path(path).read_bytes()
    if ext == "jxl":
        from rapidraw_tpu_torch.io.jxl import decode_jxl

        return upload_scaled(decode_jxl(data)[..., :3], 255.0, device)
    if ext in ("png", "tif", "tiff"):
        deep = _load_deep_u16(data, ext)
        if deep is not None:
            arr16 = _apply_exif_orientation(deep, image_orientation(data))
            return upload_scaled(arr16, 65535.0, device)
    from rapidraw_tpu_torch.io.image_decode import open_image

    frame = open_image(data)
    arr = _apply_exif_orientation(frame.convert("RGB"), frame.orientation)
    return upload_scaled(arr, 255.0, device)


def load_image(path: str | Path, app_settings=None, fast: bool = False,
               device=None) -> tuple[torch.Tensor, bool]:
    """Load any supported file. Returns (planar float32 (3, H, W), is_raw),
    the image on `device`: the CUDA device unless the caller asks for
    another.

    Mirrors load_base_image_from_bytes (image_loader.rs:62-150):
      * the RAW develop honours rawHighlightCompression / linearRawMode;
      * the RAW enhance pass (chroma NR and gentle sharpen,
        raw/enhance.py) runs per the rawPreprocessing* settings, on by
        default (0.5 -> inverse sigma 14.0, sharpening 0.35;
        app_settings.rs:517-518), and on LDR files too when
        applyPreprocessingToNonRaws is set;
      * `fast` is the thumbnail path (use_fast_raw_dev): speed demosaic,
        clamp to 1.0, no enhance.

    app_settings=None uses the reference's shipped defaults.
    """
    from rapidraw_tpu_torch.raw.enhance import remove_raw_artifacts_and_enhance
    from rapidraw_tpu_torch.utils.settings import DEFAULTS, AppSettings

    s = app_settings if app_settings is not None else AppSettings(DEFAULTS)
    real, _vc = parse_virtual_path(str(path))
    nr_amount, sharpening = s.preprocessing_amounts()
    run_enhance = not fast and (nr_amount > 0.0 or sharpening > 0.0)
    if is_raw_file(real):
        from rapidraw_tpu_torch.io.dng import load_raw_file

        img = load_raw_file(
            real,
            highlight_compression=s.raw_highlight_compression,
            linear_mode=s.linear_raw_mode,
            fast=fast,
            device=device,
        )
        if run_enhance:
            img = remove_raw_artifacts_and_enhance(img, nr_amount, sharpening)
        return img, True
    img = load_ldr(real, device=device)
    if run_enhance and s.apply_preprocessing_to_non_raws:
        img = remove_raw_artifacts_and_enhance(img, nr_amount, sharpening)
    return img, False


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
