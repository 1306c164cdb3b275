"""HDR exposure merge.

Port of `rapidraw_tpu/compositions/hdr.py`, the reference's `merge_hdr`
command (lib.rs:1399-1506, the image-hdr crate): frames are linearized,
weighted by a hat function over pixel value and averaged as radiance
estimates v / (exposure_time * gain), on the frames' device. All frames
must share dimensions (lib.rs:1450-1473).
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops.common import true_div


class HdrError(ValueError):
    pass


def _hat_weight(v: torch.Tensor) -> torch.Tensor:
    """Triangle (hat) weighting centred at 0.5, floored so extreme
    exposures still contribute (Debevec-style)."""
    return torch.clamp_min(1.0 - torch.abs(v - 0.5) * 2.0, 0.02)


def merge_hdr(images: list[torch.Tensor], exposures_secs: list[float],
              gains_iso: list[float]) -> torch.Tensor:
    """Merge linearized planar (3, H, W) frames into linear radiance.

    Args:
      images: scene-linear [0,1] frames (sRGB sources linearized first,
        lib.rs:1433-1435), on one device.
      exposures_secs: shutter time per frame (lib.rs:1442-1446).
      gains_iso: ISO per frame (lib.rs:1436-1440).

    Returns planar (3, H, W) merged radiance scaled by the median frame's
    effective exposure (t * gain), so the best-exposed content lands in
    [0, 1].
    """
    if len(images) < 2:
        raise HdrError("Please select at least two images to merge.")
    if not (len(images) == len(exposures_secs) == len(gains_iso)):
        raise HdrError("images, exposures and gains must align")
    shape = tuple(images[0].shape)
    for i, img in enumerate(images[1:], 1):
        if tuple(img.shape) != shape:
            raise HdrError(
                f"Dimension mismatch: image 0 is {shape[2]}x{shape[1]}, "
                f"image {i} is {img.shape[2]}x{img.shape[1]}"
            )

    dev = images[0].device
    num = torch.zeros(shape, dtype=torch.float32, device=dev)
    den = torch.zeros(shape, dtype=torch.float32, device=dev)
    for img, t, iso in zip(images, exposures_secs, gains_iso):
        if t <= 0 or iso <= 0:
            raise HdrError("exposure time and ISO must be positive")
        w = _hat_weight(img)
        radiance = true_div(img, t * (iso / 100.0))
        num = num + w * radiance
        den = den + w
    merged = num / torch.clamp_min(den, 1e-9)

    factors = [float(t) * (float(g) / 100.0) for t, g in zip(exposures_secs, gains_iso)]
    scale = sorted(factors)[len(factors) // 2]
    return merged * scale


def _present(v) -> bool:
    """PIL's truth of a tag value: an IFDRational is false at 0 (true at
    NaN, a zero denominator)."""
    from rapidraw_tpu_torch.io.exif import Rational

    if isinstance(v, Rational):
        return bool(v.value)
    return bool(v)


def read_exif_exposure(path: str) -> tuple[float | None, float | None]:
    """(exposure_secs, iso) from the file's EXIF (lib.rs read_exposure /
    read_iso): ExposureTime, then ISOSpeedRatings (0x8827) or
    PhotographicSensitivity (0x8833), from IFD0 merged with the Exif IFD as
    PIL's `getexif()` and `get_ifd(0x8769)` give them; (None, None) where
    PIL would not open the file or a value does not read."""
    from rapidraw_tpu_torch.io import exif as ex

    def read(buf):
        exif, _ = ex._open_exif(buf)
        if exif is None:
            raise ValueError("no image PIL would open")
        merged = exif.items()
        try:
            merged.update(exif.get_ifd(0x8769))  # Exif IFD
        except Exception:  # noqa: BLE001
            pass
        exp = merged.get(0x829A)  # ExposureTime
        iso = merged.get(0x8827)
        if not _present(iso):
            iso = merged.get(0x8833)

        def rational(v):
            # a (num, den) tuple reads as its quotient, as JAX reads it
            if isinstance(v, tuple) and len(v) == 2:
                return float(v[0]) / float(v[1]) if v[1] else None
            return float(v)

        exp_f = rational(exp) if _present(exp) else None
        if isinstance(iso, (list, tuple)):
            iso = iso[0] if iso else None
        iso_f = float(iso) if _present(iso) else None
        return exp_f, iso_f

    try:
        return ex._read_file(path, read)
    except Exception:  # noqa: BLE001
        return None, None
