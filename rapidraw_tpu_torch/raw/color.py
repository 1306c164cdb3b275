"""Host-side RAW color math: camera -> sRGB matrices, WB normalization.

The reference delegates this to rawler's develop pipeline
(raw_processing.rs:105-121); the math below is the standard dcraw/DNG
recipe: the camera's XYZ(D65)->camera color matrix is combined with the
sRGB->XYZ matrix, row-normalized so that the white-balanced camera white
(1,1,1) maps to sRGB white, then inverted.
"""

from __future__ import annotations

import numpy as np

# linear sRGB -> XYZ D65 (IEC 61966-2-1)
SRGB_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    np.float64,
)


def camera_to_srgb_matrix(xyz_to_cam: np.ndarray) -> np.ndarray:
    """Standard dcraw recipe: invert the row-normalized camera_from_sRGB.

    Args:
      xyz_to_cam: (3,3) camera color matrix (XYZ D65 -> camera RGB), e.g.
        the DNG ColorMatrix or Adobe coefficient table entry.
    Returns (3,3) float32 mapping white-balanced camera RGB -> linear sRGB.
    """
    cam_from_srgb = np.asarray(xyz_to_cam, np.float64) @ SRGB_TO_XYZ
    # normalize rows so camera white (1,1,1 after WB) maps to sRGB white
    cam_from_srgb /= cam_from_srgb.sum(axis=1, keepdims=True)
    return np.linalg.inv(cam_from_srgb).astype(np.float32)


def normalize_wb(wb_coeffs) -> np.ndarray:
    """Normalize as-shot WB multipliers so green == 1."""
    wb = np.asarray(wb_coeffs, np.float64)[:3]
    g = wb[1] if wb[1] > 0 else 1.0
    return (wb / g).astype(np.float32)
