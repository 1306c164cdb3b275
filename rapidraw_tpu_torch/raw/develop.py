"""RAW develop: CFA mosaic -> scene-linear RGB ready for the main pipeline.

Port of `rapidraw_tpu/raw/develop.py` (the reference's rawler-driven
develop, raw_processing.rs:48-231), as plain PyTorch on the CFA's device:
  1. normalize: (raw - black) / (white - black), unclipped;
  2. white-balance multipliers on the CFA sites;
  3. demosaic (bilinear / malvar / 2x2 speed, or X-Trans);
  4. camera matrix -> linear sRGB primaries;
  5. highlight compression toward the min channel with a luma-preserving
     rescale (:160-183), then a clamp to [0, highlight_compression].

The output feeds `develop_batch` with `cfg.is_raw = True`, which treats
the input as scene-linear. Divisions by a constant go through `true_div`
so that the card rounds them as the CPU (and JAX) do.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
from rapidraw_tpu_torch.ops.common import mat3_apply, true_div
from rapidraw_tpu_torch.raw.demosaic import (
    _phase_masks,
    demosaic_bilinear,
    demosaic_malvar,
    demosaic_speed,
)
from rapidraw_tpu_torch.raw.xtrans import demosaic_xtrans, xtrans_site_masks

_ALGOS = {
    "bilinear": demosaic_bilinear,
    "malvar": demosaic_malvar,
    "speed": demosaic_speed,
}


def _matrix(m: np.ndarray) -> list[list[float]]:
    """A 3x3 matrix as float32 values held in Python floats: each product
    with a float32 plane is the float32 product, as with JAX's f32 array."""
    return np.asarray(m, np.float32).tolist()


def _normalize(raw: torch.Tensor, black_level: float, white_level: float) -> torch.Tensor:
    return true_div(raw.to(torch.float32) - black_level, max(white_level - black_level, 1.0))


def apply_highlight_compression(
    rgb: torch.Tensor, highlight_compression: float,
    clamp_limit: float | None = None,
) -> torch.Tensor:
    """Channel-coupled highlight rolloff (raw_processing.rs:160-183).

    Values whose max channel exceeds 1.0 are compressed toward the pixel's
    min channel (reducing chroma), then rescaled so the max channel is
    kept; everything then clamps to [0, clamp_limit]: the compression
    limit normally, 1.0 on the fast-demosaic path (raw_processing.rs:130-134).
    """
    shc = max(float(highlight_compression), 1.01)
    limit = shc if clamp_limit is None else float(clamp_limit)
    r = torch.clamp_min(rgb, 0.0)
    max_c = r.amax(dim=0)
    min_c = r.amin(dim=0)
    factor = torch.clamp(1.0 - true_div(max_c - 1.0, shc - 1.0), 0.0, 1.0)
    compressed = min_c + (r - min_c) * factor
    compressed_max = compressed.amax(dim=0)
    big = compressed_max > 1e-6
    rescale = max_c / torch.where(big, compressed_max, 1.0)
    result = torch.where(big, compressed * rescale, max_c)
    out = torch.where(max_c > 1.0, result, r)
    return torch.clamp(out, 0.0, limit)


def develop_cfa(
    cfa: torch.Tensor,
    black_level: float,
    white_level: float,
    wb: np.ndarray,
    cam_to_srgb: np.ndarray,
    pattern: str = "RGGB",
    algorithm: str = "malvar",
    highlight_compression: float = 2.5,
    clamp_limit: float | None = None,
) -> torch.Tensor:
    """CFA (H, W) uint16/float -> planar (3, H, W) float32 scene-linear sRGB.

    wb: (3,) multipliers normalized to green == 1 (raw/color.normalize_wb);
    cam_to_srgb: (3, 3) from raw/color.camera_to_srgb_matrix.
    """
    h, w = cfa.shape
    x = _normalize(cfa, black_level, white_level)
    masks = _phase_masks(h, w, pattern, cfa.device)
    gain = masks["R"] * float(wb[0]) + masks["G"] * float(wb[1]) + masks["B"] * float(wb[2])
    x = x * gain
    del gain, masks
    rgb = _ALGOS[algorithm](x, pattern)
    del x
    rgb = mat3_apply(_matrix(cam_to_srgb), rgb)
    return apply_highlight_compression(rgb, highlight_compression, clamp_limit)


def develop_cfa_xtrans(
    cfa: torch.Tensor,
    black_level: float,
    white_level: float,
    wb: np.ndarray,
    cam_to_srgb: np.ndarray,
    xtrans: np.ndarray,
    highlight_compression: float = 2.5,
    clamp_limit: float | None = None,
) -> torch.Tensor:
    """X-Trans CFA (H, W) -> planar (3, H, W) scene-linear sRGB: the chain
    of develop_cfa with the 6x6-periodic demosaic of raw/xtrans.py."""
    h, w = cfa.shape
    x = _normalize(cfa, black_level, white_level)
    site = xtrans_site_masks(np.asarray(xtrans, np.int32), h, w, cfa.device)
    gain = site[0] * float(wb[0]) + site[1] * float(wb[1]) + site[2] * float(wb[2])
    x = x * gain
    del gain
    rgb = demosaic_xtrans(x, xtrans)
    del x
    rgb = mat3_apply(_matrix(cam_to_srgb), rgb)
    return apply_highlight_compression(rgb, highlight_compression, clamp_limit)


def develop_linear_raw(
    rgb: torch.Tensor,
    black_level: float,
    white_level: float,
    apply_ungamma: bool = False,
    highlight_compression: float = 2.5,
    cam_matrix: np.ndarray | None = None,
    clamp_limit: float | None = None,
) -> torch.Tensor:
    """Linear-DNG path (raw_processing.rs:81-86, 107-112, 138-188): no
    demosaic; optional camera-matrix calibration (skipped for the
    'skip_calib' linear modes), optional sRGB ungamma (the 'gamma' modes),
    the same highlight handling. rawler's Calibrate step runs first, then
    the rescaled values are ungamma'd (raw_processing.rs:148-158)."""
    x = _normalize(rgb, black_level, white_level)
    if cam_matrix is not None:
        x = mat3_apply(_matrix(cam_matrix), x)
    x = torch.clamp_min(x, 0.0)
    if apply_ungamma:
        x = srgb_to_linear(torch.clamp(x, 0.0, 1.0))
    return apply_highlight_compression(x, highlight_compression, clamp_limit)
