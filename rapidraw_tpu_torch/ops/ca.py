"""Chromatic aberration correction: radial per-channel resampling.

Port of the static path of `rapidraw_tpu/ops/ca.py` (shader.wgsl:1077-1105):
the red and blue channels are re-sampled at positions shifted toward or
away from the image centre by a distance-proportional amount (nearest
neighbour via round). CA amounts are document-constant (a batch with mixed
amounts is refused by merge_configs), so the shift becomes two 1-D index
vectors per channel, computed on the host in float64 exactly as the JAX
package does. Plain PyTorch indexing on the image's device: the JAX package
runs this in XLA too, not in a Pallas kernel. Planar (..., 3, H, W).
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_indices(n: int, ca: float) -> np.ndarray:
    """Sample indices for one axis: x - (x - n/2) * ca, rounded and clamped."""
    a = np.arange(n, dtype=np.float64)
    return np.clip(np.round(a - (a - n / 2.0) * ca), 0, n - 1).astype(np.int64)


def _resample(plane: torch.Tensor, ca: float) -> torch.Tensor:
    h, w = plane.shape[-2:]
    iy = torch.from_numpy(_axis_indices(h, ca)).to(plane.device)
    ix = torch.from_numpy(_axis_indices(w, ca)).to(plane.device)
    return plane.index_select(-2, iy).index_select(-1, ix)


def apply_ca_correction(input_rgb: torch.Tensor, static_rc: float,
                        static_by: float) -> torch.Tensor:
    """input_rgb: (..., 3, H, W) input-space texture; static_rc/static_by:
    the document's red/cyan and blue/yellow amounts."""
    r = input_rgb[..., 0, :, :]
    b = input_rgb[..., 2, :, :]
    if static_rc != 0.0:
        r = _resample(r, static_rc)
    if static_by != 0.0:
        b = _resample(b, static_by)
    return torch.stack([r, input_rgb[..., 1, :, :], b], dim=-3)
