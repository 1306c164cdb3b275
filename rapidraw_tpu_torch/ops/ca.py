"""Chromatic aberration correction: radial per-channel resampling.

Port of the static path of `rapidraw_tpu/ops/ca.py` (shader.wgsl:1077-1105):
the red and blue channels are re-sampled at positions shifted toward or
away from the image centre by a distance-proportional amount (nearest
neighbour via round). CA amounts are document-constant (a batch with mixed
amounts is refused by merge_configs), so the shift becomes two 1-D index
vectors per channel, computed on the host in float64 exactly as the JAX
package does. One tile of a larger image (the tiled develop) passes its
origin and the full image's size: the optical centre is the full image's
and the clamp happens in absolute coordinates, so every tile samples what
the whole image would (JAX's `ca_host_indices`). Plain PyTorch indexing on
the image's device: the JAX package runs this in XLA too, not in a Pallas
kernel. Planar (..., 3, H, W).
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_indices(n: int, ca: float, off: int, n_full: int) -> np.ndarray:
    """Local sample indices for one axis of a (possibly tiled) image:
    a - (a - n_full/2) * ca on the absolute coordinate a, rounded, clamped
    to the full image, then to the tile (JAX ca.py:14-28)."""
    a = np.arange(n, dtype=np.float64) + off
    idx = np.clip(np.round(a - (a - n_full / 2.0) * ca), 0, n_full - 1) - off
    return np.clip(idx, 0, n - 1).astype(np.int64)


def _resample(plane: torch.Tensor, ca: float, tile_offset, full_size) -> torch.Tensor:
    h, w = plane.shape[-2:]
    (x_off, y_off), (w_full, h_full) = tile_offset, full_size
    iy = torch.from_numpy(_axis_indices(h, ca, y_off, h_full)).to(plane.device)
    ix = torch.from_numpy(_axis_indices(w, ca, x_off, w_full)).to(plane.device)
    return plane.index_select(-2, iy).index_select(-1, ix)


def apply_ca_correction(input_rgb: torch.Tensor, static_rc: float, static_by: float,
                        tile_offset=(0, 0),
                        full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """input_rgb: (..., 3, H, W) input-space texture; static_rc/static_by:
    the document's red/cyan and blue/yellow amounts; tile_offset/full_size:
    the tile's origin (x, y) and its image's (w, h), the whole image when
    omitted."""
    h, w = input_rgb.shape[-2:]
    full_size = full_size if full_size is not None else (w, h)
    r = input_rgb[..., 0, :, :]
    b = input_rgb[..., 2, :, :]
    if static_rc != 0.0:
        r = _resample(r, static_rc, tile_offset, full_size)
    if static_by != 0.0:
        b = _resample(b, static_by, tile_offset, full_size)
    return torch.stack([r, input_rgb[..., 1, :, :], b], dim=-3)
