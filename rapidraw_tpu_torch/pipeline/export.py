"""Device quantizers and the single-image render entry.

Port of the slice's part of `rapidraw_tpu/pipeline/export.py`: `_device_u8`
(:127), `_device_u16` (:114) and `develop_single_compiled` (:152). The
quantization runs on the image's device before readback, with the same
rounding as the host encode: clip(y, 0, 1) * max + 0.5, then truncate.
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.params.parse import DevelopConfig
from rapidraw_tpu_torch.pipeline.bands import blur_band_rows
from rapidraw_tpu_torch.pipeline.batch import develop_batch, stack_params


def device_u8(x: torch.Tensor) -> torch.Tensor:
    """Quantize [0, 1] float to uint8 on the tensor's device."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def device_u16(x: torch.Tensor) -> torch.Tensor:
    """Quantize [0, 1] float to uint16 on the tensor's device."""
    return (torch.clamp(x, 0.0, 1.0) * 65535.0 + 0.5).to(torch.uint16)


def develop_single(image: torch.Tensor, params: dict, cfg: DevelopConfig,
                   masks=None, lut=None, flare=None) -> torch.Tensor:
    """One (3, H, W) image (and its (N, H, W) mask influences, LUT cube
    and flare map, as `develop`) through the same batch-of-1 entry an
    export chunk renders with, so single renders match batch renders
    exactly; mask-only blur levels are band-restricted as the JAX entry
    does."""
    sp, scfg = stack_params([params], [cfg], device=image.device)
    bands = blur_band_rows(scfg, masks) if masks is not None else None
    mk = torch.as_tensor(masks)[None] if masks is not None else None
    return develop_batch(image[None], sp, scfg, masks=mk, lut=lut, flare=flare,
                         blur_bands=bands)[0]
