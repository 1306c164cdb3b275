"""The develop entry for one image.

Port of `rapidraw_tpu/pipeline/develop.py`: CA -> linearize -> NR -> blur
pyramid (mask-only levels over their row bands) -> grade chain with the
mask blend -> grain -> clipping -> dither. Flare, the LUT and NR driven by
masks are later slices and raise NotImplementedError.

The port has one path: the JAX package's XLA chain and its megakernel are
two implementations, but here the blur, NR and grade wrappers already
choose between the CUDA kernels and their plain PyTorch versions by the
tensor's device, so `develop` is the batched path with B = 1 (the JAX
`prepare_inputs` work — CA and NR, blur levels in input space — lives in
pipeline/fused.py).
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.params.parse import DevelopConfig
from rapidraw_tpu_torch.pipeline.fused import develop_fused


def develop(image: torch.Tensor, params: dict, cfg: DevelopConfig,
            masks=None, blur_bands: tuple | None = None) -> torch.Tensor:
    """Develop one planar (3, H, W) float32 image in input space (sRGB for
    LDR sources, scene-linear for RAW) to clamped sRGB (3, H, W).

    params: {'glob': {...}, 'mask': {...} | None} from parse_adjustments;
    masks: the (N, H, W) influences of its N masks (rasterize_masks);
    blur_bands: blur_band_rows(cfg, masks).
    """
    if image.ndim != 3 or image.shape[0] != 3:
        raise ValueError(
            f"develop() expects a PLANAR (3, H, W) image, got {tuple(image.shape)}; "
            "convert interleaved (H, W, C) with np.moveaxis(img, -1, 0) (and drop alpha)"
        )
    return develop_fused(image, params, cfg, masks=masks, blur_bands=blur_bands)
