"""The develop entry for one image.

Port of `rapidraw_tpu/pipeline/develop.py`: CA -> linearize -> NR (on
the static grid, or per pixel when masks drive it) -> blur pyramid
(mask-only levels over their row bands) -> flare map -> grade chain with
the mask blend and the flare -> 3D LUT -> grain -> clipping -> dither.

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
            masks=None, lut=None, flare=None, blur_bands: tuple | None = None,
            tile_offset=(0, 0), full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """Develop one planar (3, H, W) float32 image in input space (sRGB for
    LDR sources, scene-linear for RAW) to clamped sRGB (3, H, W).

    params: {'glob': {...}, 'mask': {...} | None} from parse_adjustments;
    masks: the (N, H, W) influences of its N masks (rasterize_masks);
    lut: the (L, L, L, 3) cube of a document with `lutPath`
    (io/lut.parse_lut_file; without it the LUT is skipped, as in JAX);
    flare: a (512, 512, 3) flare map (made from the image when None);
    blur_bands: blur_band_rows(cfg, masks).
    tile_offset/full_size: when `image` is one tile of a larger image (the
    tiled develop, pipeline/tiled.py), its origin (x, y) and the image's
    (w, h): vignette, the centre mask, grain, dither, the flare sample and
    the NR jitter read absolute coordinates, the blur radii and resolution
    scale are the full image's, CA centres on the full image and no blur
    band applies.
    """
    if image.ndim != 3 or image.shape[0] != 3:
        raise ValueError(
            f"develop() expects a PLANAR (3, H, W) image, got {tuple(image.shape)}; "
            "convert interleaved (H, W, C) with np.moveaxis(img, -1, 0) (and drop alpha)"
        )
    return develop_fused(image, params, cfg, masks=masks, blur_bands=blur_bands, lut=lut,
                         flare=flare, tile_offset=tile_offset, full_size=full_size)
