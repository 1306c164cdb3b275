"""Batch develop: per-image params stacked along a leading batch axis.

Port of `rapidraw_tpu/pipeline/batch.py`. Every B goes through one launch
of each kernel its document needs — NR, the blur pyramid (one more per
band group of mask-only levels), the flare maps, the grade with the batch
on the grid; on a CPU batch the wrappers run their plain versions instead.
No switch sends a CUDA batch down a plain path. Mask stacks are padded to the batch's
mask count with zero adjustments.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidraw_tpu_torch.params.parse import (
    DevelopConfig,
    DevelopParams,
    _shared_set,
    merge_configs,
)
from rapidraw_tpu_torch.pipeline.fused import develop_fused_batch


def _pad_mask_sets(params: DevelopParams, target_n: int) -> DevelopParams:
    """Pad a document's mask stack to `target_n` entries (zero adjustments).

    Padded masks get zero influence bitmaps, so they are exact no-ops
    (JAX batch.py:22-60).
    """
    mask = params["mask"]
    if target_n == 0:
        return {"glob": params["glob"], "mask": None}

    def pad(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n >= target_n:
            return x[:target_n]
        pad_width = [(0, target_n - n)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad_width)

    if mask is None:
        # an all-zero mask set with the right shapes, from a template
        tmpl = _shared_set({})
        mask = {}
        for k, v in tmpl.items():
            if k == "curves":
                mask["curves"] = {
                    ck: np.zeros((0,) + np.asarray(cv).shape, np.float32)
                    for ck, cv in v.items()
                }
            else:
                mask[k] = np.zeros((0,) + np.asarray(v).shape, np.float32)

    out = {}
    for k, v in mask.items():
        if k == "curves":
            out["curves"] = {ck: pad(cv) for ck, cv in v.items()}
        else:
            out[k] = pad(v)
    return {"glob": params["glob"], "mask": out}


def _stack(trees: list, device):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], device) for k in trees[0]}
    arr = np.stack([np.asarray(t, dtype=np.float32) for t in trees])
    return torch.from_numpy(arr).to(device)


def stack_params(
    params_list: list[DevelopParams],
    configs: list[DevelopConfig],
    cfg: DevelopConfig | None = None,
    device=None,
) -> tuple[DevelopParams, DevelopConfig]:
    """Stack per-image params into batched tensors + the merged config.

    `cfg` overrides the merge (an export bucket merges once). `device`
    places the stacked leaves: the CUDA device unless the caller asks for
    another (the CPU for a CPU batch). A batch that is developed many times
    keeps its params resident there and packs them without a host copy per
    call.
    """
    if cfg is None:
        cfg = merge_configs(configs)
    padded = [_pad_mask_sets(p, cfg.mask_count) for p in params_list]
    device = device or "cuda"
    stacked = {"glob": _stack([p["glob"] for p in padded], device),
               "mask": _stack([p["mask"] for p in padded], device) if cfg.mask_count else None}
    return stacked, cfg


def develop_batch(images: torch.Tensor, params: DevelopParams, cfg: DevelopConfig,
                  masks=None, lut=None, flare=None,
                  blur_bands: tuple | None = None) -> torch.Tensor:
    """Develop planar (B, 3, H, W) images with per-image stacked params.

    masks: (B, N, H, W) influences in [0, 1] (N = cfg.mask_count), e.g.
    rasterize_masks per image, stacked; an image with fewer masks than N
    takes zero influence in the rest. lut: the (L, L, L, 3) cube of the
    batch (io/lut.parse_lut_file), shared as in JAX; a document with
    `lutPath` and no cube skips the LUT. flare: a (512, 512, 3) flare map
    for the batch, or None to make each image's own. blur_bands:
    ((level, y0, y1), ...) row bands of the mask-only blur levels
    (blur_band_rows over THIS batch's masks): exact, and the blur skips the
    rows outside.
    """
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"develop_batch expects (B, 3, H, W), got {tuple(images.shape)}")
    return develop_fused_batch(images, params, cfg, masks=masks, blur_bands=blur_bands,
                               lut=lut, flare=flare)
