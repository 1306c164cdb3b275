"""Batch develop: per-image params stacked along a leading batch axis.

Port of `rapidraw_tpu/pipeline/batch.py`. Every B goes through one launch
of each kernel its document needs — NR, the blur pyramid, the grade with
the batch on the grid; on a CPU batch the wrappers run their plain
versions instead. No switch sends a CUDA batch down a plain path.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidraw_tpu_torch.params.parse import DevelopConfig, DevelopParams, merge_configs
from rapidraw_tpu_torch.pipeline.fused import check_supported, develop_fused_batch


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
    check_supported(cfg)
    stacked = {"glob": _stack([p["glob"] for p in params_list], device or "cuda"), "mask": None}
    return stacked, cfg


def develop_batch(images: torch.Tensor, params: DevelopParams, cfg: DevelopConfig) -> torch.Tensor:
    """Develop planar (B, 3, H, W) images with per-image stacked params."""
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"develop_batch expects (B, 3, H, W), got {tuple(images.shape)}")
    return develop_fused_batch(images, params, cfg)
