"""Image culling: similarity grouping + quality scoring.

Port of `rapidraw_tpu/compositions/culling.py` (culling.rs): Laplacian-variance sharpness (:65-97), histogram
clipping exposure metric (:99-122), center-focus crop, weighted quality
score (:153-160), perceptual-hash similarity groups via BFS over hash
distance (:241-...). The reference hashes with image_hasher's
DoubleGradient 16x16; this is the same family (gradient sign hash in
both directions on a downscaled luma). The JAX package's PIL resizes and
grey conversion are the port's own (geometry/resize.py, io/encode.rgb_to_l),
byte for byte; the metrics are NumPy on the host, the loads on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WEIGHT_SHARPNESS = 0.40
WEIGHT_CENTER_FOCUS = 0.35
WEIGHT_EXPOSURE = 0.25
ANALYSIS_DIM = 720


@dataclass
class ImageAnalysis:
    path: str
    quality_score: float
    sharpness_metric: float
    center_focus_metric: float
    exposure_metric: float
    width: int
    height: int
    hash_bits: np.ndarray = field(repr=False, default=None)


def laplacian_variance(gray: np.ndarray) -> float:
    """4-neighbor Laplacian variance (culling.rs:65-97). gray: (H, W) u8."""
    h, w = gray.shape
    if h < 3 or w < 3:
        return 0.0
    g = gray.astype(np.int32)
    conv = (
        g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:] - 4 * g[1:-1, 1:-1]
    ).astype(np.float64)
    return float(conv.var())


def exposure_metric(gray: np.ndarray) -> float:
    """Clipping penalty metric (culling.rs:99-122)."""
    total = gray.size
    if total == 0:
        return 0.0
    hist = np.bincount(gray.reshape(-1), minlength=256)
    dark = hist[:5].sum() / total
    bright = hist[250:].sum() / total
    return max(1.0 - (dark * 5.0 + bright * 5.0), 0.0)


def double_gradient_hash(gray: np.ndarray, size: int = 16) -> np.ndarray:
    """DoubleGradient-family perceptual hash: horizontal gradient signs on a
    (size+1, size/2) resample + vertical gradient signs on the transpose
    (PIL's BILINEAR resizes)."""
    from rapidraw_tpu_torch.geometry.resize import resize_u8

    half = size // 2
    a = resize_u8(gray, size + 1, half, "bilinear").astype(np.int16)
    b = resize_u8(gray, half, size + 1, "bilinear").astype(np.int16)
    bits_h = (a[:, 1:] > a[:, :-1]).reshape(-1)
    bits_v = (b[1:, :] > b[:-1, :]).reshape(-1)
    return np.concatenate([bits_h, bits_v])


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a != b))


def analyze_image_array(path: str, planar) -> ImageAnalysis:
    """Analyze a planar (3, H, W) float image (culling.rs:125-175), a
    tensor on its device (quantized there) or a host array: PIL's
    thumbnail (BICUBIC, reducing gap 2) to ANALYSIS_DIM, then its
    convert("L")."""
    import torch

    from rapidraw_tpu_torch.geometry.resize import thumbnail_u8
    from rapidraw_tpu_torch.io.encode import rgb_to_l

    _, h, w = planar.shape
    if isinstance(planar, torch.Tensor):
        arr = (torch.clamp(planar, 0, 1) * 255.0 + 0.5).to(torch.uint8)
        arr = arr.permute(1, 2, 0).contiguous().cpu().numpy()
    else:
        arr = (np.clip(planar, 0, 1) * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    gray = rgb_to_l(thumbnail_u8(arr, (ANALYSIS_DIM, ANALYSIS_DIM)))

    sharp = laplacian_variance(gray)
    expo = exposure_metric(gray)
    th, tw = gray.shape
    center = gray[th // 4 : th // 4 + th // 2, tw // 4 : tw // 4 + tw // 2]
    center_focus = laplacian_variance(center)

    ns = min(np.log10(sharp + 1.0) / 3.5, 1.0)
    nc = min(np.log10(center_focus + 1.0) / 3.5, 1.0)
    score = ns * WEIGHT_SHARPNESS + nc * WEIGHT_CENTER_FOCUS + expo * WEIGHT_EXPOSURE
    return ImageAnalysis(
        path=path,
        quality_score=float(score),
        sharpness_metric=sharp,
        center_focus_metric=center_focus,
        exposure_metric=expo,
        width=w,
        height=h,
        hash_bits=double_gradient_hash(gray),
    )


def group_similar(
    analyses: list[ImageAnalysis], similarity_threshold: int = 24
) -> list[list[int]]:
    """BFS transitive grouping by hash distance (culling.rs:241+)."""
    n = len(analyses)
    processed = [False] * n
    groups = []
    for i in range(n):
        if processed[i]:
            continue
        processed[i] = True
        group = [i]
        queue = [i]
        while queue:
            cur = queue.pop(0)
            # scan ALL unprocessed nodes: limiting to j > cur made the
            # transitive closure order-dependent (A-C-B chains split when
            # the bridge node had a higher index than a member)
            for j in range(n):
                if processed[j]:
                    continue
                if hamming(analyses[cur].hash_bits, analyses[j].hash_bits) <= similarity_threshold:
                    processed[j] = True
                    group.append(j)
                    queue.append(j)
        groups.append(group)
    return groups


def cull_images(
    paths: list[str], group_similar_images: bool = True, similarity_threshold: int = 24,
    device=None,
) -> dict:
    """Full culling pass over files (culling.rs:176-312), each file loaded
    on `device` (the CUDA device unless the caller asks for another).

    Returns {'groups': [[analysis,...]], 'best': [path,...], 'failed': [...]}
    where each group is sorted best-first by quality score.
    """
    from rapidraw_tpu_torch.io.loader import load_image

    analyses: list[ImageAnalysis] = []
    failed: list[str] = []
    for p in paths:
        try:
            # fast load: every metric is computed on an ANALYSIS_DIM
            # thumbnail anyway (culling.rs:136-160)
            img, _ = load_image(p, fast=True, device=device)
            analyses.append(analyze_image_array(p, img))
        except Exception as e:  # noqa: BLE001 — per-image isolation
            del e
            failed.append(p)

    if group_similar_images:
        idx_groups = group_similar(analyses, similarity_threshold)
    else:
        idx_groups = [[i] for i in range(len(analyses))]

    groups = []
    best = []
    for g in idx_groups:
        members = sorted((analyses[i] for i in g), key=lambda a: -a.quality_score)
        groups.append(members)
        if members:
            best.append(members[0].path)
    return {"groups": groups, "best": best, "failed": failed}
