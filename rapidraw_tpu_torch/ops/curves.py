"""Tone-curve evaluation (PyTorch).

Port of `rapidraw_tpu/ops/curves.py`: the host bakes each curve into
per-segment power-form cubics (params/curves.py); here every pixel
evaluates the first `n_seg` slots and keeps the last one whose interval
holds it — the shader's segment search (shader.wgsl:340-378).
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops.common import luma


def eval_curve(val: torch.Tensor, seg, ends, enabled, n_seg: int) -> torch.Tensor:
    """Evaluate one curve over its first `n_seg` segment slots.

    seg: (MAX_SEGMENTS, 7) [x0, x1, inv_dx, a, b, c, d]; ends: (4,)
    [x_first, y_first, x_last, y_last]; enabled: 0 -> identity.
    """
    x = val * 255.0
    seg_val = torch.zeros_like(x)
    any_seg = torch.zeros_like(x, dtype=torch.bool)
    for i in range(n_seg):
        x0, x1, inv_dx, a, b, c, d = (seg[i][j] for j in range(7))
        t = (x - x0) * inv_dx
        result_y = torch.clamp(((d * t + c) * t + b) * t + a, 0.0, 1.0)
        in_seg = (x > x0) & (x <= x1)
        seg_val = torch.where(in_seg, result_y, seg_val)
        any_seg = any_seg | in_seg

    out = torch.where(any_seg, seg_val, ends[3] / 255.0)
    out = torch.where(x >= ends[2], ends[3] / 255.0, out)
    out = torch.where(x <= ends[0], ends[1] / 255.0, out)
    return torch.where(enabled > 0.0, out, val)


def apply_all_curves(
    rgb: torch.Tensor, curve_set: dict, n_seg: int, rgb_maybe_active: bool = True
) -> torch.Tensor:
    """Luma + RGB point curves with luma preservation (shader.wgsl:1218-1237).

    curve_set: {'seg': (4,S,7), 'ends': (4,4), 'enabled': (4,),
    'rgb_active': ()}, channel order luma, red, green, blue. `n_seg` is
    DevelopConfig.curve_segments (at least 1 slot is evaluated).
    `rgb_maybe_active` is the batch-wide flag: when False the rgb path is
    skipped; when True the per-document `rgb_active` selects it.
    """
    seg, ends, en = curve_set["seg"], curve_set["ends"], curve_set["enabled"]
    n_seg = max(n_seg, 1)

    def cv(v, i):
        return eval_curve(v, seg[i], ends[i], en[i], n_seg)

    luma_path = torch.stack([cv(rgb[0], 0), cv(rgb[1], 0), cv(rgb[2], 0)])
    if not rgb_maybe_active:
        return luma_path

    graded = torch.stack([cv(rgb[0], 1), cv(rgb[1], 2), cv(rgb[2], 3)])
    luma_initial = luma(rgb)
    luma_target = cv(luma_initial, 0)
    luma_graded = luma(graded)
    scale = luma_target / torch.where(luma_graded > 0.001, luma_graded, 1.0)
    rgb_path = torch.where(luma_graded > 0.001, graded * scale, luma_target)
    max_comp = torch.amax(rgb_path, dim=0)
    rgb_path = torch.where(max_comp > 1.0, rgb_path / max_comp, rgb_path)

    return torch.where(curve_set["rgb_active"] > 0.0, rgb_path, luma_path)
