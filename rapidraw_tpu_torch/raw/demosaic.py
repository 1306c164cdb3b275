"""Bayer demosaic as plain PyTorch on the CFA's device.

Port of `rapidraw_tpu/raw/demosaic.py`. Three algorithms, the reference's
quality tiers (raw_processing.rs:113-118, rawler DemosaicAlgorithm):
  * bilinear: 3x3 neighbour averaging;
  * malvar: Malvar-He-Cutler gradient-corrected bilinear (5x5), the
    high-quality default;
  * speed: 2x2 superpixel binning to half resolution (thumbnails).

The CFA is a (H, W) float32 mosaic, already black-subtracted, normalized
and white-balanced. The pattern is a 4-character string such as "RGGB"
giving the colour of (row, col) = (0,0), (0,1), (1,0), (1,1).

Every stencil is JAX's shift-add: one edge-padded copy of the plane, then
per tap a slice times the float32 weight added to the sum, in JAX's tap
order, so the CPU result equals the JAX package's op by op. A
convolution would sum in another order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_PATTERNS = ("RGGB", "BGGR", "GRBG", "GBRG")


def pad_edge(x: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) -> (H + 2r, W + 2r), clamped to the edge (jnp.pad mode="edge")."""
    return F.pad(x[None], (r, r, r, r), mode="replicate")[0]


def _phase_masks(h: int, w: int, pattern: str, device) -> dict[str, torch.Tensor]:
    """(H, W) 0/1 float32 masks of the R, G and B sites."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unsupported CFA pattern {pattern!r}")
    ym = (torch.arange(h, device=device) % 2).to(torch.float32)[:, None]
    xm = (torch.arange(w, device=device) % 2).to(torch.float32)[None, :]
    cell = (
        (1.0 - ym) * (1.0 - xm),  # pattern[0]: even row, even col
        (1.0 - ym) * xm,          # pattern[1]
        ym * (1.0 - xm),          # pattern[2]
        ym * xm,                  # pattern[3]
    )
    masks = {}
    for c in "RGB":
        terms = [cell[i] for i in range(4) if pattern[i] == c]
        masks[c] = sum(terms[1:], terms[0])
    return masks


def _shift_sum(x: torch.Tensor, taps: list[tuple[int, int, float]]) -> torch.Tensor:
    """sum_k w_k * x[y + dy_k, x + dx_k], edge-clamped, via pad and slice."""
    r = max(max(abs(dy), abs(dx)) for dy, dx, _ in taps)
    xp = pad_edge(x, r)
    h, w = x.shape
    out = None
    for dy, dx, wt in taps:
        sl = xp[r + dy : r + dy + h, r + dx : r + dx + w] * wt
        out = sl if out is None else out.add_(sl)
    return out


_K_RB = [(dy, dx, wt) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
         for wt in ([[1, 2, 1], [2, 4, 2], [1, 2, 1]][dy + 1][dx + 1],)]
_K_G = [(-1, 0, 1.0), (0, -1, 1.0), (0, 0, 4.0), (0, 1, 1.0), (1, 0, 1.0)]


def demosaic_bilinear(cfa: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """Bilinear demosaic: (H, W) -> planar (3, H, W)."""
    h, w = cfa.shape
    m = _phase_masks(h, w, pattern, cfa.device)
    planes = []
    for c, taps in (("R", _K_RB), ("G", _K_G), ("B", _K_RB)):
        num = _shift_sum(cfa * m[c], taps)
        den = _shift_sum(m[c], taps)
        planes.append(num / den)
    return torch.stack(planes)


# Malvar-He-Cutler 5x5 kernels (x8 scaling), MSR-TR-2004-02; float32 as in
# the JAX package, so each tap's weight is the same float32 value.
_MALVAR = {
    # G at R/B sites
    "g_at_rb": np.array(
        [
            [0, 0, -1, 0, 0],
            [0, 0, 2, 0, 0],
            [-1, 2, 4, 2, -1],
            [0, 0, 2, 0, 0],
            [0, 0, -1, 0, 0],
        ],
        np.float32,
    ) / 8.0,
    # R at green in R-row/B-col (and B equivalently)
    "rb_at_g_rrow": np.array(
        [
            [0, 0, 0.5, 0, 0],
            [0, -1, 0, -1, 0],
            [-1, 4, 5, 4, -1],
            [0, -1, 0, -1, 0],
            [0, 0, 0.5, 0, 0],
        ],
        np.float32,
    ) / 8.0,
    "rb_at_g_brow": np.array(
        [
            [0, 0, -1, 0, 0],
            [0, -1, 4, -1, 0],
            [0.5, 0, 5, 0, 0.5],
            [0, -1, 4, -1, 0],
            [0, 0, -1, 0, 0],
        ],
        np.float32,
    ) / 8.0,
    # R at B sites / B at R sites
    "rb_at_br": np.array(
        [
            [0, 0, -1.5, 0, 0],
            [0, 2, 0, 2, 0],
            [-1.5, 0, 6, 0, -1.5],
            [0, 2, 0, 2, 0],
            [0, 0, -1.5, 0, 0],
        ],
        np.float32,
    ) / 8.0,
}


def _conv5(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    taps = [
        (dy - 2, dx - 2, float(k[dy, dx]))
        for dy in range(5)
        for dx in range(5)
        if k[dy, dx] != 0.0
    ]
    return _shift_sum(x, taps)


def demosaic_malvar(cfa: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """Malvar-He-Cutler gradient-corrected demosaic: (H, W) -> (3, H, W).

    JAX computes the three R/B stencils once per channel; they do not
    depend on the channel, so here each runs once (the same values)."""
    h, w = cfa.shape
    m = _phase_masks(h, w, pattern, cfa.device)
    g_interp = _conv5(cfa, _MALVAR["g_at_rb"])
    g = cfa * m["G"] + g_interp * (m["R"] + m["B"])
    del g_interp

    # row phase masks: rows containing R sites vs rows containing B sites
    r_row = m["R"].amax(dim=1, keepdim=True) * torch.ones((1, w), device=cfa.device)
    b_row = 1.0 - r_row
    at_g = m["G"]
    at_g_rrow = _conv5(cfa, _MALVAR["rb_at_g_rrow"])
    at_g_brow = _conv5(cfa, _MALVAR["rb_at_g_brow"])
    opposite = _conv5(cfa, _MALVAR["rb_at_br"])

    def chan(c_mask, same_row, other_mask):
        # same_row: 1 where this channel's sites share the row with G here
        direct = cfa * c_mask
        at_g_same = at_g_rrow * at_g * same_row
        at_g_cross = at_g_brow * at_g * (1.0 - same_row)
        return direct + (at_g_same + at_g_cross) + opposite * other_mask

    r = chan(m["R"], r_row, m["B"])
    b = chan(m["B"], b_row, m["R"])
    return torch.stack([r, g, b])


def demosaic_speed(cfa: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """2x2 superpixel binning -> (3, H // 2, W // 2) (thumbnail path)."""
    h, w = cfa.shape
    h2, w2 = h // 2, w // 2
    cells = cfa[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).permute(0, 2, 1, 3)
    pos = {c: [] for c in "RGB"}
    grid = [pattern[0:2], pattern[2:4]]
    for dy in range(2):
        for dx in range(2):
            pos[grid[dy][dx]].append((dy, dx))
    planes = []
    for c in "RGB":
        vals = [cells[:, :, dy, dx] for dy, dx in pos[c]]
        planes.append(sum(vals) / len(vals))
    return torch.stack(planes)
