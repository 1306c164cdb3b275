"""Tiled model inference with mirror padding and seam blending.

Port of `rapidraw_tpu/ai/tiled_inference.py` (the reference's tiling
harness, ai_processing.rs:536-780): models with fixed input sizes run over
overlapping tiles cut with mirror (reflect) padding; overlapping bands are
blended so tile seams vanish. Quality presets trade tile overlap for speed
exactly like the reference (TILE_FASTER/BALANCED/HIGHER_QUALITY, :554-567).

The tiles are cut and blended on the image's device, in JAX's order of
accumulation. NumPy's reflect pad reflects again and again when the pad is
longer than the image (a 128 px image under a 504 px tile); F.pad refuses
such a pad, so the padded image is a gather of `reflect_index`, NumPy's
rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TileParams:
    cs: int  # model input (context) size
    ucs: int  # useful center size
    overlap: int  # blend band width

    @property
    def pad(self) -> int:
        return (self.cs - self.ucs) // 2


TILE_BALANCED = TileParams(504, 480, 6)
TILE_FASTER = TileParams(504, 504, 0)
TILE_HIGHER_QUALITY = TileParams(504, 448, 12)


def select_tile_params(quality_0_1: float) -> TileParams:
    q = min(max(quality_0_1, 0.0), 1.0)
    if q <= 0.25:
        return TILE_FASTER
    if q >= 0.75:
        return TILE_HIGHER_QUALITY
    return TILE_BALANCED


def reflect_index(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of each of the n + lo + hi samples of NumPy's
    `np.pad(..., (lo, hi), mode="reflect")` of an axis of n: the axis
    mirrored about its end samples, periodic with period 2(n - 1)."""
    i = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def run_tiled(
    model_fn,
    image,
    params: TileParams = TILE_BALANCED,
    batch_size: int = 8,
) -> torch.Tensor:
    """Run `model_fn` over mirror-padded tiles of planar (3, H, W) float32
    (a tensor; a NumPy array is taken to the CPU).

    model_fn: callable (B, 3, cs, cs) -> (B, 3, cs, cs) on the image's
    device. Returns the stitched (3, H, W) output on that device.
    """
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))
    dev = image.device
    _, h, w = image.shape
    cs, ucs, ol, pad = params.cs, params.ucs, params.overlap, params.pad
    step = ucs - ol if ucs > ol else ucs

    # mirror-pad once; every tile is then a plain slice. The high-side pad
    # is exactly what the furthest tile reads.
    ys = list(range(0, max(h - ol, 1), step))
    xs = list(range(0, max(w - ol, 1), step))
    pad_lo = pad
    pad_hi_y = max(0, ys[-1] + cs - pad_lo - h)
    pad_hi_x = max(0, xs[-1] + cs - pad_lo - w)
    iy = torch.from_numpy(reflect_index(h, pad_lo, pad_hi_y)).to(dev)
    ix = torch.from_numpy(reflect_index(w, pad_lo, pad_hi_x)).to(dev)
    src = image.index_select(1, iy).index_select(2, ix)
    tiles = []
    coords = []
    for y0 in ys:
        for x0 in xs:
            tiles.append(src[:, y0 : y0 + cs, x0 : x0 + cs])
            coords.append((y0, x0))

    out = torch.zeros((3, h, w), dtype=torch.float32, device=dev)
    wsum = torch.zeros((1, h, w), dtype=torch.float32, device=dev)

    # per-tile blend weight over the USEFUL region: 0.5 in the overlap
    # bands (matching apply_seamless), 1 in the interior
    tw = torch.ones((ucs, ucs), dtype=torch.float32, device=dev)
    if ol > 0:
        tw[:ol, :] *= 0.5
        tw[-ol:, :] *= 0.5
        tw[:, :ol] *= 0.5
        tw[:, -ol:] *= 0.5

    for start in range(0, len(tiles), batch_size):
        chunk = tiles[start : start + batch_size]
        n_valid = len(chunk)
        if n_valid < batch_size and len(tiles) > batch_size:
            # pad the remainder to the full batch shape, as JAX does for its
            # compiled model_fn
            chunk = chunk + [chunk[-1]] * (batch_size - n_valid)
        res = model_fn(torch.stack(chunk))
        for b, (y0, x0) in enumerate(coords[start : start + n_valid]):
            useful = res[b][:, pad : pad + ucs, pad : pad + ucs]
            y1 = min(y0 + ucs, h)
            x1 = min(x0 + ucs, w)
            if y1 <= y0 or x1 <= x0:
                continue
            wslice = tw[: y1 - y0, : x1 - x0]
            out[:, y0:y1, x0:x1] += useful[:, : y1 - y0, : x1 - x0] * wslice
            wsum[:, y0:y1, x0:x1] += wslice
    return out / torch.clamp(wsum, min=1e-8)
