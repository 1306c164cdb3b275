"""Tiled develop for images too large for one develop pass.

Port of `rapidraw_tpu/pipeline/tiled.py`. The reference renders through
2048-pixel tiles with a 128-pixel halo (gpu_processing.rs:1279-1280
TILE_SIZE / TILE_OVERLAP) because wgpu textures cap at 8192 px; the CLI
develops an image whose long edge passes 8192 (stitched panoramas, scan
masters) tile by tile. The halo feeds the spatial stages (blur pyramid,
NR, CA), so seams appear only where a blur radius passes the overlap, as
in the reference.

The per-pixel stages that read coordinates (vignette, centre mask, grain,
dither, flare sample, the per-pixel NR jitter) stay exact: each tile
carries its absolute origin and the full image's size into the develop
(`develop(..., tile_offset=, full_size=)`), and the grade and per-pixel NR
kernels add the origin to their coordinates. The flare map is built once
from a 1024 px proxy of the whole image, as in JAX; CA re-centres each
tile's sample indices on the full image.

JAX keeps the whole image on the host, because a TPU's memory is small,
and uploads one tile at a time. Here the (3, H, W) image stays on its own
device (a 96 MP float32 image is 1.15 GB of an H100's 80 GB) and the tiles
are cut there, so an image the CLI loaded onto the card never crosses PCIe
tile by tile; only one tile's intermediates live at a time. The params,
mask influences and LUT go to the device once.

Why tile on an 80 GB card at all: the CLI's output of an image past 8192 px
is defined as the tiled one, in JAX as in the reference, and differs from a
whole-image develop wherever a blur radius passes the overlap. Tiling keeps
the port's `develop` of such an image equal to JAX's.
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.params.parse import DevelopConfig

TILE_SIZE = 2048  # gpu_processing.rs:1279
TILE_OVERLAP = 128  # gpu_processing.rs:1280


def tile_windows(h: int, w: int, tile_size: int = TILE_SIZE,
                 overlap: int = TILE_OVERLAP) -> list[tuple]:
    """Each tile of an (h, w) image as ((y0, y1, x0, x1), (ys0, ys1, xs0,
    xs1)): the rows and columns it writes, and its source window, the
    tile grown by `overlap` on each side and clamped to the image."""
    out = []
    for y0 in range(0, h, tile_size):
        for x0 in range(0, w, tile_size):
            y1, x1 = min(y0 + tile_size, h), min(x0 + tile_size, w)
            out.append(((y0, y1, x0, x1),
                        (max(0, y0 - overlap), min(h, y1 + overlap),
                         max(0, x0 - overlap), min(w, x1 + overlap))))
    return out


def _on_device(tree, dev):
    """Every array of a nest of dicts and tuples as a tensor on `dev`."""
    if isinstance(tree, dict):
        return {k: _on_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_on_device(v, dev) for v in tree)
    return None if tree is None else torch.as_tensor(tree, device=dev)


def _flare_map(image: torch.Tensor, params: dict, cfg: DevelopConfig) -> torch.Tensor:
    """The image's (512, 512, 3) flare map from a 1024 px proxy (the map is
    512^2 whatever the input; JAX tiled.py:92-101), through the flare
    kernel on the image's device."""
    from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
    from rapidraw_tpu_torch.pipeline.fused import _add_batch_axis, flare_inputs, pack_rows

    proxy = downscale_to_long_edge(image, 1024).contiguous()
    pmat = pack_rows(_add_batch_axis(params["glob"])).to(image.device)
    return flare_inputs(proxy[None], pmat, cfg)[0]


def develop_tiled(image: torch.Tensor, params: dict, cfg: DevelopConfig, masks=None,
                  lut=None, tile_size: int = TILE_SIZE,
                  overlap: int = TILE_OVERLAP) -> torch.Tensor:
    """Develop a planar (3, H, W) image tile by tile on its device; returns
    the (3, H, W) sRGB result there.

    masks: the (N, H, W) influences (host or device); lut: the document's
    (L, L, L, 3) cube. An image that fits one tile develops whole.
    """
    from rapidraw_tpu_torch.pipeline.develop import develop

    if image.ndim != 3 or image.shape[0] != 3:
        raise ValueError(f"develop_tiled expects a PLANAR (3, H, W) image, "
                         f"got {tuple(image.shape)}")
    _, h, w = image.shape
    dev = image.device
    # the params, masks and cube go to the device once, not once per tile
    params, masks, lut = _on_device((params, masks, lut), dev)
    if h <= tile_size and w <= tile_size:
        return develop(image, params, cfg, masks=masks, lut=lut)

    flare = _flare_map(image, params, cfg) if cfg.flare_active else None
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    for (y0, y1, x0, x1), (ys0, ys1, xs0, xs1) in tile_windows(h, w, tile_size, overlap):
        tile = image[:, ys0:ys1, xs0:xs1].contiguous()
        mk = masks[:, ys0:ys1, xs0:xs1].contiguous() if masks is not None else None
        res = develop(tile, params, cfg, masks=mk, lut=lut, flare=flare,
                      tile_offset=(xs0, ys0), full_size=(w, h))
        out[:, y0:y1, x0:x1] = res[:, y0 - ys0:y1 - ys0, x0 - xs0:x1 - xs0]
        del tile, mk, res
    return out
