"""Watermark compositing for the export (host NumPy float32).

Port of `rapidraw_tpu/pipeline/watermark.py:22-82` (export_processing.rs:
75-158: a 9-anchor alpha-composited watermark scaled to the image's short
edge). The JAX package opens the watermark with PIL's
`Image.open(p).convert("RGBA")` and resizes it with PIL's 8-bit LANCZOS;
the port decodes it with its own decoders (PNG: RGB, RGBA, grey, grey with
alpha, palette with tRNS; JPEG; TIFF) to the same RGBA samples and resizes
it with `geometry.resize.lanczos_resize_u8`, which equals PIL's.
`export_adjustments_as_lut` bakes a grade into a .cube through the port's
develop on the caller's device (the CUDA device unless asked), where JAX
pins that job to its CPU backend.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ANCHORS = (
    "topLeft", "topCenter", "topRight",
    "centerLeft", "center", "centerRight",
    "bottomLeft", "bottomCenter", "bottomRight",
)


@dataclass
class WatermarkSettings:
    path: str
    anchor: str = "bottomRight"
    scale: float = 15.0  # percent of the short edge
    spacing: float = 2.0  # percent of the short edge
    opacity: float = 100.0


def decode_rgba(data: bytes) -> np.ndarray:
    """(H, W, 4) u8 of any image the port decodes, as PIL's
    convert("RGBA") gives it (io/image_decode.py)."""
    from rapidraw_tpu_torch.io.image_decode import decode_image

    return decode_image(data, mode="RGBA")


def apply_watermark(planar: np.ndarray, settings: WatermarkSettings) -> np.ndarray:
    """Composite a watermark onto planar (3, H, W) float [0,1]."""
    from rapidraw_tpu_torch.geometry.resize import lanczos_resize_u8

    wm = decode_rgba(Path(settings.path).read_bytes())
    wm_h, wm_w = wm.shape[:2]
    _, base_h, base_w = planar.shape
    base_min = min(base_w, base_h)
    # f32 scale math + .round() (half away from zero), like the reference
    # (export_processing.rs:109-112); Python round() is half-to-even
    factor = np.float32(base_min * (settings.scale / 100.0)) / np.float32(max(wm_w, 1))
    new_w = int(np.floor(np.float32(wm_w) * factor + 0.5))
    new_h = int(np.floor(np.float32(wm_h) * factor + 0.5))
    if new_w == 0 or new_h == 0:
        return planar
    wm_u8 = lanczos_resize_u8(wm, new_w, new_h)
    # the reference scales the u8 alpha IN PLACE with a truncating cast
    # (:122-125) before compositing — quantize the same way
    opacity = min(max(settings.opacity / 100.0, 0.0), 1.0)
    alpha_u8 = (wm_u8[..., 3].astype(np.float32) * np.float32(opacity)).astype(np.uint8)
    wm_arr = wm_u8.astype(np.float32) / 255.0
    wm_arr[..., 3] = alpha_u8.astype(np.float32) / 255.0

    spacing = int(base_min * (settings.spacing / 100.0))
    # i64 division truncates toward zero (the reference's `/ 2`), which
    # differs from Python's floor `//` when an oversize watermark makes
    # the centered offset negative
    def trunc2(v):
        return int(v / 2)

    if settings.anchor in ("topLeft", "centerLeft", "bottomLeft"):
        x = spacing
    elif settings.anchor in ("topCenter", "center", "bottomCenter"):
        x = trunc2(base_w - new_w)
    else:
        x = base_w - new_w - spacing
    if settings.anchor in ("topLeft", "topCenter", "topRight"):
        y = spacing
    elif settings.anchor in ("centerLeft", "center", "centerRight"):
        y = trunc2(base_h - new_h)
    else:
        y = base_h - new_h - spacing

    out = planar.copy()
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + new_w, base_w), min(y + new_h, base_h)
    if x1 <= x0 or y1 <= y0:
        return out
    wm_crop = wm_arr[y0 - y : y1 - y, x0 - x : x1 - x]
    alpha = wm_crop[..., 3][None]
    rgb = wm_crop[..., :3].transpose(2, 0, 1)
    region = out[:, y0:y1, x0:x1]
    out[:, y0:y1, x0:x1] = region * (1.0 - alpha) + rgb * alpha
    return out


def export_adjustments_as_lut(adjustments: dict, lut_size: int = 33, device=None) -> str:
    """Bake a grade into a .cube by rendering the identity LUT, unrolled to
    a (3, L^2, L) image, through the develop chain with every spatial and
    random stage zeroed (export_processing.rs:600-617; JAX watermark.py:85).
    Runs on `device`, the CUDA device unless the caller asks for another
    (the grade kernel B4 on the card). Returns the .cube text."""
    import torch

    from rapidraw_tpu_torch.io.lut import identity_lut, lut_to_cube_text
    from rapidraw_tpu_torch.params.parse import parse_adjustments
    from rapidraw_tpu_torch.pipeline.develop import develop

    adj = dict(adjustments)
    # masks are spatial (meaningless for a LUT) and would ask for bitmaps
    adj.pop("masks", None)
    adj.pop("aiPatches", None)
    adj["showClipping"] = False
    for key in (
        "vignetteAmount", "grainAmount", "sharpness", "clarity", "dehaze",
        "structure", "centré", "glowAmount", "halationAmount", "flareAmount",
        "lumaNoiseReduction", "colorNoiseReduction",
        "chromaticAberrationRedCyan", "chromaticAberrationBlueYellow",
    ):
        adj[key] = 0
    params, cfg = parse_adjustments(adj, is_raw=False)
    cfg = dataclasses.replace(cfg, dither_active=False)

    # the identity LUT unrolled to an image: width = size, height = size^2
    # (lut_processing.rs:285-303), sRGB-encoded as a normal input
    ident = identity_lut(lut_size)  # (L, L, L, 3) [r, g, b]
    img = ident.transpose(2, 1, 0, 3).reshape(lut_size * lut_size, lut_size, 3)
    planar = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1), np.float32))
    planar = planar.to(device if device is not None else "cuda")

    lut = None
    if cfg.has_lut and isinstance(adj.get("lutPath"), str):
        from rapidraw_tpu_torch.io.lut import parse_lut_file
        from rapidraw_tpu_torch.native import KernelBuildError

        try:
            lut = parse_lut_file(adj["lutPath"])
        except KernelBuildError:  # a HALD image's decoder that does not build
            raise
        except Exception:
            cfg = dataclasses.replace(cfg, has_lut=False)
    out = develop(planar, params, cfg, lut=lut).cpu().numpy()
    baked = out.transpose(1, 2, 0).reshape(lut_size, lut_size, lut_size, 3).transpose(2, 1, 0, 3)
    return lut_to_cube_text(baked)
