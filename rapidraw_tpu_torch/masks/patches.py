"""AI patch (generative replace) compositing.

Port of the JAX package's `rapidraw_tpu/masks/patches.py`
(composite_patches_on_image, image_loader.rs:214-332): visible aiPatches
carrying base64 color + mask images (JPEG q92 in the reference,
ai_commands.rs:553-572) are alpha-blended onto the base image before the
geometry transform; patches without an explicit mask rasterize their
subMasks instead. The reference strips patch base64 on the IPC hot path
and re-hydrates from a cache (adjustment_utils.rs:47-91) — the hydration
cache here is the caller's concern.

JAX decodes the data URLs with PIL; the port decodes them with its own
dispatcher (io/image_decode.py), which gives PIL's pixels for every format
PIL opens that the port decodes; data that does not decode gives None and
skips the patch, as in JAX (a decoder that does not build raises
KernelBuildError instead). Resizes are PIL's 8-bit LANCZOS
(`geometry/resize.lanczos_resize_u8`). The blend runs on the image's
device, one operation at a time, as NumPy evaluates JAX's.
"""

from __future__ import annotations

import base64

import numpy as np
import torch

def _decode_image(b64: str, mode: str) -> np.ndarray | None:
    """(H, W) u8 for mode "L", (H, W, 3) u8 for "RGB" of any image the
    port decodes (io/image_decode.py); None where the data does not decode,
    as the JAX package's PIL fails. A decoder that does not build raises."""
    from rapidraw_tpu_torch.io.image_decode import decode_image
    from rapidraw_tpu_torch.native import KernelBuildError

    data = b64.split(",", 1)[1] if "," in b64 else b64
    try:
        return decode_image(base64.b64decode(data), mode=mode)
    except KernelBuildError:
        raise
    except Exception:  # noqa: BLE001 - an undecodable patch is skipped, as in JAX
        return None


def _resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    from rapidraw_tpu_torch.geometry.resize import lanczos_resize_u8

    if arr.shape[1] == w and arr.shape[0] == h:
        return arr
    return lanczos_resize_u8(arr, w, h)


def composite_patches_on_image(
    image: torch.Tensor, adjustments: dict, scale: float = 1.0
) -> torch.Tensor:
    """image: planar (3, H, W) float32 on any device; returns a composited
    copy on that device when any visible patch applies, else the INPUT
    tensor unchanged (don't mutate the return value in place).

    scale: image resolution relative to the full-res coordinates the
    subMask parameters are expressed in (baked base64 masks resize to the
    canvas regardless; only the subMask-rasterized fallback needs it —
    the reference always composites at full res, image_loader.rs:214-332,
    so scale=1.0 is the reference-faithful default)."""
    patches = adjustments.get("aiPatches")
    if not isinstance(patches, list) or not patches:
        return image
    visible = [
        p
        for p in patches
        if isinstance(p, dict)
        and p.get("visible", True)
        and isinstance((p.get("patchData") or {}).get("color"), str)
        and (p.get("patchData") or {}).get("color")
    ]
    if not visible:
        return image

    _, h, w = image.shape
    dev = image.device
    out = image
    for patch in visible:
        pd = patch["patchData"]
        mask_b64 = pd.get("mask")
        if isinstance(mask_b64, str) and mask_b64:
            mask = _decode_image(mask_b64, "L")
            if mask is None:
                continue
            mask = _resize(mask, w, h)
        else:
            from rapidraw_tpu_torch.masks.rasterize import generate_mask_bitmap

            mask = generate_mask_bitmap(
                {
                    "visible": True,
                    "invert": bool(patch.get("invert", False)),
                    "opacity": 100.0,
                    "subMasks": patch.get("subMasks") or [],
                },
                w, h, scale=scale,
            )
            if mask is None:
                continue
        color = _decode_image(pd["color"], "RGB")
        if color is None:
            continue
        # u8 -> [0, 1] on the host, exactly as NumPy divides (CUDA divides
        # by a scalar through its rounded reciprocal); the blend on the device
        color = torch.from_numpy(
            np.ascontiguousarray((_resize(color, w, h).astype(np.float32) / 255.0)
                                 .transpose(2, 0, 1))).to(dev)
        alpha = torch.from_numpy(mask.astype(np.float32) / 255.0).to(dev)
        # plain lerp: where alpha == 0 the blend is exactly `out`, so no
        # extra mask>0 gate is needed
        out = color * alpha + out * (1.0 - alpha)
    return out.to(torch.float32)
