"""Host-side row bands for band-restricted blur-pyramid levels.

A copy of `rapidraw_tpu/pipeline/bands.py` (NumPy only).

When a blur level's consumers (sharpen/clarity/structure/shadow-blacks/
dehaze/glow/halation) are driven ONLY by masks (DevelopConfig.
blur_band_masks, parsed statically), the effective amount is exactly zero
outside the masks' support and every consumer is exactly identity there
(each op ends in a per-pixel `where(amount == 0, rgb, out)` — ops/local.py,
ops/tone.py). The level therefore only needs to be *computed* over the
union row band of its contributing masks; the rest of the buffer is zeros
the grade chain never observes.

This mirrors the economics of the reference: its per-pixel consumers are
amount-gated in the shader (shader.wgsl:1578-1612), but it still pays the
full blur dispatches per tile (gpu_processing.rs:1326-1405); here a level
is blurred over its mask band only.

Bands are computed on the HOST from the rasterized mask bitmaps (numpy,
before device upload), quantized to `QUANTUM` rows, and passed to
develop / develop_batch as `blur_bands=((level_key, y0, y1), ...)`.
"""

from __future__ import annotations

import numpy as np

from rapidraw_tpu_torch.params.parse import DevelopConfig

# row quantum for band endpoints (the JAX package bounds its compile
# variants with it; kept so both packages cut the same bands)
QUANTUM = 128
# skip the restriction when it saves less than this fraction of rows
MIN_SAVE_FRACTION = 0.125
# the same support threshold the grade kernel gates influences with
_SUPPORT_THRESHOLD = 0.001


def blur_band_rows(cfg: DevelopConfig, masks) -> tuple | None:
    """Static ((level, y0, y1), ...) bands for cfg.blur_band_masks.

    masks: (N, H, W) or batched (B, N, H, W) numpy-convertible bitmaps —
    the SAME array develop receives (support threshold 0.001 matches
    prepare_inputs' gated_infl). Returns None when nothing is restrictable.
    """
    if not getattr(cfg, "blur_band_masks", ()) or masks is None:
        return None
    m = np.asarray(masks)
    if m.ndim == 4:
        rows = (m > _SUPPORT_THRESHOLD).any(axis=(0, 3))  # (N, H)
    else:
        rows = (m > _SUPPORT_THRESHOLD).any(axis=-1)  # (N, H)
    h = rows.shape[-1]
    out = []
    for key, idxs in cfg.blur_band_masks:
        union = np.zeros(h, bool)
        for n in idxs:
            if n < rows.shape[0]:
                union |= rows[n]
        nz = np.flatnonzero(union)
        if nz.size == 0:
            # no support at all: one quantum keeps shapes valid; every
            # consumer is identity everywhere anyway
            y0, y1 = 0, min(h, QUANTUM)
        else:
            y0 = int(nz[0]) // QUANTUM * QUANTUM
            y1 = min(h, -(-(int(nz[-1]) + 1) // QUANTUM) * QUANTUM)
        if (h - (y1 - y0)) < h * MIN_SAVE_FRACTION:
            continue
        out.append((key, int(y0), int(y1)))
    return tuple(out) or None
