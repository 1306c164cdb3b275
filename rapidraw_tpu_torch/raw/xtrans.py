"""X-Trans (Fujifilm 6x6 CFA) demosaic: directional green, then R and B as
colour differences. Port of `rapidraw_tpu/raw/xtrans.py` as plain
PyTorch on the CFA's device, op for op.

Green is rebuilt by blending horizontal, vertical and isotropic neighbour
means with local inverse-gradient weights; R and B interpolate (R - G) and
(B - G) from their sites with a distance-weighted 5x5 kernel and add G
back. Every stencil is an edge-clamped shifted add. The 6x6 pattern is
tiled to the frame on the host once per (pattern, shape, device) and kept
on the device (`xtrans_site_masks`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rapidraw_tpu_torch.raw.demosaic import pad_edge

# canonical X-Trans layout (Fujifilm X-T/X-Pro series), 0=R 1=G 2=B, used
# when the RAF CFA header lacks tag 0x0131
DEFAULT_XTRANS = np.array(
    [
        [1, 2, 1, 1, 0, 1],
        [0, 1, 0, 2, 1, 2],
        [1, 2, 1, 1, 0, 1],
        [1, 0, 1, 1, 2, 1],
        [2, 1, 2, 0, 1, 0],
        [1, 0, 1, 1, 2, 1],
    ],
    np.int32,
)

# distance-weighted kernels: green sites are dense (orthogonal neighbours
# suffice); red and blue need a 5x5 reach (the largest distance to a
# same-colour site in X-Trans is 2)
_K_G = {(0, 0): 1.0, (0, 1): 1.0, (0, -1): 1.0, (1, 0): 1.0, (-1, 0): 1.0,
        (1, 1): 0.5, (1, -1): 0.5, (-1, 1): 0.5, (-1, -1): 0.5}
_K_RB = {}
for _dy in range(-2, 3):
    for _dx in range(-2, 3):
        _d = (_dy * _dy + _dx * _dx) ** 0.5
        _K_RB[(_dy, _dx)] = 1.0 / (1.0 + _d * _d)

_PAD = 2


def _shift(padded: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    return padded[_PAD + dy : _PAD + dy + h, _PAD + dx : _PAD + dx + w]


@functools.lru_cache(maxsize=8)
def _plan(xtrans_key: tuple):
    """Per colour, its sorted kernel; refuses a pattern that leaves a
    channel without samples."""
    xt = np.asarray(xtrans_key, np.int32).reshape(6, 6)
    plans = []
    for c, kern in ((0, _K_RB), (1, _K_G), (2, _K_RB)):
        mask = (xt == c).astype(np.float32)
        # interior weight sum per phase must be positive everywhere
        wsum = np.zeros((6, 6), np.float64)
        for (dy, dx), kw in kern.items():
            wsum += kw * np.roll(np.roll(mask, -dy, 0), -dx, 1)
        if not (wsum > 1e-6).all():
            raise ValueError(f"X-Trans pattern leaves channel {c} uncovered")
        plans.append(tuple(sorted(kern.items())))
    return plans


@functools.lru_cache(maxsize=2)
def _site_masks(xtrans_key: tuple, h: int, w: int, device: torch.device) -> torch.Tensor:
    xt = np.asarray(xtrans_key, np.int32).reshape(6, 6)
    reps = (h + 5) // 6 + 1, (w + 5) // 6 + 1
    site = np.tile(xt, reps)[:h, :w]
    masks = np.stack([(site == c).astype(np.float32) for c in range(3)])
    return torch.from_numpy(masks).to(device)


def xtrans_site_masks(xtrans: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """(3, H, W) 0/1 float32 masks of the R, G and B sites of an X-Trans
    frame, built on the host and uploaded once per (pattern, shape,
    device); the two most recent stay resident (at 24 MP, 302 MB each)."""
    key = tuple(np.asarray(xtrans, np.int32).reshape(-1).tolist())
    return _site_masks(key, h, w, torch.device(device))


def _masked_interp(x, mask, kern, h, w):
    """Distance-weighted interpolation of `x * mask`, with the kernel's
    mask coverage as its normalizer (shared edge-clamped shifts)."""
    num_src = pad_edge(x * mask, _PAD)
    den_src = pad_edge(mask, _PAD)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for (dy, dx), kw in kern:
        num = num + kw * _shift(num_src, dy, dx, h, w)
        den = den + kw * _shift(den_src, dy, dx, h, w)
    return num, den


def demosaic_xtrans(x: torch.Tensor, xtrans: np.ndarray) -> torch.Tensor:
    """(H, W) white-balanced CFA -> planar (3, H, W), X-Trans pattern.

    xtrans: (6, 6) int array of 0/1/2, the sensor layout at pixel (0, 0).
    """
    h, w = x.shape
    xt = np.asarray(xtrans, np.int32)
    plans = _plan(tuple(xt.reshape(-1).tolist()))
    masks = xtrans_site_masks(xt, h, w, x.device)

    # ---- stage 1: green, directionally weighted -------------------------
    g_mask = masks[1]
    kern_g = dict(plans[1])
    kern_h = tuple((o, kw) for o, kw in kern_g.items() if o[0] == 0)
    kern_v = tuple((o, kw) for o, kw in kern_g.items() if o[1] == 0)
    kern_a = tuple(kern_g.items())

    xp = pad_edge(x, _PAD)
    grad_h = torch.abs(
        _shift(xp, 0, 1, h, w) - _shift(xp, 0, -1, h, w)
    ) + torch.abs(
        2.0 * x - _shift(xp, 0, 2, h, w) - _shift(xp, 0, -2, h, w)
    )
    grad_v = torch.abs(
        _shift(xp, 1, 0, h, w) - _shift(xp, -1, 0, h, w)
    ) + torch.abs(
        2.0 * x - _shift(xp, 2, 0, h, w) - _shift(xp, -2, 0, h, w)
    )
    del xp

    num_h, den_h = _masked_interp(x, g_mask, kern_h, h, w)
    num_v, den_v = _masked_interp(x, g_mask, kern_v, h, w)
    num_a, den_a = _masked_interp(x, g_mask, kern_a, h, w)
    eps = 1e-4
    # direction weight: inverse gradient, zero where the phase has no
    # samples in that direction (den == 0)
    w_h = torch.where(den_h > 1e-6, 1.0 / (eps + grad_h), 0.0)
    w_v = torch.where(den_v > 1e-6, 1.0 / (eps + grad_v), 0.0)
    # isotropic stabilizer relative to the winning direction; phases with
    # no directional samples fall back to the isotropic estimate entirely
    w_dir = torch.maximum(w_h, w_v)
    w_a = torch.where(w_dir > 0.0, 0.1 * w_dir, 1.0)
    est_h = num_h / torch.clamp_min(den_h, 1e-6)
    est_v = num_v / torch.clamp_min(den_v, 1e-6)
    est_a = num_a / torch.clamp_min(den_a, 1e-6)
    g_interp = (w_h * est_h + w_v * est_v + w_a * est_a) / torch.clamp_min(
        w_h + w_v + w_a, 1e-9
    )
    green = torch.where(g_mask > 0, x, g_interp)

    # ---- stage 2: R/B via colour differences ----------------------------
    out = [None, green, None]
    diff = x - green  # valid at each channel's own sites
    for c in (0, 2):
        mask = masks[c]
        num, den = _masked_interp(diff, mask, plans[c], h, w)
        interp = green + num / torch.clamp_min(den, 1e-6)
        out[c] = torch.where(mask > 0, x, interp)
    return torch.stack(out)


def shift_xtrans(xt: np.ndarray, top: int, left: int) -> np.ndarray:
    """Pattern after cropping `top` rows / `left` cols."""
    return np.roll(np.roll(np.asarray(xt, np.int32), -top % 6, 0), -left % 6, 1)
