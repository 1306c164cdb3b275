"""BM3D denoising (hard-threshold + Wiener two-step, joint luma/chroma).

A copy of `rapidraw_tpu/compositions/bm3d.py` (NumPy on the host, as in
the JAX package).

Port of denoising.rs:247-928: 8x8 blocks on a stride-6 grid, 19x19 search
window, joint 3-channel block matching with cumulative distance thresholds
(:619-702), groups truncated to the previous power of two (max 16), 2D DCT
(+orthonormal tables :750-783) with a Walsh-Hadamard transform along the
group axis (:910-928), hard thresholding that always keeps the group DC
(:576-592), empirical Wiener in step 2 (:594-610), Kaiser-window weighted
aggregation (:540-556) and a detail re-blend (:278-287).

Vectorized NumPy implementation: SSD maps are computed per search offset
with integral images (all reference patches at once), then groups are
bucketed by size so the DCT/WHT pipelines run as batched einsums.
Divergences from the bit-level reference: candidate pruning uses the
normalized SSD uniformly (the reference's early-exit compares partial
unnormalized sums, :703-725) and aggregation is float (the reference uses
1e-5 fixed-point atomics, :786-810).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BLOCK = 8
AREA = 64
MAX_GROUP = 16
STRIDE = 6
SEARCH = 19


@dataclass(frozen=True)
class Bm3dParams:
    sigma: float
    hard_th_lambda: float
    max_dist_hard: float
    chroma_sigma_scale: float = 1.8

    @classmethod
    def from_intensity(cls, i: float) -> "Bm3dParams":
        v = min(max(i, 0.001), 1.0)
        return cls(sigma=v * 80.0, hard_th_lambda=2.0 + v * 2.5, max_dist_hard=3000.0 + v * 20000.0)


def _dct_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    d = np.zeros((8, 8), np.float32)
    for k in range(8):
        for n in range(8):
            scale = 0.35355339 if k == 0 else 0.5
            d[k, n] = np.cos((n + 0.5) * k * np.pi / 8.0) * scale
    di = np.zeros((8, 8), np.float32)
    for n in range(8):
        for k in range(8):
            scale = 0.35355339 if k == 0 else 0.5
            di[n, k] = scale * np.cos(np.pi / 8.0 * (n + 0.5) * k)
    kaiser = np.outer(
        np.sin(np.pi * np.arange(8) / 7.0), np.sin(np.pi * np.arange(8) / 7.0)
    ).T.astype(np.float32)
    # reference kaiser[y*8+x] = sin(pi*x/7)*sin(pi*y/7): symmetric anyway
    return d, di, kaiser


_D, _DI, _KAISER = _dct_tables()


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(np.float32(n))


def _integral_box8(sq: np.ndarray) -> np.ndarray:
    """8x8 box sums at every top-left position via integral image."""
    ii = np.zeros((sq.shape[0] + 1, sq.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(sq, axis=0), axis=1, out=ii[1:, 1:])
    return (
        ii[BLOCK:, BLOCK:] - ii[:-BLOCK, BLOCK:] - ii[BLOCK:, :-BLOCK] + ii[:-BLOCK, :-BLOCK]
    ).astype(np.float32)


def _block_match(guide: list[np.ndarray], is_step1: bool, p: Bm3dParams):
    """Vectorized joint block matching (denoising.rs:619-702).

    Returns (ref_positions (P,2), group_locs (P, MAX_GROUP, 2), group_sizes (P,)).
    """
    h, w = guide[0].shape
    ry = np.arange(0, max(h - BLOCK, 0) + 1, STRIDE)
    rx = np.arange(0, max(w - BLOCK, 0) + 1, STRIDE)
    # reference iterates y in (0..h-8).step_by(6): excludes h-8 itself only
    # when (h-8) % 6 != 0; range over saturating_sub => 0..h-8 exclusive
    ry = ry[ry < max(h - BLOCK, 1)]
    rx = rx[rx < max(w - BLOCK, 1)]
    refs = np.stack(np.meshgrid(ry, rx, indexing="ij"), axis=-1).reshape(-1, 2)  # (P,2) [y,x]
    n_ref = refs.shape[0]

    threshold = p.max_dist_hard if is_step1 else p.max_dist_hard * 0.5
    half = SEARCH // 2
    offsets = [(dy, dx) for dy in range(-half, half + 1) for dx in range(-half, half + 1)]

    max_y = h - BLOCK
    max_x = w - BLOCK
    ssd_shape = (max_y + 1, max_x + 1)

    dists = np.full((n_ref, len(offsets)), np.inf, np.float32)
    ref_y = refs[:, 0]
    ref_x = refs[:, 1]

    for oi, (dy, dx) in enumerate(offsets):
        cy = ref_y + dy
        cx = ref_x + dx
        valid = (cy >= 0) & (cy <= max_y) & (cx >= 0) & (cx <= max_x)
        if dy == 0 and dx == 0:
            dists[:, oi] = 0.0
            continue
        total = np.zeros(ssd_shape, np.float32)
        ok = None
        for c in range(3):
            img = guide[c]
            sh = np.full_like(img, np.inf)
            ys0, ys1 = max(dy, 0), min(h + dy, h)
            xs0, xs1 = max(dx, 0), min(w + dx, w)
            sh[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx] = img[ys0:ys1, xs0:xs1]
            diff = img - sh
            diff[~np.isfinite(diff)] = 1e4
            total = total + _integral_box8(diff * diff) / AREA
            gate = total <= threshold
            ok = gate if ok is None else (ok & gate)
        # total[y, x] is the SSD between the patch AT (y, x) and the patch
        # at (y+dy, x+dx): the reference patch's distance to this candidate
        # lives at the REFERENCE position (indexing at the candidate would
        # compare the candidate against a patch one further offset away)
        d = total[ref_y, ref_x]
        okv = ok[ref_y, ref_x]
        strict = d < threshold
        dists[:, oi] = np.where(valid & okv & strict, d, np.inf)

    order = np.argsort(dists, axis=1, kind="stable")[:, :MAX_GROUP]
    sorted_d = np.take_along_axis(dists, order, axis=1)
    counts = (sorted_d < np.inf).sum(axis=1)
    sizes = np.maximum(2 ** np.floor(np.log2(np.maximum(counts, 1))).astype(np.int32), 1)
    # candidate positions are derivable from refs + the sorted offsets —
    # materializing the full (P, |offsets|, 2) table cost ~1.9 GB at 24MP
    offs = np.asarray(offsets, np.int32)[order]  # (P, MAX_GROUP, 2)
    locs = np.clip(
        refs[:, None, :].astype(np.int32) + offs,
        0, np.asarray([max_y, max_x], np.int32),
    )
    return refs, locs, sizes


def _extract_groups(img: np.ndarray, locs: np.ndarray) -> np.ndarray:
    """Gather (N, K, 8, 8) patch stacks from (H, W) at locs (N, K, 2)."""
    dy, dx = np.mgrid[0:BLOCK, 0:BLOCK]
    ys = locs[..., 0][..., None, None] + dy
    xs = locs[..., 1][..., None, None] + dx
    return img[ys, xs]


def _step(
    noisy: list[np.ndarray], guide: list[np.ndarray], p: Bm3dParams, is_step1: bool
) -> list[np.ndarray]:
    h, w = noisy[0].shape
    refs, locs, sizes = _block_match(guide, is_step1, p)
    nums = [np.zeros((h, w), np.float64) for _ in range(3)]
    dens = [np.zeros((h, w), np.float64) for _ in range(3)]

    dy, dx = np.mgrid[0:BLOCK, 0:BLOCK]
    for k in sorted(set(int(s) for s in sizes)):
        sel = np.nonzero(sizes == k)[0]
        if sel.size == 0:
            continue
        gl = locs[sel, :k]  # (N, k, 2)
        hk = _hadamard(k)
        for ch in range(3):
            ch_sigma = p.sigma if ch == 0 else p.sigma * p.chroma_sigma_scale
            gstack = _extract_groups(guide[ch], gl).astype(np.float32)  # (N,k,8,8)
            # 2D DCT per patch + WHT along group axis (transform_3d)
            gt = np.einsum("im,ngmj->ngij", _D, gstack, optimize=True)
            gt = np.einsum("ngim,jm->ngij", gt, _D, optimize=True)
            gt = np.einsum("pg,ngij->npij", hk, gt, optimize=True)

            if is_step1:
                th = p.hard_th_lambda * ch_sigma
                keep = np.abs(gt) >= th
                keep[:, 0, 0, 0] = True  # flat index 0 always kept (:582)
                nonzero = keep.reshape(keep.shape[0], -1).sum(axis=1)
                out = np.where(keep, gt, 0.0)
                weight = np.where(nonzero > 0, 1.0 / np.maximum(nonzero, 1), 1.0)
            else:
                nstack = _extract_groups(noisy[ch], gl).astype(np.float32)
                nt = np.einsum("im,ngmj->ngij", _D, nstack, optimize=True)
                nt = np.einsum("ngim,jm->ngij", nt, _D, optimize=True)
                nt = np.einsum("pg,ngij->npij", hk, nt, optimize=True)
                energy = gt * gt
                coef = energy / (energy + ch_sigma * ch_sigma + 1e-5)
                coef_flat = coef.reshape(coef.shape[0], -1).copy()
                coef_flat[:, 0] = 1.0  # element 0 passes through (:600-603)
                out = nt.reshape(nt.shape[0], -1) * coef_flat
                out[:, 0] = nt.reshape(nt.shape[0], -1)[:, 0]
                out = out.reshape(nt.shape)
                wsum = (coef_flat[:, 1:] ** 2).sum(axis=1) + 1.0
                weight = np.where(wsum > 0, 1.0 / wsum, 1.0)

            # inverse 3D transform: WHT is self-inverse (orthonormal); then
            # 2D inverse DCT = DI @ X @ DI^T (idct_2d_8x8, :861-870)
            inv = np.einsum("pg,ngij->npij", hk, out, optimize=True)
            inv = np.einsum("im,ngmj->ngij", _DI, inv, optimize=True)
            inv = np.einsum("ngim,jm->ngij", inv, _DI, optimize=True)

            kw = _KAISER * weight[:, None, None, None]
            ys = gl[..., 0][..., None, None] + dy
            xs = gl[..., 1][..., None, None] + dx
            np.add.at(nums[ch], (ys, xs), (inv * kw).astype(np.float64))
            np.add.at(dens[ch], (ys, xs), np.broadcast_to(kw, inv.shape).astype(np.float64))

    out_channels = []
    for ch in range(3):
        d = dens[ch]
        res = np.where(d > 1e-6, nums[ch] / np.where(d > 1e-6, d, 1.0), noisy[ch])
        out_channels.append(res.astype(np.float32))
    return out_channels


def _gaussian_blur_1ch(img: np.ndarray, sigma: float) -> np.ndarray:
    radius = max(int(np.ceil(sigma * 3)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    pad = np.pad(img, ((radius, radius), (radius, radius)), mode="edge")
    tmp = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, pad)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, tmp).astype(np.float32)


def run_bm3d(rgb: np.ndarray, intensity: float) -> np.ndarray:
    """Denoise planar (3, H, W) float [0,1] (denoising.rs:247-295)."""
    _, h, w = rgb.shape
    if h <= BLOCK or w <= BLOCK:
        # the reference's 0..saturating_sub(dim-8) loop yields no reference
        # blocks for tiny frames and leaves the image untouched
        return np.asarray(rgb, np.float32)
    p = Bm3dParams.from_intensity(intensity)
    r, g, b = (np.asarray(c, np.float32) * 255.0 for c in rgb)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    original_y = y.copy()
    channels = [y, cb, cr]

    basic = _step(channels, channels, p, is_step1=True)
    final = _step(channels, basic, p, is_step1=False)

    # detail re-blend (:278-287)
    blurred_y = _gaussian_blur_1ch(original_y, 3.0)
    detail_strength = min(max(intensity * 0.5, 0.0), 0.5)
    final[0] = np.clip(final[0] + detail_strength * (original_y - blurred_y), 0.0, 255.0)

    yv, cbv, crv = final[0], final[1] - 128.0, final[2] - 128.0
    ro = yv + 1.402 * crv
    go = yv - 0.344136 * cbv - 0.714136 * crv
    bo = yv + 1.772 * cbv
    return np.clip(np.stack([ro, go, bo]) / 255.0, 0.0, 1.0).astype(np.float32)
