"""Panorama stitching.

Port of `rapidraw_tpu/compositions/panorama.py` (panorama_stitching.rs +
panorama_utils): detect features per frame, match pairs, estimate pairwise
homographies with RANSAC, connect the strongest-inlier pairs first (the
reference's DSU ordering, :415-443), then warp everything into the root
frame's plane and feather-blend.

The JAX package takes its primitives from cv2; the port has its own, as the
Rust reference hand-rolls them:
  * features: FAST-9 corners (threshold 20) ranked by the Harris response
    after 3x3 non-maximum suppression, the best `N_FEATURES`, each with an
    intensity-centroid orientation and a 256-bit oriented BRIEF descriptor
    over a Gaussian-smoothed image (a fixed pattern drawn from a seeded
    generator). Frames past `DETECT_MAX_SIDE` are detected on an integer
    area reduction and their keypoints scaled back. NumPy on the host.
  * matching: Hamming 2-NN (one matrix product of the +-1 descriptors) with
    the 0.75 ratio test.
  * homography: RANSAC over 4-point solves from a seeded generator
    (reprojection threshold 4 px), then a normalized DLT and Gauss-Newton
    refit on the inliers.
  * warp and blend: cv2's warpPerspective (bilinear, constant-0 border, as
    OpenCV 5 computes it) of the frame and of its feather weight, and the
    float64 accumulation, as torch on the frames' device: the output
    canvas (tens of MP) is the big array of the composition.
"""

from __future__ import annotations

import numpy as np
import torch

N_FEATURES = 4000  # cv2.ORB_create(nfeatures=4000)
FAST_THRESHOLD = 20
BORDER = 16  # keypoints keep the 31-px patch inside the frame
DETECT_MAX_SIDE = 2048
RATIO = 0.75
RANSAC_THRESHOLD = 4.0
RANSAC_ITERS = 2000
RANSAC_SEED = 20240607
PATTERN_SEED = 0x0B1EF
MIN_INLIERS = 12
WARP_ROWS = 512  # destination rows warped at a time: bounds the warp's temporaries

# FAST's Bresenham circle of radius 3, as (dx, dy), in circle order
_CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
           (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))


class PanoramaError(ValueError):
    pass


def _to_u8(img: torch.Tensor) -> np.ndarray:
    """Planar float -> (H, W, 3) u8, truncating as the JAX package does."""
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()


def _pattern() -> np.ndarray:
    """(256, 4) BRIEF point pairs (x1, y1, x2, y2): Gaussian with sigma
    31 / 5 around the keypoint, each point held within radius 13 so every
    rotation stays inside the 31-px patch."""
    pts = np.random.default_rng(PATTERN_SEED).normal(0.0, 31.0 / 5.0, (512, 2))
    r = np.hypot(pts[:, 0], pts[:, 1])
    pts *= np.minimum(1.0, 13.0 / np.maximum(r, 1e-9))[:, None]
    return pts.reshape(256, 4)


_PATTERN = _pattern()


def _box_sum(a: np.ndarray, r: int) -> np.ndarray:
    """Sum over the (2r + 1)^2 box around each pixel (zero outside)."""
    p = np.pad(a, r + 1)
    c = p.cumsum(0).cumsum(1)
    n = 2 * r + 1
    return c[n:, n:] - c[:-n, n:] - c[n:, :-n] + c[:-n, :-n]


def _gaussian(gray: np.ndarray, sigma: float = 2.0, r: int = 3) -> np.ndarray:
    """Separable Gaussian (7 taps, sigma 2, reflected border), float32."""
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    out = gray.astype(np.float32)
    for axis in (0, 1):
        p = np.pad(out, [(r, r) if a == axis else (0, 0) for a in (0, 1)], mode="reflect")
        n = out.shape[axis]
        out = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis) for i in range(2 * r + 1))
    return out


def _fast_corners(g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """FAST-9 corners of (H, W) u8 inside BORDER: (ys, xs)."""
    h, w = g.shape
    b = BORDER
    if h <= 2 * b or w <= 2 * b:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gi = g.astype(np.int16)
    c = gi[b:h - b, b:w - b]
    bright = np.zeros(c.shape, np.uint32)
    dark = np.zeros(c.shape, np.uint32)
    for k, (dx, dy) in enumerate(_CIRCLE):
        s = gi[b + dy:h - b + dy, b + dx:w - b + dx]
        bright |= (s > c + FAST_THRESHOLD).astype(np.uint32) << k
        dark |= (s < c - FAST_THRESHOLD).astype(np.uint32) << k

    def arc9(bits):
        doubled = bits | (bits << 16)
        m = doubled.copy()
        for i in range(1, 9):
            m &= doubled >> i
        return (m & 0xFFFF) != 0

    ys, xs = np.nonzero(arc9(bright) | arc9(dark))
    return ys + b, xs + b


def detect_and_describe(gray: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Keypoints (N, 2) float64 (x, y) in `gray`'s pixels and descriptors
    (N, 256) bool of an (H, W) u8 image."""
    from rapidraw_tpu_torch.geometry.resize import reduce_u8

    f = -(-max(gray.shape) // DETECT_MAX_SIDE)
    g = reduce_u8(gray, f, f) if f > 1 else gray
    ys, xs = _fast_corners(g)
    if ys.size == 0:
        return np.zeros((0, 2)), np.zeros((0, 256), bool)
    # Harris response on 3x3 Sobel gradients summed over a 7x7 block
    gf = g.astype(np.float32)
    p = np.pad(gf, 1, mode="edge")
    ix = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]))
    iy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]))
    sxx, syy, sxy = (_box_sum(a.astype(np.float64), 3)[ys, xs] for a in (ix * ix, iy * iy, ix * iy))
    score = sxx * syy - sxy * sxy - 0.04 * (sxx + syy) ** 2
    # 3x3 non-maximum suppression among the corners
    smap = np.full((g.shape[0] + 2, g.shape[1] + 2), -np.inf)
    smap[ys + 1, xs + 1] = score
    keep = np.ones(ys.size, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score >= smap[ys + 1 + dy, xs + 1 + dx]
    ys, xs, score = ys[keep], xs[keep], score[keep]
    best = np.argsort(-score, kind="stable")[:N_FEATURES]
    ys, xs = ys[best], xs[best]
    # orientation: the intensity centroid over the radius-15 disc
    r = np.arange(-15, 16)
    disc = (r[:, None] ** 2 + r[None, :] ** 2) <= 225
    patch = g[ys[:, None, None] + r[None, :, None], xs[:, None, None] + r[None, None, :]]
    patch = patch.astype(np.float64) * disc
    m10 = (patch * r[None, None, :]).sum(axis=(1, 2))
    m01 = (patch * r[None, :, None]).sum(axis=(1, 2))
    ang = np.arctan2(m01, m10)
    # oriented BRIEF on the smoothed image
    sm = _gaussian(g)
    cs, sn = np.cos(ang)[:, None], np.sin(ang)[:, None]

    def sample(px, py):
        rx = np.rint(cs * px[None, :] - sn * py[None, :]).astype(np.int64)
        ry = np.rint(sn * px[None, :] + cs * py[None, :]).astype(np.int64)
        return sm[ys[:, None] + ry, xs[:, None] + rx]

    pat = _PATTERN
    des = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    kp = np.stack([xs, ys], axis=1).astype(np.float64)
    if f > 1:
        kp = (kp + 0.5) * f - 0.5
    return kp, des


def match_ratio(des_q: np.ndarray, des_t: np.ndarray) -> list[tuple[int, int]]:
    """Hamming 2-NN of each query descriptor among the train descriptors
    with the ratio test: [(query index, train index)]."""
    if len(des_t) < 2 or len(des_q) == 0:
        return []
    q = torch.from_numpy(1.0 - 2.0 * des_q.astype(np.float32))
    t = torch.from_numpy(1.0 - 2.0 * des_t.astype(np.float32))
    dist = (des_q.shape[1] - q @ t.T) * 0.5  # exact small integers
    d2, i2 = torch.topk(dist, 2, dim=1, largest=False, sorted=True)
    ok = (d2[:, 0] < RATIO * d2[:, 1]).numpy()
    qi = np.nonzero(ok)[0]
    return [(int(i), int(i2[i, 0])) for i in qi]


def _normalizer(pts: np.ndarray) -> np.ndarray:
    """Hartley's isotropic normalization: centroid to 0, mean distance
    sqrt(2)."""
    c = pts.mean(axis=0)
    d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2.0) / d if d > 0 else 1.0
    return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])


def _apply(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Project (P, 2) points by (..., 3, 3) homographies -> (..., P, 2)."""
    x = pts[:, 0]
    y = pts[:, 1]
    hx = h[..., 0, 0, None] * x + h[..., 0, 1, None] * y + h[..., 0, 2, None]
    hy = h[..., 1, 0, None] * x + h[..., 1, 1, None] * y + h[..., 1, 2, None]
    hz = h[..., 2, 0, None] * x + h[..., 2, 1, None] * y + h[..., 2, 2, None]
    hz = np.where(np.abs(hz) > 1e-12, hz, 1e-12)
    return np.stack([hx / hz, hy / hz], axis=-1)


def _dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray | None:
    """Normalized DLT least squares over >= 4 correspondences."""
    ts, td = _normalizer(src), _normalizer(dst)
    s = src @ ts[:2, :2].T + ts[:2, 2]
    d = dst @ td[:2, :2].T + td[:2, 2]
    n = len(s)
    a = np.zeros((2 * n, 9))
    a[0::2, 0:2] = s
    a[0::2, 2] = 1
    a[0::2, 6:8] = -d[:, :1] * s
    a[0::2, 8] = -d[:, 0]
    a[1::2, 3:5] = s
    a[1::2, 5] = 1
    a[1::2, 6:8] = -d[:, 1:] * s
    a[1::2, 8] = -d[:, 1]
    hn = np.linalg.svd(a, full_matrices=False)[2][-1].reshape(3, 3)
    h = np.linalg.inv(td) @ hn @ ts
    if abs(h[2, 2]) < 1e-12:
        return None
    return h / h[2, 2]


def _refine(h: np.ndarray, src: np.ndarray, dst: np.ndarray, iters: int = 10) -> np.ndarray:
    """Gauss-Newton on the reprojection error in the destination (h33 = 1)."""
    p = h.reshape(-1)[:8].copy()
    x, y = src[:, 0], src[:, 1]
    for _ in range(iters):
        hx = p[0] * x + p[1] * y + p[2]
        hy = p[3] * x + p[4] * y + p[5]
        hz = p[6] * x + p[7] * y + 1.0
        u, v = hx / hz, hy / hz
        r = np.concatenate([u - dst[:, 0], v - dst[:, 1]])
        z = np.zeros_like(x)
        ju = np.stack([x / hz, y / hz, 1 / hz, z, z, z, -u * x / hz, -u * y / hz], axis=1)
        jv = np.stack([z, z, z, x / hz, y / hz, 1 / hz, -v * x / hz, -v * y / hz], axis=1)
        j = np.concatenate([ju, jv])
        step, *_ = np.linalg.lstsq(j, -r, rcond=None)
        p = p + step
        if np.abs(step).max() < 1e-12:
            break
    return np.append(p, 1.0).reshape(3, 3)


def find_homography_ransac(src: np.ndarray, dst: np.ndarray,
                           threshold: float = RANSAC_THRESHOLD) -> tuple[np.ndarray | None, int]:
    """(H mapping src to dst, inlier count) by RANSAC over 4-point solves
    (a seeded generator: the same matches give the same answer), then a
    normalized DLT and Gauss-Newton refit on the inliers, twice."""
    n = len(src)
    if n < 4:
        return None, 0
    rng = np.random.default_rng(RANSAC_SEED)
    ts, td = _normalizer(src), _normalizer(dst)
    s = src @ ts[:2, :2].T + ts[:2, 2]
    d = dst @ td[:2, :2].T + td[:2, 2]
    idx = np.stack([rng.choice(n, 4, replace=False) for _ in range(RANSAC_ITERS)])
    s4, d4 = s[idx], d[idx]  # (M, 4, 2)
    a = np.zeros((RANSAC_ITERS, 8, 8))
    b = np.zeros((RANSAC_ITERS, 8))
    a[:, 0::2, 0:2] = s4
    a[:, 0::2, 2] = 1
    a[:, 0::2, 6:8] = -d4[..., :1] * s4
    a[:, 1::2, 3:5] = s4
    a[:, 1::2, 5] = 1
    a[:, 1::2, 6:8] = -d4[..., 1:] * s4
    b[:, 0::2] = d4[..., 0]
    b[:, 1::2] = d4[..., 1]
    ok = np.abs(np.linalg.det(a)) > 1e-10
    if not ok.any():
        return None, 0
    sol = np.linalg.solve(a[ok], b[ok][..., None])[..., 0]
    hn = np.concatenate([sol, np.ones((len(sol), 1))], axis=1).reshape(-1, 3, 3)
    hs = np.linalg.inv(td) @ hn @ ts
    best, best_count = None, -1
    thr2 = threshold * threshold
    for c0 in range(0, len(hs), 256):
        err = ((_apply(hs[c0:c0 + 256], src) - dst) ** 2).sum(axis=-1)
        counts = (err < thr2).sum(axis=1)
        i = int(np.argmax(counts))
        if counts[i] > best_count:
            best, best_count = hs[c0 + i], int(counts[i])
    h = best / best[2, 2]
    for _ in range(2):
        inl = ((_apply(h, src) - dst) ** 2).sum(axis=-1) < thr2
        if inl.sum() < 4:
            break
        fit = _dlt(src[inl], dst[inl])
        if fit is None:
            break
        h = _refine(fit, src[inl], dst[inl])
    count = int((((_apply(h, src) - dst) ** 2).sum(axis=-1) < thr2).sum())
    return h, count


def _pair_homography(f1, f2):
    """H mapping frame 2 onto frame 1 and its inliers, or (None, 0)."""
    kp1, des1 = f1
    kp2, des2 = f2
    if len(kp1) < 8 or len(kp2) < 8:
        return None, 0
    good = match_ratio(des2, des1)
    if len(good) < 8:
        return None, 0
    src = np.array([kp2[q] for q, _ in good], np.float64)
    dst = np.array([kp1[t] for _, t in good], np.float64)
    return find_homography_ransac(src, dst)


class _Dsu:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.p[rb] = ra
        return True


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv2.invert of a 3x3 float64 matrix (DECOMP_LU: Cramer's rule)."""
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
         - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
         + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if d == 0.0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
         (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
         (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
         (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d],
    ])


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (the product is exact in float64)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def warp_perspective(src: torch.Tensor, h: np.ndarray, out_w: int, out_h: int) -> torch.Tensor:
    """cv2.warpPerspective(src, h, (out_w, out_h)) of planar (C, H, W)
    float32 on its device: bilinear, constant-0 border, as OpenCV 5's
    warp kernels compute it. h is inverted in float64 (cv2.invert's 3x3
    rule) and rounded to float32; each destination pixel's source position
    is fma(x, m0, y * m1 + m2) / fma(x, m6, y * m7 + m8) in float32 (not
    rounded to 1/32 px: OpenCV 5 takes the float position), and the taps
    are blended by three fused lerps, across then down."""
    c, hs, ws = src.shape
    dev = src.device
    m = [float(np.float32(v)) for v in _invert3(np.asarray(h, np.float64)).reshape(-1)]
    pad = torch.zeros((c, hs + 2, ws + 2), dtype=torch.float32, device=dev)
    pad[:, 1:-1, 1:-1] = src
    flat = pad.reshape(c, -1)
    step = ws + 2
    out = torch.empty((c, out_h, out_w), dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    for y0 in range(0, out_h, WARP_ROWS):
        ys = torch.arange(y0, min(y0 + WARP_ROWS, out_h), dtype=torch.float32, device=dev)[:, None]
        w = _fma(xs, m[6], ys * f32(m[7]) + f32(m[8]))
        sx = _fma(xs, m[0], ys * f32(m[1]) + f32(m[2])) / w
        sy = _fma(xs, m[3], ys * f32(m[4]) + f32(m[5])) / w
        inside = (sx > -1) & (sx < ws) & (sy > -1) & (sy < hs)  # False for NaN
        sx = torch.where(inside, sx, 0.0)
        sy = torch.where(inside, sy, 0.0)
        x0 = torch.floor(sx)
        y0f = torch.floor(sy)
        a = sx - x0
        b = sy - y0f
        px = x0.to(torch.int64) + 1  # into the zero-padded source
        py = y0f.to(torch.int64) + 1
        i00 = py * step + px
        shape = (c,) + tuple(sx.shape)

        def tap(i):
            return flat[:, i.reshape(-1)].reshape(shape)

        f00, f01, f10, f11 = tap(i00), tap(i00 + 1), tap(i00 + step), tap(i00 + step + 1)
        top = _fma(a, f01 - f00, f00)
        bot = _fma(a, f11 - f10, f10)
        v = _fma(b, bot - top, top)
        out[:, y0:y0 + ys.shape[0]] = torch.where(inside, v, 0.0)
    return out


def stitch_panorama(images: list[torch.Tensor]) -> torch.Tensor:
    """Stitch planar (3, H, W) float frames (on one device) into one
    panorama (3, H', W') on that device.

    Raises PanoramaError when fewer than two frames are given or no
    connected set of matches exists (panorama_stitching.rs:61-63, 444+).
    """
    from rapidraw_tpu_torch.pipeline.guides import rgb_to_gray

    if len(images) < 2:
        raise PanoramaError("Please select at least two images to stitch.")

    u8s = [_to_u8(im) for im in images]
    feats = [detect_and_describe(rgb_to_gray(u)) for u in u8s]

    n = len(images)
    pair_h: dict[tuple[int, int], np.ndarray] = {}
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            h, inliers = _pair_homography(feats[i], feats[j])
            if h is not None and inliers >= MIN_INLIERS:
                pair_h[(i, j)] = h
                edges.append((inliers, i, j))
    if not edges:
        raise PanoramaError("Could not find enough matching features between images.")

    # strongest-inlier spanning set (DSU ordering, :415-443)
    edges.sort(reverse=True)
    dsu = _Dsu(n)
    tree: dict[int, list[tuple[int, np.ndarray]]] = {i: [] for i in range(n)}
    for inliers, i, j in edges:
        if dsu.union(i, j):
            tree[i].append((j, pair_h[(i, j)]))
            tree[j].append((i, np.linalg.inv(pair_h[(i, j)])))

    # root = a member of the LARGEST connected component, not frame 0
    comp_sizes: dict[int, int] = {}
    for i in range(n):
        comp_sizes[dsu.find(i)] = comp_sizes.get(dsu.find(i), 0) + 1
    best_comp = max(comp_sizes, key=comp_sizes.get)
    root = min(i for i in range(n) if dsu.find(i) == best_comp)
    H = {root: np.eye(3)}
    queue = [root]
    while queue:
        cur = queue.pop(0)
        for nxt, h in tree[cur]:
            if nxt not in H:
                H[nxt] = H[cur] @ h
                queue.append(nxt)
    connected = sorted(H)
    if len(connected) < 2:
        raise PanoramaError("Images do not form a connected panorama.")

    return composite(images, H)


def composite(images: list[torch.Tensor], H: dict[int, np.ndarray]) -> torch.Tensor:
    """Warp each frame i of `H` (frame i's homography into the root's
    plane) onto the canvas that holds them all and feather-blend them in
    float64."""
    connected = sorted(H)
    corners = []
    for i in connected:
        hgt, wdt = images[i].shape[1:]
        c = np.array([[0, 0, 1], [wdt, 0, 1], [0, hgt, 1], [wdt, hgt, 1]], np.float64).T
        pc = H[i] @ c
        corners.append(pc[:2] / pc[2])
    allc = np.concatenate(corners, axis=1)
    min_x, min_y = np.floor(allc.min(axis=1)).astype(int)
    max_x, max_y = np.ceil(allc.max(axis=1)).astype(int)
    out_w, out_h = int(max_x - min_x), int(max_y - min_y)
    if out_w * out_h > 120_000_000:
        raise PanoramaError("Panorama output too large — are the images related?")
    shift = np.array([[1, 0, -min_x], [0, 1, -min_y], [0, 0, 1]], np.float64)

    dev = images[0].device
    acc = torch.zeros((3, out_h, out_w), dtype=torch.float64, device=dev)
    wacc = torch.zeros((out_h, out_w), dtype=torch.float64, device=dev)
    for i in connected:
        src = torch.clamp(images[i].to(torch.float32), 0, 1)
        hgt, wdt = src.shape[1:]
        # feather weight: distance to the frame's edge
        ar_y = torch.arange(hgt, device=dev)
        ar_x = torch.arange(wdt, device=dev)
        yy = torch.minimum(ar_y + 1, hgt - ar_y)
        xx = torch.minimum(ar_x + 1, wdt - ar_x)
        weight = torch.minimum(yy[:, None], xx[None, :]).to(torch.float32)
        weight = weight / weight.max()
        hw = shift @ H[i]
        warped = warp_perspective(src, hw, out_w, out_h)
        wweight = warp_perspective(weight[None], hw, out_w, out_h)[0]
        acc += warped.to(torch.float64) * wweight.to(torch.float64)
        wacc += wweight.to(torch.float64)
    out = acc / torch.clamp_min(wacc, 1e-6)
    return torch.clamp(out, 0, 1).to(torch.float32)
