"""Tone-curve baking: point lists -> per-segment monotone-Hermite coefficients.

The reference evaluates curves per pixel with a 16-point monotone cubic
Hermite search loop (shader.wgsl:340-378 `apply_curve`). The tangents (and
the Fritsch-Carlson style monotonicity clamp) depend only on the control
points, so we hoist them to the host: each curve becomes a fixed-size
(MAX_SEGMENTS, 6) array of [x0, y0, x1, y1, m1, m2] rows that the device
evaluates with branch-free masked Hermite blends — identical math, no
per-pixel segment search.

Curve domain is 0..255 on both axes (UI pixel values); the shader maps the
0..1 channel value via x = val*255 and divides the result by 255.
"""

from __future__ import annotations

import numpy as np

MAX_POINTS = 16  # shader.wgsl:100-104 (array<Point, 16>)
MAX_SEGMENTS = MAX_POINTS - 1

# Sentinel X for unused segment slots: masks (x > x0) & (x <= x1) never hit.
_PAD_X = 1.0e9


def bake_curve(points: np.ndarray | list) -> tuple[np.ndarray, np.ndarray, float]:
    """Bake one curve's control points.

    Args:
      points: (n, 2) float array of (x, y) control points in 0..255, sorted
        by x (the UI guarantees ordering). n may be 0.

    Returns:
      (segments, ends, enabled):
        segments: (MAX_SEGMENTS, 7) float32 [x0, x1, inv_dx, a, b, c, d] —
          the Hermite basis folded into power-form cubic coefficients
          (already /255-normalized): y(t) = a + b t + c t^2 + d t^3 with
          t = (x - x0) * inv_dx. Baking in f64 on host both removes the
          per-pixel division/tangent math and is more accurate than the
          shader's f32 basis evaluation. A degenerate segment (dx <= 0,
          shader.wgsl:373 returns y0) bakes to inv_dx = 0, a = y0/255.
        ends: (4,) float32 [x_first, y_first, x_last, y_last]
        enabled: 1.0 if n >= 2 else 0.0 (count < 2 is identity,
                 shader.wgsl:341)
    """
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    n = pts.shape[0]
    seg = np.zeros((MAX_SEGMENTS, 7), dtype=np.float32)
    seg[:, 0] = _PAD_X
    seg[:, 1] = _PAD_X
    if n < 2:
        return seg, np.array([0.0, 0.0, 255.0, 255.0], np.float32), 0.0

    n = min(n, MAX_POINTS)
    for i in range(n - 1):
        p0 = pts[max(0, i - 1)]
        p1 = pts[i]
        p2 = pts[i + 1]
        p3 = pts[min(n - 1, i + 2)]
        delta_before = (p1[1] - p0[1]) / max(0.001, p1[0] - p0[0])
        delta_current = (p2[1] - p1[1]) / max(0.001, p2[0] - p1[0])
        delta_after = (p3[1] - p2[1]) / max(0.001, p3[0] - p2[0])

        if i == 0:
            m1 = delta_current
        elif delta_before * delta_current <= 0.0:
            m1 = 0.0
        else:
            m1 = (delta_before + delta_current) / 2.0

        if i + 1 == n - 1:
            m2 = delta_current
        elif delta_current * delta_after <= 0.0:
            m2 = 0.0
        else:
            m2 = (delta_current + delta_after) / 2.0

        # Monotonicity clamp, applied per segment (shader.wgsl:364-371).
        if delta_current != 0.0:
            alpha = m1 / delta_current
            beta = m2 / delta_current
            if alpha * alpha + beta * beta > 9.0:
                tau = 3.0 / np.sqrt(alpha * alpha + beta * beta)
                m1 *= tau
                m2 *= tau

        dx = float(p2[0]) - float(p1[0])
        if dx <= 0.0:
            seg[i] = [p1[0], p2[0], 0.0, p1[1] / 255.0, 0.0, 0.0, 0.0]
            continue
        dy = float(p2[1]) - float(p1[1])
        b1 = m1 * dx
        b2 = m2 * dx
        seg[i] = [
            p1[0], p2[0], 1.0 / dx,
            p1[1] / 255.0,                       # a = y0
            b1 / 255.0,                          # b = m1 dx
            (3.0 * dy - 2.0 * b1 - b2) / 255.0,  # c
            (-2.0 * dy + b1 + b2) / 255.0,       # d
        ]

    ends = np.array([pts[0, 0], pts[0, 1], pts[n - 1, 0], pts[n - 1, 1]], np.float32)
    return seg, ends, 1.0


def is_default_curve(points: np.ndarray | list) -> bool:
    """Identity-curve detection (shader.wgsl:1197-1216).

    Curves where every point lies on y=x (within 0.5) with endpoints pinned
    to (0,0) and (255,255) are 'default'; if all three RGB curves are
    default, only the luma curve runs (applied to each channel).
    NOTE: count < 2 returns False, matching the shader.
    """
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    n = pts.shape[0]
    if n < 2:
        return False
    if np.any(np.abs(pts[:n, 0] - pts[:n, 1]) > 0.5):
        return False
    p0_origin = abs(pts[0, 0]) < 0.1 and abs(pts[0, 1]) < 0.1
    p_last_end = abs(pts[n - 1, 0] - 255.0) < 0.1 and abs(pts[n - 1, 1] - 255.0) < 0.1
    return bool(p0_origin and p_last_end)


def bake_curve_set(curves_json: dict | None) -> dict[str, np.ndarray]:
    """Bake the luma/red/green/blue curve family of one adjustment set.

    Args:
      curves_json: the "curves" JSON object ({"luma": [{"x":..,"y":..}], ...})
        or None. A missing channel defaults to the identity 2-point curve
        (image_processing.rs:1897); pass an empty-list channel to express
        "section hidden" (count 0 -> identity at eval, rgb_active semantics
        preserved).

    Returns dict with:
      seg: (4, MAX_SEGMENTS, 6)   channel order: luma, red, green, blue
      ends: (4, 4)
      enabled: (4,)
      rgb_active: ()  1.0 if any of red/green/blue is non-default
                      (shader.wgsl:1219-1222)
    """
    default = [{"x": 0.0, "y": 0.0}, {"x": 255.0, "y": 255.0}]
    curves_json = curves_json or {}
    channels = []
    for name in ("luma", "red", "green", "blue"):
        raw = curves_json.get(name, default)
        pts = np.array([[p["x"], p["y"]] for p in raw], np.float32).reshape(-1, 2)
        channels.append(pts)

    segs, ends, enabled = [], [], []
    for pts in channels:
        s, e, en = bake_curve(pts)
        segs.append(s)
        ends.append(e)
        enabled.append(en)

    rgb_active = not all(is_default_curve(pts) for pts in channels[1:])
    return {
        "seg": np.stack(segs),
        "ends": np.stack(ends),
        "enabled": np.array(enabled, np.float32),
        "rgb_active": np.float32(1.0 if rgb_active else 0.0),
    }


def used_segments(baked: dict[str, np.ndarray]) -> int:
    """Number of populated segment rows (for static trimming at eval time)."""
    seg = np.asarray(baked["seg"])
    used = seg[..., 0] < _PAD_X / 2  # (..., S)
    if not used.any():
        return 0
    return int(np.max(np.where(used)[-1])) + 1


def curve_set_is_identity(baked: dict[str, np.ndarray]) -> bool:
    """True when evaluating this curve set is a guaranteed no-op.

    Used for static jit specialization: the whole curve stage can be skipped
    when the luma curve is identity/disabled and no RGB curve is active
    (then the rgb path's normalization is also a no-op for inputs in [0,1]).
    """
    if not baked["enabled"].any():
        # All counts < 2: every apply_curve call returns its input and the
        # rgb-path luma renormalization cancels (shader.wgsl:1224-1236).
        return True
    if float(baked["rgb_active"]) != 0.0:
        return False
    # luma curve applied per channel: identity if disabled (count<2) or
    # an identity-shaped curve.
    if float(baked["enabled"][0]) == 0.0:
        return True
    seg = baked["seg"][0]
    used = seg[:, 0] < _PAD_X / 2
    if not used.any():
        return True
    # identity check: segment endpoint values on y=x (y0 = a*255 at t=0,
    # y1 = (a+b+c+d)*255 at t=1).
    s = seg[used]
    y0 = s[:, 3] * 255.0
    y1 = (s[:, 3] + s[:, 4] + s[:, 5] + s[:, 6]) * 255.0
    pts_on_diag = np.all(np.abs(s[:, 0] - y0) <= 0.5) and np.all(
        np.abs(s[:, 1] - y1) <= 0.5
    )
    ends = baked["ends"][0]
    pinned = abs(ends[0]) < 0.1 and abs(ends[1]) < 0.1 and abs(ends[2] - 255.0) < 0.1 and abs(
        ends[3] - 255.0
    ) < 0.1
    return bool(pts_on_diag and pinned)
