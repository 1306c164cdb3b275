"""AgX tonemapper working-space matrices.

Port of the reference's inset/outset primary derivation
(src-tauri/src/image_processing.rs:1566-1661, `calculate_agx_matrices_glam`).
The AgX transform runs in a rendering space built by insetting and rotating
the Rec.2020 primaries; the shader consumes two 3x3 matrices
(pipe->rendering and rendering->pipe, shader.wgsl:1168-1174).

These are pure constants (no dependence on the image or adjustments), so we
compute them once at import time in float64 and cast to float32.
"""

from __future__ import annotations

import numpy as np

_WP_D65 = np.array([0.3127, 0.3290])
_PRIMARIES_SRGB = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06]])
_PRIMARIES_REC2020 = np.array([[0.708, 0.292], [0.170, 0.797], [0.131, 0.046]])

# Inset/rotation constants (image_processing.rs:1621-1626).
_INSET = np.array([0.2946245, 0.25861925, 0.14641371])
_ROTATION = np.array([0.03540329, -0.02108586, -0.06305724])
_OUTSET = np.array([0.2907764, 0.2631554, 0.04581072])
_UNROTATION = np.array([0.03540329, -0.02108586, -0.06305724])
_MASTER_OUTSET_RATIO = 1.0
_MASTER_UNROTATION_RATIO = 0.0


def _xy_to_xyz(xy: np.ndarray) -> np.ndarray:
    x, y = xy
    if y < 1e-6:
        return np.zeros(3)
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _primaries_to_xyz_matrix(primaries: np.ndarray, white_point: np.ndarray) -> np.ndarray:
    cols = np.stack([_xy_to_xyz(p) for p in primaries], axis=1)
    s = np.linalg.inv(cols) @ _xy_to_xyz(white_point)
    return cols * s  # scale column j by s[j]


def _rotate_and_scale_primary(
    primary: np.ndarray, white_point: np.ndarray, scale: float, rotation: float
) -> np.ndarray:
    p = (primary - white_point) * scale
    c, s = np.cos(rotation), np.sin(rotation)
    return white_point + np.array([p[0] * c - p[1] * s, p[0] * s + p[1] * c])


def compute_agx_matrices() -> tuple[np.ndarray, np.ndarray]:
    """Returns (pipe_to_rendering, rendering_to_pipe) as float32 (3,3).

    Matrices act on column vectors: rendering_rgb = M @ pipe_rgb.
    """
    pipe_to_xyz = _primaries_to_xyz_matrix(_PRIMARIES_SRGB, _WP_D65)
    base_to_xyz = _primaries_to_xyz_matrix(_PRIMARIES_REC2020, _WP_D65)
    xyz_to_base = np.linalg.inv(base_to_xyz)
    pipe_to_base = xyz_to_base @ pipe_to_xyz

    inset_primaries = np.stack(
        [
            _rotate_and_scale_primary(_PRIMARIES_REC2020[i], _WP_D65, 1.0 - _INSET[i], _ROTATION[i])
            for i in range(3)
        ]
    )
    rendering_to_xyz = _primaries_to_xyz_matrix(inset_primaries, _WP_D65)
    base_to_rendering = xyz_to_base @ rendering_to_xyz

    outset_primaries = np.stack(
        [
            _rotate_and_scale_primary(
                _PRIMARIES_REC2020[i],
                _WP_D65,
                1.0 - _MASTER_OUTSET_RATIO * _OUTSET[i],
                _MASTER_UNROTATION_RATIO * _UNROTATION[i],
            )
            for i in range(3)
        ]
    )
    outset_to_xyz = _primaries_to_xyz_matrix(outset_primaries, _WP_D65)
    rendering_to_base = np.linalg.inv(xyz_to_base @ outset_to_xyz)

    pipe_to_rendering = base_to_rendering @ pipe_to_base
    rendering_to_pipe = np.linalg.inv(pipe_to_base) @ rendering_to_base
    return (
        pipe_to_rendering.astype(np.float32),
        rendering_to_pipe.astype(np.float32),
    )


AGX_PIPE_TO_RENDERING, AGX_RENDERING_TO_PIPE = compute_agx_matrices()

# Sigmoid curve constants (shader.wgsl:1107-1123).
AGX_EPSILON = 1.0e-6
AGX_MIN_EV = -15.2
AGX_MAX_EV = 5.0
AGX_RANGE_EV = AGX_MAX_EV - AGX_MIN_EV
AGX_GAMMA = 2.4
AGX_SLOPE = 2.3843
AGX_TOE_POWER = 1.5
AGX_SHOULDER_POWER = 1.5
AGX_TOE_TRANSITION_X = 0.6060606
AGX_TOE_TRANSITION_Y = 0.43446
AGX_SHOULDER_TRANSITION_X = 0.6060606
AGX_SHOULDER_TRANSITION_Y = 0.43446
AGX_INTERCEPT = -1.0112
AGX_TOE_SCALE = -1.0359
AGX_SHOULDER_SCALE = 1.3475


# ---------------------------------------------------------------------------
# Device-side curve polynomials.
#
# The AgX toe/shoulder sigmoid (shader.wgsl:1107-1143) costs ~5 pow-class
# transcendentals per channel on the TPU VPU. Each branch is analytic on its
# domain ([m0, TX] for the toe, [TX, m1] for the shoulder, where m0/m1 are
# the points where the curve clips to 0/1), so we fit degree-10 Chebyshev
# polynomials at import time (max abs error ~1.6e-6, f32-Horner stable in
# the scaled variable u = (m - mid) / half). Outside [m0, m1] the curve is
# exactly 0/1 — the kernel clamps m per branch, so no extra selects.
#
# Known deviation: at m == TX exactly, the reference takes a linear branch
# whose value differs from both sigmoids by ~6e-4 (the reference curve is
# discontinuous there); the poly path returns the shoulder value. A single
# measure-zero input value, far below the 1e-3 fidelity budget.
# ---------------------------------------------------------------------------


def _agx_scaled_np(x, scale: float):
    t = AGX_SLOPE * (np.asarray(x, np.float64) - AGX_TOE_TRANSITION_X) / scale
    s = t / (1.0 + t**1.5) ** (1.0 / 1.5)
    return scale * s + AGX_TOE_TRANSITION_Y


def _bisect(f, lo: float, hi: float) -> float:
    flo = f(lo)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if (flo > 0) == (f(mid) > 0):
            lo, flo = mid, f(mid)
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _fit_curve_polys(deg: int = 10):
    tx = AGX_TOE_TRANSITION_X
    m0 = _bisect(lambda m: _agx_scaled_np(m, AGX_TOE_SCALE), 0.1, tx - 1e-9)
    m1 = _bisect(lambda m: _agx_scaled_np(m, AGX_SHOULDER_SCALE) - 1.0, tx + 1e-9, 1.49)

    def fit(scale, lo, hi):
        xs = np.linspace(lo, hi, 8192)
        ys = np.clip(_agx_scaled_np(xs, scale), 0.0, 1.0)
        ch = np.polynomial.chebyshev.Chebyshev.fit(xs, ys, deg)
        coef = np.polynomial.chebyshev.cheb2poly(ch.coef)
        return tuple(float(c) for c in coef), (lo + hi) / 2.0, 2.0 / (hi - lo)

    toe = fit(AGX_TOE_SCALE, m0, tx)
    shoulder = fit(AGX_SHOULDER_SCALE, tx, m1)
    return float(m0), float(m1), toe, shoulder


AGX_CURVE_M0, AGX_CURVE_M1, AGX_TOE_POLY, AGX_SHOULDER_POLY = _fit_curve_polys()
