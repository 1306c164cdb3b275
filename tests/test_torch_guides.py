"""The port's straightening guides (rapidraw_tpu_torch/pipeline/guides.py,
csrc/host/guides.cc) against cv2, which the JAX package's service calls.

Bit for bit, on synthetic frames with axis-aligned and tilted edges,
stripes and noise (some blurred, one flat): cv2.cvtColor(RGB2GRAY) on every
RGB triple, cv2.Canny(gray, 50, 100), cv2.HoughLines(edges, 1, pi/180,
votes) (the same lines in the same order), cv2.line on random segments
inside, across and outside small images, and the whole overlay against
JAX's `_draw_straightening_guides`.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from rapidraw_tpu.pipeline import service as jservice
from rapidraw_tpu_torch.pipeline import guides


def scene(h: int, w: int, seed: int = 0, noise: int = 20, blur: bool = False) -> np.ndarray:
    """(h, w, 3) u8: a horizon, a vertical post, a tilted slope, a slanted
    stripe pattern and uniform noise."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 90, np.int64)
    img[h // 3:, :] = 170
    img[:, w // 2: w // 2 + 5] = 30
    yy, xx = np.mgrid[0:h, 0:w]
    img[(yy - 0.27 * xx) > h * 0.55] = 220
    img[(xx + 0.02 * yy) % 97 < 3] = 10
    img = img + rng.integers(-noise, noise + 1, img.shape)
    out = np.clip(img, 0, 255).astype(np.uint8)
    return cv2.GaussianBlur(out, (5, 5), 1.3) if blur else out


CASES = [  # (h, w, seed, noise, blur)
    (120, 160, 0, 0, False), (301, 457, 1, 5, False), (853, 1280, 2, 20, True),
    (64, 64, 3, 60, False), (200, 90, 4, 0, False), (211, 317, 5, 20, True),
    (48, 72, 6, 0, False),
]


def test_gray_is_cv2s_on_every_rgb_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    assert np.array_equal(guides.rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("case", CASES)
def test_canny_and_hough_are_cv2s(case):
    h, w, seed, noise, blur = case
    gray = cv2.cvtColor(scene(h, w, seed, noise, blur), cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, 50, 100)
    got = guides.canny(gray)
    assert np.array_equal(got, edges)
    votes = max(int(min(h, w) * 0.24), 1)
    want = cv2.HoughLines(edges, 1, np.pi / 180.0, votes)
    lines = guides.hough_lines(edges, 1, np.pi / 180.0, votes)
    assert want is not None and lines is not None
    assert lines.dtype == np.float32 and np.array_equal(lines, want)


def test_canny_and_hough_on_a_flat_frame():
    gray = np.full((40, 60), 128, np.uint8)
    assert not guides.canny(gray).any() and not cv2.Canny(gray, 50, 100).any()
    assert guides.hough_lines(guides.canny(gray), 1, np.pi / 180.0, 9) is None
    assert cv2.HoughLines(cv2.Canny(gray, 50, 100), 1, np.pi / 180.0, 9) is None


def test_lines_are_cv2s():
    rng = np.random.default_rng(1)
    for _ in range(2000):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        p1 = tuple(int(v) for v in rng.integers(-200, 200, 2))
        p2 = tuple(int(v) for v in rng.integers(-200, 200, 2))
        cv2.line(a, p1, p2, (0, 255, 0), 1)
        guides.draw_line(b, p1, p2, (0, 255, 0))
        assert np.array_equal(a, b), (h, w, p1, p2)


@pytest.mark.parametrize("case", CASES[:5])
def test_overlay_matches_jax(case):
    h, w, seed, noise, blur = case
    planar = np.ascontiguousarray(scene(h, w, seed, noise, blur).transpose(2, 0, 1))
    want = jservice._draw_straightening_guides(planar)
    got = guides.draw_straightening_guides(planar)
    assert np.array_equal(got, want)
    assert np.array_equal(planar, scene(h, w, seed, noise, blur).transpose(2, 0, 1))
