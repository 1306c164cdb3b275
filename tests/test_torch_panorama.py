"""The port's panorama stitcher (rapidraw_tpu_torch/compositions/panorama.py)
against the JAX package's, which takes ORB, the brute-force matcher,
findHomography and warpPerspective from cv2.

Keypoints equal to ORB's are not a goal: the port has its own FAST +
oriented BRIEF. Held here: tests/test_panorama.py's three cases on the
port; each frame's corners under the port's homography within 1.5 px of
their place under JAX's, on the same scenes; and, with the same
homographies, the port's warp equal to `cv2.warpPerspective` (measured max
|d| 0: OpenCV 5's float positions and fused lerps, mirrored) and its
composite within 1e-6 of a cv2 + NumPy composite written as the JAX
package writes it. The port runs on the CPU.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from rapidraw_tpu.compositions import panorama as jpano
from rapidraw_tpu_torch.compositions import panorama as pano
from rapidraw_tpu_torch.pipeline.guides import rgb_to_gray
from tests.test_panorama import _scene

torch.set_num_threads(2)

CORNER_TOL = 1.5  # px
WARP_TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_stitch_two_overlapping_crops():
    scene = _scene()
    out = pano.stitch_panorama([_t(scene[:, :, :400]), _t(scene[:, :, 240:])])
    assert out.shape[0] == 3
    assert out.shape[2] > 560
    assert abs(out.shape[1] - scene.shape[1]) < 40
    assert torch.isfinite(out).all()


def test_stitch_rejects_single_and_unrelated():
    scene = _scene()
    with pytest.raises(pano.PanoramaError):
        pano.stitch_panorama([_t(scene)])
    unrelated = np.random.default_rng(9).random((3, 200, 200), dtype=np.float32)
    with pytest.raises(pano.PanoramaError):
        pano.stitch_panorama([_t(unrelated), torch.zeros((3, 200, 200))])


def test_panorama_root_not_frame_zero():
    rng = np.random.default_rng(11)
    base = (rng.random((240, 520, 3)) * 255).astype(np.uint8)
    left = base[:, :320].astype(np.float32).transpose(2, 0, 1) / 255.0
    right = base[:, 200:].astype(np.float32).transpose(2, 0, 1) / 255.0
    noise = rng.random((3, 240, 320)).astype(np.float32)
    out = pano.stitch_panorama([_t(noise), _t(left), _t(right)])
    assert out.shape[2] > 480  # left + right joined, noise dropped


def _pairs():
    """(frame 1, frame 2) pairs of one scene: a shift, a shift with a
    vertical offset, and a perspective view of the second crop."""
    scene = _scene(360, 700, seed=2)
    a = scene[:, :, :420]
    yield "shift", a, scene[:, :, 260:]
    yield "offset", scene[:, 20:, :400], scene[:, :330, 230:]
    hom = np.array([[1.0, 0.02, 0.0], [-0.015, 1.0, 0.0], [4e-5, 2e-5, 1.0]])
    b = cv2.warpPerspective(np.ascontiguousarray(scene[:, :, 250:].transpose(1, 2, 0)), hom,
                            (450, 360)).transpose(2, 0, 1)
    yield "perspective", a, b


@pytest.mark.parametrize("case", ["shift", "offset", "perspective"])
def test_homography_corners_match_jax(case):
    f1, f2 = next((a, b) for name, a, b in _pairs() if name == case)
    u1, u2 = jpano._to_u8(f1), jpano._to_u8(f2)
    orb = cv2.ORB_create(nfeatures=4000)
    jf = [jpano._features(cv2.cvtColor(u, cv2.COLOR_RGB2GRAY), orb) for u in (u1, u2)]
    hj, nj = jpano._pair_homography(jf[0], jf[1], cv2.BFMatcher(cv2.NORM_HAMMING))
    pf = [pano.detect_and_describe(rgb_to_gray(pano._to_u8(_t(f)))) for f in (f1, f2)]
    hp, np_ = pano._pair_homography(pf[0], pf[1])
    assert hj is not None and hp is not None and nj >= 12 and np_ >= 12
    h, w = f2.shape[1:]
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T
    pj, pp = hj @ c, hp @ c
    d = np.abs(pp[:2] / pp[2] - pj[:2] / pj[2]).max()
    assert d <= CORNER_TOL, d
    # the seeded RANSAC gives the same answer every run
    hp2, np2 = pano._pair_homography(pf[0], pf[1])
    assert np2 == np_ and np.array_equal(hp2, hp)


@pytest.mark.parametrize("seed", range(4))
def test_warp_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    c, h, w = (3, 1)[seed % 2], 50 + seed * 17, 70 + seed * 9
    src = rng.random((c, h, w), dtype=np.float32)
    hom = np.array([[1 + rng.normal(0, 0.05), rng.normal(0, 0.05), rng.normal(0, 8)],
                    [rng.normal(0, 0.05), 1 + rng.normal(0, 0.05), rng.normal(0, 8)],
                    [rng.normal(0, 3e-4), rng.normal(0, 3e-4), 1.0]])
    ow, oh = w + 23, h + 11
    want = cv2.warpPerspective(np.ascontiguousarray(src.transpose(1, 2, 0)), hom, (ow, oh))
    want = want.reshape(oh, ow, c).transpose(2, 0, 1)
    got = pano.warp_perspective(_t(src), hom, ow, oh).numpy()
    assert np.abs(got - want).max() <= WARP_TOL


def _composite_cv2(images, H):
    """tests' oracle: the JAX package's bounds, warps and float64 feather
    blend (rapidraw_tpu/compositions/panorama.py:121-160) with cv2."""
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
    shift = np.array([[1, 0, -min_x], [0, 1, -min_y], [0, 0, 1]], np.float64)
    acc = np.zeros((out_h, out_w, 3), np.float64)
    wacc = np.zeros((out_h, out_w), np.float64)
    for i in connected:
        src = np.clip(np.asarray(images[i], np.float32), 0, 1).transpose(1, 2, 0)
        hgt, wdt = src.shape[:2]
        yy = np.minimum(np.arange(hgt) + 1, np.arange(hgt)[::-1] + 1)
        xx = np.minimum(np.arange(wdt) + 1, np.arange(wdt)[::-1] + 1)
        weight = np.minimum(yy[:, None], xx[None, :]).astype(np.float32)
        weight /= weight.max()
        hw = (shift @ H[i]).astype(np.float64)
        acc += cv2.warpPerspective(src, hw, (out_w, out_h)).astype(np.float64) * \
            cv2.warpPerspective(weight, hw, (out_w, out_h))[..., None]
        wacc += cv2.warpPerspective(weight, hw, (out_w, out_h))
    out = acc / np.maximum(wacc, 1e-6)[..., None]
    return np.clip(out, 0, 1).astype(np.float32).transpose(2, 0, 1)


def test_composite_matches_cv2_oracle():
    scene = _scene()
    frames = [scene[:, :, :400], scene[:, 10:, 200:], scene[:, :300, 330:]]
    feats = [pano.detect_and_describe(rgb_to_gray(pano._to_u8(_t(f)))) for f in frames]
    H = {0: np.eye(3)}
    for j in (1, 2):
        H[j], n = pano._pair_homography(feats[0], feats[j])
        assert n >= 12
    got = pano.composite([_t(f) for f in frames], H).numpy()
    want = _composite_cv2(frames, H)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= WARP_TOL
