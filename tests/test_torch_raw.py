"""The port's RAW front end (rapidraw_tpu_torch.raw) against the JAX
package's (rapidraw_tpu.raw), run op by op (`jax.disable_jit`) on the CPU.

Same inputs, made from a seed with NumPy, through both. Bounds: demosaic
(bilinear, malvar, speed; four patterns), X-Trans, highlight compression
and the three develop functions max |d| <= 1e-5; orientation bit-equal.
The enhance pass has discontinuous gates, so it is held to 1e-5 on every
value but those a gate moved, whose share is counted, printed and bounded
by 0.1%.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidraw_tpu.io.dng import _orient_planar as j_orient
from rapidraw_tpu.raw import color as jcolor
from rapidraw_tpu.raw import demosaic as jdemosaic
from rapidraw_tpu.raw import develop as jdevelop
from rapidraw_tpu.raw import enhance as jenhance
from rapidraw_tpu.raw import xtrans as jxtrans
from rapidraw_tpu_torch.io.dng import _orient_planar
from rapidraw_tpu_torch.io.loader import _apply_exif_orientation
from rapidraw_tpu_torch.raw import color, demosaic, develop, enhance, xtrans

torch.set_num_threads(2)

TOL = 1e-5
ENHANCE_FLIP_SHARE = 1e-3
PATTERNS = ("RGGB", "BGGR", "GRBG", "GBRG")
XYZ_TO_CAM = np.array([[0.9, -0.3, -0.05], [-0.4, 1.2, 0.2], [-0.05, 0.2, 0.65]], np.float32)


def jax_op_by_op(fn, *args, **kwargs) -> np.ndarray:
    with jax.disable_jit():
        return np.asarray(fn(*args, **kwargs))


def assert_close(got: torch.Tensor, want: np.ndarray, tol: float = TOL) -> None:
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= tol


def cfa_u16(h, w, seed):
    return np.random.default_rng(seed).integers(64, 16383, (h, w), dtype=np.uint16)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("algo", ["bilinear", "malvar", "speed"])
def test_demosaic_matches_jax(algo, pattern):
    x = np.random.default_rng(1).random((64, 96), dtype=np.float32) * 1.3
    want = jax_op_by_op(getattr(jdemosaic, f"demosaic_{algo}"), jnp.asarray(x), pattern)
    assert_close(getattr(demosaic, f"demosaic_{algo}")(torch.from_numpy(x), pattern), want)


@pytest.mark.parametrize("algo", ["bilinear", "malvar", "speed"])
def test_demosaic_matches_jax_at_1024x1536(algo):
    x = np.random.default_rng(2).random((1024, 1536), dtype=np.float32) * 1.3
    want = jax_op_by_op(getattr(jdemosaic, f"demosaic_{algo}"), jnp.asarray(x), "RGGB")
    assert_close(getattr(demosaic, f"demosaic_{algo}")(torch.from_numpy(x), "RGGB"), want)


def test_demosaic_refuses_an_unknown_pattern():
    with pytest.raises(ValueError, match="unsupported CFA pattern"):
        demosaic.demosaic_malvar(torch.zeros((8, 8)), "RGBG")


@pytest.mark.parametrize("shift", [(0, 0), (1, 4)])
def test_xtrans_matches_jax(shift):
    """The default layout, and the layout after a crop of 1 row, 4 columns,
    on a frame that is a multiple of 6 on neither side."""
    pat = xtrans.shift_xtrans(xtrans.DEFAULT_XTRANS, *shift)
    assert np.array_equal(pat, jxtrans.shift_xtrans(jxtrans.DEFAULT_XTRANS, *shift))
    x = np.random.default_rng(3).random((70, 101), dtype=np.float32)
    want = jax_op_by_op(jxtrans.demosaic_xtrans, jnp.asarray(x), pat)
    assert_close(xtrans.demosaic_xtrans(torch.from_numpy(x), pat), want)


def test_xtrans_refuses_an_uncovered_pattern():
    with pytest.raises(ValueError, match="uncovered"):
        xtrans.demosaic_xtrans(torch.zeros((12, 12)), np.ones((6, 6), np.int32))


@pytest.mark.parametrize("clamp_limit", [None, 1.0])
@pytest.mark.parametrize("hc", [2.5, 1.0])
def test_highlight_compression_matches_jax(hc, clamp_limit):
    rgb = np.random.default_rng(4).uniform(-0.2, 3.0, (3, 96, 128)).astype(np.float32)
    want = jax_op_by_op(jdevelop.apply_highlight_compression, jnp.asarray(rgb), hc, clamp_limit)
    got = develop.apply_highlight_compression(torch.from_numpy(rgb), hc, clamp_limit)
    assert_close(got, want)
    assert float(got.max()) <= (max(hc, 1.01) if clamp_limit is None else clamp_limit)


def test_color_matrices_are_the_jax_packages():
    assert np.array_equal(color.camera_to_srgb_matrix(XYZ_TO_CAM),
                          jcolor.camera_to_srgb_matrix(XYZ_TO_CAM))
    wb = np.array([2.1, 1.0, 1.55]) / 0.9
    assert np.array_equal(color.normalize_wb(wb), jcolor.normalize_wb(wb))


@pytest.mark.parametrize("pattern,algo,clamp_limit", [
    ("RGGB", "malvar", None), ("GBRG", "bilinear", None), ("BGGR", "speed", 1.0)])
def test_develop_cfa_matches_jax(pattern, algo, clamp_limit):
    cfa = cfa_u16(96, 130, 5)
    wb = np.array([2.1, 1.0, 1.55], np.float32)
    cam = color.camera_to_srgb_matrix(XYZ_TO_CAM)
    want = jax_op_by_op(jdevelop.develop_cfa, jnp.asarray(cfa).astype(jnp.float32), 64.0,
                        16383.0, wb, cam, pattern=pattern, algorithm=algo,
                        clamp_limit=clamp_limit)
    got = develop.develop_cfa(torch.from_numpy(cfa).to(torch.float32), 64.0, 16383.0, wb, cam,
                              pattern=pattern, algorithm=algo, clamp_limit=clamp_limit)
    assert_close(got, want)


def test_develop_cfa_xtrans_matches_jax():
    cfa = cfa_u16(72, 90, 6)
    wb = np.array([1.5, 1.0, 1.733], np.float32)
    cam = color.camera_to_srgb_matrix(XYZ_TO_CAM)
    want = jax_op_by_op(jdevelop.develop_cfa_xtrans, jnp.asarray(cfa).astype(jnp.float32), 64.0,
                        16383.0, wb, cam, jxtrans.DEFAULT_XTRANS, highlight_compression=2.0)
    got = develop.develop_cfa_xtrans(torch.from_numpy(cfa).to(torch.float32), 64.0, 16383.0,
                                     wb, cam, xtrans.DEFAULT_XTRANS, highlight_compression=2.0)
    assert_close(got, want)


@pytest.mark.parametrize("linear_mode", ["default", "gamma", "skip_calib", "gamma_skip_calib"])
def test_develop_linear_raw_matches_jax(linear_mode):
    """The four linear modes as load_raw_file maps them: ungamma in the
    'gamma' modes, the camera matrix unless 'skip_calib'."""
    rgb = np.random.default_rng(7).integers(0, 65535, (3, 80, 112)).astype(np.float32)
    ungamma = linear_mode in ("gamma", "gamma_skip_calib")
    cam = None if "skip_calib" in linear_mode else color.camera_to_srgb_matrix(XYZ_TO_CAM)
    want = jax_op_by_op(jdevelop.develop_linear_raw, jnp.asarray(rgb), 512.0, 60000.0,
                        apply_ungamma=ungamma, cam_matrix=cam)
    got = develop.develop_linear_raw(torch.from_numpy(rgb), 512.0, 60000.0,
                                     apply_ungamma=ungamma, cam_matrix=cam)
    assert_close(got, want)


@pytest.mark.parametrize("nr,sharpen", [(14.0, 0.35), (0.0, 0.35), (14.0, 0.0)])
def test_enhance_matches_jax(nr, sharpen):
    """The default amounts (colour NR 0.5 -> inverse sigma 14, sharpening
    0.35) and each pass alone, on a (3, 192, 256) image with values past
    1.0 as a RAW develop gives them."""
    img = (np.random.default_rng(8).random((3, 192, 256), dtype=np.float32) * 1.2)
    want = jax_op_by_op(jenhance.remove_raw_artifacts_and_enhance, jnp.asarray(img), nr,
                        sharpen)
    got = enhance.remove_raw_artifacts_and_enhance(torch.from_numpy(img), nr, sharpen).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    off = np.abs(got - want) > TOL
    print(f"enhance nr={nr} sharpen={sharpen}: {int(off.sum())} of {off.size} values "
          f"moved by a gate (share {off.mean():.2e})")
    assert off.mean() <= ENHANCE_FLIP_SHARE


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orient_planar_matches_jax_and_the_loader(orientation):
    img = np.random.default_rng(9).random((3, 5, 7), dtype=np.float32)
    got = _orient_planar(torch.from_numpy(img), orientation).numpy()
    assert np.array_equal(got, jax_op_by_op(j_orient, jnp.asarray(img), orientation))
    hwc = _apply_exif_orientation(img.transpose(1, 2, 0), orientation)
    assert np.array_equal(got, hwc.transpose(2, 0, 1))
