"""Each ported PyTorch op against its JAX function on seeded inputs.

Inputs are made with numpy.random.default_rng and handed to both sides;
tolerances are the per-stage ones of tests/test_oracle_match.py (the port
runs the same float32 formulas, so it sits far inside them).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rapidraw_tpu.ops import color as jcolor
from rapidraw_tpu.ops import colorspace as jcs
from rapidraw_tpu.ops import common as jcommon
from rapidraw_tpu.ops import curves as jcurves
from rapidraw_tpu.ops import grain as jgrain
from rapidraw_tpu.ops import local as jlocal
from rapidraw_tpu.ops import tone as jtone
from rapidraw_tpu.pipeline import grade as jgrade
from rapidraw_tpu.params.agx import AGX_PIPE_TO_RENDERING, AGX_RENDERING_TO_PIPE
from rapidraw_tpu.params.curves import bake_curve_set
from rapidraw_tpu_torch.ops import color as tcolor
from rapidraw_tpu_torch.ops import colorspace as tcs
from rapidraw_tpu_torch.ops import common as tcommon
from rapidraw_tpu_torch.ops import curves as tcurves
from rapidraw_tpu_torch.ops import grain as tgrain
from rapidraw_tpu_torch.ops import local as tlocal
from rapidraw_tpu_torch.ops import tone as ttone
from rapidraw_tpu_torch.pipeline import grade as tgrade

torch.set_num_threads(2)

TOL = 2e-5  # test_oracle_match.TOL (transfer functions)
SHAPE = (3, 48, 64)


def px(seed: int, lo: float = 0.0, hi: float = 1.0, shape=SHAPE) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * (hi - lo) + lo).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def close(got, want, atol, rtol=0.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def coords(h=SHAPE[1], w=SHAPE[2]):
    ys = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w)).copy()
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w)).copy()
    return xs, ys


# ---- ops/common.py ----------------------------------------------------------

@pytest.mark.parametrize("y", [0.37, 1.0 / 2.4, 1.7, 3.1])
def test_fpow_family(y):
    x = px(1, 0.0, 4.0)
    close(tcommon.fpow(t(x), y), jcommon.fpow(j(x), y), atol=1e-6, rtol=1e-6)
    if y <= 1.0:
        close(tcommon.fpow_lt1(t(x), y), jcommon.fpow_lt1(j(x), y), atol=1e-6, rtol=1e-6)
    else:
        close(tcommon.fpow_static(t(x), y), jcommon.fpow_static(j(x), y), atol=1e-6, rtol=1e-6)


def test_smoothstep_static_and_dynamic():
    x = px(2, -0.5, 1.5)
    e0, e1 = px(3, 0.0, 0.4, SHAPE[1:]), px(4, 0.5, 1.0, SHAPE[1:])
    close(tcommon.smoothstep(0.1, 0.8, t(x)), jcommon.smoothstep(0.1, 0.8, j(x)), atol=1e-7)
    close(tcommon.smoothstep(t(e0), t(e1), t(x)), jcommon.smoothstep(j(e0), j(e1), j(x)),
          atol=1e-6)
    close(tcommon.smoothstep(t(e0), t(e0), t(x)), jcommon.smoothstep(j(e0), j(e0), j(x)),
          atol=0)


def test_luma_mix_mod():
    a, b, m = px(5), px(6), px(7, 0, 1, SHAPE[1:])
    close(tcommon.luma(t(a)), jcommon.luma(j(a)), atol=0)
    close(tcommon.mix(t(a), t(b), t(m)), jcommon.mix(j(a), j(b), j(m)), atol=0)
    x = px(8, -720.0, 720.0)
    close(tcommon.wgsl_mod(t(x), 360.0), jcommon.wgsl_mod(j(x), 360.0), atol=0)


# ---- ops/colorspace.py --------------------------------------------------------

@pytest.mark.parametrize("fn", ["srgb_to_linear", "linear_to_srgb", "linear_to_srgb_extended"])
def test_transfer_functions(fn):
    x = px(9, -0.2, 1.6)
    close(getattr(tcs, fn)(t(x)), getattr(jcs, fn)(j(x)), atol=TOL)


def test_hsv_round_trip():
    x = px(10, -0.1, 1.2)
    th, ts, tv = tcs.rgb_to_hsv(t(x))
    jh, js, jv = jcs.rgb_to_hsv(j(x))
    for a, b in ((th, jh), (ts, js), (tv, jv)):
        close(a, b, atol=1e-3)  # test_oracle_match hsv tolerance
    close(tcs.hsv_to_rgb(th, ts, tv), jcs.hsv_to_rgb(jh, js, jv), atol=1e-3)


# ---- ops/tone.py ------------------------------------------------------------------

@pytest.mark.parametrize("e", [0.0, 0.7, -1.3])
def test_linear_exposure(e):
    x = px(11)
    close(ttone.apply_linear_exposure(t(x), torch.tensor(e)),
          jtone.apply_linear_exposure(j(x), e), atol=1e-6)


@pytest.mark.parametrize("b", [0.0, 0.6, -0.9])
def test_filmic_exposure(b):
    x = px(12, -0.05, 2.0)
    close(ttone.apply_filmic_exposure(t(x), torch.tensor(b)),
          jtone.apply_filmic_exposure(j(x), b), atol=1e-4)


@pytest.mark.parametrize("shadow_path", [True, False])
@pytest.mark.parametrize("con,sh,wh,bl", [(0.2, 0.3, 0.1, -0.2), (0.0, -0.4, 0.0, 0.5),
                                           (-0.3, 0.0, -0.2, 0.0)])
def test_tonal_adjustments(shadow_path, con, sh, wh, bl):
    x, blur = px(13, 0.0, 1.3), px(14, 0.0, 1.2)
    got = ttone.apply_tonal_adjustments(t(x), t(blur), con, sh, wh, bl, shadow_path=shadow_path)
    want = jtone.apply_tonal_adjustments(j(x), j(blur), False, con, sh, wh, bl,
                                         blur_is_linear=True, shadow_path=shadow_path)
    close(got, want, atol=1e-4)


@pytest.mark.parametrize("h", [-0.6, 0.4, 0.0])
def test_highlights(h):
    x = px(15, 0.0, 3.0)
    close(ttone.apply_highlights(t(x), h), jtone.apply_highlights(j(x), h), atol=1e-4, rtol=3e-5)


def test_agx_tonemap():
    x = px(16, -0.1, 4.0)
    close(ttone.agx_tonemap(t(x), t(AGX_PIPE_TO_RENDERING), t(AGX_RENDERING_TO_PIPE)),
          jtone.agx_tonemap(j(x), AGX_PIPE_TO_RENDERING, AGX_RENDERING_TO_PIPE), atol=1e-4)


def test_raw_srgb_emulation():
    x = px(17, 0.0, 1.5)
    close(ttone.raw_srgb_emulation(t(x)), jtone.raw_srgb_emulation(j(x)), atol=TOL)


# ---- ops/color.py -------------------------------------------------------------------

def test_white_balance():
    x = px(18)
    close(tcolor.apply_white_balance(t(x), torch.tensor(0.3), torch.tensor(-0.2)),
          jcolor.apply_white_balance(j(x), 0.3, -0.2), atol=1e-5)


@pytest.mark.parametrize("sat,vib", [(0.2, 0.3), (-0.3, -0.4), (0.0, 0.5), (0.4, 0.0)])
def test_creative_color(sat, vib):
    x = px(19, 0.0, 1.2)
    close(tcolor.apply_creative_color(t(x), sat, vib),
          jcolor.apply_creative_color(j(x), sat, vib), atol=1e-4)


@pytest.mark.parametrize("shift", [12.0, -40.0, 0.005])
def test_hue_shift(shift):
    x = px(20, 0.0, 1.2)
    close(tcolor.apply_hue_shift(t(x), shift), jcolor.apply_hue_shift(j(x), shift), atol=1e-4)


@pytest.mark.parametrize("bands", [(True,) * 8, (True, False, False, True, False, True, False, False)])
def test_hsl_panel(bands):
    x = px(21, 0.0, 1.2)
    hsl = px(22, -0.5, 0.5, (8, 3)) * np.asarray(bands, np.float32)[:, None]
    close(tcolor.apply_hsl_panel(t(x), t(hsl), band_active=bands),
          jcolor.apply_hsl_panel(j(x), j(hsl), band_active=bands), atol=2e-3)


@pytest.mark.parametrize("blend,bal", [(0.5, 0.0), (0.8, 0.4), (0.2, -0.6)])
def test_color_grading(blend, bal):
    x = px(23, 0.0, 1.2)
    cg = px(24, 0.0, 1.0, (4, 3)) * np.float32([360.0, 0.4, 0.2]) - np.float32([0, 0, 0.1])
    close(tcolor.apply_color_grading(t(x), t(cg), torch.tensor(blend), torch.tensor(bal)),
          jcolor.apply_color_grading(j(x), j(cg), blend, bal), atol=1e-4)


def test_color_calibration():
    x = px(25, 0.0, 1.2)
    cal = px(26, -0.3, 0.3, (7,))
    close(tcolor.apply_color_calibration(t(x), t(cal)),
          jcolor.apply_color_calibration(j(x), j(cal)), atol=1e-4)


# ---- ops/local.py -------------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("amount", [0.5, -0.4])
@pytest.mark.parametrize("is_raw", [False, True])
def test_local_contrast(mode, amount, is_raw):
    x, blur = px(27, 0.0, 1.1), px(28, 0.0, 1.1)
    got = tlocal.apply_local_contrast(t(x), t(blur), amount, is_raw, mode, torch.tensor(0.15))
    want = jlocal.apply_local_contrast(j(x), j(blur), amount, is_raw, mode, 0.15,
                                       blur_is_linear=True)
    close(got, want, atol=2e-4)


def test_centre_stages():
    x, blur = px(29, 0.0, 1.1), px(30, 0.0, 1.1)
    xs, ys = coords()
    w, h = SHAPE[2], SHAPE[1]
    cm_t = tlocal.centre_mask_from_coords(t(xs), t(ys), w, h)
    cm_j = jlocal.centre_mask_from_coords(j(xs), j(ys), w, h)
    close(cm_t, cm_j, atol=1e-6)
    close(tlocal.apply_centre_local_contrast(t(x), 0.4, t(blur), False, cm_t),
          jlocal.apply_centre_local_contrast(j(x), 0.4, j(blur), False, blur_is_linear=True,
                                             centre_mask=cm_j), atol=3e-4)
    close(tlocal.apply_centre_tonal_and_color(t(x), -0.3, cm_t),
          jlocal.apply_centre_tonal_and_color(j(x), -0.3, cm_j), atol=3e-4)


@pytest.mark.parametrize("amount", [0.6, -0.5])
def test_dehaze(amount):
    x, blur = px(31, 0.0, 1.1), px(32, 0.0, 1.1)
    close(tlocal.apply_dehaze(t(x), t(blur), amount),
          jlocal.apply_dehaze(j(x), j(blur), False, amount, blur_is_linear=True), atol=2e-4)


@pytest.mark.parametrize("stage", ["glow", "halation"])
def test_glow_and_halation(stage):
    x, blur = px(33, 0.0, 1.5), px(34, 0.0, 2.5)
    tfn = tlocal.apply_glow_bloom if stage == "glow" else tlocal.apply_halation
    jfn = jlocal.apply_glow_bloom if stage == "glow" else jlocal.apply_halation
    got = tfn(t(x), t(blur), 0.6, torch.tensor(0.3), torch.tensor(0.2), torch.tensor(0.1))
    want = jfn(j(x), j(blur), 0.6, False, 0.3, 0.2, 0.0, 0.1, blur_is_linear=True)
    close(got, want, atol=3e-4)


def test_vignette():
    x = px(35, 0.0, 1.0)
    xs, ys = coords()
    w, h = SHAPE[2], SHAPE[1]
    for amount in (-0.4, 0.3):
        args = (amount, 0.5, 0.2, 0.5)
        close(tgrade.apply_vignette(t(x), t(xs), t(ys), w, h, *(torch.tensor(a) for a in args)),
              jgrade.apply_vignette(j(x), j(xs), j(ys), w, h, *args), atol=2e-4)


# ---- ops/curves.py --------------------------------------------------------------------

@pytest.mark.parametrize("rgb_maybe", [False, True])
def test_curves(rgb_maybe):
    curves = bake_curve_set({
        "luma": [{"x": 0, "y": 10}, {"x": 90, "y": 70}, {"x": 180, "y": 200}, {"x": 255, "y": 245}],
        "red": [{"x": 0, "y": 0}, {"x": 120, "y": 140}, {"x": 255, "y": 255}],
    })
    x = px(36, 0.0, 1.0)
    tset = {k: t(v) for k, v in curves.items()}
    jset = {k: j(v) for k, v in curves.items()}
    close(tcurves.apply_all_curves(t(x), tset, 15, rgb_maybe),
          jcurves.apply_all_curves(j(x), jset, rgb_maybe), atol=1e-4)


# ---- ops/grain.py -----------------------------------------------------------------------

def test_hash_noise_and_dither():
    xs, ys = coords(64, 96)
    close(tgrain.hash2(t(xs), t(ys)), jgrain.hash2(j(xs), j(ys)), atol=1e-6)
    close(tgrain.dither_from_coords(t(xs), t(ys)), jgrain.dither_from_coords(j(xs), j(ys)),
          atol=1e-6)
    close(tgrain.gradient_noise(t(xs) * 0.37, t(ys) * 0.37),
          jgrain.gradient_noise(j(xs) * 0.37, j(ys) * 0.37), atol=1e-5)


def test_apply_grain():
    x = px(37, 0.0, 1.0)
    xs, ys = coords()
    got = tgrain.apply_grain(t(x), torch.tensor(0.3), torch.tensor(0.5), torch.tensor(0.4),
                             0.8, t(xs), t(ys))
    want = jgrain.apply_grain(j(x), 0.3, 0.5, 0.4, 0.8, j(xs), j(ys))
    close(got, want, atol=1e-5)
