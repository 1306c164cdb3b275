"""The port's tiled develop (rapidraw_tpu_torch/pipeline/tiled.py) and the
tile placement of its grade and per-pixel NR plain versions, against the
port's whole-image develop and against JAX.

Every case of tests/test_tiled.py runs on the port at its sizes (96 x 160
images, 64-pixel tiles, 16-pixel overlap): tiled against whole, at JAX's
tolerances or tighter (the port's coordinates are absolute in every stage,
so its grain and dither are exact across seams too). The port's tiled
result is held to JAX's `develop_tiled` run op by op (`jax.disable_jit`:
JAX's jitted chain differs from its own op-by-op run, ROADMAP queue C)
within 5e-5 (measured 2.3e-5 with the centre mask and grain), the grade
with a tile offset to JAX's `develop_fused` with RAPIDRAW_FUSED=1 (its
Pallas megakernel in interpret mode, the pattern of
tests/test_tiled.py::test_tiled_fused_kernel_offsets) within 2e-4, and
per-pixel NR at an offset to JAX's gather path run op by op at the bounds
of tests/test_torch_nr.py. With offset (0, 0) and the tile's own size the
plain versions give what they gave without the arguments, bit for bit.
JAX's exact-jitter NR mode (its last case) is not ported (ROADMAP queue B).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidraw_tpu.masks.rasterize import rasterize_masks as jrasterize
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline.tiled import develop_tiled as jtiled
from rapidraw_tpu_torch.masks.rasterize import rasterize_masks
from rapidraw_tpu_torch.ops import ca as tca
from rapidraw_tpu_torch.ops import colorspace as tcs
from rapidraw_tpu_torch.ops import flare as tflare
from rapidraw_tpu_torch.ops import nr as tnr
from rapidraw_tpu_torch.params.parse import parse_adjustments
from rapidraw_tpu_torch.pipeline import fused
from rapidraw_tpu_torch.pipeline.develop import develop
from rapidraw_tpu_torch.pipeline.tiled import develop_tiled, tile_windows

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

TILE = {"tile_size": 64, "overlap": 16}


def _img(h, w, seed=0):
    return np.random.default_rng(seed).random((3, h, w)).astype(np.float32)


def _radial(adjustments: dict, exposure: float, rx=50, ry=30) -> dict:
    return {"exposure": exposure, "masks": [{
        "name": "m", "visible": True, "adjustments": adjustments,
        "subMasks": [{"type": "radial", "visible": True, "mode": "additive",
                      "parameters": {"centerX": 80, "centerY": 48, "radiusX": rx,
                                     "radiusY": ry, "rotation": 0.0, "feather": 0.5}}],
    }]}


ELEMENTWISE = {"exposure": 0.5, "contrast": 20, "vignetteAmount": -40, "toneMapper": "agx"}
GRAIN = {"exposure": 0.5, "grainAmount": 25, "toneMapper": "agx"}
BLUR = {"shadows": 40, "clarity": 30, "exposure": 0.2}
CA = {"exposure": 0.2, "chromaticAberrationRedCyan": 500,
      "chromaticAberrationBlueYellow": -400}
CENTRE = {"exposure": 0.3, "vignetteAmount": 30, "centré": 40, "grainAmount": 40}
MASKS = _radial({"exposure": 1.5}, 0.2)
MASKED_NR = _radial({"lumaNoiseReduction": 60, "colorNoiseReduction": 40}, 0.1, rx=70, ry=40)

# tests/test_tiled.py's cases: (doc, image seed, dither, tiled-vs-whole bound)
CASES = {
    "elementwise": (ELEMENTWISE, 0, False, 1e-5),
    "grain_dither": (GRAIN, 0, True, 0.0),
    "blur_interior": (BLUR, 1, True, 1e-5),
    "masks": (MASKS, 3, True, 1e-6),
    "ca_full_centre": (CA, 5, False, 1e-6),
    "masked_nr": (MASKED_NR, 6, False, 1e-5),
}


def _parsed(doc, dither=True, jax_side=False):
    p, c = (jparse if jax_side else parse_adjustments)(doc, is_raw=False)
    return p, (c if dither else dataclasses.replace(c, dither_active=False))


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_matches_whole(case):
    """Tiled against the whole-image develop on the same numpy input."""
    doc, seed, dither, bound = CASES[case]
    x = torch.from_numpy(_img(96, 160, seed))
    p, c = _parsed(doc, dither)
    masks = rasterize_masks(doc, 160, 96, scale=1.0) if doc.get("masks") else None
    mk = None if masks is None else torch.from_numpy(masks)
    whole = develop(x, p, c, masks=mk)
    tiled = develop_tiled(x, p, c, masks=masks, **TILE)
    d = float((tiled - whole).abs().max())
    print(f"{case}: max|d| {d:.3e}")
    assert d <= bound
    if case == "grain_dither":
        # JAX's bar (tests/test_tiled.py:46-54): within the hash amplitude
        assert float((tiled - whole).mean().abs()) < 1e-3


def test_tiled_single_tile_path():
    x = torch.from_numpy(_img(40, 60, 2))
    p, c = _parsed({"exposure": 1.0}, dither=False)
    assert torch.equal(develop_tiled(x, p, c), develop(x, p, c))


JAX_CASES = {"elementwise": (ELEMENTWISE, 0, False), "ca_full_centre": (CA, 5, False),
             "centre_grain": (CENTRE, 1, True)}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_tiled_matches_jax(case):
    """The port's develop_tiled against JAX's, run op by op, on the same
    numpy image, two tiles and their seam: within 5e-5 (the port's chain
    sits an ulp or so from JAX's op-by-op XLA chain, ROADMAP queue C)."""
    doc, seed, dither = JAX_CASES[case]
    x = _img(64, 112, seed)
    jp, jc = _parsed(doc, dither, jax_side=True)
    p, c = _parsed(doc, dither)
    with jax.disable_jit():
        want = np.asarray(jtiled(x, jp, jc, **TILE))
    got = develop_tiled(torch.from_numpy(x), p, c, **TILE).numpy()
    d = np.abs(got - want)
    print(f"{case}: max|d| {d.max():.3e}, share>1e-6 {(d > 1e-6).mean():.2e}")
    assert got.shape == want.shape and d.max() <= 5e-5


def test_tiled_masks_match_jax_rasterizer():
    """The tiled path's mask slices come from the port's rasterizer, equal
    to JAX's on the test's document."""
    for doc in (MASKS, MASKED_NR):
        np.testing.assert_array_equal(rasterize_masks(doc, 160, 96, scale=1.0),
                                      jrasterize(doc, 160, 96, scale=1.0))


@pytest.mark.parametrize("origin", [(64, 32), (0, 48), (96, 0)])
def test_grade_tile_offset_matches_jax_fused_kernel(monkeypatch, origin):
    """JAX's megakernel (develop_fused, RAPIDRAW_FUSED=1, Pallas interpret
    mode, jitted as tests/test_tiled.py runs it) on a 64 x 64 tile at
    `origin` of a 160 x 96 image against the port's develop with the same
    placement (its grade plain version): vignette, the centre mask, the
    tonal blur at the full image's radius, within 2e-4."""
    from rapidraw_tpu.pipeline.fused import develop_fused as jfused

    monkeypatch.setenv("RAPIDRAW_FUSED", "1")
    doc = {"exposure": 0.4, "contrast": 15, "vignetteAmount": -50, "centré": 30,
           "shadows": 25, "toneMapper": "agx"}
    x0, y0 = origin
    tile = _img(96, 160, 4)[:, y0:y0 + 64, x0:x0 + 64].copy()
    jp, jc = _parsed(doc, False, jax_side=True)
    p, c = _parsed(doc, False)
    want = np.asarray(jax.jit(lambda t, q: jfused(
        t, q, jc, tile_offset=origin, full_size=(160, 96)))(jnp.asarray(tile), jp))
    got = develop(torch.from_numpy(tile), p, c, tile_offset=origin, full_size=(160, 96)).numpy()
    d = np.abs(got - want)
    print(f"origin {origin}: max|d| {d.max():.3e}")
    assert d.max() <= 2e-4


def test_nr_dynamic_tile_offset_matches_jax():
    """Per-pixel NR of a tile at (37, 53): the jitter hashes read absolute
    coordinates in both (JAX nr.py:131-133), the taps stay tile-local; JAX
    op by op, bounds of tests/test_torch_nr.py."""
    from rapidraw_tpu.ops import nr as jnr
    from test_torch_nr import adversarial

    x = adversarial(48, 72, seed=9)
    xt = torch.from_numpy(x)
    center = tcs.srgb_to_linear(xt)
    rng = np.random.default_rng(3)
    la = rng.random((48, 72)).astype(np.float32)
    ca = rng.random((48, 72)).astype(np.float32)
    scale = 800 / 1080.0
    with jax.disable_jit():
        want = np.asarray(jnr.apply_noise_reduction(
            jnp.asarray(center.numpy()), jnp.asarray(x), jnp.asarray(la), jnp.asarray(ca),
            scale, False, tile_offset=(37, 53)))
    got = tnr.nr_dynamic(center, tnr.nr_planes(xt, False), torch.from_numpy(la),
                         torch.from_numpy(ca), scale, tile_offset=(37, 53)).numpy()
    d = np.abs(got - want)
    assert d.max() <= 2e-4 and np.quantile(d, 0.999) <= 1e-5
    # the offset moves the jitter: the tile's own origin gives another result
    at_zero = tnr.nr_dynamic(center, tnr.nr_planes(xt, False), torch.from_numpy(la),
                             torch.from_numpy(ca), scale).numpy()
    assert np.abs(at_zero - got).max() > 1e-3


def test_offset_zero_is_bit_identical():
    """Offset (0, 0) and the tile's own size: the plain grade (every
    coordinate stage on, flare and masks), per-pixel NR and the flare
    sample give what they give without the arguments, bit for bit."""
    h, w = 40, 56
    x = torch.from_numpy(_img(h, w, 8))[None]
    doc = dict(_radial({"exposure": 0.5}, 0.2), vignetteAmount=-30, grainAmount=30, centré=20,
               flareAmount=40, clarity=20)
    p, c = parse_adjustments(doc)
    assert c.flare_active and c.grain_active and c.dither_active and c.mask_count == 1
    masks = torch.from_numpy(rasterize_masks(doc, w, h, scale=1.0))[None]
    sp = {"glob": fused._add_batch_axis(p["glob"]), "mask": fused._add_batch_axis(p["mask"])}
    pmat, mmat = fused.pack_rows(sp["glob"]), fused.pack_mask_rows(sp["mask"])
    levels = fused.blur_levels(x, c)
    fmap = torch.from_numpy(np.random.default_rng(1).random((1, 512, 512, 3), np.float32))
    base = fused.grade_plain(x, levels, pmat, c, masks=masks, mmat=mmat, flare=fmap)
    placed = fused.grade_plain(x, levels, pmat, c, masks=masks, mmat=mmat, flare=fmap,
                               tile_offset=(0, 0), full_size=(w, h))
    assert torch.equal(base, placed)
    assert torch.equal(tflare.sample_flare(fmap[0], h, w),
                       tflare.sample_flare(fmap[0], h, w, (0, 0), (w, h)))
    center = tcs.srgb_to_linear(x[0])
    planes = tnr.nr_planes(x[0], False)
    assert torch.equal(tnr.nr_dynamic(center, planes, 0.6, 0.4, 0.5),
                       tnr.nr_dynamic(center, planes, 0.6, 0.4, 0.5, tile_offset=(0, 0)))


def test_grade_plain_tile_equals_the_whole_image_crop():
    """The grade of a tile at its offset (its blur level the crop of the
    whole image's) equals the crop of the whole image's grade, bit for bit,
    with every coordinate stage on (vignette, centre, grain, dither, the
    flare sample)."""
    h, w = 48, 80
    x = torch.from_numpy(_img(h, w, 10))[None]
    doc = {"vignetteAmount": -30, "grainAmount": 30, "centré": 20, "flareAmount": 40,
           "exposure": 0.3}
    p, c = parse_adjustments(doc)
    pmat = fused.pack_rows(fused._add_batch_axis(p["glob"]))
    fmap = torch.from_numpy(np.random.default_rng(2).random((1, 512, 512, 3), np.float32))
    levels = fused.blur_levels(x, c)
    whole = fused.grade_plain(x, levels, pmat, c, flare=fmap)
    y0, x0 = 13, 29

    def crop(t):
        return t[:, :, y0:y0 + 24, x0:x0 + 40].contiguous()

    got = fused.grade(crop(x), {k: crop(v) for k, v in levels.items()}, pmat, c, flare=fmap,
                      tile_offset=(x0, y0), full_size=(w, h))
    assert torch.equal(got, crop(whole))


def test_ca_host_indices_and_dynamic_path_match_jax():
    """CA of one tile: the port's one path, re-centred on the full image by
    the tile's placement, equals JAX's two tile paths, its float64 host
    indices (`ca_host_indices`, what JAX's tiled develop passes) and its
    per-coordinate (dynamic) path, bit for bit."""
    from rapidraw_tpu.ops import ca as jca

    for (h, w, rc, by, off, full, seed) in ((30, 50, 0.012, -0.009, (40, 20), (160, 96), 11),
                                            (64, 64, 0.02, 0.0, (96, 32), (160, 96), 12),
                                            (96, 160, -0.015, 0.01, (0, 0), None, 13)):
        tile = _img(h, w, seed)
        with jax.disable_jit():
            host = np.asarray(jca.apply_ca_correction(
                jnp.asarray(tile), rc, by, precomputed=jca.ca_host_indices(h, w, rc, by, off,
                                                                           full)))
            dynamic = np.asarray(jca.apply_ca_correction(
                jnp.asarray(tile), jnp.float32(rc), jnp.float32(by), tile_offset=off,
                full_size=full))
        got = tca.apply_ca_correction(torch.from_numpy(tile), rc, by, tile_offset=off,
                                      full_size=full).numpy()
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, dynamic)


def test_tile_windows_cover_the_image_and_refuse_misplacement():
    for h, w in ((96, 160), (64, 64), (130, 65)):
        seen = np.zeros((h, w), np.int32)
        for (y0, y1, x0, x1), (ys0, ys1, xs0, xs1) in tile_windows(h, w, 64, 16):
            seen[y0:y1, x0:x1] += 1
            assert ys0 == max(0, y0 - 16) and ys1 == min(h, y1 + 16)
            assert xs0 == max(0, x0 - 16) and xs1 == min(w, x1 + 16)
        assert (seen == 1).all()
    x = torch.zeros((1, 3, 8, 8))
    p, c = parse_adjustments({"vignetteAmount": 20})
    pmat = fused.pack_rows(fused._add_batch_axis(p["glob"]))
    for off, full in (((4, 0), (10, 8)), ((-1, 0), (16, 16)), ((0, 0), (8, 7))):
        with pytest.raises(ValueError, match="does not lie inside"):
            fused.grade(x, {}, pmat, c, tile_offset=off, full_size=full)
