"""Local masks (BASELINE config 4) in the PyTorch port against the JAX
package, on the CPU, on inputs made from a seed with numpy.

- Rasterizer: the port's `generate_mask_bitmap` / `rasterize_masks` equal
  JAX's bit for bit (u8, then f32) for every geometric sub-mask type, the
  three modes, invert and opacity, and a luminance-range mask on a warped
  image.
- Bands: `blur_band_rows` equals JAX's for (N, H, W) and (B, N, H, W).
- `grade_chain` with masks against JAX `grade_chain` at 64 x 96: 2e-4.
- `grade_plain` with masks (through `develop_fused_batch`) against JAX
  `develop_fused_batch` in Pallas interpret mode at 128 x 256 on config 4:
  2e-4 (the JAX fused-vs-XLA bound of tests/test_fused.py). The
  five-mask document is held against `grade_chain` only: JAX compiles its
  megakernel for ~30 s.
- Band exactness: banded and full-height blur levels give the same output.
- The fixed mask layout, the blend sets and the stage count the grade
  kernel reads; NR that a mask drives develops and matches JAX.
The config-4 path end to end and the mixed batch are in test_torch_slice.py.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rapidraw_tpu.masks import rasterize as jr
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline import grade as jgrade
from rapidraw_tpu.pipeline.bands import blur_band_rows as jbands
from rapidraw_tpu.pipeline.batch import stack_params as jstack
from rapidraw_tpu.pipeline.fused import develop_fused_batch as jfused_batch
import rapidraw_tpu_torch as rt
from rapidraw_tpu_torch.masks import rasterize as tr
from rapidraw_tpu_torch.pipeline import fused as tfused
from rapidraw_tpu_torch.pipeline import grade as tgrade

torch.set_num_threads(2)

TOL = 2e-4
H, W = 96, 128


def sub(kind, params=None, **kw):
    return {"type": kind, "visible": True, "mode": "additive", "parameters": params or {}, **kw}


RADIAL = {"centerX": 70, "centerY": 40, "radiusX": 30, "radiusY": 20, "rotation": 25.0,
          "feather": 0.4}
LINEAR = {"startX": 10, "startY": 5, "endX": 60, "endY": 80, "range": 25}
STROKES = {"lines": [
    {"points": [{"x": 10, "y": 70}, {"x": 60, "y": 75}, {"x": 110, "y": 60}],
     "brushSize": 24.0, "feather": 0.5},
    {"points": [{"x": 40, "y": 72}, {"x": 50, "y": 70}], "brushSize": 10.0, "feather": 0.2,
     "tool": "eraser"},
]}
FLOW = {"lines": [
    {"points": [{"x": 20, "y": 20}, {"x": 90, "y": 30}], "brushSize": 30.0, "feather": 0.6,
     "flow": 35},
    {"points": [{"x": 50, "y": 10}, {"x": 60, "y": 50}], "brushSize": 20.0, "flow": 60},
    {"points": [{"x": 55, "y": 25}], "brushSize": 12.0, "flow": 80, "tool": "eraser"},
]}

# Each case: one MaskDefinition.
MASK_DEFS = {
    "radial": {"visible": True, "subMasks": [sub("radial", RADIAL)]},
    "linear": {"visible": True, "subMasks": [sub("linear", LINEAR)]},
    "brush with an eraser line": {"visible": True, "subMasks": [sub("brush", STROKES)]},
    "flow": {"visible": True, "subMasks": [sub("flow", FLOW)]},
    "all": {"visible": True, "subMasks": [sub("all")]},
    "subtractive, inverted, opacity": {"visible": True, "subMasks": [
        sub("all"), sub("radial", RADIAL, mode="subtractive", invert=True, opacity=55)]},
    "intersect": {"visible": True, "subMasks": [
        sub("linear", LINEAR), sub("brush", STROKES, mode="intersect")]},
    "mask invert and opacity": {"visible": True, "invert": True, "opacity": 70, "subMasks": [
        sub("radial", RADIAL, opacity=80), sub("flow", FLOW)]},
    "hidden sub-mask": {"visible": True, "subMasks": [
        sub("linear", LINEAR), dict(sub("all"), visible=False)]},
}


@pytest.mark.parametrize("case", sorted(MASK_DEFS))
def test_mask_bitmap_matches_jax_bit_exact(case):
    mask_def = MASK_DEFS[case]
    for scale, offset in ((1.0, (0.0, 0.0)), (0.75, (6.0, 3.0))):
        got = tr.generate_mask_bitmap(mask_def, W, H, scale, offset)
        want = jr.generate_mask_bitmap(mask_def, W, H, scale, offset)
        assert got.dtype == want.dtype == np.uint8
        assert np.array_equal(got, want)
    assert 0 < int(got.max())  # every case draws something


def test_rasterize_masks_matches_jax_bit_exact():
    doc = {"masks": [dict(MASK_DEFS[k], adjustments={"exposure": 0.1}) for k in sorted(MASK_DEFS)]
           + [{"visible": False, "subMasks": [sub("all")]}]}
    got = rt.rasterize_masks(doc, W, H)
    want = jr.rasterize_masks(doc, W, H)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(MASK_DEFS), H, W)
    assert np.array_equal(got, want)
    assert rt.rasterize_masks({}, W, H) is None


def test_luminance_range_mask_on_a_warped_image_matches_jax():
    rng = np.random.default_rng(7)
    image = rng.random((3, H, W), dtype=np.float32)
    doc = {"transformRotate": 3.0, "masks": [{"visible": True, "subMasks": [
        sub("luminance", {"targetX": 64, "targetY": 40, "tolerance": 30, "grow": 20,
                          "feather": 30}),
        sub("color", {"targetX": 30, "targetY": 60, "tolerance": 40}, mode="intersect"),
    ]}]}
    warped = tr.resolve_warped_image(image, doc)
    want_warped = jr.resolve_warped_image(image, doc)
    assert warped.dtype == np.uint8 and warped.shape == (H, W, 3)
    assert np.array_equal(warped, want_warped)
    got = tr.rasterize_masks(doc, W, H, warped_image=warped)
    want = jr.rasterize_masks(doc, W, H, warped_image=want_warped)
    assert np.array_equal(got, want)
    assert got.max() > 0


def test_blur_band_rows_match_jax():
    doc = chip_smoke.config4_doc(1024, 1536)
    masks = rt.rasterize_masks(doc, 1536, 1024)
    _, tc = rt.parse_adjustments(doc)
    _, jc = jparse(doc)
    batch = np.stack([masks, masks[::-1] * 0.5])
    for m in (masks, batch):
        assert rt.blur_band_rows(tc, m) == jbands(jc, m)
    assert rt.blur_band_rows(tc, masks) == (("tonal", 384, 768), ("clarity", 640, 896))
    assert rt.blur_band_rows(tc, None) is None


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32))


def test_grade_chain_with_masks_matches_jax():
    """Every blend field the grade reads, mask sharpness, HSL, colour
    grading and curves, over five masks; influences from a seed, with
    values under the 0.001 gate and exact zeros among them."""
    h, w = 64, 96
    doc = chip_smoke.mask_stage_doc(h, w)
    tp, tc = rt.parse_adjustments(doc)
    jp, jc = jparse(doc)
    assert tc.mask_count == 5 and tc.mask_sharpness_active and tc.mask_hsl_active
    assert tc.mask_cg_active and tc.mask_curves_active
    consumed = set(tgrade.EFF_FIELDS) - {"luma_nr", "color_nr", "flare"}
    assert set(tc.mask_blend_fields) == consumed
    rng = np.random.default_rng(21)
    x = rng.random((3, h, w), dtype=np.float32)
    levels = {k: rng.random((3, h, w), dtype=np.float32)
              for k in ("sharp", "tonal", "clarity", "structure")}
    infl = rng.random((5, h, w), dtype=np.float32)
    infl[:, :, : w // 3] = 0.0
    infl[1, ::3] = 0.0008
    gated = np.where(infl > 0.001, infl, 0.0).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    want = jgrade.grade_chain(
        jnp.asarray(x), *(jnp.asarray(levels[k]) for k in ("sharp", "tonal", "clarity",
                                                            "structure")),
        None, jp["glob"], jp["mask"], jnp.asarray(gated), jc, jnp.asarray(xs), jnp.asarray(ys),
        w, h, 1.0,
    )
    got = tgrade.grade_chain(
        torch.from_numpy(x), *(torch.from_numpy(levels[k]) for k in ("sharp", "tonal",
                                                                       "clarity", "structure")),
        _torch_tree(tp["glob"]), tc, torch.from_numpy(xs), torch.from_numpy(ys), w, h,
        m=_torch_tree(tp["mask"]), gated_infl=tfused.gate_influences(torch.from_numpy(infl)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_plain_grade_with_masks_matches_pallas_b4():
    h, w = 128, 256
    doc = chip_smoke.config4_doc(h, w)
    docs = [doc, dict(doc, exposure=-0.2)]
    masks = rt.rasterize_masks(doc, w, h)
    mk = np.stack([masks, masks[:, ::-1]])
    x = np.random.default_rng(8).random((2, 3, h, w), dtype=np.float32)
    tp, tc = rt.stack_params(*zip(*[rt.parse_adjustments(d) for d in docs]), device="cpu")
    jp, jc = jstack(*map(list, zip(*[jparse(d) for d in docs])))
    tc, jc = (dataclasses.replace(c, dither_active=False) for c in (tc, jc))
    got = tfused.develop_fused_batch(torch.from_numpy(x), tp, tc, masks=torch.from_numpy(mk))
    want = jfused_batch(jnp.asarray(x), jp, jc, masks=jnp.asarray(mk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_banded_levels_give_the_unbanded_output():
    """Config 4 at 1024 x 1536: both mask-only levels (tonal, clarity) are
    band-restricted; the band rows are the full-frame blur's, the rest
    zeros that no consumer selects, so the output does not change."""
    h, w = 1024, 1536
    doc = chip_smoke.config4_doc(h, w)
    masks = rt.rasterize_masks(doc, w, h)
    p, c = rt.parse_adjustments(doc)
    sp, c = rt.stack_params([p], [c], device="cpu")
    bands = rt.blur_band_rows(c, masks)
    assert {k for k, _, _ in bands} == {"tonal", "clarity"}
    x = torch.from_numpy(np.random.default_rng(9).random((1, 3, h, w), dtype=np.float32))
    full = tfused.blur_levels(x, c)
    banded = tfused.blur_levels(x, c, bands)
    for key, y0, y1 in bands:
        assert torch.equal(banded[key][:, :, y0:y1], full[key][:, :, y0:y1])
        assert not banded[key][:, :, :y0].any() and not banded[key][:, :, y1:].any()
    mk = torch.from_numpy(masks)[None]
    a = rt.develop_batch(x, sp, c, masks=mk, blur_bands=bands)
    b = rt.develop_batch(x, sp, c, masks=mk)
    assert torch.equal(a, b)
    single = rt.develop(x[0], p, rt.parse_adjustments(doc)[1], masks=masks, blur_bands=bands)
    assert torch.equal(single, a[0])
    assert torch.equal(rt.develop_single(x[0], p, rt.parse_adjustments(doc)[1], masks=masks),
                       a[0])


def test_mask_layout_is_the_generated_header():
    header = tfused.generated_header()
    assert tfused.MASK_SCALARS[: len(tgrade.EFF_FIELDS)] == tgrade.EFF_FIELDS
    for path, _ in tfused.MASK_LAYOUT:
        name = "M_" + path.replace("/", "_").upper()
        assert f"#define {name} {tfused.M_OFFSETS[path]}\n" in header
    assert f"#define M_K {tfused.KM}\n" in header
    assert f"#define M_SCALARS {len(tfused.MASK_SCALARS)}\n" in header
    assert f"#define M_BLEND {len(tgrade.EFF_FIELDS)}\n" in header
    for flag in ("mask_sharpness_active", "mask_hsl_active", "mask_cg_active",
                 "mask_curves_active"):
        assert f"#define F_{flag.upper()} (1u << {tfused.FLAGS.index(flag)})\n" in header
    # the packed rows round-trip every leaf of a stacked mask set
    p, c = rt.parse_adjustments(chip_smoke.mask_stage_doc(32, 48))
    sp, c = rt.stack_params([p, p], [c, c], device="cpu")
    rows = tfused.pack_mask_rows(sp["mask"])
    assert rows.shape == (2, 5, tfused.KM)
    back = tfused.unpack_mask_rows(rows[1])
    for path, _ in tfused.MASK_LAYOUT:
        want, got = sp["mask"], back
        for part in path.split("/"):
            want, got = want[part], got[part]
        assert torch.equal(got, want[1])
    src = (Path(tfused.__file__).parent.parent / "csrc" / "grade.cu").read_text()
    assert "unsigned bits[M_BLEND];" in src
    assert tfused._Blend.bits.size == 4 * len(tgrade.EFF_FIELDS)


def test_blend_bits_follow_the_blend_sets():
    _, c = rt.parse_adjustments(chip_smoke.config4_doc(64, 96))
    bits = tfused.blend_bits(c)
    for f, b in zip(tgrade.EFF_FIELDS, bits):
        assert b == sum(1 << n for n in tgrade.blend_mask_indices(c, f))
    assert bits[tgrade.EFF_FIELDS.index("exposure")] == 0b111
    assert bits[tgrade.EFF_FIELDS.index("hue")] == 0
    with pytest.raises(ValueError, match="ascending"):
        tfused.blend_bits(dataclasses.replace(c, mask_blend_masks=((2, 0, 1),) +
                                              c.mask_blend_masks[1:]))


def test_grade_stages_count_the_mask_stages():
    _, c = rt.parse_adjustments(chip_smoke.mask_stage_doc(64, 96))
    bare = dataclasses.replace(c, mask_count=0, mask_sharpness_active=False,
                               mask_hsl_active=False, mask_cg_active=False,
                               mask_curves_active=False)
    assert tfused.grade_stages(c) == tfused.grade_stages(bare) + 5
    plan = tfused.grade_launch_plan(2, 64, 96, c)
    assert (plan["min_blocks"], plan["rows"], plan["masks"]) == (4, 4, 5)
    assert plan["mask_smem"] == 4 * len(tfused.MASK_SCALARS) * 5


def test_masks_must_match_the_config():
    doc = chip_smoke.config4_doc(32, 48)
    p, c = rt.parse_adjustments(doc)
    sp, c = rt.stack_params([p], [c], device="cpu")
    x = torch.zeros((1, 3, 32, 48))
    with pytest.raises(ValueError, match="influences"):
        rt.develop_batch(x, sp, c)
    with pytest.raises(ValueError, match="influences"):
        rt.develop_batch(x, sp, c, masks=torch.zeros((1, 2, 32, 48)))


def test_masked_nr_still_raises():
    """Until slice A.8 NR that a mask drives raised NotImplementedError; now
    it develops through the per-pixel NR path and matches JAX's develop
    (dither off) within 2e-4."""
    from rapidraw_tpu.pipeline.develop import develop as jdevelop

    h, w = 48, 64
    doc = {"lumaNoiseReduction": 20, "masks": [
        {"visible": True, "adjustments": {"colorNoiseReduction": 40, "lumaNoiseReduction": 30},
         "subMasks": [sub("radial", RADIAL)]}]}
    p, c = rt.parse_adjustments(doc)
    jp, jc = jparse(doc)
    assert c.nr_static_luma is None and c.nr_static_color is None
    c, jc = (dataclasses.replace(k, dither_active=False) for k in (c, jc))
    masks = rt.rasterize_masks(doc, w, h)
    x = np.random.default_rng(22).random((3, h, w), dtype=np.float32)
    got = rt.develop(torch.from_numpy(x), p, c, masks=masks).numpy()
    want = np.asarray(jdevelop(jnp.asarray(x), jp, jc, masks=jnp.asarray(masks)))
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("subsampling", [0, 2])
def test_ai_mask_from_a_jpeg_data_url_matches_jax(subsampling):
    """An AI mask whose image is a JPEG data URL (the port refused these
    until the LDR loader): decoded to PIL's convert("L"), reprojected, grown
    and feathered as JAX does."""
    import base64
    import io

    from PIL import Image

    from rapidraw_tpu.masks import parametric as jparam
    from rapidraw_tpu_torch.masks import parametric

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:90, 0:120]
    rgb = np.stack([(xx * 2) % 256, (yy * 3) % 256, (xx + yy) % 256], -1)
    rgb = np.clip(rgb + rng.normal(0, 9, rgb.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=80, subsampling=subsampling)
    params = {"maskDataBase64": "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode(),
              "grow": 3.0, "feather": 0.4, "rotation": 4.0}
    got = parametric.generate_ai_mask(params, 60, 45, 0.5, (0.0, 0.0))
    want = jparam.generate_ai_mask(params, 60, 45, 0.5, (0.0, 0.0))
    assert got is not None and np.array_equal(got, want)
