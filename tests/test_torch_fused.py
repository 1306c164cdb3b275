"""The plain grade chain (plain version of csrc/grade.cu) against JAX's
grade megakernel: `develop_fused` (B3) and `develop_fused_batch` (B4) in
Pallas interpret mode, as the JAX package's own tests run them.

Bound with dither off: 2e-4, the JAX fused-vs-XLA bound of
tests/test_fused.py. Grain and dither are compared on their own: both hash
fract() of large products, where a last-ulp difference moves a whole noise
value. Grain: 2e-4 against JAX's develop run op by op (each op rounds on
its own, as in the port); against the interpret-mode megakernel, which
itself differs from that path on ~0.15% of grain values (so does a jitted
develop), 2e-4 on all but 0.5% of the values and 2 x the grain amplitude
on those. Dither: 2e-4 + 1/255 on at most 0.1% of the values, 2e-4 on the rest.
The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline.batch import stack_params as jstack
from rapidraw_tpu.pipeline.develop import develop as jdevelop
from rapidraw_tpu.pipeline.fused import develop_fused as jfused
from rapidraw_tpu.pipeline.fused import develop_fused_batch as jfused_batch
from rapidraw_tpu_torch import parse_adjustments as tparse
from rapidraw_tpu_torch import stack_params as tstack
from rapidraw_tpu_torch.pipeline import fused as tfused

torch.set_num_threads(2)

TOL = 2e-4
DITHER_TOL = 2e-4 + 1.0 / 255.0


def images(b, h, w, seed, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 3, h, w)) * hi).astype(np.float32)


def nodither(cfg):
    return dataclasses.replace(cfg, dither_active=False)


@pytest.mark.parametrize("name,h,w", [("full", 256, 640), ("config1", 256, 512)])
def test_plain_grade_matches_pallas_b3(name, h, w):
    doc, is_raw = chip_smoke.DOCS[name]
    x = images(1, h, w, seed=3)[0]
    tp, tc = tparse(doc, is_raw=is_raw)
    jp, jc = jparse(doc, is_raw=is_raw)
    got = tfused.develop_fused(torch.from_numpy(x), tp, nodither(tc)).numpy()
    want = np.asarray(jfused(jnp.asarray(x), jp, nodither(jc)))
    assert got.shape == want.shape == (3, h, w)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("name", ["config3", "raw"])
def test_plain_grade_matches_pallas_b4(name):
    doc, is_raw = chip_smoke.DOCS[name]
    docs = [doc, dict(doc, exposure=-0.2, contrast=-12)]
    x = images(2, 256, 512, seed=4, hi=1.6 if is_raw else 1.0)
    tparsed = [tparse(d, is_raw=is_raw) for d in docs]
    jparsed = [jparse(d, is_raw=is_raw) for d in docs]
    tp, tc = tstack([p for p, _ in tparsed], [c for _, c in tparsed], device="cpu")
    jp, jc = jstack([p for p, _ in jparsed], [c for _, c in jparsed])
    got = tfused.develop_fused_batch(torch.from_numpy(x), tp, nodither(tc)).numpy()
    want = np.asarray(jfused_batch(jnp.asarray(x), jp, nodither(jc)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL)


def test_grain_matches_jax():
    doc = {k: chip_smoke.GRAIN_DOC[k] for k in ("grainAmount", "grainSize", "grainRoughness")}
    x = images(1, 256, 512, seed=3)[0]
    tp, tc = tparse(doc)
    jp, jc = jparse(doc)
    tc, jc = nodither(tc), nodither(jc)
    assert tc.grain_active
    got = tfused.develop_fused(torch.from_numpy(x), tp, tc).numpy()
    eager = np.asarray(jdevelop(jnp.asarray(x), jp, jc))
    np.testing.assert_allclose(got, eager, atol=TOL)
    pallas = np.asarray(jfused(jnp.asarray(x), jp, jc))
    d = np.abs(got - pallas)
    amplitude = 0.5 * float(tp["glob"]["grain_amount"])
    assert (d > TOL).mean() <= 5e-3
    assert d.max() <= 2.0 * amplitude


def test_dither_matches_jax():
    doc = chip_smoke.CONFIG1_DOC
    x = images(1, 96, 160, seed=5)[0]
    tp, tc = tparse(doc)
    jp, jc = jparse(doc)
    assert tc.dither_active
    got = tfused.develop_fused(torch.from_numpy(x), tp, tc).numpy()
    want = np.asarray(jdevelop(jnp.asarray(x), jp, jc))
    d = np.abs(got - want)
    assert d.max() <= DITHER_TOL
    assert (d > TOL).mean() <= 1e-3


def test_plain_grade_takes_the_kernel_inputs():
    """grade() on CPU tensors is grade_plain, fed exactly what the kernel
    gets: input-space image and levels plus the packed (B, K) matrix."""
    doc, _ = chip_smoke.DOCS["full"]
    x = torch.from_numpy(images(2, 40, 64, seed=6))
    p, c = tparse(doc)
    sp, c = tstack([p, p], [c, c], device="cpu")
    pmat = tfused.pack_rows(sp["glob"])
    levels = tfused.blur_levels(x, c)
    assert sorted(levels) == ["clarity", "sharp", "structure", "tonal"]
    before = tfused.grade.launches
    a = tfused.grade(x, levels, pmat, c)
    b = tfused.grade_plain(x, levels, pmat, c)
    assert torch.equal(a, b)
    assert tfused.grade.launches == before
    with pytest.raises(ValueError):
        tfused.grade(x, {k: v for k, v in levels.items() if k != "tonal"}, pmat, c)


# Each case: the batch's documents and, for a batch the port refuses, the
# error and the text it names. Until slice A.8 the port refused all five;
# since then NR that a mask drives, the LUT, mixed NR amounts and flare
# develop and match JAX (32 x 48, dither off; the LUT case with a seeded
# 9^3 cube, the flare case with JAX handed the port's map, which
# test_torch_flare.py holds to JAX's). A batch of mixed CA amounts stays
# refused, as in JAX (one compile cannot hold two).
UNSUPPORTED = {
    "masks (slice A.6)": (
        [{"masks": [{"visible": True, "adjustments": {"lumaNoiseReduction": 30}}]}], None, None),
    "LUT (slice A.8)": ([{"lutPath": "x.cube", "lutIntensity": 75}], None, None),
    "chromatic aberration (slice A.8)": (
        [{"chromaticAberrationRedCyan": 10}, {"chromaticAberrationRedCyan": 20}],
        ValueError, "chromatic-aberration"),
    "noise reduction (slice A.8)": (
        [{"lumaNoiseReduction": 20}, {"lumaNoiseReduction": 40, "colorNoiseReduction": 30}],
        None, None),
    "flare (slice A.8)": ([{"flareAmount": 20}], None, None),
}


@pytest.mark.parametrize("what", sorted(UNSUPPORTED))
def test_documents_outside_the_slice_raise(what):
    from rapidraw_tpu.pipeline.batch import develop_batch as jdevelop_batch
    from rapidraw_tpu_torch import develop_batch, rasterize_masks
    from rapidraw_tpu_torch.ops.flare import FLARE_PARAMS, flare_maps

    docs, exc, match = UNSUPPORTED[what]
    tparsed = [tparse(d) for d in docs]
    jparsed = [jparse(d) for d in docs]
    if exc is not None:
        with pytest.raises(exc, match=match):
            tstack([p for p, _ in tparsed], [c for _, c in tparsed], device="cpu")
        with pytest.raises(exc, match=match):
            jstack([p for p, _ in jparsed], [c for _, c in jparsed])
        return
    h, w = 32, 48
    x = images(len(docs), h, w, seed=9)
    tp, tc = tstack([p for p, _ in tparsed], [c for _, c in tparsed], device="cpu")
    jp, jc = jstack([p for p, _ in jparsed], [c for _, c in jparsed])
    tc, jc = nodither(tc), nodither(jc)
    masks = None
    if tc.mask_count:
        masks = np.stack([rasterize_masks(d, w, h) for d in docs])
    kw = {}
    if tc.has_lut:
        rng = np.random.default_rng(10)
        kw["lut"] = (np.stack(np.meshgrid(*[np.linspace(0, 1, 9)] * 3, indexing="ij"), -1)
                     + 0.1 * rng.standard_normal((9, 9, 9, 3))).astype(np.float32)
    jkw = dict(kw)
    if tc.flare_active:
        fparams = tfused.pack_rows(tp["glob"])[:, [tfused.OFFSETS[k] for k in FLARE_PARAMS]]
        jkw["flare"] = flare_maps(torch.from_numpy(x), fparams.contiguous(), False)[0].numpy()
    got = develop_batch(torch.from_numpy(x), tp, tc,
                        masks=None if masks is None else torch.from_numpy(masks),
                        **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    want = np.asarray(jdevelop_batch(jnp.asarray(x), jp, jc,
                                     masks=None if masks is None else jnp.asarray(masks),
                                     **{k: jnp.asarray(v) for k, v in jkw.items()}))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL)
