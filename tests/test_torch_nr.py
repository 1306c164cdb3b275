"""The port's CA and static-grid NR (plain version of csrc/nr.cu) against JAX.

JAX's B5 (`_apply_nr_static_pallas`) runs in Pallas interpret mode on the
CPU, as the JAX package's own tests run it, on the adversarial image of
tests/test_nr_bf16.py (noise + gradients + a hard edge: the worst case for
the gates). Bounds: max |d| <= 2e-4 and p99.9 <= 1e-5 — the plain version
follows the kernel body's operations at float32, but a last-ulp difference
can flip a knife-edge gate (`w > 1e-4`, `w_b > 0.01`, the edge side) at
single pixels. CA gathers at float64 host indices, so it is held bit-exact.
The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from rapidraw_tpu.ops import nr as jnr
from rapidraw_tpu.ops.ca import apply_ca_correction as jca
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline.develop import prepare_inputs as jprepare
from rapidraw_tpu_torch import parse_adjustments as tparse
from rapidraw_tpu_torch.ops import colorspace as tcs
from rapidraw_tpu_torch.ops import nr as tnr
from rapidraw_tpu_torch.ops.ca import apply_ca_correction as tca
from rapidraw_tpu_torch.pipeline.fused import prepare_inputs as tprepare

torch.set_num_threads(2)

SCALE = 4096.0 / 1080.0


def adversarial(h=96, w=160, seed=0):
    """Noise + smooth gradients + a hard edge (tests/test_nr_bf16.py:35)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.zeros((3, h, w), np.float32)
    for c in range(3):
        base[c] = 0.4 + 0.2 * np.sin(xx / 17 + c) + 0.05 * rng.standard_normal((h, w))
    base[:, :, w // 2 :] += 0.5
    return base.clip(0, 1).astype(np.float32)


@pytest.mark.parametrize("is_raw", [True, False])
@pytest.mark.parametrize("amounts", [(0.3, 0.25), (0.8, 0.6)])
def test_nr_plain_matches_pallas_b5(amounts, is_raw):
    la, ca = amounts
    x = adversarial()
    xt = torch.from_numpy(x)
    center = xt if is_raw else tcs.srgb_to_linear(xt)
    want = np.asarray(jnr._apply_nr_static_pallas(
        jnp.asarray(center.numpy()), jnp.asarray(x), la, ca, SCALE, is_raw))
    got = tnr.nr_static_plain(center, tnr.nr_planes(xt, is_raw), la, ca, SCALE).numpy()
    d = np.abs(got - want)
    assert got.shape == want.shape == x.shape
    assert d.max() <= 2e-4, d.max()
    assert np.quantile(d, 0.999) <= 1e-5


@pytest.mark.parametrize("amounts,scale", [((0.3, 0.25), SCALE), ((0.8, 0.6), SCALE),
                                            ((1.0, 1.0), 8.0), ((0.0, 0.5), 0.3)])
def test_tap_tables_match_jax(amounts, scale):
    assert tnr.nr_static_meta(*amounts, scale) == jnr._nr_static_meta(*amounts, scale)


def test_largest_offset_stays_inside_the_halo():
    k = tnr._consts(1.0, 1.0, 1e6)  # res_factor clamps at 2: chroma stride 7
    assert k["max_off"] == 14 <= tnr.NR_HALO


def test_nr_wrapper_on_cpu_is_the_plain_version():
    x = torch.from_numpy(adversarial(40, 64, seed=2))
    planes = tnr.nr_planes(x, False)
    before = tnr.nr_static.launches
    a = tnr.nr_static(x, planes, 0.3, 0.25, SCALE)
    assert torch.equal(a, tnr.nr_static_plain(x, planes, 0.3, 0.25, SCALE))
    assert tnr.nr_static.launches == before
    # a batch is each image on its own
    b = tnr.nr_static(torch.stack([x, x.flip(-1)]), torch.stack([planes, planes.flip(-1)]),
                      0.3, 0.25, SCALE)
    assert torch.equal(b[0], a)
    with pytest.raises(ValueError):
        tnr.nr_static(x[:2], planes[:2], 0.3, 0.25, SCALE)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tnr.nr_static(x.to("meta"), planes.to("meta"), 0.3, 0.25, SCALE)


def test_per_pixel_nr_amounts_raise():
    x = torch.zeros((3, 8, 8))
    with pytest.raises(NotImplementedError, match="slice A.8"):
        tnr.apply_noise_reduction(x, x, 1.0, False, None, 0.2)


@pytest.mark.parametrize("amounts", [(0.0012, -0.0008), (0.02, -0.015), (0.0, 0.01)])
def test_ca_static_matches_jax_bit_exact(amounts):
    rc, by = amounts
    x = adversarial(72, 120, seed=4)
    xt = torch.from_numpy(x)
    want = np.asarray(jca(jnp.asarray(x), rc, by, static_rc=rc, static_by=by))
    assert np.array_equal(tca(xt, rc, by).numpy(), want)
    # a batch resamples each image the same way
    batch = tca(torch.stack([xt, xt.flip(-1)]), rc, by).numpy()
    assert np.array_equal(batch[0], want)
    want_flip = np.asarray(jca(jnp.asarray(x[..., ::-1].copy()), rc, by, static_rc=rc,
                               static_by=by))
    assert np.array_equal(batch[1], want_flip)


@pytest.mark.parametrize("doc_name", ["config5", "strong"])
def test_prepare_inputs_ca_nr_matches_jax(doc_name):
    doc = dict(chip_smoke.CONFIG5_DOC)
    if doc_name == "strong":
        doc.update(lumaNoiseReduction=80, colorNoiseReduction=60, chromaticAberrationRedCyan=40)
    x = adversarial(96, 160, seed=6)
    jp, jc = jparse(doc)
    tp, tc = tparse(doc)
    assert tc.ca_active and tc.nr_active
    want = np.asarray(jprepare(jnp.asarray(x), jp, jc, None, None, linearize_blurs=False)[0])
    got, linear = tprepare(torch.from_numpy(x)[None], tc)
    assert linear
    d = np.abs(got[0].numpy() - want)
    assert d.max() <= 2e-4, d.max()
