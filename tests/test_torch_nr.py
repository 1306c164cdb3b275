"""The port's CA and NR (plain versions of csrc/nr.cu) against JAX.

JAX's B5 (`_apply_nr_static_pallas`) runs in Pallas interpret mode on the
CPU, as the JAX package's own tests run it, on the adversarial image of
tests/test_nr_bf16.py (noise + gradients + a hard edge: the worst case for
the gates). Bounds: max |d| <= 2e-4 and p99.9 <= 1e-5 — the plain version
follows the kernel body's operations at float32, but a last-ulp difference
can flip a knife-edge gate (`w > 1e-4`, `w_b > 0.01`, the edge side) at
single pixels. CA gathers at float64 host indices, so it is held bit-exact.
NR with per-pixel amounts (`nr_dynamic`) is held to JAX's gather path run
op by op, at the same bounds.
The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import jax
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
    """Until slice A.8 per-pixel amounts raised NotImplementedError; now
    `apply_noise_reduction` routes them to the per-pixel path as JAX does
    (nr.py:73-108), and only a call without the amounts raises."""
    x = torch.from_numpy(adversarial(40, 64, seed=3))
    center = tcs.srgb_to_linear(x)
    with jax.disable_jit():
        want = np.asarray(jnr.apply_noise_reduction(
            jnp.asarray(center.numpy()), jnp.asarray(x.numpy()), 0.5, 0.2, SCALE, False,
            static_luma=None, static_color=0.2))
    got = tnr.apply_noise_reduction(center, x, SCALE, False, None, 0.2, 0.5, 0.2).numpy()
    assert np.abs(got - want).max() <= 2e-4
    with pytest.raises(ValueError, match="luma_amount and color_amount"):
        tnr.apply_noise_reduction(center, x, SCALE, False, None, 0.2)


def _amount_maps(h, w, seed):
    """Luma and colour amount maps as a mask blend makes them: a global
    amount plus a soft radial influence times the mask's, one outside [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    infl = np.clip(1.2 - np.hypot((xx - 0.6 * w) / (0.3 * w), (yy - 0.4 * h) / (0.3 * h)),
                   0.0, 1.0).astype(np.float32)
    rng = np.random.default_rng(seed)
    la = (np.float32(0.3) + infl * np.float32(0.6)).astype(np.float32)
    ca = (np.float32(0.25) + infl * np.float32(0.9) - np.float32(0.1)
          + 0.01 * rng.standard_normal((h, w)).astype(np.float32)).astype(np.float32)
    return la, ca


@pytest.mark.parametrize("case", ["maps", "scalars", "raw maps", "luma off"])
def test_nr_dynamic_matches_jax(case):
    """JAX's per-pixel gather path (nr.py:108-254) run op by op (the jitted
    graph contracts FMAs and moves jittered taps) against `nr_dynamic` on
    the CPU at 1024 x 1536: amount maps (a mask's blend), per-image scalars
    (a batch of mixed amounts), a RAW image, and luma off in part of the
    map. Bounds as for the static grid: max |d| <= 2e-4, p99.9 <= 1e-5."""
    h, w = 1024, 1536
    is_raw = case == "raw maps"
    x = adversarial(h, w, seed=11) * (1.5 if is_raw else 1.0)
    xt = torch.from_numpy(x)
    center = xt if is_raw else tcs.srgb_to_linear(xt)
    la, ca = _amount_maps(h, w, 12)
    if case == "scalars":
        la, ca = np.float32(0.6), np.float32(0.45)
    if case == "luma off":
        la = np.where(la > 0.5, la, 0.0).astype(np.float32)
    scale = h / 1080.0
    with jax.disable_jit():
        want = np.asarray(jnr.apply_noise_reduction(
            jnp.asarray(center.numpy()), jnp.asarray(x), jnp.asarray(la), jnp.asarray(ca),
            scale, is_raw))
    before = tnr.nr_dynamic.launches
    got = tnr.nr_dynamic(center, tnr.nr_planes(xt, is_raw), torch.as_tensor(la),
                         torch.as_tensor(ca), scale).numpy()
    assert tnr.nr_dynamic.launches == before
    d = np.abs(got - want)
    print(f"{case}: max|d| {d.max():.3e}, p99.9 {np.quantile(d, 0.999):.3e}")
    assert got.shape == want.shape == x.shape
    assert d.max() <= 2e-4
    assert np.quantile(d, 0.999) <= 1e-5


def test_nr_dynamic_batch_is_each_image_on_its_own():
    """(B,) amounts act per image and (B, H, W) maps per pixel: a batch
    gives each image's own result, and a map of one value equals that
    scalar."""
    x = torch.from_numpy(adversarial(40, 64, seed=5))
    xs = torch.stack([x, x.flip(-1)])
    planes = tnr.nr_planes(xs, False)
    center = tcs.srgb_to_linear(xs)
    la, ca = torch.tensor([0.3, 0.7]), torch.tensor([0.25, 0.5])
    out = tnr.nr_dynamic(center, planes, la, ca, SCALE)
    for i in range(2):
        one = tnr.nr_dynamic(center[i], planes[i], la[i], ca[i], SCALE)
        assert torch.equal(out[i], one)
    maps = tnr.nr_dynamic(center, planes, la[:, None, None].expand(2, 40, 64),
                          ca[:, None, None].expand(2, 40, 64), SCALE)
    assert torch.equal(maps, out)
    with pytest.raises(ValueError, match="NR amount shape"):
        tnr.nr_dynamic(center, planes, torch.zeros(3), ca, SCALE)


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
