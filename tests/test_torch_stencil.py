"""The stencil export slice (BASELINE config 5) against the JAX package.

As `bench.py:_bench_stencil_export` runs it: the config-5 document and
geometry, B = 2, planned two-pass warp (`plan_warp` + `warp_with_plan`),
then `develop_batch` — CA, linearize, static-grid NR, the sharpness blur
level and the grade — then the device u8 quantizer. JAX's Pallas kernels
(the resample B6 and NR B5) run in interpret mode on the CPU; the port runs
the plain versions of its kernels. JAX's planner runs op by op
(`jax.disable_jit`): its float32 formulas are then the ones the port
follows, and the two plans agree bit for bit. Compiled by XLA, the same
planner rounds the e-maps up to ~2e-4 px differently (tests/test_torch_warp.py
holds that to 1e-3), which the NR gates can amplify past 1e-3 at single
pixels.

Float output with dither off: max |d| <= 1e-3 (ROADMAP's parity bar). u8
with dither on: at most 1 LSB, on at most 0.1% of the values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidraw_tpu.geometry.params import geometry_params_from_json as jgeom
from rapidraw_tpu.geometry.warp_fast import plan_warp as jplan_warp
from rapidraw_tpu.geometry.warp_fast import warp_with_plan as jwarp_with_plan
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline.batch import develop_batch as jdevelop_batch
from rapidraw_tpu.pipeline.batch import stack_params as jstack
from rapidraw_tpu.pipeline.export import _device_u8
import chip_smoke
import rapidraw_tpu_torch as rt
from rapidraw_tpu_torch.geometry.params import geometry_params_from_json as tgeom
from rapidraw_tpu_torch.geometry.warp_fast import plan_warp as tplan_warp
from rapidraw_tpu_torch.geometry.warp_fast import warp_with_plan as twarp_with_plan

torch.set_num_threads(2)

H, W = 64, 1024


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    return rng.random((2, 3, H, W), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_warped(images):
    with jax.disable_jit():
        plan = jplan_warp(jgeom(chip_smoke.CONFIG5_GEOMETRY), H, W)
    assert plan is not None
    return np.asarray(jwarp_with_plan(jnp.asarray(images), plan.arrays, plan.static))


def jax_develop(warped, dither: bool):
    parsed = [jparse(chip_smoke.CONFIG5_DOC) for _ in range(warped.shape[0])]
    p, c = jstack([q for q, _ in parsed], [k for _, k in parsed])
    assert c.ca_active and c.nr_active and c.sharpness_blur_needed
    c = dataclasses.replace(c, dither_active=dither)
    out = jax.jit(lambda im, q: jdevelop_batch(im, q, c))(jnp.asarray(warped), p)
    return np.asarray(out), np.asarray(_device_u8(out))


def port_run(images, dither: bool):
    plan = tplan_warp(tgeom(chip_smoke.CONFIG5_GEOMETRY), H, W, device="cpu")
    assert plan is not None
    warped = twarp_with_plan(torch.from_numpy(images), plan.arrays, plan.static)
    parsed = [rt.parse_adjustments(chip_smoke.CONFIG5_DOC) for _ in range(images.shape[0])]
    p, c = rt.stack_params([q for q, _ in parsed], [k for _, k in parsed], device="cpu")
    c = dataclasses.replace(c, dither_active=dither)
    out = rt.develop_batch(warped, p, c)
    return warped.numpy(), out.numpy(), rt.device_u8(out).numpy()


def test_stencil_export_float_matches_jax(images, jax_warped):
    warped, got, _ = port_run(images, dither=False)
    np.testing.assert_allclose(warped, jax_warped, atol=1e-3)
    want, _ = jax_develop(jax_warped, dither=False)
    assert got.shape == want.shape == images.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_stencil_export_u8_matches_jax(images, jax_warped):
    _, _, got = port_run(images, dither=True)
    _, want = jax_develop(jax_warped, dither=True)
    assert got.dtype == np.uint8 and got.shape == images.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3


def test_stencil_batch_size_changes_nothing_per_image(images):
    x = torch.from_numpy(images)
    p, c = rt.parse_adjustments(chip_smoke.CONFIG5_DOC)
    two, c2 = rt.stack_params([p, p], [c, c], device="cpu")
    one, c1 = rt.stack_params([p], [c], device="cpu")
    both = rt.develop_batch(x, two, c2)
    assert torch.equal(both[1], rt.develop_batch(x[1:], one, c1)[0])
    assert torch.equal(both[0], rt.develop(x[0], p, c))
