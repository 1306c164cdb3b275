"""The port's geometry (exact warp, two-pass planner, the plain version of
csrc/resample.cu's warp and its one-pass resample, transforms) against the
JAX package.

JAX's B6 (`_resample_rows`) runs in Pallas interpret mode on the CPU.
Bounds, each with its reason:
  * resample on JAX's own plan (carried across with `plan_from_arrays`):
    <= 1e-6, the same lerp of the same two rows;
  * the planner: identical PassStatic fields and bases; e-maps <= 1e-3 px
    against JAX's XLA-compiled planner (XLA rounds the Newton inversion
    up to ~2e-4 px differently) and bit-identical against the same planner
    run op by op (`jax.disable_jit`), whose float32 formulas the port
    follows;
  * `warp_with_plan` on 64x1024 noise: <= 1e-3 (the e-map difference times
    the noise's slope);
  * the exact path and `apply_all_transformations` on the CPU: <= 1e-5
    (bit-identical on these inputs: the port takes float32 sqrt correctly
    rounded, as NumPy and XLA do).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from rapidraw_tpu.geometry import transforms as jtr
from rapidraw_tpu.geometry import warp as jw
from rapidraw_tpu.geometry import warp_fast as jwf
from rapidraw_tpu.geometry.params import geometry_params_from_json as jgeom
from rapidraw_tpu_torch.geometry import transforms as ttr
from rapidraw_tpu_torch.geometry import warp as tw
from rapidraw_tpu_torch.geometry import warp_fast as twf
from rapidraw_tpu_torch.geometry.params import geometry_params_from_json as tgeom

torch.set_num_threads(2)

H, W = 64, 1024
GEOMS = {"config5": chip_smoke.CONFIG5_GEOMETRY, "tca_rotate": chip_smoke.TCA_GEOMETRY}


def noise(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def jax_plans():
    return {k: jwf.plan_warp(jgeom(g), H, W) for k, g in GEOMS.items()}


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_plan_matches_jax(name, jax_plans):
    jp = jax_plans[name]
    tp = twf.plan_warp(tgeom(GEOMS[name]), H, W, device="cpu")
    assert jp is not None and tp is not None
    js, ts = jp.static, tp.static
    assert (js.h, js.w, js.hp, js.wp, js.has_post) == (ts.h, ts.w, ts.hp, ts.wp, ts.has_post)
    assert len(js.modes) == len(ts.modes) == (3 if name == "tca_rotate" else 1)
    for (jc, jv, jh), (tc, tv, th) in zip(js.modes, ts.modes):
        assert tuple(jc) == tc
        assert dataclasses.asdict(jv) == dataclasses.asdict(tv)
        assert dataclasses.asdict(jh) == dataclasses.asdict(th)
    assert set(tp.arrays) == {k for k in jp.arrays if not k.startswith(("gv", "gh"))}
    for k, v in tp.arrays.items():
        want = np.asarray(jp.arrays[k])
        if k.startswith(("bv", "bh")):
            assert np.array_equal(v.numpy(), want), k
        else:
            np.testing.assert_allclose(v.numpy(), want, atol=1e-3 if k != "post" else 1e-5,
                                       err_msg=k)


def test_plan_is_bit_identical_to_the_op_by_op_jax_planner():
    with jax.disable_jit():
        jp = jwf.plan_warp(jgeom(chip_smoke.CONFIG5_GEOMETRY), H, W)
    tp = twf.plan_warp(tgeom(chip_smoke.CONFIG5_GEOMETRY), H, W, device="cpu")
    for k in ("ev0", "eh0", "bv0", "bh0"):
        assert np.array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k])), k


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_resample_plain_on_jax_plan_matches_pallas_b6(name, jax_plans):
    jp = jax_plans[name]
    plan = twf.plan_from_arrays(dataclasses.asdict(jp.static),
                                {k: np.asarray(v) for k, v in jp.arrays.items()}, "cpu")
    st = jp.static
    x = np.pad(noise((2, 3, H, W), seed=1), ((0, 0), (0, 0), (0, st.hp - H), (0, st.wp - W)))
    # the vertical pass on the image, the horizontal one on a transposed image
    for key, bkey, img, stat, tstat in (
        ("ev0", "bv0", x[:, 0], st.modes[0][1], plan.static.modes[0][1]),
        ("eh0", "bh0", np.ascontiguousarray(x[:, 1].transpose(0, 2, 1)),
         st.modes[0][2], plan.static.modes[0][2]),
    ):
        gkey = "g" + key[1:]
        want = np.asarray(jwf._resample_rows(jnp.asarray(img), jp.arrays[key], jp.arrays[bkey],
                                             jp.arrays[gkey], stat))
        got = twf.resample_rows_plain(torch.from_numpy(img), plan.arrays[key],
                                      plan.arrays[bkey], tstat).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=key)
    # the warp kernel's wrapper on a CPU tensor is the plain version (both
    # passes on JAX's plan) and launches nothing
    image = torch.from_numpy(x[:, :, :H, :W].copy())
    before = twf.warp_with_plan.launches
    assert torch.equal(twf.warp_with_plan(image, plan.arrays, plan.static),
                       twf.warp_with_plan_plain(image, plan.arrays, plan.static))
    assert twf.warp_with_plan.launches == before


def test_resample_sentinel_and_out_of_range_rows_read_zero():
    st = twf.PassStatic(span=16, band=56, pad_lo=8, extent=64, nty=1, ntx=1)
    img = torch.ones((1, 32, 256))
    e = torch.full((32, 256), 3.25)
    e[0, 0] = twf.SENTINEL
    bases = torch.tensor([0, 4], dtype=torch.int32)  # rows -8.. and 24.. of the source
    out = twf.resample_rows_plain(img, e, bases, st)
    assert out[0, 0, 0] == 0.0
    # half 0: row r lerps source rows r - 8 + 3 and the next; below 0 is zero
    assert out[0, 3, 5] == 0.0 and out[0, 4, 5] == 0.25 and out[0, 5, 5] == 1.0
    # half 1: row r lerps source rows 24 + r + 3 and the next; past 31 is zero
    assert out[0, 3, 200] == 1.0 and out[0, 4, 200] == 0.75 and out[0, 5, 200] == 0.0
    # the warp kernel's wrapper takes CPU and CUDA tensors only
    ws = twf.WarpStatic(p=None, h=32, w=256, hp=256, wp=256, modes=(((0, 1, 2), st, st),))
    arrays = {"ev0": e, "bv0": bases, "eh0": e, "bh0": bases}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        twf.warp_with_plan(torch.ones((3, 32, 256), device="meta"),
                           {k: v.to("meta") for k, v in arrays.items()}, ws)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_warp_with_plan_matches_jax(name, jax_plans):
    jp = jax_plans[name]
    tp = twf.plan_warp(tgeom(GEOMS[name]), H, W, device="cpu")
    x = noise((2, 3, H, W), seed=2)
    want = np.asarray(jwf.warp_with_plan(jnp.asarray(x), jp.arrays, jp.static))
    got = twf.warp_with_plan(torch.from_numpy(x), tp.arrays, tp.static)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    one = twf.warp_with_plan(torch.from_numpy(x[1]), tp.arrays, tp.static)
    assert torch.equal(one, got[1])


EXACT = {
    "config5": chip_smoke.CONFIG5_GEOMETRY,
    "tca_rotate": chip_smoke.TCA_GEOMETRY,
    "perspective": {"transformVertical": 40.0, "transformHorizontal": -25.0,
                    "transformScale": 90.0, "transformAspect": -10.0},
    "ptlens_manual": {"transformDistortion": 20.0, "transformXOffset": 3.0,
                      "lensDistortionParams": {"k1": 0.01, "k2": -0.03, "k3": 0.01,
                                               "model": 1, "vig_k1": -0.2, "vig_k2": 0.05}},
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_warp_image_geometry_matches_jax(name):
    x = noise((3, 96, 160), seed=3)
    want = np.asarray(jw.warp_image_geometry(jnp.asarray(x), jgeom(EXACT[name])))
    got = tw.warp_image_geometry(torch.from_numpy(x), tgeom(EXACT[name])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_planner_refuses_a_folded_map():
    # strong perspective folds the map: both planners send it to the exact path
    g = {"transformVertical": 100000.0}
    assert jwf.plan_warp(jgeom(g), 64, 256) is None
    assert twf.plan_warp(tgeom(g), 64, 256, device="cpu") is None


TRANSFORM_DOCS = {
    "warp_steps_flip_rotate_crop": dict(
        chip_smoke.CONFIG5_GEOMETRY, orientationSteps=1, flipHorizontal=True, rotation=3.0,
        crop={"x": 10, "y": 4, "width": 60, "height": 120}),
    "flip_vertical_rotation": {"flipVertical": True, "rotation": -7.5, "orientationSteps": 2},
    "identity_crop": {"crop": {"x": 0, "y": 0, "width": 160, "height": 96}},
}


@pytest.mark.parametrize("name", sorted(TRANSFORM_DOCS))
def test_apply_all_transformations_on_cpu_matches_jax(name):
    x = noise((3, 96, 160), seed=4)
    want, woff = jtr.apply_all_transformations(jnp.asarray(x), TRANSFORM_DOCS[name])
    got, goff = ttr.apply_all_transformations(torch.from_numpy(x), TRANSFORM_DOCS[name])
    assert goff == woff
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ai_patches_raise():
    """A document with aiPatches no longer raises (the port composites
    them since slice A.11a, tests/test_torch_patches.py): a patch without
    image data leaves the image as JAX leaves it."""
    x = noise((3, 8, 8), seed=5)
    doc = {"aiPatches": [{"id": 1}]}
    want, woff = jtr.apply_all_transformations(jnp.asarray(x), doc)
    got, goff = ttr.apply_all_transformations(torch.from_numpy(x), doc)
    assert goff == woff and np.array_equal(got.numpy(), np.asarray(want))
