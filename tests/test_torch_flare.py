"""The port's lens flare (ops/flare.py, the flare stage of the grade)
against the JAX package, on the CPU, on images made from a seed.

- `flare_threshold_map` (LDR and RAW, with exposure, brightness and whites
  set and unset) against JAX's: 1e-5 x max(1, |ref|).
- `generate_flare_map` on a 96 x 128 image (the map is always 512^2)
  against JAX's run op by op with its bilinear sampler `_bilinear_uv`
  jitted: 1e-5 x max(1, |ref|). JAX's map is made once for the module
  (~46 s wholly op by op, ~13 s with the sampler's ~1,300 calls jitted,
  within 4e-7 x max(1, |ref|) of each other; the jitted graph of the whole
  generator compiles for minutes), the port's once through the
  `flare_maps` wrapper.
- `sample_flare` against JAX develop's `_bilinear_sample` x 1.4, squared:
  bit for bit (bound 1e-6), on two image sizes.
- `grade_chain` with flare (global amount, a flare mask over it, and a
  mask alone) against JAX's `grade_chain`: 2e-4, the grade's bound.
The flare kernel (csrc/flare.cu) and the grade kernel's flare input are
held against these plain versions on the card by chip_smoke.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidraw_tpu.ops import flare as jflare
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline import grade as jgrade
from rapidraw_tpu.pipeline.develop import _bilinear_sample as jbilinear
import rapidraw_tpu_torch as rt
from rapidraw_tpu_torch.ops import flare as tflare
from rapidraw_tpu_torch.pipeline import grade as tgrade

torch.set_num_threads(2)

H, W = 96, 128
TOL = 1e-5
GRADE_TOL = 2e-4
# amount, exposure, brightness, whites (ops/flare.py FLARE_PARAMS)
PARAMS = (0.6, 0.4, 0.3, 0.2)


def bright_image(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A dim seeded field with three bright spots, one at an edge."""
    rng = np.random.default_rng(seed)
    x = (rng.random((3, h, w)) * 0.5).astype(np.float32)
    for cy, cx, r in ((h // 3, w // 4, 6), (2 * h // 3, 3 * w // 5, 4), (h // 2, w - 3, 5)):
        yy, xx = np.ogrid[:h, :w]
        spot = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        x[:, spot] = np.float32(1.0)
    return x


def rel_err(got, want) -> float:
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.fixture(scope="module")
def maps():
    x = bright_image(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflare, "_bilinear_uv", jax.jit(jflare._bilinear_uv))
        want = np.array(jflare.generate_flare_map(jnp.asarray(x), *PARAMS, False))
    before = tflare.flare_maps.launches
    got = tflare.flare_maps(torch.from_numpy(x)[None], torch.tensor([PARAMS]), False)
    assert tflare.flare_maps.launches == before  # a CPU tensor runs the plain version
    return x, want, got[0].numpy()


def test_flare_map_matches_jax(maps):
    _, want, got = maps
    assert got.shape == want.shape == (512, 512, 3)
    err = rel_err(got, want)
    print(f"flare map: max|d|/max(1,|ref|) {err:.3e}, max |ref| {np.abs(want).max():.3f}")
    assert np.abs(want).max() > 0.05  # the spots light up the map
    assert err <= TOL


@pytest.mark.parametrize("is_raw,params", [
    (False, PARAMS), (False, (0.3, 0.0, 0.0, 0.0)), (True, (1.0, -0.5, -0.6, -0.4)),
    (True, (0.0, 0.0, 0.0, 0.7))])
def test_threshold_map_matches_jax(is_raw, params):
    x = bright_image(1) * (1.8 if is_raw else 1.0)
    with jax.disable_jit():
        want = np.asarray(jflare.flare_threshold_map(jnp.asarray(x), *params, is_raw))
    got = tflare.flare_threshold_map(torch.from_numpy(x), *map(torch.tensor, params),
                                     is_raw).numpy()
    assert got.shape == want.shape == (3, 512, 512)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("size", [(H, W), (77, 131)])
def test_sample_flare_matches_jax(maps, size):
    _, want_map, _ = maps
    h, w = size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    with jax.disable_jit():
        want = jbilinear(jnp.asarray(want_map), jnp.asarray(xs) / w, jnp.asarray(ys) / h) * 1.4
        want = np.asarray(want * want)
    got = tflare.sample_flare(torch.from_numpy(want_map), h, w).numpy()
    assert got.shape == want.shape == (3, h, w)
    assert np.abs(got - want).max() <= 1e-6


def test_flare_maps_wrapper_checks_its_inputs():
    x = torch.zeros((2, 3, 8, 8))
    with pytest.raises(ValueError, match="params shape"):
        tflare.flare_maps(x, torch.zeros((1, 4)), False)
    with pytest.raises(ValueError, match="B, 3, H, W"):
        tflare.flare_maps(x[0], torch.zeros((1, 4)), False)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tflare.flare_maps(x.to("meta"), torch.zeros((2, 4), device="meta"), False)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32))


RADIAL = {"centerX": 70, "centerY": 40, "radiusX": 30, "radiusY": 20, "rotation": 25.0,
          "feather": 0.4}
FLARE_DOCS = {
    "global": {"flareAmount": 60, "exposure": 0.3, "highlights": -20, "contrast": 10},
    "global and a mask": {"flareAmount": 40, "exposure": 0.3, "masks": [{
        "visible": True, "adjustments": {"flareAmount": 50, "exposure": -0.2},
        "subMasks": [{"type": "radial", "visible": True, "mode": "additive",
                      "parameters": RADIAL}]}]},
    "a mask alone": {"contrast": 15, "masks": [{
        "visible": True, "adjustments": {"flareAmount": 70},
        "subMasks": [{"type": "all", "visible": True, "mode": "additive", "parameters": {}}]}]},
}


@pytest.mark.parametrize("name", sorted(FLARE_DOCS))
def test_grade_chain_with_flare_matches_jax(maps, name):
    """The flare stage between halation and dehaze, its amount blended by
    the masks' where they set it; the same 512^2 map for both sides."""
    doc = FLARE_DOCS[name]
    _, fmap, _ = maps
    tp, tc = rt.parse_adjustments(doc)
    jp, jc = jparse(doc)
    assert tc.flare_active and jc.flare_active
    n = tc.mask_count
    rng = np.random.default_rng(5)
    x = bright_image(2) * np.float32(1.3)
    infl = rng.random((n, H, W), dtype=np.float32)
    if n:
        infl[:, :, : W // 4] = 0.0
    gated = np.where(infl > 0.001, infl, 0.0).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    with jax.disable_jit():
        frgb = jbilinear(jnp.asarray(fmap), jnp.asarray(xs) / W, jnp.asarray(ys) / H) * 1.4
        frgb = frgb * frgb
        want = jgrade.grade_chain(
            jnp.asarray(x), None, None, None, None, frgb, jp["glob"], jp["mask"],
            jnp.asarray(gated) if n else None, jc, jnp.asarray(xs), jnp.asarray(ys), W, H, 1.0)
    got = tgrade.grade_chain(
        torch.from_numpy(x), None, None, None, None, _torch_tree(tp["glob"]), tc,
        torch.from_numpy(xs), torch.from_numpy(ys), W, H,
        m=_torch_tree(tp["mask"]) if n else None,
        gated_infl=torch.from_numpy(gated) if n else None,
        flare_rgb=tflare.sample_flare(torch.from_numpy(fmap), H, W))
    no_flare = tgrade.grade_chain(
        torch.from_numpy(x), None, None, None, None, _torch_tree(tp["glob"]),
        dataclasses.replace(tc, flare_active=False), torch.from_numpy(xs),
        torch.from_numpy(ys), W, H, m=_torch_tree(tp["mask"]) if n else None,
        gated_infl=torch.from_numpy(gated) if n else None)
    assert float((got - no_flare).abs().max()) > 1e-3  # the stage adds light
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRADE_TOL)


def test_develop_batch_takes_a_flare_map():
    """A caller's (512, 512, 3) map serves the whole batch, as in JAX's
    develop_batch; (B, 512, 512, 3) maps serve one image each; another
    shape is refused."""
    from rapidraw_tpu.pipeline.batch import develop_batch as jdevelop_batch
    from rapidraw_tpu.pipeline.batch import stack_params as jstack

    doc = FLARE_DOCS["global"]
    rng = np.random.default_rng(8)
    x = rng.random((2, 3, 32, 48), dtype=np.float32)
    fmap = (rng.random((512, 512, 3)) * 0.5).astype(np.float32)
    tp, tc = rt.stack_params(*zip(*[rt.parse_adjustments(doc)] * 2), device="cpu")
    jp, jc = jstack(*map(list, zip(*[jparse(doc)] * 2)))
    tc, jc = (dataclasses.replace(c, dither_active=False) for c in (tc, jc))
    shared = rt.develop_batch(torch.from_numpy(x), tp, tc, flare=fmap)
    each = rt.develop_batch(torch.from_numpy(x), tp, tc, flare=np.stack([fmap, fmap]))
    assert torch.equal(shared, each)
    want = jdevelop_batch(jnp.asarray(x), jp, jc, flare=jnp.asarray(fmap))
    np.testing.assert_allclose(shared.numpy(), np.asarray(want), atol=GRADE_TOL)
    with pytest.raises(ValueError, match="flare map"):
        rt.develop_batch(torch.from_numpy(x), tp, tc, flare=fmap[:256])
