"""The port's blur pyramid (plain version of csrc/blur.cu) against JAX.

JAX's B1 (`gaussian_blur`, `_blur_axis`) and B2 (`gaussian_blur_multi`,
`_blur_axis_multi`) run in Pallas interpret mode on the CPU, as the JAX
package's own tests run them. Bounds: 5e-5 against the kernels' 3-pass
bf16 split (PARITY.md's 1.4e-5 relative bar, at values up to ~1), and
2e-6 against JAX's float32 convolution oracle `gaussian_blur_reference`.
The CUDA kernel itself is held against this plain version on the card
by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rapidraw_tpu.ops import blur as jblur
from rapidraw_tpu_torch.ops import blur as tblur

torch.set_num_threads(2)


def img(shape, seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * (hi - lo) + lo).astype(np.float32)


@pytest.fixture(scope="module")
def big():
    # (3, 512, 640): at least 4 blocks of 128 px per axis, so JAX takes the
    # prepadded fast path of B1 and the multi-radius kernel B2
    return img((3, 512, 640), seed=1)


def test_single_radius_matches_pallas_b1(big):
    got = tblur.gaussian_blur(torch.from_numpy(big), 10).numpy()
    np.testing.assert_allclose(got, np.asarray(jblur.gaussian_blur(jnp.asarray(big), 10)),
                               atol=5e-5)
    np.testing.assert_allclose(
        got, np.asarray(jblur.gaussian_blur_reference(jnp.asarray(big), 10)), atol=2e-6)


def test_multi_radius_matches_pallas_b2(big):
    radii = (1, 2, 4, 10)
    got = tblur.gaussian_blur_multi(torch.from_numpy(big), radii)
    want = jblur.gaussian_blur_multi(jnp.asarray(big), radii)
    assert len(got) == len(radii)
    for r, a, b in zip(radii, got, want):
        assert tuple(a.shape) == big.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, err_msg=f"r={r}")


@pytest.mark.parametrize("radius", [1, 3, 14, 31])
def test_matches_conv_oracle(radius):
    # values outside [0, 65504] exercise the rgba16f clamp on load
    x = img((3, 72, 96), seed=radius, lo=-0.5, hi=1.5)
    x[0, 10, 20] = 9.0e4
    got = tblur.gaussian_blur(torch.from_numpy(x), radius).numpy()
    want = np.asarray(jblur.gaussian_blur_reference(jnp.asarray(x), radius))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


def test_weights_match_jax():
    for r in (1, 4, 14, 31, 152):
        np.testing.assert_array_equal(tblur._gauss_weights(r), jblur._gauss_weights(r))


def test_batched_channels_blur_independently():
    x = torch.from_numpy(img((6, 40, 56), seed=5))
    both = tblur.gaussian_blur_multi(x, (2, 6))
    for g, r in enumerate((2, 6)):
        np.testing.assert_array_equal(both[g][:3].numpy(), tblur.gaussian_blur(x[:3], r).numpy())
        np.testing.assert_array_equal(both[g][3:].numpy(), tblur.gaussian_blur(x[3:], r).numpy())


def test_cpu_tensor_takes_the_plain_version():
    before = tblur.gaussian_blur_multi.launches
    x = torch.from_numpy(img((3, 16, 16)))
    a = tblur.gaussian_blur_multi(x, (2, 3))
    b = tblur.gaussian_blur_multi_plain(x, (2, 3))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert tblur.gaussian_blur_multi.launches == before


@pytest.mark.parametrize("bad", [
    dict(x=np.zeros((3, 8, 8), np.float64), radii=(1,)),
    dict(x=np.zeros((8, 8), np.float32), radii=(1,)),
    dict(x=np.zeros((3, 8, 8), np.float32), radii=(1, 2, 3, 4, 5)),
    dict(x=np.zeros((3, 8, 8), np.float32), radii=(0,)),
])
def test_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        tblur.gaussian_blur_multi(torch.from_numpy(bad["x"]), bad["radii"])
