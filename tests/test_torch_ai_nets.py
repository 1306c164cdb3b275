"""The AI networks of the port (rapidraw_tpu_torch/ai) against the JAX
package's flax modules, on the CPU, at narrow widths.

The flax variables are drawn from a seed on the init's own tree of shapes
(torch_ai_common.seeded_tree; flax's init of these networks compiles for
10-25 s each here); SAM's, from the JAX package's own init with every leaf
moved by seeded noise, are in test_torch_ai_sam.py. The port's carry-over
turns the flat npz layout into the torch module. Each forward is held to flax's `apply` on the same inputs within
1e-4 of the reference's span. Also: the name table at the published
widths against flax's (shapes only), the carry-over's refusals, TF32 off
inside a forward and restored after it, the bilinear resize against
`jax.image.resize`, and the tiled harness's reflect pad against NumPy's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ai_common as common
from rapidraw_tpu.ai import denoise as jdn
from rapidraw_tpu.ai import depth as jdepth
from rapidraw_tpu.ai import inpaint as jinp
from rapidraw_tpu.ai import masks as jmasks
from rapidraw_tpu.ai import sam as jsam
from rapidraw_tpu.ai import tiled_inference as jtiled
from rapidraw_tpu_torch.ai import denoise, depth, inpaint, layers, masks, sam, tiled_inference
from rapidraw_tpu_torch.geometry.resize import resize_bilinear

torch.set_num_threads(2)

TOL = 1e-4  # of the reference's span
KEY = jax.random.PRNGKey(0)


def drawn(model, seed, *args):
    """Seeded weights on the module's own tree of shapes (jax.eval_shape):
    flax's init compiles for 10-25 s a network here."""
    return common.seeded_tree(jax.eval_shape(model.init, KEY, *args), seed)


def nhwc(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def held(ref, got) -> None:
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    assert np.isfinite(got).all()
    assert common.max_rel(ref, got) <= TOL, common.max_rel(ref, got)


@pytest.fixture(scope="module")
def u2netp():
    """u2netp's widths (small=True): its weights do not depend on the side."""
    model = jmasks._u2net()(small=True)
    return model, drawn(model, 11, np.zeros((1, 16, 16, 3), np.float32))


@pytest.mark.parametrize("side", [64, 37])
def test_u2net_small_matches_flax(side, u2netp):
    """The odd side pads flax's SAME max-pool at its end
    (37 -> 19 -> 10 -> 5 -> 3 -> 2)."""
    model, v = u2netp
    x = np.random.default_rng(1).standard_normal((1, side, side, 3)).astype(np.float32)
    net = masks.u2net_weights(common.flatten(v), masks.U2NetConfig(small=True, input=side))
    held(np.asarray(jax.jit(model.apply)(v, x))[..., 0], net(nhwc(x))[:, 0].numpy())


def test_u2net_full_matches_flax():
    """The published widths (44M weights)."""
    model = jmasks._u2net()(small=False)
    x = np.random.default_rng(1).standard_normal((1, 40, 40, 3)).astype(np.float32)
    v = drawn(model, 17, x)
    net = masks.u2net_weights(common.flatten(v), masks.U2NetConfig(small=False, input=40))
    held(np.asarray(jax.jit(model.apply)(v, x))[..., 0], net(nhwc(x))[:, 0].numpy())


@pytest.mark.parametrize("side", [70])
def test_depth_matches_flax(side):
    model = jdepth._depth_model()()
    x = np.random.default_rng(2).standard_normal((1, side, side, 3)).astype(np.float32)
    v = drawn(model, 12, x)
    net = masks.depth_weights(common.flatten(v), depth.DepthConfig(input=side))
    held(jax.jit(model.apply)(v, x), net(nhwc(x)).numpy())


@pytest.fixture(scope="module")
def utnet():
    model = type(jdn._utnet())(base=8)
    v = drawn(model, 15, np.zeros((1, 16, 16, 3), np.float32))
    return jax.jit(model.apply), v, masks.utnet_weights(common.flatten(v),
                                                        denoise.UtNetConfig(base=8))


@pytest.mark.parametrize("shape", [(2, 48, 32), (1, 64, 80)])
def test_utnet_matches_flax(shape, utnet):
    apply, v, net = utnet
    b, h, w = shape
    x = np.random.default_rng(5).standard_normal((b, h, w, 3)).astype(np.float32)
    held(apply(v, x), net(nhwc(x)).permute(0, 2, 3, 1).numpy())


@pytest.fixture(scope="module")
def lama():
    mp = pytest.MonkeyPatch()
    mp.setattr(jinp, "_NGF", 8)
    mp.setattr(jinp, "_N_BLOCKS", 2)
    model = jinp._models()()
    z = np.zeros((1, 64, 64, 3), np.float32)
    v = drawn(model, 16, z, z[..., :1])
    net = masks.lama_weights(common.flatten(v), inpaint.LamaConfig(ngf=8, n_blocks=2))
    yield jax.jit(model.apply), v, net
    mp.undo()


@pytest.mark.parametrize("side", [64, 72])
def test_lama_matches_flax(side, lama):
    """FFC blocks with the rfft2/irfft2 spectral transform (an odd 9 x 9
    grid at 72), the double reflect pad of the stem, the explicit-padding
    transposed convolutions."""
    apply, v, net = lama
    rng = np.random.default_rng(6)
    img = rng.random((1, side, side, 3)).astype(np.float32)
    msk = (rng.random((1, side, side, 1)) > 0.7).astype(np.float32)
    held(apply(v, img, msk), net(nhwc(img), nhwc(msk)).permute(0, 2, 3, 1).numpy())


def _flax_shapes(init, *args) -> dict:
    tree = jax.eval_shape(init, KEY, *args)
    return {k: tuple(a.shape) for k, a in common.flatten_shapes(tree).items()}


def test_name_tables_match_flax_at_published_widths(monkeypatch):
    """Every npz key and flax shape the port reads at the published widths
    is the one JAX's init makes (jax.eval_shape: no forward runs)."""
    published = dict(SAM_INPUT=1024, _EMBED=768, _HEADS=12, _LAYERS=12, _GLOBAL=(2, 5, 8, 11),
                     _PROMPT_DIM=256, _WINDOW=14)
    for k, val in published.items():  # a narrow module fixture may hold them
        monkeypatch.setattr(jsam, k, val)
    monkeypatch.setattr(jinp, "_NGF", 64)
    monkeypatch.setattr(jinp, "_N_BLOCKS", 9)
    z = jnp.zeros
    enc, dec = jsam._models()
    cases = [
        (masks.U2Net(), jmasks._u2net()().init, z((1, 320, 320, 3))),
        (depth.DepthAnythingV2S(), jdepth._depth_model()().init, z((1, 518, 518, 3))),
        (sam.SamEncoder(), enc().init, z((1, 1024, 1024, 3))),
        (sam.SamDecoder(), dec().init, z((1, 64, 64, 256)), z((1, 2, 2)), z((1, 2)),
         z((1, 256, 256, 1)), z(())),
        (denoise.UtNet(), jdn._utnet().init, z((1, 64, 64, 3))),
        (inpaint.LamaGenerator(), jinp._models()().init, z((1, 512, 512, 3)),
         z((1, 512, 512, 1))),
    ]
    for net, init, *args in cases:
        want = _flax_shapes(init, *args)
        got = {key: shape for key, shape, *_ in layers.flax_slots(net)}
        assert got == want, type(net).__name__


def test_carry_over_refuses_leftovers_and_gaps():
    model = type(jdn._utnet())(base=4)
    x = np.zeros((1, 16, 16, 3), np.float32)
    flat = common.flatten(drawn(model, 18, x))
    masks.utnet_weights(flat, denoise.UtNetConfig(base=4))  # fills every tensor
    with pytest.raises(ValueError, match="does not read"):
        masks.utnet_weights({**flat, "params/Conv_99/kernel": np.zeros(1)},
                            denoise.UtNetConfig(base=4))
    gap = dict(flat)
    del gap["params/ConvTranspose_2/bias"]
    with pytest.raises(ValueError, match="fill no value"):
        masks.utnet_weights(gap, denoise.UtNetConfig(base=4))
    bad = dict(flat, **{"params/Conv_0/kernel": np.zeros((3, 3, 3, 5), np.float32)})
    with pytest.raises(ValueError, match="has shape"):
        masks.utnet_weights(bad, denoise.UtNetConfig(base=4))
    # the bare layout (no 'params/' prefix) is read as JAX reads it
    bare = {k.removeprefix("params/"): a for k, a in flat.items()}
    masks.utnet_weights(bare, denoise.UtNetConfig(base=4))


def test_tf32_off_inside_a_forward_and_restored_after():
    net = denoise.UtNet(denoise.UtNetConfig(base=4))
    seen = []
    net.Conv_0.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.is_grad_enabled())))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        net(torch.zeros(1, 3, 16, 16))
        assert seen == [(False, False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
        with pytest.raises(RuntimeError):  # restored on the way out of an error too
            net(torch.zeros(1, 5, 16, 16))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("src,dst", [
    ((1, 3, 40, 56), (1, 3, 64, 64)),       # up
    ((1, 3, 200, 317), (1, 3, 64, 64)),     # down, antialiased
    ((3, 77, 51), (3, 23, 130)),            # odd ratios, one axis each way
    ((1, 16, 10), (1, 320, 320)),           # the masks' upsample
    ((128, 128), (518, 518)),
    ((7,), (3,)),
])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(7).random(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reflect_index_is_numpys_reflect_pad():
    for n, lo, hi in [(128, 12, 364), (5, 7, 20), (1, 3, 3), (2, 5, 6), (504, 12, 12)]:
        a = np.arange(n)
        assert np.array_equal(tiled_inference.reflect_index(n, lo, hi),
                              np.pad(a, (lo, hi), mode="reflect")), (n, lo, hi)


@pytest.mark.parametrize("params", ["TILE_BALANCED", "TILE_FASTER", "TILE_HIGHER_QUALITY"])
def test_run_tiled_128_matches_jax(params):
    """A 128 x 128 image under 504 px tiles: the reflect pad runs to 364 px,
    past the image, as NumPy pads it; a model that mixes each tile with its
    own mean sees the padding."""
    x = np.random.default_rng(8).random((3, 128, 128)).astype(np.float32)

    def jmodel(b):
        return b * 0.75 + b.mean(axis=(2, 3), keepdims=True) * 0.25

    def tmodel(b):
        return b * 0.75 + b.mean(dim=(2, 3), keepdim=True) * 0.25

    want = jtiled.run_tiled(jmodel, x, getattr(jtiled, params))
    got = tiled_inference.run_tiled(tmodel, torch.from_numpy(x),
                                    getattr(tiled_inference, params)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_run_tiled_many_tiles_matches_jax():
    """Eleven tiles in batches of 8, the last padded to the full batch."""
    x = np.random.default_rng(9).random((3, 600, 1500)).astype(np.float32)
    model = lambda b: b[:, ::-1] * 0.5 + 0.1  # noqa: E731
    want = jtiled.run_tiled(model, x)
    got = tiled_inference.run_tiled(lambda b: b.flip(1) * 0.5 + 0.1, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
