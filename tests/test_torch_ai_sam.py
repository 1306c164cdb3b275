"""SAM ViT-B in the port against the JAX package's, on the CPU, at narrow
widths (dim 48, 2 blocks, a 64 px input, prompt dim 32).

- The encoder (windowed attention with and without its zero pad, a global
  block, the relative-position tables sliced to 2h - 1, the neck) and the
  decoder (box, point and negative prompts, with and without the fed-back
  mask) against flax's `apply` within 1e-4 of the reference's span, the
  flax variables from the JAX package's own init with every leaf moved by
  seeded noise;
- generate_image_embeddings + run_sam_decoder against JAX's entries: the
  embeddings within 1e-4 of their span, the same IoU token picked at each
  iteration, and every mask pixel that differs lying where JAX's upsampled
  logit is within 1e-3 of its largest magnitude from 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ai_common as common
from rapidraw_tpu.ai import masks as jmasks
from rapidraw_tpu.ai import sam as jsam
from rapidraw_tpu_torch.ai import masks, sam

torch.set_num_threads(2)

TOL = 1e-4  # of the reference's span
KEY = jax.random.PRNGKey(0)


def init(model, seed, *args):
    """The module's own init (compiled once), every leaf then moved."""
    return common.perturb(jax.jit(model.init)(KEY, *args), seed)


def nhwc(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def held(ref, got) -> None:
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    assert np.isfinite(got).all()
    assert common.max_rel(ref, got) <= TOL, common.max_rel(ref, got)


def _narrow_sam(monkeypatch, window):
    for k, val in dict(SAM_INPUT=64, _EMBED=48, _HEADS=6, _LAYERS=2, _GLOBAL=(1,),
                       _PROMPT_DIM=32, _WINDOW=window).items():
        monkeypatch.setattr(jsam, k, val)
    return sam.SamConfig(input=64, embed=48, heads=6, layers=2, global_blocks=(1,),
                         prompt_dim=32, window=window)


@pytest.mark.parametrize("window", [3, 14])
def test_sam_encoder_matches_flax(window, monkeypatch):
    """Windowed attention with its zero pad (a 4 x 4 grid in 3 x 3
    windows) and without (the window clipped to the grid), a global block,
    the relative-position tables sliced to 2h - 1, the neck."""
    cfg = _narrow_sam(monkeypatch, window)
    enc, _ = jsam._models()
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    v = init(enc(), 13, x)
    net = masks.sam_encoder_weights(common.flatten(v), cfg)
    held(jax.jit(enc().apply)(v, x), net(nhwc(x)).numpy())


@pytest.fixture(scope="module")
def sam_decoder():
    """The narrow decoder's flax module, weights and compiled apply."""
    mp = pytest.MonkeyPatch()
    cfg = _narrow_sam(mp, 14)  # flax reads the globals as it traces: kept until teardown
    _, dec = jsam._models()
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((1, 4, 4, 32)).astype(np.float32)
    coords = np.array([[[10.0, 12.0], [40.0, 50.0]]], np.float32)
    mask_in = rng.standard_normal((1, 16, 16, 1)).astype(np.float32)
    v = init(dec(), 14, emb, coords, np.zeros((1, 2), np.float32), mask_in, np.float32(0.0))
    net = masks.sam_decoder_weights(common.flatten(v), cfg)
    yield jax.jit(dec().apply), v, net, (emb, coords, mask_in)
    mp.undo()


@pytest.mark.parametrize("labels,has_mask", [((2.0, 3.0), 0.0), ((2.0, 3.0), 1.0),
                                             ((1.0, -1.0), 0.0), ((0.0, 1.0), 1.0)])
def test_sam_decoder_matches_flax(labels, has_mask, sam_decoder):
    """Box corners, a point with the pad label, a negative point; the
    dense prompt from the fed-back mask or the no-mask embedding."""
    apply, v, net, (emb, coords, mask_in) = sam_decoder
    lab = np.array([labels], np.float32)
    want_m, want_iou = apply(v, emb, coords, lab, mask_in, np.float32(has_mask))
    got_m, got_iou = net(*(torch.from_numpy(a) for a in (emb, coords, lab, mask_in)),
                         torch.tensor(has_mask))
    held(want_m, got_m.numpy())
    held(want_iou, got_iou.numpy())


@pytest.fixture
def narrow_sam(tmp_path, monkeypatch):
    """Both packages' SAM at the narrow widths, reading weights drawn from
    a seed on flax's trees of shapes."""
    cfg = _narrow_sam(monkeypatch, 14)
    monkeypatch.setattr(sam, "SAM", cfg)
    monkeypatch.setattr(jsam, "_jit_cache", {})
    monkeypatch.setattr(jmasks, "_weights_cache", {})
    monkeypatch.setattr(masks, "_weights_cache", {})
    monkeypatch.setenv("RAPIDRAW_MODELS", str(tmp_path))
    enc, dec = jsam._models()
    z = jnp.zeros
    drawn = lambda m, seed, *a: common.seeded_tree(jax.eval_shape(m.init, KEY, *a), seed)  # noqa: E731
    common.save(drawn(enc(), 21, z((1, 64, 64, 3))), tmp_path / "sam_vit_b_encoder.npz")
    common.save(drawn(dec(), 22, z((1, 4, 4, 32)), z((1, 2, 2)), z((1, 2)), z((1, 16, 16, 1)),
                      z(())), tmp_path / "sam_vit_b_decoder.npz")
    return cfg


def scene(h=90, w=120, seed=2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disc = ((yy - h * 0.6) ** 2 + (xx - w * 0.5) ** 2 < (h * 0.25) ** 2).astype(np.float32)
    base = np.stack([0.3 + 0.5 * (yy < h * 0.35) + 0.2 * disc,
                     0.35 + 0.4 * (yy < h * 0.35) + 0.1 * np.sin(xx / 7),
                     0.4 + 0.5 * (yy < h * 0.35) - 0.2 * disc])
    return np.clip(base + rng.normal(0, 0.04, base.shape), 0, 1).astype(np.float32)


def jax_sam_logits(e, start, end, iters=2):
    """JAX's run_sam_decoder up to its threshold (sam.py:400-454, the same
    steps): the upsampled logits and the IoU token picked per iteration."""
    variables = jmasks._load_variables("sam_vit_b_decoder.npz")
    w, h = e.original_size
    scale = jsam.SAM_INPUT / max(h, w)
    (sx, sy), (ex, ey) = start, end
    if abs(sx - ex) < 1e-6 and abs(sy - ey) < 1e-6:
        coords, labels = [(sx * scale, sy * scale), (0.0, 0.0)], [1.0, -1.0]
    else:
        x1, x2 = sorted((sx * scale, ex * scale))
        y1, y2 = sorted((sy * scale, ey * scale))
        coords, labels = [(x1, y1), (x2, y2)], [2.0, 3.0]
    emb = jnp.asarray(e.embeddings)
    g = emb.shape[1]
    mask_in = jnp.zeros((1, 4 * g, 4 * g, 1), jnp.float32)
    has_mask = jnp.float32(0.0)
    picks = []
    for _ in range(iters):
        m, iou = jsam._decoder_fwd()(variables, emb, jnp.asarray([coords], jnp.float32),
                                     jnp.asarray([labels], jnp.float32), mask_in, has_mask)
        pick = 1 + jnp.argmax(iou[0, 1:])
        picks.append(int(pick))
        best = m[0, pick]
        mask_in, has_mask = best[None, :, :, None], jnp.float32(1.0)
    full = jax.image.resize(best, (jsam.SAM_INPUT, jsam.SAM_INPUT), "bilinear")
    nh, nw = round(h * scale), round(w * scale)
    return np.asarray(jax.image.resize(full[:nh, :nw], (h, w), "bilinear")), picks


def sam_flips_near_zero(want_logits, got_mask) -> int:
    """Assert every pixel where the port's mask differs from JAX's lies
    where JAX's logit is within 1e-3 of its largest magnitude from 0;
    returns the number of such pixels."""
    want = (want_logits > 0).astype(np.uint8) * 255
    flips = want != got_mask
    near = np.abs(want_logits) <= 1e-3 * np.abs(want_logits).max()
    assert not (flips & ~near).any(), int((flips & ~near).sum())
    return int(flips.sum())


@pytest.mark.parametrize("prompt", [((20.0, 18.0), (95.0, 70.0)), ((60.0, 50.0), (60.0, 50.0))])
def test_sam_matches_jax(prompt, narrow_sam):
    """A drag (box corners) and a click (a point with the pad label)."""
    img = scene()
    je = jsam.generate_image_embeddings(img)
    pe = sam.generate_image_embeddings(img, device="cpu")
    assert pe.original_size == je.original_size == (120, 90)
    assert common.max_rel(je.embeddings, pe.embeddings.numpy()) <= 1e-4
    # the decoder on JAX's own embeddings, so each side's inputs are equal
    pe_j = sam.ImageEmbeddings(torch.from_numpy(np.asarray(je.embeddings)), je.original_size)
    want_logits, want_picks = jax_sam_logits(je, *prompt)
    got_logits, got_picks = sam.sam_mask_logits(pe_j, *prompt)
    assert got_picks == want_picks
    got = sam.run_sam_decoder(pe_j, *prompt)
    assert np.array_equal(got, (got_logits.numpy() > 0).astype(np.uint8) * 255)
    assert np.array_equal(jsam.run_sam_decoder(je, *prompt),
                          (want_logits > 0).astype(np.uint8) * 255)
    sam_flips_near_zero(want_logits, got)
    # and end to end from each side's own embeddings
    sam_flips_near_zero(want_logits, sam.run_sam_decoder(pe, *prompt))


