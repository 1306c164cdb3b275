"""The AI entries of the port against the JAX package's, on the CPU, at
narrow widths, both packages reading the same flat npz files.

- generate_foreground_mask / generate_sky_mask (u2netp widths at a 64 px
  input) and generate_depth_map (ViT-S at 70 px): u8 within 1 LSB on at
  most 0.1% of the values;
- denoise_ai (UtNet base 8; a 128 px image under 504 px tiles, and four
  tiles) and run_lama_inpainting (ngf 8, one block; the MAX_DIM downscale
  path too): within 1e-4 of the reference's span;
- generate_replace_patch: the mask JPEG byte for byte; with LaMa's output
  shared, both JPEGs byte for byte;
- the chain precompute_ai_submasks -> rasterize_masks -> develop_batch ->
  device_u8 on chip_smoke.ai_doc: each sub-mask at its entry's bar, then
  float within 1e-3 and u8 within 1 LSB on at most 0.1% over the pixels
  (at least 99%) whose rasterized masks are equal;
- the CLI's `denoise --method ai` against JAX's CLI, and its error when
  the weights are missing.
JAX runs its entries as they are (jitted); the CLI comparison runs JAX's
verb op by op, one device, as tests/test_torch_cli.py does.
"""

from __future__ import annotations

import base64
import dataclasses
import io
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import torch_ai_common as common
from test_torch_ai_sam import jax_sam_logits, sam_flips_near_zero
from rapidraw_tpu import cli as jcli
from rapidraw_tpu.ai import denoise as jdn
from rapidraw_tpu.ai import depth as jdepth
from rapidraw_tpu.ai import inpaint as jinp
from rapidraw_tpu.ai import masks as jmasks
from rapidraw_tpu.ai import sam as jsam
import rapidraw_tpu_torch as rt
from rapidraw_tpu_torch import cli as pcli
from rapidraw_tpu_torch.ai import denoise, depth, inpaint, masks, sam

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
SAM_NARROW = dict(SAM_INPUT=64, _EMBED=48, _HEADS=6, _LAYERS=2, _GLOBAL=(1,), _PROMPT_DIM=32,
                  _WINDOW=14)
SAM_CFG = sam.SamConfig(input=64, embed=48, heads=6, layers=2, global_blocks=(1,),
                        prompt_dim=32)


def _u2netp_factory(orig):
    """JAX's `_u2net()` with u2netp's widths whatever `small` it is asked."""
    return lambda: (lambda small=False: orig()(small=True))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded weights for every network at the narrow widths, drawn on the
    flax modules' own trees of shapes, in one models directory."""
    d = tmp_path_factory.mktemp("models")
    mp = pytest.MonkeyPatch()
    for k, v in SAM_NARROW.items():
        mp.setattr(jsam, k, v)
    mp.setattr(jinp, "_NGF", 8)
    mp.setattr(jinp, "_N_BLOCKS", 1)
    z = jnp.zeros
    enc, dec = jsam._models()
    nets = {
        "u2net.npz": (jmasks._u2net()(small=True).init, z((1, 64, 64, 3))),
        "skyseg.npz": (jmasks._u2net()(small=True).init, z((1, 64, 64, 3))),
        "depth_anything_v2_vits.npz": (jdepth._depth_model()().init, z((1, 70, 70, 3))),
        "sam_vit_b_encoder.npz": (enc().init, z((1, 64, 64, 3))),
        "sam_vit_b_decoder.npz": (dec().init, z((1, 4, 4, 32)), z((1, 2, 2)), z((1, 2)),
                                  z((1, 16, 16, 1)), z(())),
        "utnet.npz": (type(jdn._utnet())(base=8).init, z((1, 16, 16, 3))),
        "lama.npz": (jinp._models()().init, z((1, 64, 64, 3)), z((1, 64, 64, 1))),
    }
    shapes = {}
    for seed, (name, (init, *args)) in enumerate(nets.items()):
        key = (init.__self__.__class__, tuple(a.shape for a in args))
        if key not in shapes:
            shapes[key] = jax.eval_shape(init, KEY, *args)
        common.save(common.seeded_tree(shapes[key], 30 + seed), d / name)
    mp.undo()
    return d


@pytest.fixture
def narrow(weights, monkeypatch):
    """Both packages at the narrow widths, reading `weights`."""
    monkeypatch.setenv("RAPIDRAW_MODELS", str(weights))
    monkeypatch.setattr(jmasks, "U2NET_INPUT", 64)
    monkeypatch.setattr(jmasks, "_u2net", _u2netp_factory(jmasks._u2net))
    monkeypatch.setattr(jdepth, "DEPTH_INPUT", 70)
    for k, v in SAM_NARROW.items():
        monkeypatch.setattr(jsam, k, v)
    monkeypatch.setattr(jinp, "_NGF", 8)
    monkeypatch.setattr(jinp, "_N_BLOCKS", 1)
    base8 = type(jdn._utnet())
    monkeypatch.setattr(jdn, "_utnet", lambda: base8(base=8))
    for mod in (jmasks, jdepth, jsam, jinp, jdn):
        monkeypatch.setattr(mod, "_jit_cache", {})
    monkeypatch.setattr(jmasks, "_weights_cache", {})
    monkeypatch.setattr(masks, "U2NET", masks.U2NetConfig(small=True, input=64))
    monkeypatch.setattr(depth, "DEPTH", depth.DepthConfig(input=70))
    monkeypatch.setattr(sam, "SAM", SAM_CFG)
    monkeypatch.setattr(inpaint, "LAMA", inpaint.LamaConfig(ngf=8, n_blocks=1))
    monkeypatch.setattr(denoise, "UTNET", denoise.UtNetConfig(base=8))
    monkeypatch.setattr(masks, "_weights_cache", {})
    return weights


def scene(h=90, w=120, seed=0) -> np.ndarray:
    """A planar image with structure (a bright top, a disc) and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disc = ((yy - h * 0.6) ** 2 + (xx - w * 0.5) ** 2 < (h * 0.25) ** 2).astype(np.float32)
    base = np.stack([0.3 + 0.5 * (yy < h * 0.35) + 0.2 * disc,
                     0.35 + 0.4 * (yy < h * 0.35) + 0.1 * np.sin(xx / 7),
                     0.4 + 0.5 * (yy < h * 0.35) - 0.2 * disc])
    return np.clip(base + rng.normal(0, 0.04, base.shape), 0, 1).astype(np.float32)


def test_saliency_masks_match_jax(narrow):
    img = scene()
    common.u8_close(jmasks.generate_foreground_mask(img),
                    masks.generate_foreground_mask(img, device="cpu"))
    common.u8_close(jmasks.generate_sky_mask(img), masks.generate_sky_mask(img, device="cpu"))
    # a tensor input gives the same mask
    assert np.array_equal(masks.generate_sky_mask(torch.from_numpy(img), device="cpu"),
                          masks.generate_sky_mask(img, device="cpu"))


def test_depth_map_matches_jax(narrow):
    img = scene(seed=1)
    common.u8_close(jdepth.generate_depth_map(img), depth.generate_depth_map(img, device="cpu"))


@pytest.mark.parametrize("shape,quality", [((128, 128), 0.5), ((128, 128), 0.9),
                                           ((520, 530), 0.5)])
def test_denoise_ai_matches_jax(shape, quality, narrow):
    """A 128 px image under a 504 px tile (its reflect pad runs past the
    image, over and over), and four tiles with their blended seams."""
    h, w = shape
    img = common.rand_image(h, w, seed=3)
    want = jdn.denoise_ai(img, quality=quality)
    got = denoise.denoise_ai(img, quality=quality, device="cpu")
    assert got.shape == (3, h, w) and got.dtype == torch.float32
    assert common.max_rel(want, got.numpy()) <= 1e-4


def lama_scene(h=80, w=96):
    img = scene(h, w, seed=4)
    mask = np.zeros((h, w), np.uint8)
    mask[30:46, 40:60] = 255
    return img, mask


@pytest.mark.parametrize("max_dim", [768, 48])
def test_lama_inpainting_matches_jax(max_dim, narrow, monkeypatch):
    """At the cap the crop runs as it is; at a 48 px cap it is downscaled,
    run on a 64-aligned square and resized back."""
    monkeypatch.setattr(jinp, "MAX_DIM", max_dim)
    monkeypatch.setattr(inpaint, "MAX_DIM", max_dim)
    img, mask = lama_scene()
    want = jinp.run_lama_inpainting(img, mask)
    got = inpaint.run_lama_inpainting(img, mask, device="cpu")
    assert common.max_rel(want, got.numpy()) <= 1e-4
    empty = inpaint.run_lama_inpainting(img, np.zeros_like(mask), device="cpu")
    assert np.array_equal(empty.numpy(), img)


PATCH = {"visible": True, "subMasks": [{
    "type": "radial", "visible": True, "mode": "additive",
    "parameters": {"centerX": 50, "centerY": 38, "radiusX": 14, "radiusY": 9, "rotation": 10.0,
                   "feather": 0.4}}]}


def test_replace_patch_matches_jax(narrow, monkeypatch):
    img, _ = lama_scene()
    want = jinp.generate_replace_patch(img, PATCH)
    got = inpaint.generate_replace_patch(img, PATCH, device="cpu")
    assert got["mask"] == want["mask"]
    dec = [np.asarray(Image.open(io.BytesIO(base64.b64decode(p["color"])))).astype(np.int16)
           for p in (want, got)]
    assert np.abs(dec[0] - dec[1]).mean() < 0.05
    # with LaMa's output shared, the rest (rasterize, quantize, black
    # outside, both JPEGs) is byte for byte
    shared = np.clip(img[::-1] * 0.8 + 0.1, 0.0, 1.0).astype(np.float32)
    monkeypatch.setattr(jinp, "run_lama_inpainting", lambda *a, **k: shared.copy())
    monkeypatch.setattr(inpaint, "run_lama_inpainting", lambda *a, **k: torch.from_numpy(shared))
    assert inpaint.generate_replace_patch(img, PATCH, device="cpu") == \
        jinp.generate_replace_patch(img, PATCH)


def _decoded_masks(doc) -> list:
    from rapidraw_tpu_torch.io.encode import decode_png_gray

    out = []
    for m in doc["masks"]:
        for s in m["subMasks"]:
            data = s["parameters"]["maskDataBase64"].split(",", 1)[1]
            out.append((s["type"], decode_png_gray(base64.b64decode(data))))
    return out


def _jax_chain(doc, x, dither):
    from rapidraw_tpu.masks.rasterize import rasterize_masks as jraster
    from rapidraw_tpu.params.parse import parse_adjustments as jparse
    from rapidraw_tpu.pipeline.bands import blur_band_rows as jbands
    from rapidraw_tpu.pipeline.batch import develop_batch as jdevelop_batch
    from rapidraw_tpu.pipeline.batch import stack_params as jstack
    from rapidraw_tpu.pipeline.export import _device_u8

    h, w = x.shape[1:]
    mk = jraster(doc, w, h)[None]
    p, c = jstack(*map(list, zip(jparse(doc))))
    c = dataclasses.replace(c, dither_active=dither)
    bands = jbands(c, mk)
    out = jax.jit(lambda im, q, m: jdevelop_batch(im, q, c, masks=m, blur_bands=bands))(
        jnp.asarray(x[None]), p, jnp.asarray(mk))
    return mk[0], np.asarray(out)[0], np.asarray(_device_u8(out))[0]


def _port_chain(doc, x, dither):
    h, w = x.shape[1:]
    mk = rt.rasterize_masks(doc, w, h)[None]
    p, c = rt.stack_params(*map(list, zip(rt.parse_adjustments(doc))), device="cpu")
    c = dataclasses.replace(c, dither_active=dither)
    out = rt.develop_batch(torch.from_numpy(x[None]), p, c, masks=torch.from_numpy(mk),
                           blur_bands=rt.blur_band_rows(c, mk))
    return mk[0], out.numpy()[0], rt.device_u8(out).numpy()[0]


def test_precompute_chain_matches_jax(narrow):
    """chip_smoke.ai_doc: an ai-subject drag with a rotation plus the
    foreground saliency on one mask (with clarity: the blur runs), sky minus
    near depth on another; precompute -> rasterize -> develop -> u8."""
    h, w = 96, 128
    x = scene(h, w, seed=5)
    doc = chip_smoke.ai_doc(h, w)
    jdoc = jmasks.precompute_ai_submasks(doc, x)
    pdoc = masks.precompute_ai_submasks(doc, x, device="cpu")
    assert "maskDataBase64" not in str(doc)  # the input document is not changed
    for (jt, jm), (pt, pm) in zip(_decoded_masks(jdoc), _decoded_masks(pdoc)):
        assert jt == pt and jm.shape == pm.shape == (h, w)
        if jt == "ai-subject":
            # JAX's logits at this prompt, to place any flip
            je = jsam.generate_image_embeddings(x)
            sub = doc["masks"][0]["subMasks"][0]["parameters"]
            sp, ep = jsam.unproject_prompt_rect(
                (sub["startX"], sub["startY"]), (sub["endX"], sub["endY"]), w, h,
                rotation=sub["rotation"])
            logits, _ = jax_sam_logits(je, sp, ep)
            assert np.array_equal(jm, (logits > 0).astype(np.uint8) * 255)
            sam_flips_near_zero(logits, pm)
        else:
            common.u8_close(jm, pm)
    # the grade blends each pixel by its own mask values: where the
    # rasterized masks are equal the develop is held to the slice's bar; a
    # pixel whose mask moved (a 1 LSB sub-mask, a SAM flip) is left out
    for dither in (False, True):
        jmk, jout, ju8 = _jax_chain(jdoc, x, dither)
        pmk, pout, pu8 = _port_chain(pdoc, x, dither)
        keep = ~(np.abs(jmk - pmk) > 0).any(axis=0)
        assert keep.mean() >= 0.99
        if not dither:
            assert np.abs(jout - pout)[:, keep].max() <= 1e-3
        else:
            common.u8_close(ju8[:, keep], pu8[:, keep])


def run_cli(side, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        if side == "jax":
            with jax.disable_jit():
                rc = jcli.main(argv)
        else:
            rc = pcli.main(argv + ["--device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


def test_cli_denoise_ai_matches_jax(narrow, tmp_path, monkeypatch):
    import cv2

    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    src = tmp_path / "noisy.png"
    rgb16 = (common.rand_image(72, 104, seed=6).transpose(1, 2, 0) * 65535).astype(np.uint16)
    cv2.imwrite(str(src), rgb16[..., ::-1])
    outs = {}
    for side in ("jax", "port"):
        dst = tmp_path / f"{side}.png"
        rc, out, _ = run_cli(side, ["denoise", str(src), "--method", "ai", "-o", str(dst),
                                    "--intensity", "0.6"])
        assert rc == 0 and out.strip() == str(dst)
        outs[side] = cv2.imread(str(dst), cv2.IMREAD_UNCHANGED).astype(np.int64)
    assert outs["port"].shape == outs["jax"].shape == (72, 104, 3)
    assert np.abs(outs["port"] - outs["jax"]).max() <= 1e-4 * 65535 + 1
    # no weights: the same error from both
    monkeypatch.setenv("RAPIDRAW_MODELS", str(tmp_path / "none"))
    errors = []
    for side in ("jax", "port"):
        with pytest.raises(SystemExit) as e:
            run_cli(side, ["denoise", str(src), "--method", "ai", "-o", str(tmp_path / "x.png")])
        errors.append(str(e.value.code))
    assert errors[0] == errors[1] and errors[0].startswith("error: NIND UtNet weights not found")
