"""AI patches (rapidraw_tpu_torch/masks/patches.py) against the JAX
package's compositor, which decodes and resizes with PIL.

- `composite_patches_on_image` bit for bit: PNG and JPEG data URLs for the
  colour and the mask (an "L" mask from a colour JPEG or an RGBA / palette
  PNG through PIL's convert("L")), LANCZOS resizes of "RGB" and "L"
  images to the canvas, masks rasterized from subMasks (at scale 1 and at
  a preview's scale), hidden and undecodable patches.
- `lanczos_resize_u8` on mode "RGB" against PIL's resize(LANCZOS).
- GIF, BMP and WebP data URLs composite as JAX's PIL composites them
  (io/image_decode.py).
- A document with aiPatches through `apply_all_transformations` (with a
  warp and crop) and through `export_images`, equal to JAX's.
"""

from __future__ import annotations

import base64
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.geometry import transforms as jtr
from rapidraw_tpu.masks import patches as jpatches
from rapidraw_tpu.pipeline import export as jexport
from rapidraw_tpu_torch.geometry import resize
from rapidraw_tpu_torch.geometry import transforms as ptr
from rapidraw_tpu_torch.masks import patches as ppatches
from rapidraw_tpu_torch.pipeline import export as pexport
from test_torch_export import ldr_op_by_op
from test_torch_ldr import photo

jax.config.update("jax_platforms", "cpu")


def url(img: np.ndarray, fmt: str, mode: str | None = None, **kw) -> str:
    im = Image.fromarray(img)
    if mode == "P":
        im = im.quantize(32)
    elif mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return f"data:image/{fmt.lower()};base64," + base64.b64encode(buf.getvalue()).decode()


def canvas(h=72, w=104, seed=0) -> np.ndarray:
    return np.ascontiguousarray(photo(h, w, seed).transpose(2, 0, 1).astype(np.float32) / 255.0)


def mask_img(h, w, seed=1) -> np.ndarray:
    m = np.zeros((h, w, 3), np.uint8)
    m[h // 4: 3 * h // 4, w // 5: w // 2] = (255, 250, 240)
    m[:, w // 2:] = np.random.default_rng(seed).integers(0, 256, (h, w - w // 2, 3))
    return m


RADIAL = [{"type": "radial", "visible": True, "mode": "additive",
           "parameters": {"centerX": 52, "centerY": 36, "radiusX": 30, "radiusY": 20,
                          "feather": 0.4}}]

PATCHES = {
    "png_png": lambda: [{"id": "a", "patchData": {
        "color": url(photo(36, 52, 3), "PNG"), "mask": url(mask_img(24, 35), "PNG", "L")}}],
    "jpeg_jpeg_colour_mask": lambda: [{"id": "b", "visible": True, "patchData": {
        "color": url(photo(72, 104, 4), "JPEG", quality=92),
        "mask": url(mask_img(72, 104), "JPEG", quality=92)}}],
    "grey_jpeg_mask_upscaled": lambda: [{"id": "c", "patchData": {
        "color": url(photo(20, 30, 5), "JPEG", quality=80),
        "mask": url(mask_img(18, 26), "JPEG", "L", quality=90)}}],
    "rgba_and_palette_png_masks": lambda: [
        {"id": "d", "patchData": {"color": url(photo(72, 104, 6), "PNG", "RGBA"),
                                  "mask": url(mask_img(50, 70), "PNG", "RGBA")}},
        {"id": "e", "patchData": {"color": url(photo(90, 130, 7), "PNG", "P"),
                                  "mask": url(mask_img(72, 104), "PNG", "P")}}],
    "submask": lambda: [{"id": "f", "invert": True, "subMasks": RADIAL,
                         "patchData": {"color": url(photo(40, 60, 8), "PNG")}}],
    "hidden_and_broken": lambda: [
        {"id": "g", "visible": False, "patchData": {"color": url(photo(8, 8, 9), "PNG")}},
        {"id": "h", "patchData": {"color": "data:image/png;base64,!!notbase64", "mask": ""},
         "subMasks": RADIAL},
        {"id": "i", "patchData": {"color": url(photo(72, 104, 10), "JPEG")[:80]},
         "subMasks": RADIAL},
        {"id": "j", "patchData": {"color": ""}},
        "not a patch"],
}


@pytest.mark.parametrize("name", sorted(PATCHES))
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_composite_matches_jax(name, scale):
    doc = {"aiPatches": PATCHES[name]()}
    img = canvas()
    want = jpatches.composite_patches_on_image(img, doc, scale=scale)
    got = ppatches.composite_patches_on_image(torch.from_numpy(img), doc, scale=scale)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    if name == "hidden_and_broken":
        assert np.array_equal(want, img)


def test_no_visible_patch_returns_the_input():
    x = torch.from_numpy(canvas())
    for doc in ({}, {"aiPatches": []}, {"aiPatches": [{"id": "x", "visible": False,
                                                       "patchData": {"color": "abc"}}]}):
        assert ppatches.composite_patches_on_image(x, doc) is x


@pytest.mark.parametrize("size", [(31, 45), (90, 200), (7, 3), (72, 104)])
def test_lanczos_rgb_matches_pil(size):
    src = photo(60, 88, 11)
    w, h = size
    want = np.asarray(Image.fromarray(src).resize((w, h), Image.LANCZOS))
    got = resize.lanczos_resize_u8(src, w, h)
    assert got.shape == (h, w, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "WEBP"])
def test_other_formats_skip_the_patch(fmt):
    """PIL decodes these, so JAX composites them; so does the port, through
    its own decoders, bit for bit, colour and mask alike."""
    doc = {"aiPatches": [{"id": "z", "subMasks": RADIAL,
                          "patchData": {"color": url(photo(72, 104, 12), fmt)}},
                         {"id": "y", "patchData": {"color": url(photo(50, 70, 13), fmt),
                                                   "mask": url(mask_img(40, 60), fmt)}}]}
    img = canvas()
    want = jpatches.composite_patches_on_image(img, doc)
    assert not np.array_equal(want, img)
    got = ppatches.composite_patches_on_image(torch.from_numpy(img), doc)
    assert np.array_equal(got.numpy(), want)


def test_patches_through_apply_all_transformations():
    """The patches composite before the warp, turn and crop, at full res
    or at a preview's `patch_scale`, as JAX's `apply_all_transformations`."""
    doc = {"aiPatches": PATCHES["png_png"]() + PATCHES["submask"](),
           "rotation": 2.0, "orientationSteps": 1, "transformVertical": 8.0,
           "crop": {"x": 5, "y": 4, "width": 50, "height": 60}}
    img = canvas()
    for scale in (1.0, 0.5):
        want, woff = jtr.apply_all_transformations(jnp.asarray(img), doc, patch_scale=scale)
        got, goff = ptr.apply_all_transformations(torch.from_numpy(img), doc, patch_scale=scale)
        assert goff == woff and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_patched_document_exports_as_jax(tmp_path, monkeypatch):
    """export_images of a JPEG whose sidecar holds aiPatches (and a grade):
    the same JPEG file as JAX's, its develop run op by op."""
    root = tmp_path / "src"
    root.mkdir()
    Image.fromarray(photo(72, 104, 13)).save(root / "p.jpg", quality=92)
    doc = {"exposure": 0.3, "contrast": 15,
           "aiPatches": PATCHES["jpeg_jpeg_colour_mask"]() + PATCHES["submask"]()}
    (root / "p.jpg.rrdata").write_text(json.dumps({"version": 1, "adjustments": doc}))
    src = [str(root / "p.jpg")]
    with ldr_op_by_op(monkeypatch):
        want = jexport.export_images(src, tmp_path / "jax", jexport.ExportSettings())
    got = pexport.export_images(src, tmp_path / "port", pexport.ExportSettings(),
                                device="cpu")
    assert [(r.ok, r.error) for r in got] == [(r.ok, r.error) for r in want]
    assert got[0].ok
    a = open(got[0].output, "rb").read()
    b = open(want[0].output, "rb").read()
    assert a == b
