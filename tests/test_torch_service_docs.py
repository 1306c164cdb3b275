"""The port's preview service beyond tests/test_service.py's cases, held
to the JAX package's as tests/test_torch_service.py holds it (JAX op by op;
u8 frames within 1 LSB on <= 0.1%, JPEG bytes equal where the frames are): a masked document at an odd ROI
settled and under the interactive divisor, AI patches through the
service, a RAW source (its EXIF persisted into the sidecar), the
straightening guides' overlay, `torch.pow` against `jnp.power` in the
original preview, and one case against JAX's jitted develop under the
counted rule (<= 1 LSB on <= 0.1% of values, off the values where JAX's
two runs disagree).
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from rapidraw_tpu.pipeline import service as jservice
from rapidraw_tpu_torch.pipeline import service
from test_torch_service import (  # noqa: F401 - one_device is a fixture
    _jpg, _photo_jpg, _same_results, _same_scopes, _settings, _svc, both, one_device,
)

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("interactive", [False, True])
def test_masked_document_at_odd_roi(tmp_path, one_device, interactive):
    """Config 4's masks (linear, radial, brush) at an odd ROI of a
    non-square preview, settled and under the 'balanced' divisor (1.5):
    the crop is a strided view made contiguous once; the bitmaps are
    resampled nearest on the host."""
    p = _photo_jpg(tmp_path / "m.jpg", 150, 226, seed=3)
    doc = dict(chip_smoke.config4_doc(150, 226), **chip_smoke.CONFIG3_DOC)
    doc["masks"] = chip_smoke.config4_doc(150, 226)["masks"]
    roi = (0.31, 0.22, 0.37, 0.41)

    def run(api):
        svc = _svc(api, _settings(api, livePreviewQuality="balanced"))
        return [svc.render_preview(p, doc, interactive=interactive, roi=roi,
                                   compute_waveform=True)]

    want, got = both(one_device, run)
    _same_results(want, got, one_device)
    _same_scopes(got[0], one_device["port"][0], "waveform")
    w, h = (150, 100) if interactive else (226, 150)
    assert (got[0].full_width, got[0].full_height) == (w, h)
    assert got[0].roi == (int(0.31 * w), int(0.22 * h), int(0.37 * w), int(0.41 * h))


def _patch_doc(h, w):
    """Two visible patches: PNG colour + JPEG mask (colour, read as "L"),
    and a JPEG colour whose mask is rasterized from a radial subMask; one
    hidden patch."""
    import base64

    from test_torch_ldr import photo

    def url(img, fmt, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt, **kw)
        return f"data:image/{fmt.lower()};base64," + base64.b64encode(buf.getvalue()).decode()

    col = photo(h // 2, w // 2, 7)
    mask = np.zeros((h // 3, w // 3, 3), np.uint8)
    mask[h // 9:, : w // 5] = (250, 240, 230)
    return {"exposure": 0.2, "aiPatches": [
        {"id": "a", "visible": True,
         "patchData": {"color": url(col, "PNG"), "mask": url(mask, "JPEG", quality=92)}},
        {"id": "b", "visible": True, "patchData": {"color": url(photo(h, w, 8), "JPEG")},
         "subMasks": [{"type": "radial", "visible": True, "mode": "additive",
                       "parameters": {"centerX": w / 2, "centerY": h / 2, "radiusX": w / 4,
                                      "radiusY": h / 5, "feather": 0.3}}]},
        {"id": "c", "visible": False, "patchData": {"color": url(col, "PNG")}},
    ]}


def test_patches_through_the_service(tmp_path, one_device):
    p = _jpg(tmp_path / "ai.jpg", h=90, w=130)
    doc = _patch_doc(90, 130)

    def run(api):
        svc = _svc(api)
        return (svc.render_preview(p, doc), svc.render_uncropped_preview(p, doc),
                svc.render_original_preview(p, doc))

    want, got = both(one_device, run)
    _same_results(want, got, one_device)


def test_straightening_guides_overlay_matches_jax():
    """The port's overlay (its own Canny, Hough and lines) equals JAX's
    cv2 overlay on a photograph-like frame with tilted and axis-aligned
    edges, as u8 and as float input."""
    from rapidraw_tpu_torch.pipeline.guides import draw_straightening_guides
    from test_torch_guides import scene

    img = scene(240, 360, seed=5, noise=6)
    planar = np.ascontiguousarray(img.transpose(2, 0, 1))
    for x in (planar, planar.astype(np.float32) / 255.0):
        want = jservice._draw_straightening_guides(x)
        got = draw_straightening_guides(x)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert not np.array_equal(got, planar)  # lines were drawn


def test_raw_original_preview_pow(tmp_path):
    """render_original_preview's RAW look: torch.pow against jnp.power on
    the CPU over [0, 1] and a spread of values past it. They differ by one
    ulp on ~1.6% of these inputs (ROADMAP queue C); no value by more."""
    x = np.concatenate([np.linspace(0.0, 1.0, 1 << 20, dtype=np.float32),
                        np.random.default_rng(3).random(1 << 18).astype(np.float32) * 4.0])
    with jax.disable_jit():
        want = np.asarray(jnp.power(jnp.maximum(jnp.asarray(x), 0.0), 1.0 / 2.38))
    got = torch.pow(torch.clamp_min(torch.from_numpy(x), 0.0), 1.0 / 2.38).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert int(ulp.max()) <= 1 and (ulp > 0).mean() <= 0.02


def test_raw_previews(tmp_path, one_device):
    """A 16-bit DNG (its EXIF persisted into the sidecar on first load):
    the graded preview with CONFIG3_DOC under the divisor, and the
    original preview's gamma/contrast look."""
    from rapidraw_tpu.io import sidecar as jsidecar
    from rapidraw_tpu_torch.io import sidecar as psidecar

    cfa = chip_smoke.photo_cfa(96, 144, 64, 16383, 5)
    paths = {}
    for name in ("jax", "port"):
        paths[name] = tmp_path / name / "r.dng"
        paths[name].parent.mkdir()
        paths[name].write_bytes(chip_smoke.raw_dng_bytes(cfa, meta=chip_smoke.EXPORT_META))

    def run(api):
        p = str(paths[api.name])
        svc = _svc(api, _settings(api, livePreviewQuality="balanced"))
        return (svc.render_preview(p, chip_smoke.CONFIG3_DOC, interactive=True),
                svc.render_original_preview(p, {"rotation": 3.0}))

    want, got = both(one_device, run)
    _same_results(want, got, one_device)
    assert (got[0].width, got[0].height) == (96, 64)
    sj = jsidecar.load_sidecar(str(paths["jax"]))
    sp = psidecar.load_sidecar(str(paths["port"]))
    assert sp == sj and sp["exif"]["Make"] == chip_smoke.EXPORT_META["make"]
    assert (paths["port"].parent / "r.dng.rrdata").read_text() == \
        (paths["jax"].parent / "r.dng.rrdata").read_text()


def test_jitted_jax_service_within_the_counted_rule(tmp_path, one_device, monkeypatch):
    """JAX as it runs (jitted develop) against the port on config 3 at
    256 x 384: <= 1 LSB on <= 0.1% of the u8 values, off those where JAX's
    jitted and op-by-op frames differ; the op-by-op frame within the same
    rule (`_same_frames`)."""
    from rapidraw_tpu_torch.pipeline import export as pexport

    p = _photo_jpg(tmp_path / "j.jpg", 256, 384, seed=1)
    frames = []

    def spy(real):
        def quantize(x):
            out = real(x)
            frames.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
            return out
        return quantize

    monkeypatch.setattr(jservice, "_device_u8", spy(jservice._device_u8))
    monkeypatch.setattr(pexport, "device_u8", spy(pexport.device_u8))
    jservice.RenderService().render_preview(p, chip_smoke.CONFIG3_DOC)
    with jax.disable_jit():
        jservice.RenderService().render_preview(p, chip_smoke.CONFIG3_DOC)
    service.RenderService(device="cpu").render_preview(p, chip_smoke.CONFIG3_DOC)
    jit, eager, port = (f.astype(np.int16) for f in frames)
    assert port.shape == (3, 256, 384)
    d = np.abs(port - eager)
    assert int(d.max()) <= 1 and (d > 0).mean() <= 1e-3
    off = jit == eager  # the values where JAX's two runs agree
    d = np.abs(port - jit)[off]
    assert int(d.max()) <= 1 and (d > 0).mean() <= 1e-3
