"""The port's thumbnails (rapidraw_tpu_torch/library/thumbnails.py), PIL's
u8 resizes it brings (geometry/resize.py) and `unwarp_image_geometry`
against the JAX package and PIL.

PIL: `resize_u8` (BILINEAR, BICUBIC, LANCZOS), `reduce_u8` and
`thumbnail_u8` give PIL's bytes on ragged sizes, modes "L" and "RGB".
`unwarp_image_geometry`: JAX's output bit for bit (the port follows its
float32 op order, roots in float64), and unwarp after warp gives back the
interior. Thumbnails, the cases of tests/test_library.py:106-451: equal
cache keys; unedited-LDR and embedded-preview thumbnails byte for byte
equal to JAX's; the RAW crop at the loaded scale; batched equal to serial;
isolation and cancel; app settings honoured. Edited thumbnails follow the
preview service's rule (tests/test_torch_service.py::_same_frames): each
u8 frame within 1 LSB on <= 0.1% of values of JAX's (run op by op, one
device), the JPEG bytes equal where the frames are. The port runs on the CPU.
"""

from __future__ import annotations

import io
import struct

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.geometry import params as jgeo
from rapidraw_tpu.geometry import warp as jwarp
from rapidraw_tpu.io import sidecar as jsidecar
from rapidraw_tpu.library import thumbnails as jthumbs
from rapidraw_tpu.utils import settings as jsettings
from rapidraw_tpu_torch.geometry import params as pgeo
from rapidraw_tpu_torch.geometry import resize
from rapidraw_tpu_torch.geometry import warp as pwarp
from rapidraw_tpu_torch.library import thumbnails as pthumbs
from rapidraw_tpu_torch.utils import recovery
from rapidraw_tpu_torch.utils import settings as psettings

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

_FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}


def _u8(shape, seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    ramp = np.linspace(0, 160, w)[None, :] + np.linspace(0, 60, h)[:, None]
    if len(shape) == 3:
        ramp = ramp[..., None]
    return np.clip(ramp + rng.integers(0, 96, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", list(_FILTERS))
def test_resize_u8_matches_pil(mode, name):
    for i, (h, w) in enumerate([(37, 53), (100, 61), (481, 719), (5, 3)]):
        a = _u8((h, w) if mode == "L" else (h, w, 3), i)
        im = Image.fromarray(a)
        for tw, th in [(17, 9), (w // 3 + 1, h // 2 + 1), (w * 2 - 3, h + 5), (1, 1), (w, h + 1)]:
            want = np.asarray(im.resize((tw, th), _FILTERS[name]))
            np.testing.assert_array_equal(resize.resize_u8(a, tw, th, name), want)
        box = (1.5, 2.25, w - 0.75, h - 1.0)
        want = np.asarray(im.resize((w // 2 + 1, h // 2 + 1), _FILTERS[name], box=box))
        np.testing.assert_array_equal(resize.resize_u8(a, w // 2 + 1, h // 2 + 1, name, box),
                                      want)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_reduce_u8_matches_pil(mode):
    for i, (h, w) in enumerate([(37, 53), (100, 61), (481, 719), (2, 9)]):
        a = _u8((h, w) if mode == "L" else (h, w, 3), i)
        for f in [(2, 2), (3, 3), (4, 1), (1, 5), (7, 3), (6, 6)]:
            want = np.asarray(Image.fromarray(a).reduce(f))
            np.testing.assert_array_equal(resize.reduce_u8(a, *f), want)


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("shape", [(2000, 3000), (481, 719), (719, 481), (64, 64), (33, 20)])
def test_thumbnail_u8_matches_pil(mode, shape):
    a = _u8(shape if mode == "L" else shape + (3,), 3)
    for size in [(720, 720), (64, 64), (30, 50), (shape[1], shape[0]), (3, 100)]:
        t = Image.fromarray(a)
        t.thumbnail(size)
        np.testing.assert_array_equal(resize.thumbnail_u8(a, size), np.asarray(t))


_UNWARP = {
    "rotate_scale": {"rotate": 7.5, "scale": 112.0},
    "manual_dist_pos": {"distortion": 35.0},
    "manual_dist_neg": {"distortion": -45.0},
    "lens_poly3": {"lens_dist_k1": -0.08, "lens_dist_k2": 0.02, "lens_dist_k3": -0.004,
                   "lens_distortion_amount": 0.7},
    "lens_ptlens": {"lens_model": 1, "lens_dist_k1": 0.015, "lens_dist_k2": -0.04,
                    "lens_dist_k3": 0.01, "lens_distortion_amount": 0.5},
    "everything": {"rotate": -4.0, "scale": 105.0, "aspect": 8.0, "vertical": -15000.0,
                   "horizontal": 10000.0, "x_offset": -2.0, "y_offset": 3.0,
                   "distortion": 20.0, "lens_dist_k1": -0.05, "lens_dist_k2": 0.01,
                   "lens_distortion_amount": 0.6},
}


@pytest.mark.parametrize("name", list(_UNWARP))
def test_unwarp_matches_jax(name):
    img = np.random.default_rng(1).random((3, 52, 76), dtype=np.float32)
    want = np.asarray(jwarp.unwarp_image_geometry(img, jgeo.GeometryParams(**_UNWARP[name])))
    got = pwarp.unwarp_image_geometry(torch.from_numpy(img),
                                      pgeo.GeometryParams(**_UNWARP[name])).numpy()
    np.testing.assert_array_equal(got, want)


def test_unwarp_inverts_warp_interior():
    yy, xx = np.mgrid[0:80, 0:100].astype(np.float32)
    img = torch.from_numpy(np.stack([xx / 100, yy / 80, (xx + yy) / 180]))
    p = pgeo.geometry_params_from_json({"transformDistortion": 20.0, "transformRotate": 3.0})
    restored = pwarp.unwarp_image_geometry(pwarp.warp_image_geometry(img, p), p)
    err = (restored[:, 25:55, 30:70] - img[:, 25:55, 30:70]).abs().max()
    assert float(err) < 0.02


# ---- thumbnails ------------------------------------------------------------

def _jpg(path, h=48, w=64, seed=0, quality=95):
    arr = _u8((h, w, 3), seed)
    Image.fromarray(arr).save(path, quality=quality)
    return str(path)


def _settings(mod, **kv):
    s = mod.AppSettings(mod.DEFAULTS)
    s.update(kv)
    return s


@pytest.fixture
def frames(monkeypatch):
    """Each side's u8 thumbnail frames; JAX with one device."""
    from rapidraw_tpu.pipeline import export as jexport
    from rapidraw_tpu_torch.pipeline import export as pexport

    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    got = {"jax": [], "port": []}

    def spy(real, key):
        def quantize(x):
            out = real(x)
            got[key].append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
            return out
        return quantize

    monkeypatch.setattr(jexport, "_device_u8", spy(jexport._device_u8, "jax"))
    monkeypatch.setattr(pexport, "device_u8", spy(pexport.device_u8, "port"))
    return got


def _same_frames(frames) -> bool:
    """tests/test_torch_service.py's rule on each thumbnail's frames (a
    batched chunk's frames arrive stacked)."""
    assert len(frames["port"]) == len(frames["jax"]) > 0
    exact = True
    for g, w in zip(frames["port"], frames["jax"]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert int(d.max()) <= 1 and (d > 0).mean() <= 1e-3
        exact = exact and not d.any()
    return exact


def test_cache_keys_match_jax(tmp_path):
    p = _jpg(tmp_path / "a.jpg")
    docs = [{}, {"exposure": 1.0}, {"masks": [{"visible": True}], "crop": {"x": 1}}]
    settings = [None, _settings(jsettings), _settings(jsettings, linearRawMode="on",
                                                       tonemapperOverrideEnabled=True)]
    psets = [None, _settings(psettings), _settings(psettings, linearRawMode="on",
                                                    tonemapperOverrideEnabled=True)]
    for path in (p, p + "?vc=2", str(tmp_path / "missing.jpg")):
        for doc in docs:
            for res in (240, 720):
                for js, ps in zip(settings, psets):
                    assert pthumbs.thumbnail_cache_key(path, doc, res, ps) == \
                        jthumbs.thumbnail_cache_key(path, doc, res, js)


@pytest.mark.parametrize("shape,res", [((48, 64), 32), ((300, 211), 120), ((90, 70), 200)])
def test_unedited_ldr_bytes_match_jax(tmp_path, shape, res):
    p = _jpg(tmp_path / "plain.jpg", *shape)
    want = jthumbs.generate_thumbnail(p, resolution=res, app_settings=_settings(jsettings))
    got = pthumbs.generate_thumbnail(p, resolution=res, app_settings=_settings(psettings),
                                     device="cpu")
    assert got == want


def test_unedited_ldr_skips_develop(tmp_path, monkeypatch):
    from rapidraw_tpu_torch.pipeline import batch, develop

    def boom(*a, **k):  # pragma: no cover - fails the test if reached
        raise AssertionError("develop must not run for unedited LDR thumbnails")

    monkeypatch.setattr(develop, "develop", boom)
    monkeypatch.setattr(batch, "develop_batch", boom)
    p = _jpg(tmp_path / "plain.jpg", 48, 64)
    assert pthumbs.generate_thumbnail(p, resolution=32, device="cpu")[:2] == b"\xff\xd8"
    assert set(pthumbs.generate_thumbnails([p, p + "?vc=1"], resolution=32, device="cpu")) == \
        {p, p + "?vc=1"}


def _cr3_with_preview(path, h=120, w=160):
    from rapidraw_tpu.io.cr3 import CANON_UUID

    buf = io.BytesIO()
    Image.fromarray(_u8((h, w, 3), 4)).save(buf, "JPEG")
    jpeg = buf.getvalue()

    def box(btype, payload):
        return struct.pack(">I", 8 + len(payload)) + btype + payload

    payload = (b"\0" * 4 + struct.pack(">HHH", 0, w, h) + b"\0\0"
               + struct.pack(">I", len(jpeg)) + jpeg)
    moov = box(b"moov", box(b"uuid", CANON_UUID + box(b"PRVW", payload)))
    ftyp = box(b"ftyp", b"crx " + b"\0\0\0\x01" + b"crx isom")
    path.write_bytes(ftyp + moov)
    return str(path)


@pytest.mark.parametrize("shape,res", [((120, 160), 64), ((600, 900), 100), ((50, 40), 720)])
def test_cr3_preview_fallback_bytes_match_jax(tmp_path, shape, res):
    p = _cr3_with_preview(tmp_path / "shot.cr3", *shape)
    want = jthumbs.generate_thumbnail(p, resolution=res, cache_dir=tmp_path / "cj",
                                      app_settings=_settings(jsettings))
    got = pthumbs.generate_thumbnail(p, resolution=res, cache_dir=tmp_path / "cp",
                                     app_settings=_settings(psettings), device="cpu")
    assert got == want and got[:2] == b"\xff\xd8"
    assert max(Image.open(io.BytesIO(got)).size) == min(res, max(shape))
    assert sorted(x.name for x in (tmp_path / "cp").iterdir()) == \
        sorted(x.name for x in (tmp_path / "cj").iterdir())


def test_raw_thumbnail_crop_uses_loaded_scale(tmp_path):
    from tests.test_raw_containers import _cfa_ifd, _pack_msb, build_tiff

    cfa = np.full((32, 64), 200, np.uint16)
    cfa[:, 32:] = 3800
    p = tmp_path / "t.dng"
    p.write_bytes(build_tiff([_cfa_ifd(64, 32, 12, 1, _pack_msb(cfa, 12))]))
    jsidecar.save_sidecar(p, {"adjustments": {
        "crop": {"x": 32, "y": 0, "width": 32, "height": 32}, "exposure": 0.01}})
    data = pthumbs.generate_thumbnail(str(p), resolution=64, device="cpu")
    thumb = np.asarray(Image.open(io.BytesIO(data)), np.float32) / 255.0
    assert thumb.mean() > 0.5, f"thumb mean {thumb.mean():.3f}: the wrong half was cropped"


def _edited_set(tmp_path, rng):
    paths = []
    for i in range(3):
        p = tmp_path / f"b{i}.jpg"
        Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)).save(p, quality=95)
        jsidecar.save_sidecar(p, {"adjustments": {"exposure": 0.3 + 0.2 * i,
                                                  "contrast": 10 * i, "toneMapper": "agx"}})
        paths.append(str(p))
    odd = tmp_path / "odd.jpg"
    Image.fromarray((rng.random((64, 40, 3)) * 255).astype(np.uint8)).save(odd, quality=95)
    jsidecar.save_sidecar(odd, {"adjustments": {"exposure": 0.5, "toneMapper": "agx",
                                                "masks": [{"visible": True, "subMasks": [{
                                                    "type": "radial", "visible": True,
                                                    "mode": "additive",
                                                    "parameters": {"centerX": 20, "centerY": 30,
                                                                   "radiusX": 15, "radiusY": 20,
                                                                   "feather": 0.5}}],
                                                    "adjustments": {"exposure": 1.0}}]}})
    return paths + [str(odd)]


def test_batched_matches_serial_and_progress(tmp_path, monkeypatch):
    monkeypatch.setattr(pthumbs, "_THUMB_BATCH", 2)  # a padded last chunk
    paths = _edited_set(tmp_path, np.random.default_rng(3))
    paths.insert(2, paths[0] + "?vc=1")
    settings = _settings(psettings)
    serial = {p: pthumbs.generate_thumbnail(p, resolution=32, app_settings=settings,
                                            device="cpu") for p in paths}
    ticks = []
    batched = pthumbs.generate_thumbnails(paths, resolution=32, app_settings=settings,
                                          progress=lambda d, n, p: ticks.append((d, n)),
                                          device="cpu")
    assert set(batched) == set(paths)
    for p in paths:
        assert batched[p] == serial[p], p
    n = len(paths)
    assert ticks == [(i, n) for i in range(1, n + 1)] + [(n, n)]


def test_edited_thumbnails_match_jax(tmp_path, frames):
    paths = _edited_set(tmp_path, np.random.default_rng(4))
    with jax.disable_jit():
        want = jthumbs.generate_thumbnails(paths, resolution=32,
                                           app_settings=_settings(jsettings))
    got = pthumbs.generate_thumbnails(paths, resolution=32, app_settings=_settings(psettings),
                                      device="cpu")
    assert set(got) == set(want) == set(paths)
    exact = _same_frames(frames)
    for p in paths:
        assert got[p][:2] == b"\xff\xd8" and (got[p] == want[p] or not exact)


def test_merged_bucket_matches_jax_and_a_serial_develop_under_it(tmp_path, frames):
    """Two same-shape documents, one turning on stages the other leaves off,
    share a bucket: each side develops both under the bucket's merged
    config. The port's batched thumbnail of the plain document equals its
    serial develop under that config byte for byte, and both sides' frames
    follow the service's rule."""
    from rapidraw_tpu.pipeline.batch import stack_params as jstack
    from rapidraw_tpu_torch.pipeline.batch import stack_params as pstack
    from rapidraw_tpu_torch.pipeline.develop import develop

    rng = np.random.default_rng(6)
    docs = [{"exposure": 0.4, "toneMapper": "agx"},
            {"exposure": 0.2, "toneMapper": "agx", "contrast": 25, "clarity": 40,
             "vibrance": 30, "vignetteAmount": -30}]
    paths = []
    for i, doc in enumerate(docs):
        p = tmp_path / f"m{i}.jpg"
        Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)).save(p, quality=95)
        jsidecar.save_sidecar(p, {"adjustments": doc})
        paths.append(str(p))
    psets, jsets = _settings(psettings), _settings(jsettings)
    preps = [pthumbs._prep_thumbnail(p, 32, app_settings=psets, device="cpu") for p in paths]
    jpreps = [jthumbs._prep_thumbnail(p, 32, app_settings=jsets) for p in paths]
    assert pthumbs._bucket_key(preps[0]) == pthumbs._bucket_key(preps[1])
    _, merged = pstack([q["params"] for q in preps], [q["cfg"] for q in preps], device="cpu")
    _, jmerged = jstack([q["params"] for q in jpreps], [q["cfg"] for q in jpreps])
    assert merged != preps[0]["cfg"] and jmerged != jpreps[0]["cfg"]

    with jax.disable_jit():
        want = jthumbs.generate_thumbnails(paths, resolution=32, app_settings=jsets)
    got = pthumbs.generate_thumbnails(paths, resolution=32, app_settings=psets, device="cpu")
    exact = _same_frames(frames)
    for p in paths:
        assert got[p] == want[p] or not exact
    under = develop(preps[0]["x"], preps[0]["params"], merged)
    assert got[paths[0]] == pthumbs._finish_thumbnail(under, None)


def test_isolation_and_cancel(tmp_path):
    good1, good2, bad = (tmp_path / n for n in ("g1.jpg", "g2.jpg", "bad.jpg"))
    for p in (good1, good2):
        Image.fromarray(np.full((16, 24, 3), 128, np.uint8)).save(p)
    bad.write_bytes(b"not a jpeg at all")
    out = pthumbs.generate_thumbnails([str(good1), str(bad), str(good2)], resolution=16,
                                      device="cpu")
    assert set(out) == {str(good1), str(good2)} and all(out.values())

    tok = recovery.CancellationToken()
    seen = []

    def progress(done, n, p):
        seen.append((done, p))
        if done == 1:
            tok.cancel()

    out2 = pthumbs.generate_thumbnails([str(good1), str(good2)], resolution=16, cancel=tok,
                                       progress=progress, device="cpu")
    assert len(out2) == 1 and len(seen) == 1


def test_app_settings_honoured(tmp_path):
    import json
    import os

    p = _jpg(tmp_path / "a.jpg", 64, 96)
    jsidecar.save_sidecar(p, {"adjustments": {"exposure": 0.8, "contrast": 30}})
    cache = tmp_path / "cache"
    default = pthumbs.generate_thumbnail(p, resolution=48, cache_dir=cache, device="cpu")
    data_dir = tmp_path / "_appdata"
    assert os.environ["RAPIDRAW_DATA_DIR"] == str(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    (data_dir / "settings.json").write_text(json.dumps({
        "tonemapperOverrideEnabled": True, "defaultNonRawTonemapper": "agx"}))
    overridden = pthumbs.generate_thumbnail(p, resolution=48, cache_dir=cache, device="cpu")
    assert overridden != default
    assert pthumbs.generate_thumbnail(p, resolution=48, cache_dir=cache, device="cpu") == \
        overridden
    assert len(list(cache.glob("*.jpg"))) == 2
    pthumbs.clear_thumbnail_cache(str(cache))
    assert cache.is_dir() and not list(cache.iterdir())


def test_default_device_is_the_card(tmp_path):
    """No device: the CUDA device, which this machine lacks; it fails."""
    assert not torch.cuda.is_available()
    p = _jpg(tmp_path / "a.jpg")
    with pytest.raises((RuntimeError, AssertionError)):
        pthumbs.generate_thumbnail(p, resolution=32)
