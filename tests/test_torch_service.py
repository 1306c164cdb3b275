"""The port's preview service (rapidraw_tpu_torch/pipeline/service.py)
against the JAX package's (rapidraw_tpu/pipeline/service.py).

Every case of tests/test_service.py runs on both packages, the port on the
CPU (its kernels' plain versions) and JAX op by op (`jax.disable_jit`
around the call, one device: JAX's jitted develop differs from its own
op-by-op run in known places, ROADMAP queue C, and the port follows the
op-by-op numerics). Held: the u8 frames within 1 LSB on <= 0.1% of
values, and the JPEG bytes equal where the frames are (the port's encoder
writes PIL's bytes); equal `to_binary` headers, ROI tuples and
dimensions, scopes and mask bitmaps. The cases beyond test_service.py's are in tests/test_torch_service_docs.py.
The workers' coalescing and survival, the default device and
`guarded_backend_init` are the port's own.
"""

from __future__ import annotations

import io
import struct
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.geometry import params as jgeo
from rapidraw_tpu.pipeline import service as jservice
from rapidraw_tpu.utils import settings as jsettings
from rapidraw_tpu_torch.geometry import params as pgeo
from rapidraw_tpu_torch.pipeline import service
from rapidraw_tpu_torch.utils import recovery
from rapidraw_tpu_torch.utils import settings as psettings

jax.config.update("jax_platforms", "cpu")

JAX = types.SimpleNamespace(name="jax", mod=jservice, settings=jsettings, geo=jgeo, kw={})
PORT = types.SimpleNamespace(name="port", mod=service, settings=psettings, geo=pgeo,
                             kw={"device": "cpu"})


def _jpg(path, h=120, w=160, seed=0):
    arr = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=95)
    return str(path)


def _photo_jpg(path, h, w, seed=0):
    """A smooth photograph-like JPEG (the guides find its edges)."""
    from test_torch_ldr import photo

    Image.fromarray(photo(h, w, seed)).save(path, quality=95)
    return str(path)


def _svc(api, settings=None):
    return api.mod.RenderService(settings, **api.kw)


def _settings(api, **kv):
    s = api.settings.AppSettings(api.settings.DEFAULTS)
    s.update(kv)
    return s


@pytest.fixture
def one_device(monkeypatch):
    """JAX's plain single-device entries, as the port has one card; each
    side's u8 frames, as its service quantizes them."""
    from rapidraw_tpu_torch.pipeline import export as pexport

    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    frames = {"jax": [], "port": []}

    def spy(real, key):
        def quantize(x):
            out = real(x)
            frames[key].append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
            return out
        return quantize

    monkeypatch.setattr(jservice, "_device_u8", spy(jservice._device_u8, "jax"))
    monkeypatch.setattr(pexport, "device_u8", spy(pexport.device_u8, "port"))
    return frames


def both(frames, fn):
    """fn(api) on JAX op by op and on the port; (jax result, port result).
    `frames` (the `one_device` fixture) collects each side's u8 frames."""
    frames["jax"].clear()
    frames["port"].clear()
    with jax.disable_jit():
        want = fn(JAX)
    return want, fn(PORT)


def _same_frames(frames) -> bool:
    """Each render's u8 frame against JAX's: the same shape, <= 1 LSB on <=
    0.1% of values (the port's develop sits within an ulp or so of JAX's
    op-by-op XLA chain, which moves a few u8 values: ROADMAP queue C).
    True when every frame is equal."""
    assert len(frames["port"]) == len(frames["jax"]) > 0
    exact = True
    for g, w in zip(frames["port"], frames["jax"]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert int(d.max()) <= 1 and (d > 0).mean() <= 1e-3
        exact = exact and not d.any()
    return exact


def _res(r):
    """The comparable parts of a PreviewResult."""
    return (r.jpeg, r.to_binary()[:24], r.roi, r.width, r.height, r.full_width, r.full_height)


def _same_results(want, got, frames):
    """Headers, ROI tuples and dimensions equal; u8 frames by
    `_same_frames`; the JPEG bytes equal where every frame is (the port's
    encoder writes PIL's bytes)."""
    exact = _same_frames(frames)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, bytes):
            assert w[:2] == g[:2] == b"\xff\xd8" and (w == g or not exact)
        else:
            assert _res(w)[1:] == _res(g)[1:] and (w.jpeg == g.jpeg or not exact)
    return exact


def _same_scopes(res, frame, kind):
    """The port's scopes equal JAX's scope functions on the port's frame."""
    from rapidraw_tpu.analysis import scopes as jscopes

    want = getattr(jscopes, f"calculate_{kind}")(frame)
    got = getattr(res, kind)
    assert set(got) == set(want)
    for k, v in want.items():
        assert (got[k] is None and v is None) or np.array_equal(got[k], v), k


def _decode(jpeg) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(jpeg)))


# ---- tests/test_service.py's cases on both packages ------------------------------


def test_render_preview_basic(tmp_path, one_device):
    p = _jpg(tmp_path / "a.jpg")

    def run(api):
        svc = _svc(api)
        res = svc.render_preview(p, {"exposure": 1.0}, compute_histogram=True)
        return res, svc.render_preview(p, {"exposure": 1.0})

    want, got = both(one_device, run)
    _same_results(want, got, one_device)
    assert _decode(got[0].jpeg).shape == (120, 160, 3)
    _same_scopes(got[0], one_device["port"][0], "histogram")


def test_render_preview_downscales_and_interactive(tmp_path, one_device):
    p = _jpg(tmp_path / "b.jpg", h=300, w=400)

    def run(api):
        svc = _svc(api, _settings(api, editorPreviewResolution=200,
                                  livePreviewQuality="performance"))
        return svc.render_preview(p, {}), svc.render_preview(p, {}, interactive=True)

    want, got = both(one_device, run)
    _same_results(want, got, one_device)
    assert max(got[0].width, got[0].height) == 200
    assert max(got[1].width, got[1].height) == 100  # divisor 2


MASK_DOC = {
    "masks": [
        {"visible": True, "invert": False, "opacity": 100.0,
         "adjustments": {"exposure": 2.0},
         "subMasks": [{"type": "all", "visible": True, "mode": "additive"}]}
    ]
}


def test_render_preview_roi_and_masks(tmp_path, one_device):
    p = _jpg(tmp_path / "c.jpg", h=128, w=128)
    want, got = both(one_device, lambda api: [_svc(api).render_preview(p, MASK_DOC,
                                                           roi=(0.25, 0.25, 0.5, 0.5))])
    _same_results(want, got, one_device)
    assert got[0].roi == (32, 32, 64, 64) and (got[0].width, got[0].height) == (64, 64)


def test_service_tonemapper_override(tmp_path, one_device):
    p = _jpg(tmp_path / "d.jpg")
    want, got = both(one_device, lambda api: [_svc(api, _settings(
        api, tonemapperOverrideEnabled=True, defaultNonRawTonemapper="agx")).render_preview(p, {})])
    _same_results(want, got, one_device)


def test_uncropped_preview_ignores_crop(tmp_path, one_device):
    p = _jpg(tmp_path / "u.jpg")
    adj = {"exposure": 0.5, "crop": {"x": 20, "y": 10, "width": 80, "height": 60}}

    def run(api):
        svc = _svc(api)
        return svc.render_preview(p, adj), svc.render_uncropped_preview(p, adj)

    want, got = both(one_device, run)
    _same_results(want, got, one_device)
    assert _decode(got[0].jpeg).shape == (60, 80, 3)
    assert _decode(got[1]).shape == (120, 160, 3)


def test_original_preview_skips_grade(tmp_path, one_device):
    p = _jpg(tmp_path / "o.jpg")
    want, got = both(one_device, lambda api: [_svc(api).render_original_preview(p, {"exposure": 5.0})])
    _same_results(want, got, one_device)
    orig = np.asarray(Image.open(p), np.float32)
    assert abs(_decode(got[0]).astype(np.float32).mean() - orig.mean()) < 8.0


def test_geometry_preview_and_guides(tmp_path, one_device):
    p = _jpg(tmp_path / "g.jpg")

    def run(api):
        svc = _svc(api)
        gp = api.geo.GeometryParams(rotate=2.0)
        a = svc.preview_geometry_transform(p, gp, {"exposure": 0.2})
        b = svc.preview_geometry_transform(p, gp, {"exposure": 0.2}, show_lines=True)
        assert len(svc._geometry_base) == 1
        return a, b

    want, got = both(one_device, run)
    _same_results(want, got, one_device)


def test_preset_preview_small(tmp_path, one_device):
    p = _jpg(tmp_path / "pp.jpg", h=600, w=800)
    want, got = both(one_device, lambda api: [_svc(api).render_preset_preview(p, {"contrast": 40})])
    _same_results(want, got, one_device)
    assert max(_decode(got[0]).shape[:2]) == 400


def test_preview_binary_protocol(tmp_path, one_device):
    p = _jpg(tmp_path / "b.jpg")
    want, got = both(one_device, lambda api: [_svc(api).render_preview(p, {"exposure": 0.3},
                                                           roi=(0.25, 0.25, 0.5, 0.5))])
    _same_results(want, got, one_device)
    x, y, w, h, fw, fh = struct.unpack("<6I", got[0].to_binary()[:24])
    assert (fw, fh) == (160, 120) and (w, h) == (got[0].width, got[0].height)


def _red_blue(path, split=(slice(None), slice(0, 40))):
    arr = np.zeros((60, 80, 3), np.uint8)
    arr[:] = (30, 30, 220)
    arr[split] = (220, 30, 30)
    Image.fromarray(arr).save(path, quality=98)
    return str(path)


COLOR_DOC = {
    "exposure": 2.0,
    "masks": [{
        "name": "reds", "visible": True,
        "adjustments": {"exposure": 2.0},
        "subMasks": [{"type": "color", "visible": True, "mode": "additive",
                      "parameters": {"targetX": 10, "targetY": 30, "tolerance": 30}}],
    }],
}


def test_color_range_mask_resolves_warped_image(tmp_path, one_device):
    p = _red_blue(tmp_path / "cr.jpg")

    def run(api):
        svc = _svc(api)
        warped = svc._warped_for_masks(p, COLOR_DOC)
        masks = svc._masks(p, COLOR_DOC, 80, 60, 1.0, (0.0, 0.0), warped_image=warped)
        return warped, masks, svc.render_preview(p, COLOR_DOC)

    (jw, jm, jr), (pw, pm, pr) = both(one_device, run)
    assert pw.shape == (60, 80, 3) and np.array_equal(pw, jw)
    assert np.array_equal(pm, jm)
    assert pm[0][:, :35].mean() > 0.8 and pm[0][:, 45:].mean() < 0.1
    _same_results([jr], [pr], one_device)


def test_mask_cache_keyed_by_image_identity(tmp_path, one_device):
    pa = _red_blue(tmp_path / "a.jpg")
    pb = _red_blue(tmp_path / "b.jpg", (slice(0, 20), slice(0, 20)))
    adj = {"masks": [dict(COLOR_DOC["masks"][0], subMasks=[
        {"type": "color", "visible": True, "mode": "additive",
         "parameters": {"targetX": 10, "targetY": 10, "tolerance": 30}}])]}

    def run(api):
        svc = _svc(api)
        out = []
        for p in (pa, pb):
            out.append(svc._masks(p, adj, 80, 60, 1.0, (0.0, 0.0),
                                  warped_image=svc._warped_for_masks(p, adj)))
        return out

    (ja, jb), (ma, mb) = both(one_device, run)
    assert ma is not mb and float(np.abs(ma - mb).max()) > 0.5
    assert np.array_equal(ma, ja) and np.array_equal(mb, jb)


def test_device_u8_matches_host_encode_quantization():
    from rapidraw_tpu_torch.io.loader import to_uint8_hwc
    from rapidraw_tpu_torch.pipeline.export import device_u8

    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.random((3, 16, 16)).astype(np.float32),
        np.linspace(-0.2, 1.2, 768, dtype=np.float32).reshape(3, 16, 16),
    ], axis=1)
    via_device = device_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(via_device.transpose(1, 2, 0), to_uint8_hwc(x))
    np.testing.assert_array_equal(via_device, np.asarray(jservice._device_u8(x)))
    np.testing.assert_array_equal(to_uint8_hwc(via_device), to_uint8_hwc(x))


def test_geometry_preview_with_masked_document(tmp_path, one_device):
    p = _jpg(tmp_path / "gm.jpg")
    adj = {"exposure": 0.2, "masks": [{
        "visible": True, "invert": False, "opacity": 100.0,
        "adjustments": {"exposure": 2.0},
        "subMasks": [{"type": "radial", "visible": True, "mode": "additive",
                      "parameters": {"centerX": 80, "centerY": 60, "radiusX": 40,
                                     "radiusY": 30, "feather": 0.5}}]}]}
    want, got = both(one_device, lambda api: [_svc(api).preview_geometry_transform(
        p, api.geo.GeometryParams(rotate=2.0), adj)])
    _same_results(want, got, one_device)


def _radial_doc(exposure, radius_x=40):
    return {"masks": [{
        "visible": True, "invert": False, "opacity": 100.0,
        "adjustments": {"exposure": exposure},
        "subMasks": [{"type": "radial", "visible": True, "mode": "additive",
                      "parameters": {"centerX": 80, "centerY": 60, "radiusX": radius_x,
                                     "radiusY": 30, "feather": 0.5}}]}]}


def test_mask_cache_ignores_grading_changes(tmp_path, monkeypatch, one_device):
    """A masked-slider scrub hits the bitmap cache; a geometry change of the
    mask does not. The frames equal JAX's."""
    import rapidraw_tpu.masks.rasterize as jrast
    import rapidraw_tpu_torch.masks.rasterize as prast

    p = _jpg(tmp_path / "mc.jpg")
    calls = {}
    for name, mod in (("jax", jrast), ("port", prast)):
        def counting(*a, _real=mod.rasterize_masks, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, "rasterize_masks", counting)

    def run(api):
        svc = _svc(api)
        out = [svc.render_preview(p, _radial_doc(0.5))]
        assert calls[api.name] == 1
        out.append(svc.render_preview(p, _radial_doc(1.5)))  # grading change only
        assert calls[api.name] == 1
        out.append(svc.render_preview(p, _radial_doc(1.5, radius_x=70)))
        assert calls[api.name] == 2
        return out

    want, got = both(one_device, run)
    _same_results(want, got, one_device)


def _cube(path):
    lines = ["LUT_3D_SIZE 2"]
    for b in (0.0, 1.0):
        for g in (0.0, 1.0):
            for r in (0.0, 1.0):
                lines.append(f"{r:.1f} {g:.1f} {b:.1f}")
    path.write_text("\n".join(lines))
    return lines


def test_lut_cached_across_renders(tmp_path, monkeypatch, one_device):
    import os

    import rapidraw_tpu.io.lut as jlut
    import rapidraw_tpu_torch.io.lut as plut

    cube = tmp_path / "t.cube"
    lines = _cube(cube)
    calls = {}
    for name, mod in (("jax", jlut), ("port", plut)):
        def counting(path, _real=mod.parse_lut_file, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(path)

        monkeypatch.setattr(mod, "parse_lut_file", counting)
    p = _jpg(tmp_path / "l.jpg")
    adj = {"lutPath": str(cube), "lutAmount": 80, "exposure": 0.1}

    def run(api):
        svc = _svc(api)
        out = [svc.render_preview(p, adj), svc.render_preview(p, dict(adj, exposure=0.6))]
        assert calls[api.name] == 1
        cube.write_text("\n".join(lines))
        os.utime(cube, ns=(1, 1 if api.name == "jax" else 2))  # a new mtime invalidates
        out.append(svc.render_preview(p, dict(adj, exposure=0.9)))
        assert calls[api.name] == 2
        return out

    want, got = both(one_device, run)
    _same_results(want, got, one_device)


def test_roi_accepts_struct_spelling(tmp_path, one_device):
    p = _jpg(tmp_path / "roi.jpg")
    adj = {"exposure": 0.3}

    def run(api):
        svc = _svc(api)
        a = svc.render_preview(p, adj, interactive=True, roi=[0.25, 0.25, 0.5, 0.5])
        b = svc.render_preview(p, adj, interactive=True,
                               roi={"x": 0.25, "y": 0.25, "width": 0.5, "height": 0.5})
        assert a.jpeg == b.jpeg and a.roi == b.roi
        with pytest.raises(ValueError, match="roi dict"):
            svc.render_preview(p, adj, interactive=True, roi={"x": 0.2, "y": 0.2})
        return a, b

    want, got = both(one_device, run)
    _same_results(want, got, one_device)


# ---- the port's own: workers, device, crash flag --------------------------------


def test_preview_worker_coalesces(tmp_path):
    """Drain-to-latest: jobs submitted while busy replace each other
    (lib.rs:650-683); the last job submitted renders last."""
    p = _jpg(tmp_path / "img.jpg", h=24, w=32)
    svc = service.RenderService(device="cpu")
    results = []
    done = threading.Event()

    def cb(r):
        results.append(r)
        done.set()

    worker = service.PreviewWorker(svc, cb)
    worker.submit(p, {"exposure": 0.1})
    assert done.wait(120)
    done.clear()
    for i in range(8):
        worker.submit(p, {"exposure": 0.1 * i})
    deadline = time.time() + 120
    while time.time() < deadline:
        with worker._cond:
            idle = worker._pending is None
        if idle and done.is_set():
            time.sleep(0.2)
            with worker._cond:
                if worker._pending is None:
                    break
    worker.close()
    assert all(not isinstance(r, Exception) for r in results), results
    assert 2 <= len(results) < 9
    last = svc.render_preview(p, {"exposure": 0.7})
    assert results[-1].jpeg == last.jpeg


def test_analytics_worker(tmp_path):
    got = []
    done = threading.Event()

    def cb(r):
        got.append(r)
        done.set()

    w = service.AnalyticsWorker(cb)
    img = np.random.default_rng(0).random((3, 32, 48)).astype(np.float32)
    w.submit(img)
    assert done.wait(60)
    w.close()
    from rapidraw_tpu.analysis.scopes import calculate_histogram

    assert not isinstance(got[0], Exception)
    want = calculate_histogram(img)
    assert all(np.array_equal(got[0]["histogram"][k], want[k]) for k in want)
    assert "waveform" in got[0]


def test_workers_survive_raising_callbacks(tmp_path):
    p = _jpg(tmp_path / "wk.jpg")
    svc = service.RenderService(device="cpu")
    got = []

    def bad_then_good(r):
        got.append(r)
        if len(got) == 1:
            raise RuntimeError("embedder bug")

    pw = service.PreviewWorker(svc, bad_then_good)
    pw.submit(p, {"exposure": 0.2})
    for _ in range(100):
        if got:
            break
        time.sleep(0.1)
    pw.submit(p, {"exposure": 0.6})
    for _ in range(100):
        if len(got) >= 2:
            break
        time.sleep(0.1)
    pw.close()
    assert len(got) == 2 and all(hasattr(r, "jpeg") for r in got)

    seen = []

    def scope_cb(s):
        seen.append(s)
        raise RuntimeError("embedder bug")

    aw = service.AnalyticsWorker(scope_cb)
    aw.submit(np.zeros((3, 16, 24), np.float32))
    for _ in range(100):
        if seen:
            break
        time.sleep(0.1)
    aw.submit(np.ones((3, 16, 24), np.float32))
    for _ in range(100):
        if len(seen) >= 2:
            break
        time.sleep(0.1)
    aw.close()
    assert len(seen) == 2 and all("histogram" in s for s in seen)


def test_worker_reports_a_failed_render(tmp_path):
    svc = service.RenderService(device="cpu")
    got = []
    done = threading.Event()
    pw = service.PreviewWorker(svc, lambda r: (got.append(r), done.set()))
    pw.submit(str(tmp_path / "missing.jpg"), {})
    assert done.wait(30)
    pw.close()
    assert isinstance(got[0], Exception)


def test_service_defaults_to_the_card(tmp_path, monkeypatch):
    """RenderService() keeps its images on CUDA: the loader is asked for
    the CUDA device, and on a machine without a card the render raises
    rather than falling back to the CPU. device='cpu' is honoured."""
    from rapidraw_tpu_torch.io import loader

    p = _jpg(tmp_path / "dev.jpg", h=16, w=24)
    asked = []
    real = loader.load_image

    def spy(path, app_settings=None, fast=False, device=None):
        asked.append(device)
        return real(path, app_settings=app_settings, fast=fast, device=device)

    monkeypatch.setattr(loader, "load_image", spy)
    assert service.RenderService().device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            service.RenderService().render_preview(p, {})
    svc = service.RenderService(device="cpu")
    svc.render_preview(p, {})
    assert [torch.device(d).type for d in asked] == ["cuda", "cpu"]
    (x, *_), = [v for k, v in svc._transformed._d.items()]
    assert x.device.type == "cpu" and svc.is_image_cached(p)
    svc.clear_caches()
    assert not svc.is_image_cached(p)


def test_stage_split_only_when_asked(tmp_path):
    """`time_stages` splits a render's time by stage; off (the default),
    a render takes no marks and its result has no stages. The frame is
    the same either way."""
    p = _jpg(tmp_path / "st.jpg", h=24, w=32)
    svc = service.RenderService(device="cpu")
    off = svc.render_preview(p, {"exposure": 0.4}, roi=(0.25, 0.25, 0.5, 0.5))
    assert off.stages is None
    svc.time_stages = True
    on = svc.render_preview(p, {"exposure": 0.4}, roi=(0.25, 0.25, 0.5, 0.5),
                            compute_histogram=True)
    assert list(on.stages) == ["masks", "divisor_roi", "parse", "develop", "readback",
                               "scopes", "encode"]  # the transformed preview was cached
    assert all(v >= 0.0 for v in on.stages.values()) and on.jpeg == off.jpeg
    svc.clear_caches()
    cold = svc.render_preview(p, {"exposure": 0.4})
    assert list(cold.stages)[:2] == ["load", "transform"]


def test_guarded_backend_init_never_falls_back(tmp_path, monkeypatch):
    """A crash flag left by a run that died in CUDA's initialization makes
    the next run raise and name the flag (JAX pins the CPU instead);
    device='cpu' runs without touching it; a clean run leaves no flag."""
    monkeypatch.setenv("RAPIDRAW_CACHE_DIR", str(tmp_path))
    flag = tmp_path / "backend_crash_flag"
    flag.write_text("init")
    with pytest.raises(recovery.BackendCrashFlag, match=str(flag)):
        recovery.guarded_backend_init()
    assert flag.exists()
    assert recovery.guarded_backend_init(device="cpu") == "cpu"
    flag.unlink()
    if torch.cuda.is_available():
        assert recovery.guarded_backend_init() == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recovery.guarded_backend_init()
    assert not flag.exists()


def test_settings_match_jax(tmp_path):
    """The preview settings' accessors and files equal JAX's."""
    s = psettings.AppSettings(psettings.DEFAULTS, livePreviewQuality="balanced",
                              editorPreviewResolution=None)
    j = jsettings.AppSettings(jsettings.DEFAULTS, livePreviewQuality="balanced",
                              editorPreviewResolution=None)
    for attr in ("editor_preview_resolution", "thumbnail_resolution", "image_cache_size"):
        assert getattr(s, attr) == getattr(j, attr)
    assert [s.preview_quality(b) for b in (False, True)] == \
        [j.preview_quality(b) for b in (False, True)]
    assert psettings.LIVE_PREVIEW_QUALITY == jsettings.LIVE_PREVIEW_QUALITY
    s.save(tmp_path / "p.json")
    j.save(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert psettings.AppSettings.load(tmp_path / "j.json") == \
        jsettings.AppSettings.load(tmp_path / "j.json")
    for env, value in (("RAPIDRAW_DATA_DIR", tmp_path / "data"), ("XDG_DATA_HOME", tmp_path)):
        with pytest.MonkeyPatch.context() as m:
            m.delenv("RAPIDRAW_DATA_DIR", raising=False)
            m.setenv(env, str(value))
            assert psettings.app_data_dir() == jsettings.app_data_dir()
            assert psettings.app_data_dir().is_dir()
