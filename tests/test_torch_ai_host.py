"""The host side of the AI port against the JAX package's, on the CPU:
the euclidean distance transform and grow_mask bit for bit, the
one-component JPEG byte for byte against PIL's "L" save, the data URL's
decoded mask, the HTTP connector against a local middleware (both
clients, the same requests and the same patch), generative replace
through it, the prompt un-projection, the registry and the
ModelUnavailable messages of every entry, the same as JAX's."""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.ai import connector as jconn
from rapidraw_tpu.ai import denoise as jdn
from rapidraw_tpu.ai import depth as jdepth
from rapidraw_tpu.ai import inpaint as jinp
from rapidraw_tpu.ai import masks as jmasks
from rapidraw_tpu.ai import models as jmodels
from rapidraw_tpu.ai import sam as jsam
from rapidraw_tpu.ai import tiled_inference as jtiled
from rapidraw_tpu_torch import native
from rapidraw_tpu_torch.ai import connector, denoise, depth, inpaint, masks, models, sam
from rapidraw_tpu_torch.ai import tiled_inference

torch.set_num_threads(2)


def blobs(h=60, w=80, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(6):
        y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(2, 9)
        yy, xx = np.mgrid[0:h, 0:w]
        m[(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = 255
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_edt_and_grow_mask_bit_for_bit(seed):
    m = blobs(seed=seed)
    assert np.array_equal(masks.euclidean_distance_transform(m),
                          jmasks.euclidean_distance_transform(m))
    assert np.array_equal(masks._edt_1d_sq(np.where(m > 0, 0.0, 1e12)[:5]),
                          jmasks._edt_1d_sq(np.where(m > 0, 0.0, 1e12)[:5]))
    for px in (0, 3.5, -2.0, 11):
        assert np.array_equal(masks.grow_mask(m, px), jmasks.grow_mask(m, px)), px


@pytest.mark.parametrize("shape", [(1, 1), (7, 9), (8, 16), (61, 83), (128, 128), (241, 319)])
@pytest.mark.parametrize("quality", [92, 1, 50, 100])
def test_grey_jpeg_is_pils_l_save(shape, quality):
    """SOF0 with one component, the luminance table, DC0/AC0 only, edge
    blocks replicated: the bytes PIL's libjpeg writes for mode "L"."""
    h, w = shape
    rng = np.random.default_rng(h * w + quality)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.clip((xx * 3 + yy * 2) % 256 + rng.integers(-12, 12, (h, w)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a, mode="L").save(buf, format="JPEG", quality=quality)
    assert native.jpeg_encode(a, quality) == buf.getvalue()


def test_mask_data_url_decodes_to_the_mask():
    m = blobs(seed=2)
    ours, theirs = masks.mask_to_data_url(m), jmasks.mask_to_data_url(m)
    assert ours.startswith("data:image/png;base64,")
    decode = lambda url: np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",")[1]))))  # noqa: E731
    assert np.array_equal(decode(ours), m) and np.array_equal(decode(theirs), m)


class _Middleware(BaseHTTPRequestHandler):
    """The inpainting middleware: /health, /upload_source, /inpaint (404
    until the source is uploaded); it keeps what each client sent."""

    sources: set = set()
    reply = ("PNG", {})  # the inpainted crop's format and save options
    received: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        self.send_response(200 if self.path == "/health" else 404)
        self.end_headers()

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if self.path == "/upload_source":
            sid = body.split(b'name="source_id"\r\n\r\n')[1].split(b"\r\n")[0].decode()
            jpeg = body.split(b"Content-Type: image/jpeg\r\n\r\n")[1].rsplit(b"\r\n--", 1)[0]
            _Middleware.sources.add(sid)
            _Middleware.received.append(("upload", jpeg))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"{}")
            return
        payload = json.loads(body)
        if payload["prompt"] == "fail":
            self.send_response(500)
            self.end_headers()
            self.wfile.write(b"boom")
            return
        if payload["source_id"] not in _Middleware.sources:
            self.send_response(404)
            self.end_headers()
            return
        _Middleware.received.append(("mask", payload["mask_image_base64"]))
        rgba = np.zeros((10, 12, 4), np.uint8)
        rgba[..., 0] = 200
        rgba[..., 1] = np.arange(12) * 20
        rgba[..., 3] = np.arange(10)[:, None] * 25
        buf = io.BytesIO()
        fmt, kw = _Middleware.reply
        Image.fromarray(rgba, "RGBA").save(buf, format=fmt, **kw)
        resp = {"x": -3, "y": 20, "color": base64.b64encode(buf.getvalue()).decode()}
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(json.dumps(resp).encode())


@pytest.fixture
def middleware():
    srv = HTTPServer(("127.0.0.1", 0), _Middleware)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Middleware.sources = set()
    _Middleware.received = []
    _Middleware.reply = ("PNG", {})
    yield f"127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def test_connector_matches_jax(middleware, tmp_path):
    src = tmp_path / "s.jpg"
    src.write_bytes(b"x")
    rng = np.random.default_rng(3)
    img = rng.random((3, 24, 32)).astype(np.float32)
    mask = blobs(24, 32, seed=3)
    assert connector.check_status(middleware) == jconn.check_status(middleware) is True
    assert connector.check_status("127.0.0.1:1") is False
    assert connector.generate_source_id(str(src)) == jconn.generate_source_id(str(src))
    want = jconn.process_inpainting(f"http://{middleware}", str(src), img, mask, "a red box")
    jax_sent = list(_Middleware.received)
    _Middleware.sources.clear()
    _Middleware.received.clear()
    got = connector.process_inpainting(f"http://{middleware}", str(src), torch.from_numpy(img),
                                       mask, "a red box")
    assert got.shape == want.shape == (4, 24, 32) and got.dtype == np.uint8
    assert np.array_equal(got, want)  # the crop clipped at the canvas's left and bottom edges
    port_sent = list(_Middleware.received)
    assert [k for k, _ in port_sent] == [k for k, _ in jax_sent] == ["upload", "mask"]
    assert port_sent[0][1] == jax_sent[0][1]  # the uploaded JPEG, byte for byte
    decode = lambda b: np.asarray(Image.open(io.BytesIO(base64.b64decode(b))))  # noqa: E731
    assert np.array_equal(decode(port_sent[1][1]), decode(jax_sent[1][1]))
    with pytest.raises(RuntimeError, match="AI generation failed"):
        connector.process_inpainting(f"http://{middleware}", str(src), img, mask, "fail")


@pytest.mark.parametrize("fmt,kw", [("WEBP", {"lossless": True}), ("WEBP", {"quality": 70}),
                                    ("GIF", {}), ("BMP", {}), ("TGA", {})],
                         ids=["webp-lossless", "webp-lossy", "gif", "bmp", "tga"])
def test_connector_reply_formats_match_jax(middleware, tmp_path, fmt, kw):
    """A reply image in another format PIL opens: the port composites it
    as JAX does (io/image_decode.py)."""
    src = tmp_path / "s.jpg"
    src.write_bytes(b"x")
    img = np.random.default_rng(5).random((3, 24, 32)).astype(np.float32)
    mask = blobs(24, 32, seed=5)
    _Middleware.reply = (fmt, kw)
    want = jconn.process_inpainting(f"http://{middleware}", str(src), img, mask, "a box")
    _Middleware.sources.clear()
    got = connector.process_inpainting(f"http://{middleware}", str(src), torch.from_numpy(img),
                                       mask, "a box")
    assert got.shape == want.shape == (4, 24, 32) and np.array_equal(got, want)


def test_replace_patch_through_the_connector_matches_jax(middleware, tmp_path):
    img = np.random.default_rng(4).random((3, 40, 48)).astype(np.float32)
    patch = {"visible": True, "prompt": "sky", "subMasks": [{
        "type": "radial", "visible": True, "mode": "additive",
        "parameters": {"centerX": 10, "centerY": 28, "radiusX": 12, "radiusY": 9,
                       "feather": 0.3}}]}
    kw = dict(use_fast_inpaint=False, connector_url=f"http://{middleware}",
              source_path=str(tmp_path / "p.jpg"))
    want = jinp.generate_replace_patch(img, patch, **kw)
    _Middleware.sources.clear()
    got = inpaint.generate_replace_patch(img, patch, device="cpu", **kw)
    assert got == want
    with pytest.raises(ValueError, match="no generative backend"):
        inpaint.generate_replace_patch(img, patch, use_fast_inpaint=False, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"rotation": 17.0}, {"flip_horizontal": True},
                                {"flip_vertical": True, "orientation_steps": 1},
                                {"orientation_steps": 2}, {"orientation_steps": 3,
                                                           "rotation": -8.0}])
def test_unproject_prompt_rect_matches_jax(kw):
    args = ((12.5, 30.0), (70.0, 44.0), 120, 90)
    assert sam.unproject_prompt_rect(*args, **kw) == jsam.unproject_prompt_rect(*args, **kw)


def test_registry_matches_jax(tmp_path, monkeypatch):
    assert set(models.MODELS) == set(jmodels.MODELS)
    for k, spec in models.MODELS.items():
        j = jmodels.MODELS[k]
        assert (spec.name, spec.filename, spec.url, spec.sha256, spec.weights_file) == \
            (j.name, j.filename, j.url, j.sha256, j.weights_file)
    monkeypatch.setenv("RAPIDRAW_MODELS_DIR", str(tmp_path))
    assert models.models_dir() == jmodels.models_dir()
    with pytest.raises(models.ModelUnavailable) as a:
        models.model_path("u2net_foreground")
    with pytest.raises(jmodels.ModelUnavailable) as b:
        jmodels.model_path("u2net_foreground")
    assert str(a.value) == str(b.value)
    (tmp_path / "u2net.onnx").write_bytes(b"onnx")
    assert models.model_path("u2net_foreground") == jmodels.model_path("u2net_foreground")
    with pytest.raises(models.ModelUnavailable, match="onnxruntime is not available"):
        models.get_session("u2net_foreground")
    for a, b in ((tiled_inference.select_tile_params(q), jtiled.select_tile_params(q))
                 for q in (0.0, 0.25, 0.5, 0.75, 1.0)):
        assert (a.cs, a.ucs, a.overlap, a.pad) == (b.cs, b.ucs, b.overlap, b.pad)


def _jax_entries():
    img = np.zeros((3, 20, 24), np.float32)
    mask = np.zeros((20, 24), np.uint8)
    mask[5:9, 5:9] = 255
    emb = jsam.ImageEmbeddings(np.zeros((1, 4, 4, 32), np.float32), (24, 20))
    return {
        "fg": lambda: jmasks.generate_foreground_mask(img),
        "sky": lambda: jmasks.generate_sky_mask(img),
        "depth": lambda: jdepth.generate_depth_map(img),
        "sam_enc": lambda: jsam.generate_image_embeddings(img),
        "sam_dec": lambda: jsam.run_sam_decoder(emb, (1, 1), (9, 9)),
        "denoise": lambda: jdn.denoise_ai(img),
        "lama": lambda: jinp.run_lama_inpainting(img, mask),
    }


def _port_entries():
    img = np.zeros((3, 20, 24), np.float32)
    mask = np.zeros((20, 24), np.uint8)
    mask[5:9, 5:9] = 255
    emb = sam.ImageEmbeddings(torch.zeros((1, 4, 4, 32)), (24, 20))
    return {
        "fg": lambda: masks.generate_foreground_mask(img, device="cpu"),
        "sky": lambda: masks.generate_sky_mask(img, device="cpu"),
        "depth": lambda: depth.generate_depth_map(img, device="cpu"),
        "sam_enc": lambda: sam.generate_image_embeddings(img, device="cpu"),
        "sam_dec": lambda: sam.run_sam_decoder(emb, (1, 1), (9, 9)),
        "denoise": lambda: denoise.denoise_ai(img, device="cpu"),
        "lama": lambda: inpaint.run_lama_inpainting(img, mask, device="cpu"),
    }


@pytest.mark.parametrize("entry", list(_port_entries()))
def test_missing_weights_raise_jaxs_message(entry, tmp_path, monkeypatch):
    monkeypatch.setenv("RAPIDRAW_MODELS", str(tmp_path))
    with pytest.raises(models.ModelUnavailable) as got:
        _port_entries()[entry]()
    with pytest.raises(jmodels.ModelUnavailable) as want:
        _jax_entries()[entry]()
    assert str(got.value) == str(want.value)
    assert str(tmp_path) in str(got.value)


def test_precompute_skips_filled_and_other_sub_masks(tmp_path, monkeypatch):
    """A sub-mask that carries its data URL, and a non-AI one, run nothing
    (no weights are there to run)."""
    monkeypatch.setenv("RAPIDRAW_MODELS", str(tmp_path))
    doc = {"masks": [{"visible": True, "subMasks": [
        {"type": "ai-sky", "parameters": {"maskDataBase64": "data:image/png;base64,AAAA"}},
        {"type": "radial", "parameters": {}}, "not a sub-mask"]}, "not a mask"]}
    img = np.zeros((3, 8, 8), np.float32)
    assert masks.precompute_ai_submasks(doc, img, device="cpu") == \
        jmasks.precompute_ai_submasks(doc, img)
