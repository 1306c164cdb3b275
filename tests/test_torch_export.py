"""The port's batch export (pipeline/export.py) against the JAX package's.

Sources are 16-bit DNGs with a preview IFD0 and capture metadata
(`chip_smoke.raw_dng_bytes(meta=EXPORT_META)`, GPS included), since the
port loads no LDR file yet, with `.rrdata` sidecars; the port runs on the
CPU (its kernels' plain versions).

- Against JAX with its develop run op by op (the port follows JAX's
  op-by-op numerics): the same file names and results, JPEG files byte for
  byte, EXIF included; 16-bit TIFF and PNG pixels within 1e-3 + 1/65535;
  the same tags read back by PIL (GPS stripped, Orientation 1); the same
  mtimes with `preserve_timestamps`; the same size estimate.
- A 1024 x 1536 DNG with config 3 against JAX's jitted export (how JAX
  runs it): its jitted develop differs from its own op-by-op run (fused
  arithmetic flips a gate on a few pixels, see tests/test_torch_slice.py),
  so the pixels whose 16-bit TIFF values moved past 1e-3 + 1/65535 are
  counted (<= 0.1%, the develop's bar). Each JPEG is PIL's file of its
  package's u8 frame; decoded by PIL they agree to 1 LSB on >= 99.9% of
  values and exactly outside the 16 x 16 blocks (MCUs) where the frames
  differ and their neighbours (a 1-LSB frame difference can move a
  quantized coefficient, and its block by more than 3 LSB).
- test_export_pipeline.py's cases (budgets, the bounded window, error
  isolation, cancellation, mixed-document buckets) on both packages.
"""

from __future__ import annotations

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from rapidraw_tpu.io import encode as jencode
from rapidraw_tpu.io import exif as jexif
from rapidraw_tpu.pipeline import export as jexport
from rapidraw_tpu.pipeline import watermark as jwatermark
from rapidraw_tpu.utils.recovery import CancellationToken
from rapidraw_tpu_torch.io import loader
from rapidraw_tpu_torch.pipeline import export

jax.config.update("jax_platforms", "cpu")

META = chip_smoke.EXPORT_META
TIFF_TOL = 1e-3 + 1 / 65535  # the develop's 1e-3 plus one step of the u16 rounding


def make_sources(root, docs, w=96, h=64, seed=0, content="random") -> list[str]:
    """One DNG (+ sidecar) per document, names img_000.dng ..."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, doc in enumerate(docs):
        cfa = (chip_smoke.photo_cfa(h, w, 64, 16383, seed + i) if content == "photo"
               else rng.integers(64, 16383, (h, w), dtype=np.uint16))
        p = root / f"img_{i:03d}.dng"
        p.write_bytes(chip_smoke.raw_dng_bytes(cfa, meta=META))
        (root / f"{p.name}.rrdata").write_text(json.dumps({"version": 1, "adjustments": doc}))
        paths.append(str(p))
    return paths


@contextlib.contextmanager
def op_by_op(monkeypatch):
    """JAX's develop run op by op on one device: jax.disable_jit holds in
    the thread that enters it, export's render loop (JAX's loader runs
    jitted in the prepare threads, and equals the port's on these
    sources), and one device takes JAX's plain develop entry, as the port
    has one card, instead of the mesh of the tests' eight virtual CPU
    devices (op by op, a sharded develop takes minutes)."""
    with monkeypatch.context() as m:
        m.setattr(jax, "device_count", lambda *a: 1)
        with jax.disable_jit():
            yield


def pixels(path) -> np.ndarray:
    """u8 JPEG / PNG-8 or u16 TIFF / PNG-16 values as int64."""
    if str(path).endswith((".tif", ".tiff")):
        return jencode.read_tiff16_rgb(path).astype(np.int64)
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1].astype(np.int64)


DOCS = [{"exposure": 0.4}, {"contrast": 30, "saturation": 12}, chip_smoke.CONFIG3_DOC]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("src")
    paths = make_sources(root, DOCS)
    return paths + [paths[0] + "?vc=2"]


@pytest.mark.parametrize("fmt", ["jpeg", "tiff", "png"])
def test_export_matches_jax_op_by_op(fmt, sources, tmp_path, monkeypatch):
    kw = dict(format=fmt, batch_size=2, preserve_timestamps=True)
    with op_by_op(monkeypatch):
        want = jexport.export_images(sources, tmp_path / "jax", jexport.ExportSettings(**kw))
    got = export.export_images(sources, tmp_path / "port", export.ExportSettings(**kw),
                               device="cpu")
    assert [(r.source, r.ok, r.error) for r in got] == [(r.source, r.ok, r.error) for r in want]
    assert all(r.ok for r in got)
    assert [os.path.relpath(r.output, tmp_path / "port") for r in got] == \
        [os.path.relpath(r.output, tmp_path / "jax") for r in want]
    assert os.path.basename(got[-1].output) == f"img_000_edited_VC02.{'jpg' if fmt == 'jpeg' else fmt}"
    for g, w in zip(got, want):
        tags = jexif.read_exif_tags(g.output)
        assert tags == jexif.read_exif_tags(w.output)
        assert tags["Make"] == META["make"] and tags["Orientation"] == "1"
        assert not any(k.startswith("GPS") for k in tags)
        assert os.stat(g.output).st_mtime == os.stat(w.output).st_mtime
        a, b = pixels(g.output), pixels(w.output)
        assert a.shape == b.shape == (64, 96, 3)
        if fmt == "jpeg":
            assert open(g.output, "rb").read() == open(w.output, "rb").read()
        else:
            assert float(np.abs(a - b).max()) / 65535 <= TIFF_TOL


def _moved_mcus(moved: np.ndarray) -> np.ndarray:
    """(H, W) bool: the 16 x 16 MCUs holding a moved pixel and their
    neighbours (the decoder's chroma upsampling reads the next MCU's
    samples)."""
    h, w = moved.shape
    blocks = np.zeros((-(-h // 16) + 2, -(-w // 16) + 2), bool)
    ys, xs = np.nonzero(moved)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            blocks[ys // 16 + dy, xs // 16 + dx] = True
    return np.repeat(np.repeat(blocks[1:-1, 1:-1], 16, 0), 16, 1)[:h, :w]


def _frames(path, doc):
    """The u8 frame each package's export encodes for `path`: its loader,
    parse and stack, then its export chunk entry (JAX's jitted, on the mesh
    of the tests' virtual devices; the port's on the CPU)."""
    import jax.numpy as jnp

    from rapidraw_tpu.io.loader import load_image as jload_image
    from rapidraw_tpu.params.parse import parse_adjustments as jparse
    from rapidraw_tpu.pipeline.batch import stack_params as jstack
    from rapidraw_tpu_torch.params.parse import parse_adjustments
    from rapidraw_tpu_torch.pipeline.batch import stack_params

    adj = dict(doc, showClipping=False)
    jimg, _ = jload_image(path)
    jsp, jsc = jstack(*[[v] for v in jparse(adj, is_raw=True)])
    want = jexport._render_chunk(jnp.asarray(jimg)[None], jsp, None, None, jsc)[0]
    img, _ = loader.load_image(path, device="cpu")
    p, c = parse_adjustments(adj, is_raw=True)
    sp, sc = stack_params([p], [c], device="cpu")
    got = export._render_chunk(img[None], sp, None, None, sc)[0]
    return got.transpose(1, 2, 0), np.asarray(want).transpose(1, 2, 0)


def _pil_jpeg_pixels(frame: np.ndarray) -> np.ndarray:
    import io

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=90)
    return np.asarray(Image.open(buf)).astype(np.int64)


def test_config3_export_matches_jax_jitted(tmp_path):
    """A 1024 x 1536 photograph-like DNG with config 3, TIFF and JPEG q90."""
    [path] = make_sources(tmp_path / "src", [chip_smoke.CONFIG3_DOC], w=1536, h=1024,
                          seed=31, content="photo")
    out = {}
    for fmt in ("tiff", "jpeg"):
        want = jexport.export_images([path], tmp_path / f"jax_{fmt}",
                                     jexport.ExportSettings(format=fmt))
        got = export.export_images([path], tmp_path / f"port_{fmt}",
                                   export.ExportSettings(format=fmt), device="cpu")
        assert want[0].ok and got[0].ok
        assert os.path.basename(got[0].output) == os.path.basename(want[0].output)
        assert jexif.read_exif_tags(got[0].output) == jexif.read_exif_tags(want[0].output)
        out[fmt] = pixels(got[0].output), pixels(want[0].output)
    d = np.abs(out["tiff"][0] - out["tiff"][1]) / 65535
    moved = (d > TIFF_TOL).any(axis=-1)
    print(f"tiff: max|d| {d.max():.3e}; pixels past {TIFF_TOL:.3e}: {int(moved.sum())} "
          f"(share {moved.mean():.2e})")
    assert moved.mean() <= 1e-3
    # each JPEG is PIL's q90 file of its package's u8 frame (the port's
    # encoder writes PIL's bytes): blocks whose frames agree decode alike
    got_u8, want_u8 = _frames(path, chip_smoke.CONFIG3_DOC)
    du8 = np.abs(got_u8.astype(np.int64) - want_u8)
    jgot, jwant = out["jpeg"]
    assert np.array_equal(jgot, _pil_jpeg_pixels(got_u8))
    assert np.array_equal(jwant, _pil_jpeg_pixels(want_u8))
    d = np.abs(jgot - jwant)
    differ = _moved_mcus(du8.max(axis=-1) > 0)
    print(f"u8 frames: max|d| {du8.max()}, values off {(du8 > 0).mean():.2e}; jpeg: share "
          f"within 1 LSB {(d <= 1).mean():.6f}, max {d.max()}, MCUs with a frame difference "
          f"{differ.mean():.2e}")
    assert (du8 > 1).mean() <= 1e-3
    assert (d <= 1).mean() >= 0.999
    assert d[~differ].max() == 0


def test_estimate_matches_jax(sources, tmp_path, monkeypatch):
    for fmt in ("jpeg", "tiff"):
        st = dict(format=fmt, long_edge=48)
        with op_by_op(monkeypatch):
            want = jexport.estimate_export_sizes(sources[:2], jexport.ExportSettings(**st))
        got = export.estimate_export_sizes(sources[:2], export.ExportSettings(**st), device="cpu")
        assert got == want > 0
    assert export.estimate_export_sizes(sources, export.ExportSettings(format="cube")) == \
        jexport.estimate_export_sizes(sources, jexport.ExportSettings(format="cube"))
    assert export.estimate_export_sizes([], export.ExportSettings()) == 0


def test_export_resizes_as_jax(sources, tmp_path, monkeypatch):
    kw = dict(long_edge=40, batch_size=4, format="tiff")
    with op_by_op(monkeypatch):
        want = jexport.export_images(sources[:1], tmp_path / "jax", jexport.ExportSettings(**kw))
    got = export.export_images(sources[:1], tmp_path / "port", export.ExportSettings(**kw),
                               device="cpu")
    a, b = pixels(got[0].output), pixels(want[0].output)
    assert a.shape == b.shape == (27, 40, 3)
    assert float(np.abs(a - b).max()) / 65535 <= TIFF_TOL


def test_watermark_and_mask_exports_raise(sources, tmp_path):
    """A watermark file that does not exist fails each image's encode, with
    and without mask exports, as it fails JAX's (the export itself does not
    raise: failures are per image)."""
    for masks in (False, True):
        kw = dict(export_masks=masks)
        got = export.export_images(
            sources[:2], tmp_path / f"port{masks}", export.ExportSettings(
                watermark=export.WatermarkSettings(path=str(tmp_path / "logo.png")), **kw),
            device="cpu")
        want = jexport.export_images(
            sources[:2], tmp_path / f"jax{masks}", jexport.ExportSettings(
                watermark=jwatermark.WatermarkSettings(path=str(tmp_path / "logo.png")), **kw))
        assert [r.ok for r in got] == [r.ok for r in want] == [False, False]
        assert all(r.error.startswith("encode failed") for r in got + want)


def test_export_defaults_to_the_card(sources, tmp_path):
    """Without `device=`, the images go to CUDA: on a machine without a
    card every image fails to prepare rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    got = export.export_images(sources[:2], tmp_path / "out", export.ExportSettings())
    assert all(not r.ok and r.error.startswith("prepare failed") for r in got)


@pytest.mark.parametrize("preset", [
    {},
    {"file_format": "PNG", "jpeg_quality": None, "enable_resize": True, "resize_value": 2048,
     "resize_mode": "shortEdge", "dont_enlarge": None, "keep_metadata": False,
     "strip_gps": None, "preserve_folders": True, "preserve_timestamps": True},
    {"enable_watermark": True, "watermark_path": "/x/logo.png", "watermark_scale": 0,
     "watermark_opacity": None, "watermark_anchor": "topLeft", "export_masks": True},
])
def test_settings_from_preset_match_jax(preset):
    import dataclasses

    got = dataclasses.asdict(export.settings_from_preset(preset))
    want = dataclasses.asdict(jexport.settings_from_preset(preset))
    assert got == want


def test_output_paths_match_jax(tmp_path):
    import datetime

    src = tmp_path / "2024" / "trip" / "IMG_0001.CR2"
    src.parent.mkdir(parents=True)
    created = datetime.datetime(2024, 5, 17, 9, 41, 7)
    for tmpl in ("{original_filename}_edited", "{YYYY}{MM}{DD}_{hh}{mm}_{sequence}",
                 "{filename}-{sequence}"):
        for fmt in ("jpeg", "tiff"):
            for kw in ({}, {"vc": 3}, {"appearance": 2}, {"total": 120, "seq": 7}):
                kw = {"seq": 1, **kw}
                st = dict(filename_template=tmpl, format=fmt, preserve_folders=True,
                          base_origin_folders=(str(tmp_path / "2024"),))
                got = export._output_path(str(src), tmp_path / "p", export.ExportSettings(**st),
                                          created=created, **kw)
                want = jexport._output_path(str(src), tmp_path / "p",
                                            jexport.ExportSettings(**st), created=created, **kw)
                assert got == want


# ---- test_export_pipeline.py's cases, on both packages ----------------------------

def test_budgets_match_jax():
    n = export.host_worker_budget()
    assert n == jexport.host_worker_budget()
    for b in (1, 2, 4, 16):
        assert export.prepare_window(b, n) == jexport.prepare_window(b, n)


def test_pipelined_export_bounded_and_complete(tmp_path):
    paths = make_sources(tmp_path / "src", [{"exposure": 0.4}] * 11)
    jres = jexport.export_images(paths, tmp_path / "jax", jexport.ExportSettings(batch_size=3))
    st = export.ExportSettings(batch_size=3)
    res = export.export_images(paths, tmp_path / "port", st, device="cpu")
    assert all(r.ok for r in res), [r.error for r in res]
    assert [r.source for r in res] == paths == [r.source for r in jres]
    assert sorted(p.name for p in (tmp_path / "port").glob("*.jpg")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("*.jpg"))
    window = export.prepare_window(st.batch_size, export.host_worker_budget())
    n_enc = max(1, min(export.host_worker_budget(), 8))
    bound = window + window + st.batch_size + 2 * n_enc
    assert export._peak_prepared <= bound, (export._peak_prepared, bound)
    assert export._live_prepared == 0


def test_pipelined_export_output_matches_serial_render(tmp_path):
    """A frame of the pipelined export equals the same chunk entry's render
    of that image, encoded alone."""
    doc = {"exposure": 0.5, "contrast": 15, "toneMapper": "agx"}
    paths = make_sources(tmp_path / "src", [doc] * 3)
    res = export.export_images(paths, tmp_path / "out", export.ExportSettings(batch_size=2),
                               device="cpu")
    assert all(r.ok for r in res)
    from rapidraw_tpu_torch.params.parse import parse_adjustments
    from rapidraw_tpu_torch.pipeline.batch import stack_params

    img, _ = loader.load_image(paths[0], device="cpu")
    p, cfg = parse_adjustments(dict(doc, showClipping=False), is_raw=True)
    sp, scfg = stack_params([p], [cfg], device="cpu")
    ref = export._render_chunk(img[None], sp, None, None, scfg)[0]
    from rapidraw_tpu_torch.io.encode import encode_image

    encode_image(ref, tmp_path / "ref.jpg", "jpeg", 90)
    assert np.array_equal(np.asarray(Image.open(res[0].output)),
                          np.asarray(Image.open(tmp_path / "ref.jpg")))


def test_pipelined_export_error_isolation(tmp_path):
    paths = make_sources(tmp_path / "src", [{"exposure": 0.4}] * 4)
    bad = tmp_path / "src" / "broken.dng"
    bad.write_bytes(b"not an image at all")
    all_paths = paths[:2] + [str(bad)] + paths[2:]
    for mod, dev in ((jexport, {}), (export, {"device": "cpu"})):
        res = mod.export_images(all_paths, tmp_path / mod.__name__, mod.ExportSettings(batch_size=2),
                                **dev)
        assert len(res) == 5
        by_src = {r.source: r for r in res}
        assert not by_src[str(bad)].ok and "prepare failed" in by_src[str(bad)].error
        assert sum(r.ok for r in res) == 4


def test_pipelined_export_cancellation(tmp_path):
    paths = make_sources(tmp_path / "src", [{"exposure": 0.4}] * 6)
    for mod, dev in ((jexport, {}), (export, {"device": "cpu"})):
        token = CancellationToken()
        calls = {"n": 0}

        def progress(i, total, p):
            calls["n"] += 1
            if calls["n"] == 2:
                token.cancel()

        res = mod.export_images(paths, tmp_path / mod.__name__, mod.ExportSettings(batch_size=2),
                                progress=progress, cancel=token, **dev)
        assert len(res) == 6
        assert any(not r.ok and r.error == "cancelled" for r in res)


def test_mixed_docs_bucket_and_merge(tmp_path, monkeypatch):
    """Different slider values share a bucket; a shape change and the AgX
    tone mapper each force another: the chunks are JAX's, one by one."""
    root = tmp_path / "src"
    paths = (make_sources(root / "a", [{"exposure": 0.3}, {"contrast": 30, "saturation": 12}])
             + make_sources(root / "b", [{"exposure": -0.2}], w=64, h=96)
             + make_sources(root / "c", [{"exposure": 0.1, "toneMapper": "agx"},
                                         {"vibrance": 20}], seed=5))
    seen = {}
    for mod, dev in ((jexport, {}), (export, {"device": "cpu"})):
        chunks = seen.setdefault(mod.__name__, [])
        real = mod._render_chunk

        def spy(imgs, params, masks, lut, cfg, *a, _real=real, _chunks=chunks, **k):
            _chunks.append((tuple(imgs.shape), cfg.tonemapper_agx))
            return _real(imgs, params, masks, lut, cfg, *a, **k)

        monkeypatch.setattr(mod, "_render_chunk", spy)
        res = mod.export_images(paths, tmp_path / mod.__name__, mod.ExportSettings(batch_size=4),
                                **dev)
        assert all(r.ok for r in res), [r.error for r in res]
        assert len(list((tmp_path / mod.__name__).glob("*.jpg"))) == 5
    assert seen[export.__name__] == seen[jexport.__name__]
    assert len(seen[export.__name__]) == 3


def test_same_names_are_claimed_apart(tmp_path):
    """Two sources that template to one name: the second takes '-1', in
    both packages."""
    paths = (make_sources(tmp_path / "x", [{"exposure": 0.2}])
             + make_sources(tmp_path / "y", [{"exposure": 0.3}], seed=2))
    names = []
    for mod, dev in ((jexport, {}), (export, {"device": "cpu"})):
        res = mod.export_images(paths, tmp_path / mod.__name__, mod.ExportSettings(), **dev)
        names.append([os.path.basename(r.output) for r in res])
    assert names[0] == names[1] == ["img_000_edited.jpg", "img_000_edited-1.jpg"]


# ---- LDR sources, watermarks, per-mask exports ---------------------------------------


def make_ldr_sources(root, h=48, w=72) -> list[str]:
    """A JPEG (EXIF orientation 6), an 8-bit PNG and a 16-bit TIFF, each
    with a sidecar: CONFIG3_DOC, a light grade, and config 4's masks."""
    import cv2

    from test_torch_ldr import photo

    root.mkdir(parents=True, exist_ok=True)
    a = photo(h, w, 8)
    ex = Image.Exif()
    ex[0x0112] = 6
    ex[0x010F] = "Maker"
    Image.fromarray(a).save(root / "shot.jpg", quality=92, exif=ex.tobytes())
    Image.fromarray(a[::-1]).save(root / "scan.png")
    a16 = (a.astype(np.uint16) * 257) ^ np.uint16(0x55)
    cv2.imwrite(str(root / "deep.tif"), a16[..., ::-1],
                [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW])
    docs = {"shot.jpg": chip_smoke.CONFIG3_DOC, "scan.png": {"exposure": 0.3, "contrast": 20},
            "deep.tif": chip_smoke.config4_doc(h, w)}
    for name, doc in docs.items():
        (root / f"{name}.rrdata").write_text(json.dumps({"version": 1, "adjustments": doc}))
    return [str(root / n) for n in docs]


@contextlib.contextmanager
def ldr_op_by_op(monkeypatch):
    """`op_by_op` for LDR sources: JAX's u8 / u16 uploads (jitted in the
    prepare threads) and its single-image develop (jitted in the encode
    threads that export the masks) run op by op too."""
    import jax.numpy as jnp

    from rapidraw_tpu.io import loader as jloader

    with monkeypatch.context() as m:
        m.setattr(jloader, "_U8_TO_PLANAR_JIT",
                  lambda a: jnp.transpose(a.astype(jnp.float32), (2, 0, 1)) / 255.0)
        m.setattr(jloader, "_U16_TO_PLANAR_JIT",
                  lambda a: jnp.transpose(a.astype(jnp.float32), (2, 0, 1)) / 65535.0)
        single = jexport.develop_single_compiled

        def eager_single(*a, **k):
            with jax.disable_jit():
                return single(*a, **k)

        m.setattr(jexport, "develop_single_compiled", eager_single)
        with op_by_op(m):
            yield


@pytest.fixture(scope="module")
def ldr_sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldr")
    paths = make_ldr_sources(root)
    logo = np.zeros((20, 36, 4), np.uint8)
    logo[..., 0] = 230
    logo[..., 3] = np.linspace(0, 255, 36, dtype=np.uint8)
    logo[5:15, 8:28, 1:3] = 200
    Image.fromarray(logo, "RGBA").save(root / "logo.png")
    return paths, str(root / "logo.png")


def _same_export(got_dir, want_dir, fmt):
    """Every file of the two exports: the same names; JPEG byte for byte,
    16-bit TIFF / PNG within TIFF_TOL, the alpha PNGs as decoded pixels."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for n in names:
        g, w = os.path.join(got_dir, n), os.path.join(want_dir, n)
        if n.endswith("_alpha.png"):
            assert np.array_equal(np.asarray(Image.open(g)), np.asarray(Image.open(w))), n
        elif fmt == "jpeg":
            assert open(g, "rb").read() == open(w, "rb").read(), n
        else:
            a, b = pixels(g), pixels(w)
            assert a.shape == b.shape and float(np.abs(a - b).max()) / 65535 <= TIFF_TOL, n
    return names


@pytest.mark.parametrize("fmt", ["jpeg", "tiff"])
def test_ldr_export_matches_jax_op_by_op(fmt, ldr_sources, tmp_path, monkeypatch):
    """JPEG, PNG and TIFF sources through export_images: the same files as
    JAX's (its develop op by op), EXIF included."""
    paths, _ = ldr_sources
    kw = dict(format=fmt, batch_size=2)
    with ldr_op_by_op(monkeypatch):
        want = jexport.export_images(paths, tmp_path / "jax", jexport.ExportSettings(**kw))
    got = export.export_images(paths, tmp_path / "port", export.ExportSettings(**kw),
                               device="cpu")
    assert [(r.ok, r.error) for r in got] == [(r.ok, r.error) for r in want]
    assert all(r.ok for r in got)
    _same_export(tmp_path / "port", tmp_path / "jax", fmt)
    assert jexif.read_exif_tags(got[0].output) == jexif.read_exif_tags(want[0].output)
    assert pixels(got[0].output).shape == (72, 48, 3)  # turned by its orientation


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_watermark_and_mask_export_match_jax(fmt, ldr_sources, tmp_path, monkeypatch):
    """A watermark (RGBA PNG, resized by the 8-bit Lanczos), the long-edge
    resize and `export_masks` on the config-4 document: every file equal to
    JAX's, the per-mask images and the alpha PNGs (compared decoded)."""
    paths, logo = ldr_sources
    kw = dict(format=fmt, batch_size=2, long_edge=60, export_masks=True,
              preserve_timestamps=True)
    wm = dict(path=logo, anchor="bottomLeft", scale=30.0, opacity=70.0)
    with ldr_op_by_op(monkeypatch):
        want = jexport.export_images(paths, tmp_path / "jax", jexport.ExportSettings(
            watermark=jwatermark.WatermarkSettings(**wm), **kw))
    got = export.export_images(paths, tmp_path / "port", export.ExportSettings(
        watermark=export.WatermarkSettings(**wm), **kw), device="cpu")
    assert [(r.ok, r.error) for r in got] == [(r.ok, r.error) for r in want]
    assert all(r.ok for r in got)
    names = _same_export(tmp_path / "port", tmp_path / "jax", fmt)
    ext = "jpg" if fmt == "jpeg" else fmt
    assert [n for n in names if "_mask_" in n] == [
        f"deep_edited_mask_{i}_{k}" for i in range(3)
        for k in ("alpha.png", f"image.{ext}")]
    for n in names:  # capture times stamped on the images (not the alpha PNGs)
        if not n.endswith("_alpha.png"):
            assert os.stat(tmp_path / "port" / n).st_mtime == \
                os.stat(tmp_path / "jax" / n).st_mtime
    alpha = np.asarray(Image.open(tmp_path / "port" / "deep_edited_mask_1_alpha.png"))
    assert alpha.shape == (40, 60) and alpha.max() == 255 and alpha.min() == 0
