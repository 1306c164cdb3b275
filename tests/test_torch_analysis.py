"""The preview service's host helpers against the JAX package's: scopes
(analysis/scopes.py), auto adjust (analysis/auto_adjust.py: the <= 1024 px
downscale on the tensor's device, the rest in NumPy), the EXIF persisted
into the `.rrdata` sidecar on first load (io/exif.persist_exif_if_missing,
io/sidecar.save_sidecar), the cache-key hashes and LRU (utils/hashing.py)
and the trace helpers (utils/trace.py). Everything is held equal: values,
dict keys in order, sidecar files byte for byte.
"""

from __future__ import annotations

import json
import logging

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from rapidraw_tpu.analysis import auto_adjust as jauto
from rapidraw_tpu.analysis import scopes as jscopes
from rapidraw_tpu.io import exif as jexif
from rapidraw_tpu.io import sidecar as jsidecar
from rapidraw_tpu.utils import hashing as jhash
from rapidraw_tpu_torch.analysis import auto_adjust as pauto
from rapidraw_tpu_torch.analysis import scopes as pscopes
from rapidraw_tpu_torch.io import exif as pexif
from rapidraw_tpu_torch.io import sidecar as psidecar
from rapidraw_tpu_torch.utils import hashing as phash
from rapidraw_tpu_torch.utils import trace

jax.config.update("jax_platforms", "cpu")


def _img(h, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    x = rng.random((3, h, w), dtype=np.float32)
    if kind == "dark":
        return x * 0.15
    if kind == "bright":
        return np.clip(x * 0.8 + 0.5, 0, 1).astype(np.float32)
    if kind == "flat":
        return np.full((3, h, w), 0.4, np.float32)
    if kind == "halves":
        # values whose u8 scale lands exactly on a .5 (round half up)
        return (rng.integers(0, 255, (3, h, w)) + 0.5).astype(np.float32) / 255.0
    return (x * 1.4 - 0.2).astype(np.float32)  # past [0, 1] both ways


KINDS = ["u8", "dark", "bright", "flat", "halves", "wide"]


def _same_scopes(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        assert (got[k] is None and v is None) or np.array_equal(got[k], v), k
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype


@pytest.mark.parametrize("kind", KINDS)
def test_scopes_match_jax(kind):
    img = _img(61, 93, 1, kind)
    _same_scopes(pscopes.calculate_histogram(img), jscopes.calculate_histogram(img))
    for ch in (None, "rgb", "luma", "parade", "vectorscope"):
        _same_scopes(pscopes.calculate_waveform(img, ch), jscopes.calculate_waveform(img, ch))
    t = pscopes.calculate_histogram(torch.from_numpy(img))
    _same_scopes(t, jscopes.calculate_histogram(img))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(64, 96), (700, 1100)])
def test_auto_adjustments_match_jax(kind, shape):
    """<= 1024 px: NumPy as JAX; larger: the port's float64 downscale
    against JAX's f32 product, whose u8 rounding agrees on these images."""
    img = _img(*shape, 2, kind)
    want = jauto.calculate_auto_adjustments(img)
    got = pauto.calculate_auto_adjustments(img)
    assert list(got) == list(want) and got == want
    assert pauto.calculate_auto_adjustments(torch.from_numpy(img)) == want
    json.dumps(got)


def test_auto_adjust_rounds_halves_away_from_zero():
    x = np.array([0.5, 1.5, 2.5, 3.49, 3.5, 254.5], np.float64)
    assert (pauto._round_half_up(x) == jauto._round_half_up(x)).all()
    assert (pauto._round_half_up(x) == [1, 2, 3, 3, 4, 255]).all()


def _source(path):
    path.write_bytes(chip_smoke.raw_dng_bytes(chip_smoke.photo_cfa(24, 36, 64, 16383, 1),
                                              meta=chip_smoke.EXPORT_META))
    return str(path)


@pytest.mark.parametrize("case", ["fresh", "existing", "legacy", "no_exif", "has_exif"])
def test_persisted_exif_sidecar_matches_jax(case, tmp_path):
    files = {}
    for name, ex, sc in (("jax", jexif, jsidecar), ("port", pexif, psidecar)):
        d = tmp_path / name
        d.mkdir()
        if case == "no_exif":
            p = str(d / "plain.png")
            Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(p)
        else:
            p = _source(d / "shot.dng")
        if case == "existing":
            (d / (p.rsplit("/", 1)[1] + ".rrdata")).write_text(
                json.dumps({"rating": 3, "adjustments": {"exposure": 0.5}, "tags": ["x"]}))
        if case == "legacy":
            (d / (p.rsplit("/", 1)[1] + ".rrexif")).write_text(
                json.dumps({"source": "elsewhere", "exif": {"Make": "Legacy", "Model": "L1"}}))
        if case == "has_exif":
            sc.save_sidecar(p, {"exif": {"Make": "Kept"}, "adjustments": None})
        ex.persist_exif_if_missing(p)
        files[name] = sorted((q.name, q.read_bytes()) for q in d.iterdir()
                             if q.suffix in (".rrdata", ".rrexif"))
    assert files["port"] == files["jax"]
    if case in ("fresh", "existing"):
        meta = json.loads(files["port"][0][1])
        assert meta["exif"]["Make"] == chip_smoke.EXPORT_META["make"]
    assert not list(tmp_path.rglob("*.tmp"))


def test_save_sidecar_matches_jax(tmp_path):
    meta = {"rating": 4, "adjustments": chip_smoke.CONFIG3_DOC, "tags": ["a", "ü"],
            "exif": {"Make": "X"}}
    for sc, name in ((jsidecar, "j.jpg"), (psidecar, "p.jpg")):
        sc.save_sidecar(str(tmp_path / name), meta)
        sc.save_sidecar(str(tmp_path / name) + "?vc=3", dict(meta, rating=1))
    for suffix in (".rrdata", ".3.rrdata"):
        assert (tmp_path / f"p.jpg{suffix}").read_bytes() == \
            (tmp_path / f"j.jpg{suffix}").read_bytes()
    assert psidecar.load_sidecar(str(tmp_path / "p.jpg")) == \
        jsidecar.load_sidecar(str(tmp_path / "j.jpg"))


HASH_DOCS = [
    {},
    {"exposure": 0.3},
    chip_smoke.CONFIG3_DOC,
    chip_smoke.CONFIG5_DOC,
    dict(chip_smoke.config4_doc(60, 80), crop={"x": 4, "y": 2, "width": 50, "height": 30}),
    {"rotation": 1.5, "orientationSteps": 1, "flipHorizontal": True, "lensModel": None,
     "transformVertical": 12.0, "lensDistortionParams": {"k1": -0.1}},
    {"orientationSteps": None, "rotation": None, "aiPatches": [
        {"id": "p1", "visible": False, "patchData": {"color": "abc", "mask": "de"},
         "subMasks": [{"type": "all"}], "invert": True},
        {"id": "p2", "patchDataBase64": "xyz"}]},
    {"tags": ["é"], "exposure": 1e-9, "curves": {"luma": [{"x": 0, "y": 0}]}},
]


@pytest.mark.parametrize("i", range(len(HASH_DOCS)))
def test_hashes_match_jax(i):
    doc = HASH_DOCS[i]
    assert phash.calculate_geometry_hash(doc) == jhash.calculate_geometry_hash(doc)
    assert phash.calculate_transform_hash(doc) == jhash.calculate_transform_hash(doc)
    for path in ("/a/b.dng", "c.jpg?vc=2"):
        assert phash.calculate_visual_hash(path, doc) == jhash.calculate_visual_hash(path, doc)
        assert phash.calculate_full_job_hash(path, doc) == \
            jhash.calculate_full_job_hash(path, doc)
    assert phash.GEOMETRY_KEYS == jhash.GEOMETRY_KEYS


def test_lru_cache_matches_jax():
    ops = [("put", 1), ("put", 2), ("get", 1), ("put", 3), ("put", 4), ("get", 2),
           ("put", 1), ("get", 3), ("clear", None), ("put", 5), ("get", 5)]
    caches = (phash.LruCache(3), jhash.LruCache(3))
    for op, k in ops:
        outs = []
        for c in caches:
            if op == "put":
                c.put(k, str(k))
            elif op == "get":
                outs.append(c.get(k))
            else:
                c.clear()
        if outs:
            assert outs[0] == outs[1]
        assert len(caches[0]) == len(caches[1])
        assert list(caches[0]._d) == list(caches[1]._d)
    assert phash.LruCache(0).capacity == jhash.LruCache(0).capacity == 1


def test_lru_cache_under_threads():
    """Eight threads hammer one cache with the interpreter switching every
    microsecond: no operation raises, the size never passes the capacity,
    and every hit returns the value stored under its key."""
    import sys
    import threading

    cache = phash.LruCache(4)
    errors = []

    def work(t):
        try:
            for i in range(3000):
                k = (t * 7 + i) % 11
                cache.put(k, k * 10)
                v = cache.get((k + 3) % 11)
                if v is not None and v != ((k + 3) % 11) * 10:
                    errors.append((k, v))
                if len(cache) > 4:
                    errors.append(("size", len(cache)))
        except Exception as e:  # noqa: BLE001 - collected and asserted on
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_trace_helpers(tmp_path, caplog):
    with caplog.at_level(logging.DEBUG, logger="rapidraw_tpu_torch"):
        trace.log.setLevel(logging.DEBUG)
        with trace.stage_timer("decode") as st:
            pass
        assert st["seconds"] >= 0.0
        for _ in range(10):
            trace.log_render_fps(0.01)
    assert any("decode:" in r.getMessage() for r in caplog.records)
    assert any("fps" in r.getMessage() for r in caplog.records)
    with trace.profiler_trace(tmp_path / "prof") as prof:
        torch.ones(64).add_(1)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert prof.key_averages() is not None
    trace.setup_logging("warning", tmp_path / "log.txt")
    trace.log.warning("to the file")
    for h in trace.log.handlers:
        h.flush()
    assert "to the file" in (tmp_path / "log.txt").read_text()
    trace.log.handlers.clear()
    trace.log.propagate = True
