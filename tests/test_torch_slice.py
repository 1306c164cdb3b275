"""The whole slice, adjustment JSON -> develop_batch -> device_u8, against
the JAX package's develop_batch + _device_u8, for B = 1 and B = 2.

Float output with dither off: max |d| <= 1e-3 (ROADMAP's parity bar).
u8 with dither on (the real export path): at most 1 LSB, on at most 0.1%
of the values — the dither hash is fract() of large products, and the
jitted JAX graph rounds some of them differently.
Config 4 (local masks) at 1024 x 1536 and a batch of documents with 3, 1
and 0 masks are held to the same bounds, and so is config 2 (RAW): a
1024 x 1536 DNG through the port's load_image -> develop_batch against the
JAX package's jitted load_image -> develop_batch, and so are 1024 x 1536
CR2, NEF, ARW and CR3 files, and the documents of slice A.8: config 3
with flare and a .cube LUT, NR that a mask drives and a batch of mixed NR
amounts. Also: importing the port (and decoding every vendor container with it)
leaves JAX (and PIL) out, and chip_smoke.py refuses to run without a GPU.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline.batch import develop_batch as jdevelop_batch
from rapidraw_tpu.pipeline.bands import blur_band_rows as jblur_band_rows
from rapidraw_tpu.pipeline.batch import stack_params as jstack
from rapidraw_tpu.pipeline.export import _device_u8
import rapidraw_tpu_torch as rt
from rapidraw_tpu_torch.ops.flare import FLARE_PARAMS, flare_maps
from rapidraw_tpu_torch.pipeline import fused as tfused

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
H, W = 128, 192


def batch(seed=11, b=2):
    rng = np.random.default_rng(seed)
    return rng.random((b, 3, H, W), dtype=np.float32)


def jax_run(docs, x, dither: bool, masks=None, op_by_op: bool = False):
    """JAX's develop_batch -> _device_u8, jitted (as export runs it) or op
    by op (`jax.disable_jit`)."""
    parsed = [jparse(d) for d in docs]
    p, c = jstack([q for q, _ in parsed], [k for _, k in parsed])
    c = dataclasses.replace(c, dither_active=dither)
    bands = jblur_band_rows(c, masks)
    fn = lambda im, q, mk: jdevelop_batch(im, q, c, masks=mk, blur_bands=bands)  # noqa: E731
    args = (jnp.asarray(x), p, None if masks is None else jnp.asarray(masks))
    if op_by_op:
        with jax.disable_jit():
            out = fn(*args)
    else:
        out = jax.jit(fn)(*args)
    return np.asarray(out), np.asarray(_device_u8(out))


@functools.cache
def jitted_develop(cfg):
    """JAX's develop_batch(images, params, cfg) jitted, one program per
    config: config 2's and the vendor files' cases develop the same
    document at the same size, and each compile takes seconds here."""
    return jax.jit(lambda im, q: jdevelop_batch(im, q, cfg))


def port_run(docs, x, dither: bool, masks=None):
    parsed = [rt.parse_adjustments(d) for d in docs]
    p, c = rt.stack_params([q for q, _ in parsed], [k for _, k in parsed], device="cpu")
    c = dataclasses.replace(c, dither_active=dither)
    bands = rt.blur_band_rows(c, masks)
    out = rt.develop_batch(torch.from_numpy(x), p, c,
                           masks=None if masks is None else torch.from_numpy(masks),
                           blur_bands=bands)
    return out.numpy(), rt.device_u8(out).numpy()


def assert_u8_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("name", ["config1", "config3", "full"])
def test_slice_float_matches_jax(name):
    doc, _ = chip_smoke.DOCS[name]
    docs = [doc, dict(doc, exposure=-0.3)]
    x = batch()
    want, _ = jax_run(docs, x, dither=False)
    got2, _ = port_run(docs, x, dither=False)
    got1, _ = port_run(docs[:1], x[:1], dither=False)
    assert got2.shape == want.shape == x.shape
    np.testing.assert_allclose(got2, want, atol=1e-3)
    np.testing.assert_allclose(got1[0], want[0], atol=1e-3)
    assert np.array_equal(got1[0], got2[0])  # batch size changes nothing per image


def test_slice_u8_matches_jax():
    docs = [chip_smoke.CONFIG3_DOC, dict(chip_smoke.CONFIG3_DOC, exposure=-0.3)]
    x = batch(seed=12)
    _, want = jax_run(docs, x, dither=True)
    _, got2 = port_run(docs, x, dither=True)
    _, got1 = port_run(docs[:1], x[:1], dither=True)
    assert got2.dtype == np.uint8 and got2.shape == x.shape
    for got, ref in ((got2, want), (got1, want[:1])):
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert d.max() <= 1
        assert (d > 0).mean() <= 1e-3


def test_config4_matches_jax():
    """JSON -> rasterize_masks -> blur_band_rows -> stack_params ->
    develop_batch -> device_u8 at 1024 x 1536, both mask-only levels
    band-restricted: float (dither off) within 1e-3, u8 (dither on) within
    1 LSB on at most 0.1% of the values."""
    h, w = 1024, 1536
    doc = chip_smoke.config4_doc(h, w)
    docs = [doc, dict(doc, exposure=-0.3)]
    masks = rt.rasterize_masks(doc, w, h)
    mk = np.stack([masks, masks])
    x = np.random.default_rng(14).random((2, 3, h, w), dtype=np.float32)
    assert rt.blur_band_rows(rt.parse_adjustments(doc)[1], mk) is not None
    want, _ = jax_run(docs, x, dither=False, masks=mk)
    got, _ = port_run(docs, x, dither=False, masks=mk)
    np.testing.assert_allclose(got, want, atol=1e-3)
    _, want_u8 = jax_run(docs, x, dither=True, masks=mk)
    _, got_u8 = port_run(docs, x, dither=True, masks=mk)
    assert_u8_close(got_u8, want_u8)


def test_mixed_mask_counts_match_jax():
    """A batch of documents with 3, 1 and 0 masks: the stacks pad to 3
    masks with zero adjustments and the influences with zeros."""
    h, w = 128, 192
    doc3 = chip_smoke.config4_doc(h, w)
    docs = [doc3, dict(doc3, masks=doc3["masks"][1:2]), dict(chip_smoke.CONFIG3_DOC)]
    mk = np.zeros((3, 3, h, w), np.float32)
    for i, d in enumerate(docs):
        m = rt.rasterize_masks(d, w, h)
        if m is not None:
            mk[i, : len(m)] = m
    x = batch(seed=15, b=3)
    want, want_u8 = jax_run(docs, x, dither=True, masks=mk)
    got, got_u8 = port_run(docs, x, dither=True, masks=mk)
    assert_u8_close(got_u8, want_u8)
    want, _ = jax_run(docs, x, dither=False, masks=mk)
    got, _ = port_run(docs, x, dither=False, masks=mk)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.fixture(scope="module")
def config2_images(tmp_path_factory):
    """A 1024 x 1536 config-2 DNG (random u16 CFA from a seed, bench.py's
    range) loaded by the JAX package (jitted, as export runs it) and by
    the port on the CPU, with the default enhance pass."""
    from rapidraw_tpu.io.loader import load_image as jload_image

    h, w = 1024, 1536
    cfa = np.random.default_rng(16).integers(64, 16383, (h, w), dtype=np.uint16)
    path = tmp_path_factory.mktemp("config2") / "config2.dng"
    path.write_bytes(chip_smoke.raw_dng_bytes(cfa))
    want, want_raw = jload_image(path)
    got, got_raw = rt.load_image(path, device="cpu")
    assert want_raw and got_raw
    return np.asarray(want)[None], got.numpy()[None]


@pytest.mark.parametrize("name", ["empty", "config3"])
def test_config2_matches_jax(name, config2_images):
    """load_image -> parse_adjustments(is_raw=True) -> stack_params ->
    develop_batch -> device_u8, the way export runs a RAW file. The JAX
    front end is one jitted program whose fused arithmetic differs from
    its own op-by-op run by up to ~3e-4 (the port follows the op-by-op
    run); the enhance pass's gates can turn such a difference into a step,
    so the values a gate moved are counted and bounded by 0.1%, and every
    other value is held to 1e-3."""
    doc = {"empty": {}, "config3": chip_smoke.CONFIG3_DOC}[name]
    jimg, img = config2_images
    assert img.shape == jimg.shape == (1, 3, 1024, 1536)
    front = np.abs(img - jimg).max(axis=1) > 1e-3
    print(f"config2 front end + enhance: max|d| {np.abs(img - jimg).max():.3e}, "
          f"pixels moved past 1e-3 by a gate {int(front.sum())} (share {front.mean():.2e})")
    assert front.mean() <= 1e-3
    out = {}
    for dither in (False, True):
        jp, jc = jparse(doc, is_raw=True)
        sp, sc = jstack([jp], [jc])
        sc = dataclasses.replace(sc, dither_active=dither)
        want = jitted_develop(sc)(jnp.asarray(jimg), sp)
        p, c = rt.parse_adjustments(doc, is_raw=True)
        assert c.is_raw
        tp, tc = rt.stack_params([p], [c], device="cpu")
        tc = dataclasses.replace(tc, dither_active=dither)
        got = rt.develop_batch(torch.from_numpy(img), tp, tc)
        out[dither] = (got.numpy(), np.asarray(want), rt.device_u8(got).numpy(),
                       np.asarray(_device_u8(want)))
    got, want, _, _ = out[False]
    d = np.abs(got - want)
    print(f"config2 {name}: max|d| {d.max():.3e} off the gate-moved pixels "
          f"{d.max(axis=1)[~front].max():.3e}")
    assert np.isfinite(got).all()
    assert float(d.max(axis=1)[~front].max()) <= 1e-3
    _, _, got_u8, want_u8 = out[True]
    assert_u8_close(got_u8, want_u8)


@pytest.mark.parametrize("kind", chip_smoke.VENDOR_MAIN)
def test_vendor_raw_matches_jax(kind, tmp_path):
    """A 1024 x 1536 vendor file written by chip_smoke.py's writers (held to
    the test encoders by tests/test_torch_rawvendor.py) through the port's
    load_image -> parse_adjustments(is_raw=True) -> stack_params ->
    develop_batch(CONFIG3_DOC) -> device_u8 against the JAX package's jitted
    load_image -> develop_batch -> _device_u8, at test_config2_matches_jax's
    bounds; none of these files carries a colour matrix. The jitted develop
    differs from its own op-by-op run past 1e-3 on a few pixels (a hue gate
    on a dark NEF pixel moves one by 1.5e-2): those, with the front end's
    gate-moved ones, are counted and bounded by 0.1%, and the port is also
    held to the op-by-op run, which it follows, on every value."""
    from rapidraw_tpu.io.loader import load_image as jload_image

    data, cfa = chip_smoke.vendor_file(kind, 1024, 1536, 60)
    path = tmp_path / f"shot.{kind}"
    path.write_bytes(data)
    assert np.array_equal(rt.parse_raw(data, kind).cfa, cfa)
    jimg, jraw = jload_image(path)
    img, is_raw = rt.load_image(path, device="cpu")
    assert jraw and is_raw
    jimg, img = np.asarray(jimg)[None], img.numpy()[None]
    assert img.shape == jimg.shape == (1, 3, 1024, 1536)
    gate = np.abs(img - jimg).max(axis=1)[0] > 1e-3
    jp, jc = jparse(chip_smoke.CONFIG3_DOC, is_raw=True)
    p, c = rt.parse_adjustments(chip_smoke.CONFIG3_DOC, is_raw=True)
    out = {}
    for dither in (False, True):
        sp, sc = jstack([jp], [jc])
        sc = dataclasses.replace(sc, dither_active=dither)
        want = jitted_develop(sc)(jnp.asarray(jimg), sp)
        with jax.disable_jit():
            want_op = jdevelop_batch(jnp.asarray(jimg), sp, sc)
        tp, tc = rt.stack_params([p], [c], device="cpu")
        tc = dataclasses.replace(tc, dither_active=dither)
        got = rt.develop_batch(torch.from_numpy(img), tp, tc)
        out[dither] = [(got.numpy(), rt.device_u8(got).numpy())] + [
            (np.asarray(x), np.asarray(_device_u8(x))) for x in (want, want_op)]
    (got, got_u8), (want, want_u8), (want_op, op_u8) = out[False]
    gate |= np.abs(want - want_op).max(axis=1)[0] > 1e-3
    d = np.abs(got - want).max(axis=1)[0]
    print(f"{kind} config3: max|d| {d.max():.3e}, off the {int(gate.sum())} gate-moved pixels "
          f"{d[~gate].max():.3e}; against the op-by-op run {np.abs(got - want_op).max():.3e}")
    assert np.isfinite(got).all()
    assert gate.mean() <= 1e-3
    assert float(d[~gate].max()) <= 1e-3
    np.testing.assert_allclose(got, want_op, atol=1e-3)
    (_, got_u8), (_, want_u8), (_, op_u8) = out[True]
    assert_u8_close(got_u8, op_u8)
    du = np.abs(got_u8.astype(np.int16) - want_u8.astype(np.int16))[0]
    assert du[:, ~gate].max() <= 1 and (du > 0).mean() <= 1e-3


@pytest.fixture(scope="module")
def phase13_cube(tmp_path_factory):
    """chip_smoke.py's 33^3 .cube, written and parsed by the port's and
    the JAX package's parsers (the same array)."""
    from rapidraw_tpu.io.lut import parse_lut_file as jparse_lut
    from rapidraw_tpu_torch.io.lut import parse_lut_file

    path = tmp_path_factory.mktemp("lut") / "phase13.cube"
    chip_smoke.write_cube(path)
    cube = parse_lut_file(path)
    assert np.array_equal(cube, jparse_lut(path)) and cube.shape == (33, 33, 33, 3)
    return cube


def bright_batch(b, h, w, seed):
    """Random pixels with a few saturated discs: the flare's bright sources."""
    x = np.random.default_rng(seed).random((b, 3, h, w), dtype=np.float32) * np.float32(0.7)
    yy, xx = np.ogrid[:h, :w]
    for cy, cx in ((0.3, 0.25), (0.6, 0.7)):
        x[:, :, (yy - cy * h) ** 2 + (xx - cx * w) ** 2 <= (0.03 * h) ** 2] = 1.0
    return x


def test_flare_lut_matches_jax(phase13_cube, monkeypatch):
    """Phase 13's (b) document (config 3 + flare 50 + the 33^3 .cube at 80%)
    at 1024 x 1536 through develop_batch -> device_u8. The port makes its
    own flare map (kept as develop_batch makes it, and passed back in for the
    dithered run); JAX is handed the same map (test_torch_flare.py holds the
    port's map to JAX's; JAX's jitted map generator, ~1,300 unrolled taps,
    compiles for minutes). Float (dither off) within 1e-3, u8 (dither on)
    within 1 LSB on at most 0.1% of the values."""
    h, w = 1024, 1536
    doc = chip_smoke.FLARE_LUT_DOC
    x = bright_batch(1, h, w, 17)
    tp, tc = rt.stack_params(*zip(rt.parse_adjustments(doc)), device="cpu")
    jp, jc = jstack(*map(list, zip(jparse(doc))))
    assert tc.flare_active and tc.has_lut
    calls, maps = [], []
    monkeypatch.setattr(tfused, "flare_maps",
                        lambda *a: calls.append(a) or maps.append(flare_maps(*a)) or maps[-1])
    out = {}
    for dither in (False, True):
        c = dataclasses.replace(tc, dither_active=dither)
        jcd = dataclasses.replace(jc, dither_active=dither)
        got = rt.develop_batch(torch.from_numpy(x), tp, c, lut=torch.from_numpy(phase13_cube),
                               flare=None if not dither else maps[0])
        want = jax.jit(lambda im, q, lut, fl: jdevelop_batch(im, q, jcd, lut=lut, flare=fl))(
            jnp.asarray(x), jp, jnp.asarray(phase13_cube), jnp.asarray(maps[0][0].numpy()))
        out[dither] = (got.numpy(), np.asarray(want), rt.device_u8(got).numpy(),
                       np.asarray(_device_u8(want)))
    assert len(maps) == 1  # the map the undithered develop made, and no other
    (img, fparams, is_raw), = calls  # from the image and the global flare columns
    cols = [tfused.OFFSETS[k] for k in FLARE_PARAMS]
    assert torch.equal(img, torch.from_numpy(x)) and is_raw is False
    assert torch.equal(fparams, tfused.pack_rows(tp["glob"])[:, cols])
    got, want, _, _ = out[False]
    print(f"flare + LUT: max|d| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=1e-3)
    _, _, got_u8, want_u8 = out[True]
    assert_u8_close(got_u8, want_u8)


@pytest.mark.parametrize("case", ["masked NR", "mixed NR"])
def test_per_pixel_nr_matches_jax(case):
    """NR with per-pixel amounts at 1024 x 1536, B = 2, through
    develop_batch -> device_u8 against JAX's develop_batch run op by op:
    config 5's document with a radial mask carrying its own NR (amount
    maps), and config 5 at NR 0.30/0.25 beside 0.60/0.45 (per-image
    amounts). Dither off (JAX's op-by-op develop is slow at this size):
    float within 1e-3, u8 within 1 LSB on at most 0.1%. JAX's jitted graph contracts the coordinate hash into
    FMAs and so moves some jittered taps: it differs from its own op-by-op
    run past 1e-3 on ~0.2% of the values, and the port follows the op-by-op
    run."""
    h, w = 1024, 1536
    if case == "masked NR":
        doc = chip_smoke.masked_nr_doc(h, w)
        docs = [doc, dict(doc, exposure=-0.3)]
        m = rt.rasterize_masks(doc, w, h)
        masks = np.stack([m, m])
    else:
        docs, masks = list(chip_smoke.MIXED_NR_DOCS), None
    x = np.random.default_rng(18).random((2, 3, h, w), dtype=np.float32)
    assert rt.merge_configs([rt.parse_adjustments(d)[1] for d in docs]).nr_static_luma is None
    want, want_u8 = jax_run(docs, x, dither=False, masks=masks, op_by_op=True)
    got, got_u8 = port_run(docs, x, dither=False, masks=masks)
    print(f"{case}: max|d| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert_u8_close(got_u8, want_u8)


def test_develop_single_is_the_batch_of_one():
    doc = chip_smoke.CONFIG1_DOC
    x = batch(seed=13, b=1)
    p, c = rt.parse_adjustments(doc)
    single = rt.develop_single(torch.from_numpy(x[0]), p, c)
    sp, sc = rt.stack_params([p], [c], device="cpu")
    assert torch.equal(single, rt.develop_batch(torch.from_numpy(x), sp, sc)[0])
    assert torch.equal(single, rt.develop(torch.from_numpy(x[0]), p, c))


def test_stack_params_defaults_to_the_card():
    """The CPU only on request: without `device=`, params go to CUDA (on a
    machine without a card, that refuses rather than falling back)."""
    from rapidraw_tpu_torch.geometry.params import GeometryParams
    from rapidraw_tpu_torch.geometry.warp_fast import plan_warp

    p, c = rt.parse_adjustments({})
    if torch.cuda.is_available():
        sp, _ = rt.stack_params([p], [c])
        assert sp["glob"]["exposure"].device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        rt.stack_params([p], [c])
    with pytest.raises((AssertionError, RuntimeError)):
        plan_warp(GeometryParams(rotate=1.0), 64, 256)
    sp, _ = rt.stack_params([p], [c], device="cpu")
    assert sp["glob"]["exposure"].device.type == "cpu"


def test_device_quantizers_round_like_jax():
    y = np.linspace(-0.1, 1.1, 4001, dtype=np.float32)
    assert np.array_equal(rt.device_u8(torch.from_numpy(y)).numpy(),
                          np.asarray(_device_u8(jnp.asarray(y))))
    u16 = rt.device_u16(torch.from_numpy(y))
    want = (np.clip(y, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    assert np.array_equal(u16.to(torch.int32).numpy(), want.astype(np.int32))


def test_develop_rejects_interleaved_images():
    p, c = rt.parse_adjustments({})
    with pytest.raises(ValueError, match="PLANAR"):
        rt.develop(torch.zeros((8, 8, 3)), p, c)


def test_import_leaves_jax_out():
    code = (
        "import sys; import rapidraw_tpu_torch, rapidraw_tpu_torch.pipeline.export, "
        "rapidraw_tpu_torch.ops.blur, rapidraw_tpu_torch.pipeline.fused, "
        "rapidraw_tpu_torch.ops.nr, rapidraw_tpu_torch.ops.ca, "
        "rapidraw_tpu_torch.geometry.transforms, rapidraw_tpu_torch.geometry.warp_fast, "
        "rapidraw_tpu_torch.tools.prof_chunked, rapidraw_tpu_torch.tools.prof_nr_slices, "
        "rapidraw_tpu_torch.masks.rasterize, rapidraw_tpu_torch.masks.parametric, "
        "rapidraw_tpu_torch.pipeline.bands, rapidraw_tpu_torch.io.loader, "
        "rapidraw_tpu_torch.io.dng, rapidraw_tpu_torch.io.containers, rapidraw_tpu_torch.io.raf, "
        "rapidraw_tpu_torch.io.sidecar, rapidraw_tpu_torch.io.makers, rapidraw_tpu_torch.io.cr3, "
        "rapidraw_tpu_torch.io.crx, rapidraw_tpu_torch.io.iiq, rapidraw_tpu_torch.native, "
        "rapidraw_tpu_torch.raw.develop, rapidraw_tpu_torch.io.lut, rapidraw_tpu_torch.ops.lut3d, "
        "rapidraw_tpu_torch.ops.flare, "
        "rapidraw_tpu_torch.raw.enhance, rapidraw_tpu_torch.utils.settings, "
        "rapidraw_tpu_torch.io.encode, rapidraw_tpu_torch.io.exif, rapidraw_tpu_torch.io.jxl, "
        "rapidraw_tpu_torch.geometry.resize, rapidraw_tpu_torch.pipeline.export\n"
        "import chip_smoke\n"
        "for k in (*chip_smoke.VENDOR_MAIN, *chip_smoke.VENDOR_OTHER):\n"
        "    data, cfa = chip_smoke.vendor_file(k, 16, 224, 1)\n"
        "    ext = chip_smoke.VENDOR_OTHER.get(k, (k,))[0]\n"
        "    assert (rapidraw_tpu_torch.parse_raw(data, ext).cfa == cfa).all(), k\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rapidraw_tpu' or m.startswith('rapidraw_tpu.')"
        " or m == 'tools' or m.startswith('tools.') or m == 'PIL' or m.startswith('PIL.')"
        " or m == 'cv2' or m.startswith('cv2.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    """Neither the port nor chip_smoke.py imports JAX, flax, the JAX package,
    the repo's `tools/` probes (the port keeps its own in its `tools`), PIL,
    cv2, transformers, tokenizers, regex, safetensors, huggingface_hub or
    onnxruntime (the card's machine has none of them: the port writes its
    own files, runs its own networks, tokenizes and reads checkpoints
    itself)."""
    bad = re.compile(r"^\s*(import|from)\s+"
                     r"(jax|flax|rapidraw_tpu|tools|PIL|cv2|transformers|tokenizers|regex|"
                     r"safetensors|huggingface_hub|onnxruntime)\b")
    ai = sorted((REPO / "rapidraw_tpu_torch" / "ai").glob("*.py"))
    assert {p.stem for p in ai} >= {"models", "masks", "depth", "sam", "denoise",
                                    "tiled_inference", "inpaint", "connector", "tag_data",
                                    "checkpoint", "clip_tokenizer", "clip", "tagging"}
    for path in [*(REPO / "rapidraw_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not bad.match(line), f"{path}: {line}"


def test_port_writers_bind_no_codec_library():
    """The host sources include only the C++ standard library and their own
    headers (no libwebp, libavif or codec header: the encoders are the
    port's own, built with g++ alone), and the WebP writer loads nothing but
    its own host library."""
    std = re.compile(r'^\s*#\s*include\s+(<[a-z_]+>|"[a-z0-9_]+\.h")\s*$')
    host = REPO / "rapidraw_tpu_torch" / "csrc" / "host"
    for path in [*host.glob("*.cc"), *host.glob("*.h")]:
        for line in path.read_text().splitlines():
            if "#include" in line:
                assert std.match(line), f"{path.name}: {line}"
    assert "vp8_common.h" in (host / "webp_enc.cc").read_text()
    webp_py = (REPO / "rapidraw_tpu_torch" / "io" / "webp.py").read_text()
    assert "CDLL" not in webp_py and "find_library" not in webp_py
    for name in ("webp.py", "avif.py"):
        text = (REPO / "rapidraw_tpu_torch" / "io" / name).read_text()
        assert not re.search(r"^\s*(import|from)\s+(PIL|jax|rapidraw_tpu)\b", text, re.M)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package beside it
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=dict(env, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
