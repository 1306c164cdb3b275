"""The port's compositions (rapidraw_tpu_torch/compositions/) against the
JAX package's: the HDR merge within 1e-6 relative of JAX; the negative
conversion within 2e-6 on its [0, 1] output (both run float32 chains whose
log, exp and pow differ by an ulp now and then, which the curve's
sigmoid - y0 cancellation and the 1/2.2 power lift at dark values: the port
takes log10 as XLA does, log(x) * f32(1 / ln 10), and still measured up to
1.37e-6 apart on these documents, where each side is 6.4e-6 from the chain
run in float64), `read_exif_exposure` equal on files with and
without the tags, BM3D equal bit for bit (a copy of the NumPy code), and
culling's hash bits, scores and groups equal (the port's PIL resizes and
grey conversion give PIL's bytes). The port runs on the CPU.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.compositions import bm3d as jbm3d
from rapidraw_tpu.compositions import culling as jculling
from rapidraw_tpu.compositions import hdr as jhdr
from rapidraw_tpu.compositions import negative as jneg
from rapidraw_tpu_torch.compositions import bm3d, culling, hdr, negative

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

TOL = 1e-6
NEG_TOL = 2e-6


def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.5 + 0.4 * np.sin(xx / (9 + seed) + yy / 13),
                     0.5 + 0.35 * np.cos(xx / 7 - yy / (11 + seed)),
                     0.4 + 0.3 * np.sin((xx + yy) / 10)])
    return np.clip(base + rng.normal(0, 0.04, base.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_hdr_matches_jax(seed):
    rng = np.random.default_rng(seed)
    base = _photo(37, 53, seed)
    exps = [1 / 250, 1 / 60, 1 / 15][: 2 + seed % 2]
    isos = [100.0, 200.0, 100.0][: len(exps)]
    frames = [np.clip(base * (e * 120) + rng.normal(0, 0.01, base.shape), 0, 1).astype(np.float32)
              for e in exps]
    want = np.asarray(jhdr.merge_hdr([jax.numpy.asarray(f) for f in frames], exps, isos))
    got = hdr.merge_hdr([torch.from_numpy(f) for f in frames], exps, isos).numpy()
    assert np.abs(got - want).max() <= TOL * max(1.0, float(np.abs(want).max()))


def test_merge_hdr_errors_match_jax():
    a = torch.zeros((3, 4, 5))
    cases = [([a], [1.0], [100.0]), ([a, a], [1.0], [100.0]),
             ([a, torch.zeros((3, 5, 5))], [1.0, 1.0], [100.0, 100.0]),
             ([a, a], [1.0, 0.0], [100.0, 100.0])]
    for imgs, t, iso in cases:
        with pytest.raises(jhdr.HdrError) as want:
            jhdr.merge_hdr([np.asarray(x) for x in imgs], t, iso)
        with pytest.raises(hdr.HdrError) as got:
            hdr.merge_hdr(imgs, t, iso)
        assert str(got.value) == str(want.value)


def _jpeg_with_exif(path, exif=None):
    im = Image.fromarray((_photo(24, 32).transpose(1, 2, 0) * 255).astype(np.uint8))
    im.save(path, "JPEG", exif=exif if exif is not None else Image.Exif())
    return str(path)


def test_read_exif_exposure_matches_jax(tmp_path):
    def exif(**tags):
        e = Image.Exif()
        e[0x010F] = "AcmeCam"
        sub = {}
        for k, v in tags.items():
            sub[{"exp": 0x829A, "iso": 0x8827, "sens": 0x8833}[k]] = v
        if sub:
            e[0x8769] = sub
        return e

    from PIL.TiffImagePlugin import IFDRational

    files = [
        _jpeg_with_exif(tmp_path / "both.jpg", exif(exp=IFDRational(1, 125), iso=400)),
        _jpeg_with_exif(tmp_path / "sens.jpg", exif(exp=IFDRational(1, 30), sens=1600)),
        _jpeg_with_exif(tmp_path / "zero.jpg", exif(exp=IFDRational(0, 1), iso=0)),
        _jpeg_with_exif(tmp_path / "none.jpg", exif()),
        _jpeg_with_exif(tmp_path / "empty.jpg"),
    ]
    # IFD0 holding the tags (PIL merges IFD0 with the Exif IFD)
    e = Image.Exif()
    e[0x829A] = IFDRational(1, 8)
    e[0x8827] = 100
    files.append(_jpeg_with_exif(tmp_path / "ifd0.jpg", e))
    tif = tmp_path / "t.tif"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tif, exif=e)
    files.append(str(tif))
    (tmp_path / "junk.jpg").write_bytes(b"not an image")
    files += [str(tmp_path / "junk.jpg"), str(tmp_path / "missing.jpg")]
    for f in files:
        assert hdr.read_exif_exposure(f) == jhdr.read_exif_exposure(f), f
    assert hdr.read_exif_exposure(files[0]) == (1 / 125, 400.0)


@pytest.mark.parametrize("params", [
    {}, {"exposure": 0.4, "contrast": 1.6}, {"red_weight": 0.8, "blue_weight": 1.2, "exposure": -0.3},
])
def test_negative_matches_jax(params):
    img = _photo(61, 83, 3) * 0.8 + 0.05
    want = np.asarray(jneg.convert_negative(jax.numpy.asarray(img),
                                            jneg.NegativeConversionParams(**params)))
    got = negative.convert_negative(torch.from_numpy(img),
                                    negative.NegativeConversionParams(**params)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= NEG_TOL
    # the bounds themselves, on a frame past the 1080-px reference
    log = -np.log10(np.clip(img, 1e-6, 1.0))
    np.testing.assert_array_equal(negative.analyze_bounds(log), jneg.analyze_bounds(log))


def test_negative_run_pipeline_matches_jax():
    img = _photo(40, 50, 4)
    want = np.asarray(jneg.run_pipeline(jax.numpy.asarray(img)))
    got = negative.run_pipeline(torch.from_numpy(img)).numpy()
    assert np.abs(got - want).max() <= NEG_TOL


@pytest.mark.parametrize("shape,intensity", [((3, 40, 52), 0.5), ((3, 33, 47), 0.9)])
def test_bm3d_matches_jax_bit_for_bit(shape, intensity):
    rng = np.random.default_rng(7)
    img = np.clip(_photo(*shape[1:], 5) + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(bm3d.run_bm3d(img, intensity), jbm3d.run_bm3d(img, intensity))


def _cull_files(tmp_path):
    """Two near-duplicate pairs, one blurred frame, one loner; JPEGs."""
    paths = []
    bases = [_photo(300, 420, 0), _photo(300, 420, 6)]
    for i, base in enumerate(bases):
        for j in range(2):
            rng = np.random.default_rng(10 * i + j)
            x = np.clip(base + rng.normal(0, 0.02 * (j + 1), base.shape), 0, 1)
            p = tmp_path / f"s{i}{j}.jpg"
            Image.fromarray((x.transpose(1, 2, 0) * 255).astype(np.uint8)).save(p, quality=92)
            paths.append(str(p))
    loner = tmp_path / "loner.png"
    Image.fromarray((np.random.default_rng(3).random((200, 260, 3)) * 255)
                    .astype(np.uint8)).save(loner)
    paths.append(str(loner))
    (tmp_path / "bad.jpg").write_bytes(b"broken")
    paths.append(str(tmp_path / "bad.jpg"))
    return paths


def test_double_gradient_hash_matches_jax():
    rng = np.random.default_rng(1)
    for h, w in [(480, 720), (31, 17), (720, 405)]:
        gray = (rng.random((h, w)) * 255).astype(np.uint8)
        np.testing.assert_array_equal(culling.double_gradient_hash(gray),
                                      jculling.double_gradient_hash(gray))


@pytest.mark.parametrize("shape", [(3, 1500, 1000), (3, 479, 731), (3, 200, 150)])
def test_analyze_image_array_matches_jax(shape):
    img = _photo(*shape[1:], 2)
    want = jculling.analyze_image_array("x", img)
    for arg in (img, torch.from_numpy(img)):
        got = culling.analyze_image_array("x", arg)
        np.testing.assert_array_equal(got.hash_bits, want.hash_bits)
        assert (got.quality_score, got.sharpness_metric, got.center_focus_metric,
                got.exposure_metric, got.width, got.height) == (
            want.quality_score, want.sharpness_metric, want.center_focus_metric,
            want.exposure_metric, want.width, want.height)


def test_cull_images_matches_jax(tmp_path):
    paths = _cull_files(tmp_path)
    for group in (False, True):
        want = jculling.cull_images(paths, group_similar_images=group)
        got = culling.cull_images(paths, group_similar_images=group, device="cpu")
        assert got["best"] == want["best"] and got["failed"] == want["failed"]
        assert [[a.path for a in g] for g in got["groups"]] == \
            [[a.path for a in g] for g in want["groups"]]
        for gg, wg in zip(got["groups"], want["groups"]):
            for a, b in zip(gg, wg):
                assert a.quality_score == b.quality_score
                np.testing.assert_array_equal(a.hash_bits, b.hash_bits)
    assert len(want["groups"]) < len(paths) - 1  # grouped: the near duplicates share groups
