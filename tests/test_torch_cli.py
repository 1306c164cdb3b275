"""The port's CLI (rapidraw_tpu_torch/cli.py) against the JAX package's
(rapidraw_tpu/cli.py), verb by verb, on the same files in tmp_path.

The port runs with `--device cpu` (its kernels' plain versions); JAX runs
op by op (`jax.disable_jit`, one device: its jitted develop differs from
its own op-by-op run, ROADMAP queue C, and the port follows the op-by-op
numerics). `develop` and `export`: the u8 frames each side hands its
encoder within 1 LSB on <= 0.1% of values (the rule of
tests/test_torch_service.py::_same_frames) and the files' bytes equal where
the frames are. The cases of tests/test_cli_export.py's CLI tests run on
both. `lut-export`: the .cube values within 1e-5 (measured 5.0e-6 at
L = 17, a few units of the file's sixth decimal: float32 ulps of the chain
against JAX's op-by-op run, rounded to six decimals on each side). `lib`,
`exif`, `preset`: the same printed lines and the same sidecar and store
files. The verbs of later slices exit 2 naming their slice; without a card
and without `--device cpu` the port's CLI fails.
"""

from __future__ import annotations

import io
import json
import shutil
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu import cli as jcli
from rapidraw_tpu_torch import cli as pcli

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)


def _jpeg(path, h=48, w=64, seed=0):
    arr = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=95)
    return str(path)


@pytest.fixture
def frames(monkeypatch):
    """Each side's u8 frames as its encoder receives them; JAX with one
    device (its plain single-device entries, as the port has one card)."""
    from rapidraw_tpu.io import encode as jencode
    from rapidraw_tpu_torch.io import encode as pencode

    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    got = {"jax": [], "port": []}

    def spy(real, key):
        def encode(planar, *a, **kw):
            x = np.asarray(planar.cpu() if isinstance(planar, torch.Tensor) else planar)
            if x.dtype != np.uint8 and x.dtype != np.uint16:
                x = (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            got[key].append(x)
            return real(planar, *a, **kw)
        return encode

    monkeypatch.setattr(jencode, "encode_image", spy(jencode.encode_image, "jax"))
    monkeypatch.setattr(pencode, "encode_image", spy(pencode.encode_image, "port"))
    return got


def run(side: str, argv: list) -> tuple[int, str, str]:
    """One CLI call: (exit code, stdout, stderr). JAX op by op; the port
    with --device cpu."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        if side == "jax":
            with jax.disable_jit():
                rc = jcli.main(argv)
        else:
            rc = pcli.main(argv + ["--device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


def both(argv_of, frames=None) -> tuple:
    """argv_of(side) on JAX, then on the port: their (rc, stdout, stderr)."""
    if frames is not None:
        frames["jax"].clear()
        frames["port"].clear()
    return run("jax", argv_of("jax")), run("port", argv_of("port"))


def same_frames(frames) -> bool:
    """Each frame within 1 LSB on <= 0.1% of values; True when all equal."""
    assert len(frames["port"]) == len(frames["jax"]) > 0
    exact = True
    for g, w in zip(frames["port"], frames["jax"]):
        if g.shape != w.shape and g.ndim == 3 and g.shape[0] == 3:
            g = g.transpose(1, 2, 0)
        if w.shape != g.shape and w.ndim == 3 and w.shape[0] == 3:
            w = w.transpose(1, 2, 0)
        assert g.shape == w.shape and g.dtype == w.dtype
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        lsb = 257 if g.dtype == np.uint16 else 1
        assert int(d.max()) <= lsb and (d > 0).mean() <= 1e-3
        exact = exact and not d.any()
    return exact


def same_files(a: Path, b: Path, frames) -> None:
    exact = same_frames(frames)
    assert a.read_bytes()[:4] == b.read_bytes()[:4]
    assert a.read_bytes() == b.read_bytes() or not exact


def _adj(tmp_path, doc, name="adj.json") -> str:
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


@pytest.mark.parametrize("doc", [{"exposure": 1.0, "contrast": 20},
                                 {"exposure": 0.4, "vignetteAmount": -30, "clarity": 25,
                                  "grainAmount": 20}])
def test_develop_with_adjustments(tmp_path, frames, doc):
    src = _jpeg(tmp_path / "in.jpg")
    adj = _adj(tmp_path, doc)
    (rj, oj, _), (rp, op, _) = both(
        lambda s: ["develop", src, "-a", adj, "-o", str(tmp_path / f"{s}.jpg")], frames)
    assert rj == rp == 0 and oj.strip().endswith("jax.jpg") and op.strip().endswith("port.jpg")
    assert Image.open(tmp_path / "port.jpg").size == (64, 48)
    same_files(tmp_path / "jax.jpg", tmp_path / "port.jpg", frames)


def test_develop_accepts_sidecar_format_adjustments(tmp_path, frames):
    src = _jpeg(tmp_path / "in.jpg")
    adj = _adj(tmp_path, {"version": 1, "rating": 3, "adjustments": {"exposure": 2.0}},
               "meta.rrdata")
    both(lambda s: ["develop", src, "-a", adj, "-o", str(tmp_path / f"{s}.jpg")], frames)
    same_files(tmp_path / "jax.jpg", tmp_path / "port.jpg", frames)
    bright = np.asarray(Image.open(tmp_path / "port.jpg")).mean()
    assert bright > np.asarray(Image.open(src)).mean()


def test_develop_uses_sidecar(tmp_path, frames):
    from rapidraw_tpu_torch.io.sidecar import save_sidecar

    src = _jpeg(tmp_path / "in.jpg")
    save_sidecar(src, {"adjustments": {"exposure": 2.0, "shadows": 30}})
    both(lambda s: ["develop", src, "-o", str(tmp_path / f"{s}.jpg")], frames)
    same_files(tmp_path / "jax.jpg", tmp_path / "port.jpg", frames)


def test_develop_honors_app_settings(tmp_path, frames, monkeypatch):
    data_dir = tmp_path / "_appdata"
    data_dir.mkdir()
    monkeypatch.setenv("RAPIDRAW_DATA_DIR", str(data_dir))
    src = _jpeg(tmp_path / "in.jpg")
    adj = _adj(tmp_path, {"exposure": 0.8, "contrast": 30})
    both(lambda s: ["develop", src, "-a", adj, "-o", str(tmp_path / f"d_{s}.jpg")], frames)
    same_files(tmp_path / "d_jax.jpg", tmp_path / "d_port.jpg", frames)
    (data_dir / "settings.json").write_text(json.dumps(
        {"tonemapperOverrideEnabled": True, "defaultNonRawTonemapper": "agx"}))
    both(lambda s: ["develop", src, "-a", adj, "-o", str(tmp_path / f"a_{s}.jpg")], frames)
    same_files(tmp_path / "a_jax.jpg", tmp_path / "a_port.jpg", frames)
    a = np.asarray(Image.open(tmp_path / "d_port.jpg"), dtype=np.int16)
    b = np.asarray(Image.open(tmp_path / "a_port.jpg"), dtype=np.int16)
    assert np.abs(a - b).max() > 2, "tonemapper override had no effect"


def test_develop_strips_clipping_overlay_png(tmp_path):
    """A 16-bit PNG from the float render, as JAX writes it, and no
    clipping overlay baked in."""
    src = _jpeg(tmp_path / "in.jpg")
    clip = _adj(tmp_path, {"exposure": 3.0, "showClipping": True}, "clip.json")
    plain = _adj(tmp_path, {"exposure": 3.0}, "plain.json")
    both(lambda s: ["develop", src, "-a", clip, "-o", str(tmp_path / f"clip_{s}.png")])
    run("port", ["develop", src, "-a", plain, "-o", str(tmp_path / "plain_port.png")])
    a = np.asarray(Image.open(tmp_path / "clip_port.png"))
    np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "plain_port.png")))
    w = np.asarray(Image.open(tmp_path / "clip_jax.png"))
    assert a.shape == w.shape and a.dtype == w.dtype
    assert np.abs(a.astype(np.int32) - w.astype(np.int32)).max() <= 257


def test_develop_equals_export(tmp_path, frames):
    """`develop X` and `export X` write the same JPEG on the port, and
    each matches JAX's."""
    from rapidraw_tpu_torch.io.sidecar import save_sidecar

    src = _jpeg(tmp_path / "in.jpg", seed=3)
    save_sidecar(src, {"adjustments": {"exposure": 0.5, "vibrance": 20, "shadows": 20}})
    both(lambda s: ["develop", src, "-o", str(tmp_path / f"dev_{s}.jpg")], frames)
    same_files(tmp_path / "dev_jax.jpg", tmp_path / "dev_port.jpg", frames)
    both(lambda s: ["export", src, "-o", str(tmp_path / f"out_{s}")], frames)
    [pj] = list((tmp_path / "out_jax").iterdir())
    [pp] = list((tmp_path / "out_port").iterdir())
    assert pj.name == pp.name == "in_edited.jpg"
    same_files(pj, pp, frames)
    assert pp.read_bytes() == (tmp_path / "dev_port.jpg").read_bytes()


def test_develop_takes_the_tiled_path_above_the_threshold(tmp_path, monkeypatch):
    """An image whose long edge passes TILED_ABOVE goes through
    develop_tiled (shown with a threshold of 48 px and 32-pixel tiles); the
    file equals the whole-image develop's."""
    from rapidraw_tpu_torch.pipeline import develop as pdevelop
    from rapidraw_tpu_torch.pipeline import tiled

    src = _jpeg(tmp_path / "in.jpg", h=48, w=64, seed=4)
    adj = _adj(tmp_path, {"exposure": 0.6, "vignetteAmount": -40, "grainAmount": 25,
                          "clarity": 10})
    assert run("port", ["develop", src, "-a", adj, "-o", str(tmp_path / "whole.jpg")])[0] == 0
    calls = []
    real = tiled.develop_tiled

    def spy(image, params, cfg, **kw):
        calls.append(tuple(image.shape))
        return real(image, params, cfg, **dict(kw, tile_size=32, overlap=16))

    offsets = []
    real_develop = pdevelop.develop

    def develop_spy(image, params, cfg, **kw):  # each tile's develop
        offsets.append(kw["tile_offset"])
        return real_develop(image, params, cfg, **kw)

    monkeypatch.setattr(tiled, "develop_tiled", spy)
    monkeypatch.setattr(pdevelop, "develop", develop_spy)
    monkeypatch.setattr(pcli, "TILED_ABOVE", 48)
    rc, _, err = run("port", ["develop", src, "-a", adj, "-o", str(tmp_path / "tiled.jpg"),
                              "--timings"])
    assert rc == 0 and calls == [(3, 48, 64)]
    assert offsets == [(0, 0), (16, 0), (0, 16), (16, 16)]
    assert (tmp_path / "tiled.jpg").read_bytes() == (tmp_path / "whole.jpg").read_bytes()
    # --timings: one JSON line on stderr, each stage's ms, the launches
    [line] = [ln for ln in err.splitlines() if ln.startswith('{"timings"')]
    t = json.loads(line)["timings"]
    assert {"load", "prepare", "develop", "readback", "encode"} <= set(t["stages_ms"])
    assert "main_at" in t and set(t["launches"]) >= {"grade", "blur"}


def test_export_batches_and_virtual_copies(tmp_path, frames):
    from rapidraw_tpu_torch.io.sidecar import save_sidecar
    from rapidraw_tpu_torch.library.catalog import create_virtual_copy

    paths = []
    for i in range(2):
        p = _jpeg(tmp_path / f"img{i}.jpg", seed=i)
        save_sidecar(p, {"adjustments": {"exposure": 0.5, "vibrance": 20}})
        paths.append(p)
    vc = create_virtual_copy(paths[0])
    save_sidecar(vc, {"adjustments": {"exposure": 1.0}})
    (rj, oj, ej), (rp, op, ep) = both(
        lambda s: ["export", *paths, vc, "-o", str(tmp_path / s), "--batch-size", "2"], frames)
    assert rj == rp == 0, (ej, ep)
    names = sorted(q.name for q in (tmp_path / "port").iterdir())
    assert names == sorted(q.name for q in (tmp_path / "jax").iterdir())
    assert any("VC01" in n for n in names)
    exact = same_frames(frames)
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
                or not exact)


def test_develop_virtual_copy_default_output(tmp_path, monkeypatch):
    from rapidraw_tpu_torch.io.sidecar import save_sidecar
    from rapidraw_tpu_torch.library.catalog import create_virtual_copy

    src = _jpeg(tmp_path / "in.jpg")
    vc = create_virtual_copy(src)
    save_sidecar(vc, {"adjustments": {"exposure": 1.0}})
    monkeypatch.chdir(tmp_path)
    assert run("port", ["develop", vc])[0] == 0
    assert (tmp_path / "in_vc1_edited.jpg").exists()


def test_auto_and_histogram(tmp_path):
    src = _jpeg(tmp_path / "in.jpg")
    (rj, oj, _), (rp, op, _) = both(lambda s: ["auto", src])
    assert rj == rp == 0 and json.loads(op) == json.loads(oj)
    (rj, oj, _), (rp, op, _) = both(lambda s: ["histogram", src])
    hj, hp = json.loads(oj), json.loads(op)
    assert set(hp) == set(hj) and len(hp["luma"]) == 256
    for k in hj:
        np.testing.assert_allclose(hp[k], hj[k], atol=1e-4)


def test_lut_export_matches_jax(tmp_path):
    adj = _adj(tmp_path, {"exposure": 0.7, "contrast": 25, "saturation": 20,
                          "vignetteAmount": -40, "grainAmount": 30,
                          "hsl": {"reds": {"hue": 10, "saturation": 15, "luminance": 5}}})
    (rj, _, _), (rp, _, _) = both(
        lambda s: ["lut-export", "-a", adj, "--size", "17", "-o", str(tmp_path / f"{s}.cube")])
    assert rj == rp == 0
    from rapidraw_tpu_torch.io.lut import parse_cube

    want = parse_cube((tmp_path / "jax.cube").read_text())
    got = parse_cube((tmp_path / "port.cube").read_text())
    assert got.shape == want.shape == (17, 17, 17, 3)
    d = np.abs(got - want)
    print(f"lut-export L=17: max|d| {d.max():.3e}")
    assert d.max() <= 1e-5
    assert np.abs(got - parse_cube(_identity_cube(17))).max() > 0.05


def _identity_cube(n):
    from rapidraw_tpu_torch.io.lut import identity_lut, lut_to_cube_text

    return lut_to_cube_text(identity_lut(n))


def _twin_dirs(tmp_path):
    """Two copies of one small library (three JPEGs, one sidecar)."""
    from rapidraw_tpu_torch.io.sidecar import save_sidecar

    base = tmp_path / "lib"
    (base / "sub").mkdir(parents=True)
    for i, name in enumerate(("a.jpg", "b.jpg", "sub/c.jpg")):
        _jpeg(base / name, seed=i)
    save_sidecar(str(base / "a.jpg"), {"adjustments": {"exposure": 0.2}, "virtualCopies": [1]})
    for side in ("jax", "port"):
        shutil.copytree(base, tmp_path / side)
    return tmp_path / "jax", tmp_path / "port"


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_lib_verbs_match_jax(tmp_path):
    dj, dp = _twin_dirs(tmp_path)
    d = {"jax": dj, "port": dp}
    steps = [
        lambda s: ["lib", "ls", str(d[s]), "-r"],
        lambda s: ["lib", "rate", "4", str(d[s] / "a.jpg"), str(d[s] / "b.jpg")],
        lambda s: ["lib", "label", "red", str(d[s] / "b.jpg")],
        lambda s: ["lib", "tag-add", "--tags", "sky,sea", str(d[s] / "a.jpg")],
        lambda s: ["lib", "tag-remove", "--tags", "sky", str(d[s] / "a.jpg")],
        lambda s: ["lib", "types"],
        lambda s: ["lib", "dims", str(d[s] / "a.jpg"), str(d[s] / "sub" / "c.jpg")],
    ]
    for step in steps:
        (rj, oj, _), (rp, op, _) = both(step)
        assert rj == rp == 0
        assert op == oj.replace(str(dj), str(dp))
    assert _tree(dp) == _tree(dj)
    (rj, oj, _), (rp, op, _) = both(lambda s: ["lib", "clear-sidecars", str(d[s])])
    assert op == oj and int(op) == 2 and _tree(dp) == _tree(dj)


def test_exif_set_visible_in_read(tmp_path):
    dj, dp = _twin_dirs(tmp_path)
    d = {"jax": dj, "port": dp}
    for sets in (["Artist=Tester", "Make=CamCo"], ["Make="]):
        (rj, oj, _), (rp, op, _) = both(
            lambda s: ["exif", str(d[s] / "b.jpg"), "--set", *sets])
        assert rj == rp == 0
        assert json.loads(op)[str(dp / "b.jpg")] == json.loads(oj)[str(dj / "b.jpg")]
    tags = json.loads(op)[str(dp / "b.jpg")]
    assert "Make" not in tags and tags["Artist"] == "Tester"
    assert _tree(dp) == _tree(dj)


_XMP = """<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF
 xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
 <rdf:Description xmlns:crs="http://ns.adobe.com/camera-raw-settings/1.0/"
  crs:Exposure2012="+0.50" crs:Contrast2012="+15" crs:Shadows2012="+20"
  crs:Vibrance="+10" crs:Clarity2012="+5" crs:HueAdjustmentRed="+8">
  <crs:Name><rdf:Alt><rdf:li xml:lang="x-default">Moody</rdf:li></rdf:Alt></crs:Name>
 </rdf:Description></rdf:RDF></x:xmpmeta>"""


def test_preset_verbs_match_jax(tmp_path):
    dj, dp = _twin_dirs(tmp_path)
    d = {"jax": dj, "port": dp}
    xmp = tmp_path / "moody.xmp"
    xmp.write_text(_XMP)
    shared = tmp_path / "share.json"
    shared.write_text(json.dumps([{"name": "Warm", "adjustments": {"temperature": 20}}]))

    def store(s):
        return ["preset", "--store", str(d[s] / "presets.json")]

    steps = [
        lambda s: store(s) + ["import", str(xmp)],
        lambda s: store(s) + ["import", str(shared)],
        lambda s: store(s) + ["list"],
        lambda s: store(s) + ["show", "Warm"],
        lambda s: store(s) + ["apply", "Warm", str(d[s] / "a.jpg"), str(d[s] / "b.jpg")],
        lambda s: store(s) + ["reset", str(d[s] / "b.jpg")],
        lambda s: store(s) + ["export", str(d[s] / "out.json")],
    ]
    for step in steps:
        (rj, oj, _), (rp, op, _) = both(step)
        assert rj == rp == 0 and op == oj
    # preset ids are fresh uuids on each side: compare the rest
    for name in ("presets.json", "out.json"):
        j, p = (json.loads((x / name).read_text()) for x in (dj, dp))
        strip = (lambda doc: [{k: v for k, v in q.items() if k != "id"}
                              for q in (doc["presets"] if isinstance(doc, dict) else doc)])
        assert strip(p) == strip(j)
    tj, tp = _tree(dj), _tree(dp)
    assert {k: v for k, v in tp.items() if k.endswith(".rrdata")} == \
        {k: v for k, v in tj.items() if k.endswith(".rrdata")}
    (rj, _, _), (rp, _, _) = both(lambda s: store(s) + ["show", "missing"])
    assert rj == rp == 1


@pytest.mark.parametrize("argv,slice_", [
    (["denoise", "x.jpg", "--method", "ai"], "A.13"), (["tag", "."], "A.13"),
    (["lib", "clear-ai-tags", "."], "A.13"),
])
def test_later_verbs_exit_2_naming_their_slice(argv, slice_):
    rc, out, err = run("port", argv)
    assert rc == 2 and out == "" and f"slice {slice_}" in err


def _read16(path) -> np.ndarray:
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.int32)


def _bracket(tmp_path) -> list[str]:
    """Three bracketed JPEGs of one scene with ExposureTime and ISO."""
    from PIL.TiffImagePlugin import IFDRational

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:40, 0:56]
    scene = np.stack([0.2 + 0.7 * xx / 56, 0.3 + 0.5 * yy / 40, 0.4 + 0.2 * np.sin(xx / 5)], -1)
    paths = []
    for i, (den, iso) in enumerate([(500, 100), (125, 100), (30, 200)]):
        lin = np.clip(scene * (iso / 100) * 60 / den + rng.normal(0, 0.01, scene.shape), 0, 1)
        e = Image.Exif()
        e[0x8769] = {0x829A: IFDRational(1, den), 0x8827: iso}
        p = tmp_path / f"br{i}.jpg"
        Image.fromarray((lin ** (1 / 2.2) * 255).astype(np.uint8)).save(p, quality=95, exif=e)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("verb", ["negative", "cull", "hdr", "panorama", "denoise"])
def test_composition_verbs_match_jax(tmp_path, verb):
    """The composition verbs on small files give JAX's outputs: the
    negative and the HDR merge within one 16-bit step, BM3D's PNG pixels
    equal, culling's JSON equal, the panorama's size within 2 px and its
    mean within 2e-3 (its own features, tests/test_torch_panorama.py)."""
    out = {s: tmp_path / s for s in ("jax", "port")}
    for d in out.values():
        d.mkdir()
    if verb == "negative":
        src = _jpeg(tmp_path / "neg.jpg", 60, 80, seed=1)
        argv = lambda s: ["negative", src, "-o", str(out[s] / "pos.tiff"), "--red", "0.9",
                          "--exposure", "0.2", "--contrast", "1.3"]
    elif verb == "cull":
        a = _jpeg(tmp_path / "c0.jpg", 60, 80, seed=2)
        shutil.copy(a, tmp_path / "c1.jpg")
        b = _jpeg(tmp_path / "c2.jpg", 70, 50, seed=3)
        argv = lambda s: ["cull", a, str(tmp_path / "c1.jpg"), b]
    elif verb == "hdr":
        br = _bracket(tmp_path)
        argv = lambda s: ["hdr", *br, "-o", str(out[s] / "m.png")]
    elif verb == "panorama":
        from tests.test_panorama import _scene

        scene = (_scene().transpose(1, 2, 0) * 255).astype(np.uint8)
        truth = scene[..., ::-1].astype(np.int32) * 257  # as the 16-bit PNG reads back
        left, right = tmp_path / "l.png", tmp_path / "r.png"
        Image.fromarray(scene[:, :400]).save(left)
        Image.fromarray(scene[:, 240:]).save(right)
        argv = lambda s: ["panorama", str(left), str(right), "-o", str(out[s] / "p.png")]
    else:
        src = _jpeg(tmp_path / "noisy.jpg", 40, 48, seed=4)
        argv = lambda s: ["denoise", src, "-o", str(out[s] / "d.png"), "--intensity", "0.6"]
    (rj, oj, ej), (rp, op, ep) = both(argv)
    assert rj == rp == 0, (ej, ep)
    if verb == "cull":
        assert json.loads(op) == json.loads(oj)
        return
    assert op.strip() != "" and oj.strip() != ""
    name = {"negative": "pos.tiff", "hdr": "m.png", "panorama": "p.png",
            "denoise": "d.png"}[verb]
    g, w = _read16(out["port"] / name), _read16(out["jax"] / name)
    if verb == "panorama":
        assert abs(g.shape[0] - w.shape[0]) <= 2 and abs(g.shape[1] - w.shape[1]) <= 2
        h, wd = truth.shape[0] - 4, truth.shape[1] - 4

        def err(x):
            return min(np.abs(x[2 + dy:2 + dy + h, 2 + dx:2 + dx + wd] - truth[2:-2, 2:-2]).mean()
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1))

        assert err(g) <= err(w), (err(g), err(w))
    elif verb == "denoise":
        np.testing.assert_array_equal(g, w)
    else:
        assert g.shape == w.shape and int(np.abs(g - w).max()) <= 1


def test_without_a_card_the_cli_fails(tmp_path):
    """No --device: the CUDA device, which this machine lacks. The CLI
    exits with an error; it does not carry on on the CPU."""
    assert not torch.cuda.is_available()
    src = _jpeg(tmp_path / "in.jpg")
    for argv in (["develop", src, "-o", str(tmp_path / "o.jpg")], ["auto", src],
                 ["histogram", src], ["export", src, "-o", str(tmp_path / "x")],
                 ["lut-export", "--image", src, "-o", str(tmp_path / "g.cube")],
                 ["negative", src], ["cull", src, src], ["hdr", src, src],
                 ["denoise", src], ["panorama", src, src]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            pcli.main(argv)
    assert not (tmp_path / "o.jpg").exists() and not (tmp_path / "x").exists()
    # --device before the verb works as after it
    assert pcli.main(["--device", "cpu", "develop", src, "-o", str(tmp_path / "o.jpg")]) == 0
