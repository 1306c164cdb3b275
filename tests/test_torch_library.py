"""The port's library modules against the JAX package's: the catalog
(library/catalog.py), presets (library/presets.py), the Lightroom XMP
converter (library/preset_converter.py), the lensfun DB (lens/db.py), the
EXIF writer (`io/exif.update_exif_fields`) and the dimension queries
(`io/containers.raw_dimensions` and the catalog's `get_image_dimensions`).

The cases of tests/test_library.py (catalog, presets), of
tests/test_preset_converter.py and of tests/test_components.py's lensfun
tests run on both packages (`Side`), each in its own directory, and their
results and files are held equal. `get_image_dimensions` is held to JAX
on RAW containers of every layout the port decodes (chip_smoke.py's
writers at small sizes, X3F and CRW from tests/test_x3f_crw.py) and on
JPEG, PNG and TIFF; and to PIL's `Image.open(p).size` on each LDR format
whose header the port reads, ICO and DDS among them. The formats JAX's PIL
does not identify (hdr, exr, ff, pam, jxl) raise OSError on both.
"""

from __future__ import annotations

import io
import json
import struct
import types

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from rapidraw_tpu.io import exif as jexif
from rapidraw_tpu.io import sidecar as jsidecar
from rapidraw_tpu.lens import db as jlens
from rapidraw_tpu.library import catalog as jcatalog
from rapidraw_tpu.library import preset_converter as jconv
from rapidraw_tpu.library import presets as jpresets
from rapidraw_tpu_torch.io import containers as pcontainers
from rapidraw_tpu_torch.io import exif as pexif
from rapidraw_tpu_torch.io import sidecar as psidecar
from rapidraw_tpu_torch.lens import db as plens
from rapidraw_tpu_torch.library import catalog as pcatalog
from rapidraw_tpu_torch.library import preset_converter as pconv
from rapidraw_tpu_torch.library import presets as ppresets

JAX = types.SimpleNamespace(name="jax", catalog=jcatalog, presets=jpresets, sidecar=jsidecar,
                            conv=jconv, lens=jlens, exif=jexif)
PORT = types.SimpleNamespace(name="port", catalog=pcatalog, presets=ppresets,
                             sidecar=psidecar, conv=pconv, lens=plens, exif=pexif)


def _jpg(path, h=32, w=48, exif=None):
    arr = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    kw = {"quality": 92}
    if exif is not None:
        kw["exif"] = exif
    Image.fromarray(arr).save(path, **kw)
    return path


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def on_both(tmp_path, fn):
    """fn(side, its own directory) on JAX and on the port; the results and
    the directories' files must be equal (paths relative to each)."""
    out = {}
    for side in (JAX, PORT):
        root = tmp_path / side.name
        root.mkdir()
        res = fn(side, root)
        out[side.name] = json.loads(json.dumps(res, default=str).replace(str(root), "ROOT"))
    assert out["port"] == out["jax"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    return out["port"]


def test_catalog_listing_and_vc(tmp_path):
    def case(s, root):
        (root / "sub").mkdir()
        _jpg(root / "a.jpg")
        _jpg(root / "sub" / "b.jpg")
        (root / "notes.txt").write_text("x")
        kids = [n.name for n in s.catalog.folder_children(root)]
        flat = s.catalog.list_images(root)
        rec = s.catalog.list_images(root, recursive=True)
        vc = s.catalog.create_virtual_copy(str(root / "a.jpg"))
        return kids, flat, rec, vc, s.catalog.list_images(root)

    kids, flat, rec, vc, after = on_both(tmp_path, case)
    assert kids == ["sub"] and len(rec) == 2 and vc.endswith("?vc=1") and len(after) == 2


def test_catalog_file_ops_keep_sidecars(tmp_path):
    def case(s, root):
        src = _jpg(root / "a.jpg")
        s.sidecar.save_sidecar(src, {"rating": 3, "adjustments": {"exposure": 1}})
        moved = s.catalog.move_image(src, root / "out")
        renamed = s.catalog.rename_image(moved, "b")
        s.catalog.copy_image(renamed, root / "copy")
        rating = s.catalog.get_rating(renamed)
        s.catalog.delete_image(renamed)
        return moved, renamed, rating

    moved, renamed, rating = on_both(tmp_path, case)
    assert renamed.endswith("b.jpg") and rating == 3


def test_ratings_labels_tags(tmp_path):
    def case(s, root):
        p = _jpg(root / "a.jpg")
        s.catalog.set_rating(p, 9)
        s.catalog.set_color_label(p, "red")
        s.catalog.add_tags(p, ["user:sky", "user:sea"])
        tags = s.catalog.remove_tags(p, ["user:sky"])
        return s.catalog.get_rating(p), s.sidecar.load_sidecar(p)["colorLabel"], tags

    assert on_both(tmp_path, case) == [5, "red", ["user:sea"]]


def test_albums_folders_and_sidecar_clearing(tmp_path):
    def case(s, root):
        a = s.catalog.Albums(root / "albums.json")
        a.create("trip")
        a.add("trip", ["x.jpg", "y.jpg"])
        a.add("trip", ["x.jpg"])
        a2 = s.catalog.Albums(root / "albums.json")
        a2.remove("trip", ["x.jpg"])
        s.catalog.create_folder(root / "shoot")
        p = _jpg(root / "shoot" / "c.jpg")
        s.sidecar.save_sidecar(p, {"rating": 1})
        new = s.catalog.rename_folder(root / "shoot", "day1", albums=a2)
        n = s.catalog.clear_all_sidecars(root)
        return a2.images("trip"), new, n, s.catalog.get_supported_file_types()

    images, new, n, types_ = on_both(tmp_path, case)
    assert images == ["y.jpg"] and n == 1 and "dng" in types_["raw"]


def test_presets(tmp_path):
    def case(s, root):
        store = s.presets.PresetStore(root / "presets.json")
        store.add("Punchy", {"contrast": 30, "vibrance": 20, "curves": {"luma": []}})
        merged = s.presets.apply_preset({"exposure": 1.0}, store.get("Punchy")["adjustments"])
        merged2 = s.presets.apply_preset({}, store.get("Punchy")["adjustments"],
                                         sections=["color"])
        (root / "community.json").write_text(
            '[{"name": "Film", "adjustments": {"grainAmount": 40}}]')
        imported = store.import_file(root / "community.json")
        s.presets.export_presets_to_file(store.list(), root / "share.json")
        again = s.presets.PresetStore(root / "other.json").import_file(root / "share.json")
        img = _jpg(root / "a.jpg")
        s.presets.apply_adjustments_to_paths([img], {"exposure": 0.3})
        s.presets.reset_adjustments_for_paths([_jpg(root / "b.jpg")])
        strip = [{k: v for k, v in p.items() if k != "id"} for p in imported + again]
        return merged, merged2, strip, [p["name"] for p in store.list()]

    # preset ids are fresh uuids: the stores' files differ only there
    out = {}
    for side in (JAX, PORT):
        root = tmp_path / side.name
        root.mkdir()
        out[side.name] = case(side, root)
        for name in ("presets.json", "share.json", "other.json"):
            text = (root / name).read_text()
            doc = json.loads(text)
            items = doc["presets"] if isinstance(doc, dict) else doc
            for p in items:
                p["id"] = "ID"
            (root / name).write_text(json.dumps(doc))
    assert out["port"] == out["jax"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    merged, merged2 = out["port"][:2]
    assert merged["contrast"] == 30 and "vibrance" in merged2 and "contrast" not in merged2


def test_auto_adjustments_to_paths(tmp_path):
    """The port's load and analysis on the CPU against JAX's."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    for side in (JAX, PORT):
        root = tmp_path / side.name
        root.mkdir()
        paths = [str(_jpg(root / "a.jpg")), str(root / "missing.jpg")]
        kw = {"device": "cpu"} if side is PORT else {}
        side.presets.apply_auto_adjustments_to_paths(paths, **kw)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_resolve_lens_in_adjustments():
    for exif in ({"LensModel": "Super 35mm f/1.8", "LensMake": "Acme", "FocalLength": "35"},
                 {"Lens": "Acme Zoomer 24-70mm", "Make": "Acme", "FocalLength": "467/10"},
                 {"LensModel": "Nope", "Make": "Acme"}):
        got = []
        for side in (JAX, PORT):
            adj = {"lensDistortionAmount": 100}
            side.presets._resolve_lens_in_adjustments(
                adj, exif, side.lens.parse_lensfun_xml(LENSFUN_XML))
            got.append(adj)
        assert got[0] == got[1]


_XMP = open(__file__.replace("test_torch_library.py", "test_preset_converter.py")).read()
_XMP = _XMP[_XMP.index('"""<?xpacket') + 3:_XMP.index('</x:xmpmeta>') + len('</x:xmpmeta>')]


def test_preset_converter_matches_jax(tmp_path):
    want = jconv.convert_xmp_to_preset(_XMP)
    got = pconv.convert_xmp_to_preset(_XMP)
    want.pop("id", None)
    got.pop("id", None)
    assert got == want
    a = got["adjustments"]
    assert got["name"] == "Moody Teal" and a["shadows"] == 60.0
    assert a["hsl"]["reds"]["hue"] == -15.0 and a["curves"]["luma"][0] == {"x": 0, "y": 16}

    def case(s, root):
        f = root / "moody.xmp"
        f.write_text(_XMP)
        out = s.presets.PresetStore(root / "p.json").import_file(f)
        (root / "p.json").write_text((root / "p.json").read_text().replace(out[0]["id"], "ID"))
        return [{k: v for k, v in p.items() if k != "id"} for p in out]

    assert on_both(tmp_path, case)[0]["adjustments"]["contrast"] == 18


LENSFUN_XML = """<lensdatabase>
  <lens>
    <maker>Acme</maker>
    <model>Acme Super 35mm f/1.8</model>
    <model lang="en">Super 35mm f/1.8</model>
    <mount>acme-x</mount>
    <cropfactor>1.5</cropfactor>
    <calibration>
      <distortion model="poly3" focal="35" k1="-0.01" />
      <tca model="linear" focal="35" vr="1.0002" vb="0.9998" />
      <vignetting model="pa" focal="35" aperture="1.8" distance="10" k1="-0.5" k2="0.1" k3="0.0" />
      <vignetting model="pa" focal="35" aperture="4.0" distance="10" k1="-0.2" k2="0.05" k3="0.0" />
    </calibration>
  </lens>
  <lens>
    <maker>Acme</maker>
    <model>Acme Zoomer 24-70mm f/2.8</model>
    <mount>acme-x</mount>
    <calibration>
      <distortion model="ptlens" focal="24" a="0.01" b="-0.02" c="0.005" />
      <distortion model="ptlens" focal="70" a="0.02" b="-0.04" c="0.01" />
    </calibration>
  </lens>
</lensdatabase>"""


@pytest.mark.parametrize("query", [
    ("Acme", "Super 35mm f/1.8", 35.0, 1.8), ("Acme", "Super 35mm f/1.8", 35.0, 5.6),
    ("Acme", "Zoomer 24-70", 47.0, None), ("Acme", "Super 35 1.8", 30.0, None),
    ("Other", "Lens", 50.0, None)])
def test_lens_db_matches_jax(query, tmp_path):
    """The lensfun XML of tests/test_components.py: parse, fuzzy match,
    focal and aperture interpolation, from a string and from a directory."""
    maker, model, focal, aperture = query
    (tmp_path / "db.xml").write_text(LENSFUN_XML)
    out = []
    for side in (JAX, PORT):
        db = side.lens.parse_lensfun_xml(LENSFUN_XML)
        on_disk = side.lens.load_lensfun_dir(tmp_path)
        kw = {} if aperture is None else {"aperture": aperture}
        out.append((side.lens.resolve_lens_params(db, maker, model, focal, **kw),
                    side.lens.find_best_lens_match(db, maker, model),
                    [(l.maker(), l.short_name()) for l in on_disk.lenses],
                    db.lenses[1].distortion_params(focal)))
    assert out[0] == out[1]


def test_update_exif_fields_matches_jax(tmp_path):
    exif = Image.Exif()
    exif[0x010F] = "AcmeCam"
    exif[0x0110] = "Model-X"

    def case(s, root):
        src = _jpg(root / "e.jpg", exif=exif)
        s.exif.update_exif_fields([src], {"Artist": " Tester ", "Make": "CamCo"})
        first = s.exif.effective_exif_tags(src)
        s.exif.update_exif_fields([src], {"Make": ""})
        return first, s.exif.effective_exif_tags(src)

    first, second = on_both(tmp_path, case)
    assert first["Artist"] == "Tester" and first["Make"] == "CamCo"
    assert "Make" not in second and second["Model"] == "Model-X"


# ---- dimensions ------------------------------------------------------------

RAW_KINDS = ("cr2", "cr3", "nef", "arw", "pef", "orf_packed", "orf_predictive", "rw2", "mrw",
             "srw", "iiq5")
RAW_EXT = {"cr2": "cr2", "cr3": "cr3", "nef": "nef", "arw": "arw", "pef": "pef",
           "orf_packed": "orf", "orf_predictive": "orf", "rw2": "rw2", "mrw": "mrw",
           "srw": "srw", "iiq5": "iiq"}


def _raw_files(root) -> dict:
    files = {}
    cfa = chip_smoke.photo_cfa(64, 96, 0, 4000, 3)
    files["dng"] = chip_smoke.raw_dng_bytes(cfa)
    files["dng_orient6"] = chip_smoke.raw_dng_bytes(cfa, orientation=6)
    xtrans = np.array([[1, 1, 0, 1, 1, 2], [1, 1, 2, 1, 1, 0], [2, 0, 1, 0, 2, 1],
                       [1, 1, 2, 1, 1, 0], [1, 1, 0, 1, 1, 2], [0, 2, 1, 2, 0, 1]], np.int32)
    files["raf"] = chip_smoke.raw_raf_bytes(chip_smoke.photo_cfa(48, 72, 0, 4000, 4), xtrans)
    for kind in RAW_KINDS:
        h, w = {"orf_predictive": (32, 48), "rw2": (48, 56)}.get(kind, (48, 64))
        files[kind] = chip_smoke.vendor_file(kind, h, w, 5)[0]
    from test_x3f_crw import _build_crw, _build_x3f

    files["x3f"] = _build_x3f(cols=64, rows=48)
    files["x3f_rot"] = _build_x3f(cols=64, rows=48, rotation=90)
    files["crw"] = _build_crw(width=80, height=56)
    out = {}
    for name, data in files.items():
        ext = {"dng_orient6": "dng", "x3f_rot": "x3f"}.get(name, RAW_EXT.get(name, name))
        p = root / f"{name}.{ext}"
        p.write_bytes(data)
        out[name] = p
    return out


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)


def test_raw_dimensions_match_jax(tmp_path):
    """Every RAW layout the port decodes, and X3F and CRW (read for their
    dimensions only), through the catalog's query and `raw_dimensions`,
    against JAX: the same size or the same refusal (chip_smoke.py's CR2 has
    no dimensioned IFD, so both refuse it); a virtual-copy path reads its
    real file."""
    sized = 0
    for name, p in _raw_files(tmp_path).items():
        want = _outcome(jcatalog.get_image_dimensions, str(p))
        assert _outcome(pcatalog.get_image_dimensions, str(p)) == want, name
        assert _outcome(pcatalog.get_image_dimensions, f"{p}?vc=2") == want, name
        assert _outcome(pcontainers.raw_dimensions, p.read_bytes(), p.suffix[1:]) == want, name
        sized += isinstance(want[0], int) and min(want) > 0
    assert sized == 16


def test_raw_dimensions_refusals_match_jax():
    from rapidraw_tpu.io.containers import raw_dimensions as jdims

    for data, ext in ((b"\x00" * 64, "raw"), (b"II*\x00" + b"\x00" * 8, "dng"),
                      (b"ARRI\x12\x34\x56\x78" + b"\x00" * 8, "ari")):
        with pytest.raises(ValueError) as want:
            jdims(data, ext)
        with pytest.raises(ValueError) as got:
            pcontainers.raw_dimensions(data, ext)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


def _ldr_files(root) -> dict:
    rng = np.random.default_rng(7)
    rgb = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    im = Image.fromarray(rgb)
    files = {}
    for name, kw in {"a.jpg": {}, "b.jpeg": {"progressive": True}, "c.png": {},
                     "d.tif": {}, "e.tiff": {"compression": "tiff_lzw"}, "f.gif": {},
                     "g.bmp": {}, "h.webp": {"lossless": True}, "i.webp": {"quality": 80},
                     "k.qoi": {}, "l.tga": {}, "m.ppm": {}}.items():
        im.save(root / name, **kw)
        files[name] = root / name
    im.convert("L").save(root / "n.pgm")
    im.convert("1").save(root / "o.pbm")
    im.convert("L").save(root / "p.png")
    Image.fromarray((rng.random((37, 53, 4)) * 255).astype(np.uint8)).save(root / "q.webp")
    # a top-down bitmap (negative height) and an OS/2 core header
    bmp = (root / "g.bmp").read_bytes()
    w, h = struct.unpack_from("<ii", bmp, 18)
    (root / "r.bmp").write_bytes(bmp[:22] + struct.pack("<i", -h) + bmp[26:])
    (root / "s.pnm").write_bytes(b"P6\n# a comment\n53 37\n255\n" + rgb.tobytes())
    # an animated WebP (VP8X canvas)
    frames = [Image.fromarray(np.roll(rgb, k, 1)) for k in range(2)]
    frames[0].save(root / "t.webp", save_all=True, append_images=frames[1:], duration=50)
    for name in ("n.pgm", "o.pbm", "p.png", "q.webp", "r.bmp", "s.pnm", "t.webp"):
        files[name] = root / name
    return files


def test_ldr_dimensions_match_pil(tmp_path):
    """Each LDR header the port reads, against PIL's `Image.open(p).size`
    (JAX's read) and against JAX's catalog."""
    for name, p in _ldr_files(tmp_path).items():
        with Image.open(p) as im:
            want = im.size
        assert pcatalog.get_image_dimensions(str(p)) == want, name
        assert jcatalog.get_image_dimensions(str(p)) == want, name


def test_ldr_dimensions_after_large_app_segments(tmp_path):
    """A JPEG whose SOF sits past 64 KB of APP segments, and a JPEG named
    .png: the format is read from the file."""
    rgb = (np.random.default_rng(1).random((20, 30, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    seg = b"\xff\xe2" + struct.pack(">H", 65000) + bytes(64998)
    (tmp_path / "big.jpg").write_bytes(data[:2] + seg + seg + data[2:])
    (tmp_path / "named.png").write_bytes(data)
    for name in ("big.jpg", "named.png"):
        with Image.open(tmp_path / name) as im:
            assert pcatalog.get_image_dimensions(str(tmp_path / name)) == im.size == (30, 20)


def test_unread_headers_name_the_slice(tmp_path):
    """ICO (PNG and BMP entries) and DDS read as PIL's `.size` gives them;
    the five formats JAX's PIL does not identify raise OSError on both
    packages."""
    rgb = (np.random.default_rng(2).random((16, 24, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.ico")
    Image.fromarray(rgb).save(tmp_path / "b.dds")
    Image.fromarray(rgb).save(tmp_path / "e.ico", bitmap_format="bmp", sizes=[(24, 24), (16, 16)])
    Image.fromarray(rgb).save(tmp_path / "f.dds", pixel_format="DXT5")
    from rapidraw_tpu_torch.io.float_images import write_hdr

    (tmp_path / "c.hdr").write_bytes(write_hdr(rgb.astype(np.float32) / 255.0))
    (tmp_path / "d.ff").write_bytes(b"farbfeld" + struct.pack(">II", 24, 16) + bytes(16 * 24 * 8))
    (tmp_path / "g.pam").write_bytes(b"P7\nWIDTH 24\nHEIGHT 16\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
                                     + rgb.tobytes())
    (tmp_path / "h.exr").write_bytes(b"\x76\x2f\x31\x01" + bytes(60))
    (tmp_path / "i.jxl").write_bytes(b"\xff\x0a" + bytes(30))
    for name in ("a.ico", "b.dds", "e.ico", "f.dds"):
        with Image.open(tmp_path / name) as im:
            want = im.size
        assert pcatalog.get_image_dimensions(str(tmp_path / name)) == want, name
        assert jcatalog.get_image_dimensions(str(tmp_path / name)) == want, name
    for name in ("c.hdr", "d.ff", "g.pam", "h.exr", "i.jxl"):
        with pytest.raises(OSError):
            pcatalog.get_image_dimensions(str(tmp_path / name))
        with pytest.raises(OSError):
            jcatalog.get_image_dimensions(str(tmp_path / name))
