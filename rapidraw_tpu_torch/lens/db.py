"""Lensfun XML database: parsing, coefficient interpolation, autodetect.

Copy of `rapidraw_tpu/lens/db.py` (host Python).

Port of lens_correction.rs: the lensfun schema subset the reference reads
(:13-158), piecewise-linear focal interpolation of distortion/TCA
coefficients (:296-385), nearest-aperture/distance + focal interpolation
for vignetting (:387-476), model extraction (poly3/poly5 -> model 0,
ptlens -> model 1, :491-509), and fuzzy lens autodetect from EXIF
maker/model (:643-724).

Point `load_lensfun_dir` at any lensfun database checkout (version 1/2
XMLs); the output `LensDistortionParams` dict plugs directly into the
adjustment JSON's `lensDistortionParams` (geometry/params.py).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Distortion:
    model: str
    focal: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0


@dataclass
class Tca:
    focal: float
    vr: float = 1.0
    vb: float = 1.0


@dataclass
class Vignetting:
    focal: float
    aperture: float
    distance: float = 1000.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0


@dataclass
class Lens:
    makers: list = field(default_factory=list)  # (lang, value)
    models: list = field(default_factory=list)
    mounts: list = field(default_factory=list)
    cropfactor: float | None = None
    distortions: list = field(default_factory=list)
    tcas: list = field(default_factory=list)
    vignettings: list = field(default_factory=list)

    def _named(self, entries, lang):
        for lg, v in entries:
            if lg == lang:
                return v
        return entries[0][1] if entries else None

    def full_model_name(self) -> str:
        return self._named(self.models, "en") or "Unknown Model"

    def canonical_model_name(self) -> str:
        return self._named(self.models, None) or "Unknown Model"

    def maker(self) -> str:
        return self._named(self.makers, "en") or "Misc"

    def short_name(self) -> str:
        return _strip_maker_prefix(self.full_model_name(), self.maker())

    def display_name(self, maker_lenses: list["Lens"]) -> str:
        """Disambiguation ladder (lens_correction.rs:221-263)."""
        my_short = self.short_name()
        if sum(1 for l in maker_lenses if l.short_name() == my_short) <= 1:
            return my_short
        my_canon_short = _strip_maker_prefix(self.canonical_model_name(), self.maker())
        if (
            sum(
                1
                for l in maker_lenses
                if _strip_maker_prefix(l.canonical_model_name(), l.maker()) == my_canon_short
            )
            <= 1
        ):
            return my_canon_short
        my_canon = self.canonical_model_name()
        if sum(1 for l in maker_lenses if l.canonical_model_name() == my_canon) <= 1:
            return my_canon
        if self.cropfactor is not None:
            return f"{my_canon_short} (crop {self.cropfactor:.1f}x)"
        return my_canon_short

    def distortion_params(
        self, focal_length: float, aperture: float | None = None, distance: float | None = None
    ) -> dict | None:
        """Interpolated coefficients for the warp (rs:265-489)."""
        if not (self.distortions or self.tcas or self.vignettings):
            return None
        k1, k2, k3, model = _interp_distortion(self.distortions, focal_length)
        vr, vb = _interp_tca(self.tcas, focal_length)
        v1, v2, v3 = _interp_vignetting(
            self.vignettings, focal_length, aperture or 3.5, distance or 1000.0
        )
        return {
            "k1": k1, "k2": k2, "k3": k3, "model": model,
            "tca_vr": vr, "tca_vb": vb,
            "vig_k1": v1, "vig_k2": v2, "vig_k3": v3,
        }


@dataclass
class Camera:
    makers: list = field(default_factory=list)
    models: list = field(default_factory=list)
    mount: str = ""
    cropfactor: float = 1.0


@dataclass
class LensDatabase:
    cameras: list = field(default_factory=list)
    lenses: list = field(default_factory=list)

    def lenses_for_maker(self, maker: str) -> list[Lens]:
        return [l for l in self.lenses if l.maker() == maker]

    def makers(self) -> list[str]:
        """Distinct lens makers, sorted (lens_corrections.rs
        get_lensfun_makers)."""
        return sorted({l.maker() for l in self.lenses})


def _strip_maker_prefix(name: str, maker: str) -> str:
    if name.lower().startswith(maker.lower()):
        rest = name[len(maker) :].strip()
        if rest:
            return rest
    return name


def _f(el, attr, default=0.0):
    v = el.get(attr)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def _names(parent, tag) -> list:
    out = []
    for el in parent.findall(tag):
        lang = el.get("{http://www.w3.org/XML/1998/namespace}lang") or el.get("lang")
        out.append((lang, (el.text or "").strip()))
    return out


def parse_lensfun_xml(text: str) -> LensDatabase:
    db = LensDatabase()
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        return db
    for cam in root.findall("camera"):
        try:
            cam_cf = float(cam.findtext("cropfactor") or 1.0)
        except ValueError:
            cam_cf = 1.0  # malformed value must not abort the whole DB load
        db.cameras.append(
            Camera(
                makers=_names(cam, "maker"),
                models=_names(cam, "model"),
                mount=(cam.findtext("mount") or "").strip(),
                cropfactor=cam_cf,
            )
        )
    for lens_el in root.findall("lens"):
        lens = Lens(
            makers=_names(lens_el, "maker"),
            models=_names(lens_el, "model"),
            mounts=[(m.text or "").strip() for m in lens_el.findall("mount")],
        )
        cf = lens_el.findtext("cropfactor")
        if cf:
            try:
                lens.cropfactor = float(cf)
            except ValueError:
                pass
        cal = lens_el.find("calibration")
        if cal is not None:
            for d in cal.findall("distortion"):
                lens.distortions.append(
                    Distortion(
                        model=d.get("model", ""),
                        focal=_f(d, "focal"),
                        k1=_f(d, "k1"), k2=_f(d, "k2"), k3=_f(d, "k3"),
                        a=_f(d, "a"), b=_f(d, "b"), c=_f(d, "c"),
                    )
                )
            for t in cal.findall("tca"):
                lens.tcas.append(Tca(focal=_f(t, "focal"), vr=_f(t, "vr", 1.0), vb=_f(t, "vb", 1.0)))
            for v in cal.findall("vignetting"):
                lens.vignettings.append(
                    Vignetting(
                        focal=_f(v, "focal"),
                        aperture=_f(v, "aperture"),
                        distance=_f(v, "distance", 1000.0),
                        k1=_f(v, "k1"), k2=_f(v, "k2"), k3=_f(v, "k3"),
                    )
                )
        db.lenses.append(lens)
    return db


def load_lensfun_dir(path: str | Path) -> LensDatabase:
    """Parse every .xml under a lensfun database directory (rs:689-765)."""
    db = LensDatabase()
    for xml_path in sorted(Path(path).rglob("*.xml")):
        sub = parse_lensfun_xml(xml_path.read_text(errors="replace"))
        db.cameras.extend(sub.cameras)
        db.lenses.extend(sub.lenses)
    return db


def _dist_tuple(d: Distortion):
    if d.model in ("poly3", "poly5"):
        return (d.k1, d.k2, d.k3, 0)
    if d.model == "ptlens":
        return (d.a, d.b, d.c, 1)
    return (0.0, 0.0, 0.0, 0)


def _interp_distortion(dists: list[Distortion], focal: float):
    if not dists:
        return (0.0, 0.0, 0.0, 0)
    dists = sorted(dists, key=lambda d: d.focal)
    for d in dists:
        if abs(d.focal - focal) < 1e-5:
            return _dist_tuple(d)
    if focal < dists[0].focal:
        return _dist_tuple(dists[0])
    if focal > dists[-1].focal:
        return _dist_tuple(dists[-1])
    for d1, d2 in zip(dists, dists[1:]):
        if d1.focal <= focal <= d2.focal:
            p1, p2 = _dist_tuple(d1), _dist_tuple(d2)
            rng = d2.focal - d1.focal
            if abs(rng) < 1e-5 or p1[3] != p2[3]:
                return p1
            t = (focal - d1.focal) / rng
            return (
                p1[0] + t * (p2[0] - p1[0]),
                p1[1] + t * (p2[1] - p1[1]),
                p1[2] + t * (p2[2] - p1[2]),
                p1[3],
            )
    return (0.0, 0.0, 0.0, 0)


def _interp_tca(tcas: list[Tca], focal: float):
    if not tcas:
        return (1.0, 1.0)
    tcas = sorted(tcas, key=lambda t: t.focal)
    for t in tcas:
        if abs(t.focal - focal) < 1e-5:
            return (t.vr, t.vb)
    if focal < tcas[0].focal:
        return (tcas[0].vr, tcas[0].vb)
    if focal > tcas[-1].focal:
        return (tcas[-1].vr, tcas[-1].vb)
    for t1, t2 in zip(tcas, tcas[1:]):
        if t1.focal <= focal <= t2.focal:
            rng = t2.focal - t1.focal
            if abs(rng) < 1e-5:
                return (t1.vr, t1.vb)
            t = (focal - t1.focal) / rng
            return (t1.vr + t * (t2.vr - t1.vr), t1.vb + t * (t2.vb - t1.vb))
    return (1.0, 1.0)


def _best_vig(group: list[Vignetting], aperture: float, distance: float):
    if not group:
        return (0.0, 0.0, 0.0)
    best_ap = min(group, key=lambda v: abs(v.aperture - aperture))
    candidates = [v for v in group if abs(v.aperture - best_ap.aperture) < 0.01]
    best = min(candidates, key=lambda v: abs(v.distance - distance), default=best_ap)
    return (best.k1, best.k2, best.k3)


def _interp_vignetting(vigs: list[Vignetting], focal: float, aperture: float, distance: float):
    if not vigs:
        return (0.0, 0.0, 0.0)
    vigs = sorted(vigs, key=lambda v: v.focal)
    if focal <= vigs[0].focal + 0.01:
        group = [v for v in vigs if abs(v.focal - vigs[0].focal) < 0.01]
        return _best_vig(group, aperture, distance)
    if focal >= vigs[-1].focal - 0.01:
        group = [v for v in vigs if abs(v.focal - vigs[-1].focal) < 0.01]
        return _best_vig(group, aperture, distance)
    focals: list[float] = []
    for v in vigs:
        if not focals or abs(v.focal - focals[-1]) >= 0.01:
            focals.append(v.focal)
    for f1, f2 in zip(focals, focals[1:]):
        if f1 <= focal <= f2:
            g1 = [v for v in vigs if abs(v.focal - f1) < 0.01]
            g2 = [v for v in vigs if abs(v.focal - f2) < 0.01]
            p1 = _best_vig(g1, aperture, distance)
            p2 = _best_vig(g2, aperture, distance)
            rng = f2 - f1
            if abs(rng) <= 0.01:
                return p1
            t = (focal - f1) / rng
            return tuple(a + t * (b - a) for a, b in zip(p1, p2))
    return (0.0, 0.0, 0.0)


def _fuzzy_score(candidate: str, query: str) -> int:
    """Subsequence fuzzy score approximating the reference's SkimMatcherV2:
    all query chars must appear in order; consecutive runs score higher."""
    c = candidate.lower()
    q = query.lower()
    score = 0
    pos = 0
    run = 0
    for ch in q:
        if ch == " ":
            continue
        idx = c.find(ch, pos)
        if idx < 0:
            return 0
        run = run + 1 if idx == pos else 1
        score += 1 + run * 2
        pos = idx + 1
    return score


def find_best_lens_match(db: LensDatabase, maker: str, model: str) -> tuple[str, str] | None:
    """EXIF maker/model -> (maker, display_name) (lens_correction.rs:643-724)."""
    clean_maker = maker.strip().strip('"')
    clean_model = model.strip().strip('"')

    maker_lenses = [l for l in db.lenses if l.maker().lower() == clean_maker.lower()]
    if maker_lenses:
        best = None
        for lens in maker_lenses:
            se = _fuzzy_score(lens.full_model_name(), clean_model)
            sc = _fuzzy_score(lens.canonical_model_name(), clean_model)
            score = max(se, sc)
            if score > 0:
                name = lens.canonical_model_name() if sc > se else lens.full_model_name()
                adjusted = score - max(len(name) - len(clean_model), 0) // 2
                if best is None or adjusted > best[0]:
                    best = (adjusted, lens)
        if best:
            return (best[1].maker(), best[1].display_name(maker_lenses))

    best = None
    for lens in db.lenses:
        score = max(
            _fuzzy_score(lens.full_model_name(), clean_model),
            _fuzzy_score(lens.canonical_model_name(), clean_model),
        )
        if score > 0 and (best is None or score > best[0]):
            best = (score, lens)
    if best:
        lens = best[1]
        return (lens.maker(), lens.display_name(db.lenses_for_maker(lens.maker())))
    return None


def resolve_lens_params(
    db: LensDatabase,
    maker: str,
    model: str,
    focal_length: float,
    aperture: float | None = None,
    distance: float | None = None,
) -> dict | None:
    """(rs:768-785): look up by display name, interpolate for the shot."""
    maker_lenses = db.lenses_for_maker(maker)
    for lens in maker_lenses:
        if lens.display_name(maker_lenses) == model:
            return lens.distortion_params(focal_length, aperture, distance)
    return None
