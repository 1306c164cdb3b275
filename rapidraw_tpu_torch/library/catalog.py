"""Folder/file catalog operations.

Copy of `rapidraw_tpu/library/catalog.py` (host Python), except the
dimension query of LDR files: JAX reads their size through PIL's header
parse, which the card's machine does not have; here `ldr_dimensions`
reads each format's own header (JPEG through io/jpeg.jpeg_info, TIFF
through io/tiff.Frame, the fixed headers of PNG, GIF, BMP, WebP, QOI, TGA
and the PNM family) and refuses the rest, naming slice A.10c.

Port of file_management.rs's library core: folder tree with lazy child scan
(:806-998), image listing (flat + recursive), file ops that keep sidecars
associated (copy/move/rename/delete, :1854-2053), virtual copies
(parse_virtual_path :165-196), ratings and color labels stored on the
.rrdata sidecar, and albums (:533-789) as JSON path collections.
"""

from __future__ import annotations

import json
import shutil
import struct
from dataclasses import dataclass
from pathlib import Path

from rapidraw_tpu_torch.io.loader import RAW_EXTENSIONS, parse_virtual_path
from rapidraw_tpu_torch.io.sidecar import SIDECAR_EXT, load_sidecar, save_sidecar, sidecar_path

# the reference's NON_RAW_EXTENSIONS, formats.rs:73-79 (io/loader.py
# decodes JPEG, PNG, TIFF, hdr/exr/ff/pam and jxl; the rest waits for
# slice A.10c, io/loader.DEFERRED_EXTENSIONS)
LDR_EXTENSIONS = {
    "jpg", "jpeg", "png", "gif", "bmp", "tiff", "tif", "webp", "jxl",
    "exr", "hdr", "tga", "ico", "dds", "qoi", "ff",
    "pnm", "pbm", "pgm", "ppm", "pam",
}
SUPPORTED_EXTENSIONS = LDR_EXTENSIONS | RAW_EXTENSIONS


def is_supported_image(path: str | Path) -> bool:
    return Path(str(path)).suffix.lower().lstrip(".") in SUPPORTED_EXTENSIONS


@dataclass
class FolderNode:
    path: str
    name: str
    has_children: bool
    children: list | None = None  # lazy (file_management.rs:806-998)


def scan_folder(path: str | Path) -> FolderNode:
    p = Path(path)
    sub = [d for d in p.iterdir() if d.is_dir() and not d.name.startswith(".")] if p.is_dir() else []
    return FolderNode(str(p), p.name, bool(sub))


def folder_children(path: str | Path) -> list[FolderNode]:
    p = Path(path)
    out = []
    if p.is_dir():
        for d in sorted(p.iterdir()):
            if d.is_dir() and not d.name.startswith("."):
                out.append(scan_folder(d))
    return out


def list_images(path: str | Path, recursive: bool = False) -> list[str]:
    p = Path(path)
    it = p.rglob("*") if recursive else p.glob("*")
    files = [str(f) for f in it if f.is_file() and is_supported_image(f)]
    files.sort()
    # expand virtual copies recorded on sidecars
    expanded = []
    for f in files:
        expanded.append(f)
        meta = load_sidecar(f)
        for vc in meta.get("virtualCopies", []) or []:
            expanded.append(f"{f}?vc={vc}")
    return expanded


# ---- file ops with sidecar association (file_management.rs:1854-2053) -----


def _associated_files(path: Path) -> list[Path]:
    """The image plus ALL its sidecars: 'a.jpg.rrdata' and every
    virtual-copy sidecar 'a.jpg.N.rrdata' (sidecar_path naming) — VC edits
    must travel with copy/move/delete."""
    out = [path]
    sc = sidecar_path(path)
    if sc.exists():
        out.append(sc)
    for vc_sc in path.parent.glob(f"{path.name}.*{SIDECAR_EXT}"):
        if vc_sc != sc and vc_sc.exists():
            out.append(vc_sc)
    return out


def copy_image(src: str | Path, dst_dir: str | Path) -> str:
    src = Path(str(parse_virtual_path(str(src))[0]))
    dst_dir = Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    for f in _associated_files(src):
        shutil.copy2(f, dst_dir / f.name)
    return str(dst_dir / src.name)


def move_image(src: str | Path, dst_dir: str | Path) -> str:
    src = Path(str(parse_virtual_path(str(src))[0]))
    dst_dir = Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    for f in _associated_files(src):
        shutil.move(str(f), str(dst_dir / f.name))
    return str(dst_dir / src.name)


def rename_image(src: str | Path, new_stem: str) -> str:
    src = Path(str(parse_virtual_path(str(src))[0]))
    dst = src.with_name(new_stem + src.suffix)
    if dst.exists() and str(dst) != str(src):
        raise FileExistsError(f"rename target already exists: {dst}")
    src.rename(dst)
    # every sidecar (base + virtual copies) follows the new name
    sc = sidecar_path(src)
    if sc.exists():
        sc.rename(dst.parent / (dst.name + SIDECAR_EXT))
    for vc_sc in src.parent.glob(f"{src.name}.*{SIDECAR_EXT}"):
        tail = vc_sc.name[len(src.name):]
        vc_sc.rename(dst.parent / (dst.name + tail))
    return str(dst)


def delete_image(src: str | Path) -> None:
    src = Path(str(parse_virtual_path(str(src))[0]))
    for f in _associated_files(src):
        f.unlink(missing_ok=True)


# ---- virtual copies --------------------------------------------------------


def create_virtual_copy(src: str | Path) -> str:
    """Register a new virtual copy id on the sidecar; returns its path."""
    real = str(parse_virtual_path(str(src))[0])
    meta = load_sidecar(real)
    vcs = list(meta.get("virtualCopies", []) or [])
    next_id = (max(vcs) + 1) if vcs else 1
    vcs.append(next_id)
    meta["virtualCopies"] = vcs
    save_sidecar(real, meta)
    return f"{real}?vc={next_id}"


# ---- ratings / color labels ------------------------------------------------


def set_rating(path: str | Path, rating: int) -> None:
    real = str(parse_virtual_path(str(path))[0])
    meta = load_sidecar(real)
    meta["rating"] = max(0, min(int(rating), 5))
    save_sidecar(real, meta)


def set_color_label(path: str | Path, label: str | None) -> None:
    real = str(parse_virtual_path(str(path))[0])
    meta = load_sidecar(real)
    meta["colorLabel"] = label
    save_sidecar(real, meta)


def get_rating(path: str | Path) -> int:
    return int(load_sidecar(str(parse_virtual_path(str(path))[0])).get("rating") or 0)


# ---- tags on sidecars (tagging.rs:416-540) ---------------------------------


def add_tags(path: str | Path, tags: list[str]) -> list[str]:
    real = str(parse_virtual_path(str(path))[0])
    meta = load_sidecar(real)
    current = list(meta.get("tags") or [])
    for t in tags:
        if t and t not in current:
            current.append(t)
    meta["tags"] = current
    save_sidecar(real, meta)
    return current


def remove_tags(path: str | Path, tags: list[str]) -> list[str]:
    real = str(parse_virtual_path(str(path))[0])
    meta = load_sidecar(real)
    current = [t for t in (meta.get("tags") or []) if t not in set(tags)]
    meta["tags"] = current
    save_sidecar(real, meta)
    return current


def clear_tags(path: str | Path) -> None:
    real = str(parse_virtual_path(str(path))[0])
    meta = load_sidecar(real)
    meta["tags"] = []
    save_sidecar(real, meta)


def get_tags(path: str | Path) -> list[str]:
    return list(load_sidecar(str(parse_virtual_path(str(path))[0])).get("tags") or [])


# ---- albums (file_management.rs:533-789) -----------------------------------


class Albums:
    """JSON-file album store: {name: [image paths]}."""

    def __init__(self, store_path: str | Path):
        self.store_path = Path(store_path)
        self._data: dict[str, list[str]] = {}
        if self.store_path.exists():
            try:
                data = json.loads(self.store_path.read_text())
                if isinstance(data, dict):
                    self._data = {k: list(v) for k, v in data.items()}
            except (OSError, json.JSONDecodeError):
                pass

    def _save(self) -> None:
        self.store_path.parent.mkdir(parents=True, exist_ok=True)
        self.store_path.write_text(json.dumps(self._data, indent=2))

    def names(self) -> list[str]:
        return sorted(self._data)

    def create(self, name: str) -> None:
        self._data.setdefault(name, [])
        self._save()

    def delete(self, name: str) -> None:
        self._data.pop(name, None)
        self._save()

    def add(self, name: str, paths: list[str]) -> None:
        album = self._data.setdefault(name, [])
        for p in paths:
            if p not in album:
                album.append(p)
        self._save()

    def remove(self, name: str, paths: list[str]) -> None:
        if name not in self._data:
            return  # do not create a phantom empty album
        self._data[name] = [p for p in self._data[name] if p not in set(paths)]
        self._save()

    def images(self, name: str) -> list[str]:
        return list(self._data.get(name, []))

    def sync_folder_rename(self, old_folder: str, new_folder: str) -> None:
        """Rewrite album entries under a renamed folder
        (file_management.rs sync_album_path_changes, :1758)."""
        old_prefix = str(Path(old_folder)) + "/"
        changed = False
        for name, paths in self._data.items():
            out = []
            for p in paths:
                if p.startswith(old_prefix):
                    p = str(Path(new_folder) / p[len(old_prefix):])
                    changed = True
                out.append(p)
            self._data[name] = out
        if changed:
            self._save()


# ------------------------------------------------------------- folder ops


def create_folder(path: str | Path) -> None:
    """mkdir with a case-insensitive duplicate check in the parent
    (file_management.rs:1717-1733)."""
    p = Path(path)
    parent = p.parent
    if parent.exists():
        lower = p.name.lower()
        for entry in parent.iterdir():
            if entry.name.lower() == lower:
                raise FileExistsError("A folder with that name already exists.")
    p.mkdir(parents=True, exist_ok=True)


def rename_folder(path: str | Path, new_name: str,
                  albums: "Albums | None" = None) -> str:
    """Rename a directory (case-insensitive sibling check) and sync album
    paths (file_management.rs:1736-1761). Returns the new path."""
    p = Path(path)
    if not p.is_dir():
        raise NotADirectoryError("Path is not a directory.")
    parent = p.parent
    for entry in parent.iterdir():
        if entry.name.lower() == new_name.lower() and entry != p:
            raise FileExistsError("A folder with that name already exists.")
    new_path = parent / new_name
    p.rename(new_path)
    if albums is not None:
        albums.sync_folder_rename(str(p), str(new_path))
    return str(new_path)


def delete_folder(path: str | Path) -> None:
    """Remove a directory tree (file_management.rs:1763-1776; the reference
    tries the OS trash first and falls back to permanent delete — headless
    deployments have no trash, so this is the fallback branch)."""
    shutil.rmtree(path)


def clear_all_sidecars(root_path: str | Path) -> int:
    """Delete every .rrdata/.rrexif under root; returns the count
    (file_management.rs:2758-2782)."""
    root = Path(root_path)
    if not root.exists():
        raise FileNotFoundError(f"Root path does not exist: {root_path}")
    deleted = 0
    for p in root.rglob("*"):
        if p.is_file() and p.suffix in (".rrdata", ".rrexif"):
            try:
                p.unlink()
                deleted += 1
            except OSError:
                pass
    return deleted


def pinned_folder_trees(paths: list[str | Path]) -> list[FolderNode]:
    """One folder tree per pinned root; unreadable roots are skipped
    (file_management.rs:1017-1045)."""
    out = []
    for p in paths:
        if not Path(p).is_dir():
            continue
        try:
            out.append(scan_folder(p))
        except OSError:
            continue
    return out


# ---------------------------------------------------------- misc utilities


def get_supported_file_types() -> dict:
    """{"raw": [...], "nonRaw": [...]} (file_management.rs:1703-1714)."""
    return {
        "raw": sorted(RAW_EXTENSIONS),
        "nonRaw": sorted(LDR_EXTENSIONS),
    }


def _pnm_dimensions(data: bytes) -> tuple[int, int]:
    """P1-P6: the magic, then width and height as ASCII integers between
    whitespace and '#' comments."""
    fields, pos = [], 2
    while len(fields) < 2:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise ValueError("malformed PNM header")
        fields.append(int(data[start:pos]))
    return fields[0], fields[1]


def _webp_dimensions(data: bytes) -> tuple[int, int]:
    """The canvas of a VP8X file, else the frame of its VP8 / VP8L chunk."""
    kind = data[12:16]
    if kind == b"VP8X":
        return 1 + int.from_bytes(data[24:27], "little"), 1 + int.from_bytes(data[27:30], "little")
    if kind == b"VP8L" and data[20:21] == b"\x2f":
        bits = int.from_bytes(data[21:25], "little")
        return 1 + (bits & 0x3FFF), 1 + ((bits >> 14) & 0x3FFF)
    if kind == b"VP8 " and data[23:26] == b"\x9d\x01\x2a":
        w, h = struct.unpack_from("<HH", data, 26)
        return w & 0x3FFF, h & 0x3FFF
    raise ValueError("malformed WebP header")


def ldr_dimensions(path: str | Path) -> tuple[int, int]:
    """(width, height) of an LDR file from its header, as PIL's
    `Image.open(path).size` gives it: the format is sniffed by its magic
    (TGA, which has none, by its extension). A format whose header the port
    does not read raises NotImplementedError naming slice A.10c."""
    p = Path(path)
    with open(p, "rb") as f:
        data = f.read(64 * 1024)
    if data[:3] == b"\xff\xd8\xff":
        from rapidraw_tpu_torch.io.jpeg import jpeg_info

        with open(p, "rb") as f:  # the SOF may follow large APP segments
            w, h, _ = jpeg_info(f.read())
        return w, h
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return struct.unpack_from(">II", data, 16)
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        from rapidraw_tpu_torch.io.tiff import Frame

        with open(p, "rb") as f:
            fr = Frame(f.read())
        return fr.width, fr.height
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return struct.unpack_from("<HH", data, 6)
    if data[:2] == b"BM":
        (size,) = struct.unpack_from("<I", data, 14)
        if size == 12:
            return struct.unpack_from("<HH", data, 18)
        if size in (40, 52, 56, 64, 108, 124):
            w, h = struct.unpack_from("<ii", data, 18)
            # PIL: a top-down bitmap (negative height) reads as 2^32 - h
            return w, h if data[25] != 0xFF else 2**32 - (h & 0xFFFFFFFF)
        raise ValueError(f"unsupported BMP header size {size}")
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return _webp_dimensions(data)
    if data[:4] == b"qoif":
        return struct.unpack_from(">II", data, 4)
    if data[:1] == b"P" and data[1:2] in b"123456" and len(data) > 2 and data[2:3].isspace():
        return _pnm_dimensions(data)
    if p.suffix.lower() == ".tga" and len(data) >= 18:
        w, h = struct.unpack_from("<HH", data, 12)
        if data[1] in (0, 1) and w > 0 and h > 0 and data[16] in (1, 8, 16, 24, 32):
            return w, h
        raise ValueError("not a TGA file")
    raise NotImplementedError(
        f"{p.name}: reading this format's dimensions waits for slice A.10c "
        "(JPEG, PNG, TIFF, GIF, BMP, WebP, QOI, TGA and PNM headers are read)")


def get_image_dimensions(path: str | Path) -> tuple[int, int]:
    """(width, height) from the container header, virtual-copy aware
    (lib.rs:232-238). LDR formats read only their header
    (`ldr_dimensions`); RAW formats parse the container metadata (no
    decode)."""
    source, _ = parse_virtual_path(str(path))
    sp = Path(source)
    ext = sp.suffix.lower().lstrip(".")
    if ext in RAW_EXTENSIONS:
        import mmap

        from rapidraw_tpu_torch.io.containers import raw_dimensions

        # mmap instead of read_bytes: the metadata walk touches only the
        # header pages, not the whole 100MB+ RAW
        with open(sp, "rb") as f:
            try:
                with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                    return raw_dimensions(mm, ext=ext)
            except (ValueError, OSError) as e:
                if isinstance(e, ValueError):
                    raise
                f.seek(0)
                return raw_dimensions(f.read(), ext=ext)
    return ldr_dimensions(sp)


def save_temp_file(data: bytes, suffix: str = "") -> str:
    """Persist bytes to a kept temp file, returning its path
    (lib.rs:1392-1398)."""
    import tempfile

    fd, name = tempfile.mkstemp(suffix=suffix, prefix="rapidraw_")
    import os

    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return name


def internal_library_root(base: str | Path | None = None) -> str:
    """Create-if-missing the managed library folder
    (file_management.rs:2552-2580: app-data/library). `base` overrides the
    app-data dir (tests, alternate deployments)."""
    if base is None:
        from rapidraw_tpu_torch.utils.settings import app_data_dir

        base = app_data_dir()
    root = Path(base) / "library"
    root.mkdir(parents=True, exist_ok=True)
    return str(root)


def save_collage(data_url: str, first_path: str | Path) -> str:
    """Persist a frontend-composed collage: decode the data-URL PNG and
    write '<first stem>_Collage.png' beside the first image
    (lib.rs:1555-1582)."""
    import base64

    prefix = "data:image/png;base64,"
    if not data_url.startswith(prefix):
        raise ValueError("Invalid base64 data format")
    decoded = base64.b64decode(data_url[len(prefix):])
    source, _ = parse_virtual_path(str(first_path))
    sp = Path(source)
    out = sp.parent / f"{sp.stem}_Collage.png"
    out.write_bytes(decoded)
    return str(out)
