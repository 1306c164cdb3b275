"""Build and load the hand-written CUDA kernels (csrc/*.cu) and the host
C++ decoders (csrc/host/*.cc) over ctypes.

Each source compiles with nvcc for Hopper (sm_90a) into a shared library
with a plain C interface, at first use, into `_build/` beside this file
(listed in .gitignore). The library name carries a hash of the source and
of any generated header, so an edited kernel or param layout rebuilds and
a stale library is never loaded. Build failures raise; nothing falls back.
nvcc's output (with ptxas's registers and spills per kernel) is kept beside
the library as `<library>.log` and read back when a built library is reused.
A host decoder compiles with g++ the same way (`host_library`): the
lossless-JPEG decoder (ljpeg.cc), the Nikon and Pentax Huffman decoders
(vendor_huff.cc), the Panasonic and Olympus bitstreams (pana_oly.cc), the
crx codec of CR3 (crx.cc) and the Phase One IIQ rows (phase_one.cc). Their
bindings below copy the JAX package's (`rapidraw_tpu/native/__init__.py`)
signature for signature. The export's baseline JPEG encoder (jpeg_enc.cc)
builds the same way; it has no JAX counterpart (the JAX package encodes
through PIL).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_DIR = Path(__file__).parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class KernelBuildError(RuntimeError):
    pass


_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}


def _build_lock(out: Path) -> threading.Lock:
    """One lock per library file: the threads of a process build it once."""
    with _locks_guard:
        return _locks.setdefault(str(out), threading.Lock())


def _temp_name(out: Path) -> Path:
    """A name beside `out` that no other thread or process uses; the
    compiler writes there and `os.replace` publishes the whole file, so a
    concurrent loader finds either no library or a complete one."""
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=f"{out.name}.", suffix=".tmp")
    os.close(fd)
    return Path(tmp)


def _write_atomic(path: Path, text: str) -> None:
    tmp = _temp_name(path)
    tmp.write_text(text)
    os.replace(tmp, path)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


class KernelLibrary:
    """One compiled csrc/<name>.cu: the ctypes handle plus its build record."""

    def __init__(self, name: str, header: str = "", extra_flags: tuple = ()):
        self.name = name
        self.header = header
        self.extra_flags = tuple(extra_flags)
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def _build(self) -> Path:
        src = CSRC / f"{self.name}.cu"
        h = hashlib.blake2b(digest_size=8)
        h.update(src.read_bytes())
        h.update(self.header.encode())
        h.update(" ".join(ARCH_FLAGS + self.extra_flags).encode())
        tag = h.hexdigest()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{self.name}_{tag}.so"
        log = out.with_suffix(".log")
        with _build_lock(out):
            if out.exists():
                self.build_log = log.read_text() if log.exists() else ""
                return out
            inc = BUILD_DIR / f"inc_{self.name}_{tag}"
            inc.mkdir(exist_ok=True)
            _write_atomic(inc / f"{self.name}_gen.h", self.header)
            tmp = _temp_name(out)
            cmd = [
                _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", *self.extra_flags,
                "-I", str(inc), "-o", str(tmp), str(src),
            ]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            except (OSError, subprocess.TimeoutExpired) as e:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"failed to run nvcc: {e}") from e
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"nvcc failed on {src.name}:\n{proc.stderr[-4000:]}")
            _write_atomic(log, proc.stderr)
            os.replace(tmp, out)
            return out

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self._build()))
                    lib.rr_error_string.argtypes = [ctypes.c_int]
                    lib.rr_error_string.restype = ctypes.c_char_p
                    self._lib = lib
        return self._lib

    def check(self, status: int, what: str) -> None:
        """Raise on a non-zero cudaError_t returned by a C entry point."""
        if status != 0:
            msg = self.lib().rr_error_string(status).decode()
            raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


_host_libs: dict[str, ctypes.CDLL] = {}


def host_library(name: str) -> ctypes.CDLL:
    """csrc/host/<name>.cc compiled with g++ at first use into `_build/`,
    named by a hash of the source. One build per process, behind a lock
    held per library (the export's and the preview service's threads reach
    it at once), compiled to a name unique to the thread and the process
    and published atomically, as several test workers may build it at
    once. A failed build raises; nothing stands in for the decoder."""
    lib = _host_libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / "host" / f"{name}.cc"
    tag = hashlib.blake2b(src.read_bytes(), digest_size=8).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_host_{tag}.so"
    with _build_lock(out):
        lib = _host_libs.get(name)
        if lib is not None:
            return lib
        if not out.exists():
            tmp = _temp_name(out)
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"failed to run g++: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"g++ failed on {src.name}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        lib = _host_libs[name] = ctypes.CDLL(str(out))
        return lib


def ljpeg_decode(stream: bytes):
    """Decode one lossless-JPEG (SOF3) stream -> uint16 array (h, w * comps).

    Raises KernelBuildError if the decoder does not build and ValueError on
    malformed or unsupported streams.
    """
    import numpy as np

    fn = host_library("ljpeg").ljpeg_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    # DNG tiles are <= a few MPix; start at 4M samples and grow on -3
    cap = 1 << 22
    for _ in range(4):
        buf = np.empty(cap, np.uint16)
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        nc = ctypes.c_int(0)
        rc = fn(
            stream, len(stream),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), cap,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
        )
        if rc == -3:
            cap *= 4
            continue
        if rc != 0:
            raise ValueError(f"ljpeg decode failed (code {rc})")
        n = w.value * h.value * nc.value
        return buf[:n].reshape(h.value, w.value * nc.value).copy()
    raise ValueError("ljpeg stream too large")


def nikon_decode(stream: bytes, width: int, height: int, tree: int,
                 split: int, vpred, bits: int):
    """Nikon NEF compression 34713 -> (H, W) uint16 predicted values
    (pre-curve). vpred: 4 uint16 initial vertical predictors."""
    import numpy as np

    lib = host_library("vendor_huff")
    fn = lib.nikon_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
    ]
    out = np.empty((height, width), np.uint16)
    vp = np.ascontiguousarray(np.asarray(vpred, np.uint16).reshape(4))
    rc = fn(
        stream, len(stream),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        width, height, tree, split,
        vp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), bits,
    )
    if rc != 0:
        raise ValueError(f"nikon decode failed (code {rc})")
    return out


def pentax_decode(stream: bytes, width: int, height: int, bits: int = 16,
                  table=None):
    """Pentax PEF compression 65535 -> (H, W) u16.

    table: optional (codes, lens, syms) sequences from makernote 0x220
    (dcraw builds its Huffman table from that tag unconditionally); None
    uses the format's default table.
    """
    import numpy as np

    lib = host_library("vendor_huff")
    out = np.empty((height, width), np.uint16)
    out_p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
    if table is None:
        fn = lib.pentax_decode
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        rc = fn(stream, len(stream), out_p, width, height, bits)
    else:
        codes, lens, syms = table
        n = len(codes)
        if not (0 < n <= 32 and len(lens) == n and len(syms) == n):
            raise ValueError("pentax table must be <=32 (codes, lens, syms)")
        fn = lib.pentax_decode_table
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int,
        ]
        codes_a = np.ascontiguousarray(codes, np.uint16)
        rc = fn(
            stream, len(stream), out_p, width, height, bits,
            codes_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            bytes(bytearray(lens)), bytes(bytearray(syms)), n,
        )
    if rc != 0:
        raise ValueError(f"pentax decode failed (code {rc})")
    return out


def panasonic_decode(stream: bytes, raw_width: int, height: int):
    """Panasonic RW2 12-bit bitstream -> (H, raw_width) uint16."""
    import numpy as np

    lib = host_library("pana_oly")
    fn = lib.panasonic_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int,
    ]
    out = np.empty((height, raw_width), np.uint16)
    rc = fn(
        stream, len(stream),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        raw_width, height,
    )
    if rc != 0:
        raise ValueError(f"panasonic decode failed (code {rc})")
    return out


def olympus_decode(stream: bytes, raw_width: int, width: int, height: int):
    """Olympus ORF predictive codec -> (H, width) uint16 (12-bit range)."""
    import numpy as np

    lib = host_library("pana_oly")
    fn = lib.olympus_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    out = np.zeros((height, width), np.uint16)
    rc = fn(
        stream, len(stream),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        raw_width, width, height,
    )
    if rc != 0:
        raise ValueError(f"olympus decode failed (code {rc})")
    return out


def phase_one_decode(data: bytes, row_offsets, raw_width: int,
                     raw_height: int, fmt: int, big_endian: bool):
    """Phase One IIQ compressed rows -> (H, W) uint16 pixel values
    (post-prediction, format-5 curve applied, PRE black subtraction).

    row_offsets: per-row byte offsets into `data` (the region starting at
    the container's data_offset)."""
    import numpy as np

    lib = host_library("phase_one")
    fn = lib.phase_one_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    offs = np.ascontiguousarray(row_offsets, np.uint32)
    if offs.shape != (raw_height,):
        raise ValueError("row_offsets must have raw_height entries")
    out = np.empty((raw_height, raw_width), np.uint16)
    rc = fn(
        data, len(data),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        raw_width, raw_height, fmt, 1 if big_endian else 0,
    )
    if rc != 0:
        raise ValueError(f"phase one decode failed (code {rc})")
    return out


def crx_decode(sample: bytes, planes: int, pw: int, ph: int):
    """Decode one crx-class tile sample -> uint16 (planes, ph, pw).

    Strictly validates the ff01/ff02/ff03 framing; raises ValueError on any
    mismatch (io/cr3.py treats that as "not our crx dialect" and falls back
    to its precise refusal).
    """
    import numpy as np

    lib = host_library("crx")
    fn = lib.crx_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16),
    ]
    out = np.empty((planes, ph, pw), np.uint16)
    rc = fn(sample, len(sample), planes, pw, ph,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"crx decode failed (code {rc})")
    return out


def crx_encode(planes_arr) -> bytes:
    """Encode uint16 (planes, ph, pw) as one crx-class tile sample."""
    import numpy as np

    a = np.ascontiguousarray(planes_arr, np.uint16)
    planes, ph, pw = a.shape
    lib = host_library("crx")
    fn = lib.crx_encode
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
    ]
    cap = a.nbytes * 2 + 4096
    buf = (ctypes.c_ubyte * cap)()
    n = fn(a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
           planes, pw, ph, buf, cap)
    if n < 0:
        raise ValueError(f"crx encode failed (code {n})")
    return bytes(buf[: int(n)])


def jpeg_encode(hwc_u8, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB, or (H, W) uint8 grey -> a baseline JPEG file at
    `quality` (1-100), as PIL's `Image.save(..., "JPEG", quality=quality)`
    writes it for mode "RGB" or "L" (csrc/host/jpeg_enc.cc). The call
    releases the GIL, so threads encode in parallel."""
    import numpy as np

    a = np.asarray(hwc_u8)
    grey = a.ndim == 2
    if a.dtype != np.uint8 or not (grey or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"jpeg_encode expects (H, W, 3) or (H, W) uint8, got {a.dtype} {a.shape}")
    a = np.ascontiguousarray(a)
    lib = host_library("jpeg_enc")
    enc = lib.jpeg_encode_gray if grey else lib.jpeg_encode_rgb
    enc.restype = ctypes.c_long
    enc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int]
    fetch = lib.jpeg_fetch
    fetch.restype = ctypes.c_int
    fetch.argtypes = [ctypes.c_void_p, ctypes.c_long]
    h, w = a.shape[:2]
    n = enc(a.ctypes.data, w, h, (1 if grey else 3) * w, int(quality))
    if n < 0:
        raise ValueError(f"jpeg encode failed for a {w}x{h} image (code {n})")
    out = np.empty(n, np.uint8)
    if fetch(out.ctypes.data, n) != 0:
        raise RuntimeError("jpeg encode: the encoded file was lost before it was fetched")
    return out.tobytes()
