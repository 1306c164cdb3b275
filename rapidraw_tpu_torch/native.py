"""Build and load the hand-written CUDA kernels (csrc/*.cu) over ctypes.

Each source compiles with nvcc for Hopper (sm_90a) into a shared library
with a plain C interface, at first use, into `_build/` beside this file
(listed in .gitignore). The library name carries a hash of the source and
of any generated header, so an edited kernel or param layout rebuilds and
a stale library is never loaded. Build failures raise; nothing falls back.
nvcc's output (with ptxas's registers and spills per kernel) is kept beside
the library as `<library>.log` and read back when a built library is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_DIR = Path(__file__).parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class KernelBuildError(RuntimeError):
    pass


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
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return out
        inc = BUILD_DIR / f"inc_{self.name}_{tag}"
        inc.mkdir(exist_ok=True)
        (inc / f"{self.name}_gen.h").write_text(self.header)
        # compile to a process-unique name and publish atomically, so a
        # concurrent loader never maps a half-written library
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", *self.extra_flags,
            "-I", str(inc), "-o", str(tmp), str(src),
        ]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise KernelBuildError(f"failed to run nvcc: {e}") from e
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"nvcc failed on {src.name}:\n{proc.stderr[-4000:]}")
        log.write_text(proc.stderr)
        os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL:
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
