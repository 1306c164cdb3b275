"""First-use builds of the port's libraries (rapidraw_tpu_torch/native.py)
from many threads of one process at once.

The export's prepare and encode pools and the preview service's workers
reach `native.host_library` and `KernelLibrary.lib()` from several
threads on a machine whose `_build/` is empty: every thread must get the
one library, built once, with no temporary file left behind.

- `host_library("tiff_codec")` from 8 threads released together by a
  barrier, into an empty build directory: one handle, one `.so`, no
  `.tmp`.
- `KernelLibrary` the same way without nvcc: `native._nvcc` is replaced by
  a script that copies a prebuilt host library (exporting the
  `rr_error_string` every kernel library exports) to its `-o` argument and
  counts its runs.
"""

from __future__ import annotations

import os
import stat
import subprocess
import threading

import pytest

from rapidraw_tpu_torch import native

THREADS = 8


def _together(fn, n: int = THREADS) -> tuple[list, list]:
    """Run fn() in n threads released at once; (results, exceptions)."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def body(i):
        barrier.wait()
        try:
            results[i] = fn()
        except Exception as e:  # noqa: BLE001 - collected and asserted on
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return results, errors


@pytest.fixture
def empty_build(tmp_path, monkeypatch):
    build = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_host_libs", {})
    return build


def test_host_library_builds_once_across_threads(empty_build):
    results, errors = _together(lambda: native.host_library("tiff_codec"))
    assert errors == []
    assert all(r is results[0] for r in results) and results[0] is not None
    assert [p.name for p in empty_build.glob("*.so")] == [os.path.basename(results[0]._name)]
    assert not list(empty_build.glob("*.tmp"))
    assert native.host_library("tiff_codec") is results[0]


def test_host_library_failed_build_raises_in_every_thread(tmp_path, monkeypatch, empty_build):
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    results, errors = _together(lambda: native.host_library("broken"), n=4)
    assert len(errors) == 4 and all(isinstance(e, native.KernelBuildError) for e in errors)
    assert not list(empty_build.glob("*.so*"))


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc: copies a prebuilt library to its -o argument and
    appends a line to a counter file per run."""
    so = tmp_path / "prebuilt.so"
    src = tmp_path / "prebuilt.cc"
    src.write_text('extern "C" const char* rr_error_string(int) { return "fake"; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(so)], check=True)
    runs = tmp_path / "runs.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
        f'echo run >> "{runs}"\n'
        "sleep 0.2\n"
        f'cp "{so}" "$out"\n'
        'echo "ptxas info    : Used 8 registers" 1>&2\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(native, "_nvcc", lambda: str(script))
    return runs


def test_kernel_library_builds_once_across_threads(empty_build, fake_nvcc):
    lib = native.KernelLibrary("blur", header="// test header\n")
    results, errors = _together(lib.lib)
    assert errors == []
    assert all(r is results[0] for r in results)
    assert fake_nvcc.read_text().count("run") == 1
    assert len(list(empty_build.glob("*.so"))) == 1
    assert not list(empty_build.rglob("*.tmp"))
    assert "Used 8 registers" in lib.build_log
    assert results[0].rr_error_string(0) == b"fake"


def test_kernel_libraries_of_one_source_share_one_build(empty_build, fake_nvcc):
    """Separate KernelLibrary objects of the same source and flags (the
    variant tools make several) publish one file, built once."""
    libs = [native.KernelLibrary("blur", header="// h\n") for _ in range(THREADS)]
    it = iter(libs)
    lock = threading.Lock()

    def one():
        with lock:
            kl = next(it)
        return kl.lib()

    results, errors = _together(one)
    assert errors == [] and all(r is not None for r in results)
    assert fake_nvcc.read_text().count("run") == 1
    assert len(list(empty_build.glob("*.so"))) == 1
    assert not list(empty_build.rglob("*.tmp"))
    assert all(kl.build_log.strip().endswith("Used 8 registers") for kl in libs)
