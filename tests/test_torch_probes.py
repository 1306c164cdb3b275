"""The port's profiling probes P1 and P2 (plain versions of csrc/chunked.cu
and csrc/nr_slices.cu) against the repo's JAX probes.

P1: the JAX probe `tools/prof_chunked.py` runs its Pallas kernel in
interpret mode on the CPU, whole-tile and chunked, at 512x1024 (its
module-level 24 MP shape is patched for the test); each mode against
`chain` on a CPU tensor, bound 1e-6 (the same 104 float32 operations in
the same order). P2: `tools/prof_nr_slices.py` builds its kernel
(`pallas_nr`) and its XLA reference (`xla_nr`) inside `main()`; the test
captures both from `jax.jit` and runs them at 128x256 and at 100x200 (not
a multiple of the probe's 64-row tile). `slices` matches `xla_nr` run op
by op exactly (the same products and sums in the same order), and
`pallas_nr` and the jitted `xla_nr` to 1e-6: compiled for the CPU, XLA
contracts a product and a sum into one fused multiply-add, which moves a
third of the values by an ulp. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.

P2's kernel (csrc/nr_slices.cu) sums each output's terms in another
arrangement than the plain version: input row by input row, each row
scattered into a ring of output rows. The order test replays that
arrangement in NumPy float32 from the source's compiled tap table and the
launch plan's bands, and holds it bit for bit to `slices_plain`.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import rapidraw_tpu.cli  # noqa: F401  (imported before jax.jit is patched below)
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from rapidraw_tpu_torch.tools import CHAIN_OPS_PER_ELEMENT, SLICES_OPS_PER_ELEMENT
from rapidraw_tpu_torch.tools import prof_chunked as tpc
from rapidraw_tpu_torch.tools import prof_nr_slices as tps

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
SLICES_CU = (Path(tps.__file__).resolve().parent.parent / "csrc" / "nr_slices.cu").read_text()


def cu_array(name: str) -> list[int]:
    body = re.search(rf"constexpr int {name}\[NTAPS\] = \{{([^}}]*)\}};", SLICES_CU).group(1)
    return [int(v) for v in body.split(",")]


def cu_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SLICES_CU).group(1))


def load_probe(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def image(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((3, h, w), dtype=np.float32)


@pytest.mark.parametrize("mode,ch", [("whole", 0), ("chunk", 8), ("chunk", 64)])
def test_chain_matches_jax_probe(monkeypatch, mode, ch):
    probe = load_probe("prof_chunked")
    monkeypatch.setattr(probe, "H", 512)
    monkeypatch.setattr(probe, "W", 1024)
    x = image(512, 1024, seed=ch)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.make_fn(mode, ch or 8)(jnp.asarray(x)))
    got = tpc.chain(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _Captured(Exception):
    pass


def capture_nr_probe(monkeypatch, h: int, w: int) -> dict:
    """`pallas_nr` and `xla_nr` from the probe's main(), at (3, h, w):
    recorded as main() hands them to jax.jit, before any timing runs."""
    probe = load_probe("prof_nr_slices")
    monkeypatch.setattr(probe, "H", h)
    monkeypatch.setattr(probe, "W", w)
    monkeypatch.setattr(rapidraw_tpu.cli, "_enable_persistent_jit_cache", lambda: None)
    real_jit = jax.jit
    fns = {}

    def recording_jit(fn, *args, **kwargs):
        fns[fn.__name__] = fn
        if {"pallas_nr", "xla_nr"} <= fns.keys():
            raise _Captured
        return real_jit(fn, *args, **kwargs)

    monkeypatch.setattr(jax, "jit", recording_jit)
    with pytest.raises(_Captured):
        probe.main()
    monkeypatch.setattr(jax, "jit", real_jit)
    return fns


@pytest.mark.parametrize("h,w", [(128, 256), (100, 200)])
def test_slices_matches_jax_probe(monkeypatch, h, w):
    fns = capture_nr_probe(monkeypatch, h, w)
    x = image(h, w, seed=h)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax.jit(fns["pallas_nr"])(jnp.asarray(x)))
    with jax.disable_jit():
        xla = np.asarray(fns["xla_nr"](jnp.asarray(x)))
    xla_fused = np.asarray(jax.jit(fns["xla_nr"])(jnp.asarray(x)))
    got = tps.slices(torch.from_numpy(x)).numpy()
    assert got.shape == pallas.shape == xla.shape == x.shape
    assert np.array_equal(got, xla)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla_fused, rtol=0, atol=1e-6)


def test_slices_plain_is_the_conv_yardstick():
    """The library call chip_smoke.py times computes the same function."""
    x = torch.from_numpy(image(40, 72, seed=3))
    xp, k = tps.conv_yardstick(x)
    conv = torch.nn.functional.conv2d(xp, k, groups=3)[0]
    np.testing.assert_allclose(conv.numpy(), tps.slices_plain(x).numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("probe", ["chain", "slices"])
def test_probe_wrappers_take_the_plain_path_on_the_cpu(probe):
    wrapper, plain = {"chain": (tpc.chain, tpc.chain_plain),
                      "slices": (tps.slices, tps.slices_plain)}[probe]
    x = torch.from_numpy(image(24, 40, seed=5))
    before = wrapper.launches
    assert torch.equal(wrapper(x), plain(x))
    assert wrapper.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(torch.empty((3, 24, 40), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        wrapper(x.double())


def test_probe_wrappers_reject_bad_work_splits():
    x = torch.zeros((3, 16, 32))
    for rows in (0, 65):
        with pytest.raises(ValueError, match="rows per thread"):
            tpc.chain(x, rows)
    for band_rows in (0, -15, 2.5, True):
        with pytest.raises(ValueError, match="bands of at least one row"):
            tps.slices(x, band_rows)
    with pytest.raises(ValueError, match="bands of at least one row"):
        tps.slices_launch_plan(3, 16, 32, 528, band_rows=0)
    with pytest.raises(ValueError, match="fewer than 65536 bands"):
        tps.slices_launch_plan(3, 65536, 32, 528, band_rows=1)
    with pytest.raises(ValueError, match="fewer than 65536 bands"):
        tps.slices_launch_plan(65536, 16, 32, 528)
    with pytest.raises(ValueError, match="non-empty"):
        tps.slices_launch_plan(3, 0, 32, 528)


def ring_order(x: np.ndarray, band_rows: int) -> np.ndarray:
    """csrc/nr_slices.cu's accumulation in NumPy float32, every column at
    once: per band, input rows y0 - HALO .. y0 + rows + HALO - 1 in
    increasing order (virtual rows outside the image are its edge rows,
    each scattered as its own row); step u starts output row y0 + u with
    0.5 x, then adds every tap of its row, in the compiled table's order, to
    the output row it belongs to (ring slot (u + RING - HALO - dy) % RING),
    and output row y0 + u - 2 HALO leaves the ring."""
    c, h, w = x.shape
    halo, ring = cu_int("HALO"), 2 * cu_int("HALO") + 1
    table = list(zip(cu_array("TAP_DX"), cu_array("TAP_DY")))
    weights = [np.float32(tps._weight(k)) for k in range(len(table))]
    cols = np.arange(w)
    out = np.full_like(x, np.nan)
    for y0 in range(0, h, band_rows):
        rows = min(band_rows, h - y0)
        acc = np.zeros((ring, c, w), np.float32)
        for u in range(rows + 2 * halo):
            if u < rows:
                acc[u % ring] = x[:, y0 + u] * np.float32(0.5)
            row = x[:, min(max(y0 - halo + u, 0), h - 1)]
            for k, (dx, dy) in enumerate(table):
                slot = (u + ring - halo - dy) % ring
                acc[slot] = acc[slot] + row[:, np.clip(cols + dx, 0, w - 1)] * weights[k]
            if u >= 2 * halo:
                out[:, y0 + u - 2 * halo] = acc[(u + 1) % ring]
    return out


@pytest.mark.parametrize("h,w", [(5, 9), (37, 95), (128, 256)])
def test_slices_ring_order_matches_plain(h, w):
    """The kernel's order of products and sums is the plain version's, bit
    for bit: at the plan's band on a card of 132 SMs x 1 block (1-3 rows
    here) and at bands that wrap the ring more than once or pass the
    image's height."""
    x = image(h, w, seed=h + w)
    want = tps.slices_plain(torch.from_numpy(x)).numpy()
    planned = tps.slices_launch_plan(3, h, w, 132)["band_rows"]
    for band in sorted({planned, 20, 50}):
        got = ring_order(x, band)
        assert np.array_equal(got, want), (band, float(np.nanmax(np.abs(got - want))))


def test_slices_launch_plan():
    """Bands cover every row once, blocks every column; the default band is
    the shortest whose grid fits one wave of resident blocks; 16-byte copies
    and stores only for aligned rows (W % 4 == 0 and aligned pointers), and
    the column blocks whose halo crosses an edge named."""
    for c, h, w in ((3, 4096, 6144), (3, 1000, 1503), (3, 5, 9), (2, 37, 95), (1, 300, 1024)):
        for slots in (132, 528, 1):
            plan = tps.slices_launch_plan(c, h, w, slots)
            cb, bands, planes = plan["grid"]
            band = plan["band_rows"]
            assert planes == c and cb * tps.BLOCK_COLS >= w > (cb - 1) * tps.BLOCK_COLS
            assert bands * band >= h > (bands - 1) * band
            assert plan["steps"] == band + 2 * tps.HALO
            if cb * c <= slots:
                assert cb * bands * c <= slots and plan["waves"] == 1
            else:  # not even one band per column block and plane fits
                assert band == h
            if band > 1:  # one row less would need more blocks than fit
                assert cb * -(-h // (band - 1)) * c > slots
            assert plan["vector"] == (w % 4 == 0)
            assert not tps.slices_launch_plan(c, h, w, slots, aligned=False)["vector"]
            assert plan["edge_blocks"] == [i for i in range(cb) if i == 0 or i == cb - 1
                                           or (i + 1) * tps.BLOCK_COLS + tps.PAD > w]
    plan = tps.slices_launch_plan(3, 4096, 6144, 132)
    assert plan["band_rows"] == 293 and plan["grid"] == (3, 14, 3)
    assert plan["vector"] and plan["edge_blocks"] == [0, 2]
    half = tps.slices_launch_plan(3, 4096, 6144, 132, band_rows=147)
    assert half["grid"] == (3, 28, 3) and half["waves"] == 2
    ragged = tps.slices_launch_plan(3, 1000, 1503, 132)
    assert ragged["vector"] is False and ragged["grid"] == (1, 44, 3)


def test_compiled_tap_table_is_offsets():
    """csrc/nr_slices.cu's compile-time taps are OFFSETS in table order,
    sorted by dy (the order proof's premise); its block and halo constants
    are the wrapper's; the weights the wrapper passes are f32(0.01 (k + 1))."""
    assert list(zip(cu_array("TAP_DX"), cu_array("TAP_DY"))) == tps.OFFSETS
    assert cu_array("TAP_DY") == sorted(cu_array("TAP_DY"))
    assert cu_int("HALO") == tps.HALO
    assert (cu_int("THREADS"), cu_int("COLS"), cu_int("PAD")) == (tps.THREADS, tps.COLS, tps.PAD)
    assert cu_int("NTAPS") == tps.NTAPS == 24
    weights = np.array(tps._weights().w, np.float32)
    assert np.array_equal(weights, [np.float32(0.01 * (k + 1)) for k in range(24)])


class _FakeLibrary:
    """Stands in for the built library: rr_nr_slices_taps writes `table`."""

    def __init__(self, table):
        self.table = table

    def rr_nr_slices_taps(self, dx, dy):
        for k, (a, b) in enumerate(self.table):
            dx[k], dy[k] = a, b
        return len(self.table)


def test_wrapper_refuses_a_compiled_table_that_is_not_offsets():
    tps.check_tap_table(_FakeLibrary(tps.OFFSETS))
    swapped = list(tps.OFFSETS)
    swapped[0], swapped[1] = swapped[1], swapped[0]
    with pytest.raises(ValueError, match="not OFFSETS"):
        tps.check_tap_table(_FakeLibrary(swapped))
    with pytest.raises(ValueError, match="not OFFSETS"):
        tps.check_tap_table(_FakeLibrary(tps.OFFSETS[:-1]))


def test_tap_table_check_outlives_a_freed_library():
    """A library that passed the check and was freed lends its address to
    the next object of its size: that object is checked on its own."""
    swapped = list(tps.OFFSETS)
    swapped[0], swapped[1] = swapped[1], swapped[0]
    good = _FakeLibrary(tps.OFFSETS)
    tps.check_tap_table(good)
    freed = id(good)
    del good
    bad = _FakeLibrary(swapped)  # CPython usually reuses the freed block at once
    with pytest.raises(ValueError, match="not OFFSETS"):
        tps.check_tap_table(bad)
    assert freed not in {id(lib) for lib in tps._CHECKED}


def test_probe_op_counts():
    """chip_smoke.count_ops gives the probes' bounds: 104 operations per
    element for P1, 49 for P2 (each output read and written once)."""
    x = torch.from_numpy(image(16, 24, seed=7))
    _, ops = chip_smoke.count_ops(lambda: tpc.chain_plain(x))
    assert ops == CHAIN_OPS_PER_ELEMENT * x.numel() == 104 * x.numel()
    _, ops = chip_smoke.count_ops(lambda: tps.slices_plain(x))
    assert ops == SLICES_OPS_PER_ELEMENT * x.numel() == 49 * x.numel()


@pytest.mark.parametrize("module", [tpc, tps])
def test_probe_main_refuses_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main()
