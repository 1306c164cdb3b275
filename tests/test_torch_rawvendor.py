"""The port's vendor RAW containers (rapidraw_tpu_torch.io.makers, .cr3,
.crx, .iiq and the host decoders in csrc/host/) against the JAX package's,
on the CPU.

Every file the JAX package's own container tests build (tests/
test_raw_containers.py, tests/test_iiq.py, tests/test_crx.py) goes through
both packages: each JAX test runs with its `parse_raw` (and the sniffer,
`parse_dng`, `parse_cr3_info` and the native bindings it calls) replaced by a twin that calls the
JAX function and the port's on the same arguments and asserts that both
return the same value, field for field, or raise the same error type with
the same message. The JAX test's own assertions then run on JAX's result,
so the file it builds is the file it meant. The decoders also meet the
mutated streams of tools/fuzz_native.py in a child process, as
tests/test_native_fuzz.py runs them for the JAX package.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import rapidraw_tpu.io.cr3 as jcr3
import rapidraw_tpu.native as jnative
import test_crx as tcx
import test_iiq as tiq
import test_raw_containers as trc
from rapidraw_tpu.io import containers as jcontainers
from rapidraw_tpu.io import dng as jdng
from rapidraw_tpu_torch import native
from rapidraw_tpu_torch.io import containers, cr3, crx, dng
from test_native_ljpeg import encode_ljpeg
from test_torch_rawio import assert_same_rawfile

REPO = Path(__file__).resolve().parent.parent


def same_error(got: BaseException, want: BaseException) -> None:
    assert type(got).__name__ == type(want).__name__, (got, want)
    assert str(got) == str(want)
    assert getattr(got, "format", None) == getattr(want, "format", None)


def twin(jfn, pfn, compare, log: list):
    """A stand-in for the JAX function `jfn`: calls it and the port's `pfn`
    on the same arguments, holds the two outcomes equal, and returns (or
    raises) the JAX function's own."""

    def call(*args, **kwargs):
        try:
            want = jfn(*args, **kwargs)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pfn(*args, **kwargs)
            same_error(got.value, e)
            log.append("raised")
            raise
        compare(pfn(*args, **kwargs), want)
        log.append("equal")
        return want

    return call


def same_array(got, want) -> None:
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert np.array_equal(got, want)


def same_info(got, want) -> None:
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def same_value(got, want) -> None:
    assert got == want


def run_twinned(test, monkeypatch, tmp_path) -> list:
    """Run one JAX container test with the package functions it calls
    replaced by their twins; returns the log of twinned calls."""
    log: list = []
    mod = sys.modules[test.__module__]
    monkeypatch.setattr(mod, "parse_raw", twin(jcontainers.parse_raw, containers.parse_raw,
                                               assert_same_rawfile, log))
    if hasattr(mod, "sniff_container"):
        monkeypatch.setattr(mod, "sniff_container", twin(
            jcontainers.sniff_container, containers.sniff_container, same_value, log))
    if mod is trc:
        monkeypatch.setattr(trc, "parse_dng", twin(jdng.parse_dng, dng.parse_dng,
                                                   assert_same_rawfile, log))
    monkeypatch.setattr(jcr3, "parse_cr3_info",
                        twin(jcr3.parse_cr3_info, cr3.parse_cr3_info, same_info, log))
    for name in ("panasonic_decode", "olympus_decode", "phase_one_decode", "crx_decode"):
        monkeypatch.setattr(jnative, name,
                            twin(getattr(jnative, name), getattr(native, name), same_array, log))
    if mod is tcx:
        monkeypatch.setattr(tcx, "crx_decode",
                            twin(tcx.crx_decode, native.crx_decode, same_array, log))
        monkeypatch.setattr(tcx, "crx_encode",
                            twin(tcx.crx_encode, native.crx_encode, same_value, log))
    test(**{p: tmp_path for p in inspect.signature(test).parameters})
    return log


# the JAX tests that build a vendor file (or a DNG or refusal beside them)
# and parse it, by format
BUILDERS = {
    "cr2": ["test_cr2_sliced_ljpeg_roundtrip", "test_cr2_bits_from_sof3_precision"],
    "nef": ["test_nef_packed12_roundtrip", "test_nef_compressed_lossless12_roundtrip",
            "test_nef_compressed_bigendian_makernote",
            "test_nef_lossy_type2_ver40_curve_and_white"],
    "pef": ["test_pef_huffman_roundtrip", "test_pef_custom_huffman_table_0x220",
            "test_extension_tail_ptx_routes_to_pef"],
    "arw": ["test_arw2_roundtrip_quantized", "test_arw2_partial_width_decodes_full_blocks",
            "test_arw_packed14_roundtrip", "test_arw2_curve_is_12bit_index_space"],
    "orf": ["test_orf_uncompressed16_roundtrip", "test_orf_packed12_roundtrip",
            "test_orf_corrupt_predictive_rejected", "test_orf_predictive_roundtrip",
            "test_orf_predictive_container_parse"],
    "rw2": ["test_rw2_bitstream_roundtrip", "test_rw2_container_parse",
            "test_rwl_routes_to_rw2_parser", "test_bare_panasonic_raw_routes_by_magic"],
    "mrw": ["test_mrw_packed_roundtrip", "test_mrw_unpacked_and_gbrg",
            "test_mrw_malformed_refused"],
    "tiffcfa": ["test_erf_packed_12bit", "test_srw_16bit_wb", "test_fff_16bit_bigendian_pattern",
                "test_3fr_compressed_refused_precisely", "test_kdc_asshotneutral_wb",
                "test_mef_ext_dispatch_without_make", "test_tiffcfa_truncated_strip_refused",
                "test_extension_tail_tiff_shaped_decodes",
                "test_extension_tail_precise_refusals"],
    "cr3": ["test_cr3_container_metadata_and_refusal"],
    "iiq": ["test_iiq_without_phase_one_directory_is_malformed"],
    "other": ["test_sniff_and_unsupported_errors", "test_dng_with_vendor_make_routes_to_dng",
              "test_crw_refused_precisely", "test_ari_metadata_and_refusal",
              "test_dng_spp_allocation_bomb_refused", "test_dng_short_asshotneutral_neutral_wb",
              "test_dng_missing_stripbytecounts_multi_strip", "test_raf_uncompressed_roundtrip",
              "test_raf_compressed_rejected_actionably", "test_sniff_tiff_family_dispatch"],
}
IIQ_TESTS = [
    "test_iiq_format5_roundtrip", "test_iiq_format5_bigendian_margins_and_matrix",
    "test_iiq_format1_xor_scramble", "test_iiq_format0_plain_and_dimensions",
    "test_iiq_unknown_format_refuses_precisely", "test_iiq_malformed_raises_valueerror",
    "test_iiq_meta_quadrant_multipliers", "test_iiq_meta_defect_bad_pixel",
    "test_iiq_meta_defect_bad_column", "test_iiq_meta_poly_curves",
    "test_iiq_meta_malformed_degrades_to_uncorrected",
    "test_iiq_meta_flat_field_u16_matches_dcraw_loops", "test_iiq_meta_flat_field_float_allcolor",
    "test_iiq_meta_flat_field_redblue", "test_iiq_meta_quadrant_linearization",
    "test_iiq_meta_quadrant_combined_respects_qmult_order", "test_iiq_meta_41e_blocks_41f",
    "test_iiq_meta_nonfinite_payloads_degrade", "test_iiq_meta_spatial_gain_412",
    "test_iiq_meta_spatial_gain_412_selects_by_tag_21a",
    "test_iiq_meta_flat_field_and_412_malformed_degrade",
    "test_iiq_meta_corrections_fuzz_never_crash", "test_iiq_predictor_overflow_is_nonfatal",
]
CRX_TESTS = ["test_cr3_full_decode_path", "test_cr3_sensor_info_crop_and_black",
             "test_cr3_corrupt_payload_falls_back_to_refusal", "test_codec_roundtrip_natural",
             "test_codec_roundtrip_extremes", "test_codec_rejects_garbage_and_truncation",
             "test_codec_compresses_smooth_content"]

CASES = ([(fmt, trc, name) for fmt, names in BUILDERS.items() for name in names]
         + [("iiq", tiq, name) for name in IIQ_TESTS]
         + [("cr3", tcx, name) for name in CRX_TESTS])


@pytest.mark.parametrize("fmt,mod,name", CASES,
                         ids=[f"{fmt}-{name.removeprefix('test_')}" for fmt, _, name in CASES])
def test_port_parses_every_builder_as_jax(fmt, mod, name, monkeypatch, tmp_path):
    log = run_twinned(getattr(mod, name), monkeypatch, tmp_path)
    assert log, f"{name} reached no twinned call"


def test_the_builder_table_covers_the_jax_container_tests():
    """Every JAX test of these files runs against the port here (twinned,
    or with the port's module in place) or tests a part the port leaves
    out or tests elsewhere: the DNG bit packing (tests/test_torch_rawio.py),
    loads through the JAX loader, the X-Trans demosaic
    (tests/test_torch_raw.py) and the dimension queries."""
    covered = {name for _, _, name in CASES} | {name for _, name, _ in MODULE_TESTS}
    elsewhere = {
        "test_dng_packed_bits_roundtrip", "test_loader_unsupported_is_actionable",
        "test_xtrans_demosaic_properties",
        "test_raf_loads_end_to_end", "test_xtrans_directional_edge_quality",
        "test_raf_dimensions_agree_with_decoded_shape",
        "test_raf_embedded_tiff_missing_height_refuses", "test_iiq_loads_end_to_end",
    }
    for mod in (trc, tiq, tcx):
        names = {n for n in vars(mod) if n.startswith("test_")}
        assert names <= covered | elsewhere, sorted(names - covered - elsewhere)


# JAX tests of a module's own functions, run with the port's functions in
# place of the JAX package's: (test module, test, {JAX module: names})
MODULE_TESTS = [
    (tcx, "test_cmp1_roundtrip", {}), (tcx, "test_cmp1_rejects_implausible", {}),
    (tcx, "test_decode_raw_mosaic_roundtrip", {}), (tcx, "test_decode_raw_refuses_lossy_modes", {}),
    (tcx, "test_cmp1_byte_layout_matches_public_spec", {"rapidraw_tpu.io.crx": ["parse_cmp1"]}),
    (tiq, "test_cubic_spline_curve_identity_and_linear",
     {"rapidraw_tpu.io.iiq": ["_cubic_spline_curve"]}),
]


@pytest.mark.parametrize("mod,name,swaps", MODULE_TESTS, ids=[n for _, n, _ in MODULE_TESTS])
def test_port_module_passes_the_jax_test(mod, name, swaps, monkeypatch):
    """The port's crx module (CMP1 header, encode_raw / decode_raw) and IIQ
    spline curve under the JAX package's own tests of them."""
    from rapidraw_tpu_torch.io import iiq

    port = {"rapidraw_tpu.io.crx": crx, "rapidraw_tpu.io.iiq": iiq}
    monkeypatch.setattr(tcx, "crx", crx)
    for jmod, names in swaps.items():
        for n in names:
            monkeypatch.setattr(sys.modules[jmod], n, getattr(port[jmod], n))
    getattr(mod, name)()


# the four host decoders: each builds from the port's source into _build/
HOST = {"vendor_huff": ("nikon_decode", "pentax_decode"),
        "pana_oly": ("panasonic_decode", "olympus_decode"),
        "crx": ("crx_decode", "crx_encode"),
        "phase_one": ("phase_one_decode",)}


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_decoder_builds_from_the_port_source(name):
    lib = native.host_library(name)
    assert Path(lib._name).parent == native.BUILD_DIR
    assert Path(lib._name).name.startswith(f"lib{name}_host_")
    for fn in HOST[name]:
        assert hasattr(lib, fn)
    src = (native.CSRC / "host" / f"{name}.cc").read_text()
    jsrc = (REPO / "rapidraw_tpu" / "native" / f"{name}.cc").read_text()
    # the same code as the JAX package's decoder; only the header comment differs
    code = [ln for ln in src.splitlines() if not ln.startswith("//")]
    jcode = [ln for ln in jsrc.splitlines() if not ln.startswith("//")]
    assert code == jcode


def _huffman_streams():
    rng = np.random.default_rng(31)
    cfa = rng.integers(0, 1 << 12, (12, 20), dtype=np.uint16)
    return cfa, trc._encode_nikon_lossless12(cfa), trc._encode_pentax(cfa)


def test_nikon_and_pentax_decoders_equal_jax():
    cfa, nef, pef = _huffman_streams()
    for stream in (nef, nef[: len(nef) // 2], b"\xff" * 64):
        args = (stream, 20, 12, 2, 0, [0, 0, 0, 0], 12)
        try:
            want = jnative.nikon_decode(*args)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native.nikon_decode(*args)
            same_error(got.value, e)
            continue
        same_array(native.nikon_decode(*args), want)
    assert np.array_equal(native.nikon_decode(nef, 20, 12, 2, 0, [0] * 4, 12), cfa)
    codes = trc._pentax_codemap([4, 3, 2, 5, 1, 6, 0, 7, 8, 9, 10, 12, 11])
    custom = trc._encode_pentax(cfa, codes)
    table = ([codes[c][0] << (12 - codes[c][1]) for c in range(13)],
             [codes[c][1] for c in range(13)], list(range(13)))
    for stream, tab in ((pef, None), (custom, table), (pef[:40], None)):
        try:
            want = jnative.pentax_decode(stream, 20, 12, 12, tab)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native.pentax_decode(stream, 20, 12, 12, tab)
            same_error(got.value, e)
            continue
        same_array(native.pentax_decode(stream, 20, 12, 12, tab), want)
    assert np.array_equal(native.pentax_decode(pef, 20, 12, 12), cfa)


def test_pentax_table_checks_as_jax():
    bad = ([1, 2], [3], [4, 5])
    with pytest.raises(ValueError) as want:
        jnative.pentax_decode(b"\0" * 16, 4, 2, 12, bad)
    with pytest.raises(ValueError, match="<=32") as got:
        native.pentax_decode(b"\0" * 16, 4, 2, 12, bad)
    same_error(got.value, want.value)


FUZZ_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, "tools")
sys.path.insert(0, ".")
import fuzz_native
from rapidraw_tpu import native as jnative
from rapidraw_tpu_torch import native

decoder = sys.argv[1]
trials = int(sys.argv[2])
seeds = fuzz_native._build_seeds(decoder)


def run(mod, buf):
    try:
        return ("ok", _decode(mod, buf))
    except ValueError as e:
        return ("ValueError", str(e))


def _decode(mod, buf):
    if decoder == "nikon":
        return mod.nikon_decode(buf, 32, 16, 2, 0, [0, 0, 0, 0], 12)
    if decoder == "pentax":
        return mod.pentax_decode(buf, 32, 16, 12)
    if decoder == "panasonic":
        return mod.panasonic_decode(buf, 56, 16)
    if decoder == "olympus":
        return mod.olympus_decode(buf, 32, 32, 16)
    if decoder == "crx":
        return mod.crx_decode(buf, 4, 24, 16)
    offs = np.linspace(0, max(len(buf) - 8, 0), 16).astype(np.uint32)
    return mod.phase_one_decode(buf, offs, 24, 16, 5, False)


for si, seed in enumerate(seeds):
    for trial in range(trials):
        buf = fuzz_native._mutate(seed, np.random.default_rng(trial))
        a, b = run(native, buf), run(jnative, buf)
        same = a[0] == b[0] and (np.array_equal(a[1], b[1]) if a[0] == "ok" else a[1] == b[1])
        if not same:
            print(f"DIFFER {decoder} seed={si} trial={trial}: port {a[0]}, jax {b[0]}")
            sys.exit(3)
print(f"ok {decoder}: {trials * len(seeds)} mutations, the port as the JAX package")
"""


@pytest.mark.parametrize("decoder", ["nikon", "pentax", "panasonic", "olympus", "crx",
                                     "phase_one"])
def test_port_decoder_survives_the_native_fuzz_as_jax(decoder):
    """tools/fuzz_native.py's mutations of its seed streams (the same 120 of
    tests/test_native_fuzz.py) through the port's binding and the JAX
    package's, in a child process so that a crash fails this test instead
    of the test run: each mutation decodes to the same plane in both or
    raises ValueError with the same message in both."""
    proc = subprocess.run(
        [sys.executable, "-c", FUZZ_CHILD, decoder, "120"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, (
        f"{decoder}: exit {proc.returncode}\n{proc.stdout[-1500:]}\n{proc.stderr[-1500:]}")
    assert proc.stdout.strip().startswith(f"ok {decoder}")


# chip_smoke.py's writers of the vendor files: each bitstream byte for byte
# the repo's test encoder's, at small sizes
WRITER_SHAPES = [(1, 2), (4, 6), (10, 14)]


@pytest.mark.parametrize("shape", WRITER_SHAPES)
def test_chip_smoke_cr2_stream_is_the_test_encoder(shape):
    """The sliced CR2 strip: lossless JPEG, two interleaved 14-bit
    components (and the one-component 16-bit stream of the DNG files)."""
    s = np.random.default_rng(41).integers(0, 1 << 14, shape, dtype=np.uint16)
    assert chip_smoke.ljpeg_encode(s, precision=14, ncomp=2) == encode_ljpeg(s, precision=14,
                                                                                ncomp=2)
    assert chip_smoke.ljpeg_encode(s) == encode_ljpeg(s, precision=16)


@pytest.mark.parametrize("shape", WRITER_SHAPES)
def test_chip_smoke_nef_and_pef_streams_are_the_test_encoders(shape):
    cfa = np.random.default_rng(42).integers(0, 1 << 12, shape, dtype=np.uint16)
    nef = chip_smoke.vendor_huffman(cfa, chip_smoke.NIKON_LOSSLESS12)
    assert nef == trc._encode_nikon_lossless12(cfa)
    assert chip_smoke.vendor_huffman(cfa, chip_smoke.PENTAX_DEFAULT) == trc._encode_pentax(cfa)
    assert chip_smoke.pack_12le(cfa) == trc._pack_12le(cfa)
    assert chip_smoke.mrw_bytes(cfa) == trc._build_mrw(cfa, packed=True)


@pytest.mark.parametrize("shape", [(2, 32), (3, 64), (1, 96)])
def test_chip_smoke_arw2_stream_is_the_test_encoder(shape):
    """ARW2 blocks byte for byte, and the decoder gives the Sony curve of
    the plane the writer says it quantized (with a flat block, where the
    min's position is not the first minimum)."""
    from rapidraw_tpu.io.makers import _arw2_curve, _arw2_decode

    plane = np.random.default_rng(43).integers(0, 0x800, shape, dtype=np.uint16)
    plane[0, :32] = 0x3FF
    stream, quant = chip_smoke.arw2_encode(plane)
    assert stream == trc._encode_arw2(plane)
    assert np.array_equal(_arw2_decode(stream, shape[1], shape[0]),
                          _arw2_curve()[quant.astype(np.int64) << 1])


@pytest.mark.parametrize("big_romm", [False, True])
def test_chip_smoke_iiq_file_is_the_test_writer(big_romm):
    pred = np.random.default_rng(44).integers(0, 16000, (5, 21)).astype(np.uint16)
    romm = np.eye(3) * 1.1 if big_romm else None
    assert chip_smoke.iiq_bytes(pred, romm=romm) == tiq._build_iiq(pred, fmt=5, black=64,
                                                                    romm=romm)


def test_chip_smoke_sequential_streams_are_the_test_encoders():
    """The ORF predictive and Panasonic streams draw from the generator as
    the test encoders do: the same bytes and frames from the same seed."""
    got, want = (chip_smoke.orf_predictive(6, 10, np.random.default_rng(3)),
                 trc._encode_orf_predictive(6, 10, np.random.default_rng(3)))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    got, want = (chip_smoke.rw2_stream(6, 28, np.random.default_rng(3)),
                 trc._encode_rw2_stream(6, 28, np.random.default_rng(3)))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])


def test_chip_smoke_rw2_stream_spans_sections():
    """Past 1024 blocks the stream takes a second 0x4000-byte section."""
    stream, plane = chip_smoke.rw2_stream(40, 560, np.random.default_rng(5))
    assert len(stream) == 2 * 0x4000
    assert np.array_equal(native.panasonic_decode(stream, 560, 40), plane)


VENDOR_KINDS = [*chip_smoke.VENDOR_MAIN, *chip_smoke.VENDOR_OTHER]


@pytest.mark.parametrize("kind", VENDOR_KINDS)
def test_chip_smoke_vendor_files_parse_as_jax(kind):
    """Each of phase 12's files at a small size decodes to the CFA it was
    written from, in the port as in the JAX package, field for field."""
    h, w = (36, 64) if kind != "rw2" else (38, 112)
    data, want = chip_smoke.vendor_file(kind, h, w, 50)
    ext = chip_smoke.VENDOR_OTHER.get(kind, (kind,))[0]
    got = containers.parse_raw(data, ext)
    assert_same_rawfile(got, jcontainers.parse_raw(data, ext))
    assert got.cfa.dtype == np.uint16 and np.array_equal(got.cfa, want)
    if kind in chip_smoke.VENDOR_MAIN:
        assert got.cfa.shape == (h, w) and got.xyz_to_cam is None
        assert not np.allclose(got.wb, 1.0)
