"""The port's 3D LUT (io/lut.py parsers, ops/lut3d.py, the LUT stage of the
grade) against the JAX package, on the CPU, on inputs made from a seed.

- Parsers: every parser gives the same array as JAX's on the same texts,
  images and files, and raises the same error with the same message.
- `apply_lut` at L = 2, 17 and 33, on values outside [0, 1] and on exact
  ties (fr == fg, fg == fb, all three): equal to JAX's run op by op, bit
  for bit (bound 1e-6: the same float32 operations in the same order).
- `finish_chain` with the LUT (and grain after it) against JAX's: 2e-4,
  the grade's bound; a document with `lutPath` and no cube skips the LUT
  in both.
The grade kernel's LUT stage is held against this plain version on the
card by chip_smoke.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidraw_tpu.io import lut as jlut
from rapidraw_tpu.ops import lut3d as jlut3d
from rapidraw_tpu.params.parse import parse_adjustments as jparse
from rapidraw_tpu.pipeline import grade as jgrade
import rapidraw_tpu_torch as rt
from rapidraw_tpu_torch.io import lut as tlut
from rapidraw_tpu_torch.ops import lut3d as tlut3d
from rapidraw_tpu_torch.pipeline import fused as tfused
from rapidraw_tpu_torch.pipeline import grade as tgrade

torch.set_num_threads(2)


def random_cube(size: int, seed: int) -> np.ndarray:
    """An (L, L, L, 3) cube: the identity bent by a seeded smooth field,
    with some entries past [0, 1]."""
    rng = np.random.default_rng(seed)
    cube = tlut.identity_lut(size)
    return (cube + 0.15 * np.sin(3.0 * cube[..., ::-1] + rng.random(3))
            + 0.02 * rng.standard_normal(cube.shape)).astype(np.float32)


def cube_text(size: int, seed: int) -> str:
    return "TITLE \"seeded\"\n# a comment\n" + tlut.lut_to_cube_text(random_cube(size, seed))


def lines_3dl(size: int, peak: int | None, mesh: bool, seed: int) -> str:
    """A .3dl body (blue fastest); integer code values up to `peak`, or
    floats in [0, 1] when peak is None; optionally an input-mesh line."""
    cube = np.clip(random_cube(size, seed), 0.0, 1.0).reshape(-1, 3)
    head = []
    if mesh:
        head.append(" ".join(str(int(v)) for v in np.linspace(0, peak or 1023, size)))
    if peak is None:
        body = [f"{r:.6f} {g:.6f} {b:.6f}" for r, g, b in cube]
    else:
        body = [" ".join(str(int(round(c * peak))) for c in row) for row in cube]
    return "\n".join(["# 3dl", *head, *body]) + "\n"


PARSE_CASES = {
    "cube 2": ("cube", cube_text(2, 1)),
    "cube 17": ("cube", cube_text(17, 2)),
    "cube 33 domain lines": ("cube", "DOMAIN_MIN 0 0 0\nDOMAIN_MAX 1 1 1\n" + cube_text(33, 3)),
    "cube no size": ("cube", "0 0 0\n1 1 1\n"),
    "cube malformed size": ("cube", "LUT_3D_SIZE\n0 0 0\n"),
    "cube short line": ("cube", "LUT_3D_SIZE 2\n0 0\n"),
    "cube size mismatch": ("cube", "LUT_3D_SIZE 2\n0 0 0\n1 1 1\n"),
    "3dl 12-bit with mesh": ("3dl", lines_3dl(17, 4095, True, 4)),
    "3dl 10-bit no mesh": ("3dl", lines_3dl(9, 1023, False, 5)),
    "3dl floats": ("3dl", lines_3dl(5, None, False, 6)),
    "3dl junk lines": ("3dl", "a b c\n" + lines_3dl(2, None, False, 7)),
    "3dl not a cube": ("3dl", "0 0 0\n1 1 1\n"),
    "3dl empty": ("3dl", "# nothing\n"),
}


def _same_outcome(run_port, run_jax):
    try:
        want = run_jax()
    except jlut.LutError as e:
        with pytest.raises(tlut.LutError) as info:
            run_port()
        assert str(info.value) == str(e)
        return None
    got = run_port()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    return got


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parsers_match_jax(case):
    kind, text = PARSE_CASES[case]
    tp, jp = {"cube": (tlut.parse_cube, jlut.parse_cube),
              "3dl": (tlut.parse_3dl, jlut.parse_3dl)}[kind]
    _same_outcome(lambda: tp(text), lambda: jp(text))


@pytest.mark.parametrize("side", [8, 64, 12])
def test_hald_matches_jax(side):
    """A HALD image (8 x 8 and 64 x 64 are perfect cubes; 12 x 12 is not)."""
    rng = np.random.default_rng(side)
    img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    _same_outcome(lambda: tlut.parse_hald(img), lambda: jlut.parse_hald(img))
    wide = rng.integers(0, 256, (side, side + 1, 3), dtype=np.uint8)
    _same_outcome(lambda: tlut.parse_hald(wide), lambda: jlut.parse_hald(wide))


@pytest.mark.parametrize("name", ["look.cube", "look.3dl", "look.CUBE", "look.xyz"])
def test_parse_lut_file_matches_jax(name, tmp_path):
    path = tmp_path / name
    text = cube_text(5, 8) if name.lower().endswith(".cube") else lines_3dl(5, 1023, True, 9)
    path.write_text(text)
    got = _same_outcome(lambda: tlut.parse_lut_file(path), lambda: jlut.parse_lut_file(path))
    assert (got is None) == name.endswith(".xyz")


@pytest.mark.parametrize("name", ["look.jpg", "look.jpeg", "look.tiff", "lzw.tiff", "grey.jpg",
                                  "prog.jpg"])
def test_hald_image_files_match_jax(name, tmp_path):
    """JPEG and TIFF HALD images (PIL's files, 64 x 64: a 16^3 cube) read
    at 8 bits through the port's decoders, as JAX's PIL convert("RGB")."""
    from PIL import Image

    side = 64
    hald = (np.arange(side * side * 3) * 37 % 256).astype(np.uint8).reshape(side, side, 3)
    im = Image.fromarray(hald[..., 0] if name.startswith("grey") else hald)
    kw = {"lzw.tiff": {"compression": "tiff_lzw"}, "prog.jpg": {"progressive": True}}.get(name, {})
    im.save(tmp_path / name, **kw)
    got = _same_outcome(lambda: tlut.parse_lut_file(tmp_path / name),
                        lambda: jlut.parse_lut_file(tmp_path / name))
    assert got is not None and got.shape == (16, 16, 16, 3)


def test_identity_and_cube_text_match_jax():
    for size in (2, 17):
        assert np.array_equal(tlut.identity_lut(size), jlut.identity_lut(size))
    cube = random_cube(9, 10)
    assert tlut.lut_to_cube_text(cube) == jlut.lut_to_cube_text(cube)
    back = tlut.parse_cube(tlut.lut_to_cube_text(cube))
    np.testing.assert_allclose(back, cube, atol=1e-6)


def lut_inputs(size: int, seed: int) -> np.ndarray:
    """(3, 64, 48) colours from a seed: values in [-0.3, 1.3], exact lattice
    points, and ties between the fractional coordinates."""
    rng = np.random.default_rng(seed)
    x = (rng.random((3, 64, 48)) * 1.6 - 0.3).astype(np.float32)
    grid = np.float32(size - 1)
    x[:, :8] = np.round(x[:, :8] * grid) / grid  # lattice points: all fractions 0
    x[1, 8:16] = x[0, 8:16]                     # fr == fg
    x[2, 16:24] = x[1, 16:24]                   # fg == fb
    x[1, 24:32] = x[0, 24:32]                   # all three equal
    x[2, 24:32] = x[0, 24:32]
    x[0, 32:40] = x[2, 32:40]                   # fr == fb
    return x


@pytest.mark.parametrize("size", [2, 17, 33])
def test_apply_lut_matches_jax(size):
    cube = random_cube(size, size)
    x = lut_inputs(size, 20 + size)
    with jax.disable_jit():
        want = np.asarray(jlut3d.apply_lut(jnp.asarray(x), jnp.asarray(cube), jnp.float32(0.8)))
    got = tlut3d.apply_lut(torch.from_numpy(x), torch.from_numpy(cube),
                           torch.tensor(0.8)).numpy()
    d = np.abs(got - want)
    print(f"L={size}: max|d| {d.max():.3e}, values that differ {(d > 0).mean():.2e}")
    assert got.shape == want.shape == x.shape
    assert d.max() <= 1e-6


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32))


@pytest.mark.parametrize("with_cube", [True, False])
def test_finish_chain_with_lut_matches_jax(with_cube):
    doc = {"lutPath": "look.cube", "lutIntensity": 70, "grainAmount": 30, "grainSize": 40}
    tp, tc = rt.parse_adjustments(doc)
    jp, jc = jparse(doc)
    assert tc.has_lut and jc.has_lut and tc.grain_active
    tc, jc = (dataclasses.replace(c, dither_active=False) for c in (tc, jc))
    cube = random_cube(17, 30) if with_cube else None
    h, w = 40, 48
    x = lut_inputs(17, 31)[:, :h, :w].copy()
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    with jax.disable_jit():
        want = jgrade.finish_chain(jnp.asarray(x), jp["glob"], jc, jnp.asarray(xs),
                                   jnp.asarray(ys), 1.0,
                                   lut=None if cube is None else jnp.asarray(cube))
    got = tgrade.finish_chain(torch.from_numpy(x), _torch_tree(tp["glob"]), tc,
                              torch.from_numpy(xs), torch.from_numpy(ys), 1.0,
                              lut=None if cube is None else torch.from_numpy(cube))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_grade_wrapper_takes_the_cube_on_cpu():
    """grade() on CPU tensors with a LUT is grade_plain with it; a cube
    that is not (L, L, L, 3) is refused."""
    doc = {"lutPath": "look.cube", "lutIntensity": 80, "exposure": 0.3}
    p, c = rt.parse_adjustments(doc)
    sp, c = rt.stack_params([p], [c], device="cpu")
    pmat = tfused.pack_rows(sp["glob"])
    x = torch.from_numpy(lut_inputs(9, 40)[None, :, :16, :24].copy())
    cube = torch.from_numpy(random_cube(9, 41))
    before = tfused.grade.launches
    a = tfused.grade(x, {}, pmat, c, lut=cube)
    assert torch.equal(a, tfused.grade_plain(x, {}, pmat, c, lut=cube))
    assert not torch.equal(a, tfused.grade(x, {}, pmat, c))  # without the cube: no LUT stage
    assert tfused.grade.launches == before
    with pytest.raises(ValueError, match="LUT"):
        tfused.grade(x, {}, pmat, c, lut=cube[:, :, :4])
