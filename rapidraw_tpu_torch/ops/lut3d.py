"""3D LUT application with tetrahedral interpolation (plain PyTorch).

Port of `rapidraw_tpu/ops/lut3d.py` (shader.wgsl:1243-1311): the RGB cube
is split into 6 tetrahedra by the ordering of the fractional coordinates,
and the output is a 4-corner barycentric blend. This is the plain version
of the grade kernel's LUT stage (csrc/grade.cu), which fetches only the
selected tetrahedron's corners. Planar (3, ...) layout; the cube comes from
`io/lut.py`.
"""

from __future__ import annotations

import torch


def sample_lut_tetrahedral(rgb: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """rgb: (3, ...) (clamped to [0, 1] here); lut: (L, L, L, 3) indexed [r, g, b]."""
    size = lut.shape[0]
    scaled = torch.clamp(rgb, 0.0, 1.0) * (size - 1)
    i0 = torch.floor(scaled)
    f = scaled - i0
    c0 = i0.to(torch.int64)
    c1 = torch.clamp_max(c0 + 1, size - 1)
    flat = lut.reshape(-1, 3)

    def fetch(xi, yi, zi):
        return flat[(xi * size + yi) * size + zi].movedim(-1, 0)  # planar (3, ...)

    r0, g0, b0 = c0[0], c0[1], c0[2]
    r1, g1, b1 = c1[0], c1[1], c1[2]
    fr, fg, fb = f[0], f[1], f[2]

    c000 = fetch(r0, g0, b0)
    c111 = fetch(r1, g1, b1)
    c100 = fetch(r1, g0, b0)
    c110 = fetch(r1, g1, b0)
    c101 = fetch(r1, g0, b1)
    c001 = fetch(r0, g0, b1)
    c011 = fetch(r0, g1, b1)
    c010 = fetch(r0, g1, b0)

    def t(w0, wa, ca, wb, cb, w1):
        return c000 * w0 + ca * wa + cb * wb + c111 * w1

    # 6 tetrahedra by the sort order of (fr, fg, fb) (shader.wgsl:1256-1308)
    t1 = t(1.0 - fr, fr - fg, c100, fg - fb, c110, fb)  # r > g > b
    t2 = t(1.0 - fr, fr - fb, c100, fb - fg, c101, fg)  # r > g, r > b >= g
    t3 = t(1.0 - fb, fb - fr, c001, fr - fg, c101, fg)  # b >= r > g
    t4 = t(1.0 - fb, fb - fg, c001, fg - fr, c011, fr)  # b > g >= r
    t5 = t(1.0 - fg, fg - fb, c010, fb - fr, c011, fr)  # g >= b > r
    t6 = t(1.0 - fg, fg - fr, c010, fr - fb, c110, fb)  # g >= r, b <= r

    res_hi = torch.where(fg > fb, t1, torch.where(fr > fb, t2, t3))
    res_lo = torch.where(fb > fg, t4, torch.where(fb > fr, t5, t6))
    return torch.where(fr > fg, res_hi, res_lo)


def apply_lut(rgb: torch.Tensor, lut: torch.Tensor, intensity) -> torch.Tensor:
    """mix(rgb, lut(rgb), intensity) (shader.wgsl:1699-1702)."""
    lut_color = sample_lut_tetrahedral(rgb, lut)
    return rgb * (1.0 - intensity) + lut_color * intensity
