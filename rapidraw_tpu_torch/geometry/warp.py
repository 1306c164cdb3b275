"""Inverse-mapped geometry warp: perspective/rotate/scale/aspect/offset
homography fused with lens distortion, TCA and vignetting (exact path).

Port of `rapidraw_tpu/geometry/warp.py` (image_processing.rs:645-803):
  * forward homography T_center*Offset*Perspective*Rotate*Scale*T_uncenter,
    inverted once on the host (float32, NumPy);
  * lens auto-crop scale from 8 border samples;
  * lensfun-style distortion (ptlens or poly on the half-diagonal radius,
    blended by amount*2.5) and the manual r^2 distortion;
  * TCA: red/blue sampled at radially scaled coordinates with a clamping
    sampler, while the plain path is black outside [0, W-1);
  * the lens vignetting gain after sampling.

Here the exact path is plain PyTorch gathers on the image's device; the
planned two-pass path (geometry/warp_fast.py) runs on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidraw_tpu_torch.geometry.params import GeometryParams
from rapidraw_tpu_torch.ops.common import coord_maps, sqrt_rn, true_div


def build_transform_matrix(p: GeometryParams, width: float, height: float) -> np.ndarray:
    """Forward homography (image_processing.rs:408-455), float32."""
    cx, cy = width / 2.0, height / 2.0
    ref_dim = 2000.0
    p_vert = (p.vertical / 100000.0) * (ref_dim / height)
    p_horiz = (-p.horizontal / 100000.0) * (ref_dim / width)
    theta = np.deg2rad(p.rotate)
    if p.aspect >= 0.0:
        aspect = 1.0 + p.aspect / 100.0
    else:
        aspect = 1.0 / (1.0 + abs(p.aspect) / 100.0)
    scale = p.scale / 100.0
    off_x = (p.x_offset / 100.0) * width
    off_y = (p.y_offset / 100.0) * height

    t_center = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float32)
    t_uncenter = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    m_persp = np.array([[1, 0, 0], [0, 1, 0], [p_horiz, p_vert, 1]], np.float32)
    s, c = np.sin(theta), np.cos(theta)
    m_rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    m_scale = np.array(
        [[scale * aspect, 0, 0], [0, scale, 0], [0, 0, 1]], np.float32
    )
    m_off = np.array([[1, 0, off_x], [0, 1, off_y], [0, 0, 1]], np.float32)
    return t_center @ m_off @ m_persp @ m_rot @ m_scale @ t_uncenter


def _inverse(p: GeometryParams, w: int, h: int) -> np.ndarray:
    forward = build_transform_matrix(p, float(w), float(h))
    try:
        return np.linalg.inv(forward)
    except np.linalg.LinAlgError:
        return np.eye(3, dtype=np.float32)


def _distort_radius_norm(ru_norm, p: GeometryParams):
    """Distorted radius (normalized), ptlens or poly model (:737-749)."""
    r2 = ru_norm * ru_norm
    if p.lens_model == 1:
        a, b, c = p.lens_dist_k1, p.lens_dist_k2, p.lens_dist_k3
        d = 1.0 - a - b - c
        return ru_norm * (a * r2 * ru_norm + b * r2 + c * ru_norm + d)
    k1, k2, k3 = p.lens_dist_k1, p.lens_dist_k2, p.lens_dist_k3
    return ru_norm * (1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2)


def _has_lens(p: GeometryParams) -> bool:
    return p.lens_distortion_enabled and (
        abs(p.lens_dist_k1) > 1e-6 or abs(p.lens_dist_k2) > 1e-6 or abs(p.lens_dist_k3) > 1e-6
    )


def _tca_scales(p: GeometryParams) -> tuple[float, float]:
    """Effective TCA scale factors blended by amount (:679-688)."""
    vr = p.tca_vr + (1.0 - p.tca_vr) * (1.0 - p.lens_tca_amount) if abs(p.tca_vr - 1.0) > 1e-5 else 1.0
    vb = p.tca_vb + (1.0 - p.tca_vb) * (1.0 - p.lens_tca_amount) if abs(p.tca_vb - 1.0) > 1e-5 else 1.0
    return vr, vb


def compute_lens_auto_crop_scale(p: GeometryParams, width: float, height: float) -> float:
    """8-border-sample auto-crop factor (image_processing.rs:557-643)."""
    cx, cy = width / 2.0, height / 2.0
    half_diag = np.sqrt(cx * cx + cy * cy)
    max_radius_sq_inv = 1.0 / (cx * cx + cy * cy)
    lens_amt = p.lens_distortion_amount * 2.5
    k_distortion = (p.distortion / 100.0) * 2.5
    has_lens = _has_lens(p)
    samples = [
        (cx, 0.0), (cx, height), (0.0, cy), (width, cy),
        (0.0, 0.0), (width, 0.0), (0.0, height), (width, height),
    ]
    max_scale = 1.0
    for px, py in samples:
        dx, dy = px - cx, py - cy
        ru = np.sqrt(dx * dx + dy * dy)
        if ru < 1e-6:
            continue
        mdx, mdy = dx, dy
        if has_lens:
            ru_norm = ru / half_diag
            rd_norm = _distort_radius_norm(ru_norm, p)
            eff = ru_norm + (rd_norm - ru_norm) * lens_amt
            s = eff / ru_norm
            mdx *= s
            mdy *= s
        if abs(k_distortion) > 1e-5:
            r2n = (mdx * mdx + mdy * mdy) * max_radius_sq_inv
            f = 1.0 + k_distortion * r2n
            mdx *= f
            mdy *= f
        s = np.sqrt(mdx * mdx + mdy * mdy) / ru
        max_scale = max(max_scale, s)
    return float(max_scale * 1.002) if max_scale > 1.0 else float(max_scale)


def _auto_crop(p: GeometryParams, w: int, h: int) -> float:
    k_distortion = (p.distortion / 100.0) * 2.5
    if _has_lens(p) or abs(k_distortion) > 1e-5:
        return compute_lens_auto_crop_scale(p, float(w), float(h))
    return 1.0


def _bilinear_zero_outside(plane: torch.Tensor, xq, yq, w: int, h: int) -> torch.Tensor:
    """Plain-path sampling of (..., H, W): black outside [0, W-1) x [0, H-1)."""
    valid = (
        (xq >= 0.0) & (yq >= 0.0) & (xq < w - 1.0) & (yq < h - 1.0)
        & torch.isfinite(xq) & torch.isfinite(yq)
    )
    xs = torch.where(valid, xq, 0.0)
    ysv = torch.where(valid, yq, 0.0)
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ysv).to(torch.int64)
    wx = xs - x0
    wy = ysv - y0
    x0 = torch.clamp(x0, 0, w - 2)
    y0 = torch.clamp(y0, 0, h - 2)
    top, bot = _corners(plane, x0, y0, wx, w)
    return torch.where(valid, top * (1 - wy) + bot * wy, 0.0)


def _bilinear_clamped(plane: torch.Tensor, xq, yq, w: int, h: int) -> torch.Tensor:
    """TCA-path sampling: clamped to the borders (:488-527)."""
    xc = torch.clamp(torch.nan_to_num(xq), 0.0, w - 1.0)
    yc = torch.clamp(torch.nan_to_num(yq), 0.0, h - 1.0)
    x0 = torch.clamp(torch.clamp_max(torch.floor(xc).to(torch.int64), w - 2), min=0)
    y0 = torch.clamp(torch.clamp_max(torch.floor(yc).to(torch.int64), h - 2), min=0)
    wx = xc - x0
    wy = yc - y0
    top, bot = _corners(plane, x0, y0, wx, w)
    return top * (1 - wy) + bot * wy


def _corners(plane, x0, y0, wx, w):
    flat = plane.reshape(*plane.shape[:-2], -1)

    def g(yy, xx):
        return flat[..., (yy * w + xx).reshape(-1)].reshape(*plane.shape[:-2], *xx.shape)

    top = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
    bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
    return top, bot


def geometry_values(p: GeometryParams, h: int, w: int) -> dict:
    """Scalar bundle for `source_coords_values`: inverse homography,
    auto-crop and the effective distortion/TCA coefficients, float32."""
    has_lens = _has_lens(p)
    k_distortion = (p.distortion / 100.0) * 2.5
    vr, vb = _tca_scales(p)
    return {
        "inv": _inverse(p, w, h).astype(np.float32),
        "auto_crop": np.float32(_auto_crop(p, w, h)),
        "lens_amt": np.float32(p.lens_distortion_amount * 2.5 if has_lens else 0.0),
        "k1": np.float32(p.lens_dist_k1 if has_lens else 0.0),
        "k2": np.float32(p.lens_dist_k2 if has_lens else 0.0),
        "k3": np.float32(p.lens_dist_k3 if has_lens else 0.0),
        "k_distortion": np.float32(k_distortion if abs(k_distortion) > 1e-5 else 0.0),
        "vr": np.float32(vr if p.lens_tca_enabled else 1.0),
        "vb": np.float32(vb if p.lens_tca_enabled else 1.0),
    }


def source_coords_values(vals: dict, h: int, w: int, xs: torch.Tensor, ys: torch.Tensor,
                         lens_model: int):
    """source_coords_at driven by `geometry_values`, every stage applied
    with neutral coefficients when inactive (k = 0 gives a scale of exactly
    1, auto_crop is held >= 1): the planner's form of the map."""
    cx, cy = w / 2.0, h / 2.0
    half_diag = float(np.sqrt(cx * cx + cy * cy))
    max_radius_sq_inv = 1.0 / (cx * cx + cy * cy)
    inv = [[float(v) for v in row] for row in vals["inv"]]

    hx = inv[0][0] * xs + inv[0][1] * ys + inv[0][2]
    hy = inv[1][0] * xs + inv[1][1] * ys + inv[1][2]
    hz = inv[2][0] * xs + inv[2][1] * ys + inv[2][2]
    z_ok = torch.abs(hz) > 1e-6
    inv_z = 1.0 / torch.where(z_ok, hz, 1.0)
    src_x = hx * inv_z
    src_y = hy * inv_z

    ac = float(vals["auto_crop"]) if float(vals["auto_crop"]) > 1.0 else 1.0
    src_x = cx + true_div(src_x - cx, ac)
    src_y = cy + true_div(src_y - cy, ac)

    dx = src_x - cx
    dy = src_y - cy
    ru = sqrt_rn(dx * dx + dy * dy)
    ru_norm = true_div(ru, half_diag)
    r2 = ru_norm * ru_norm
    k1, k2, k3 = float(vals["k1"]), float(vals["k2"]), float(vals["k3"])
    if lens_model == 1:
        # d = 1 - a - b - c in float32, as the traced JAX scalars compute it
        d = float(np.float32(np.float32(np.float32(1.0) - vals["k1"]) - vals["k2"]) - vals["k3"])
        rd_norm = ru_norm * (k1 * r2 * ru_norm + k2 * r2 + k3 * ru_norm + d)
    else:
        rd_norm = ru_norm * (1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2)
    safe_ru = torch.where(ru_norm > 1e-9, ru_norm, 1.0)
    eff = ru_norm + (rd_norm - ru_norm) * float(vals["lens_amt"])
    s = eff / safe_ru
    apply = ru > 1e-6
    src_x = torch.where(apply, cx + dx * s, src_x)
    src_y = torch.where(apply, cy + dy * s, src_y)

    dx = src_x - cx
    dy = src_y - cy
    r2n = (dx * dx + dy * dy) * max_radius_sq_inv
    f = 1.0 + float(vals["k_distortion"]) * r2n
    src_x = cx + dx * f
    src_y = cy + dy * f
    return src_x, src_y, z_ok


def source_coords(p: GeometryParams, h: int, w: int, device):
    """Inverse-map source coordinates for every output pixel:
    (src_x, src_y, z_ok, meta), meta carrying the TCA/vignette flags."""
    xs, ys = coord_maps(h, w, device)
    return source_coords_at(p, h, w, xs, ys)


def source_coords_at(p: GeometryParams, h: int, w: int, xs: torch.Tensor, ys: torch.Tensor):
    """source_coords at arbitrary (fractional) output coordinates."""
    cx, cy = w / 2.0, h / 2.0
    inv = [[float(v) for v in row] for row in _inverse(p, w, h)]
    half_diag = float(np.sqrt((w / 2.0) ** 2 + (h / 2.0) ** 2))
    max_radius_sq_inv = 1.0 / (cx * cx + cy * cy)

    k_distortion = (p.distortion / 100.0) * 2.5
    lens_amt = p.lens_distortion_amount * 2.5
    has_lens = _has_lens(p)
    auto_crop = _auto_crop(p, w, h)
    vr, vb = _tca_scales(p)
    has_tca = p.lens_tca_enabled and (abs(vr - 1.0) > 1e-5 or abs(vb - 1.0) > 1e-5)
    lens_vig_amt = p.lens_vignette_amount * 0.8
    has_vig = p.lens_vignette_enabled and (
        abs(p.vig_k1) > 1e-6 or abs(p.vig_k2) > 1e-6 or abs(p.vig_k3) > 1e-6
    ) and lens_vig_amt > 0.01

    hx = inv[0][0] * xs + inv[0][1] * ys + inv[0][2]
    hy = inv[1][0] * xs + inv[1][1] * ys + inv[1][2]
    hz = inv[2][0] * xs + inv[2][1] * ys + inv[2][2]
    z_ok = torch.abs(hz) > 1e-6
    inv_z = 1.0 / torch.where(z_ok, hz, 1.0)
    src_x = hx * inv_z
    src_y = hy * inv_z

    if auto_crop > 1.0:
        src_x = cx + true_div(src_x - cx, auto_crop)
        src_y = cy + true_div(src_y - cy, auto_crop)

    if has_lens:
        dx = src_x - cx
        dy = src_y - cy
        ru = sqrt_rn(dx * dx + dy * dy)
        ru_norm = true_div(ru, half_diag)
        rd_norm = _distort_radius_norm(ru_norm, p)
        safe_ru = torch.where(ru_norm > 1e-9, ru_norm, 1.0)
        eff = ru_norm + (rd_norm - ru_norm) * lens_amt
        s = eff / safe_ru
        apply = ru > 1e-6
        src_x = torch.where(apply, cx + dx * s, src_x)
        src_y = torch.where(apply, cy + dy * s, src_y)

    if abs(k_distortion) > 1e-5:
        dx = src_x - cx
        dy = src_y - cy
        r2n = (dx * dx + dy * dy) * max_radius_sq_inv
        f = 1.0 + k_distortion * r2n
        src_x = cx + dx * f
        src_y = cy + dy * f

    meta = {
        "has_tca": has_tca, "vr": vr, "vb": vb,
        "has_vig": has_vig, "lens_vig_amt": lens_vig_amt,
        "half_diag": half_diag, "cx": cx, "cy": cy,
    }
    return src_x, src_y, z_ok, meta


def apply_lens_vignette(out, src_x, src_y, p: GeometryParams, meta):
    """Lens vignetting polynomial gain at the source coords (:775-795)."""
    dx = src_x - meta["cx"]
    dy = src_y - meta["cy"]
    ru_norm2 = true_div(dx * dx + dy * dy, meta["half_diag"] * meta["half_diag"])
    v = 1.0 + p.vig_k1 * ru_norm2 + p.vig_k2 * ru_norm2**2 + p.vig_k3 * ru_norm2**3
    gain = 1.0 + (1.0 / torch.where(v > 1e-6, v, 1.0) - 1.0) * meta["lens_vig_amt"]
    return out * torch.where(v > 1e-6, gain, 1.0)


def warp_image_geometry(image: torch.Tensor, p: GeometryParams) -> torch.Tensor:
    """Warp planar (..., 3, H, W) by GeometryParams. Same-size output."""
    h, w = image.shape[-2:]
    cx, cy = w / 2.0, h / 2.0
    src_x, src_y, z_ok, meta = source_coords(p, h, w, image.device)
    planes = [image[..., c, :, :] for c in range(3)]
    if meta["has_tca"]:
        vr, vb = meta["vr"], meta["vb"]
        rx = cx + (src_x - cx) * vr
        ry = cy + (src_y - cy) * vr
        bx = cx + (src_x - cx) * vb
        by = cy + (src_y - cy) * vb
        out = torch.stack(
            [
                _bilinear_clamped(planes[0], rx, ry, w, h),
                _bilinear_clamped(planes[1], src_x, src_y, w, h),
                _bilinear_clamped(planes[2], bx, by, w, h),
            ], dim=-3,
        )
    else:
        out = torch.stack([_bilinear_zero_outside(f, src_x, src_y, w, h) for f in planes], dim=-3)

    if meta["has_vig"]:
        out = apply_lens_vignette(out, src_x, src_y, p, meta)

    # pixels whose homography z ~ 0 stay black (:718)
    return torch.where(z_ok, out, 0.0)


def unwarp_image_geometry(image: torch.Tensor, p: GeometryParams) -> torch.Tensor:
    """Exact inverse of warp_image_geometry (image_processing.rs:805-938):
    undoes the manual distortion (Newton on k r^3 + r = r_target, 10
    steps), the lensfun distortion (8 Newton steps on the blended radius),
    the auto-crop and the forward homography, in JAX's float32 op order on
    the image's device."""
    h, w = image.shape[-2:]
    cx, cy = w / 2.0, h / 2.0
    fwd = [[float(v) for v in row] for row in build_transform_matrix(p, float(w), float(h))]
    half_diag = float(np.sqrt(cx * cx + cy * cy))
    max_radius_sq_inv = 1.0 / (cx * cx + cy * cy)
    k_distortion = (p.distortion / 100.0) * 2.5
    lens_amt = p.lens_distortion_amount * 2.5
    has_lens = p.lens_distortion_enabled and (
        abs(p.lens_dist_k1) > 1e-6 or abs(p.lens_dist_k2) > 1e-6 or abs(p.lens_dist_k3) > 1e-6
    )
    auto_crop = (compute_lens_auto_crop_scale(p, float(w), float(h))
                 if (has_lens or abs(k_distortion) > 1e-5) else 1.0)
    cur_x, cur_y = coord_maps(h, w, image.device)

    if abs(k_distortion) > 1e-5:
        dx = cur_x - cx
        dy = cur_y - cy
        r_dist = sqrt_rn(dx * dx + dy * dy)
        k_eff = k_distortion * max_radius_sq_inv
        r = r_dist
        for _ in range(10):
            val = k_eff * r**3 + r - r_dist
            slope = 3.0 * k_eff * r * r + 1.0
            r = r - torch.where(torch.abs(slope) > 1e-9, val / slope, 0.0)
        apply = r_dist > 1e-6
        s = r / torch.where(apply, r_dist, 1.0)
        cur_x = torch.where(apply, cx + dx * s, cur_x)
        cur_y = torch.where(apply, cy + dy * s, cur_y)

    if has_lens:
        dx = cur_x - cx
        dy = cur_y - cy
        rd = sqrt_rn(dx * dx + dy * dy)
        ru = rd
        k1, k2, k3 = p.lens_dist_k1, p.lens_dist_k2, p.lens_dist_k3
        for _ in range(8):
            ru_n = true_div(ru, half_diag)
            ru_n2 = ru_n * ru_n
            if p.lens_model == 1:
                a, b, c = k1, k2, k3
                d = 1.0 - a - b - c
                poly = a * ru_n2 * ru_n + b * ru_n2 + c * ru_n + d
                f_val = ru * poly
                f_prime = 4.0 * a * ru_n2 * ru_n + 3.0 * b * ru_n2 + 2.0 * c * ru_n + d
            else:
                poly = 1.0 + k1 * ru_n2 + k2 * ru_n2**2 + k3 * ru_n2**3
                f_val = ru * poly
                poly_prime = (2.0 * k1 * ru_n + 4.0 * k2 * ru_n2 * ru_n
                              + 6.0 * k3 * ru_n2**2 * ru_n)
                f_prime = poly + ru_n * poly_prime
            g_val = ru + (f_val - ru) * lens_amt - rd
            g_prime = 1.0 + (f_prime - 1.0) * lens_amt
            ru = ru - torch.where(torch.abs(g_prime) > 1e-7, g_val / g_prime, 0.0)
        apply = rd > 1e-6
        s = ru / torch.where(apply, rd, 1.0)
        cur_x = torch.where(apply, cx + dx * s, cur_x)
        cur_y = torch.where(apply, cy + dy * s, cur_y)

    if auto_crop > 1.0:
        cur_x = cx + (cur_x - cx) * auto_crop
        cur_y = cy + (cur_y - cy) * auto_crop

    hx = fwd[0][0] * cur_x + fwd[0][1] * cur_y + fwd[0][2]
    hy = fwd[1][0] * cur_x + fwd[1][1] * cur_y + fwd[1][2]
    hz = fwd[2][0] * cur_x + fwd[2][1] * cur_y + fwd[2][2]
    z_ok = torch.abs(hz) > 1e-6
    inv_z = 1.0 / torch.where(z_ok, hz, 1.0)
    src_x = hx * inv_z
    src_y = hy * inv_z
    planes = [image[..., c, :, :] for c in range(3)]
    out = torch.stack([_bilinear_zero_outside(f, src_x, src_y, w, h) for f in planes], dim=-3)
    return torch.where(z_ok, out, 0.0)
