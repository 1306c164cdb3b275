// The develop grade chain as one per-pixel CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU megakernel B3 (rapidraw_tpu/pipeline/fused.py
// `develop_fused`, body `_make_dev_kernel`) and its batched form B4
// (`develop_fused_batch`): grade_chain + finish_chain of
// rapidraw_tpu/pipeline/grade.py, local masks, lens flare and the 3D LUT
// included (CA and NR run before it). Every device function
// below transcribes the plain PyTorch op of the same name in
// rapidraw_tpu_torch/ops (itself a port of the JAX op) in the same
// operation order; the file is built with --fmad=false so each product and
// sum rounds on its own, as the plain chain does.
//
// Inputs: the image (B, 3, H, W) and up to four blur levels (B, 3, H, W),
// all in input space (sRGB for LDR, linear for RAW) — both are linearized
// here, in registers, as the TPU kernel does in VMEM (fused.py:243), except
// an image that NR already made linear (flag bit F_IMAGE_LINEAR); a
// (B, K) f32 param matrix whose offsets come from the generated
// grade_gen.h (pipeline/fused.py LAYOUT). DevelopConfig arrives as a
// warp-uniform runtime bitmask plus curve_segments and the HSL band mask:
// the reference shader gates stages the same way (`if (param != 0)`), every
// gated stage is an exact identity when skipped, and one build serves
// every document.
//
// What bounds it on the card: instruction issue. At 24 MP each pixel reads
// 3 + 3*levels floats and writes 3, but the chain runs ~1,300 float32
// operations per pixel (config 3), many of them accurate log2/exp2, IEEE
// divides and square roots that expand to tens of instructions (a log2f is
// a ~25-instruction polynomial), each multiply and add issued alone (no
// contraction). A one-thread-per-pixel kernel of this chain needs only 40
// registers (PERF.md), so the design cuts instructions and keeps registers
// low rather than raising occupancy:
// - a block of 32 x 8 threads owns a tile of 32 columns and 8 * rows rows;
//   a thread computes `rows` pixels of one column, 8 rows apart (a warp is
//   32 neighbouring columns: coalesced), the batch on the grid's z axis
//   (one launch for any B); the block's threads meet at a barrier before
//   each row step, so its warps run the long chain in step;
// - once per block, before the pixels, the block stages its image's (K,)
//   param row in shared memory (read there per pixel, so the compiler does
//   not hoist the whole row into registers) and computes there every value
//   that does not depend on the pixel (the exposure gain, the shadow and
//   contrast factors, the highlight gains, the white-balance multipliers,
//   ...: `Uniforms`) and every term that depends on x alone or y alone (the
//   vignette's sgn(u) |u|^round per column and per row, the centre mask's
//   coordinates), with the same device functions, so each such value is
//   bit for bit what the per-pixel expression gave;
// - the hue wrap `fmodf(h, 360)` takes exact subtractions on [0, 1080)
//   (`mod360`);
// - two register budgets: a long chain (many stages on) takes the build
//   for 4 blocks per SM (up to 64 registers), a short one the build for 6
//   (40 registers, more warps to cover memory latency).
// Every expression keeps the plain chain's operation order, so the kernel
// stays bit-identical to `grade_plain` on the card.
//
// Local masks take their own builds (`MASKS`), so a document without masks
// runs the code above unchanged. With masks the kernel also reads the
// (B, N, H, W) influences, gated on load as JAX gates them (x > 0.001, else
// 0), a (B, N, M_K) mask-param tensor (offsets M_* in grade_gen.h,
// pipeline/fused.py MASK_LAYOUT) and, per field of EFF_FIELDS, the set of
// masks that blends it (`MaskBlend`, one bit per mask). A blended field's
// value is a per-pixel sum, global + influence_n * mask_n in ascending mask
// order, and every value derived from it (its `Uniforms` entries) is
// computed per pixel by the same device function; fields no mask blends
// keep the block's hoisted values. Each block stages its masks' leading
// M_SCALARS params (the blended fields, sharpness and the colour-grading
// blend and balance) in dynamic shared memory; the rarely read HSL, colour
// grading and curve rows are read from global memory, where every thread
// of a block reads the same address. The mask stages (sharpness delta,
// HSL, colour grading, curves) skip a mask whose influence is 0 at the
// pixel: its terms there are exact zeros for finite values.
//
// Lens flare: the TPU kernel streams a (3, H, W) flare tile that XLA
// sampled from the 512^2 map beforehand (302 MB per 24 MP image). Here each
// pixel samples its image's (512, 512, 3) map itself (bilinear at
// u = x / W, v = y / H, true divisions; indices clamped, uv not), times 1.4,
// squared (JAX develop.py:36-67, :207-217): the 3 MB map stays in L2 and no
// full-size flare tensor exists. The 3D LUT: the TPU kernel stops after the
// curves when a document has one and leaves the LUT, grain and dither to
// XLA, because a gather is slow in Pallas there; on this card the stage
// stays in the kernel, after the curves and before grain, which saves a
// full-size f32 round trip. It fetches only the selected tetrahedron's four
// corners from the (L, L, L, 3) cube (L <= 65, <= 3.3 MB, read through the
// read-only cache) and blends them in the plain version's order, so its
// result is the `where`-selected one bit for bit.
//
// Tile placement: a batch may be one tile of a larger image (the tiled
// develop, pipeline/tiled.py). Its origin (x_off, y_off) and the full
// image's size arrive as arguments, and every coordinate the spatial stages
// read is absolute: the vignette's and the centre mask's tables, grain,
// dither and the flare sample, each from (float)(x + x_off) as JAX builds
// arange(w) + x_off in float32 (exact below 2^24) and divided by the full
// size (JAX fused.py:224-256, :320-325). A whole image is the tile at
// (0, 0) of its own size, which computes what it did before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grade_gen.h"

// Per field of EFF_FIELDS (the M_* offsets below M_BLEND), bit n is set when
// mask n blends the field; passed by value, so every thread reads it from
// the kernel's parameter space.
struct MaskBlend {
  unsigned bits[M_BLEND];
};

namespace {

// A Python float constant as the plain chain sees it: the exact double,
// rounded once to f32.
#define FC(x) ((float)(x))

constexpr int BX = 32;        // threads (and tile columns) across
constexpr int BY = 8;         // thread rows; a tile is BY * rows rows tall
constexpr int MAX_ROWS = 16;  // rows per thread the row tables hold
constexpr int MAX_TILE_H = BY * MAX_ROWS;


struct F3 {
  float r, g, b;
};

__device__ __forceinline__ F3 f3(float r, float g, float b) { return {r, g, b}; }
__device__ __forceinline__ F3 splat(float v) { return {v, v, v}; }
__device__ __forceinline__ F3 add(F3 a, F3 b) { return {a.r + b.r, a.g + b.g, a.b + b.b}; }
__device__ __forceinline__ F3 sub(F3 a, F3 b) { return {a.r - b.r, a.g - b.g, a.b - b.b}; }
__device__ __forceinline__ F3 mul(F3 a, F3 b) { return {a.r * b.r, a.g * b.g, a.b * b.b}; }
__device__ __forceinline__ F3 divv(F3 a, float s) { return {a.r / s, a.g / s, a.b / s}; }
__device__ __forceinline__ F3 divv(F3 a, F3 s) { return {a.r / s.r, a.g / s.g, a.b / s.b}; }
__device__ __forceinline__ F3 scl(F3 a, float s) { return {a.r * s, a.g * s, a.b * s}; }
__device__ __forceinline__ F3 addc(F3 a, float s) { return {a.r + s, a.g + s, a.b + s}; }
__device__ __forceinline__ F3 max0(F3 a) {
  return {fmaxf(a.r, 0.0f), fmaxf(a.g, 0.0f), fmaxf(a.b, 0.0f)};
}
__device__ __forceinline__ float max3(F3 a) { return fmaxf(a.r, fmaxf(a.g, a.b)); }
__device__ __forceinline__ float min3(F3 a) { return fminf(a.r, fminf(a.g, a.b)); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float fract(float x) { return x - floorf(x); }
// x divided by a constant that the plain chain holds as a Python scalar.
// PyTorch's CUDA division by a CPU scalar multiplies by the reciprocal
// taken in double and rounded to f32 (measured bit-exact on the H100), so
// the kernel does the same and the on-card comparison is like for like; on
// the CPU both PyTorch and JAX divide, which differs by at most 1 ulp.
// The runtime divisors (W, H, the resolution scale) arrive as reciprocals
// taken the same way on the host.
#define divs(x, c) ((x) * (float)(1.0 / (c)))

// The values of one image that do not depend on the pixel, computed once
// per block (`uniforms`) by the same expressions the per-pixel chain used.
struct Uniforms {
  float exp_gain;          // exp2f(exposure)
  float br_scale, br_k;    // filmic_exposure's gains at the document's brightness
  float w_mult;            // the white gain 1 / max(1 - whites / 4, 0.01)
  float con_strength;      // exp2f(contrast * 1.25)
  float sh_factor, bl_factor;  // the shadow and black lifts of shadow_mult
  float hl_gamma, hl_cstr, hl_gain;  // highlights' gamma, compression, gain
  float wb_r, wb_g, wb_b;  // white-balance multipliers
  float v_e0, v_e1;        // the vignette's smoothstep edges
  float grain_freq;        // grain's base frequency
};

// The derived values of `Uniforms` as functions of their field, shared by
// the per-block `uniforms` and the mask build's per-pixel values.
__device__ __forceinline__ float w_mult_of(float whites) {
  const float white_level = 1.0f - whites * FC(0.25);
  return 1.0f / fmaxf(white_level, FC(0.01));
}
__device__ __forceinline__ float con_strength_of(float contrast) {
  return exp2f(contrast * FC(1.25));
}
__device__ __forceinline__ float bl_factor_of(float blacks) {
  return fminf(exp2f(blacks * FC(0.75)), FC(3.9));
}
__device__ __forceinline__ float sh_factor_of(float shadows) {
  return fminf(exp2f(shadows * FC(1.5)), FC(3.9));
}
__device__ __forceinline__ void hl_gains(float h, float& gamma, float& cstr, float& gain) {
  gamma = 1.0f - h * FC(1.75);
  cstr = -h * FC(6.0);
  gain = exp2f(h * FC(1.75));
}
__device__ __forceinline__ void wb_gains(float t, float n, float& r, float& g, float& b) {
  r = (1.0f + t * FC(0.2)) * (1.0f + n * FC(0.25));
  g = (1.0f + t * FC(0.05)) * (1.0f - n * FC(0.25));
  b = (1.0f - t * FC(0.2)) * (1.0f + n * FC(0.25));
}

// ---- ops/common.py --------------------------------------------------------

__device__ __forceinline__ float luma(F3 c) {
  return c.r * FC(0.2126) + c.g * FC(0.7152) + c.b * FC(0.0722);
}
__device__ __forceinline__ float mix(float a, float b, float t) {
  return a * (1.0f - t) + b * t;
}
__device__ __forceinline__ F3 mix3(F3 a, F3 b, float t) {
  return {mix(a.r, b.r, t), mix(a.g, b.g, t), mix(a.b, b.b, t)};
}
// smoothstep with static edges: the reciprocal folds on the host side in
// the plain chain, so it is the double 1/(e1-e0) rounded once
__device__ __forceinline__ float ss(double e0, double e1, float x) {
  const float inv = (float)(1.0 / (e1 - e0));
  const float t = clampf((x - (float)e0) * inv, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}
// smoothstep with runtime edges (step fallback when e0 == e1)
__device__ __forceinline__ float ssd(float e0, float e1, float x) {
  float d = e1 - e0;
  d = d == 0.0f ? FC(1e-20) : d;
  const float t = clampf((x - e0) / d, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}
__device__ __forceinline__ float fpow(float x, float y) {
  const float safe = fmaxf(x, FC(1e-37));
  float l = log2f(safe);
  const float e = exp2f(l);
  l = l + (safe - e) / (e * FC(0.6931471805599453));
  return exp2f(y * l);
}
__device__ __forceinline__ float fpow_lt1(float x, float y) {
  return exp2f(y * log2f(fmaxf(x, FC(1e-37))));
}
// x^2.4 and x^2.2 as fpow_static: x^frac * x * x
__device__ __forceinline__ float pow_2p4(float x) {
  float acc = fpow_lt1(x, FC(2.4 - 2.0));
  acc = acc * x;
  return acc * x;
}
__device__ __forceinline__ float pow_2p2(float x) {
  float acc = fpow_lt1(x, FC(2.2 - 2.0));
  acc = acc * x;
  return acc * x;
}

// ---- ops/colorspace.py ----------------------------------------------------

__device__ __forceinline__ float srgb_to_linear(float c) {
  const float higher = pow_2p4(divs(fabsf(c + FC(0.055)), 1.055));
  const float lower = divs(c, 12.92);
  return c <= FC(0.04045) ? lower : higher;
}
__device__ __forceinline__ F3 srgb_to_linear3(F3 c) {
  return {srgb_to_linear(c.r), srgb_to_linear(c.g), srgb_to_linear(c.b)};
}
__device__ __forceinline__ float linear_to_srgb(float c) {
  c = clampf(c, 0.0f, 1.0f);
  const float higher = FC(1.055) * fpow_lt1(c, FC(1.0 / 2.4)) - FC(0.055);
  const float lower = c * FC(12.92);
  return c <= FC(0.0031308) ? lower : higher;
}
__device__ __forceinline__ float linear_to_srgb_ext(float c) {
  c = fmaxf(c, 0.0f);
  const float higher = FC(1.055) * fpow_lt1(c, FC(1.0 / 2.4)) - FC(0.055);
  const float lower = c * FC(12.92);
  return c <= FC(0.0031308) ? lower : higher;
}

__device__ __forceinline__ void rgb_to_hsv(F3 c, float& h, float& s, float& v) {
  const float c_max = fmaxf(c.r, fmaxf(c.g, c.b));
  const float c_min = fminf(c.r, fminf(c.g, c.b));
  const float delta = c_max - c_min;
  const float safe_delta = delta > 0.0f ? delta : 1.0f;
  const float inv_delta = 1.0f / safe_delta;
  const float h_r = 60.0f * ((c.g - c.b) * inv_delta);
  const float h_g = 60.0f * ((c.b - c.r) * inv_delta + 2.0f);
  const float h_b = 60.0f * ((c.r - c.g) * inv_delta + 4.0f);
  float hh = c_max == c.r ? h_r : (c_max == c.g ? h_g : h_b);
  hh = delta > 0.0f ? hh : 0.0f;
  h = hh < 0.0f ? hh + 360.0f : hh;
  s = c_max > 0.0f ? delta / c_max : 0.0f;
  v = c_max;
}

__device__ __forceinline__ F3 hsv_to_rgb(float h, float s, float v) {
  const float c = v * s;
  const float u = h * FC(1.0 / 60.0);
  const float x = c * (1.0f - fabsf(u - 2.0f * floorf(u * 0.5f) - 1.0f));
  const float z = 0.0f;
  F3 p;
  if (h < 60.0f) p = f3(c, x, z);
  else if (h >= 60.0f && h < 120.0f) p = f3(x, c, z);
  else if (h >= 120.0f && h < 180.0f) p = f3(z, c, x);
  else if (h >= 180.0f && h < 240.0f) p = f3(z, x, c);
  else if (h >= 240.0f && h < 300.0f) p = f3(x, z, c);
  else p = f3(c, z, x);
  const float m = v - c;
  return addc(p, m);
}

// ---- ops/tone.py ----------------------------------------------------------

// gain = exp2f(e), taken once per block (Uniforms)
__device__ __forceinline__ F3 linear_exposure(F3 c, float e, float gain) {
  return e == 0.0f ? c : scl(c, gain);
}

// the two gains of filmic_exposure that depend on br alone
__device__ __forceinline__ void filmic_gains(float br, float& scale, float& k) {
  const float direct_adj = br * FC(1.0 - 0.95);
  const float rational_adj = br * FC(0.95);
  scale = exp2f(direct_adj);
  k = exp2f(-rational_adj * FC(1.2));
}

__device__ F3 filmic_exposure(F3 c, float br, float scale, float k) {
  const float ol = luma(c);
  const float la = fabsf(ol);
  const float lf = floorf(divs(la, 1.06)) * FC(1.06);
  const float ln = divs(la - lf, 1.06);
  const float sn = ln / (ln + (1.0f - ln) * k);
  const float sla = lf + sn * FC(1.06);
  const float nl = sgnf(ol) * sla * scale;
  const F3 chroma = addc(c, -ol);
  const float safe_orig = fabsf(ol) < FC(1e-20) ? 1.0f : ol;
  const float tls = nl / safe_orig;
  const float lw = clampf(nl, 0.0f, 2.0f) * 0.5f;
  const float dyn = mix(FC(0.95), FC(0.65), lw);
  const float bcs = fpow_lt1(fmaxf(tls, 0.0f), dyn);
  const float hr = 1.0f / (1.0f + fmaxf(nl - FC(0.9), 0.0f) * 2.0f);
  const float cs = bcs * hr;
  const F3 out = addc(scl(chroma, cs), nl);
  const bool skip = br == 0.0f || fabsf(ol) < FC(0.00001);
  return skip ? c : out;
}

// bl_factor = fminf(exp2f(bl * 0.75), 3.9), sh_factor = fminf(exp2f(sh *
// 1.5), 3.9), taken once per block
__device__ __forceinline__ float shadow_mult(float l, float sh, float bl, float bl_factor,
                                             float sh_factor) {
  const float sl = fmaxf(l, FC(0.0001));
  float mult = 1.0f;
  float x = divs(sl, 0.05);
  float m = (1.0f - x) * (1.0f - x);
  const float bl_mult = mix(1.0f, bl_factor, m);
  mult = mult * ((bl != 0.0f && sl < FC(0.05)) ? bl_mult : 1.0f);
  x = divs(sl, 0.1);
  m = (1.0f - x) * (1.0f - x);
  const float sh_mult = mix(1.0f, sh_factor, m);
  mult = mult * ((sh != 0.0f && sl < FC(0.1)) ? sh_mult : 1.0f);
  return mult;
}

__device__ __forceinline__ float contrast_channel(float c, float strength) {
  const float safe = fmaxf(c, 0.0f);
  const float perceptual = fpow_lt1(safe, FC(1.0 / 2.2));
  const float cp = clampf(perceptual, 0.0f, 1.0f);
  const bool lo = cp < 0.5f;
  const float base = lo ? 2.0f * cp : 2.0f * (1.0f - cp);
  const float powed = 0.5f * fpow(base, strength);
  const float curved = lo ? powed : 1.0f - powed;
  const float adjusted = pow_2p2(curved);
  const float mf = ss(1.0, 1.01, safe);
  return mix(adjusted, c, mf);
}

__device__ F3 tonal_adjustments(F3 c, F3 blur, bool shadow_path, float con, float sh,
                                float wh, float bl, const Uniforms& u) {
  const bool w_on = wh != 0.0f;
  if (w_on) c = scl(c, u.w_mult);
  if (shadow_path) {
    if (w_on) blur = scl(blur, u.w_mult);
    const float spl = fmaxf(luma(max0(c)), FC(0.0001));
    const float sbl = fmaxf(luma(max0(blur)), FC(0.0001));
    const float halo = ss(0.05, 0.25, fabsf(sqrtf(spl) - sqrtf(sbl)));
    const float spatial = shadow_mult(sbl, sh, bl, u.bl_factor, u.sh_factor);
    const float pixel = shadow_mult(spl, sh, bl, u.bl_factor, u.sh_factor);
    const float fm = mix(spatial, pixel, halo);
    if (sh != 0.0f || bl != 0.0f) c = scl(c, fm);
  }
  if (con != 0.0f) {
    const float strength = u.con_strength;
    c = f3(contrast_channel(c.r, strength), contrast_channel(c.g, strength),
           contrast_channel(c.b, strength));
  }
  return c;
}

__device__ F3 highlights(F3 c, float h, const Uniforms& u) {
  const float pl = luma(max0(c));
  const float spl = fmaxf(pl, FC(0.0001));
  const float hm = ss(0.3, 0.95, tanhf(spl * FC(1.5)));
  if (h == 0.0f || hm < FC(0.001)) return c;
  F3 adjusted;
  if (h < 0.0f) {
    const float l = pl;
    const float nll = fpow(fmaxf(l, 0.0f), u.hl_gamma);
    const float le = l - 1.0f;
    const float ce = le / (1.0f + fmaxf(le, 0.0f) * u.hl_cstr);
    const float nlh = 1.0f + ce;
    const float nl = l <= 1.0f ? nll : nlh;
    const F3 ta = scl(c, nl / fmaxf(l, FC(0.0001)));
    const float desat = ss(1.0, 10.0, l);
    adjusted = mix3(ta, splat(nl), desat);
  } else {
    adjusted = scl(c, u.hl_gain);
  }
  return mix3(c, adjusted, hm);
}

__device__ __forceinline__ float horner(float u, const float* coef) {
  float acc = coef[AGX_NCOEF - 1];
#pragma unroll
  for (int i = AGX_NCOEF - 2; i >= 0; --i) acc = acc * u + coef[i];
  return acc;
}

__device__ __forceinline__ float agx_curve(float x) {
  float r;
  if (x < AGX_TX) {
    r = horner((clampf(x, AGX_M0, AGX_TX) - AGX_T_MID) * AGX_T_INV_HALF, AGX_TOE_COEF);
  } else {
    r = horner((clampf(x, AGX_TX, AGX_M1) - AGX_S_MID) * AGX_S_INV_HALF, AGX_SHOULDER_COEF);
  }
  return clampf(r, 0.0f, 1.0f);
}

__device__ __forceinline__ F3 mat3(const float* m, F3 c) {
  return {m[0] * c.r + m[1] * c.g + m[2] * c.b, m[3] * c.r + m[4] * c.g + m[5] * c.b,
          m[6] * c.r + m[7] * c.g + m[8] * c.b};
}

__device__ __forceinline__ float agx_channel(float v) {
  const float x_rel = fmaxf(divs(v, 0.18), AGX_EPSILON);
  const float le = divs(log2f(x_rel) - AGX_MIN_EV, AGX_RANGE_EV);
  const float curved = agx_curve(clampf(le, 0.0f, 1.0f));
  return pow_2p4(fmaxf(curved, 0.0f));
}

__device__ F3 agx_tonemap(F3 c, const float* p2r, const float* r2p) {
  const float min_c = min3(c);
  const F3 comp = min_c < 0.0f ? addc(c, -min_c) : c;
  const F3 in = mat3(p2r, comp);
  return mat3(r2p, f3(agx_channel(in.r), agx_channel(in.g), agx_channel(in.b)));
}

__device__ __forceinline__ float raw_emulation(float c) {
  float s = linear_to_srgb(c);
  s = fpow_lt1(fmaxf(s, 0.0f), FC(1.0 / 1.1));
  const float cc = s * s * (3.0f - 2.0f * s);
  return mix(s, cc, 0.75f);
}

// ---- ops/color.py ---------------------------------------------------------

__device__ __forceinline__ F3 white_balance(F3 c, const Uniforms& u) {
  return {c.r * u.wb_r, c.g * u.wb_g, c.b * u.wb_b};
}

__device__ F3 creative_color(F3 c, float sat, float vib) {
  const float l = luma(c);
  const F3 processed = sat != 0.0f ? mix3(splat(l), c, 1.0f + sat) : c;
  const float c_max = max3(processed);
  const float c_min = min3(processed);
  const float delta = c_max - c_min;
  if (vib == 0.0f || delta < FC(0.02)) return processed;
  const float cur_sat = delta / fmaxf(c_max, FC(0.001));
  float amount;
  if (vib > 0.0f) {
    const float sat_mask = 1.0f - ss(0.4, 0.9, cur_sat);
    float h, s, v;
    rgb_to_hsv(processed, h, s, v);
    const float hue_dist = fminf(fabsf(h - 25.0f), 360.0f - fabsf(h - 25.0f));
    const float is_skin = ss(35.0, 10.0, hue_dist);
    const float skin_dampener = mix(1.0f, FC(0.6), is_skin);
    amount = vib * sat_mask * skin_dampener * 3.0f;
  } else {
    amount = vib * (1.0f - ss(0.2, 0.8, cur_sat));
  }
  return mix3(splat(l), processed, 1.0f + amount);
}

// fmodf(x, 360) without the libm call where it is a plain subtraction: on
// [0, 1080) the result is x, x - 360 or x - 720, and each subtraction is
// exact (Sterbenz: 360 <= x <= 720 and 720 <= x <= 1440), as fmod is.
// Elsewhere (a hue parameter past 720 degrees, a NaN) it is fmodf itself.
// Both callers pass h + shift + 360 with h in [0, 360].
__device__ __forceinline__ float mod360(float x) {
  if (x >= 0.0f && x < 1080.0f) return x >= 720.0f ? x - 720.0f : (x >= 360.0f ? x - 360.0f : x);
  return fmodf(x, 360.0f);
}

__device__ F3 hue_shift(F3 c, float shift) {
  if (fabsf(shift) < FC(0.01)) return c;
  const F3 srgb = f3(linear_to_srgb_ext(c.r), linear_to_srgb_ext(c.g), linear_to_srgb_ext(c.b));
  float h, s, v;
  rgb_to_hsv(srgb, h, s, v);
  const float sh = mod360(h + shift + 360.0f);
  return srgb_to_linear3(hsv_to_rgb(sh, s, v));
}

__constant__ float HSL_CENTER[8] = {358.0f, 25.0f, 60.0f, 115.0f, 180.0f, 225.0f, 280.0f, 330.0f};
__constant__ float HSL_INV_HALF_WIDTH[8] = {
    FC(2.0 / 35.0), FC(2.0 / 45.0), FC(2.0 / 40.0), FC(2.0 / 90.0),
    FC(2.0 / 60.0), FC(2.0 / 60.0), FC(2.0 / 55.0), FC(2.0 / 50.0)};

// mask gate on load (JAX develop.py:120: where(masks > 0.001, masks, 0))
__device__ __forceinline__ float gate(float x) { return x > FC(0.001) ? x : 0.0f; }

// The masks of one pixel: its influences (ungated, one plane apart), the
// block's staged mask scalars and the image's mask-param rows.
struct PixelMasks {
  const float* infl;
  size_t plane;
  const float* msm;
  const float* rows;
  int n;
  __device__ __forceinline__ float influence(int m) const { return gate(__ldg(infl + m * plane)); }
  __device__ __forceinline__ float scalar(int m, int k) const { return msm[m * M_SCALARS + k]; }
  __device__ __forceinline__ const float* row(int m) const { return rows + (size_t)m * M_K; }
};

// HSL's weighted totals of one band-param set (8 x 3)
__device__ __forceinline__ void hsl_totals(const float* p, const float* inf, float inv_total,
                                           unsigned bands, float& th, float& ts, float& tl) {
  th = 0.0f;
  ts = 0.0f;
  tl = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!(bands & (1u << i))) continue;
    const float ni = inf[i] * inv_total;
    th = th + p[3 * i + 0] * 2.0f * ni;
    ts = ts + p[3 * i + 1] * ni;
    tl = tl + p[3 * i + 2] * ni;
  }
}

// With MASKS, every mask's band totals add to the global ones, weighted by
// its influence, in mask order (ops/color.py apply_hsl_panel)
template <bool MASKS>
__device__ F3 hsl_panel(F3 c, const float* hsl, unsigned bands, const PixelMasks* pm) {
  const F3 safe = max0(c);
  float h, s, v;
  rgb_to_hsv(safe, h, s, v);
  const float ol = luma(safe);
  const float sat_mask = ss(0.05, 0.20, s);
  const float lum_weight = ss(0.0, 1.0, s);
  const bool gray = fabsf(safe.r - safe.g) < FC(0.001) && fabsf(safe.g - safe.b) < FC(0.001);
  const bool zero_w = sat_mask < FC(0.001) && lum_weight < FC(0.001);
  if (gray || zero_w) return safe;

  float inf[8];
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = fabsf(h - HSL_CENTER[i]);
    const float dist = fminf(d, 360.0f - d);
    const float f = dist * HSL_INV_HALF_WIDTH[i];
    inf[i] = expf(-1.5f * f * f);
    total = i == 0 ? inf[i] : total + inf[i];
  }
  const float inv_total = 1.0f / total;
  float th, ts, tl;
  hsl_totals(hsl, inf, inv_total, bands, th, ts, tl);
  float total_hue = th * sat_mask;
  float total_sat = ts * sat_mask;
  float total_lum = tl * lum_weight;
  if constexpr (MASKS) {
    if (pm != nullptr) {
      for (int m = 0; m < pm->n; ++m) {
        const float im = pm->influence(m);
        if (im == 0.0f) continue;
        hsl_totals(pm->row(m) + M_HSL, inf, inv_total, bands, th, ts, tl);
        total_hue = total_hue + im * (th * sat_mask);
        total_sat = total_sat + im * (ts * sat_mask);
        total_lum = total_lum + im * (tl * lum_weight);
      }
    }
  }

  const float new_sat_raw = s * (1.0f + total_sat);
  const float desat_val = ol * (1.0f + total_lum);
  if (new_sat_raw < FC(0.0001)) return splat(desat_val);
  const float new_h = mod360(h + total_hue + 360.0f);
  const float new_s = clampf(new_sat_raw, 0.0f, 1.0f);
  const F3 hs = hsv_to_rgb(new_h, new_s, v);
  const float nl = luma(hs);
  const float target = ol * (1.0f + total_lum);
  if (nl < FC(0.0001)) return splat(fmaxf(target, 0.0f));
  return scl(hs, target / nl);
}

__device__ F3 color_grading(F3 c, const float* cg, float blending, float balance) {
  const float l = luma(max0(c));
  const float sc = FC(0.1) + fmaxf(-balance, 0.0f) * 0.5f;
  const float hc = 0.5f - fmaxf(balance, 0.0f) * 0.5f;
  const float feather = FC(0.2) * blending;
  const float fsc = fminf(sc, hc - FC(0.01));
  const float shadow = 1.0f - ssd(fsc - feather, fsc + feather, l);
  const float high = ssd(hc - feather, hc + feather, l);
  const float mid = fmaxf(1.0f - shadow - high, 0.0f);
  const float masks[4] = {shadow, mid, high, 1.0f};
  const float sat_str[4] = {FC(0.3), FC(0.6), FC(0.8), 1.0f};
  const float lum_str[4] = {0.5f, FC(0.8), 1.0f, 1.0f};
  F3 graded = c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hue = cg[3 * i], sat = cg[3 * i + 1], lum = cg[3 * i + 2];
    const float m = masks[i];
    if (sat > FC(0.001)) {
      const F3 t = hsv_to_rgb(hue, 1.0f, 1.0f);
      const float amt = (sat * sat_str[i]) * m;
      graded = add(graded, f3((t.r - 0.5f) * amt, (t.g - 0.5f) * amt, (t.b - 0.5f) * amt));
    }
    graded = addc(graded, (lum * lum_str[i]) * m);
  }
  return graded;
}

__device__ F3 color_calibration(F3 c, const float* cal) {
  const float st = cal[0], h_r = cal[1], s_r = cal[2];
  const float h_g = cal[3], s_g = cal[4], h_b = cal[5], s_b = cal[6];
  const float rp0 = 1.0f - fabsf(h_r), rp1 = fmaxf(0.0f, h_r), rp2 = fmaxf(0.0f, -h_r);
  const float gp0 = fmaxf(0.0f, -h_g), gp1 = 1.0f - fabsf(h_g), gp2 = fmaxf(0.0f, h_g);
  const float bp0 = fmaxf(0.0f, h_b), bp1 = fmaxf(0.0f, -h_b), bp2 = 1.0f - fabsf(h_b);
  F3 o = f3(rp0 * c.r + gp0 * c.g + bp0 * c.b, rp1 * c.r + gp1 * c.g + bp1 * c.b,
            rp2 * c.r + gp2 * c.g + bp2 * c.b);
  const float l = luma(max0(o));
  const F3 sat_vector = addc(o, -l);
  const float color_sum = o.r + o.g + o.b;
  F3 masks = splat(0.0f);
  if (color_sum > FC(0.001)) masks = divv(o, color_sum == 0.0f ? 1.0f : color_sum);
  const float total = masks.r * s_r + masks.g * s_g + masks.b * s_b;
  o = add(o, scl(sat_vector, total));
  if (fabsf(st) > FC(0.001)) {
    const float m = 1.0f - ss(0.0, 0.3, luma(max0(o)));
    o = f3(mix(o.r, o.r * (1.0f + st * FC(0.25)), m), mix(o.g, o.g * (1.0f - st * FC(0.25)), m),
           mix(o.b, o.b * (1.0f + st * FC(0.25)), m));
  }
  return o;
}

// ---- ops/local.py ---------------------------------------------------------

__device__ F3 local_contrast(F3 c, F3 blur, float amount, bool is_raw, int mode,
                             float threshold) {
  if (amount == 0.0f) return c;
  if (amount < 0.0f) {
    const float blur_amount = mode == 0 ? -amount * 0.5f : -amount * 1.0f;
    return mix3(c, blur, blur_amount);
  }
  const float center_luma = luma(c);
  const float shadow_protection =
      is_raw ? ss(0.0, 0.1, center_luma) : ss(0.0, 0.03, center_luma);
  const float highlight_protection = 1.0f - ss(0.9, 1.0, center_luma);
  const float midtone_mask = shadow_protection * highlight_protection;
  if (midtone_mask < FC(0.001)) return c;
  const float safe_center = fmaxf(center_luma, FC(0.0001));
  const float safe_blurred = fmaxf(luma(blur), FC(0.0001));
  const float log_ratio = log2f(safe_center / safe_blurred);
  float eff;
  if (mode == 0) {
    const float edge = fabsf(log_ratio);
    const float ne = clampf(divs(edge, 3.0), 0.0f, 1.0f);
    const float dampener = 1.0f - sqrtf(ne);
    const float edge_mask = ssd(threshold * 0.5f, threshold * 1.5f, edge);
    eff = amount * dampener * edge_mask * FC(0.8);
  } else {
    eff = amount * 1.0f;
  }
  const float cf = exp2f(log_ratio * eff);
  return mix3(c, scl(c, cf), midtone_mask);
}

// un = (x / W - 0.5) * 2 of the column, va = (y / H - 0.5) * 2 * aspect of
// the row: both from the block's tables
__device__ __forceinline__ float centre_mask(float un, float va) {
  const float d = sqrtf(un * un + va * va) * 0.5f;
  return 1.0f - ss(0.4 - 0.375, 0.4 + 0.375, d);
}

__device__ F3 centre_local_contrast(F3 c, float amount, F3 clarity, bool is_raw, float cm) {
  if (amount == 0.0f) return c;
  const float strength = amount * (2.0f * cm - 1.0f) * FC(0.9);
  if (!(fabsf(strength) > FC(0.001))) return c;
  return local_contrast(c, clarity, strength, is_raw, 1, 0.0f);
}

__device__ F3 centre_tonal_and_color(F3 c, float amount, float cm) {
  if (amount == 0.0f) return c;
  const float br = cm * amount * 0.5f;
  float scale, k;
  filmic_gains(br, scale, k);
  F3 out = filmic_exposure(c, br, scale, k);
  const float vib = cm * amount * FC(0.4);
  const float sat_centre = cm * amount * FC(0.3);
  const float sat_edge = -(1.0f - cm) * amount * FC(0.8);
  return creative_color(out, sat_centre + sat_edge, vib);
}

__device__ F3 dehaze(F3 c, F3 blur, float amount) {
  if (amount == 0.0f) return c;
  const F3 atm = f3(FC(0.95), FC(0.97), 1.0f);
  const float regional_dark = min3(blur);
  if (amount > 0.0f) {
    const float pixel_dark = min3(c);
    const float pl = luma(max0(c));
    const float bl = luma(max0(blur));
    const float edge = fabsf(sqrtf(fmaxf(pl, 0.0f)) - sqrtf(fmaxf(bl, 0.0f)));
    const float halo = ss(0.02, 0.15, edge);
    const float spatial_dark = mix(regional_dark, pixel_dark, halo);
    const float safe_dark = fmaxf(spatial_dark - FC(0.02), 0.0f);
    const float mapped = safe_dark / (safe_dark + FC(0.2));
    const float t = fmaxf(1.0f - amount * mapped * FC(0.85), FC(0.15));
    F3 rec = add(divv(sub(c, atm), t), atm);
    const float lift = ss(0.1, 0.0, luma(max0(rec))) * (1.0f - t) * FC(0.15);
    rec = addc(rec, lift);
    const float sat_boost = (1.0f - t) * 0.5f;
    rec = mix3(splat(luma(max0(rec))), rec, 1.0f + sat_boost);
    return max0(rec);
  }
  const float sdn = fmaxf(regional_dark - FC(0.02), 0.0f);
  const float depth = mix(FC(0.4), 1.0f, sdn / (sdn + FC(0.2)));
  return mix3(c, atm, fabsf(amount) * FC(0.7) * depth);
}

__device__ __forceinline__ float perceptual_luma(float l) {
  return l <= 1.0f ? fpow_lt1(fmaxf(l, 0.0f), FC(1.0 / 2.2))
                   : 1.0f + fpow_lt1(fmaxf(l - 1.0f, 0.0f), FC(1.0 / 2.2));
}

// glow/halation source: the level through exposure, brightness and whites
// (the tonal stage with contrast = shadows = blacks = 0 is the white gain)
__device__ F3 graded_blur(F3 blur, float exp, float bright, float wh, const Uniforms& u) {
  blur = linear_exposure(blur, exp, u.exp_gain);
  blur = filmic_exposure(blur, bright, u.br_scale, u.br_k);
  if (wh != 0.0f) blur = scl(blur, u.w_mult);
  return blur;
}

__device__ F3 glow_bloom(F3 c, F3 blur, float amount, float exp, float bright, float wh,
                         const Uniforms& u) {
  if (amount <= 0.0f) return c;
  const F3 b = graded_blur(blur, exp, bright, wh, u);
  const float ll = luma(max0(b));
  const float pl = perceptual_luma(ll);
  const float cutoff = mix(FC(0.75), FC(0.08), clampf(amount, 0.0f, 1.0f));
  const float fade = ssd(cutoff, cutoff + FC(0.15), pl);
  const float excess = fmaxf(pl - cutoff, 0.0f);
  const float intensity = fpow_lt1(ss(0.0, 1.0, divs(excess, 5.5)), FC(0.45));
  F3 bloom = ll > FC(0.01) ? mul(divv(b, ll), f3(FC(1.03), 1.0f, FC(0.97)))
                           : f3(1.0f, FC(0.99), FC(0.98));
  const float luma_factor = fpow_lt1(fmaxf(ll, 0.0f), FC(0.6));
  const float black_gate = sqrtf(ss(0.0, 0.5, ll));
  bloom = scl(bloom, intensity * luma_factor * fade * black_gate);
  const float protection = 1.0f - ss(1.0, 2.2, luma(max0(c)));
  return add(c, scl(bloom, amount * FC(3.8) * protection));
}

// the flare contribution of one pixel: its image's (512, 512, 3) map
// sampled bilinearly at u = x / W, v = y / H (absolute coordinates over the
// full image's size), times 1.4, squared
// (ops/flare.py `sample_flare`)
__device__ F3 flare_sample(const float* __restrict__ map, float xs, float ys, int W, int H) {
  constexpr int FN = 512;
  const float x = __fdiv_rn(xs, (float)W) * (float)FN - 0.5f;
  const float y = __fdiv_rn(ys, (float)H) * (float)FN - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int xi0 = min(max((int)x0, 0), FN - 1), yi0 = min(max((int)y0, 0), FN - 1);
  const int xi1 = min(xi0 + 1, FN - 1), yi1 = min(yi0 + 1, FN - 1);
  const float* c00 = map + (yi0 * FN + xi0) * 3;
  const float* c10 = map + (yi0 * FN + xi1) * 3;
  const float* c01 = map + (yi1 * FN + xi0) * 3;
  const float* c11 = map + (yi1 * FN + xi1) * 3;
  float o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = __ldg(c00 + k) * (1.0f - fx) + __ldg(c10 + k) * fx;
    const float bot = __ldg(c01 + k) * (1.0f - fx) + __ldg(c11 + k) * fx;
    const float v = (top * (1.0f - fy) + bot * fy) * FC(1.4);
    o[k] = v * v;
  }
  return f3(o[0], o[1], o[2]);
}

__device__ F3 halation(F3 c, F3 blur, float amount, float exp, float bright, float wh,
                       const Uniforms& u) {
  if (amount <= 0.0f) return c;
  const F3 b = graded_blur(blur, exp, bright, wh, u);
  const float ll = luma(max0(b));
  const float pl = perceptual_luma(ll);
  const float cutoff = mix(FC(0.85), FC(0.1), clampf(amount, 0.0f, 1.0f));
  if (pl <= cutoff) return c;
  const float excess = pl - cutoff;
  const float rng = fmaxf(1.5f - cutoff, FC(0.1));
  const float hm = ssd(0.0f, rng * FC(0.6), excess);
  const float blend = ss(0.0, 0.7, hm);
  const F3 tint = mix3(f3(1.0f, FC(0.32), FC(0.10)), f3(1.0f, FC(0.15), FC(0.03)), blend);
  const F3 glow = scl(tint, hm * ll);
  const float cl = luma(max0(c));
  const F3 affected = mix3(c, splat(cl), hm * FC(0.12));
  const F3 reduced = mix3(splat(0.5f), affected, 1.0f - hm * FC(0.06));
  return add(reduced, scl(scl(glow, amount), 2.5f));
}

// the flare stage (pipeline/grade.py, shader.wgsl:1596-1610)
__device__ __forceinline__ F3 flare(F3 c, F3 fr, float amount) {
  const float perceptual = perceptual_luma(luma(max0(c)));
  const float protection = 1.0f - ss(0.7, 1.8, perceptual);
  if (!(amount > 0.0f)) return c;
  return add(c, f3(fr.r * amount * protection, fr.g * amount * protection,
                   fr.b * amount * protection));
}

// ---- ops/lut3d.py ---------------------------------------------------------

// Tetrahedral interpolation in the (L, L, L, 3) cube and the intensity
// blend: the tetrahedron is chosen as `sample_lut_tetrahedral`'s nested
// `where`s choose it (ties included), and only its four corners are read;
// each channel is c000 * w0 + ca * wa + cb * wb + c111 * w1 in that order.
__device__ F3 apply_lut(F3 c, const float* __restrict__ lut, int L, float intensity) {
  const float s = (float)(L - 1);
  const float sr = clampf(c.r, 0.0f, 1.0f) * s, sg = clampf(c.g, 0.0f, 1.0f) * s,
              sb = clampf(c.b, 0.0f, 1.0f) * s;
  const float ir = floorf(sr), ig = floorf(sg), ib = floorf(sb);
  const float fr = sr - ir, fg = sg - ig, fb = sb - ib;
  const int r0 = (int)ir, g0 = (int)ig, b0 = (int)ib;
  const int r1 = min(r0 + 1, L - 1), g1 = min(g0 + 1, L - 1), b1 = min(b0 + 1, L - 1);
  // corners (ra, ga, ba), (rb, gb, bb) and the four weights of the chosen tetrahedron
  int ra, ga, ba, rb, gb, bb;
  float w0, wa, wb, w1;
  if (fr > fg) {
    if (fg > fb) {  // t1: c100, c110
      ra = r1, ga = g0, ba = b0, rb = r1, gb = g1, bb = b0;
      w0 = 1.0f - fr, wa = fr - fg, wb = fg - fb, w1 = fb;
    } else if (fr > fb) {  // t2: c100, c101
      ra = r1, ga = g0, ba = b0, rb = r1, gb = g0, bb = b1;
      w0 = 1.0f - fr, wa = fr - fb, wb = fb - fg, w1 = fg;
    } else {  // t3: c001, c101
      ra = r0, ga = g0, ba = b1, rb = r1, gb = g0, bb = b1;
      w0 = 1.0f - fb, wa = fb - fr, wb = fr - fg, w1 = fg;
    }
  } else {
    if (fb > fg) {  // t4: c001, c011
      ra = r0, ga = g0, ba = b1, rb = r0, gb = g1, bb = b1;
      w0 = 1.0f - fb, wa = fb - fg, wb = fg - fr, w1 = fr;
    } else if (fb > fr) {  // t5: c010, c011
      ra = r0, ga = g1, ba = b0, rb = r0, gb = g1, bb = b1;
      w0 = 1.0f - fg, wa = fg - fb, wb = fb - fr, w1 = fr;
    } else {  // t6: c010, c110
      ra = r0, ga = g1, ba = b0, rb = r1, gb = g1, bb = b0;
      w0 = 1.0f - fg, wa = fg - fr, wb = fr - fb, w1 = fb;
    }
  }
  const float* p000 = lut + ((r0 * L + g0) * L + b0) * 3;
  const float* p111 = lut + ((r1 * L + g1) * L + b1) * 3;
  const float* pa = lut + ((ra * L + ga) * L + ba) * 3;
  const float* pb = lut + ((rb * L + gb) * L + bb) * 3;
  float o[3];
  const float in[3] = {c.r, c.g, c.b};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t = __ldg(p000 + k) * w0 + __ldg(pa + k) * wa + __ldg(pb + k) * wb +
                    __ldg(p111 + k) * w1;
    o[k] = in[k] * (1.0f - intensity) + t * intensity;
  }
  return f3(o[0], o[1], o[2]);
}

// ---- pipeline/grade.py: vignette ------------------------------------------

// sgn(u) |u|^round of one coordinate, u = (coord / size - 0.5) * 2: the
// vignette's term of a column (ux) or, times the aspect, of a row (ua)
__device__ __forceinline__ float vignette_u(float coord, float inv_size, float v_round) {
  const float un = (coord * inv_size - 0.5f) * 2.0f;
  return sgnf(un) * fpow(fabsf(un), v_round);
}

__device__ F3 vignette(F3 c, float ux, float ua, float amount, float e0, float e1) {
  const float d = sqrtf(ux * ux + ua * ua) * 0.5f;
  const float vm = ssd(e0, e1, d);
  if (amount < 0.0f) return scl(c, 1.0f + amount * vm);
  return mix3(c, splat(1.0f), amount * vm);
}

// ---- ops/curves.py --------------------------------------------------------

__device__ float eval_curve(float val, const float* seg, const float* ends, float enabled,
                            int nseg) {
  if (!(enabled > 0.0f)) return val;
  const float x = val * 255.0f;
  float seg_val = 0.0f;
  bool any_seg = false;
  for (int i = 0; i < nseg; ++i) {
    const float* s = seg + 7 * i;
    const float x0 = s[0], x1 = s[1];
    if (x > x0 && x <= x1) {
      const float t = (x - x0) * s[2];
      seg_val = clampf(((s[6] * t + s[5]) * t + s[4]) * t + s[3], 0.0f, 1.0f);
      any_seg = true;
    }
  }
  const float last = divs(ends[3], 255.0);
  float out = any_seg ? seg_val : last;
  if (x >= ends[2]) out = last;
  if (x <= ends[0]) out = divs(ends[1], 255.0);
  return out;
}

// one curve set: seg (4, MAX_SEGMENTS, 7), ends (4, 4), enabled (4,) and
// rgb_active, from the param row (global) or a mask-param row
__device__ F3 apply_curves(F3 c, const float* seg, const float* ends, const float* en,
                           const float* rgb_active, int nseg, bool rgb_maybe) {
  const int cs = MAX_SEGMENTS * 7;
  const float en0 = en[0];
  const F3 luma_path = f3(eval_curve(c.r, seg, ends, en0, nseg),
                          eval_curve(c.g, seg, ends, en0, nseg),
                          eval_curve(c.b, seg, ends, en0, nseg));
  if (!rgb_maybe || !(*rgb_active > 0.0f)) return luma_path;
  const F3 graded = f3(eval_curve(c.r, seg + cs, ends + 4, en[1], nseg),
                       eval_curve(c.g, seg + 2 * cs, ends + 8, en[2], nseg),
                       eval_curve(c.b, seg + 3 * cs, ends + 12, en[3], nseg));
  const float target = eval_curve(luma(c), seg, ends, en0, nseg);
  const float lg = luma(graded);
  F3 rp = lg > FC(0.001) ? scl(graded, target / lg) : splat(target);
  const float mc = max3(rp);
  if (mc > 1.0f) rp = divv(rp, mc);
  return rp;
}

// ---- ops/grain.py ---------------------------------------------------------

__device__ __forceinline__ float hash2(float px, float py) {
  float p3x = fract(px * FC(0.1031));
  float p3y = fract(py * FC(0.1031));
  float p3z = fract(px * FC(0.1031));
  const float d = p3x * (p3y + FC(33.33)) + p3y * (p3z + FC(33.33)) + p3z * (p3x + FC(33.33));
  p3x = p3x + d;
  p3y = p3y + d;
  p3z = p3z + d;
  return fract((p3x + p3y) * p3z);
}

__device__ __forceinline__ float grad_dot(float ix, float iy, float fx, float fy, float ox,
                                          float oy) {
  const float gx = hash2(ix + ox, iy + oy) * 2.0f - 1.0f;
  const float gy = hash2(ix + ox + 11.0f, iy + oy + 37.0f) * 2.0f - 1.0f;
  return gx * (fx - ox) + gy * (fy - oy);
}

__device__ float gradient_noise(float px, float py) {
  const float ix = floorf(px), iy = floorf(py);
  const float fx = px - ix, fy = py - iy;
  const float ux = fx * fx * fx * (fx * (fx * 6.0f - 15.0f) + 10.0f);
  const float uy = fy * fy * fy * (fy * (fy * 6.0f - 15.0f) + 10.0f);
  const float d00 = grad_dot(ix, iy, fx, fy, 0.0f, 0.0f);
  const float d10 = grad_dot(ix, iy, fx, fy, 1.0f, 0.0f);
  const float d01 = grad_dot(ix, iy, fx, fy, 0.0f, 1.0f);
  const float d11 = grad_dot(ix, iy, fx, fy, 1.0f, 1.0f);
  return mix(mix(d00, d10, ux), mix(d01, d11, ux), uy);
}

// freq = (1 / max(size, 0.1)) / scale, taken once per block
__device__ F3 grain(F3 c, float x, float y, float amount, float roughness, float freq) {
  const float amt = amount * 0.5f;
  const float l = fmaxf(luma(c), 0.0f);
  const float lm = ss(0.0, 0.15, l) * (1.0f - ss(0.6, 1.0, l));
  const float nb = gradient_noise(x * freq, y * freq);
  const float nr = gradient_noise(x * freq * FC(0.6) + FC(5.2), y * freq * FC(0.6) + FC(1.3));
  const float nv = mix(nb, nr, roughness);
  return addc(c, nv * amt * lm);
}

// ---- the kernel -----------------------------------------------------------

__device__ __forceinline__ F3 load3(const float* __restrict__ t, size_t i, size_t plane) {
  return f3(__ldg(t + i), __ldg(t + i + plane), __ldg(t + i + 2 * plane));
}

// Every value of one image that does not depend on the pixel, from its
// param row, by the expressions the stages used per pixel before.
__device__ void uniforms(const float* __restrict__ p, float inv_scale, Uniforms& u) {
  const float exposure = __ldg(p + P_EXPOSURE), brightness = __ldg(p + P_BRIGHTNESS);
  const float whites = __ldg(p + P_WHITES), h = __ldg(p + P_HIGHLIGHTS);
  const float t = __ldg(p + P_TEMPERATURE), n = __ldg(p + P_TINT);
  u.exp_gain = exp2f(exposure);
  filmic_gains(brightness, u.br_scale, u.br_k);
  u.w_mult = w_mult_of(whites);
  u.con_strength = con_strength_of(__ldg(p + P_CONTRAST));
  u.bl_factor = bl_factor_of(__ldg(p + P_BLACKS));
  u.sh_factor = sh_factor_of(__ldg(p + P_SHADOWS));
  hl_gains(h, u.hl_gamma, u.hl_cstr, u.hl_gain);
  wb_gains(t, n, u.wb_r, u.wb_g, u.wb_b);
  const float midpoint = __ldg(p + P_VIGNETTE_MIDPOINT);
  const float v_feather = __ldg(p + P_VIGNETTE_FEATHER) * 0.5f;
  u.v_e0 = midpoint - v_feather;
  u.v_e1 = midpoint + v_feather;
  u.grain_freq = (1.0f / fmaxf(__ldg(p + P_GRAIN_SIZE), FC(0.1))) * inv_scale;
}

// A field's effective value at one pixel: global + influence_n * mask_n
// over the masks in `bits`, ascending (pipeline/grade.py effective_params)
__device__ __forceinline__ float blend_field(float v, unsigned bits, int f, const PixelMasks& pm) {
  while (bits) {
    const int m = __ffs(bits) - 1;
    bits &= bits - 1u;
    v = v + pm.influence(m) * pm.scalar(m, f);
  }
  return v;
}

// The mask sharpness delta (pipeline/grade.py): each mask's sharpening of
// the stage's input, weighted by its influence, summed in mask order
__device__ F3 mask_sharpness(F3 c0, F3 blur, bool is_raw, const PixelMasks& pm) {
  F3 delta = splat(0.0f);
  for (int m = 0; m < pm.n; ++m) {
    const float a = pm.scalar(m, M_SHARPNESS);
    const float im = pm.influence(m);
    if (!(fabsf(a) > FC(0.001)) || im == 0.0f) continue;
    const F3 res = local_contrast(c0, blur, a, is_raw, 0, pm.scalar(m, M_SHARPNESS_THRESHOLD));
    delta = add(delta, scl(sub(res, c0), im));
  }
  return delta;
}

// The kernel is built for two register budgets (`__launch_bounds__`'s
// blocks per SM): 4 blocks, up to 64 registers, for a long chain, which is
// issue-bound and gains from the registers; 6 blocks, 40 registers and 48
// warps resident, for a short chain, which waits on memory and gains from
// the warps. The wrapper's launch plan picks one by the document's stage
// count (`grade_launch_plan`). A document with masks takes the MASKS build,
// at 4 blocks per SM.
template <int MIN_BLOCKS, bool MASKS>
__global__ void __launch_bounds__(BX* BY, MIN_BLOCKS)
    grade_kernel(const float* __restrict__ img, const float* __restrict__ l_sharp,
                 const float* __restrict__ l_tonal, const float* __restrict__ l_clarity,
                 const float* __restrict__ l_structure, const float* __restrict__ params,
                 float* __restrict__ out, unsigned flags, int nseg, unsigned bands, int rows,
                 int H, int W, int x_off, int y_off, int W_full, int H_full, float inv_w,
                 float inv_h, float inv_scale, float aspect, const float* __restrict__ infl, const float* __restrict__ mparams, int nmask,
                 MaskBlend blend, const float* __restrict__ flare_map,
                 const float* __restrict__ lut, int lut_size) {
  // per block: the image's param row and Uniforms, and the x-only and
  // y-only terms of the tile's columns and rows; with masks, each mask's
  // M_SCALARS leading params (dynamic shared memory)
  __shared__ float prm[P_K];
  __shared__ Uniforms u;
  __shared__ float vig_x[BX], cen_x[BX];
  __shared__ float vig_y[MAX_TILE_H], cen_y[MAX_TILE_H];
  extern __shared__ float msm[];
#define ON(f) ((flags & (f)) != 0u)
#define PV(name) prm[name]
// a field's value at the pixel, and whether a mask blends it
#define BLENDED(m) (MASKS && blend.bits[m] != 0u)
#define EFF(pname, m) (BLENDED(m) ? blend_field(PV(pname), blend.bits[m], m, pm) : PV(pname))
  const int tile_h = BY * rows;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const float* __restrict__ p = params + (size_t)blockIdx.z * P_K;
  for (int k = tid; k < P_K; k += BX * BY) prm[k] = __ldg(p + k);
  const float* __restrict__ mrows = nullptr;
  if constexpr (MASKS) {
    mrows = mparams + (size_t)blockIdx.z * nmask * M_K;
    for (int k = tid; k < nmask * M_SCALARS; k += BX * BY)
      msm[k] = __ldg(mrows + (size_t)(k / M_SCALARS) * M_K + k % M_SCALARS);
  }
  const float v_round = 1.0f - __ldg(p + P_VIGNETTE_ROUNDNESS);
  if (tid < BX) {
    const float xs = (float)(blockIdx.x * BX + tid + x_off);
    if (ON(F_VIGNETTE_ACTIVE)) vig_x[tid] = vignette_u(xs, inv_w, v_round);
    if (ON(F_CENTRE_ACTIVE)) cen_x[tid] = (xs * inv_w - 0.5f) * 2.0f;
  }
  if (tid < tile_h) {
    const float ys = (float)(blockIdx.y * tile_h + tid + y_off);
    if (ON(F_VIGNETTE_ACTIVE)) vig_y[tid] = vignette_u(ys, inv_h, v_round) * aspect;
    if (ON(F_CENTRE_ACTIVE)) cen_y[tid] = ((ys * inv_h - 0.5f) * 2.0f) * aspect;
  }
  if (tid == BX * BY - 1) uniforms(p, inv_scale, u);
  __syncthreads();

  const int x = blockIdx.x * BX + threadIdx.x;
  const size_t plane = (size_t)H * W;
  const size_t base = (size_t)blockIdx.z * 3 * plane + x;
  const bool is_raw = ON(F_IS_RAW);
  const float xs = (float)(x + x_off);
  const float ux = ON(F_VIGNETTE_ACTIVE) ? vig_x[threadIdx.x] : 0.0f;
  const float un = ON(F_CENTRE_ACTIVE) ? cen_x[threadIdx.x] : 0.0f;

#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    // every thread of the block takes part in each row step, so the barrier
    // starts the block's 8 warps on a row together: they run the chain's
    // long code in step (measured: with 4 rows per thread this is 5% faster
    // on config 3 than letting the warps drift apart)
    if (r > 0) __syncthreads();
    const int ty = threadIdx.y + r * BY;
    const int y = blockIdx.y * tile_h + ty;
    if (x >= W || y >= H) continue;
    const size_t i = base + (size_t)y * W;
    const float ys = (float)(y + y_off);
    PixelMasks pm;
    Uniforms lu;  // MASKS: the block's Uniforms, blended fields' values per pixel
    if constexpr (MASKS) {
      pm = {infl + (size_t)blockIdx.z * nmask * plane + (size_t)y * W + x, plane, msm, mrows,
            nmask};
    }
    const Uniforms& U = MASKS ? lu : u;

    F3 c = load3(img, i, plane);
    F3 b_sharp = {}, b_tonal = {}, b_clarity = {}, b_structure = {};
    if (l_sharp) b_sharp = load3(l_sharp, i, plane);
    if (l_tonal) b_tonal = load3(l_tonal, i, plane);
    if (l_clarity) b_clarity = load3(l_clarity, i, plane);
    if (l_structure) b_structure = load3(l_structure, i, plane);
    if (!is_raw && !ON(F_IMAGE_LINEAR)) c = srgb_to_linear3(c);
    if (!is_raw) {
      if (l_sharp) b_sharp = srgb_to_linear3(b_sharp);
      if (l_tonal) b_tonal = srgb_to_linear3(b_tonal);
      if (l_clarity) b_clarity = srgb_to_linear3(b_clarity);
      if (l_structure) b_structure = srgb_to_linear3(b_structure);
    }

    float cm = 0.0f;
    if (ON(F_CENTRE_ACTIVE)) cm = centre_mask(un, cen_y[ty]);

    // local contrast chain (shader.wgsl:1555-1580)
    const F3 c_in = c;
    if (ON(F_SHARPNESS_ACTIVE))
      c = local_contrast(c, b_sharp, PV(P_SHARPNESS), is_raw, 0, PV(P_SHARPNESS_THRESHOLD));
    if constexpr (MASKS) {
      if (ON(F_MASK_SHARPNESS_ACTIVE)) c = add(c, mask_sharpness(c_in, b_sharp, is_raw, pm));
    }
    if (ON(F_CLARITY_ACTIVE))
      c = local_contrast(c, b_clarity, EFF(P_CLARITY, M_CLARITY), is_raw, 1, 0.0f);
    if (ON(F_STRUCTURE_ACTIVE))
      c = local_contrast(c, b_structure, EFF(P_STRUCTURE, M_STRUCTURE), is_raw, 1, 0.0f);
    if (ON(F_CENTRE_ACTIVE)) c = centre_local_contrast(c, PV(P_CENTRE), b_clarity, is_raw, cm);

    // exposure + atmosphere (shader.wgsl:1582-1613)
    const float exposure = EFF(P_EXPOSURE, M_EXPOSURE);
    const float brightness = EFF(P_BRIGHTNESS, M_BRIGHTNESS);
    const float whites = EFF(P_WHITES, M_WHITES);
    if constexpr (MASKS) {
      lu.exp_gain = BLENDED(M_EXPOSURE) ? exp2f(exposure) : u.exp_gain;
      if (BLENDED(M_BRIGHTNESS)) {
        filmic_gains(brightness, lu.br_scale, lu.br_k);
      } else {
        lu.br_scale = u.br_scale;
        lu.br_k = u.br_k;
      }
      lu.w_mult = BLENDED(M_WHITES) ? w_mult_of(whites) : u.w_mult;
    }
    if (ON(F_EXPOSURE_ACTIVE)) c = linear_exposure(c, exposure, U.exp_gain);
    if (ON(F_GLOW_ACTIVE))
      c = glow_bloom(c, b_structure, EFF(P_GLOW, M_GLOW), exposure, brightness, whites, U);
    if (ON(F_HALATION_ACTIVE))
      c = halation(c, b_clarity, EFF(P_HALATION, M_HALATION), exposure, brightness, whites, U);
    if (ON(F_FLARE_ACTIVE)) {
      const float* map = flare_map + (size_t)blockIdx.z * (512 * 512 * 3);
      c = flare(c, flare_sample(map, xs, ys, W_full, H_full), EFF(P_FLARE, M_FLARE));
    }
    if (ON(F_DEHAZE_ACTIVE)) c = dehaze(c, b_structure, EFF(P_DEHAZE, M_DEHAZE));
    if (ON(F_CENTRE_ACTIVE)) c = centre_tonal_and_color(c, PV(P_CENTRE), cm);

    // global grade (shader.wgsl:1614-1631)
    if (ON(F_WB_ACTIVE)) {
      if constexpr (MASKS) {
        if (BLENDED(M_TEMPERATURE) || BLENDED(M_TINT)) {
          wb_gains(EFF(P_TEMPERATURE, M_TEMPERATURE), EFF(P_TINT, M_TINT), lu.wb_r, lu.wb_g,
                   lu.wb_b);
        } else {
          lu.wb_r = u.wb_r;
          lu.wb_g = u.wb_g;
          lu.wb_b = u.wb_b;
        }
      }
      c = white_balance(c, U);
    }
    if (ON(F_BRIGHTNESS_ACTIVE)) c = filmic_exposure(c, brightness, U.br_scale, U.br_k);
    if (ON(F_TONAL_ACTIVE)) {
      const bool shadow_path = l_tonal != nullptr;
      const float contrast = EFF(P_CONTRAST, M_CONTRAST);
      const float shadows = EFF(P_SHADOWS, M_SHADOWS), blacks = EFF(P_BLACKS, M_BLACKS);
      if constexpr (MASKS) {
        lu.con_strength = BLENDED(M_CONTRAST) ? con_strength_of(contrast) : u.con_strength;
        lu.sh_factor = BLENDED(M_SHADOWS) ? sh_factor_of(shadows) : u.sh_factor;
        lu.bl_factor = BLENDED(M_BLACKS) ? bl_factor_of(blacks) : u.bl_factor;
      }
      c = tonal_adjustments(c, shadow_path ? b_tonal : c, shadow_path, contrast, shadows, whites,
                            blacks, U);
    }
    if (ON(F_HIGHLIGHTS_ACTIVE)) {
      const float hl = EFF(P_HIGHLIGHTS, M_HIGHLIGHTS);
      if constexpr (MASKS) {
        if (BLENDED(M_HIGHLIGHTS)) {
          hl_gains(hl, lu.hl_gamma, lu.hl_cstr, lu.hl_gain);
        } else {
          lu.hl_gamma = u.hl_gamma;
          lu.hl_cstr = u.hl_cstr;
          lu.hl_gain = u.hl_gain;
        }
      }
      c = highlights(c, hl, U);
    }
    if (ON(F_CALIBRATION_ACTIVE)) c = color_calibration(c, prm + P_CALIBRATION);
    if (ON(F_HSL_ACTIVE))
      c = hsl_panel<MASKS>(c, prm + P_HSL, bands,
                           MASKS && ON(F_MASK_HSL_ACTIVE) ? &pm : nullptr);
    if (ON(F_HUE_ACTIVE)) c = hue_shift(c, EFF(P_HUE, M_HUE));
    if (ON(F_CREATIVE_ACTIVE))
      c = creative_color(c, EFF(P_SATURATION, M_SATURATION), EFF(P_VIBRANCE, M_VIBRANCE));
    if (ON(F_CG_ACTIVE)) c = color_grading(c, prm + P_CG, PV(P_CG_BLENDING), PV(P_CG_BALANCE));
    if constexpr (MASKS) {
      if (ON(F_MASK_CG_ACTIVE)) {
        for (int m = 0; m < pm.n; ++m) {
          const float im = pm.influence(m);
          if (im == 0.0f) continue;
          const F3 graded = color_grading(c, pm.row(m) + M_CG, pm.scalar(m, M_CG_BLENDING),
                                          pm.scalar(m, M_CG_BALANCE));
          c = mix3(c, graded, im);
        }
      }
    }

    // vignette (shader.wgsl:1645-1662)
    if (ON(F_VIGNETTE_ACTIVE))
      c = vignette(c, ux, vig_y[ty], PV(P_VIGNETTE_AMOUNT), u.v_e0, u.v_e1);

    // tonemap (shader.wgsl:1664-1676)
    if (ON(F_TONEMAPPER_AGX)) c = agx_tonemap(c, prm + P_AGX_P2R, prm + P_AGX_R2P);
    else if (is_raw) c = f3(raw_emulation(c.r), raw_emulation(c.g), raw_emulation(c.b));
    else c = f3(linear_to_srgb(c.r), linear_to_srgb(c.g), linear_to_srgb(c.b));

    // point curves (shader.wgsl:1678-1697)
    const bool rgb_maybe = ON(F_RGB_CURVES_MAYBE_ACTIVE);
    if (ON(F_CURVES_ACTIVE))
      c = apply_curves(c, prm + P_CURVES_SEG, prm + P_CURVES_ENDS, prm + P_CURVES_ENABLED,
                       prm + P_CURVES_RGB_ACTIVE, nseg, rgb_maybe);
    if constexpr (MASKS) {
      if (ON(F_MASK_CURVES_ACTIVE)) {
        for (int m = 0; m < pm.n; ++m) {
          const float im = pm.influence(m);
          if (im == 0.0f) continue;
          const float* mr = pm.row(m);
          const F3 curved = apply_curves(c, mr + M_CURVES_SEG, mr + M_CURVES_ENDS,
                                         mr + M_CURVES_ENABLED, mr + M_CURVES_RGB_ACTIVE, nseg,
                                         rgb_maybe);
          c = mix3(c, curved, im);
        }
      }
    }

    // finish: 3D LUT -> grain -> clipping -> dither -> clamp (shader.wgsl:1699-1734)
    if (ON(F_HAS_LUT)) c = apply_lut(c, lut, lut_size, PV(P_LUT_INTENSITY));
    if (ON(F_GRAIN_ACTIVE))
      c = grain(c, xs, ys, PV(P_GRAIN_AMOUNT), PV(P_GRAIN_ROUGHNESS), u.grain_freq);
    if (ON(F_SHOW_CLIPPING)) {
      const bool hi = c.r > FC(0.998) || c.g > FC(0.998) || c.b > FC(0.998);
      const bool lo = c.r < FC(0.002) || c.g < FC(0.002) || c.b < FC(0.002);
      if (hi) c = f3(1.0f, 0.0f, 0.0f);
      else if (lo) c = f3(0.0f, 0.0f, 1.0f);
    }
    if (ON(F_DITHER_ACTIVE)) c = addc(c, (hash2(xs, ys) - 0.5f) * FC(1.0 / 255.0));
    out[i] = clampf(c.r, 0.0f, 1.0f);
    out[i + plane] = clampf(c.g, 0.0f, 1.0f);
    out[i + 2 * plane] = clampf(c.b, 0.0f, 1.0f);
  }
#undef EFF
#undef BLENDED
#undef PV
#undef ON
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Grade a (B, 3, H, W) batch on the wrapper's launch plan
// (`grade_launch_plan` in pipeline/fused.py): the build for `min_blocks`
// blocks per SM (4 or 6; with masks, 4), `rows` rows per thread, a grid_x x
// grid_y x B grid of 32 x 8 blocks. Absent blur levels are null pointers;
// the config flags tell the kernel which stages read which level. With
// `nmask` > 0 masks: the (B, nmask, H, W) influences, the (B, nmask, M_K)
// mask params, the blend sets and the plan's `mask_smem` bytes of dynamic
// shared memory. With F_FLARE_ACTIVE the (B, 512, 512, 3) flare maps, with
// F_HAS_LUT the (lut_size^3, 3) cube. The batch is a W x H tile whose
// origin sits at (x_off, y_off) in a W_full x H_full image (0, 0 and the
// tile's own size for a whole image); inv_w, inv_h, inv_scale and aspect
// are the full image's. A plan that leaves a pixel uncovered,
// names another build or another shared-memory size, or passes the block's
// shared memory, and flags whose inputs are missing, are refused before
// launch.
extern "C" int rr_grade(const float* img, const float* l_sharp, const float* l_tonal,
                        const float* l_clarity, const float* l_structure, const float* params,
                        float* out, unsigned flags, int nseg, unsigned bands,
                        int min_blocks, int rows, int grid_x, int grid_y, int B, int H, int W,
                        int x_off, int y_off, int W_full, int H_full, float inv_w, float inv_h, float inv_scale, float aspect,
                        const float* infl, const float* mparams, int nmask,
                        const MaskBlend* blend, int mask_smem, const float* flare_map,
                        const float* lut, int lut_size, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || (min_blocks != 4 && min_blocks != 6))
    return (int)cudaErrorInvalidValue;
  if ((size_t)grid_x * BX < (size_t)W || (size_t)grid_y * BY * rows < (size_t)H ||
      grid_y > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // the tile lies inside its image, whose coordinates float32 holds exactly
  if (x_off < 0 || y_off < 0 || (long long)x_off + W > W_full ||
      (long long)y_off + H > H_full || W_full > (1 << 24) || H_full > (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (nmask < 0 || nmask > MAX_MASKS || blend == nullptr ||
      mask_smem != nmask * M_SCALARS * (int)sizeof(float) ||
      (nmask > 0 && (infl == nullptr || mparams == nullptr || min_blocks != 4)))
    return (int)cudaErrorInvalidValue;
  if (((flags & F_FLARE_ACTIVE) && flare_map == nullptr) ||
      ((flags & F_HAS_LUT) && (lut == nullptr || lut_size < 2)))
    return (int)cudaErrorInvalidValue;
  auto kernel = nmask > 0          ? grade_kernel<4, true>
                : min_blocks == 4 ? grade_kernel<4, false>
                                  : grade_kernel<6, false>;
  if (nmask > 0) {
    // the static shared memory and the masks' together within a block's
    // default 48 KB (at most 32 masks: ~3 KB)
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.sharedSizeBytes + (size_t)mask_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  }
  dim3 block(BX, BY);
  dim3 grid(grid_x, grid_y, B);
  kernel<<<grid, block, mask_smem, (cudaStream_t)stream>>>(
      img, l_sharp, l_tonal, l_clarity, l_structure, params, out, flags, nseg, bands, rows, H, W,
      x_off, y_off, W_full, H_full, inv_w, inv_h, inv_scale, aspect, infl, mparams, nmask, *blend, flare_map, lut, lut_size);
  return (int)cudaGetLastError();
}
