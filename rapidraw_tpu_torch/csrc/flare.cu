// The lens-flare map as two CUDA kernels for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the map with XLA
// (rapidraw_tpu/ops/flare.py `generate_flare_map`, ~1,300 vectorized
// bilinear taps over a 512 x 512 grid). Its plain PyTorch version
// (rapidraw_tpu_torch/ops/flare.py `generate_flare_map`) repeats those taps
// one op at a time, some 30,000 launches per image; here one call of
// `rr_flare` makes the maps of a whole batch in two launches:
// - `threshold_kernel`: one thread per pixel of each image's 512^2 map
//   (the batch on the grid's z axis): a clamped bilinear sample of the
//   (B, 3, H, W) input, linearized unless RAW, then exposure, the flare
//   filmic, whites and the soft knee (flare.py `flare_threshold_map`),
//   written twice: planar (B, 3, N + 1, S) and as float4 texels (B, N + 1,
//   S), each padded by a column and a row that repeat the last ones;
// - `composite_kernel`: the 6-spike starburst (per-channel spread), the
//   inner burst, the glow rings, the iris rings, the 7 ghosts, the 3 halos
//   and the 64-tap streak, each tap a bilinear sample of the threshold
//   map, written (B, 512, 512, 3) HWC as JAX returns it.
// Every tap's offset, falloff and weight is a double on the JAX side,
// rounded once to f32 where it meets an f32 array: the wrapper builds that
// table (`flare_taps`), uploads it once per aspect ratio and device, and
// each block stages it in shared memory, where every thread of a warp
// reads the same tap at the same time (a broadcast). Each expression keeps
// the plain version's operation order, and the file is built with
// --fmad=false; divisions by a Python constant multiply by its reciprocal
// as PyTorch's CUDA division does (`divs`), and pow, atan2, cos, exp and
// sqrt are the libm calls PyTorch's CUDA kernels make (powf, atan2f,
// cosf, expf, sqrtf). A tap whose uv falls outside the bounds JAX gates it
// by is not sampled at all (its term is an exact zero).
//
// What bounds it on the card: instruction issue and the L1 traffic of the
// taps. A map pixel takes ~1,300 bilinear samples and the reads hit L1/L2,
// not HBM: the threshold map (7 MB per image, both copies) stays in the
// 50 MB L2 cache. HBM traffic is the input's 2 x 2 texels per map pixel
// and the 3 MB map written, so a batch of two 24 MP images moves a few MB.
// The design cuts the work per tap:
// - a thread makes two map rows of one column, so a tap's column part
//   (clamp, texel index, weight) is computed once for both, and the
//   streak's row part once per row for all 64 taps (they share v);
// - `axis` takes texel space with one fma (x 512 is exact) and its floor
//   by a round-down add instead of two conversions; the padding stands in
//   for the high clamp of the neighbour index;
// - a three-channel tap reads four float4 texels, not twelve floats;
// - a tap's column start in a plane is one register pair, and each row's
//   texel one widening multiply-add from it (`opaque`), with the four
//   texels immediate offsets.

#include <cuda_runtime.h>
#include <math.h>

#define N_SPIKES 6
#define N_STAR 24
#define N_INNER 16
#define N_GLOW 36
#define N_STREAK 64

// Every tap's constants, float32 (ops/flare.py `_Taps`, same field order).
// Outside the anonymous namespace: the extern "C" entry point takes it.
struct alignas(16) FlareTaps {
  float star[N_SPIKES * 2 * N_STAR * 8];    // green dx, dy; red dx, dy; blue dx, dy; falloff; 0
  float inner[N_SPIKES * 2 * N_INNER * 4];  // dx, dy, falloff, 0
  float glow[N_GLOW * 4];                   // dx, dy, ring weight, 0
  float streak[N_STREAK * 4];               // green du, red du, blue du, weight
  float aspect;                             // W / H
  float total_w_inv;                        // 1 / (sum of the streak weights), in double
  float pad[2];
};

namespace {

#define FC(x) ((float)(x))
// x divided by a Python scalar constant, as PyTorch's CUDA division by a
// CPU scalar computes it (see grade.cu)
#define divs(x, c) ((x) * (float)(1.0 / (c)))

constexpr int N = 512;  // the map's side (FLARE_MAP_SIZE)
constexpr int BX = 32, BY = 4;

struct F3 {
  float r, g, b;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float luma(F3 c) {
  return c.r * FC(0.2126) + c.g * FC(0.7152) + c.b * FC(0.0722);
}
__device__ __forceinline__ float mix(float a, float b, float t) { return a * (1.0f - t) + b * t; }
__device__ __forceinline__ float sq(float x) { return x * x; }
// smoothstep with static edges: the reciprocal is the double 1/(e1-e0)
__device__ __forceinline__ float ss(double e0, double e1, float x) {
  const float inv = (float)(1.0 / (e1 - e0));
  const float t = clampf((x - (float)e0) * inv, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}
// ops/common.py fpow_lt1 and fpow_static(x, 2.4), as in grade.cu
__device__ __forceinline__ float fpow_lt1(float x, float y) {
  return exp2f(y * log2f(fmaxf(x, FC(1e-37))));
}
__device__ __forceinline__ float srgb_to_linear(float c) {
  const float base = divs(fabsf(c + FC(0.055)), 1.055);
  float higher = fpow_lt1(base, FC(2.4 - 2.0));
  higher = higher * base;
  higher = higher * base;
  const float lower = divs(c, 12.92);
  return c <= FC(0.04045) ? lower : higher;
}

// bilinear weights and texel indices of one uv on an (h, w) image, uv
// clamped to [0, 1] (flare.py `_bilinear_uv`): the threshold pass's sample
// of the input
struct Bilin {
  int i00, i01, i10, i11;
  float fx, fy;
};
__device__ __forceinline__ Bilin bilin(float u, float v, int h, int w) {
  const float x = clampf(u, 0.0f, 1.0f) * (float)w - 0.5f;
  const float y = clampf(v, 0.0f, 1.0f) * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const int xi0 = min(max((int)x0, 0), w - 1), yi0 = min(max((int)y0, 0), h - 1);
  const int xi1 = min(xi0 + 1, w - 1), yi1 = min(yi0 + 1, h - 1);
  return {yi0 * w + xi0, yi0 * w + xi1, yi1 * w + xi0, yi1 * w + xi1, x - x0, y - y0};
}
__device__ __forceinline__ float lerp_plane(const float* __restrict__ p, const Bilin& s) {
  const float top = mix(__ldg(p + s.i00), __ldg(p + s.i01), s.fx);
  const float bot = mix(__ldg(p + s.i10), __ldg(p + s.i11), s.fx);
  return mix(top, bot, s.fy);
}

// One axis of a bilinear tap of the threshold map: the texel index and the
// weight of clamp(c, 0, 1) * N - 0.5. The product by N = 512 is exact, so
// one fma rounds as the plain version's multiply and subtract do. x <=
// N - 0.5, so only the low clamp of the index can act: at x0 = -1 the
// index is 0 and its neighbour 1, JAX's rule (`xi1 = clip(xi0 + 1)` of the
// clipped xi0); the map's padding (texel N repeats texel N - 1) stands in
// for the high clamp of the neighbour.
struct Ax {
  unsigned i;
  float f;
};
// floor(x) by one round-down add of 1.5 * 2^23: x lies in [-0.5, N - 0.5],
// where that sum's ulp is 1, so the sum is floor(x) + 1.5 * 2^23 exactly;
// its float less the constant is floor(x), its bits less the constant's
// the integer (no conversion instruction).
__device__ __forceinline__ Ax axis(float c) {
  const float x = __fmaf_rn(__saturatef(c), (float)N, -0.5f);
  const float t = __fadd_rd(x, 12582912.0f);
  const float x0 = t - 12582912.0f;
  return {(unsigned)max(__float_as_int(t) - 0x4B400000, 0), x - x0};
}

// a map row's stride in texels (N plus the padding, 16-byte aligned) and a
// padded plane's texels (N + 1 rows)
constexpr int S = N + 4;
constexpr int MAP_TEX = (N + 1) * S;

// one channel of the planar padded map, or all three of the float4 one,
// at the texel q (its row and column already added) with weights fx, fy:
// the four texels are immediate offsets from q. A caller adds a tap's
// column to the plane's base once and each row's offset (one widening
// multiply-add) per row, so no 64-bit index arithmetic repeats per texel.
__device__ __forceinline__ float lerp1(const float* __restrict__ q, float fx, float fy) {
  const float top = mix(__ldg(q), __ldg(q + 1), fx);
  const float bot = mix(__ldg(q + S), __ldg(q + S + 1), fx);
  return mix(top, bot, fy);
}
__device__ __forceinline__ F3 lerp3(const float4* __restrict__ q, float fx, float fy) {
  const float4 a = __ldg(q), b = __ldg(q + 1);
  const float4 c = __ldg(q + S), d = __ldg(q + S + 1);
  return {mix(mix(a.x, b.x, fx), mix(c.x, d.x, fx), fy),
          mix(mix(a.y, b.y, fx), mix(c.y, d.y, fx), fy),
          mix(mix(a.z, b.z, fx), mix(c.z, d.z, fx), fy)};
}
// p as a value the compiler cannot see into: a tap's column start becomes
// one register pair, and a row's offset from it one widening multiply-add,
// not a 64-bit add and shift of a recombined index per texel
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm("mov.b64 %0, %0;" : "+l"(p));
  return p;
}

__device__ __forceinline__ F3 tap3(const float4* __restrict__ p, float u, float v) {
  const Ax x = axis(u), y = axis(v);
  return lerp3(p + x.i + y.i * S, x.f, y.f);
}

__device__ __forceinline__ bool in_unit(float c) { return c >= 0.0f && c <= 1.0f; }

__device__ __forceinline__ float map_coord(int i) { return ((float)i + 0.5f) * (1.0f / N); }

__global__ void __launch_bounds__(BX* BY)
    threshold_kernel(const float* __restrict__ img, const float* __restrict__ fparams,
                     float* __restrict__ thr, float4* __restrict__ thr4, int is_raw, int H,
                     int W) {
  const int j = blockIdx.x * BX + threadIdx.x, i = blockIdx.y * BY + threadIdx.y;
  if (j >= N || i >= N) return;
  const float* p = fparams + blockIdx.z * 4;
  const float amount = __ldg(p), exposure = __ldg(p + 1), br = __ldg(p + 2), wh = __ldg(p + 3);
  const size_t plane = (size_t)H * W;
  const float* src = img + (size_t)blockIdx.z * 3 * plane;
  const Bilin s = bilin(map_coord(j), map_coord(i), H, W);
  F3 c = {lerp_plane(src, s), lerp_plane(src + plane, s), lerp_plane(src + 2 * plane, s)};
  if (!is_raw) c = {srgb_to_linear(c.r), srgb_to_linear(c.g), srgb_to_linear(c.b)};
  if (exposure != 0.0f) {
    const float gain = exp2f(exposure);
    c = {c.r * gain, c.g * gain, c.b * gain};
  }
  // the flare filmic (flare.py `_filmic_exposure_flare`)
  {
    const float ol = luma(c);
    const float scale = exp2f(br * FC(0.05));
    const float k = exp2f(-(br * FC(0.95)) * FC(1.2));
    const float la = fabsf(ol);
    const float lf = floorf(la);
    const float fr = la - lf;
    const float shaped = fr / (fr + (1.0f - fr) * k);
    const float nl = sgnf(ol) * (lf + shaped) * scale;
    const float safe = fabsf(ol) < FC(1e-20) ? 1.0f : ol;
    const float cs = powf(fmaxf(nl / safe, 0.0f), FC(0.8));
    const bool skip = br == 0.0f || fabsf(ol) < FC(0.00001);
    if (!skip) c = {nl + (c.r - ol) * cs, nl + (c.g - ol) * cs, nl + (c.b - ol) * cs};
  }
  if (wh != 0.0f) {
    const float wl = fmaxf(1.0f - wh * FC(0.25), FC(0.01));
    c = {c.r / wl, c.g / wl, c.b / wl};
  }
  const float true_luma = luma(c);
  const float lt = fminf(true_luma, 1.0f);
  const float threshold = mix(FC(0.88), FC(0.50), clampf(amount, 0.0f, 1.0f));
  const float x = lt - threshold + FC(0.15);
  const float contrib = x <= 0.0f ? 0.0f : (x < FC(0.3) ? divs(x * x, 0.6) : x - FC(0.15));
  const float f = contrib / fmaxf(true_luma, FC(0.001));
  const float4 t = {c.r * f, c.g * f, c.b * f, 0.0f};
  // the texel, and the padding row and column that repeat the last ones
  float* pl = thr + (size_t)blockIdx.z * 3 * MAP_TEX;
  float4* p4 = thr4 + (size_t)blockIdx.z * MAP_TEX;
  for (int dy = 0; dy <= (i == N - 1); ++dy) {
    for (int dx = 0; dx <= (j == N - 1); ++dx) {
      const int off = (i + dy) * S + j + dx;
      pl[off] = t.x;
      pl[MAP_TEX + off] = t.y;
      pl[2 * MAP_TEX + off] = t.z;
      p4[off] = t;
    }
  }
}

__device__ __forceinline__ void add_tinted(F3& acc, F3 t, float tr, float tg, float tb,
                                           float mult) {
  acc.r = acc.r + t.r * tr * mult;
  acc.g = acc.g + t.g * tg * mult;
  acc.b = acc.b + t.b * tb * mult;
}

// Each thread makes ROWS map pixels of one column, rows ROWS * ty ..
// ROWS * ty + ROWS - 1 of its block: a tap's column part (the clamp, index
// and weight of u + du) is computed once for all of them, and the streak's
// row part (its taps share v) once per row for all 64 taps.
constexpr int ROWS = 2;

__global__ void __launch_bounds__(BX* BY, 8)
    composite_kernel(const float* __restrict__ thr_all, const float4* __restrict__ thr4_all,
                     const float* __restrict__ fparams, const FlareTaps* __restrict__ taps,
                     float* __restrict__ out) {
  // the tap table, staged from the wrapper's cached device copy
  __shared__ FlareTaps tb;
  {
    const float4* src = reinterpret_cast<const float4*>(taps);
    float4* dst = reinterpret_cast<float4*>(&tb);
    for (int k = threadIdx.y * BX + threadIdx.x; k < (int)(sizeof(FlareTaps) / 16); k += BX * BY)
      dst[k] = __ldg(src + k);
  }
  __syncthreads();
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i0 = (blockIdx.y * BY + threadIdx.y) * ROWS;
  const float* thr = thr_all + (size_t)blockIdx.z * 3 * MAP_TEX;
  const float* thr_g = thr + MAP_TEX;
  const float* thr_b = thr + 2 * MAP_TEX;
  const float4* thr4 = thr4_all + (size_t)blockIdx.z * MAP_TEX;
  const float amount = __ldg(fparams + blockIdx.z * 4);
  const float u = map_coord(j), fu = 1.0f - u;
  const float aspect = tb.aspect;
  float v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = map_coord(i0 + r);
  F3 flare[ROWS];

  // ---- 6-spike starburst
  {
    F3 star[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) star[r] = {0.0f, 0.0f, 0.0f};
    for (int spike = 0; spike < N_SPIKES; ++spike) {
      F3 acc[ROWS];
      float wsum[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = {0.0f, 0.0f, 0.0f}, wsum[r] = 0.0f;
#pragma unroll 2
      for (int t = 0; t < 2 * N_STAR; ++t) {
        const float4* tp = reinterpret_cast<const float4*>(tb.star) + (spike * 2 * N_STAR + t) * 2;
        const float4 g = tp[0];  // green dx, dy; red dx, dy
        const float4 bf = tp[1]; // blue dx, dy; falloff
        const float uu = u + g.x;
        if (!in_unit(uu)) continue;
        const Ax xr = axis(u + g.z), xg = axis(uu), xb = axis(u + bf.x);
        const float* cr = opaque(thr + xr.i);
        const float* cg = opaque(thr_g + xg.i);
        const float* cb = opaque(thr_b + xb.i);
        const float f = bf.z;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float vv = v[r] + g.y;
          if (!in_unit(vv)) continue;
          const Ax yr = axis(v[r] + g.w), yg = axis(vv), yb = axis(v[r] + bf.y);
          acc[r].r = acc[r].r + lerp1(cr + (size_t)yr.i * S, xr.f, yr.f) * f;
          acc[r].g = acc[r].g + lerp1(cg + (size_t)yg.i * S, xg.f, yg.f) * f;
          acc[r].b = acc[r].b + lerp1(cb + (size_t)yb.i * S, xb.f, yb.f) * f;
          wsum[r] = wsum[r] + f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (wsum[r] > 0.0f) {
          const float d = fmaxf(wsum[r], FC(1e-9));
          star[r] = {star[r].r + acc[r].r / d, star[r].g + acc[r].g / d,
                     star[r].b + acc[r].b / d};
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const F3 st = {divs(star[r].r, 6.0) * 3.0f, divs(star[r].g, 6.0) * 3.0f,
                     divs(star[r].b, 6.0) * 3.0f};
      flare[r] = {st.r * 1.0f * 3.5f, st.g * FC(0.95) * 3.5f, st.b * FC(0.85) * 3.5f};
    }
  }

  // ---- inner starburst
  {
    F3 inner[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) inner[r] = {0.0f, 0.0f, 0.0f};
    for (int spike = 0; spike < N_SPIKES; ++spike) {
      F3 acc[ROWS];
      float wsum[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = {0.0f, 0.0f, 0.0f}, wsum[r] = 0.0f;
#pragma unroll 2
      for (int t = 0; t < 2 * N_INNER; ++t) {
        const float4 tt = reinterpret_cast<const float4*>(tb.inner)[spike * 2 * N_INNER + t];
        const float uu = u + tt.x;
        if (!in_unit(uu)) continue;
        const Ax x = axis(uu);
        const float4* col = opaque(thr4 + x.i);
        const float f = tt.z;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float vv = v[r] + tt.y;
          if (!in_unit(vv)) continue;
          const Ax y = axis(vv);
          const F3 s = lerp3(col + (size_t)y.i * S, x.f, y.f);
          acc[r] = {acc[r].r + s.r * f, acc[r].g + s.g * f, acc[r].b + s.b * f};
          wsum[r] = wsum[r] + f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (wsum[r] > 0.0f) {
          const float d = fmaxf(wsum[r], FC(1e-9));
          inner[r] = {inner[r].r + acc[r].r / d, inner[r].g + acc[r].g / d,
                      inner[r].b + acc[r].b / d};
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const F3 in = {divs(inner[r].r, 6.0) * 2.0f, divs(inner[r].g, 6.0) * 2.0f,
                     divs(inner[r].b, 6.0) * 2.0f};
      add_tinted(flare[r], in, 1.0f, FC(0.9), FC(0.8), 1.5f);
    }
  }

  // ---- radial glow
  {
    F3 glow[ROWS];
    float gw[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const F3 c = tap3(thr4, u, v[r]);
      glow[r] = {c.r * 2.0f, c.g * 2.0f, c.b * 2.0f};
      gw[r] = 2.0f;
    }
#pragma unroll 2
    for (int t = 0; t < N_GLOW; ++t) {
      const float4 tt = reinterpret_cast<const float4*>(tb.glow)[t];
      const float uu = u + tt.x;
      if (!in_unit(uu)) continue;
      const Ax x = axis(uu);
      const float4* col = opaque(thr4 + x.i);
      const float w = tt.z;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float vv = v[r] + tt.y;
        if (!in_unit(vv)) continue;
        const Ax y = axis(vv);
        const F3 s = lerp3(col + (size_t)y.i * S, x.f, y.f);
        glow[r] = {glow[r].r + s.r * w, glow[r].g + s.g * w, glow[r].b + s.b * w};
        gw[r] = gw[r] + w;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      add_tinted(flare[r], {glow[r].r / gw[r], glow[r].g / gw[r], glow[r].b / gw[r]}, 1.0f,
                 FC(0.95), FC(0.9), FC(0.4));
  }

  // ---- iris rings, ghosts and halos, one row at a time; the halos share
  // the iris rings' sample and centre distance
  const float ua = (u - 0.5f) * aspect;
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    const float vr = v[r], fv = 1.0f - vr;
    const float center_dist = sqrtf(sq(ua) + sq(vr - 0.5f));
    const F3 src = tap3(thr4, fu, fv);
    {
      const float angle = atan2f(vr - 0.5f, ua);
      const float hex_mod = FC(0.9) + FC(0.1) * powf(fabsf(cosf(angle * 3.0f)), 4.0f);
      // (ring radius, width, intensity); the widths divide as Python scalars
      const float rf[4] = {expf(-sq(divs(center_dist - FC(0.15), 0.02))),
                           expf(-sq(divs(center_dist - FC(0.25), 0.025))),
                           expf(-sq(divs(center_dist - FC(0.35), 0.03))),
                           expf(-sq(divs(center_dist - FC(0.48), 0.035)))};
      const float inten[4] = {FC(0.4), FC(0.3), FC(0.2), FC(0.15)};
      F3 iris = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        iris = {iris.r + src.r * rf[k] * inten[k] * hex_mod,
                iris.g + src.g * rf[k] * inten[k] * hex_mod,
                iris.b + src.b * rf[k] * inten[k] * hex_mod};
      }
      add_tinted(flare[r], iris, FC(0.7), FC(0.8), 1.0f, FC(0.2));
    }
    // ghosts: (inverted uv, scale, vignette edges, tint, mult, gated)
    {
      struct Ghost {
        bool inv;
        float sc;
        double e0, e1;
        float tr, tg, tb, mult;
        bool gated;
      };
      const Ghost ghosts[7] = {
          {true, FC(0.75), 0.15, 0.6, 1.0f, FC(0.92), FC(0.85), FC(0.05), false},
          {true, FC(0.4), 0.1, 0.45, FC(0.92), 1.0f, FC(0.95), FC(0.07), false},
          {true, FC(0.2), 0.08, 0.35, FC(0.95), FC(0.97), 1.0f, FC(0.08), false},
          {true, FC(0.12), 0.05, 0.25, 1.0f, 1.0f, FC(0.97), FC(0.07), false},
          {false, FC(1.8), 0.25, 0.75, FC(0.85), FC(0.9), 1.0f, FC(0.03), true},
          {true, FC(1.3), 0.2, 0.55, 1.0f, FC(0.9), FC(0.95), FC(0.03), true},
          {true, FC(0.55), 0.2, 0.5, FC(0.97), FC(0.95), 1.0f, FC(0.04), false},
      };
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const Ghost& gh = ghosts[k];
        const float gx = 0.5f + ((gh.inv ? fu : u) - 0.5f) * gh.sc;
        const float gy = 0.5f + ((gh.inv ? fv : vr) - 0.5f) * gh.sc;
        if (gh.gated && !(gx > 0.0f && gx < 1.0f && gy > 0.0f && gy < 1.0f)) continue;
        const F3 g = tap3(thr4, gx, gy);
        const float dist = sqrtf(sq((gx - 0.5f) * aspect) + sq(gy - 0.5f));
        const float vig = 1.0f - ss(gh.e0, gh.e1, dist);
        flare[r] = {flare[r].r + g.r * gh.tr * gh.mult * vig,
                    flare[r].g + g.g * gh.tg * gh.mult * vig,
                    flare[r].b + g.b * gh.tb * gh.mult * vig};
      }
    }
    // halos: (radius, width, tint, mult), widths dividing as Python scalars
    {
      const float hf[3] = {expf(-sq(divs(center_dist - FC(0.4), 0.05))),
                           expf(-sq(divs(center_dist - FC(0.22), 0.035))),
                           expf(-sq(divs(center_dist - FC(0.55), 0.06)))};
      const float tint[3][3] = {{FC(0.85), FC(0.92), 1.0f},
                                {FC(0.92), FC(0.88), 1.0f},
                                {FC(0.85), FC(0.95), FC(0.97)}};
      const float mult[3] = {FC(0.07), FC(0.05), FC(0.03)};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        flare[r] = {flare[r].r + src.r * tint[k][0] * hf[k] * mult[k],
                    flare[r].g + src.g * tint[k][1] * hf[k] * mult[k],
                    flare[r].b + src.b * tint[k][2] * hf[k] * mult[k]};
      }
    }
  }

  // ---- anamorphic streak: every tap samples at its row's v
  {
    F3 acc[ROWS];
    float fy[ROWS];
    const float *row_r[ROWS], *row_g[ROWS], *row_b[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const Ax y = axis(v[r]);
      acc[r] = {0.0f, 0.0f, 0.0f};
      fy[r] = y.f;
      row_r[r] = opaque(thr + y.i * S);
      row_g[r] = opaque(thr_g + y.i * S);
      row_b[r] = opaque(thr_b + y.i * S);
    }
#pragma unroll 2
    for (int t = 0; t < N_STREAK; ++t) {
      const float4 tt = reinterpret_cast<const float4*>(tb.streak)[t];
      const float su = u + tt.x;
      if (!(su > 0.0f && su < 1.0f)) continue;
      const Ax xr = axis(u + tt.y), xg = axis(su), xb = axis(u + tt.z);
      const float w = tt.w;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r].r = acc[r].r + lerp1(row_r[r] + xr.i, xr.f, fy[r]) * w;
        acc[r].g = acc[r].g + lerp1(row_g[r] + xg.i, xg.f, fy[r]) * w;
        acc[r].b = acc[r].b + lerp1(row_b[r] + xb.i, xb.f, fy[r]) * w;
      }
    }
    const float inv = tb.total_w_inv;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      add_tinted(flare[r], {acc[r].r * inv, acc[r].g * inv, acc[r].b * inv}, FC(0.85), FC(0.92),
                 1.0f, 1.0f);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float* o = out + (((size_t)blockIdx.z * N + i0 + r) * N + j) * 3;
    o[0] = flare[r].r * amount * 1.5f;
    o[1] = flare[r].g * amount * 1.5f;
    o[2] = flare[r].b * amount * 1.5f;
  }
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The flare maps of a (B, 3, H, W) batch: `fparams` (B, 4) holds each
// image's flare amount, exposure, brightness and whites; `taps` is the
// wrapper's device copy of the tap table (made once per aspect ratio);
// `thr` (B, 3, N + 1, S) and `thr4` (B, N + 1, S) float4 are the caller's
// scratch for the padded threshold map, `out` the (B, N, N, 3) maps.
// `rows` and `grid_y` are the wrapper's launch plan (`flare_launch_plan`),
// refused unless they are this build's.
extern "C" int rr_flare(const float* img, const float* fparams, float* thr, float* thr4,
                        float* out, const FlareTaps* taps, int is_raw, int rows, int grid_y,
                        int B, int H, int W, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || taps == nullptr) return (int)cudaErrorInvalidValue;
  if (rows != ROWS || grid_y * BY * ROWS != N) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  threshold_kernel<<<dim3(N / BX, N / BY, B), dim3(BX, BY), 0, st>>>(
      img, fparams, thr, reinterpret_cast<float4*>(thr4), is_raw, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  composite_kernel<<<dim3(N / BX, grid_y, B), dim3(BX, BY), 0, st>>>(
      thr, reinterpret_cast<const float4*>(thr4), fparams, taps, out);
  return (int)cudaGetLastError();
}
