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
//   into a (B, 3, 512, 512) scratch map;
// - `composite_kernel`: one thread per map pixel: the 6-spike starburst
//   (per-channel spread), the inner burst, the glow rings, the iris rings,
//   the 7 ghosts, the 3 halos and the 64-tap streak, each tap a bilinear
//   sample of the 3 MB threshold map, written (B, 512, 512, 3) HWC as JAX
//   returns it.
// Every tap's offset, falloff and weight is a double on the JAX side,
// rounded once to f32 where it meets an f32 array: the wrapper builds that
// table (`flare_taps`) and this file copies it into constant memory, where
// every thread of a warp reads the same tap at the same time (a broadcast).
// Each expression keeps the plain version's operation order, and the file
// is built with --fmad=false; divisions by a Python constant multiply by
// its reciprocal as PyTorch's CUDA division does (`divs`), and pow, atan2,
// cos, exp and sqrt are the libm calls PyTorch's CUDA kernels make (powf,
// atan2f, cosf, expf, sqrtf). A tap whose uv falls outside the bounds JAX
// gates it by is not sampled at all (its term is an exact zero).
//
// What bounds it on the card: operations. A map pixel takes ~1,300
// bilinear samples (4 loads and ~10 operations each, one channel or three)
// and the reads hit L1/L2, not HBM: the threshold map (3 MB per image)
// stays in the 50 MB L2 cache. HBM traffic is the input's 2 x 2 texels per
// map pixel and the 3 MB map written, so a batch of two 24 MP images moves
// a few MB.

#include <cuda_runtime.h>
#include <math.h>

#define N_SPIKES 6
#define N_STAR 24
#define N_INNER 16
#define N_GLOW 36
#define N_STREAK 64

// Every tap's constants, float32 (ops/flare.py `_Taps`, same field order).
// Outside the anonymous namespace: the extern "C" entry point takes it.
struct FlareTaps {
  float star[N_SPIKES * 2 * N_STAR * 7];    // green dx, dy; red dx, dy; blue dx, dy; falloff
  float inner[N_SPIKES * 2 * N_INNER * 3];  // dx, dy, falloff
  float glow[N_GLOW * 3];                   // dx, dy, ring weight
  float streak[N_STREAK * 4];               // green du, red du, blue du, weight
  float aspect;                             // W / H
  float total_w_inv;                        // 1 / (sum of the streak weights), in double
};

namespace {

#define FC(x) ((float)(x))
// x divided by a Python scalar constant, as PyTorch's CUDA division by a
// CPU scalar computes it (see grade.cu)
#define divs(x, c) ((x) * (float)(1.0 / (c)))

constexpr int N = 512;  // the map's side (FLARE_MAP_SIZE)
constexpr int BX = 32, BY = 8;

__constant__ FlareTaps c_taps;

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

// bilinear weights and texel indices of one uv on an (h, w) grid, uv
// clamped to [0, 1] (flare.py `_bilinear_uv`)
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

// one channel, or all three, of the (3, N, N) threshold map at uv
__device__ __forceinline__ float tap1(const float* __restrict__ thr, int ch, float u, float v) {
  return lerp_plane(thr + ch * N * N, bilin(u, v, N, N));
}
__device__ __forceinline__ F3 tap3(const float* __restrict__ thr, float u, float v) {
  const Bilin s = bilin(u, v, N, N);
  return {lerp_plane(thr, s), lerp_plane(thr + N * N, s), lerp_plane(thr + 2 * N * N, s)};
}

__device__ __forceinline__ bool in_bounds(float u, float v) {
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
}

__device__ __forceinline__ float map_coord(int i) { return ((float)i + 0.5f) * (1.0f / N); }

__global__ void __launch_bounds__(BX* BY)
    threshold_kernel(const float* __restrict__ img, const float* __restrict__ fparams,
                     float* __restrict__ thr, int is_raw, int H, int W) {
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
  float* out = thr + (size_t)blockIdx.z * 3 * N * N + i * N + j;
  out[0] = c.r * f;
  out[N * N] = c.g * f;
  out[2 * N * N] = c.b * f;
}

__device__ __forceinline__ void add_tinted(F3& acc, F3 t, float tr, float tg, float tb,
                                           float mult) {
  acc.r = acc.r + t.r * tr * mult;
  acc.g = acc.g + t.g * tg * mult;
  acc.b = acc.b + t.b * tb * mult;
}

__global__ void __launch_bounds__(BX* BY)
    composite_kernel(const float* __restrict__ thr_all, const float* __restrict__ fparams,
                     float* __restrict__ out) {
  const int j = blockIdx.x * BX + threadIdx.x, i = blockIdx.y * BY + threadIdx.y;
  if (j >= N || i >= N) return;
  const float* thr = thr_all + (size_t)blockIdx.z * 3 * N * N;
  const float amount = __ldg(fparams + blockIdx.z * 4);
  const float u = map_coord(j), v = map_coord(i);
  const float fu = 1.0f - u, fv = 1.0f - v;
  const float aspect = c_taps.aspect;

  // ---- 6-spike starburst
  F3 star = {0.0f, 0.0f, 0.0f};
  for (int spike = 0; spike < N_SPIKES; ++spike) {
    F3 acc = {0.0f, 0.0f, 0.0f};
    float wsum = 0.0f;
#pragma unroll 2
    for (int t = 0; t < 2 * N_STAR; ++t) {
      // indexed on the __constant__ array itself, so the loads stay constant-cache loads
      const int k = (spike * 2 * N_STAR + t) * 7;
      const float uu = u + c_taps.star[k], vv = v + c_taps.star[k + 1];
      if (!in_bounds(uu, vv)) continue;
      const float f = c_taps.star[k + 6];
      acc.r = acc.r + tap1(thr, 0, u + c_taps.star[k + 2], v + c_taps.star[k + 3]) * f;
      acc.g = acc.g + tap1(thr, 1, uu, vv) * f;
      acc.b = acc.b + tap1(thr, 2, u + c_taps.star[k + 4], v + c_taps.star[k + 5]) * f;
      wsum = wsum + f;
    }
    if (wsum > 0.0f) {
      const float d = fmaxf(wsum, FC(1e-9));
      star = {star.r + acc.r / d, star.g + acc.g / d, star.b + acc.b / d};
    }
  }
  star = {divs(star.r, 6.0) * 3.0f, divs(star.g, 6.0) * 3.0f, divs(star.b, 6.0) * 3.0f};
  F3 flare = {star.r * 1.0f * 3.5f, star.g * FC(0.95) * 3.5f, star.b * FC(0.85) * 3.5f};

  // ---- inner starburst
  F3 inner = {0.0f, 0.0f, 0.0f};
  for (int spike = 0; spike < N_SPIKES; ++spike) {
    F3 acc = {0.0f, 0.0f, 0.0f};
    float wsum = 0.0f;
#pragma unroll 2
    for (int t = 0; t < 2 * N_INNER; ++t) {
      const int k = (spike * 2 * N_INNER + t) * 3;
      const float uu = u + c_taps.inner[k], vv = v + c_taps.inner[k + 1];
      if (!in_bounds(uu, vv)) continue;
      const float f = c_taps.inner[k + 2];
      const F3 s = tap3(thr, uu, vv);
      acc = {acc.r + s.r * f, acc.g + s.g * f, acc.b + s.b * f};
      wsum = wsum + f;
    }
    if (wsum > 0.0f) {
      const float d = fmaxf(wsum, FC(1e-9));
      inner = {inner.r + acc.r / d, inner.g + acc.g / d, inner.b + acc.b / d};
    }
  }
  inner = {divs(inner.r, 6.0) * 2.0f, divs(inner.g, 6.0) * 2.0f, divs(inner.b, 6.0) * 2.0f};
  add_tinted(flare, inner, 1.0f, FC(0.9), FC(0.8), 1.5f);

  // ---- radial glow
  {
    F3 glow = tap3(thr, u, v);
    glow = {glow.r * 2.0f, glow.g * 2.0f, glow.b * 2.0f};
    float gw = 2.0f;
    for (int t = 0; t < N_GLOW; ++t) {
      const float uu = u + c_taps.glow[3 * t], vv = v + c_taps.glow[3 * t + 1];
      if (!in_bounds(uu, vv)) continue;
      const float w = c_taps.glow[3 * t + 2];
      const F3 s = tap3(thr, uu, vv);
      glow = {glow.r + s.r * w, glow.g + s.g * w, glow.b + s.b * w};
      gw = gw + w;
    }
    add_tinted(flare, {glow.r / gw, glow.g / gw, glow.b / gw}, 1.0f, FC(0.95), FC(0.9),
               FC(0.4));
  }

  // ---- iris rings; the halos share their sample and centre distance
  const float ua = (u - 0.5f) * aspect;
  const float center_dist = sqrtf(sq(ua) + sq(v - 0.5f));
  const F3 src = tap3(thr, fu, fv);
  {
    const float angle = atan2f(v - 0.5f, ua);
    const float hex_mod = FC(0.9) + FC(0.1) * powf(fabsf(cosf(angle * 3.0f)), 4.0f);
    // (ring radius, width, intensity); the widths divide as Python scalars
    const float rf[4] = {expf(-sq(divs(center_dist - FC(0.15), 0.02))),
                         expf(-sq(divs(center_dist - FC(0.25), 0.025))),
                         expf(-sq(divs(center_dist - FC(0.35), 0.03))),
                         expf(-sq(divs(center_dist - FC(0.48), 0.035)))};
    const float inten[4] = {FC(0.4), FC(0.3), FC(0.2), FC(0.15)};
    F3 iris = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      iris = {iris.r + src.r * rf[r] * inten[r] * hex_mod,
              iris.g + src.g * rf[r] * inten[r] * hex_mod,
              iris.b + src.b * rf[r] * inten[r] * hex_mod};
    }
    add_tinted(flare, iris, FC(0.7), FC(0.8), 1.0f, FC(0.2));
  }

  // ---- ghosts: (inverted uv, scale, vignette edges, tint, mult, gated)
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
      const float gy = 0.5f + ((gh.inv ? fv : v) - 0.5f) * gh.sc;
      if (gh.gated && !(gx > 0.0f && gx < 1.0f && gy > 0.0f && gy < 1.0f)) continue;
      const F3 g = tap3(thr, gx, gy);
      const float dist = sqrtf(sq((gx - 0.5f) * aspect) + sq(gy - 0.5f));
      const float vig = 1.0f - ss(gh.e0, gh.e1, dist);
      flare = {flare.r + g.r * gh.tr * gh.mult * vig, flare.g + g.g * gh.tg * gh.mult * vig,
               flare.b + g.b * gh.tb * gh.mult * vig};
    }
  }

  // ---- halos: (radius, width, tint, mult), widths dividing as Python scalars
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
      flare = {flare.r + src.r * tint[k][0] * hf[k] * mult[k],
               flare.g + src.g * tint[k][1] * hf[k] * mult[k],
               flare.b + src.b * tint[k][2] * hf[k] * mult[k]};
    }
  }

  // ---- anamorphic streak
  {
    F3 acc = {0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int t = 0; t < N_STREAK; ++t) {
      const float su = u + c_taps.streak[4 * t];
      if (!(su > 0.0f && su < 1.0f)) continue;
      const float w = c_taps.streak[4 * t + 3];
      acc.r = acc.r + tap1(thr, 0, u + c_taps.streak[4 * t + 1], v) * w;
      acc.g = acc.g + tap1(thr, 1, su, v) * w;
      acc.b = acc.b + tap1(thr, 2, u + c_taps.streak[4 * t + 2], v) * w;
    }
    const float inv = c_taps.total_w_inv;
    add_tinted(flare, {acc.r * inv, acc.g * inv, acc.b * inv}, FC(0.85), FC(0.92), 1.0f, 1.0f);
  }

  float* o = out + (((size_t)blockIdx.z * N + i) * N + j) * 3;
  o[0] = flare.r * amount * 1.5f;
  o[1] = flare.g * amount * 1.5f;
  o[2] = flare.b * amount * 1.5f;
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The flare maps of a (B, 3, H, W) batch: `fparams` (B, 4) holds each
// image's flare amount, exposure, brightness and whites; `thr` is the
// caller's (B, 3, 512, 512) scratch and `out` the (B, 512, 512, 3) maps.
// The tap table is copied to constant memory on the stream first.
extern "C" int rr_flare(const float* img, const float* fparams, float* thr, float* out,
                        const FlareTaps* taps, int is_raw, int B, int H, int W, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || taps == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(c_taps, taps, sizeof(FlareTaps), 0,
                                            cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(BX, BY);
  const dim3 grid(N / BX, N / BY, B);
  threshold_kernel<<<grid, block, 0, st>>>(img, fparams, thr, is_raw, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  composite_kernel<<<grid, block, 0, st>>>(thr, fparams, out);
  return (int)cudaGetLastError();
}
