// Separable truncated-Gaussian blur pyramid for Hopper (sm_90a).
//
// Replaces the TPU kernels B1 and B2 of rapidraw_tpu/ops/blur.py:
// `_blur_axis` (_make_kernel, one radius) and `_blur_axis_multi`
// (_make_multi_kernel, up to four radii in one launch per axis). Same
// semantics as blur.wgsl and `gaussian_blur_reference`: sigma = r/2, taps
// -r..r normalised by their sum, clamp-to-edge sampling, inputs clamped to
// [0, 65504] (the rgba16f range) as they are staged.
//
// Layout: input (C, N, M) f32; output plane g*C + c holds source channel c
// blurred with level g's radius. Clamp-to-edge is index arithmetic per
// axis: per-axis index clamping of a separable blur is exactly the 2D
// edge-padded result of the reference.
//
// What bounds it on the card: HBM bytes at small radii, FP32 FMA issue at
// large ones (r = 152 at 24 MP is 305 taps a pass). So there are two
// regimes, and the launch plan (ops/blur.py: blur_launch_plan) puts each
// level in one of them by its radius:
//   * fused (r <= the plan's threshold): one launch for every such level.
//     A block streams a tall strip of source rows, with the column halo of
//     the largest fused radius, through shared memory: 16-byte cp.async
//     copies (clamped 4-byte ones at the image's edges) land the next
//     step's rows while the current step computes, and each thread then
//     clamps what it copied to the rgba16f range into the stage. Each level
//     runs its H pass once per source row into a ring of H rows in shared
//     memory (clamped to 65504 as it is written, the only part of a V-side
//     rgba16f clamp that can change a value: H outputs are means of values
//     in [0, 65504]) and its V pass from that ring, and writes each output
//     once, coalesced. The source is read from HBM once for all fused
//     levels, and no H row is computed twice within a strip.
//   * two-pass (larger radii): an H launch over 32-row x 128-column tiles
//     into a scratch plane, then a V launch over tall 32-column strips
//     whose input rows stream through a ring in shared memory (cp.async,
//     one step of rows prefetched while the previous step computes), so
//     each input row is read about once per strip, with no index clamp
//     and no value clamp in the inner loop.
// Both regimes share one FMA-dense inner loop (`conv`): a thread owns KB =
// 16 consecutive outputs and walks the taps in chunks of KB, holding 2KB-1
// inputs and KB weights in registers: 31 shared loads (plus 4 broadcast
// 16-byte weight loads) for 256 FMAs, 0.14 loads per FMA; the 2r+1 taps
// are padded to whole chunks with zero weights. The H passes map
// lanes to rows of an odd-strided tile and the V passes lanes to adjacent
// columns, so neither pass has bank conflicts. Accumulation is plain fp32
// FMA: TF32 tensor cores would miss the 1.4e-5 parity bar of the JAX
// kernels' 3-pass bf16 split. Weights are built on the device by a tiny
// prep kernel from the same f32 formula as `_gauss_weights`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float F16_MAX = 65504.0f;
constexpr int MAX_LEVELS = 4;
constexpr int KB = 16;          // outputs per thread and taps per chunk
constexpr int NT = 256;         // threads per block, every pass
constexpr int NW = NT / 32;     // warps per block
constexpr int FX = NW * KB;     // tile width of the fused and H passes: one column block per warp
constexpr int HS = FX + 1;      // row stride of the fused rings (odd: no bank conflicts)
constexpr int FSTEP = 32;       // source rows per step of the fused stream, one per lane
constexpr int FROWS = FSTEP / NW;  // staged rows per warp and step
constexpr int FCH = 2;          // 4-column chunks per lane and staged row
constexpr int FSTAGE_MAX = 32 * 4 * FCH - 1;  // widest stage (odd)
constexpr int HROWS = 32;       // rows of a two-pass H tile, one per lane
constexpr int VC = 32;          // columns of a two-pass V strip, one per lane
constexpr int VSTEP = NW * KB;  // output rows of one ring step, KB per warp
constexpr int SMEM_MAX = 232448;  // what one block may use on sm_90
constexpr int NO_RING = 1 << 30;

__device__ __forceinline__ float clamp_f16(float v) {
  return fminf(fmaxf(v, 0.0f), F16_MAX);
}

__host__ __device__ __forceinline__ int padded_taps(int r) {
  return (2 * r + 1 + KB - 1) / KB * KB;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Fused stage geometry: column 0 of the stage is source column x0 -
// col_halo(R), a multiple of 4 left of the tile, so that copies of 4
// columns are 16-byte aligned; the landing rows are the stage width
// rounded up to whole chunks.
__host__ __device__ __forceinline__ int col_halo(int rmax) { return (rmax + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int land_width(int sw) { return (sw + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One level's weights into shared memory, zero past the 2r+1 taps up to tp.
__device__ __forceinline__ void load_weights(float* ws, const float* __restrict__ w, int r,
                                             int tp) {
  for (int i = threadIdx.x; i < tp; i += NT) ws[i] = i <= 2 * r ? w[i] : 0.0f;
}

// acc[k] += sum_{t < tp} w[t] * in(k + t) for k < KB, tp a multiple of KB,
// in(i) = p[((i0 + i) mod ring) * S]. i0 and ring are multiples of KB, so a
// chunk's 2KB-1 inputs lie in two runs of KB entries that do not wrap.
template <int S>
__device__ __forceinline__ void conv(const float* __restrict__ p, int i0, int ring,
                                     const float* __restrict__ w, int tp, float (&acc)[KB]) {
  for (int t0 = 0; t0 < tp; t0 += KB) {
    int i1 = i0 + KB;
    if (i1 >= ring) i1 -= ring;
    const float* a = p + i0 * S;
    const float* b = p + i1 * S;
    float v[2 * KB - 1];
    float wk[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) v[j] = a[j * S];
#pragma unroll
    for (int j = 0; j < KB - 1; ++j) v[KB + j] = b[j * S];
#pragma unroll
    for (int j = 0; j < KB; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + t0 + j);
      wk[j] = q.x;
      wk[j + 1] = q.y;
      wk[j + 2] = q.z;
      wk[j + 3] = q.w;
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int k = 0; k < KB; ++k) acc[k] = fmaf(wk[kk], v[k + kk], acc[k]);
    i0 = i1;
  }
}

// Clamp every staged value to the rgba16f range in place.
__device__ __forceinline__ void clamp_staged(float* s, int count) {
  for (int i = threadIdx.x; i < count; i += NT) s[i] = clamp_f16(s[i]);
}

}  // namespace

// The launch plan, from ops/blur.py: blur_launch_plan (same field order).
struct BlurPlan {
  int nf, fr[MAX_LEVELS], fslot[MAX_LEVELS];      // fused levels: radius, output slot,
  int fring[MAX_LEVELS], fdelay[MAX_LEVELS];      // ring rows, steps from H to V
  int fstrip, sw, fgx, fgy, fsmem;                // strip rows, stage width
  int n2, tr[MAX_LEVELS], tslot[MAX_LEVELS];  // two-pass levels
  int hgx, hgy, hsmem, strip, ring, vgx, vgy, vsmem;
};

namespace {

// One radius group per block: w[t] = exp(-(x*x) / (2 sigma^2)), x = t - r,
// normalised by the sum of all 2r+1 taps.
__global__ void gauss_weights(float* __restrict__ w, int wstride, int r0, int r1, int r2,
                              int r3) {
  __shared__ float part[256];
  const int g = blockIdx.x;
  const int r = g == 0 ? r0 : g == 1 ? r1 : g == 2 ? r2 : r3;
  const int taps = 2 * r + 1;
  const double sigma = r / 2.0;
  const float denom = (float)(2.0 * sigma * sigma);
  float* wg = w + (size_t)g * wstride;
  float s = 0.0f;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    const float x = (float)(t - r);
    const float v = expf(-(x * x) / denom);
    wg[t] = v;
    s += v;
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  const float total = part[0];
  for (int t = threadIdx.x; t < taps; t += blockDim.x) wg[t] = wg[t] / total;
}

// Fused regime. Block: one channel, an FX-column strip of p.fstrip output
// rows, every fused level. The strip's source rows (rows from ys - R,
// columns from x0 - col_halo(R), R the largest fused radius) stream in
// steps of FSTEP rows: the copies of step st + 1 land in `land` while step
// st computes from `stage`. Each step runs every level's H pass over its
// FSTEP new rows (lane <-> row, warp <-> column block) into that level's
// ring of H rows, then the V pass of the FSTEP output rows that the ring
// now covers (the level's delay, p.fdelay, steps behind). Ring entry e of
// level f holds the H output of source row ys - r_f + e, in row e mod
// p.fring[f] (a power of two).
__global__ void __launch_bounds__(NT, 3) blur_fused(
    const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ w,
    int wstride, BlurPlan p, int cpg, int n, int m) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.z, x0 = blockIdx.x * FX, ys = blockIdx.y * p.fstrip;
  const int sw = p.sw, lw = land_width(sw);
  int rmax = 0, tpmax = 0, dmax = 0;
  for (int f = 0; f < p.nf; ++f) {
    rmax = max(rmax, p.fr[f]);
    tpmax = max(tpmax, padded_taps(p.fr[f]));
    dmax = max(dmax, p.fdelay[f]);
  }
  const int cmax = col_halo(rmax);
  float* ws = sm;                        // nf x tpmax weights
  float* land = ws + p.nf * tpmax;       // FSTEP x lw source rows as copied (16-byte aligned)
  float* stage = land + FSTEP * lw;      // FSTEP x sw, clamped, odd stride for the H pass
  float* rings = stage + FSTEP * sw;     // each level's fring x HS H rows
  for (int f = 0; f < p.nf; ++f)
    load_weights(ws + f * tpmax, w + (size_t)p.fslot[f] * wstride, p.fr[f], tpmax);

  // A thread copies rows warp * FROWS + q, 4-column chunks lane + 32 h of
  // each step: one 16-byte copy where the chunk lies inside the row and the
  // row is 16-byte aligned, else four clamped 4-byte copies.
  const float* src = x + (size_t)c * n * m;
  const bool rows16 = (m & 3) == 0 && ((uintptr_t)x & 15) == 0;
  auto fetch = [&](int st) {
#pragma unroll
    for (int q = 0; q < FROWS; ++q) {
      const int row = warp * FROWS + q;
      const float* sr = src + (size_t)clampi(ys - rmax + st * FSTEP + row, 0, n - 1) * m;
#pragma unroll
      for (int h = 0; h < FCH; ++h) {
        const int j = 4 * (lane + 32 * h), c0 = x0 - cmax + j;
        if (j < sw) {
          float* d = land + row * lw + j;
          if (rows16 && c0 >= 0 && c0 + 3 < m) {
            cp_async16(d, sr + c0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async4(d + e, sr + clampi(c0 + e, 0, m - 1));
          }
        }
      }
    }
  };
  // once its own copies have landed, a thread clamps them into the stage
  auto convert = [&]() {
#pragma unroll
    for (int q = 0; q < FROWS; ++q) {
      const int row = warp * FROWS + q;
#pragma unroll
      for (int h = 0; h < FCH; ++h) {
        const int j = 4 * (lane + 32 * h);
        if (j < sw) {
          const float4 v = *reinterpret_cast<const float4*>(land + row * lw + j);
          float* d = stage + row * sw + j;
          d[0] = clamp_f16(v.x);
          if (j + 1 < sw) d[1] = clamp_f16(v.y);
          if (j + 2 < sw) d[2] = clamp_f16(v.z);
          if (j + 3 < sw) d[3] = clamp_f16(v.w);
        }
      }
    }
  };

  const int nob = (min(p.fstrip, n - ys) + FSTEP - 1) / FSTEP;
  const int steps = nob + dmax;
  const int col = threadIdx.x % FX, xx = x0 + col;
  fetch(0);
  cp_async_commit();
  cp_async_wait<0>();
  convert();
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) fetch(st + 1);
    cp_async_commit();
    float* ring = rings;
    for (int f = 0; f < p.nf; ++f) {
      const int r = p.fr[f], tp = padded_taps(r), off = rmax - r, e = st * FSTEP + lane - off;
      if (e >= 0) {
        float acc[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) acc[k] = 0.0f;
        conv<1>(stage + lane * sw + cmax - r + warp * KB, 0, NO_RING, ws + f * tpmax, tp, acc);
        float* d = ring + (e & (p.fring[f] - 1)) * HS + warp * KB;
#pragma unroll
        for (int k = 0; k < KB; ++k) d[k] = fminf(acc[k], F16_MAX);
      }
      ring += p.fring[f] * HS;
    }
    __syncthreads();
    ring = rings;
    for (int f = 0; f < p.nf; ++f) {
      const int ob = st - p.fdelay[f];
      if (ob >= 0 && ob < nob) {
        const int a = ob * FSTEP + threadIdx.x / FX * KB;
        float acc[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) acc[k] = 0.0f;
        conv<HS>(ring + col, a & (p.fring[f] - 1), p.fring[f], ws + f * tpmax,
                 padded_taps(p.fr[f]), acc);
        float* dst = y + ((size_t)(p.fslot[f] * cpg + c) * n + ys + a) * m + xx;
        if (xx < m) {
          if (ys + a + KB <= n) {
#pragma unroll
            for (int k = 0; k < KB; ++k) dst[(size_t)k * m] = acc[k];
          } else {
#pragma unroll
            for (int k = 0; k < KB; ++k)
              if (ys + a + k < n) dst[(size_t)k * m] = acc[k];
          }
        }
      }
      ring += p.fring[f] * HS;
    }
    cp_async_wait<0>();
    if (st + 1 < steps) convert();  // the H pass of step st is done with the stage
    __syncthreads();  // the next step's H reads the stage and rewrites rings
  }
}

// Two-pass regime, H. Block: one (two-pass level, channel) plane, HROWS x FX
// outputs; lane <-> row, warp <-> column block. Output staged back through
// the tile for coalesced stores.
__global__ void __launch_bounds__(NT, 2) blur_h(
    const float* __restrict__ x, float* __restrict__ tmp, const float* __restrict__ w,
    int wstride, BlurPlan p, int cpg, int n, int m) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.z / cpg, c = blockIdx.z - j * cpg;
  const int r = p.tr[j], tp = padded_taps(r);
  const int sw = FX + tp - 1;  // odd
  const int x0 = blockIdx.x * FX, y0 = blockIdx.y * HROWS;
  float* ws = sm;
  float* s = sm + tp;

  const float* src = x + (size_t)c * n * m;
  for (int row = warp; row < HROWS; row += NW) {
    const float* sr = src + (size_t)min(y0 + row, n - 1) * m;
    float* d = s + row * sw;
    for (int col = lane; col < sw; col += 32)
      cp_async4(d + col, sr + clampi(x0 - r + col, 0, m - 1));
  }
  cp_async_commit();
  load_weights(ws, w + (size_t)p.tslot[j] * wstride, r, tp);
  cp_async_wait<0>();
  __syncthreads();
  clamp_staged(s, HROWS * sw);
  __syncthreads();

  float acc[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) acc[k] = 0.0f;
  conv<1>(s + lane * sw + warp * KB, 0, NO_RING, ws, tp, acc);
  __syncthreads();
  float* d = s + lane * sw + warp * KB;
#pragma unroll
  for (int k = 0; k < KB; ++k) d[k] = fminf(acc[k], F16_MAX);
  __syncthreads();
  float* dst = tmp + (size_t)blockIdx.z * n * m;
  for (int row = warp; row < HROWS; row += NW) {
    if (y0 + row >= n) break;
    for (int col = lane; col < FX; col += 32)
      if (x0 + col < m) dst[(size_t)(y0 + row) * m + x0 + col] = s[row * sw + col];
  }
}

// Two-pass regime, V. Block: one plane, a p.strip x VC strip; ring entry i
// holds input row clamp(ys - r + i). Each step computes VSTEP output rows
// (KB per warp, lane <-> column) while the next step's rows land.
__global__ void __launch_bounds__(NT, 2) blur_v(
    const float* __restrict__ tmp, float* __restrict__ y, const float* __restrict__ w,
    int wstride, BlurPlan p, int cpg, int n, int m) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.z / cpg, c = blockIdx.z - j * cpg;
  const int r = p.tr[j], tp = padded_taps(r), ring = 2 * VSTEP + tp;
  const int ys = blockIdx.y * p.strip, xx = blockIdx.x * VC + lane;
  float* ws = sm;
  float* buf = sm + tp;

  const float* src = tmp + (size_t)blockIdx.z * n * m + min(xx, m - 1);
  auto load = [&](int i0, int i1) {
    for (int i = i0 + warp; i < i1; i += NW)
      cp_async4(buf + (i % ring) * VC + lane, src + (size_t)clampi(ys - r + i, 0, n - 1) * m);
  };
  const int steps = (min(p.strip, n - ys) + VSTEP - 1) / VSTEP;
  load(0, VSTEP + tp - 1);
  cp_async_commit();
  load_weights(ws, w + (size_t)p.tslot[j] * wstride, r, tp);
  float* dst = y + (size_t)(p.tslot[j] * cpg + c) * n * m + xx;
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load((st + 1) * VSTEP + tp - 1, (st + 2) * VSTEP + tp - 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int a = st * VSTEP + warp * KB;
    float acc[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[k] = 0.0f;
    conv<VC>(buf + lane, a % ring, ring, ws, tp, acc);
    if (xx < m) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (ys + a + k < n) dst[(size_t)(ys + a + k) * m] = acc[k];
    }
    __syncthreads();  // the next step's loads reuse this step's oldest slots
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The plan as blur_launch_plan computes it, or false.
bool plan_ok(const BlurPlan& p, const int* radii, int levels, int cpg, int n, int m) {
  if (p.nf < 0 || p.n2 < 0 || p.nf + p.n2 != levels) return false;
  bool seen[MAX_LEVELS] = {false, false, false, false};
  for (int f = 0; f < p.nf; ++f) {
    if (p.fslot[f] < 0 || p.fslot[f] >= levels || seen[p.fslot[f]]) return false;
    if (p.fr[f] != radii[p.fslot[f]]) return false;
    seen[p.fslot[f]] = true;
  }
  for (int k = 0; k < p.n2; ++k) {
    if (p.tslot[k] < 0 || p.tslot[k] >= levels || seen[p.tslot[k]]) return false;
    if (p.tr[k] != radii[p.tslot[k]]) return false;
    seen[p.tslot[k]] = true;
  }
  if (p.nf > 0) {
    int rmax = 0, tpmax = 0, reach = 0;
    long rings = 0;
    for (int f = 0; f < p.nf; ++f) {
      rmax = rmax > p.fr[f] ? rmax : p.fr[f];
      tpmax = tpmax > padded_taps(p.fr[f]) ? tpmax : padded_taps(p.fr[f]);
    }
    for (int f = 0; f < p.nf; ++f) {
      const int tp = padded_taps(p.fr[f]), off = rmax - p.fr[f];
      const int need = col_halo(rmax) - p.fr[f] + tp + FX - 1;
      reach = reach > need ? reach : need;
      // the V pass of output block ob runs once H has covered its last entry,
      // and the ring keeps every entry it reads until then
      if (p.fdelay[f] != cdiv(tp - 1 + off, FSTEP)) return false;
      if ((p.fring[f] & (p.fring[f] - 1)) != 0 || p.fring[f] < KB ||
          p.fring[f] < (p.fdelay[f] + 1) * FSTEP - off)
        return false;
      rings += p.fring[f];
    }
    const long smem =
        4L * (p.nf * tpmax + (long)FSTEP * (land_width(p.sw) + p.sw) + rings * HS);
    if (p.fstrip <= 0 || p.fstrip % FSTEP != 0 || p.sw < reach || p.sw % 2 == 0 ||
        p.sw > FSTAGE_MAX || smem != p.fsmem || smem > SMEM_MAX || p.fgx != cdiv(m, FX) ||
        p.fgy != cdiv(n, p.fstrip) || p.fgy > 65535 || cpg > 65535)
      return false;
  }
  if (p.n2 > 0) {
    int tpmax = 0;
    for (int k = 0; k < p.n2; ++k)
      tpmax = tpmax > padded_taps(p.tr[k]) ? tpmax : padded_taps(p.tr[k]);
    const long hsmem = 4L * (tpmax + (long)HROWS * (FX + tpmax - 1));
    const long vsmem = 4L * (tpmax + (long)(2 * VSTEP + tpmax) * VC);
    if (hsmem != p.hsmem || hsmem > SMEM_MAX || vsmem != p.vsmem || vsmem > SMEM_MAX ||
        p.ring != 2 * VSTEP + tpmax || p.hgx != cdiv(m, FX) || p.hgy != cdiv(n, HROWS) ||
        p.hgy > 65535 || p.strip <= 0 || p.strip % VSTEP != 0 || p.vgx != cdiv(m, VC) ||
        p.vgy != cdiv(n, p.strip) || p.vgy > 65535 || p.n2 * cpg > 65535)
      return false;
  }
  return true;
}

cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Blur (cpg, n, m) into y (levels*cpg, n, m) on plan `p`. `tmp` holds the
// two-pass levels' H planes (n2*cpg, n, m; unused when n2 = 0); `wbuf` the
// (levels, wstride) weight table, wstride >= 2*rmax+1.
extern "C" int rr_blur(const float* x, float* tmp, float* y, float* wbuf, int wstride,
                       int r0, int r1, int r2, int r3, int levels, int cpg, int n, int m,
                       const BlurPlan* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int radii[MAX_LEVELS] = {r0, r1, r2, r3};
  const BlurPlan p = *plan;
  if (levels < 1 || levels > MAX_LEVELS || !plan_ok(p, radii, levels, cpg, n, m))
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < levels; ++g)
    if (2 * radii[g] + 1 > wstride) return (int)cudaErrorInvalidValue;

  gauss_weights<<<levels, 256, 0, st>>>(wbuf, wstride, r0, r1, r2, r3);
  cudaError_t e;
  if (p.nf > 0) {
    if ((e = set_smem((const void*)blur_fused, p.fsmem)) != cudaSuccess) return (int)e;
    blur_fused<<<dim3(p.fgx, p.fgy, cpg), NT, p.fsmem, st>>>(x, y, wbuf, wstride, p, cpg, n,
                                                            m);
  }
  if (p.n2 > 0) {
    if ((e = set_smem((const void*)blur_h, p.hsmem)) != cudaSuccess) return (int)e;
    if ((e = set_smem((const void*)blur_v, p.vsmem)) != cudaSuccess) return (int)e;
    blur_h<<<dim3(p.hgx, p.hgy, p.n2 * cpg), NT, p.hsmem, st>>>(x, tmp, wbuf, wstride, p, cpg,
                                                               n, m);
    blur_v<<<dim3(p.vgx, p.vgy, p.n2 * cpg), NT, p.vsmem, st>>>(tmp, y, wbuf, wstride, p, cpg,
                                                               n, m);
  }
  return (int)cudaGetLastError();
}
