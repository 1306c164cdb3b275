// Separable truncated-Gaussian blur pyramid for Hopper (sm_90a).
//
// Replaces the TPU kernels B1 and B2 of rapidraw_tpu/ops/blur.py:
// `_blur_axis` (_make_kernel, one radius) and `_blur_axis_multi`
// (_make_multi_kernel, up to four radii in one launch per axis). Same
// semantics as blur.wgsl and `gaussian_blur_reference`: sigma = r/2, taps
// -r..r normalised by their sum, clamp-to-edge sampling, inputs clamped to
// [0, 65504] (the rgba16f range) as they are loaded.
//
// Layout: input (C, N, M) f32; output channel co = g*C + c holds source
// channel c blurred with radius group g (L = 1 is B1). One H launch fans
// the C source channels out to L*C planes, one V launch blurs each plane
// with its group's radius. Clamp-to-edge is index arithmetic per axis, so
// there is no host-side pad: per-axis index clamping of a separable blur is
// exactly the 2D edge-padded result of the reference.
//
// What bounds it on the card: HBM bandwidth at small radii (one read and one
// write of every plane per pass), fp32 FMA issue at large radii (r = 152 at
// 24 MP is 305 taps a pass). The design keeps both passes FMA-dense:
//   * each thread produces K consecutive outputs and walks the taps in
//     chunks of K, holding 2K-1 inputs and K weights in registers, so a
//     chunk costs 3K-1 loads for K*K FMAs (the TPU version's 128x128 band
//     blocks on the MXU become register blocking on the FP32 pipes);
//   * the H pass stages one row segment plus its 2r halo in shared memory;
//     K = 7 is odd, so the per-thread stride hits 32 distinct banks;
//   * the V pass reads straight from global memory with threads along W,
//     so every load of a warp is one coalesced 128-byte row segment;
//   * accumulation is plain fp32 FMA. TF32 tensor cores would miss the
//     1.4e-5 parity bar of the JAX kernels' 3-pass bf16 split.
// Weights are built on the device by a tiny prep kernel from the same f32
// formula as `_gauss_weights`, so no host upload (and no stream sync)
// happens per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float F16_MAX = 65504.0f;
constexpr int MAX_LEVELS = 4;
constexpr int KH = 7;    // outputs per thread, H pass
constexpr int TH = 128;  // threads per block, H pass
constexpr int KV = 16;   // outputs per thread, V pass
constexpr int TV = 128;  // threads per block, V pass

struct Radii {
  int r[MAX_LEVELS];
};

__device__ __forceinline__ float clamp_f16(float v) {
  return fminf(fmaxf(v, 0.0f), F16_MAX);
}

__host__ __device__ __forceinline__ int round_up(int a, int k) {
  return (a + k - 1) / k * k;
}

// One block per radius group: w[t] = exp(-(x*x) / (2 sigma^2)), x = t - r,
// normalised by the sum of all 2r+1 taps.
__global__ void gauss_weights(float* __restrict__ w, int wstride, Radii radii) {
  __shared__ float part[256];
  const int g = blockIdx.x;
  const int r = radii.r[g];
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

// Horizontal pass. Block: one row of one output channel, TH*KH outputs.
__global__ void __launch_bounds__(TH) blur_h(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w, int wstride, Radii radii, int cpg, int n, int m) {
  extern __shared__ float sm[];
  const int co = blockIdx.z;
  const int g = co / cpg;
  const int ci = co % cpg;  // the H pass fans source channels out to groups
  const int r = radii.r[g];
  const int taps = 2 * r + 1;
  const int tp = round_up(taps, KH);
  const int row = blockIdx.y;
  const int x0 = blockIdx.x * (TH * KH);
  const int tile = TH * KH + tp;
  float* ws = sm;
  float* s = sm + tp;

  for (int i = threadIdx.x; i < tp; i += TH)
    ws[i] = i < taps ? w[(size_t)g * wstride + i] : 0.0f;
  const float* src = x + ((size_t)ci * n + row) * m;
  for (int i = threadIdx.x; i < tile; i += TH) {
    const int xx = min(max(x0 - r + i, 0), m - 1);
    s[i] = clamp_f16(src[xx]);
  }
  __syncthreads();

  float acc[KH];
#pragma unroll
  for (int k = 0; k < KH; ++k) acc[k] = 0.0f;
  const int base = threadIdx.x * KH;
  for (int t0 = 0; t0 < tp; t0 += KH) {
    float v[2 * KH - 1];
    float wk[KH];
#pragma unroll
    for (int j = 0; j < 2 * KH - 1; ++j) v[j] = s[base + t0 + j];
#pragma unroll
    for (int j = 0; j < KH; ++j) wk[j] = ws[t0 + j];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
#pragma unroll
      for (int k = 0; k < KH; ++k) acc[k] = fmaf(wk[kk], v[k + kk], acc[k]);
  }
  __syncthreads();  // stage outputs through shared memory for coalesced stores
#pragma unroll
  for (int k = 0; k < KH; ++k) s[base + k] = acc[k];
  __syncthreads();
  float* dst = y + ((size_t)co * n + row) * m;
  for (int i = threadIdx.x; i < TH * KH; i += TH)
    if (x0 + i < m) dst[x0 + i] = s[i];
}

// Vertical pass. Block: TV columns x KV consecutive rows of one channel;
// threads run along W so each load of a warp is one coalesced row segment.
__global__ void __launch_bounds__(TV) blur_v(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w, int wstride, Radii radii, int cpg, int n, int m) {
  extern __shared__ float ws[];
  const int co = blockIdx.z;
  const int g = co / cpg;
  const int r = radii.r[g];
  const int taps = 2 * r + 1;
  const int tp = round_up(taps, KV);
  for (int i = threadIdx.x; i < tp; i += TV)
    ws[i] = i < taps ? w[(size_t)g * wstride + i] : 0.0f;
  __syncthreads();

  const int col = blockIdx.y * TV + threadIdx.x;
  const int y0 = blockIdx.x * KV;
  if (col >= m) return;
  const float* src = x + (size_t)co * n * m + col;
  float acc[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) acc[k] = 0.0f;
  for (int t0 = 0; t0 < tp; t0 += KV) {
    float v[2 * KV - 1];
    float wk[KV];
#pragma unroll
    for (int j = 0; j < 2 * KV - 1; ++j) {
      const int yy = min(max(y0 - r + t0 + j, 0), n - 1);
      v[j] = clamp_f16(__ldg(src + (size_t)yy * m));
    }
#pragma unroll
    for (int j = 0; j < KV; ++j) wk[j] = ws[t0 + j];
#pragma unroll
    for (int kk = 0; kk < KV; ++kk)
#pragma unroll
      for (int k = 0; k < KV; ++k) acc[k] = fmaf(wk[kk], v[k + kk], acc[k]);
  }
  float* dst = y + (size_t)co * n * m + col;
#pragma unroll
  for (int k = 0; k < KV; ++k)
    if (y0 + k < n) dst[(size_t)(y0 + k) * m] = acc[k];
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Blur (cpg, n, m) into (L*cpg, n, m). `tmp` holds the H-pass planes
// (L*cpg, n, m); `wbuf` the (L, wstride) weight table, wstride >= 2*rmax+1.
extern "C" int rr_blur_multi(const float* x, float* tmp, float* y, float* wbuf,
                             int wstride, int r0, int r1, int r2, int r3, int levels,
                             int cpg, int n, int m, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Radii radii = {{r0, r1, r2, r3}};
  int rmax = 0;
  for (int g = 0; g < levels; ++g) rmax = radii.r[g] > rmax ? radii.r[g] : rmax;
  const int cout = levels * cpg;

  gauss_weights<<<levels, 256, 0, st>>>(wbuf, wstride, radii);

  const int tph = round_up(2 * rmax + 1, KH);
  const size_t smem_h = sizeof(float) * (size_t)(tph + TH * KH + tph);
  if (smem_h > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(blur_h, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_h);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 gh((m + TH * KH - 1) / (TH * KH), n, cout);
  blur_h<<<gh, TH, smem_h, st>>>(x, tmp, wbuf, wstride, radii, cpg, n, m);

  const size_t smem_v = sizeof(float) * (size_t)round_up(2 * rmax + 1, KV);
  if (smem_v > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(blur_v, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_v);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 gv((n + KV - 1) / KV, (m + TV - 1) / TV, cout);
  blur_v<<<gv, TV, smem_v, st>>>(tmp, y, wbuf, wstride, radii, cpg, n, m);
  return (int)cudaGetLastError();
}
