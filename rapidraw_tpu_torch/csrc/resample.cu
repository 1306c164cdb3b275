// One pass of the planned two-pass warp as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel B6 (rapidraw_tpu/geometry/warp_fast.py
// `_resample_rows`): a 1-D row resample of (C, R, L) planar data. Output
// pixel (r, x) of the padded (C, nty*TH, ntx*TW) grid lerps source rows
// k = 8*base(half tile) - pad_lo + (r mod TH) + floor(e[r, x]) and k + 1 of
// column x with frac = e - floor(e): s0 + frac * (s1 - s0), exactly as
// `resample_rows_plain` (rapidraw_tpu_torch/geometry/warp_fast.py) does;
// built with --fmad=false so the product and the sum round apart. Rows
// outside [0, R) read as 0 (the TPU kernel's zero padding, without a
// padded copy), so the planner's sentinel e = -1e6 gives exactly 0. The
// horizontal pass runs the same kernel on the transposed intermediate.
//
// What bounds it on the card: HBM bytes (per pixel: e read once, two
// source rows read and one value written per channel; ~0 flops). The
// design: one thread per output column x and row r, looping over the
// channels so e and the base load once; threads of a warp take
// neighbouring x, so every load and store is coalesced and the two source
// rows of a tile overlap in L1/L2. The TPU kernel's shift-and-select loop
// over the span and its per-half-tile trip counts exist because Mosaic
// cannot gather; here the row index is computed directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;    // plan tile rows
constexpr int TWH = 128;  // plan half-tile width: one base per half tile
constexpr int BX = 128;
constexpr int BY = 2;

__global__ void __launch_bounds__(BX* BY)
    resample_kernel(const float* __restrict__ img, const float* __restrict__ e,
                    const int* __restrict__ bases, float* __restrict__ out, int C, int R,
                    int HP, int WP, int pad_lo, int nhx) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (x >= WP || r >= HP) return;
  const float ev = __ldg(e + (size_t)r * WP + x);
  const float e0 = floorf(ev);
  const float frac = ev - e0;
  const int64_t k0 = (int64_t)__ldg(bases + (r / TH) * nhx + x / TWH) * 8 - pad_lo + (r % TH) +
                     (int64_t)e0;
  const bool ok0 = k0 >= 0 && k0 < R;
  const bool ok1 = k0 + 1 >= 0 && k0 + 1 < R;
  for (int c = 0; c < C; ++c) {
    const float* src = img + (size_t)c * R * WP + x;
    const float s0 = ok0 ? __ldg(src + (size_t)k0 * WP) : 0.0f;
    const float s1 = ok1 ? __ldg(src + (size_t)(k0 + 1) * WP) : 0.0f;
    out[((size_t)c * HP + r) * WP + x] = s0 + frac * (s1 - s0);
  }
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// img (C, R, WP), e (HP, WP) float32, bases (HP/TH, nhx) int32 stored / 8,
// out (C, HP, WP). nhx = WP / TWH half tiles per tile row.
extern "C" int rr_resample_rows(const float* img, const float* e, const int* bases, float* out,
                                int C, int R, int HP, int WP, int pad_lo, int nhx,
                                void* stream) {
  if (HP % TH != 0 || WP != nhx * TWH) return (int)cudaErrorInvalidValue;
  dim3 block(BX, BY);
  dim3 grid((WP + BX - 1) / BX, (HP + BY - 1) / BY);
  resample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, e, bases, out, C, R, HP, WP,
                                                            pad_lo, nhx);
  return (int)cudaGetLastError();
}
