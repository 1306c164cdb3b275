// Probe P1: a long elementwise chain as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU probe kernel of tools/prof_chunked.py (`make_fn`, run
// whole-tile or as a loop over CH-row slices of a 256x512 tile). The chain
// is the probe's `chain`, op for op as `chain_plain`
// (rapidraw_tpu_torch/tools/prof_chunked.py): 8 rounds of mul-add, max 0,
// smoothstep x*x*(3-2x), the select x > 0.5 -> 0.999x, exp2(0.1x) * 0.933,
// 104 operations per element. Built with --fmad=false, so each multiply and
// add rounds on its own as the plain version's PyTorch ops do, and without
// --use_fast_math: exp2f is the accurate one, as torch.exp2 on CUDA is.
//
// What bounds it on the card: HBM in principle (4 bytes read and 4 written
// per element against 104 operations; 0.180 ms for 24 MP at 3.35 TB/s), but
// without contraction every multiply and add is its own instruction, and
// the 8 exp2f go to the special-function units at a quarter of the FP32
// rate, so instruction issue may come close to the bytes.
//
// The design: the (..., W) tensor is taken as rows of W columns; a thread
// owns `rows` rows of one column (rows = 1: one thread per element, the
// counterpart of the probe's whole-tile variant; rows = CH: the CH-row
// chunk, more independent work per thread instead of more threads). A warp
// covers 32 neighbouring columns, so every load and store is coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // columns per block
constexpr int ROUNDS = 8;

__device__ __forceinline__ float chain(float x) {
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    x = x * 1.0001f + 0.0001f;
    x = x < 0.0f ? 0.0f : x;  // clamp_min: NaN passes through
    x = x * x * (3.0f - 2.0f * x);
    x = x > 0.5f ? x * 0.999f : x;
    x = exp2f(x * 0.1f) * 0.933f;
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
    chain_kernel(const float* __restrict__ x, float* __restrict__ y, int nrows, int width,
                 int rows) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= width) return;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(r0 + rows, nrows);
  // unrolled by 4: four independent loads in flight and four chains
  // interleaved per thread
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * width + col;
    y[i] = chain(__ldg(x + i));
  }
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The chain over nrows x width floats, `rows` rows per thread. The Python
// wrapper (`chain`) checks the limits: 1..64 rows, under 65536 row groups.
extern "C" int rr_chain(const float* x, float* y, int nrows, int width, int rows,
                        void* stream) {
  dim3 grid((width + THREADS - 1) / THREADS, (nrows + rows - 1) / rows);
  chain_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, nrows, width, rows);
  return (int)cudaGetLastError();
}
