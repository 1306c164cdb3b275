// Probe P2: a 24-tap weighted sum of static 2-D offsets, staged with a
// clamp-to-edge halo, as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU probe kernel of tools/prof_nr_slices.py (`pallas_nr`:
// 64-row tiles of an edge-padded copy, 16-row halo strips, 16-row chunks).
// For each pixel: out = 0.5 x + sum_k w_k x[clamp(y + dy_k), clamp(x + dx_k)]
// over the 24 taps in table order, as `slices_plain`
// (rapidraw_tpu_torch/tools/prof_nr_slices.py) computes it. Built with
// --fmad=false, so each product and sum rounds on its own and the result
// can be bit-identical to the plain version.
//
// It is NR's access pattern (csrc/nr.cu) without NR's gate arithmetic: a
// block stages its tile plus a halo of the largest offset in shared memory
// with clamp-to-edge indexing (the scheme of nr.cu, no padded copy in HBM),
// then each thread reads its 24 taps from shared memory. What bounds it on
// the card: HBM (4 bytes read, 4 written per pixel; 49 operations), so the
// question it answers is what the halo staging and the shared-memory taps
// cost above that bound. The tile's height is a runtime parameter (the
// counterpart of the probe's TH/CH choice): a 32x8 tile is nr.cu's, with
// (32 + 2 halo)(8 + 2 halo) staged values for 256 outputs; a taller tile
// stages fewer per output. A 32x8 block of threads serves any height, each
// thread taking every 8th row of the tile.

#include <cuda_runtime.h>

constexpr int NTAPS = 24;

// The tap table, passed by value. Outside any anonymous namespace: the
// extern "C" entry point takes it.
struct SliceTaps {
  int dx[NTAPS], dy[NTAPS];
  float w[NTAPS];
};

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__global__ void __launch_bounds__(BX* BY)
    slices_kernel(const float* __restrict__ x, float* __restrict__ y, const SliceTaps taps,
                  int halo, int tile_rows, int H, int W) {
  extern __shared__ float tile[];
  const int sw = BX + 2 * halo;
  const int sn = sw * (tile_rows + 2 * halo);
  const size_t plane = (size_t)H * W;
  const float* src = x + blockIdx.z * plane;

  // stage the tile plus halo, clamped to the edge
  const int x0 = blockIdx.x * BX - halo;
  const int y0 = blockIdx.y * tile_rows - halo;
  for (int k = threadIdx.y * BX + threadIdx.x; k < sn; k += BX * BY) {
    const int gy = min(max(y0 + k / sw, 0), H - 1);
    const int gx = min(max(x0 + k % sw, 0), W - 1);
    tile[k] = __ldg(src + (size_t)gy * W + gx);
  }
  __syncthreads();

  const int gx = blockIdx.x * BX + threadIdx.x;
  if (gx >= W) return;
  int off[NTAPS];
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) off[t] = taps.dy[t] * sw + taps.dx[t];
  float* dst = y + blockIdx.z * plane;
  for (int ry = threadIdx.y; ry < tile_rows; ry += BY) {
    const int gy = blockIdx.y * tile_rows + ry;
    if (gy >= H) break;
    const int c0 = (ry + halo) * sw + threadIdx.x + halo;
    float acc = tile[c0] * 0.5f;
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) acc = acc + tile[c0 + off[t]] * taps.w[t];
    dst[(size_t)gy * W + gx] = acc;
  }
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The weighted tap sum of C planes of H x W floats; `halo` is the largest
// tap offset. The Python wrapper (`slices`) checks the limits: `tile_rows` a
// multiple of 8 up to 128, under 65536 tiles per column and planes.
extern "C" int rr_nr_slices(const float* x, float* y, const SliceTaps* taps, int halo,
                            int tile_rows, int C, int H, int W, void* stream) {
  dim3 block(BX, BY);
  dim3 grid((W + BX - 1) / BX, (H + tile_rows - 1) / tile_rows, C);
  const size_t smem = (size_t)(BX + 2 * halo) * (tile_rows + 2 * halo) * sizeof(float);
  slices_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(x, y, *taps, halo, tile_rows, H,
                                                             W);
  return (int)cudaGetLastError();
}
