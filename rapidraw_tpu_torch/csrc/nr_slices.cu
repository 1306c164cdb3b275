// Probe P2: a 24-tap weighted sum of static 2-D offsets with clamp-to-edge
// indexing, as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU probe kernel of tools/prof_nr_slices.py (`pallas_nr`:
// 64-row tiles of an edge-padded copy, 16-row halo strips, 16-row chunks).
// For each pixel: out = 0.5 x + sum_k w_k x[clamp(y + dy_k), clamp(x + dx_k)]
// over the 24 taps in table order, as `slices_plain`
// (rapidraw_tpu_torch/tools/prof_nr_slices.py) computes it. Built with
// --fmad=false, so each product and sum rounds on its own and the result is
// bit-identical to the plain version.
//
// What bounds it on the card: HBM (4 bytes read, 4 written per pixel; 49
// operations). A design that reads one value per tap from shared memory
// moves 100 bytes of shared traffic per output, more than the HBM bound
// allows for, so this one reads each input row once per thread:
// - A thread owns 4 adjacent columns (one 16-byte vector) and walks down a
//   band of rows. The x offsets {0, +-4, +-7} of its 4 columns fall inside
//   the five vectors at x0 - 8 .. x0 + 8 of a row, its window: one input row
//   gives all 20 horizontal taps of each output row that reads it.
// - Each input row i is scattered into the accumulators of the output rows
//   that read it (i + 7, i + 4, i, i - 4, i - 7). Input rows come in
//   increasing order and the table is sorted by dy, so each output's terms
//   arrive in the plain version's tap order; its 0.5 x term is taken from
//   the staged row i + 7 when its first row arrives. The 15 output rows in
//   flight are a ring of 15 x 4 accumulators in registers; the steps are
//   unrolled by the ring's period, so every index is static.
// - Virtual rows above 0 and below H - 1 are the clamped edge rows, each
//   scattered as its own row; bands of any height, and H below the halo,
//   need no other path.
// - A block of 512 threads (2048 columns plus 8 each side, one block and
//   16 warps per SM at 127 registers) stages its input rows in a ring of 15
//   rows in dynamic shared memory with cp.async, fetched 7 to 14 steps ahead
//   of their use, so loads overlap the arithmetic of the steps before them;
//   each thread reads its window as five 16-byte shared loads (24 bytes of
//   shared traffic per output instead of 100). Trials on the card: 8 KB
//   contiguous per row and block beat 2 KB and 4 KB (128- and 256-thread
//   blocks, 4 and 2 per SM), and a deeper ring did not help. A block
//   inside the image with aligned rows (W % 4 == 0) makes one 16-byte copy
//   per thread and row, with no clamp; the blocks at the image's edges and
//   other widths take the edge path of the same kernel: 16-byte copies
//   where a chunk lies inside an aligned row, else four 4-byte copies of
//   clamped columns (no plain fallback).
// - The tap table is compile-time (TAP_DX, TAP_DY below); the wrapper holds
//   it against the Python table (rr_nr_slices_taps) and passes the weights.
// - The wrapper's plan picks the band height so that the grid is about one
//   wave of resident blocks (rr_nr_slices_blocks_per_sm).

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

constexpr int NTAPS = 24;

// The weights in table order, passed by value. Outside any anonymous
// namespace: the extern "C" entry point takes it.
struct SliceWeights {
  float w[NTAPS];
};

namespace {

// The taps (dx, dy) in table order: rapidraw_tpu_torch/tools OFFSETS.
constexpr int TAP_DX[NTAPS] = {-7, -4, 0, 4, 7, -7, -4, 0, 4, 7, -7, -4,
                               4,  7,  -7, -4, 0, 4, 7, -7, -4, 0, 4, 7};
constexpr int TAP_DY[NTAPS] = {-7, -7, -7, -7, -7, -4, -4, -4, -4, -4, 0, 0,
                               0,  0,  4,  4,  4,  4,  4,  7,  7,  7,  7, 7};
constexpr int HALO = 7;             // the largest |offset|
constexpr int RING = 2 * HALO + 1;  // output rows in flight, and staged input rows
constexpr int COLS = 4;             // adjacent columns per thread: one vector
constexpr int PAD = 8;              // staged columns on each side: HALO in whole vectors
constexpr int WIN = COLS + 2 * PAD;  // a thread's window of one row: 5 vectors
constexpr int THREADS = 512;
constexpr int ROWF = COLS * THREADS + 2 * PAD;  // floats of one staged row
constexpr int CHUNKS = ROWF / 4;                // its 16-byte chunks
constexpr int SMEM = RING * ROWF * sizeof(float);  // the staged ring, dynamic
constexpr int IN_FLIGHT = RING - 2 - HALO;      // row copies a step leaves pending

// the order proof's premises: every tap inside the halo and the window, and
// dy never decreasing along the table (input rows arrive in increasing order)
constexpr bool table_in_row_order() {
  for (int k = 0; k < NTAPS; ++k) {
    if (TAP_DX[k] < -HALO || TAP_DX[k] > HALO || TAP_DY[k] < -HALO || TAP_DY[k] > HALO)
      return false;
    if (k > 0 && TAP_DY[k] < TAP_DY[k - 1]) return false;
  }
  return true;
}
static_assert(table_in_row_order(), "taps must lie within HALO and be sorted by dy");
static_assert(HALO <= PAD && PAD % 4 == 0, "the window must hold the halo in whole vectors");

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Band {
  const float* src;  // this plane of the input
  float* dst;        // and of the output
  float* ring;       // RING staged rows of ROWF floats
  int H, W;
  int x0;    // the block's first column
  int y0;    // the band's first output row
  int rows;  // its output rows
  int steps;  // input rows it reads: rows + 2 HALO
  bool vec;    // 16-byte copies and stores (W % 4 == 0, aligned pointers)
  bool inner;  // vec, and the staged columns lie inside the image
};

// Stage virtual row v (clamped to the image) of the block's columns
// x0 - PAD .. x0 + COLS THREADS + PAD - 1 (clamped) into one ring row.
__device__ __forceinline__ void stage_row(const Band& b, float* row, int v) {
  const float* src = b.src + (size_t)min(max(v, 0), b.H - 1) * b.W;
  if (b.inner) {  // one 16-byte copy per thread, and the last CHUNKS - THREADS
    const int q = threadIdx.x;
    cp16(row + 4 * q, src + b.x0 - PAD + 4 * q);
    if (q < CHUNKS - THREADS)
      cp16(row + 4 * (q + THREADS), src + b.x0 - PAD + 4 * (q + THREADS));
    return;
  }
  for (int q = threadIdx.x; q < CHUNKS; q += THREADS) {
    const int g = b.x0 - PAD + 4 * q;
    if (b.vec && g >= 0 && g + 4 <= b.W) {
      cp16(row + 4 * q, src + g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp4(row + 4 * q + e, src + min(max(g + e, 0), b.W - 1));
    }
  }
}

// Tap K of input row u (ring step J = u % RING) into the output row that
// reads it: output p = u + dy_min - dy, whose accumulators sit in slot p % RING.
// `win` is this thread's window of the row (WIN floats from x0 - PAD).
template <int J, int K, class Window>
__device__ __forceinline__ void tap(float (&acc)[RING][COLS], const Window& win,
                                    const SliceWeights& w) {
  constexpr int dx = TAP_DX[K], dy = TAP_DY[K];
  constexpr int slot = (J + RING - HALO - dy) % RING;
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[slot][c] = acc[slot][c] + win[PAD + c + dx] * w.w[K];
}

// Every tap of staged row `row` (this thread's window), in table order.
template <int J, int... K>
__device__ __forceinline__ void scatter(float (&acc)[RING][COLS], const float* row,
                                        const SliceWeights& w, std::integer_sequence<int, K...>) {
  float win[WIN];
#pragma unroll
  for (int m = 0; m < WIN / 4; ++m) {
    const float4 q = *reinterpret_cast<const float4*>(row + 4 * m);
    win[4 * m] = q.x;
    win[4 * m + 1] = q.y;
    win[4 * m + 2] = q.z;
    win[4 * m + 3] = q.w;
  }
  (tap<J, K>(acc, win, w), ...);
}

// Step u (u % RING == J): input row y0 - HALO + u, which starts output row
// y0 + u and ends output row y0 + u - 2 HALO.
template <int J>
__device__ __forceinline__ void step(const Band& b, float (&acc)[RING][COLS],
                                     const SliceWeights& w, int u) {
  cp_wait<IN_FLIGHT>();  // rows up to u + HALO have landed
  __syncthreads();       // for every thread, and row u - 1 is no longer read
  if (u + RING - 1 < b.steps) stage_row(b, b.ring + (J + RING - 1) % RING * ROWF,
                                        b.y0 - HALO + u + RING - 1);
  cp_commit();
  const float* row = b.ring + J * ROWF + COLS * threadIdx.x;
  if (u < b.rows) {  // 0.5 x of output row y0 + u: the centre of staged row u + HALO
    const float4 c = *reinterpret_cast<const float4*>(
        b.ring + (J + HALO) % RING * ROWF + COLS * threadIdx.x + PAD);
    acc[J][0] = c.x * 0.5f;
    acc[J][1] = c.y * 0.5f;
    acc[J][2] = c.z * 0.5f;
    acc[J][3] = c.w * 0.5f;
  }
  scatter<J>(acc, row, w, std::make_integer_sequence<int, NTAPS>{});
  const int gx = b.x0 + COLS * threadIdx.x;
  constexpr int done = (J + 1) % RING;
  if (u >= 2 * HALO && gx < b.W) {  // output row y0 + u - 2 HALO is complete
    float* out = b.dst + (size_t)(b.y0 + u - 2 * HALO) * b.W + gx;
    if (b.vec) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[done][0], acc[done][1], acc[done][2], acc[done][3]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (gx + c < b.W) out[c] = acc[done][c];
    }
  }
}

template <int... J>
__device__ __forceinline__ void steps(const Band& b, float (&acc)[RING][COLS],
                                      const SliceWeights& w, int u0,
                                      std::integer_sequence<int, J...>) {
  ((u0 + J < b.steps && (step<J>(b, acc, w, u0 + J), true)) && ...);
}

__global__ void __launch_bounds__(THREADS, 1)
    slices_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const __grid_constant__ SliceWeights w,
                  int band, int H, int W, int vec) {
  extern __shared__ __align__(16) float ring[];
  const size_t plane = (size_t)H * W;
  Band b;
  b.src = x + blockIdx.z * plane;
  b.dst = y + blockIdx.z * plane;
  b.ring = ring;
  b.H = H;
  b.W = W;
  b.x0 = blockIdx.x * (COLS * THREADS);
  b.y0 = blockIdx.y * band;
  b.rows = min(band, H - b.y0);
  b.steps = b.rows + 2 * HALO;
  b.vec = vec != 0;
  b.inner = b.vec && b.x0 >= PAD && b.x0 + ROWF - PAD <= W;
#pragma unroll
  for (int u = 0; u < RING - 1; ++u) {  // steps >= RING: every prologue row is read
    stage_row(b, ring + u * ROWF, b.y0 - HALO + u);
    cp_commit();
  }
  float acc[RING][COLS] = {};
  for (int u0 = 0; u0 < b.steps; u0 += RING)
    steps(b, acc, w, u0, std::make_integer_sequence<int, RING>{});
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The compiled tap table, for the wrapper to hold against its own: writes
// NTAPS offsets to each of dx and dy and returns NTAPS.
extern "C" int rr_nr_slices_taps(int* dx, int* dy) {
  for (int k = 0; k < NTAPS; ++k) {
    dx[k] = TAP_DX[k];
    dy[k] = TAP_DY[k];
  }
  return NTAPS;
}

// The ring passes the 48 KB a kernel gets without asking.
static cudaError_t allow_smem() {
  return cudaFuncSetAttribute(slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

// Blocks of the kernel resident on one SM (the wrapper's plan sizes its
// bands from it); returns a cudaError_t.
extern "C" int rr_nr_slices_blocks_per_sm(int* blocks) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, slices_kernel, THREADS, SMEM);
}

// The weighted tap sum of C planes of H x W floats, in bands of `band` rows
// and 4 THREADS columns (the wrapper's `slices_launch_plan`); `vec` asks for
// 16-byte copies and stores, and needs W % 4 == 0 and 16-byte aligned x, y.
extern "C" int rr_nr_slices(const float* x, float* y, const SliceWeights* w, int band, int C,
                            int H, int W, int vec, void* stream) {
  if (band < 1 || C < 1 || H < 1 || W < 1 || (H + band - 1) / band >= 65536 || C >= 65536 ||
      (vec && (W % 4 || (uintptr_t)x % 16 || (uintptr_t)y % 16)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + COLS * THREADS - 1) / (COLS * THREADS), (H + band - 1) / band, C);
  slices_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(x, y, *w, band, H, W, vec);
  return (int)cudaGetLastError();
}
