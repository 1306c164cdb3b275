// The planned two-pass geometry warp as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel B6 (rapidraw_tpu/geometry/warp_fast.py
// `_resample_rows`, both of its calls in `warp_with_plan`) and the glue
// around them: the zero pad, the vertical pass, the transposes of the
// intermediate, the horizontal pass, the channel-set order, the crop and the
// post gain, in one launch for every channel set and the whole batch. It
// computes what `warp_with_plan_plain` (rapidraw_tpu_torch/geometry/
// warp_fast.py) computes, bit for bit: a pass maps output (i, j) to
// s0 + frac * (s1 - s0) of rows k0 = 8 * base(half tile) - pad_lo +
// (i mod TH) + floor(e[i, j]) and k0 + 1 of its source at column j, with
// frac = e - floor(e), rows outside the source reading 0; built with
// --fmad=false so the product and the sum round apart, as the plain
// version's PyTorch ops do.
//
// out[c, y, x] is the horizontal pass at transposed position (i = x, j = y):
// it lerps intermediate columns k and k + 1 of row y, its base from
// bh[x / TH, y / TWH]. The intermediate tmp[c, y, k] is the vertical pass
// at (y, k) on the unpadded source, zero outside [0, H) x [0, W) (the
// plain version's zero pad). A block writes one output tile of TH columns
// x by ROWS rows y, which lies in one horizontal half tile and so shares
// one base kb, and one tile row of the vertical pass. Its lanes read
// intermediate columns kb .. kb + TH + span - 1 only, and in a smooth map
// about TH of them: the block reads its tile of `eh` ((WP, HP),
// x-major) along y into shared memory, takes the window of columns its
// lanes read from it, stages the vertical pass there (two source rows per
// value, read along k), then lerps from shared memory and writes along x,
// every access coalesced. A lane whose columns lie outside the plan's TH +
// span (the planner's sentinel e) computes them from the source directly,
// the same way.
//
// What bounds it on the card: HBM bytes (the image and the e-maps read once,
// the post gain read once where the plan has it, the output written once;
// a few operations a pixel). The intermediate never reaches device memory;
// the window makes the vertical pass's recomputation across neighbouring
// tiles small. A block resamples up to `group` planes of one set (channels
// x batch) on one set of indices, so the e-maps and the index arithmetic
// serve several planes; the planes' groups of one tile are neighbouring
// blocks, so the e-maps come from L2 the second time. Sets go on grid z,
// row tiles on y, (tile column, group) on x. The loads are the latency to
// hide: each thread stages U values at once, and the register cap holds
// MIN_BLOCKS blocks an SM (PERF.md §6: PR 17's design trials).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int TH = 32;             // plan tile rows: a block's columns x
constexpr int TWH = 128;           // plan half tile: one base per TWH
constexpr int NT = 256;            // threads per block
constexpr int ROWS = 32;           // a block's output rows y
constexpr int U = 3;               // intermediate values a thread stages at once
constexpr int MIN_BLOCKS = 6;      // blocks an SM holds: at most 40 registers
static_assert(ROWS == TH, "a block's rows are one tile row of the vertical pass");
constexpr int MAX_SPAN = 128;      // the planner's largest span
constexpr int MAX_SETS = 3;        // channel sets of a plan (TCA: three)
constexpr int MAX_GROUP = 3;       // planes one block resamples
constexpr int SMEM_MAX = 232448;   // shared memory one block may use on sm_90
constexpr int SMEM_DEFAULT = 48 * 1024;

}  // namespace

// The launch plan (geometry/warp_fast.py `warp_launch_plan`, field for
// field), outside the unnamed namespace: rr_warp takes it from the host.
// One channel set: its planes (batch x channels, in the plain version's
// order b * nc + j), split into `ngroups` groups of up to `group` planes.
struct WarpSet {
  int planes;
  int nc;
  int ch[3];   // the image channel of each of the set's channels
  int group;
  int ngroups;
  int pad_v;   // zero rows before the source, vertical pass
  int pad_h;   // horizontal pass
  int span_h;  // the horizontal pass's span
  int sw;      // the most staged intermediate columns: TH + span_h
};

struct WarpPlan {
  int nsets;
  int group;    // the largest group of any set (the build)
  int ngroups;  // the most groups of any set (grid x = column tiles x ngroups)
  int rows;     // output rows y of a block: ROWS
  int sw_max;
  int smem;
  int gx;
  int gy;
  int gz;
  int b;
  int h;
  int w;
  int hp;
  int wp;
  WarpSet set[MAX_SETS];
};

struct WarpPtrs {
  const float* ev[MAX_SETS];  // (HP, WP) vertical e-map
  const int* bv[MAX_SETS];    // (HP / TH, WP / TWH) vertical bases / 8
  const float* eh[MAX_SETS];  // (WP, HP) horizontal e-map
  const int* bh[MAX_SETS];    // (WP / TH, HP / TWH) horizontal bases / 8
};

namespace {

// floor(e) as a row count; past +-2^30 the rows it names lie outside any
// source either way, so the clamp leaves every result as it was
__device__ __forceinline__ int row_steps(float e0) {
  return (int)fminf(fmaxf(e0, -1073741824.0f), 1073741824.0f);
}

// The vertical pass at intermediate pixel (y, k) of one plane; 0 outside
// the source's columns (the zero pad, and the horizontal pass's rows past
// the intermediate).
__device__ __forceinline__ float vertical(const float* __restrict__ plane,
                                          const float* __restrict__ ev,
                                          const int* __restrict__ bv, int y, int k, int H,
                                          int W, int WP, int pad_v) {
  if (k < 0 || k >= W) return 0.0f;
  const float e = __ldg(ev + (size_t)y * WP + k);
  const float e0 = floorf(e);
  const float frac = e - e0;
  const int k0 =
      __ldg(bv + (y / TH) * (WP / TWH) + k / TWH) * 8 - pad_v + y % TH + row_steps(e0);
  const float s0 = (k0 >= 0 && k0 < H) ? __ldg(plane + (size_t)k0 * W + k) : 0.0f;
  const float s1 = (k0 >= -1 && k0 < H - 1) ? __ldg(plane + (size_t)(k0 + 1) * W + k) : 0.0f;
  return s0 + frac * (s1 - s0);
}

template <int G>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    warp_kernel(const float* __restrict__ img, const float* __restrict__ post,
                float* __restrict__ out, const __grid_constant__ WarpPlan p,
                const __grid_constant__ WarpPtrs q) {
  extern __shared__ float smem[];
  const int z = blockIdx.z;
  const WarpSet& s = p.set[z];
  const int grp = blockIdx.x % p.ngroups;
  if (grp >= s.ngroups) return;
  const float* __restrict__ ev = q.ev[z];
  const int* __restrict__ bv = q.bv[z];
  const int H = p.h, W = p.w, WP = p.wp, sw = s.sw;
  const int xt = blockIdx.x / p.ngroups;
  const int x0 = xt * TH, y0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  __shared__ int vb_s[3];
  __shared__ int win_s[NT / 32][2];
  float* eh_s = smem;                     // [TH][ROWS + 1]: the tile's e, x-major
  float* stage = smem + TH * (ROWS + 1);  // [G][ROWS][<= sw]: the intermediate

  // the group's planes; a short group's spare slots repeat its last plane
  // and are neither computed nor written
  const int first = grp * s.group;
  const int gn = min(s.group, s.planes - first);
  const size_t hw = (size_t)H * W;
  int plane[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int cg = first + min(g, gn - 1);
    const int b = cg / s.nc;
    plane[g] = b * 3 + s.ch[cg - b * s.nc];
  }

  // 1. the tile's horizontal e, read along y (eh is x-major), and the
  //    horizontal base kb of the tile's half tile; the vertical bases of the
  //    block's rows (one tile row of the vertical pass) at the half tiles
  //    its staged columns may cross: three at most, as sw <= TH + MAX_SPAN
  const float* __restrict__ eh = q.eh[z];
  const int kb = __ldg(q.bh[z] + xt * (p.hp / TWH) + y0 / TWH) * 8 - s.pad_h;
  int lo = INT_MAX, hi = -1;  // the tile's staged columns (from kb) its lanes read
#pragma unroll
  for (int j = 0; j < TH * ROWS / NT; ++j) {
    const int i = tid + j * NT;
    const int xl = i / ROWS, yl = i % ROWS;
    const bool inside = x0 + xl < W && y0 + yl < H;
    const float e = inside ? __ldg(eh + (size_t)(x0 + xl) * p.hp + y0 + yl) : 0.0f;
    eh_s[xl * (ROWS + 1) + yl] = e;
    const int l = xl + row_steps(floorf(e));
    if (inside && l >= 0 && l + 1 < sw) {
      lo = min(lo, l);
      hi = max(hi, l);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) {
    win_s[tid >> 5][0] = lo;
    win_s[tid >> 5][1] = hi;
  }
  const int hx0 = max(kb, 0) / TWH;
  if (tid < 3)
    vb_s[tid] = hx0 + tid < WP / TWH ? __ldg(bv + (y0 / TH) * (WP / TWH) + hx0 + tid) : 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    lo = min(lo, win_s[w][0]);
    hi = max(hi, win_s[w][1]);
  }
  // the window: intermediate columns kb + lo .. kb + hi + 1, `wn` of them
  // (none where every lane of the tile reads past the staged columns)
  const int wn = hi >= lo ? hi + 2 - lo : 0;
  const int kw = kb + lo;

  // 2. the vertical pass at rows y0 .. y0 + ROWS - 1 and the window's
  //    columns, for every plane of the group, threads along k; U values a
  //    thread at once, so their loads are in flight together
  if (wn > 0) {
    int yl = tid / wn, kl = tid - yl * wn;
    const int dy = NT / wn, dk = NT - dy * wn;
    while (yl < ROWS) {
      int ys[U], ks[U];
      bool in[U];
      float e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ys[u] = yl;
        ks[u] = kl;
        kl += dk;
        yl += dy;
        if (kl >= wn) {
          kl -= wn;
          ++yl;
        }
        const int y = y0 + ys[u], k = kw + ks[u];
        in[u] = ys[u] < ROWS && y < H && k >= 0 && k < W;
        e[u] = in[u] ? __ldg(ev + (size_t)y * WP + k) : 0.0f;
      }
      float v[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float e0 = floorf(e[u]);
        const float frac = e[u] - e0;
        const int base = vb_s[in[u] ? (kw + ks[u]) / TWH - hx0 : 0];
        const int k0 = base * 8 - s.pad_v + ys[u] + row_steps(e0);
        const bool ok0 = in[u] && k0 >= 0 && k0 < H;
        const bool ok1 = in[u] && k0 >= -1 && k0 < H - 1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* col = img + plane[g] * hw + kw + ks[u];
          const float s0 = ok0 && g < gn ? __ldg(col + (size_t)k0 * W) : 0.0f;
          const float s1 = ok1 && g < gn ? __ldg(col + (size_t)(k0 + 1) * W) : 0.0f;
          v[u][g] = in[u] ? s0 + frac * (s1 - s0) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ys[u] < ROWS)
#pragma unroll
          for (int g = 0; g < G; ++g) stage[(g * ROWS + ys[u]) * wn + ks[u]] = v[u][g];
    }
  }
  __syncthreads();

  // 3. the horizontal pass from the staged columns: lanes along x, warps
  //    along y; the post gain, and the store to the plane's own channel
  const int lane = tid & 31;
  const int x = x0 + lane;
  if (x >= W) return;
#pragma unroll
  for (int j = 0; j < ROWS / (NT / 32); ++j) {
    const int yl = (tid >> 5) + j * (NT / 32);
    const int y = y0 + yl;
    if (y < H) {
      const float e = eh_s[lane * (ROWS + 1) + yl];
      const float e0 = floorf(e);
      const float frac = e - e0;
      const int l = lane + row_steps(e0);  // intermediate column - kb
      const bool staged = l >= lo && l <= hi;
      const float gain = post != nullptr ? __ldg(post + (size_t)y * W + x) : 1.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < gn) {
          float t0, t1;
          if (staged) {
            t0 = stage[(g * ROWS + yl) * wn + l - lo];
            t1 = stage[(g * ROWS + yl) * wn + l - lo + 1];
          } else {
            t0 = vertical(img + plane[g] * hw, ev, bv, y, kb + l, H, W, WP, s.pad_v);
            t1 = vertical(img + plane[g] * hw, ev, bv, y, kb + l + 1, H, W, WP, s.pad_v);
          }
          float r = t0 + frac * (t1 - t0);
          if (post != nullptr) r = r * gain;
          out[plane[g] * hw + (size_t)y * W + x] = r;
        }
      }
    }
  }
}

template <int G>
int launch(const float* img, const float* post, float* out, const WarpPlan& p,
           const WarpPtrs& q, cudaStream_t stream) {
  if (p.smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  warp_kernel<G><<<dim3(p.gx, p.gy, p.gz), NT, p.smem, stream>>>(img, post, out, p, q);
  return (int)cudaGetLastError();
}

// The plan must be the one this source makes of its fields: every count,
// size and grid dimension is recomputed here and compared.
bool plan_ok(const WarpPlan& p) {
  if (p.nsets < 1 || p.nsets > MAX_SETS || p.group < 1 || p.group > MAX_GROUP) return false;
  if (p.rows != ROWS) return false;
  if (p.b < 1 || p.h < 1 || p.w < 1 || p.hp % 256 != 0 || p.wp % 256 != 0 || p.h > p.hp ||
      p.w > p.wp)
    return false;
  int group = 0, ngroups = 0, sw_max = 0;
  for (int i = 0; i < p.nsets; ++i) {
    const WarpSet& s = p.set[i];
    if (s.nc < 1 || s.nc > 3 || s.planes != p.b * s.nc || s.group < 1) return false;
    for (int j = 0; j < s.nc; ++j)
      if (s.ch[j] < 0 || s.ch[j] > 2) return false;
    if (s.ngroups != (s.planes + s.group - 1) / s.group) return false;
    if (s.span_h < 1 || s.span_h > MAX_SPAN || s.sw != TH + s.span_h) return false;
    if (s.pad_v < 0 || s.pad_h < 0) return false;
    group = s.group > group ? s.group : group;
    ngroups = s.ngroups > ngroups ? s.ngroups : ngroups;
    sw_max = s.sw > sw_max ? s.sw : sw_max;
  }
  const long smem = 4L * (TH * (p.rows + 1) + (long)group * p.rows * sw_max);
  return group == p.group && ngroups == p.ngroups && sw_max == p.sw_max && smem == p.smem &&
         smem <= SMEM_MAX && p.gx == (p.w + TH - 1) / TH * ngroups &&
         p.gy == (p.h + p.rows - 1) / p.rows && p.gz == p.nsets;
}

}  // namespace

extern "C" const char* rr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// img, out (b, 3, h, w) float32; post (h, w) float32 or null; the e-maps
// and bases of each set as WarpPtrs lists them.
extern "C" int rr_warp(const float* img, const float* post, float* out, const WarpPlan* plan,
                       const WarpPtrs* ptrs, void* stream) {
  if (plan == nullptr || ptrs == nullptr || !plan_ok(*plan)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (plan->group) {
    case 1:
      return launch<1>(img, post, out, *plan, *ptrs, st);
    case 2:
      return launch<2>(img, post, out, *plan, *ptrs, st);
    default:
      return launch<3>(img, post, out, *plan, *ptrs, st);
  }
}
