// Tile-engine g-SpMM kernels for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes by dgl1_tpu_torch/ops/tile_kernels.py, whose
// wrappers check devices, types and shapes, allocate the output and count
// launches. Each entry point launches on the given stream and returns
// cudaGetLastError(); the wrapper raises when it is not 0.
//
// The kernels replace the Pallas kernels of dgl1_tpu/ops/engine_pallas.py:
//
//   K9   tile_sum      <- _reduce_kernel / _segment_sum_tiles
//                         (engine_pallas.py:54, :170)
//   K10  tile_minmax   <- _minmax_kernel / _segment_minmax_tiles
//                         (engine_pallas.py:75, :134, :163)
//
// Layout (graph._build_tiles): tile t holds T = 1024 slots of row block
// rows[t] (R = 128 output rows); lid[t][s] is the slot's row in the block
// or -1 for padding; msg has one row of f floats per slot. Tiles of a row
// block are consecutive in `rows` (sorted), lid is sorted within a tile so
// each row's slots are one run, and first[t] = 1 marks a tile whose
// partial result replaces what the earlier tiles of its block gave. A
// tile whose slot 0 is padding holds no edge; such tiles (graph._pad_tiles)
// come after the real tiles of their row block and carry first = 0.
//
// What bounds them on the card: bytes. Each real slot reads one message
// row once and each output row is written once; the arithmetic is one add
// or compare per element. The TPU kernels build a one-hot (T x R) matrix
// and run it through the MXU, and carry the output block across the
// sequential grid in VMEM. Here a block owns one row block and one stripe
// of at most 128 feature columns, finds its tile range by binary search in
// `rows` (and the end of its real tiles by a second search on slot 0),
// walks its tiles in order, and keeps the 128 x 128 partial
// result in registers: warp w owns rows w, w + 16, ..., lane l columns
// l, l + 32, l + 64, l + 96 of the stripe. Per tile, the run of each row
// is found from lid in shared memory and the warp reduces it slot after
// slot, two rows of loads in flight. Padding slots are never read, each
// output element is stored once, there are no atomics, and the order of
// summation is fixed (slots in order, tiles in order): the result does
// not change from run to run.
//
// K10 keeps the reference's semantics: a row's extremum within one tile
// counts as 0 when it is not finite (NaN anywhere in the run, or +-inf);
// tiles combine by max/min; rows that no tile reaches keep -inf / +inf
// for the caller to zero. K9's sum is exact per element order above.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 1024;       // slots per tile
constexpr int R = 128;        // rows per row block
constexpr int FS = 128;       // feature columns per block (stripe)
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = R / WARPS;  // rows per warp
constexpr int CPL = FS / 32;    // columns per lane

enum Mode { kSum = 0, kMax = 1, kMin = 2 };

// First index i in [lo, hi) with pred(i) false, where pred holds on a
// prefix of the range, by one warp: each round the 32 lanes probe 32
// evenly spaced positions, so the range shrinks 32-fold per dependent
// load (3 loads for 2,548 tiles).
template <class Pred>
__device__ __forceinline__ int warp_partition_point(int lo, int hi,
                                                    Pred pred, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && pred(p);
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    const int new_lo = cnt > 0 ? lo + (cnt - 1) * step + 1 : lo;
    const int p_cnt = lo + cnt * step;
    hi = (cnt < 32 && p_cnt < hi) ? p_cnt : hi;
    lo = new_lo;
  }
  const bool below = lo + lane < hi && pred(lo + lane);
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

template <int MODE>
__device__ __forceinline__ float ident() {
  return MODE == kMax ? -INFINITY : (MODE == kMin ? INFINITY : 0.0f);
}

template <int MODE>
__device__ __forceinline__ float pick(float a, float b) {
  return MODE == kMax ? fmaxf(a, b) : fminf(a, b);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
tile_reduce_kernel(const int* __restrict__ rows, const int* __restrict__ first,
                   const int* __restrict__ lid, int n_tiles,
                   const float* __restrict__ msg, int f,
                   float* __restrict__ out) {
  __shared__ int s_lid[T];
  __shared__ int s_beg[R];
  __shared__ int s_end[R];
  __shared__ int s_range[2];

  const int rb = blockIdx.x;
  const int col0 = blockIdx.y * FS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Warps 0 and 1 find the block's tile range [t0, t1) side by side.
  if (warp < 2) {
    const int v = rb + warp;
    const int b = warp_partition_point(
        0, n_tiles, [&](int t) { return __ldg(rows + t) < v; }, lane);
    if (lane == 0) s_range[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    // Padding tiles (graph._pad_tiles: all slots -1, first = 0) trail the
    // last row block's real tiles, about a thousand on a sampled block's
    // reverse layout; every real tile holds an edge in slot 0. Cut them
    // off by search instead of walking them.
    const int t0 = s_range[0];
    const int t1 = warp_partition_point(
        t0, s_range[1],
        [&](int t) { return __ldg(lid + (size_t)t * T) >= 0; }, lane);
    // The last tile flagged `first` restarts the block's result: scan
    // back from t1 - 1, 32 tiles per round.
    int ts = t0;
    for (int top = t1 - 1; top >= t0; top -= 32) {
      const int t = top - lane;
      const unsigned hit = __ballot_sync(
          0xffffffffu, t >= t0 && __ldg(first + t) == 1);
      if (hit) {
        ts = top - (__ffs(hit) - 1);
        break;
      }
    }
    __syncwarp();
    if (lane == 0) {
      s_range[0] = ts;
      s_range[1] = t1;
    }
  }
  __syncthreads();
  const int ts = s_range[0], t1 = s_range[1];

  bool col_ok[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) col_ok[k] = col0 + lane + 32 * k < f;
  const float* mcol = msg + col0 + lane;

  float acc[RPW][CPL];
#pragma unroll
  for (int j = 0; j < RPW; ++j)
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[j][k] = ident<MODE>();

  for (int t = ts; t < t1; ++t) {
    for (int i = tid; i < T; i += THREADS) s_lid[i] = lid[(size_t)t * T + i];
    for (int i = tid; i < R; i += THREADS) { s_beg[i] = 0; s_end[i] = 0; }
    __syncthreads();
    for (int i = tid; i < T; i += THREADS) {
      int v = s_lid[i];
      if (v >= 0 && v < R) {
        if (i == 0 || s_lid[i - 1] != v) s_beg[v] = i;
        if (i == T - 1 || s_lid[i + 1] != v) s_end[v] = i + 1;
      }
    }
    __syncthreads();

    const size_t base = (size_t)t * T;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + WARPS * j;
      const int b = s_beg[r], e = s_end[r];
      if (b >= e) continue;
      float run[CPL];
      bool nan[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        run[k] = MODE == kSum ? acc[j][k] : ident<MODE>();
        nan[k] = false;
      }
      int s = b;
      for (; s + 2 <= e; s += 2) {
        const float* p0 = mcol + (base + s) * (size_t)f;
        const float* p1 = p0 + f;
        float v0[CPL], v1[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          v0[k] = col_ok[k] ? __ldg(p0 + 32 * k) : 0.0f;
          v1[k] = col_ok[k] ? __ldg(p1 + 32 * k) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          if (MODE == kSum) {
            run[k] += v0[k];
            run[k] += v1[k];
          } else {
            nan[k] |= isnan(v0[k]) || isnan(v1[k]);
            run[k] = pick<MODE>(run[k], pick<MODE>(v0[k], v1[k]));
          }
        }
      }
      if (s < e) {
        const float* p0 = mcol + (base + s) * (size_t)f;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          float v = col_ok[k] ? __ldg(p0 + 32 * k) : 0.0f;
          if (MODE == kSum) {
            run[k] += v;
          } else {
            nan[k] |= isnan(v);
            run[k] = pick<MODE>(run[k], v);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (MODE == kSum) {
          acc[j][k] = run[k];
        } else {
          // fmaxf/fminf skip NaN, so a NaN is tracked apart; a run whose
          // extremum is NaN or +-inf counts as 0 (the reference's
          // finite-only extraction).
          float p = (nan[k] || isinf(run[k])) ? 0.0f : run[k];
          acc[j][k] = pick<MODE>(acc[j][k], p);
        }
      }
    }
    __syncthreads();  // s_lid / s_beg / s_end are rewritten next tile
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    float* o = out + ((size_t)rb * R + warp + WARPS * j) * (size_t)f + col0 +
               lane;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (col_ok[k]) o[32 * k] = acc[j][k];
  }
}

template <int MODE>
int launch(const int* rows, const int* first, const int* lid, int n_tiles,
           const float* msg, int f, float* out, int n_row_blocks,
           void* stream) {
  dim3 grid(n_row_blocks, (f + FS - 1) / FS);
  tile_reduce_kernel<MODE><<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      rows, first, lid, n_tiles, msg, f, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out: (n_row_blocks * 128, f); every element is written.
int tile_sum(const int* rows, const int* first, const int* lid, int n_tiles,
             const float* msg, int f, float* out, int n_row_blocks,
             void* stream) {
  return launch<kSum>(rows, first, lid, n_tiles, msg, f, out, n_row_blocks,
                      stream);
}

int tile_minmax(int is_max, const int* rows, const int* first,
                const int* lid, int n_tiles, const float* msg, int f,
                float* out, int n_row_blocks, void* stream) {
  return is_max ? launch<kMax>(rows, first, lid, n_tiles, msg, f, out,
                               n_row_blocks, stream)
                : launch<kMin>(rows, first, lid, n_tiles, msg, f, out,
                               n_row_blocks, stream);
}

}  // extern "C"
