// Tile-engine g-SpMM kernels for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes by dgl1_tpu_torch/ops/tile_kernels.py, whose
// wrappers check devices, types and shapes, choose the launch plan
// (tile_plan_for), allocate the output and count launches. Each entry point
// launches on the given stream and returns cudaGetLastError(); the wrapper
// raises when it is not 0.
//
// The kernels replace the Pallas kernels of dgl1_tpu/ops/engine_pallas.py,
// with the gather of the glue around them (engine_pallas.py:234-236) taken
// in:
//
//   K9   tile_sum      <- _reduce_kernel / _segment_sum_tiles
//                         (engine_pallas.py:54, :170)
//   K10  tile_minmax   <- _minmax_kernel / _segment_minmax_tiles
//                         (engine_pallas.py:75, :134, :163)
//
// Layout (graph._build_tiles): tile t holds T = 1024 slots of row block
// rows[t] (R = 128 output rows); lid[t][s] is the slot's row in the block
// or -1 for padding. Tiles of a row block are consecutive in `rows`
// (sorted); within a tile the real slots come first, sorted by lid, and
// padding slots follow, so each row's slots are one run; first[t] = 1
// marks a tile whose partial result replaces what the earlier tiles of
// its block gave. A tile whose slot 0 is padding holds no edge; such
// tiles (graph._pad_tiles) come after the real tiles of their row block
// and carry first = 0.
//
// Slot s of tile t reads source row t * T + s of `src` (message mode, idx
// null: one row per slot) or row clamp(idx[t * T + s], 0, n_src - 1)
// (gather mode: the layout's `gather` or `eid`, as the glue's
// gather_rows). Padding slots are never read.
//
// What bounds them on the card: bytes. Each real slot reads one source
// row of f floats and each output row is written once; the arithmetic is
// one add or compare per element. The TPU kernels build a one-hot (T x R)
// matrix and run it through the MXU, carry the output block across the
// sequential grid in VMEM, and take a message tensor built by the glue
// with a row for every slot, padding included (6.28 GB for a sampled
// Reddit block's reverse layout at F=602). Here:
//
// - No message tensor: in gather mode the kernel reads each real slot's
//   row of `src` through the index, so the bytes are the real slots' rows
//   (rows shared by many slots come from L2) and the output.
// - A block owns `rpb` rows of one row block (tile_plan halves 128 until
//   the grid fills the card: block 1 of a sampled batch has 8 row blocks,
//   so 2 rows a block) and every column. It finds its tile range once: two
//   warp searches over `rows`, one over the tiles' slot 0 for the padding
//   cut, and a backward scan for the last tile flagged `first`.
//   It then stages up to NT tiles at a time: lid in 16-byte loads, turned
//   into each of its rows' run [ptr[r], ptr[r + 1]) per tile; in gather
//   mode the index of its rows' slots follows by cp.async. A row block
//   with no tile writes its identity without staging anything.
// - Warps walk (row, stripe) items, row-major, so the stripes of a row
//   are written together: a stripe is the 32 * VEC * NC columns (256 or
//   320) a warp holds in registers, VEC = 4, 2 or 1 floats a lane (16- or
//   8-byte loads where f and the source allow it). A batch issues the
//   loads of S = 32 / (VEC * NC) slots of the run before adding any of
//   them; slots past the run hold the identity, so the adds take no
//   branch. Where a row block has more than NT tiles, the next chunk
//   resumes from the output the block wrote, which no other block
//   touches.
// - The walk is bound by its instructions as much as by memory (a row of
//   one or two slots per stripe on reverse layouts), so wide stripes
//   repeat each slot's index and address work fewer times; output stores
//   stream past L2 (evict-first) to leave it to the source rows.
//
// Padding slots are never read, each output element has one owner, there
// are no atomics, and the order of summation is fixed (a row's slots in
// order, its tiles in order, as the earlier design): the result does not
// change from run to run.
//
// K10 keeps the reference's semantics: a row's extremum within one tile
// counts as 0 when it is not finite (NaN anywhere in the run, or +-inf);
// tiles combine by max/min; rows that no tile reaches keep -inf / +inf
// for the caller to zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 1024;       // slots per tile
constexpr int R = 128;        // rows per row block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 4;         // tiles staged at a time
// 16-byte lid loads a thread issues for a chunk of NT tiles.
constexpr int LID_Q = NT * T / 4 / THREADS;

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

// One slot into a run: the sum, or max/min that return NaN when either
// operand is NaN (fmaxf/fminf skip it), so a run that holds a NaN ends as
// NaN with no flag of its own.
template <int MODE>
__device__ __forceinline__ float combine(float a, float b) {
  float r;
  if constexpr (MODE == kSum) {
    r = a + b;
  } else if constexpr (MODE == kMax) {
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  } else {
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void load_vec(float* d, const float* p) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = x.x; d[1] = x.y;
  } else {
    d[0] = __ldg(p);
  }
}

// Output stores are streaming (evict-first): the output is written once
// and read by the next kernel, while L2 keeps the source rows that many
// slots share.
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* d) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(d[0], d[1], d[2], d[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(d[0], d[1]));
  } else {
    __stcs(p, d[0]);
  }
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A slot's row key: lid, or R for padding (padding follows the real slots).
__device__ __forceinline__ int slot_key(int v) { return v < 0 ? R : v; }

// ptr[r - r0] = first slot of the tile whose key is >= r, for r in
// [r0, r0 + rpb]: slot s sets the rows in (key(s - 1), key(s)], the last
// slot also the rows past its key. Every entry has one writer.
__device__ __forceinline__ void set_ptr(int* ptr, int s, int kp, int k,
                                        int r0, int rpb) {
  const int lo = max(kp + 1, r0), hi = min(k, r0 + rpb);
  for (int r = lo; r <= hi; ++r) ptr[r - r0] = s;
  if (s == T - 1)
    for (int r = max(k + 1, r0); r <= r0 + rpb; ++r) ptr[r - r0] = T;
}

template <int MODE, int VEC, int NC>
__global__ void __launch_bounds__(THREADS, 6)
tile_reduce_kernel(const int* __restrict__ rows, const int* __restrict__ first,
                   const int* __restrict__ lid, int n_tiles,
                   const float* __restrict__ src,
                   const int* __restrict__ idx, int n_src, int f,
                   float* __restrict__ out, int rpb) {
  constexpr int CPL = VEC * NC;   // floats a lane holds of one slot
  constexpr int S = 32 / CPL;     // slots a batch
  constexpr int SW = 32 * CPL;    // columns a stripe
  __shared__ int s_ptr[NT][R + 1];
  __shared__ int s_range[2];
  extern __shared__ int s_idx[];  // [NT][T], gather mode only

  const int groups = R / rpb;
  const int rb = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * rpb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool gather = idx != nullptr;

  // Warps 0 and 1 find the row block's tiles [t0, te) side by side.
  if (warp < 2) {
    const int v = rb + warp;
    const int b = warp_partition_point(
        0, n_tiles, [&](int t) { return __ldg(rows + t) < v; }, lane);
    if (lane == 0) s_range[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    // Padding tiles (all slots -1, first = 0) trail the real tiles of
    // their row block, about a thousand on a sampled block's reverse
    // layout; every real tile holds an edge in slot 0. The last tile
    // flagged `first` before the cut restarts the block's result.
    const int t0 = s_range[0], te = s_range[1];
    const int t1 = warp_partition_point(
        t0, te, [&](int t) { return __ldg(lid + (size_t)t * T) >= 0; },
        lane);
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
  float* const out0 = out + ((size_t)rb * R + r0) * (size_t)f;

  if (ts >= t1) {
    // No edge reaches these rows: write the identity, 16 bytes a store
    // where the rows' span allows.
    const float idv[4] = {ident<MODE>(), ident<MODE>(), ident<MODE>(),
                          ident<MODE>()};
    const int n = rpb * f;
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(out0) % 16 == 0) {
      for (int i = tid; i < n / 4; i += THREADS)
        store_vec<4>(out0 + 4 * i, idv);
    } else {
      for (int i = tid; i < n / VEC; i += THREADS)
        store_vec<VEC>(out0 + VEC * i, idv);
    }
    return;
  }

  const int nstripes = (f + SW - 1) / SW;
  const int items = rpb * nstripes;

  for (int c0 = ts; c0 < t1; c0 += NT) {
    const int nt = min(NT, t1 - c0);
    if (c0 > ts) __syncthreads();  // the last chunk's walk is done

    // Stage lid: each thread reads 4 slots a load, all loads issued
    // before any is used; the lane before (lane 0: the slot before, read
    // apart) gives the key of the slot preceding the first.
    {
      int4 q[LID_Q];
      int prev[LID_Q];
#pragma unroll
      for (int k = 0; k < LID_Q; ++k) {
        const int i = tid + THREADS * k;  // 16-byte unit of the chunk
        const int ti = i / (T / 4), s = 4 * (i % (T / 4));
        q[k] = make_int4(0, 0, 0, 0);
        prev[k] = -1;
        if (ti < nt) {
          const int* p = lid + (size_t)(c0 + ti) * T + s;
          q[k] = __ldg(reinterpret_cast<const int4*>(p));
          if (lane == 0 && s > 0) prev[k] = __ldg(p - 1);
        }
      }
#pragma unroll
      for (int k = 0; k < LID_Q; ++k) {
        const int i = tid + THREADS * k;
        const int ti = i / (T / 4), s = 4 * (i % (T / 4));
        const int up = __shfl_up_sync(0xffffffffu, q[k].w, 1);
        if (ti < nt) {
          const int kp = lane == 0 ? (s > 0 ? slot_key(prev[k]) : -1)
                                   : slot_key(up);
          int* ptr = s_ptr[ti];
          const int k0 = slot_key(q[k].x), k1 = slot_key(q[k].y),
                    k2 = slot_key(q[k].z), k3 = slot_key(q[k].w);
          set_ptr(ptr, s, kp, k0, r0, rpb);
          set_ptr(ptr, s + 1, k0, k1, r0, rpb);
          set_ptr(ptr, s + 2, k1, k2, r0, rpb);
          set_ptr(ptr, s + 3, k2, k3, r0, rpb);
        }
      }
    }
    __syncthreads();
    if (gather) {
      // The index of this block's slots: one range a tile.
      for (int ti = 0; ti < nt; ++ti) {
        const int b = s_ptr[ti][0], e = s_ptr[ti][rpb];
        const int* g = idx + (size_t)(c0 + ti) * T;
        for (int s = b + tid; s < e; s += THREADS)
          cp_async4(s_idx + ti * T + s, g + s);
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // Items row-major: the stripes of a row are written together.
    for (int it = warp; it < items; it += WARPS) {
      const int rl = it / nstripes, sp = it % nstripes;
      const int col = sp * SW + lane * VEC;
      bool ok[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) ok[c] = col + 32 * VEC * c < f;
      float* const orow = out0 + (size_t)rl * f + col;
      float acc[NC][VEC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c0 > ts && ok[c]) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[c][v] = orow[32 * VEC * c + v];
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[c][v] = ident<MODE>();
        }
      }
      for (int ti = 0; ti < nt; ++ti) {
        const int b = s_ptr[ti][rl], e = s_ptr[ti][rl + 1];
        if (b >= e) continue;
        const size_t tbase = (size_t)(c0 + ti) * T;
        const int* const sidx = s_idx + ti * T;
        float run[NC][VEC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            run[c][v] = MODE == kSum ? acc[c][v] : ident<MODE>();
        for (int s = b; s < e; s += S) {
          // Slots past the run load nothing and hold the identity, so
          // the adds below need no branch: x + 0 and pick(x, ident) are x.
          float x[S][NC][VEC];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const bool live = s + j < e;
            size_t srow = tbase + s + j;
            if (gather && live)
              srow = (size_t)min(max(sidx[s + j], 0), n_src - 1);
            const float* p = src + srow * (size_t)f + col;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) x[j][c][v] = ident<MODE>();
              if (live && ok[c]) load_vec<VEC>(x[j][c], p + 32 * VEC * c);
            }
          }
#pragma unroll
          for (int j = 0; j < S; ++j)
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                run[c][v] = combine<MODE>(run[c][v], x[j][c][v]);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            if (MODE == kSum) {
              acc[c][v] = run[c][v];
            } else {
              // A run whose extremum is NaN or +-inf counts as 0 (the
              // reference's finite-only extraction).
              const float p = isfinite(run[c][v]) ? run[c][v] : 0.0f;
              acc[c][v] = pick<MODE>(acc[c][v], p);
            }
          }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (ok[c]) store_vec<VEC>(orow + 32 * VEC * c, acc[c]);
    }
  }
}

template <int MODE, int VEC, int NC>
int launch_plan(const int* rows, const int* first, const int* lid,
                int n_tiles, const float* src, const int* idx, int n_src,
                int f, float* out, int n_row_blocks, int rpb,
                cudaStream_t stream) {
  const int smem = idx ? NT * T * static_cast<int>(sizeof(int)) : 0;
  const int blocks = n_row_blocks * (R / rpb);
  tile_reduce_kernel<MODE, VEC, NC><<<blocks, THREADS, smem, stream>>>(
      rows, first, lid, n_tiles, src, idx, n_src, f, out, rpb);
  return static_cast<int>(cudaGetLastError());
}

// The plans tile_plan gives: (vec, nc) = (4, 2), (2, 5), (1, 8): 8, 10
// and 8 floats a lane, 4, 3 and 4 slots a batch.
template <int MODE>
int launch(const int* rows, const int* first, const int* lid, int n_tiles,
           const float* src, const int* idx, int n_src, int f, float* out,
           int n_row_blocks, int vec, int nc, int rpb, void* stream) {
  if (rpb < 1 || rpb > R || R % rpb != 0 || n_tiles < 1 || f < 1 ||
      n_row_blocks < 1 || (idx && n_src < 1) || f % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define TILE_PLAN(V, N)                                                    \
  if (vec == V && nc == N)                                                 \
    return launch_plan<MODE, V, N>(rows, first, lid, n_tiles, src, idx,    \
                                   n_src, f, out, n_row_blocks, rpb, st);
  TILE_PLAN(4, 2)
  TILE_PLAN(2, 5)
  TILE_PLAN(1, 8)
#undef TILE_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out: (n_row_blocks * 128, f); every element is written. idx: null
// (src has a row per slot) or (n_tiles * 1024,) indices into src's n_src
// rows. vec, nc, rpb: the launch plan (tile_kernels.tile_plan_for).
int tile_sum(const int* rows, const int* first, const int* lid, int n_tiles,
             const float* src, const int* idx, int n_src, int f, float* out,
             int n_row_blocks, int vec, int nc, int rpb, void* stream) {
  return launch<kSum>(rows, first, lid, n_tiles, src, idx, n_src, f, out,
                      n_row_blocks, vec, nc, rpb, stream);
}

int tile_minmax(int is_max, const int* rows, const int* first,
                const int* lid, int n_tiles, const float* src,
                const int* idx, int n_src, int f, float* out,
                int n_row_blocks, int vec, int nc, int rpb, void* stream) {
  return is_max ? launch<kMax>(rows, first, lid, n_tiles, src, idx, n_src,
                               f, out, n_row_blocks, vec, nc, rpb, stream)
                : launch<kMin>(rows, first, lid, n_tiles, src, idx, n_src,
                               f, out, n_row_blocks, vec, nc, rpb, stream);
}

// Warps a block: what tile_kernels.tile_plan_for plans for.
int tile_warps() { return WARPS; }

}  // extern "C"
