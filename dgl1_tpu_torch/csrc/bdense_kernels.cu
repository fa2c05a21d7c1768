// Block-dense g-SpMM kernel (K11) for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes by dgl1_tpu_torch/ops/bdense_kernels.py, whose
// wrapper checks devices, types and shapes, allocates the output and counts
// launches. The entry point launches on the given stream and returns
// cudaGetLastError(); the wrapper raises when it is not 0.
//
// It replaces the Pallas kernel of dgl1_tpu/ops/engine_bdense.py:
//
//   K11  block_mm   <- _block_kernel / _block_call (engine_bdense.py:42,
//                      :70), forward and transpose
//
// Layout (bdense_format.py): K count blocks of 128 x 128 (bf16, exact
// small integers, or float32 when a count passes 256); block k is rows
// [k*128, (k+1)*128) of `a`, indexed (dst-local row, src-local column).
//
//   forward    out[rb*128 + i] = sum over the blocks k of rb row's run
//              ptr[rb] .. ptr[rb+1] (row_ptr over the rb-sorted `a`) of
//              sum_j A_k[i][j] * x[in_blk[k]*128 + j]     (in_blk = cb)
//   transpose  out[cb*128 + j] = sum over cb column's run (col_ptr over the
//              cb-sorted `ab`) of sum_i A_k[i][j] * x[in_blk[k]*128 + i]
//              (in_blk = rbb)
//
// x is (n_in, f) float32, unpadded: rows past n_in read as 0. out is
// (n_out, f) float32 and every element is written once; an output block
// row with an empty run gets zeros, so the reference's rb_mask / cb_mask
// pass is not needed.
//
// What bounds it on the card: bytes. At 2^20 geometric nodes and F=128 the
// blocks (336 MB of bf16), the input blocks' rows (~670 MB) and the output
// (537 MB) take ~0.42 ms at 3.35 TB/s; the products the nonzero counts
// need are 1.8 GFLOP. The counts are ~4% nonzero, but only ~34% of their
// 16 x 16 sub-tiles are empty-free, so the tensor cores on the occupied
// sub-tiles do the work in well under the byte time. The design:
//
// * Tensor cores, exact. A block is staged as bf16 in shared memory (a
//   float32 block, whose counts pass 256, as three bf16 planes hi + mid +
//   lo whose sum is each count exactly). Each input value is split in
//   registers into three bf16 planes the same way, x = hi + mid + lo
//   exactly for normal floats, and each (A plane, x plane) pair is one
//   mma.sync.m16n8k16 with float32 accumulation: every product is exact,
//   so the float32 result is as close as a float32 sum gets. The bf16
//   matmul mode (the reference's cast of A and x to bfloat16) takes the hi
//   planes alone, which are exactly that cast (nearest even).
// * Empty 16 x 16 sub-tiles are skipped. After staging, warp w ballots the
//   staged rows 16w..16w+15 of each plane into an 8-bit mask of occupied
//   sub-tiles; no layout array is added.
// * A is read once for F <= 128. A thread block owns one output block row
//   and one stripe of up to 128 columns (FS = 64 or 128; F > 128 takes
//   128-column stripes, each block of the grid re-reading A, from L2 when
//   the stripes of one row run together: the grid orders stripes fastest).
//   FS = 64 serves F <= 64: on the H100 it is faster than a 128-column
//   stripe at F = 32 and 40 in both directions (PERF.md; 70 KB of shared
//   memory a block against 102, half the accumulators).
//   Warp w owns output rows 16w..16w+15 and every n-tile of 8 columns of
//   the stripe; A fragments come through ldmatrix (ldmatrix.trans for the
//   transpose, so both directions are one kernel), B fragments from the
//   staged float32 rows of x.
// * Loads: A (16-byte cp.async) and the stripe of the 128 input rows
//   (16-byte cp.async when rows are 16-byte aligned, else 4-byte) with
//   zero fill past n_in and f. A block takes ~100 KB of shared memory, so
//   two fit on an SM and one's loads run under the other's MMAs; a run
//   holds 1.25 blocks on average, so a ring inside one block would rarely
//   have a second block to prefetch.
// * No atomics; the order of summation is fixed (the run's blocks in
//   order, then the sub-tiles in order, each plane pair in order), so the
//   result does not change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;
constexpr int THREADS = 256;        // 8 warps; warp w owns rows 16w..+15
constexpr int AS = BLK + 8;         // bf16 row stride of a staged A plane:
                                    // 272 B, so ldmatrix rows hit all banks
constexpr unsigned FULL = 0xffffffffu;

template <int FS>
struct Tile {
  static constexpr int XS = FS + 4;  // float row stride of staged x: the
                                     // B-fragment loads are conflict-free
  static constexpr int NT = FS / 8;  // n-tiles a warp accumulates
  static size_t smem(int pa) {
    return sizeof(__nv_bfloat16) * (size_t)pa * BLK * AS +
           sizeof(float) * (size_t)BLK * XS + sizeof(uint32_t) * 3 * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; `bytes` < the copy size zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) as bf16 pairs whose sums are v0 and v1: hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid). Each difference is exact in
// float32, and what is left after mid has at most 8 significant bits, so
// hi + mid + lo == v for normal floats. P = 1 gives hi alone: bf16(v),
// nearest even.
template <int P>
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&o)[P]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  o[0] = bits(h);
  if constexpr (P == 3) {
    const float2 hf = __bfloat1622float2(h);
    const float r0 = v0 - hf.x, r1 = v1 - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    o[1] = bits(m);
    o[2] = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// acc (16 x 8, float32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage block k of `a` as PA bf16 planes of 128 x AS.
template <typename AT, int PA>
__device__ __forceinline__ void stage_a(const AT* __restrict__ ak,
                                        __nv_bfloat16* sA, int tid);

template <>
__device__ __forceinline__ void stage_a<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ ak, __nv_bfloat16* sA, int tid) {
  for (int idx = tid; idx < BLK * BLK / 8; idx += THREADS) {
    const int r = idx >> 4, c = (idx & 15) * 8;
    cp_async16(sA + r * AS + c, ak + r * BLK + c, 16);
  }
}

template <int PA>
__device__ __forceinline__ void stage_a_f32(const float* __restrict__ ak,
                                            __nv_bfloat16* sA, int tid) {
  for (int idx = tid; idx < BLK * BLK / 4; idx += THREADS) {
    const int r = idx >> 5, c = (idx & 31) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(ak + r * BLK + c));
    uint32_t lo[PA], hi[PA];
    split<PA>(v.x, v.y, lo);
    split<PA>(v.z, v.w, hi);
#pragma unroll
    for (int p = 0; p < PA; ++p)
      *reinterpret_cast<uint2*>(sA + (size_t)p * BLK * AS + r * AS + c) =
          make_uint2(lo[p], hi[p]);
  }
}

template <>
__device__ __forceinline__ void stage_a<float, 1>(const float* __restrict__ ak,
                                                  __nv_bfloat16* sA, int tid) {
  stage_a_f32<1>(ak, sA, tid);
}
template <>
__device__ __forceinline__ void stage_a<float, 3>(const float* __restrict__ ak,
                                                  __nv_bfloat16* sA, int tid) {
  stage_a_f32<3>(ak, sA, tid);
}

// AT: the counts' type. BF16: the bf16 matmul mode (hi planes only). A
// float32 block outside that mode is split into three planes.
template <typename AT, int FS, bool TRANSPOSE, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
block_mm_kernel(const AT* __restrict__ a, const int* __restrict__ ptr,
                const int* __restrict__ in_blk, const float* __restrict__ x,
                int n_in, int f, float* __restrict__ out, int n_out,
                int n_stripes, int vec4) {
  constexpr int PA = (sizeof(AT) == 4 && !BF16) ? 3 : 1;  // A planes
  constexpr int PX = BF16 ? 1 : 3;                          // x planes
  constexpr int XS = Tile<FS>::XS, NT = Tile<FS>::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sX = reinterpret_cast<float*>(sA + (size_t)PA * BLK * AS);
  uint32_t* occ = reinterpret_cast<uint32_t*>(sX + BLK * XS);  // [PA][8]

  const int ob = blockIdx.x / n_stripes;
  const int col0 = (blockIdx.x - ob * n_stripes) * FS;
  const int nf = min(FS, f - col0);
  const int nt = (nf + 7) >> 3;  // live n-tiles of the stripe
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = __ldg(ptr + ob), k1 = __ldg(ptr + ob + 1);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  // ldmatrix row address of this lane within a 16 x 16 sub-tile: matrix
  // q = lane / 8, row r = lane % 8. Forward reads A's (m, k) tile as
  // stored; the transpose reads the stored (k, m) tile with .trans.
  const int q = lane >> 3, r8 = lane & 7;
  const int lm_row = TRANSPOSE ? r8 + (q >> 1) * 8 : r8 + (q & 1) * 8;
  const int lm_col = TRANSPOSE ? (q & 1) * 8 : (q >> 1) * 8;

  for (int k = k0; k < k1; ++k) {
    if (k > k0) __syncthreads();  // the previous block's reads are done
    stage_a<AT, PA>(a + (size_t)k * BLK * BLK, sA, tid);
    const int64_t row0 = (int64_t)__ldg(in_blk + k) * BLK;
    if (vec4) {
      const int units = nt * 2;  // 16-byte units of a staged row
      for (int idx = tid; idx < BLK * units; idx += THREADS) {
        const int r = idx / units, c = (idx - r * units) * 4;
        const bool live = row0 + r < n_in && col0 + c < f;
        cp_async16(sX + r * XS + c,
                   live ? x + (row0 + r) * f + col0 + c : x, live ? 16 : 0);
      }
    } else {
      const int w8 = nt * 8;
      for (int idx = tid; idx < BLK * w8; idx += THREADS) {
        const int r = idx / w8, c = idx - r * w8;
        const bool live = row0 + r < n_in && col0 + c < f;
        cp_async4(sX + r * XS + c,
                  live ? x + (row0 + r) * f + col0 + c : x, live ? 4 : 0);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // Occupancy: warp w ballots stored rows 16w..16w+15 of each plane;
    // lane l reads row 16w + l/2, columns 64 (l % 2) .. +63 (4 sub-tiles).
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const uint4* row = reinterpret_cast<const uint4*>(
          sA + (size_t)p * BLK * AS + (warp * 16 + (lane >> 1)) * AS +
          (lane & 1) * 64);
      uint32_t m = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint4 u = row[2 * s], v = row[2 * s + 1];
        const unsigned b = __ballot_sync(
            FULL, (u.x | u.y | u.z | u.w | v.x | v.y | v.z | v.w) != 0u);
        m |= (unsigned)((b & 0x55555555u) != 0u) << s;
        m |= (unsigned)((b & 0xAAAAAAAAu) != 0u) << (4 + s);
      }
      if (lane == 0) occ[p * 8 + warp] = m;
    }
    __syncthreads();

    // The k sub-tiles of output rows 16w..+15 with a nonzero, per plane.
    uint32_t kmask[PA];
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      if (TRANSPOSE) {
        uint32_t m = 0;
#pragma unroll
        for (int s = 0; s < 8; ++s) m |= ((occ[p * 8 + s] >> warp) & 1u) << s;
        kmask[p] = m;
      } else {
        kmask[p] = occ[p * 8 + warp];
      }
    }
    uint32_t kall = 0;
#pragma unroll
    for (int p = 0; p < PA; ++p) kall |= kmask[p];

    while (kall) {
      const int ks = __ffs(kall) - 1;
      kall &= kall - 1;
      uint32_t af[PA][4];
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int sr = TRANSPOSE ? ks * 16 + lm_row : warp * 16 + lm_row;
        const int sc = TRANSPOSE ? warp * 16 + lm_col : ks * 16 + lm_col;
        if ((kmask[p] >> ks) & 1u)
          ldmatrix_x4(af[p], smem_u32(sA + (size_t)p * BLK * AS + sr * AS + sc),
                      TRANSPOSE);
      }
      const float* xr = sX + (ks * 16 + 2 * tig) * XS + gid;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nt) {
          const float* xp = xr + n * 8;
          uint32_t b0[PX], b1[PX];
          split<PX>(xp[0], xp[XS], b0);
          split<PX>(xp[8 * XS], xp[9 * XS], b1);
#pragma unroll
          for (int p = 0; p < PA; ++p) {
            if ((kmask[p] >> ks) & 1u) {
#pragma unroll
              for (int pq = PX - 1; pq >= 0; --pq)
                mma_bf16(acc[n], af[p], b0[pq], b1[pq]);
            }
          }
        }
      }
    }
  }

  // Fragment (gid, 2 tig) and (gid + 8, 2 tig) of each n-tile.
  const bool vec2 = (f & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ob * BLK + warp * 16 + gid + 8 * h;
    if (row >= n_out) continue;
    float* o = out + (size_t)row * f + col0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * tig;
      if (n >= nt || c >= nf) continue;
      const float v0 = acc[n][2 * h], v1 = acc[n][2 * h + 1];
      if (vec2 && c + 1 < nf) {
        *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
      } else {
        o[c] = v0;
        if (c + 1 < nf) o[c + 1] = v1;
      }
    }
  }
}

template <typename AT, int FS, bool TRANSPOSE, bool BF16>
int launch(const void* a, const int* ptr, const int* in_blk, const float* x,
           int n_in, int f, float* out, int n_out, int n_out_blocks,
           cudaStream_t stream) {
  constexpr int PA = (sizeof(AT) == 4 && !BF16) ? 3 : 1;
  auto kern = block_mm_kernel<AT, FS, TRANSPOSE, BF16>;
  const size_t smem = Tile<FS>::smem(PA);  // above 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_stripes = (f + FS - 1) / FS;
  const int vec4 = (f % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int64_t grid = (int64_t)n_out_blocks * n_stripes;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const AT*>(a), ptr, in_blk, x, n_in, f, out, n_out,
      n_stripes, vec4);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT, int FS, bool BF16>
int launch_dir(int transpose, const void* a, const int* ptr,
               const int* in_blk, const float* x, int n_in, int f,
               float* out, int n_out, int n_out_blocks, cudaStream_t s) {
  return transpose
             ? launch<AT, FS, true, BF16>(a, ptr, in_blk, x, n_in, f, out,
                                          n_out, n_out_blocks, s)
             : launch<AT, FS, false, BF16>(a, ptr, in_blk, x, n_in, f, out,
                                           n_out, n_out_blocks, s);
}

template <typename AT, bool BF16>
int launch_fs(int fs, int transpose, const void* a, const int* ptr,
              const int* in_blk, const float* x, int n_in, int f, float* out,
              int n_out, int n_out_blocks, cudaStream_t s) {
  return fs == 64
             ? launch_dir<AT, 64, BF16>(transpose, a, ptr, in_blk, x, n_in, f,
                                        out, n_out, n_out_blocks, s)
             : launch_dir<AT, 128, BF16>(transpose, a, ptr, in_blk, x, n_in,
                                         f, out, n_out, n_out_blocks, s);
}

template <bool BF16>
int launch_at(int a_is_bf16, int fs, int transpose, const void* a,
              const int* ptr, const int* in_blk, const float* x, int n_in,
              int f, float* out, int n_out, int n_out_blocks,
              cudaStream_t s) {
  return a_is_bf16
             ? launch_fs<__nv_bfloat16, BF16>(fs, transpose, a, ptr, in_blk,
                                              x, n_in, f, out, n_out,
                                              n_out_blocks, s)
             : launch_fs<float, BF16>(fs, transpose, a, ptr, in_blk, x, n_in,
                                      f, out, n_out, n_out_blocks, s);
}

}  // namespace

extern "C" {

// a: (K*128, 128) counts, bf16 when a_is_bf16 else float32, 16-byte
// aligned; ptr: (n_out_blocks + 1,) run pointers; in_blk: (K,) input block
// per block; x: (n_in, f) float32; out: (n_out, f) float32, every element
// written. fs: the column stripe a thread block covers, 64 or 128. bf16: 1
// for the bf16 mode.
int block_mm(int transpose, int a_is_bf16, const void* a, const int* ptr,
             const int* in_blk, const float* x, int n_in, int f, float* out,
             int n_out, int n_out_blocks, int fs, int bf16, void* stream) {
  if ((fs != 64 && fs != 128) || reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_at<true>(a_is_bf16, fs, transpose, a, ptr, in_blk, x,
                                n_in, f, out, n_out, n_out_blocks, s)
              : launch_at<false>(a_is_bf16, fs, transpose, a, ptr, in_blk, x,
                                 n_in, f, out, n_out, n_out_blocks, s);
}

}  // extern "C"
