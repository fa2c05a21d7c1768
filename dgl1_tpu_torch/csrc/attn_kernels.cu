// Fused GAT attention kernels for Hopper (sm_90a), plain C interface.
//
// Built by dgl1_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// (no --use_fast_math: expf and the subnormal floor behave as on the CPU)
// and bound with ctypes by dgl1_tpu_torch/ops/attn_kernels.py, whose
// wrappers check devices, types and shapes, allocate every output and
// count launches. Each entry point launches on the given stream and
// returns cudaGetLastError(); the wrapper raises when it is not 0.
//
// The kernels replace the Pallas kernels of dgl1_tpu/ops/attention.py:
//
//   K6 attn_fwd        <- _attn_fwd_kernel                (attention.py:152)
//   K7 attn_bwd_src    <- _attn_bwd_kernel, to_src=True   (attention.py:307)
//   K7 attn_bwd_grp    <- _attn_bwd_kernel, to_src=False  (attention.py:307)
//   K8 attn_ger_reduce <- _ger_reduce_kernel              (attention.py:612)
//
// The TPU kernels gather and scatter through one-hot matmuls and carry
// sums across an in-order grid in VMEM. Here rows are staged in shared
// memory or loaded, sums live in registers and shared memory, and blocks
// that share an output combine at the end (K6 and K7 g-major: per-block
// partials that a second kernel sums). Outputs are narrow: H columns
// for den/mraw/gel/partials and H*D for num/gft (the reference pads both
// to 128-lane multiples and its callers read these columns only).
//
// Layout (hub_format.py): chunks of CHUNK slots. In the forward layout a
// slot's a is the source row within window in_id[t] and b the hub row
// within group out_id[t]; chunks are sorted by (group, window) and a
// window's slots come in runs of equal b (each destination's edges
// together, the runs in no order of b). In the backward layout a is the hub row within
// group in_id[t], b the source row within window out_id[t]; chunks are
// sorted by (window, group). Padding slots have a = b = -1.
//
// Heads are processed in stripes of hs = max(1, 128 / D) heads (at most
// 128 feature columns; one head of up to 384 columns when D > 128; K6
// cuts such a head into 128-column pieces): a block owns one stripe, so
// every per-head quantity it needs stays inside.
//
// K6 and both K7 modes have a BF16 instantiation, the reference's bf16
// matmul mode (dgl1_tpu/ops/precision.py): it rounds to bfloat16 (nearest
// even, in registers, rnd() below) exactly the values the reference casts
// to its compute dtype before a one-hot matmul, and nothing else (el and
// er stay float32: they pick the leaky_relu branch); inputs, outputs and
// sums stay float32. Each kernel's note lists its rounding points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;         // hub group rows / window rows
constexpr int NT = 256;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_COLS = 384;    // widest stripe (one head)
constexpr float NEG = -1e30f;    // the reference's -inf stand-in

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// bf16 mode: round to bfloat16, nearest even, and back.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Order-preserving int image of a float (for atomicMax) and its inverse.
__device__ __forceinline__ int f2key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// The reference's _mix32/_drop_mask: int32 arithmetic with wraparound and
// logical shifts, i.e. uint32. key = eid * 131 + head (wrapping).
__device__ __forceinline__ float drop_scale(int eid, int head, int seed,
                                            int thresh, float inv_keep) {
  uint32_t x = static_cast<uint32_t>(eid) * 131u + static_cast<uint32_t>(head);
  x = x * 0x9E3779B9u + static_cast<uint32_t>(seed);
  x ^= x >> 15;
  x *= 0xC2B2AE35u;
  x ^= x >> 13;
  const int bits = static_cast<int>(x & 0x7FFFFFFFu);
  return bits < thresh ? inv_keep : 0.f;
}

struct Stripe {
  int h0, nh, c0, nf;  // first head, heads, first column, columns
};

__device__ __forceinline__ Stripe stripe_of(int y, int hs, int h, int d) {
  Stripe s;
  s.h0 = y * hs;
  s.nh = min(hs, h - s.h0);
  s.c0 = s.h0 * d;
  s.nf = s.nh * d;
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; `bytes` below the size zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* s, const void* g, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}
// Waits until at most the newest group this thread committed is pending.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// First chunk of group g in the group-sorted out_id: lower_bound(g).
__device__ __forceinline__ int first_chunk(const int* __restrict__ out_id,
                                           int n_chunks, int g) {
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (out_id[mid] < g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------
// K6: fused GAT forward over the forward layout.
//
// Replaces _attn_fwd_kernel (dgl1_tpu/ops/attention.py:152), whose
// in-order grid carries each group's running max (mraw) and its num/den
// in VMEM from chunk to chunk with an online rescale. Per real slot (a
// the source row within window in_id[t], b the hub row within group
// out_id[t]) and head: p = exp(leaky(el_a + er_b) - leaky(er_b + mraw)),
// den_b += p, num_b += p * mask * ft_a, where mraw is the group's max of
// el over its real slots (the value the reference's running max ends at).
//
// Bound on the H100: bytes. At arxiv layer 1 (H=8, D=32, no dropout; one
// group, 5,292 chunks over 1,323 windows, 4.39 M real slots) the data are
// a and b (43.4 MB), ft (173.4 MB) and el (5.4 MB) read once and small
// outputs: ~66 us at 3.35 TB/s (the exps and FMAs, 2.3 GFLOP, ~35 us at
// 67 TFLOP/s). The earlier design (a block per run of chunks, a thread per
// (slot, head) gathering el, er and ft rows from L1/L2, shared atomics
// into a (128 x stripe) block, a serial bf16 walk) lost its time as
// follows; this one:
//
// * The max (attn_max_kernel). A block walks a run of chunks, marks the
//   window rows that its real slots name, and per head takes the max of
//   el over the marked rows with a warp reduction of the float's ordered
//   int image: one shared atomic per warp and head, then one device
//   atomicMax per head and group (exact: max is order-free). Before, each
//   (slot, head) did a shared atomicMax onto H words.
// * The rows (attn_fwd_kernel). A block owns a stripe of at most 128
//   feature columns (whole heads, or a 128-column piece of a head wider
//   than that) and a run of consecutive chunks, taken in batches of the
//   chunks that share a (group, window). It stages the next batch's
//   window, the stripe of ft for 128 rows and their el, by 16-byte
//   cp.async into one of two buffers while it walks the current one, and
//   the group's er and leaky(er + mraw) once per group. No slot gathers a
//   row from L2.
// * The walk. Warp w takes the batch's rounds of 32 slots w, w + 16, ...
//   (a window's slots come as a few long runs of one hub row, then many
//   short ones; interleaved rounds give every warp its share of both,
//   where equal contiguous shares left one warp with all the short runs
//   to set the block's time). In a round a lane first takes a slot: p for each head of
//   the stripe, computed once (not once per column), into shared memory.
//   Then lanes run over the columns, four a lane: where the round's slots
//   share a hub row (most rounds) a branch-free loop reads each
//   slot's ft row with one 16-byte shared load a lane and adds p * ft into
//   registers; else one slot at a time. A warp keeps a hub row's sums in
//   registers across rounds and batches and adds them only when its row
//   changes: one 16-byte red.global.add a lane (den: one per head, after
//   a segmented warp sum of each run of rows). Duplicate (b, a) pairs are
//   not adjacent in the layout (arxiv: 4,357,535 adjacent runs among
//   4,390,906 real slots, 1,248,457 distinct (chunk, b, a)), so no slot is
//   folded.
// * The flush. The adds go into the block's own zeroed partial of its
//   group; attn_fold_kernel then sums the partials per group in block
//   order into num and den, writing every element. Adding straight into
//   zeroed num and den measured as fast at layer 1 and a third slower at
//   layer 2 (H=1: every block's adds meet on 128 x 40 floats). The earlier
//   design added a shared (128 x 128) block per flush with one scalar
//   atomic per nonzero; on this card a shared float atomic is a
//   compare-and-swap loop, which is why none is left on the walk.
// * BF16 (the reference's dt=bfloat16). Its online softmax rounds each
//   chunk's p against the running max of the group's chunks so far, and
//   rescales what came before by a scale it rounds for num (not for den).
//   attn_max_kernel then also writes each chunk's max (cmax);
//   attn_run_kernel scans each group's chunks in parallel for the running
//   max (run: max is exact, so any order gives the serial values); and
//   per (chunk t, hub row, head) fden, the product of the later chunks'
//   scales exp(leaky(er + run_{u-1}) - leaky(er + run_u)), and fnum, the
//   product of the same scales each rounded to bf16, come from a segmented
//   suffix product in three passes over segments of FWD_SEG chunks
//   (attn_seg_kernel: each segment's product; attn_segscan_kernel: the
//   products over segments; attn_segapply_kernel: each chunk's within its
//   segment), in place of a thread per (group, row, head) walking the
//   group's 5,292 chunks. The factors are the serial walk's; only the
//   association of their product differs: the walk took ((s_{n-1} s_{n-2})
//   ...) s_{t+1} from the group's end, this takes each segment's product
//   from its end and multiplies the later segments' product in at the
//   segment boundary. Then p = exp(leaky(el + er) - leaky(er + run_t)); a
//   hub row's run of slots of one chunk sums rnd(p) * fden into den and
//   rnd(rnd(p * mask) * rnd(ft)) into num, and multiplies num's sums by
//   fnum when it adds them (the reference scales each term). The scratch
//   (cmax, run, fden, fnum and the segment products) exists only in this
//   mode.
// ---------------------------------------------------------------------
constexpr int FWD_NT = 512;                // threads of a K6 block
constexpr int FWD_NW = FWD_NT / 32;
constexpr int FWD_COLS = 128;              // widest stripe
constexpr int FWD_SEG = 32;                // chunks a bf16 scan segment
constexpr size_t FWD_SMEM_MAX = 227 * 1024;  // sm_90's opt-in per block

// A K6 plan (made by the wrapper, ops/attn_kernels.py fwd_plan): nhs heads
// a stripe (1 when d > 128, each head then cut into nsub pieces of up to
// 128 columns), staged rows ws floats apart (the widest stripe rounded up
// to 4, plus 4), g lanes a slot (a power of two, 4 g >= the widest
// stripe).
struct FwdPlan {
  int nhs, nsub, ws, g;
};

size_t fwd_smem(const FwdPlan& p) {
  // Two ft and two el windows, er and the shift, and each warp's p and
  // staged rows of 32 slots.
  return sizeof(float) * (static_cast<size_t>(BLK) * (2 * p.ws + 4 * p.nhs) +
                          static_cast<size_t>(FWD_NW) * 32 * (p.nhs + 1));
}

int fwd_stripes(const FwdPlan& p, int h, int d) {
  return d > FWD_COLS ? h * p.nsub : (h + p.nhs - 1) / p.nhs;
}

struct FwdStripe {
  int h0, nh, c0, nc;  // first head, heads, first column, columns
};

__device__ __forceinline__ FwdStripe fwd_stripe(int y, int h, int d,
                                                const FwdPlan& p) {
  FwdStripe s;
  if (d > FWD_COLS) {
    const int hd = y / p.nsub, sub = y - hd * p.nsub;
    s.h0 = hd;
    s.nh = 1;
    s.c0 = hd * d + sub * FWD_COLS;
    s.nc = min(FWD_COLS, d - sub * FWD_COLS);
  } else {
    s.h0 = y * p.nhs;
    s.nh = min(p.nhs, h - s.h0);
    s.c0 = s.h0 * d;
    s.nc = s.nh * d;
  }
  return s;
}

__global__ void __launch_bounds__(NT)
    attn_init_kernel(int* __restrict__ mkey, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < n) mkey[i] = f2key(NEG);
}

// PER_CHUNK (bf16 mode): each chunk's max is taken and written to cmax;
// else a run of chunks that share a (group, window) is taken at once.
template <bool PER_CHUNK>
__global__ void __launch_bounds__(NT)
    attn_max_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    const int* __restrict__ in_id,
                    const int* __restrict__ out_id, int n_chunks, int chunk,
                    int cpb, const float* __restrict__ el, int n_src, int h,
                    int* __restrict__ mkey, float* __restrict__ cmax) {
  __shared__ int mark[BLK];  // window rows a real slot names
  __shared__ int cm[BLK];    // this segment's max per head
  __shared__ int gm[BLK];    // this group's max per head
  const int tid = threadIdx.x, lane = tid % 32;
  const int neg = f2key(NEG);
  for (int i = tid; i < BLK; i += NT) {
    mark[i] = 0;
    cm[i] = gm[i] = neg;
  }
  __syncthreads();
  const int t0 = blockIdx.x * cpb, t1 = min(n_chunks, t0 + cpb);
  for (int t = t0; t < t1; ++t) {
    const int64_t slot0 = static_cast<int64_t>(t) * chunk;
    for (int j = tid; j < chunk; j += NT) {
      const int aa = a[slot0 + j], bb = b[slot0 + j];
      if (aa >= 0 && bb >= 0) mark[aa] = 1;
    }
    const int w = in_id[t], g = out_id[t];
    const bool g_end = t + 1 == t1 || out_id[t + 1] != g;
    if (!PER_CHUNK && !g_end && in_id[t + 1] == w) continue;
    __syncthreads();
    // A warp covers 32 rows of one head (128 h is a multiple of 32).
    const int64_t win0 = static_cast<int64_t>(w) * BLK;
    for (int idx = tid; idx < BLK * h; idx += NT) {
      const int k = idx / BLK, r = idx - k * BLK;
      int v = neg;
      if (mark[r] && win0 + r < n_src) v = f2key(el[(win0 + r) * h + k]);
      v = __reduce_max_sync(0xffffffffu, v);
      if (lane == 0 && v != neg) atomicMax(&cm[k], v);
    }
    __syncthreads();
    for (int k = tid; k < h; k += NT) {
      if (PER_CHUNK) cmax[static_cast<int64_t>(t) * h + k] = key2f(cm[k]);
      gm[k] = max(gm[k], cm[k]);
      cm[k] = neg;
      if (g_end) {
        if (gm[k] != neg) atomicMax(&mkey[static_cast<int64_t>(g) * h + k], gm[k]);
        gm[k] = neg;
      }
    }
    for (int i = tid; i < BLK; i += NT) mark[i] = 0;
    __syncthreads();
  }
}

// bf16 mode: run[t, k], the running max of cmax over group out_id[t]'s
// chunks up to and including t. A block per (group, head) scans them 256
// at a time (max is exact, so this is the serial walk's value).
__global__ void __launch_bounds__(NT)
    attn_run_kernel(const int* __restrict__ out_id, int n_chunks,
                    const float* __restrict__ cmax, int h,
                    float* __restrict__ run) {
  __shared__ float wmax[NWARPS];
  const int g = blockIdx.x, k = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t0 = first_chunk(out_id, n_chunks, g);
  const int t1 = first_chunk(out_id, n_chunks, g + 1);
  float carry = -INFINITY;
  for (int base = t0; base < t1; base += NT) {
    const int t = base + threadIdx.x;
    float v = t < t1 ? cmax[static_cast<int64_t>(t) * h + k] : -INFINITY;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = fmaxf(v, y);
    }
    if (lane == 31) wmax[warp] = v;
    __syncthreads();
    float pre = carry, tot = carry;
    for (int w = 0; w < NWARPS; ++w) {
      if (w < warp) pre = fmaxf(pre, wmax[w]);
      tot = fmaxf(tot, wmax[w]);
    }
    if (t < t1) run[static_cast<int64_t>(t) * h + k] = fmaxf(v, pre);
    carry = tot;
    __syncthreads();
  }
}

// bf16 mode: the scale chunk u applies to its group's earlier terms,
// exp(leaky(er + run_{u-1}) - leaky(er + run_u)); exactly 1 where the
// running max did not move and at the group's first chunk.
__device__ __forceinline__ float online_scale(const int* __restrict__ out_id,
                                              const float* __restrict__ run,
                                              int u, int h, int k, float erv,
                                              float slope) {
  if (u == 0 || out_id[u - 1] != out_id[u]) return 1.f;
  const float r0 = run[static_cast<int64_t>(u - 1) * h + k];
  const float r1 = run[static_cast<int64_t>(u) * h + k];
  return r0 == r1 ? 1.f
                  : expf(leaky(erv + r0, slope) - leaky(erv + r1, slope));
}

// bf16 mode, pass 1: per (segment j of FWD_SEG chunks, hub row r, head k),
// the product of the scales of the segment's chunks of its first chunk's
// group, from the last of them down: float32 (lden) and rounded (lnum).
__global__ void __launch_bounds__(NT)
    attn_seg_kernel(const int* __restrict__ out_id, int n_chunks,
                    const float* __restrict__ run,
                    const float* __restrict__ er_g, int h, float slope,
                    float* __restrict__ lden, float* __restrict__ lnum) {
  const int n_seg = (n_chunks + FWD_SEG - 1) / FWD_SEG;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_seg) * BLK * h) return;
  const int j = static_cast<int>(i / (BLK * h));
  const int rk = static_cast<int>(i - static_cast<int64_t>(j) * BLK * h);
  const int r = rk / h, k = rk - r * h;
  const int s0 = j * FWD_SEG, e = min(n_chunks, s0 + FWD_SEG);
  const int g = out_id[s0];
  int ge = s0 + 1;
  while (ge < e && out_id[ge] == g) ++ge;
  const float erv = er_g[(static_cast<int64_t>(g) * BLK + r) * h + k];
  float ad = 1.f, an = 1.f;
  for (int u = ge - 1; u >= s0; --u) {
    const float s = online_scale(out_id, run, u, h, k, erv, slope);
    ad *= s;
    an *= rnd<true>(s);
  }
  lden[i] = ad;
  lnum[i] = an;
}

// bf16 mode, pass 2: per (hub row, head), over the segments from the last:
// the product of a segment's first group's scales from the segment's
// start to the group's end (the segment's own times the next segment's
// while the group runs on), in place.
__global__ void __launch_bounds__(NT)
    attn_segscan_kernel(const int* __restrict__ out_id, int n_chunks, int h,
                        float* __restrict__ lden, float* __restrict__ lnum) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= BLK * h) return;
  const int n_seg = (n_chunks + FWD_SEG - 1) / FWD_SEG;
  float gd = 1.f, gn = 1.f;
#pragma unroll 4
  for (int j = n_seg - 1; j >= 0; --j) {
    const int e = (j + 1) * FWD_SEG;
    const bool cont = e < n_chunks && out_id[e] == out_id[j * FWD_SEG];
    const int64_t o = static_cast<int64_t>(j) * BLK * h + i;
    gd = lden[o] * (cont ? gd : 1.f);
    gn = lnum[o] * (cont ? gn : 1.f);
    lden[o] = gd;
    lnum[o] = gn;
  }
}

// bf16 mode, pass 3: per (segment, hub row, head), each chunk's fden and
// fnum, walking the segment down from the next segment's product.
__global__ void __launch_bounds__(NT)
    attn_segapply_kernel(const int* __restrict__ out_id, int n_chunks,
                         const float* __restrict__ run,
                         const float* __restrict__ er_g, int h, float slope,
                         const float* __restrict__ gden,
                         const float* __restrict__ gnum,
                         float* __restrict__ fden, float* __restrict__ fnum) {
  const int n_seg = (n_chunks + FWD_SEG - 1) / FWD_SEG;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_seg) * BLK * h) return;
  const int j = static_cast<int>(i / (BLK * h));
  const int rk = static_cast<int>(i - static_cast<int64_t>(j) * BLK * h);
  const int r = rk / h, k = rk - r * h;
  const int s0 = j * FWD_SEG, e = min(n_chunks, s0 + FWD_SEG);
  const bool cont = e < n_chunks && out_id[e] == out_id[e - 1];
  const int64_t nx = i + static_cast<int64_t>(BLK) * h;  // segment j + 1
  float ad = cont ? gden[nx] : 1.f, an = cont ? gnum[nx] : 1.f;
  int g = -1;
  float erv = 0.f;
  for (int u = e - 1; u >= s0; --u) {
    const int gu = out_id[u];
    if (gu != g) {
      g = gu;
      erv = er_g[(static_cast<int64_t>(g) * BLK + r) * h + k];
    }
    const int64_t o = (static_cast<int64_t>(u) * BLK + r) * h + k;
    fden[o] = ad;
    fnum[o] = an;
    if (u == 0 || out_id[u - 1] != gu) {
      ad = an = 1.f;
    } else {
      const float s = online_scale(out_id, run, u, h, k, erv, slope);
      ad *= s;
      an *= rnd<true>(s);
    }
  }
}

__global__ void __launch_bounds__(NT)
    attn_bcast_kernel(const int* __restrict__ mkey, float* __restrict__ mraw,
                      int n_groups, int h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_groups) * BLK * h) return;
  const int64_t row = i / h, k = i - row * h;
  mraw[i] = key2f(mkey[(row / BLK) * h + k]);
}

// Stages window w's 128 rows of the stripe's ft columns (zeros past n_src
// and past the stripe) and their el into one buffer, and commits.
__device__ void fwd_stage(float* wbuf, float* ebuf, int w,
                          const float* __restrict__ ft,
                          const float* __restrict__ el, int n_src, int h,
                          int F, const FwdStripe& st, const FwdPlan& pl,
                          bool vec) {
  const int64_t row0 = static_cast<int64_t>(w) * BLK;
  const int nacc = pl.ws - 4;
  if (vec) {
    const int units = nacc / 4;
    for (int idx = threadIdx.x; idx < BLK * units; idx += FWD_NT) {
      const int r = idx / units, c = (idx - r * units) * 4;
      const bool ok = c < st.nc && row0 + r < n_src;
      cp_async16(wbuf + r * pl.ws + c,
                 ok ? ft + (row0 + r) * F + st.c0 + c : ft, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BLK * nacc; idx += FWD_NT) {
      const int r = idx / nacc, c = idx - r * nacc;
      const bool ok = c < st.nc && row0 + r < n_src;
      cp_async4(wbuf + r * pl.ws + c,
                ok ? ft + (row0 + r) * F + st.c0 + c : ft, ok ? 4 : 0);
    }
  }
  for (int idx = threadIdx.x; idx < BLK * pl.nhs; idx += FWD_NT) {
    const int r = idx / pl.nhs, k = idx - r * pl.nhs;
    const bool ok = k < st.nh && row0 + r < n_src;
    cp_async4(ebuf + idx, ok ? el + (row0 + r) * h + st.h0 + k : el,
              ok ? 4 : 0);
  }
  cp_async_commit();
}

template <bool DROP, bool BF16, bool HEAD4>
__global__ void __launch_bounds__(FWD_NT, 1)
    attn_fwd_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    const int* __restrict__ eid,
                    const int* __restrict__ in_id,
                    const int* __restrict__ out_id, int n_chunks, int chunk,
                    int cpb, const float* __restrict__ el,
                    const float* __restrict__ er_g,
                    const float* __restrict__ ft, int n_src,
                    const int* __restrict__ mkey,
                    const float* __restrict__ run,
                    const float* __restrict__ fden,
                    const float* __restrict__ fnum, int h, int d, FwdPlan pl,
                    float slope, const int* __restrict__ seed, int thresh,
                    float inv_keep, int n_seg, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int ws = pl.ws, nacc = ws - 4, nhs = pl.nhs, F = h * d;
  float* wbuf = smem;                    // 2 x BLK x ws: ft windows
  float* ebuf = wbuf + 2 * BLK * ws;     // 2 x BLK x nhs: el windows
  float* er_sh = ebuf + 2 * BLK * nhs;   // BLK x nhs: the group's er
  float* mz_sh = er_sh + BLK * nhs;      // BLK x nhs: leaky(er + mraw)
  const FwdStripe st = fwd_stripe(blockIdx.y, h, d, pl);
  // This warp's p * mask of its 32 current slots, per head (32 x nhs),
  // and their staged rows' offsets (32).
  float* pm_sh = mz_sh + BLK * nhs + (threadIdx.x / 32) * 32 * nhs;
  int* ro_sh = reinterpret_cast<int*>(mz_sh + BLK * nhs + FWD_NW * 32 * nhs) +
               (threadIdx.x / 32) * 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = pl.g, R = 32 / G, lj = lane / G, lu = lane % G;
  const unsigned FULL = 0xffffffffu;
  const int sd = DROP ? seed[0] : 0;
  const bool vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(ft) & 15) == 0;
  // This lane's four columns: whether they lie in the stripe, and their
  // heads within it.
  int hl[4];
  bool live[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int lc = 4 * lu + e;
    live[e] = lc < st.nc;
    hl[e] = live[e] ? (st.c0 + lc) / d - st.h0 : 0;
  }
  // Only the stripe that holds its heads' first columns sums den.
  const bool sums_den = st.c0 % d == 0;

  const int t0 = blockIdx.x * cpb, t1 = min(n_chunks, t0 + cpb);
  const int g_first = out_id[0];
  // A batch: the chunks from tb on that share its (group, window).
  auto batch_end = [&](int tb) {
    const int w = in_id[tb], g = out_id[tb];
    int te = tb + 1;
    while (te < t1 && in_id[te] == w && out_id[te] == g) ++te;
    return te;
  };
  // Each warp sums a hub row's run in registers (acc: its lanes' columns;
  // dreg: lane k, head k's den) across batches, and adds the sums, when
  // the row changes, with one float4 (or float) red.global.add a lane
  // into the block's zeroed partial of the group (the num block, rows
  // nacc floats apart, then the den block).
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, fn[4] = {1.f, 1.f, 1.f, 1.f};
  float dreg = 0.f;
  int cur = -1;   // (chunk from tb if BF16) << 7 | hub row of acc
  int dcur = -1;  // hub row of dreg
  int64_t ctb = 0;  // tb of cur's chunk numbers (BF16)
  float *sum_n = nullptr, *sum_d = nullptr;
  auto flush_row = [&]() {
    if (cur >= 0) {
      float* q = sum_n + (cur & (BLK - 1)) * nacc + 4 * lu;
      if (live[3]) {
        atomicAdd(reinterpret_cast<float4*>(q),
                  make_float4(acc[0] * fn[0], acc[1] * fn[HEAD4 ? 0 : 1],
                              acc[2] * fn[HEAD4 ? 0 : 2],
                              acc[3] * fn[HEAD4 ? 0 : 3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (live[e]) atomicAdd(q + e, acc[e] * fn[HEAD4 ? 0 : e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  };
  auto flush_den = [&]() {
    if (dcur >= 0 && lane < st.nh) atomicAdd(sum_d + dcur * nhs + lane, dreg);
    dreg = 0.f;
  };
  int tb = t0, te = batch_end(t0), buf = 0, cur_g = -1, acc_g = -1;
  fwd_stage(wbuf, ebuf, in_id[tb], ft, el, n_src, h, F, st, pl, vec);
  while (tb < t1) {
    const int tn = te, tne = tn < t1 ? batch_end(tn) : tn;
    // The next batch's window goes into the other buffer meanwhile.
    if (tn < t1)
      fwd_stage(wbuf + (buf ^ 1) * BLK * ws, ebuf + (buf ^ 1) * BLK * nhs,
                in_id[tn], ft, el, n_src, h, F, st, pl, vec);
    else
      cp_async_commit();
    const int g = out_id[tb];
    if (g != cur_g) {
      cur_g = g;
      for (int idx = tid; idx < BLK * nhs; idx += FWD_NT) {
        const int r = idx / nhs, k = idx - r * nhs;
        float er = 0.f, mz = 0.f;
        if (k < st.nh) {
          const int hk = st.h0 + k;
          er = er_g[(static_cast<int64_t>(g) * BLK + r) * h + hk];
          if (!BF16)
            mz = leaky(er + key2f(mkey[static_cast<int64_t>(g) * h + hk]),
                       slope);
        }
        er_sh[idx] = er;
        mz_sh[idx] = mz;
      }
    }
    cp_async_wait_prev();
    __syncthreads();

    // The walk: warp w takes the batch's rounds of 32 slots w, w + 16,
    // ... (where a window's slots come as long runs of one hub row, then
    // many short ones, every warp gets its share of both).
    // First a lane a slot: p for each head of the stripe into pm_sh (0 on
    // padding) and the slot's staged row into ro_sh; den's terms summed
    // over the warp where the 32 share a hub row, kept by lane k for head
    // k until the row changes. Then lanes over columns, lane group lj the
    // slots lj, lj + R, ...: where the 32 share a row (and chunk, BF16),
    // a walk without branches (each slot's ft row times its p * mask,
    // padding adding 0), else one slot at a time.
    const float* wb = wbuf + buf * BLK * ws + 4 * lu;
    const float* eb = ebuf + buf * BLK * nhs;
    const int64_t slot0 = static_cast<int64_t>(tb) * chunk;
    const int S = (te - tb) * chunk;
    constexpr int STEP = 32 * FWD_NW;  // slots from one round to a warp's next
    if (g != acc_g) {  // the sums so far belong to the last group's rows
      flush_row();
      cur = -1;
      if (sums_den) flush_den();
      dcur = -1;
      acc_g = g;
      sum_n = part + (static_cast<int64_t>(blockIdx.y) * n_seg + blockIdx.x +
                      g - g_first) * BLK * (nacc + nhs);
      sum_d = sum_n + BLK * nacc;
    }
    if (BF16) {  // chunk numbers in cur count from this batch's tb
      if (cur >= 0) {
        flush_row();
        cur = -1;
      }
      ctb = tb;
    }
    // The next 32 slots' a and b (and edge ids), loaded a round ahead.
    int na = -1, nb = -1, ne = 0;
    if (32 * warp + lane < S) {
      na = a[slot0 + 32 * warp + lane];
      nb = b[slot0 + 32 * warp + lane];
      if (DROP) ne = eid[slot0 + 32 * warp + lane];
    }
    for (int base = 32 * warp; base < S; base += STEP) {
      const int i = base + lane;
      const int aa = na, bb = nb, ev = ne;
      if (i + STEP < S) {
        na = a[slot0 + i + STEP];
        nb = b[slot0 + i + STEP];
        if (DROP) ne = eid[slot0 + i + STEP];
      }
      const bool real = i < S && aa >= 0 && bb >= 0;
      const int ci = BF16 ? i / chunk : 0;
      const int key = real ? (ci << 14 | bb << 7 | aa) : -1;
      const unsigned reals = __ballot_sync(FULL, real);
      if (reals == 0u) continue;
      const int r0 = __shfl_sync(FULL, key >> 7, __ffs(reals) - 1);
      const bool one_row = __all_sync(FULL, !real || (key >> 7) == r0);
      const int a0 = real ? aa : 0, b0 = real ? bb : 0;
      const int64_t t = tb + ci;
      ro_sh[lane] = a0 * ws;
      if (sums_den && one_row && (r0 & (BLK - 1)) != dcur) {
        flush_den();
        dcur = r0 & (BLK - 1);
      }
      // Where the 32 hold several rows: each run of equal rows (lanes
      // [run head, e]) sums its den terms, and its head adds them.
      const int rk = real ? bb : -1;
      const int rk_next = __shfl_down_sync(FULL, rk, 1);
      const int rk_prev = __shfl_up_sync(FULL, rk, 1);
      const unsigned ends = __ballot_sync(FULL, lane == 31 || rk_next != rk);
      const int e = lane + __ffs(ends >> lane) - 1;
      const bool run_head = real && (lane == 0 || rk_prev != rk);
#pragma unroll 4
      for (int k = 0; k < st.nh; ++k) {
        const int hk = st.h0 + k;
        const float er = er_sh[b0 * nhs + k];
        const float mz = BF16 ? leaky(er + run[t * h + hk], slope)
                              : mz_sh[b0 * nhs + k];
        const float p = expf(leaky(eb[a0 * nhs + k] + er, slope) - mz);
        const float pm = rnd<BF16>(
            DROP ? p * drop_scale(ev, hk, sd, thresh, inv_keep) : p);
        float dt = BF16 ? rnd<true>(p) * fden[(t * BLK + b0) * h + hk] : p;
        pm_sh[lane * nhs + k] = real ? pm : 0.f;
        dt = real ? dt : 0.f;
        if (sums_den) {
          if (one_row) {
            for (int o = 16; o > 0; o >>= 1)
              dt += __shfl_xor_sync(FULL, dt, o);
            if (lane == k) dreg += dt;
          } else {
            for (int o = 1; o < 32; o <<= 1) {
              const float y = __shfl_down_sync(FULL, dt, o);
              if (lane + o <= e) dt += y;
            }
            if (run_head) atomicAdd(sum_d + bb * nhs + k, dt);
          }
        }
      }
      __syncwarp();
      if (one_row) {
        if (r0 != cur) {
          if (cur >= 0) flush_row();
          cur = r0;
          if (BF16) {
            const int64_t o = ((ctb + (r0 >> 7)) * BLK + (r0 & (BLK - 1))) * h;
#pragma unroll
            for (int e = 0; e < (HEAD4 ? 1 : 4); ++e)
              fn[e] = fnum[o + st.h0 + hl[e]];
          }
        }
        if (live[0]) {
#pragma unroll 8
          for (int s = lj; s < 32; s += R) {
            const float4 v4 = *reinterpret_cast<const float4*>(wb + ro_sh[s]);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
            const float* pr = pm_sh + s * nhs;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pm = pr[hl[HEAD4 ? 0 : e]];
              acc[e] = BF16 ? acc[e] + rnd<true>(pm * rnd<true>(v[e]))
                            : fmaf(pm, v[e], acc[e]);
            }
          }
        }
      } else {
        for (int s = lj; s < 32; s += R) {
          const int k = __shfl_sync(FULL, key, s);
          if (k < 0 || !live[0]) continue;
          const int row = k >> 7;
          if (row != cur) {
            if (cur >= 0) flush_row();
            cur = row;
            if (BF16) {
              const int64_t o =
                  ((ctb + (row >> 7)) * BLK + (row & (BLK - 1))) * h;
#pragma unroll
              for (int e = 0; e < (HEAD4 ? 1 : 4); ++e)
                fn[e] = fnum[o + st.h0 + hl[e]];
            }
          }
          const float4 v4 = *reinterpret_cast<const float4*>(wb + ro_sh[s]);
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
          const float* pr = pm_sh + s * nhs;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pm = pr[hl[HEAD4 ? 0 : e]];
            acc[e] = BF16 ? acc[e] + rnd<true>(pm * rnd<true>(v[e]))
                          : fmaf(pm, v[e], acc[e]);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();
    tb = tn;
    te = tne;
    buf ^= 1;
  }
  flush_row();
  if (sums_den) flush_den();
}

// Sums the partials of the blocks whose run of chunks met each group, in
// block order, into every element of num and den (zero where no chunk
// names the group). A thread per output element.
__global__ void __launch_bounds__(NT)
    attn_fold_kernel(const int* __restrict__ out_id, int n_chunks, int cpb,
                     int n_groups, int h, int d, FwdPlan pl, int n_seg,
                     const float* __restrict__ part, float* __restrict__ num,
                     float* __restrict__ den) {
  const int F = h * d, W = F + h, nacc = pl.ws - 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_groups) * BLK * W) return;
  const int64_t row = i / W;
  const int c = static_cast<int>(i - row * W);
  const int g = static_cast<int>(row / BLK), r = static_cast<int>(row % BLK);
  // The column's stripe and its place in the stripe's partial.
  int y, off;
  if (c < F) {
    const int hdc = c / d, in_head = c - hdc * d;
    if (d > FWD_COLS) {
      const int sub = in_head / FWD_COLS;
      y = hdc * pl.nsub + sub;
      off = r * nacc + in_head - sub * FWD_COLS;
    } else {
      y = hdc / pl.nhs;
      off = r * nacc + c - y * pl.nhs * d;
    }
  } else {
    const int k = c - F;
    y = d > FWD_COLS ? k * pl.nsub : k / pl.nhs;
    off = BLK * nacc + r * pl.nhs + (d > FWD_COLS ? 0 : k - y * pl.nhs);
  }
  const int t0 = first_chunk(out_id, n_chunks, g);
  const int t1 = first_chunk(out_id, n_chunks, g + 1);
  float s = 0.f;
  if (t0 < t1) {
    const int64_t blk = static_cast<int64_t>(BLK) * (nacc + pl.nhs);
    const int seg0 = g - out_id[0];
    for (int x = t0 / cpb; x <= (t1 - 1) / cpb; ++x)
      s += part[(static_cast<int64_t>(y) * n_seg + x + seg0) * blk + off];
  }
  if (c < F) num[row * F + c] = s; else den[row * h + (c - F)] = s;
}

// ---------------------------------------------------------------------
// K7: GAT backward, to_src=True, over the window-major layout.
//
// Replaces _attn_bwd_kernel(to_src=True), which recomputes p per chunk,
// accumulates gft/gel per window over consecutive chunks in VMEM and
// writes one per-chunk (128, 128) block of group-side q partials. Per
// real slot (hub row a of group in_id[t], window row b of window
// out_id[t]) and head it recomputes
//   acoef = exp(leaky(el_s + er_a) - lse_a)      (lse = mz + log den)
//   g     = <ft_s, ct_a> over the head's D features
//   q     = acoef * (g * mask - rho_a) * leaky'(el_s + er_a)
// then gel_s += q, the chunk's partial gerp[t, a] += q, and gft_s +=
// acoef * mask * ct_a.
//
// Bound on the H100: bytes. At arxiv layer 1 (H=8, D=32) the data are a
// and b (43.4 MB), ft (173.4 MB) and el read once, the group rows (small),
// gft (173.4 MB) and gel written once, and the narrow partials (21.7 MB):
// ~126 us at 3.35 TB/s. A thread per (slot, head) gathering ft and ct rows
// from L2 and adding gft with a shared atomic per slot and column (the
// earlier design) waits on those gathers and atomics. This design:
//
// * A block owns one (window, stripe of heads) and walks the window's
//   chunks in batches of consecutive chunks of one group (up to 4,096
//   slots). It stages the group's ct rows of its stripe (128 rows, by
//   16-byte cp.async) and their er, lse and rho in shared memory once per
//   group, so no ct row is gathered from L2 per slot.
// * The batch's real slots are counting-sorted by window row b in shared
//   memory, stably (ranks within each 32-slot step from seven ballots on
//   b's bits), so within a row they keep the layout's order by hub row:
//   the slots of one (b, a) pair of one chunk are one run. The power-law
//   generator repeats edges (the arxiv layout's 4.39 M real slots form
//   1.25 M runs); all slots of a run share ft_b, ct_a, acoef and the dot,
//   and differ only in the dropout mask.
// * Warps own window rows, split by equal shares of the sorted slots. A
//   warp walks a row's runs R at a time: lane (run j, head k, part p)
//   holds up to 32 of head k's features (G parts a head, G a power of two
//   with 32 G >= D; R = 32 / (heads x G), 8 at H=8, D=32), takes its
//   run's dot from registers and shared memory and G-part shuffles, and
//   adds its run's terms to its registers: n_kept * acoef * inv_keep *
//   ct_a to gft, n_kept * q_kept + n_dropped * q_dropped to gel and to the
//   chunk's partial (one shared atomic per run and head; stored once per
//   chunk). At the row's end a reduce-scatter over the R lanes of each
//   (head, part) leaves each lane 32 / R summed features, stored once (the
//   first batch of a window stores, later ones add: no atomics).
// * 95 KB of shared memory a block at arxiv layer 1 (111 KB with
//   dropout), so two blocks share an SM and one's staging and sort run
//   under the other's walk.
//
// BF16 rounds ft and ct, each product ft * ct before the head sum, acoef *
// mask, its product with ct and q (before every sum it enters), and lse
// and rho only when 3H > 128 (below that the reference packs [er | lse |
// rho] into one float32 block it does not round). The slots of a run give
// equal rounded terms, so n * term is the sum the reference takes.
// ---------------------------------------------------------------------
constexpr int SRC_SORT = 4096;       // slots sorted per batch
constexpr int SRC_SORT_WIDE = 1024;  // ... when ct rows are over 128 wide
constexpr int SRC_GP = 8192;         // floats of chunk partials per batch
constexpr int SRC_SPL = SRC_SORT / NT;  // slots a lane loads for the sort
constexpr int SRC_COLS = 32;         // features a lane holds
constexpr size_t SRC_SMEM_MAX = 227 * 1024;  // sm_90's opt-in per block

// A K7 block's plan: G lanes per head part (32 G >= d), cpl features per
// part (a multiple of 4, at most 32), hs heads per stripe, R runs walked
// together, ct rows of w floats (the stripe's hs * d) at stride ws, maxs
// slots and nb chunks per batch.
struct SrcPlan {
  int g, cpl, hs, r, w, ws, maxs, nb;
};

size_t src_smem(const SrcPlan& p, bool drop) {
  return sizeof(float) * (static_cast<size_t>(BLK) * p.ws +
                          static_cast<size_t>(3 + p.nb) * BLK * p.hs) +
         sizeof(int) * (NWARPS * BLK + BLK + 1 + 4 + NWARPS * 33 +
                        (drop ? p.maxs : 0)) +
         sizeof(uint16_t) * p.maxs;
}

SrcPlan src_plan(int h, int d, int chunk, bool drop) {
  SrcPlan p;
  p.g = 1;
  while (SRC_COLS * p.g < d) p.g *= 2;
  p.cpl = ((d + p.g - 1) / p.g + 3) / 4 * 4;
  // Heads share a stripe only while it stays 128 wide (one head when d >
  // 128), so the staged ct rows fit in shared memory up to MAX_COLS.
  int cap = 32 / p.g;
  const int by_w = d < BLK ? BLK / d : 1;
  if (by_w < cap) cap = by_w;
  if (h < cap) cap = h;
  p.hs = 1;
  while (2 * p.hs <= cap) p.hs *= 2;
  p.r = 32 / (p.hs * p.g);
  p.w = p.hs * d;
  p.ws = (p.w + 3) / 4 * 4 + 4;  // +4: rows start in other bank groups
  p.maxs = p.w > BLK ? SRC_SORT_WIDE : SRC_SORT;
  const int by_gp = SRC_GP / (BLK * p.hs);
  p.nb = chunk > 0 ? p.maxs / chunk : 0;
  if (p.nb > (by_gp > 1 ? by_gp : 1)) p.nb = by_gp > 1 ? by_gp : 1;
  // Fewer chunks a batch where small chunks would pass the opt-in limit.
  while (p.nb > 1 && src_smem(p, drop) > SRC_SMEM_MAX) --p.nb;
  return p;
}

// The lanes of this step whose window row equals this lane's (7 bits).
__device__ __forceinline__ unsigned row_peers(bool real, int bb) {
  unsigned peers = __ballot_sync(0xffffffffu, real);
#pragma unroll
  for (int bit = 0; bit < 7; ++bit) {
    const bool on = (bb >> bit) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, real && on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// The first n (<= 32) features of a row segment; absent ones read 0.
template <bool BF16>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int n,
                                          bool vec, float (&v)[SRC_COLS]) {
#pragma unroll
  for (int c = 0; c < SRC_COLS; c += 4) {
    if (vec && c + 4 <= n) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + c));
      v[c] = x.x; v[c + 1] = x.y; v[c + 2] = x.z; v[c + 3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[c + e] = c + e < n ? __ldg(p + c + e) : 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < SRC_COLS; ++c) v[c] = rnd<BF16>(v[c]);
}

// Four staged ct features from shared memory (16-byte aligned when vec,
// else the first n of them, the rest 0).
__device__ __forceinline__ float4 ct4(const float* p, bool vec, int n) {
  return vec ? *reinterpret_cast<const float4*>(p)
             : make_float4(p[0], n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                           n > 3 ? p[3] : 0.f);
}

// One step of a reduce-scatter over lanes o apart (none when o < 1):
// the lane keeps the half of v[0, 2 HALF) its bit o selects, summed with
// its partner's, in v[0, HALF).
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[SRC_COLS], int lj, int o) {
  if (o < 1) return;
  const bool up = (lj & o) != 0;
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float send = up ? v[c] : v[c + HALF];
    const float keep = up ? v[c + HALF] : v[c];
    v[c] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <bool DROP, bool BF16>
__global__ void __launch_bounds__(NT, 2)
    attn_bwd_src_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        const int* __restrict__ eid,
                        const int* __restrict__ in_id,
                        const int* __restrict__ out_id, int n_chunks,
                        int chunk, const float* __restrict__ el,
                        const float* __restrict__ er_g,
                        const float* __restrict__ lse_g,
                        const float* __restrict__ rho_g,
                        const float* __restrict__ ft,
                        const float* __restrict__ ct_g, int h, int d,
                        SrcPlan pl, float slope, const int* __restrict__ seed,
                        int thresh, float inv_keep, float* __restrict__ gft,
                        float* __restrict__ gel, float* __restrict__ gerp) {
  extern __shared__ __align__(16) float smem[];
  const int hs = pl.hs, R = pl.r, ws = pl.ws;
  float* ct_sh = smem;                             // BLK x ws
  float* st_sh = ct_sh + BLK * ws;                 // er, lse, rho: 3 x BLK x hs
  float* gp_sh = st_sh + 3 * BLK * hs;             // nb x BLK x hs
  int* cnt_sh = reinterpret_cast<int*>(gp_sh + pl.nb * BLK * hs);  // 8 x BLK
  int* start_sh = cnt_sh + NWARPS * BLK;           // BLK + 1
  int* wsum_sh = start_sh + BLK + 1;               // 4
  int* runs_sh = wsum_sh + 4;                      // 8 x 33 run starts
  int* eid_sh = runs_sh + NWARPS * 33;             // maxs (DROP)
  uint16_t* key_sh =
      reinterpret_cast<uint16_t*>(eid_sh + (DROP ? pl.maxs : 0));  // maxs

  const Stripe st = stripe_of(blockIdx.y, hs, h, d);
  const int F = h * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Lane (run j, part p, head k): j fastest.
  const int lj = lane % R, lp = (lane / R) % pl.g, lk = lane / (R * pl.g);
  const bool live = lk < st.nh;
  const int hc0 = lp * pl.cpl;                     // first feature of part
  const int ncol = live ? max(0, min(pl.cpl, d - hc0)) : 0;
  const int w = blockIdx.x;
  const int64_t win0 = static_cast<int64_t>(w) * BLK;
  const int sd = DROP ? seed[0] : 0;
  const bool rstats = BF16 && 3 * h > BLK;
  const bool vec = (d & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(ft) |
                     reinterpret_cast<uintptr_t>(ct_g)) & 15) == 0;
  int* my_runs = runs_sh + warp * 33;

  // This window's chunks: [lower_bound(w), lower_bound(w + 1)).
  const int t0 = first_chunk(out_id, n_chunks, w);
  const int t1 = first_chunk(out_id, n_chunks, w + 1);

  int staged = -1;
  bool first = true;
  for (int tb = t0;;) {
    // A batch: up to nb consecutive chunks of one group (none when the
    // window has no chunk: every row is then written as zeros).
    const int grp = tb < t1 ? in_id[tb] : -1;
    int te = tb;
    if (tb < t1) {
      te = tb + 1;
      while (te < t1 && te - tb < pl.nb && in_id[te] == grp) ++te;
    }
    const int nbc = te - tb, ns = nbc * chunk;
    const bool restage = grp >= 0 && grp != staged;
    if (restage) {
      staged = grp;
      const int64_t grp0 = static_cast<int64_t>(grp) * BLK;
      const int units = pl.w / 4;
      if (vec) {
        for (int idx = tid; idx < BLK * units; idx += NT) {
          const int r = idx / units, c = (idx - r * units) * 4;
          const bool ok = c < st.nf;
          cp_async16(ct_sh + r * ws + c,
                     ok ? ct_g + (grp0 + r) * F + st.c0 + c : ct_g,
                     ok ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < BLK * pl.w; idx += NT) {
          const int r = idx / pl.w, c = idx - r * pl.w;
          const bool ok = c < st.nf;
          cp_async4(ct_sh + r * ws + c,
                    ok ? ct_g + (grp0 + r) * F + st.c0 + c : ct_g, ok ? 4 : 0);
        }
      }
      for (int idx = tid; idx < BLK * hs; idx += NT) {
        const int r = idx / hs, k = idx - r * hs;
        float er = 0.f, lse = 0.f, rho = 0.f;
        if (k < st.nh) {
          const int64_t o = (grp0 + r) * h + st.h0 + k;
          er = er_g[o];
          lse = lse_g[o];
          rho = rho_g[o];
          if (rstats) {
            lse = rnd<true>(lse);
            rho = rnd<true>(rho);
          }
        }
        st_sh[idx] = er;
        st_sh[BLK * hs + idx] = lse;
        st_sh[2 * BLK * hs + idx] = rho;
      }
    }
    for (int i = tid; i < nbc * BLK * hs; i += NT) gp_sh[i] = 0.f;
    for (int i = tid; i < NWARPS * BLK; i += NT) cnt_sh[i] = 0;

    // Stable counting sort of the batch's real slots by window row b:
    // warp w takes the slots [w ns / 8, (w+1) ns / 8) in order, counts
    // them per b, and later scatters them after the counts of the warps
    // before it, ranked within each 32-slot step by row_peers.
    const int64_t slot0 = static_cast<int64_t>(tb) * chunk;
    const int s_lo = static_cast<int>(static_cast<int64_t>(warp) * ns / NWARPS);
    const int s_hi =
        static_cast<int>(static_cast<int64_t>(warp + 1) * ns / NWARPS);
    // The warp's slots, loaded together: (b << 7 | a), or -1 for padding.
    int pk[SRC_SPL], ek[DROP ? SRC_SPL : 1];
#pragma unroll
    for (int u = 0; u < SRC_SPL; ++u) {
      const int i = s_lo + 32 * u + lane;
      pk[u] = -1;
      if (i < s_hi) {
        const int aa = a[slot0 + i], bb = b[slot0 + i];
        if (aa >= 0 && bb >= 0) pk[u] = bb << 7 | aa;
        if constexpr (DROP) ek[u] = eid[slot0 + i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SRC_SPL; ++u) {
      if (s_lo + 32 * u >= s_hi) break;
      const bool real = pk[u] >= 0;
      const int bb = pk[u] >> 7;
      const unsigned peers = row_peers(real, bb);
      if (real && lane == __ffs(peers) - 1)
        cnt_sh[warp * BLK + bb] += __popc(peers);
    }
    __syncthreads();
    int tot = 0, incl = 0;
    if (tid < BLK) {
      for (int v = 0; v < NWARPS; ++v) tot += cnt_sh[v * BLK + tid];
      incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum_sh[warp] = incl;
    }
    __syncthreads();
    if (tid < BLK) {
      int run = incl - tot;
      for (int v = 0; v < warp; ++v) run += wsum_sh[v];
      start_sh[tid] = run;
      for (int v = 0; v < NWARPS; ++v) {
        const int c = cnt_sh[v * BLK + tid];
        cnt_sh[v * BLK + tid] = run;
        run += c;
      }
      if (tid == BLK - 1) start_sh[BLK] = run;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SRC_SPL; ++u) {
      if (s_lo + 32 * u >= s_hi) break;
      const bool real = pk[u] >= 0;
      const int bb = pk[u] >> 7;
      const unsigned peers = row_peers(real, bb);
      if (real) {
        const int i = s_lo + 32 * u + lane;
        const int dst =
            cnt_sh[warp * BLK + bb] + __popc(peers & ((1u << lane) - 1u));
        key_sh[dst] = static_cast<uint16_t>(((i / chunk) << 7) |
                                            (pk[u] & (BLK - 1)));
        if constexpr (DROP) eid_sh[dst] = ek[u];
      }
      __syncwarp();
      if (real && lane == __ffs(peers) - 1)
        cnt_sh[warp * BLK + bb] += __popc(peers);
      __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();
    if (BF16 && restage) {
      for (int i = tid; i < BLK * ws; i += NT) ct_sh[i] = rnd<true>(ct_sh[i]);
      __syncthreads();
    }

    // Warp w's rows: those whose sorted slots start in its equal share.
    const int S = start_sh[BLK];
    const int want_lo = static_cast<int>(static_cast<int64_t>(warp) * S / NWARPS);
    const int want_hi =
        warp == NWARPS - 1
            ? S + 1
            : static_cast<int>(static_cast<int64_t>(warp + 1) * S / NWARPS);
    int rb = 0, re = 0;
    for (int v = BLK; v > 0; v >>= 1) {  // first r with start[r] >= want
      if (rb + v <= BLK && start_sh[rb + v - 1] < want_lo) rb += v;
      if (re + v <= BLK && start_sh[re + v - 1] < want_hi) re += v;
    }
    for (int r = rb; r < re; ++r) {
      const int s0 = start_sh[r], s1 = start_sh[r + 1];
      if (s0 == s1 && !first) continue;
      const int64_t row = win0 + r;
      float acc[SRC_COLS];
#pragma unroll
      for (int c = 0; c < SRC_COLS; ++c) acc[c] = 0.f;
      float gacc = 0.f;
      if (s0 < s1) {
        float fv[SRC_COLS];
        load_cols<BF16>(ft + row * F + st.c0 + lk * d + hc0, ncol, vec, fv);
        const float elv = live ? el[row * h + st.h0 + lk] : 0.f;
        for (int pos = s0; pos < s1;) {
          // The runs of equal (chunk, hub row) keys that start in
          // [pos, pos + 32) and end by s1 or inside that window.
          const int i = pos + lane;
          const int kk = i < s1 ? key_sh[i] : -1;
          const int prev = __shfl_up_sync(0xffffffffu, kk, 1);
          const unsigned starts =
              __ballot_sync(0xffffffffu, i < s1 && (lane == 0 || kk != prev));
          if (starts & (1u << lane))
            my_runs[__popc(starts & ((1u << lane) - 1u))] = lane;
          const int nr = __popc(starts);
          const bool tail_open = pos + 32 < s1;  // the last run may go on
          if (!tail_open && lane == 0) my_runs[nr] = s1 - pos;
          __syncwarp();
          const int take = min(R, tail_open ? nr - 1 : nr);
          int s = 0, n = 0, next;
          if (take == 0) {
            // One run of 32 slots or more from pos: find its end.
            const int k0 = __shfl_sync(0xffffffffu, kk, 0);
            int e = pos + 32;
            for (;;) {
              const int ii = e + lane;
              const unsigned m =
                  __ballot_sync(0xffffffffu, ii < s1 && key_sh[ii] == k0);
              const int c = m == 0xffffffffu ? 32 : __ffs(~m) - 1;
              e += c;
              if (c < 32) break;
            }
            next = e;
            if (lj == 0) {
              s = pos;
              n = e - pos;
            }
          } else {
            next = pos + my_runs[take];
            if (lj < take) {
              s = pos + my_runs[lj];
              n = my_runs[lj + 1] - my_runs[lj];
            }
          }
          __syncwarp();
          // This lane's run: the dot over its part, then over the parts.
          const int key = key_sh[n > 0 ? s : pos];
          const int aa = key & (BLK - 1);
          const float* crow = ct_sh + aa * ws + lk * d + hc0;
          // Four partial sums: the 32 terms are not one dependent chain.
          float pp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < SRC_COLS; c += 4) {
            if (c < ncol) {
              const float4 v = ct4(crow + c, vec, ncol - c);
              const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                pp[e] = BF16 ? pp[e] + rnd<true>(fv[c + e] * vv[e])
                             : fmaf(fv[c + e], vv[e], pp[e]);
            }
          }
          float p = (pp[0] + pp[1]) + (pp[2] + pp[3]);
          for (int o = R; o < R * pl.g; o <<= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
          if (n > 0 && live) {
            const int hr = aa * hs + lk;
            const float sv = elv + st_sh[hr];
            const float acoef = expf(leaky(sv, slope) - st_sh[BLK * hs + hr]);
            const float rho = st_sh[2 * BLK * hs + hr];
            const float dl = sv >= 0.f ? 1.f : slope;
            int kept = n;
            if (DROP) {
              kept = 0;
              for (int j = 0; j < n; ++j)
                kept += drop_scale(eid_sh[s + j], st.h0 + lk, sd, thresh,
                                   inv_keep) != 0.f;
            }
            const float m1 = DROP ? inv_keep : 1.f;
            float qs = static_cast<float>(kept) *
                       rnd<BF16>(acoef * (p * m1 - rho) * dl);
            if (DROP && kept < n)
              qs += static_cast<float>(n - kept) *
                    rnd<BF16>(acoef * (0.f - rho) * dl);
            const float am = rnd<BF16>(acoef * m1);
            const float wk = static_cast<float>(kept);
            gacc += qs;
            if (lp == 0) atomicAdd(&gp_sh[((key >> 7) * BLK + aa) * hs + lk], qs);
#pragma unroll
            for (int c = 0; c < SRC_COLS; c += 4) {
              if (c < ncol) {
                const float4 v = ct4(crow + c, vec, ncol - c);
                acc[c] = fmaf(wk, rnd<BF16>(am * v.x), acc[c]);
                acc[c + 1] = fmaf(wk, rnd<BF16>(am * v.y), acc[c + 1]);
                acc[c + 2] = fmaf(wk, rnd<BF16>(am * v.z), acc[c + 2]);
                acc[c + 3] = fmaf(wk, rnd<BF16>(am * v.w), acc[c + 3]);
              }
            }
          }
          pos = next;
        }
      }
      // Reduce-scatter over the R run lanes of each (head, part): lane j
      // ends with the features [j * 32 / R, (j + 1) * 32 / R) of its part
      // in acc[0 ..], and gel's sum.
      halve<16>(acc, lj, R >> 1);
      halve<8>(acc, lj, R >> 2);
      halve<4>(acc, lj, R >> 3);
      halve<2>(acc, lj, R >> 4);
      halve<1>(acc, lj, R >> 5);
      for (int o = 1; o < R; o <<= 1)
        gacc += __shfl_xor_sync(0xffffffffu, gacc, o);
      // gft_b and gel_b: the first batch stores, later ones add.
      if (live) {
        const int per = SRC_COLS / R, c0 = lj * per;
        float* gr = gft + row * F + st.c0 + lk * d + hc0 + c0;
        const int nc = min(per, ncol - c0);
        if (vec && per >= 4 && nc == per) {
#pragma unroll
          for (int c = 0; c < SRC_COLS; c += 4) {
            if (c < per) {
              float4* p4 = reinterpret_cast<float4*>(gr + c);
              float4 v = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
              if (!first) {
                const float4 o = *p4;
                v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
              }
              *p4 = v;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < SRC_COLS; ++c)
            if (c < nc) gr[c] = first ? acc[c] : gr[c] + acc[c];
        }
        if (lj == 0 && lp == 0) {
          float* gp = gel + row * h + st.h0 + lk;
          *gp = first ? gacc : *gp + gacc;
        }
      }
    }
    __syncthreads();
    // The batch's chunk partials: every (row, head) of the stripe, once.
    for (int idx = tid; idx < nbc * BLK * st.nh; idx += NT) {
      const int rr = idx / st.nh, k = idx - rr * st.nh;
      gerp[(static_cast<int64_t>(tb) * BLK + rr) * h + st.h0 + k] =
          gp_sh[rr * hs + k];
    }
    first = false;
    tb = te;
    if (tb >= t1) break;
    __syncthreads();  // gp_sh, the sort arrays and the stage are reused
  }
}


// ---------------------------------------------------------------------
// K7 g-major: GAT backward, to_src=False, over the forward layout.
//
// Replaces _attn_bwd_kernel(to_src=False), which the reference runs when
// the backward layout has no gperm descriptors: it computes grad_er
// straight from the group-major forward layout, carrying each group's
// (128, 128) output block across its consecutive chunks in VMEM. In this
// layout a slot's a is the source row within window in_id[t] and b the
// hub row within group out_id[t]. Per real slot and head it recomputes
// K7's q (acoef, the full-width per-head dot <ft_s, ct_b> and the
// jacobian row term rho_b; see attn_bwd_src_kernel) and adds it to
// grad_er[b]; rows no slot reaches are zero.
//
// Bound on the H100: bytes. At arxiv layer 1 (H=8, D=32) the data are a
// and b (43.4 MB), ft (173.4 MB) and el read once, the group rows (er,
// lse, rho, ct: small) and grad_er (n_groups * 128 * H) written once:
// ~66 us at 3.35 TB/s. The dots, 2 x 256 FLOP a slot (2.2 GFLOP), take
// ~34 us at 67 TFLOP/s; but each slot's ft row has to reach the lanes
// that hold its hub row's ct, and those 4.4 GB of shared-memory reads
// (1 KB a slot) take ~150 us at 128 bytes a clock an SM.
//
// The earlier design (a thread per (slot, head) that gathered both rows
// from L2, its own 128-byte runs, and added q to a shared (128 x H)
// block with a float atomic, a compare-and-swap loop on this card: at
// arxiv 35 M adds on 1,024 words) took 40x its bound. This one:
//
// * A 16-warp block owns a stripe of hs whole heads (at most 128
//   columns, or one head up to 384) and a run of consecutive chunks,
//   taken in batches of the chunks that share a (group, window), at most
//   abcap slots a batch. It stages the next batch, its window (the stripe
//   of ft for 128 rows and their el) and its slots' a, b and eid, by
//   16-byte cp.async into one of two buffers while it walks the current
//   one, and the group's er, lse, rho and (where they fit) ct rows once
//   per group; otherwise ct rows come through L1, and where two batches
//   do not fit, one. The walk reads nothing from global memory but those
//   ct rows: a batch's descriptors and first slots loaded only when the
//   batch starts cost a global round trip a batch.
// * Warps take the batch's 32-slot rounds interleaved (contiguous shares
//   were slower: the padding at a run's end falls to a few warps). Lane
//   (j, p, k) takes slot j of each step of R = 32 / (hs x g) slots, part
//   p of head k (g parts of cpl <= 32 features). It holds its slot's hub
//   row of ct in registers, reloaded when the row
//   changes (a window's slots come in runs of equal b: 14.6 runs a chunk
//   at arxiv), reads the slot's ft part from the staged window with
//   16-byte loads, all before it adds any, each lane starting at its own
//   chunk (lane % 8: the eight lanes of a quarter-warp then read eight
//   distinct bank groups where rows are a multiple of 32 floats apart),
//   and sums the head over its g parts with shuffles. Where every lane
//   holds 32 features (VM == 2) the chunk offsets are fixed and no load
//   is guarded.
// * q is summed per hub row without a shared atomic. A warp keeps the
//   running sum of its current hub row in its lanes' registers while a
//   step's slots all name that row (most steps); at a step that changes
//   the row it adds the sum over its j lanes to its own (128 x hs)
//   partial in shared memory, and any slot of a row neither before nor
//   after the change one at a time, in order of j. When the group changes
//   and at the run's end the warps' partials are summed in warp order
//   into the block's slot of a global partial (block + group - first
//   group, as K6), and attn_grp_fold_kernel sums the slots of each group
//   in block order into every element of grad_er. No atomics: two runs
//   give the same bits, as the reference's in-order sweep does.
//
// What holds it back (PERF.md, section 6): the walk, most of a block's
// time at arxiv layer 1, issues ~140 instructions a step of 8 slots and
// waits on its shared-memory chain (a, b, then the row, then 32 FMAs,
// then the exp); staging and waiting take the rest.
//
// BF16: as attn_bwd_src_kernel (ft, ct, their products, q; lse and rho
// when 3H > 128); the staged window is rounded once, in shared memory, by
// the threads that copied it, ct as it is staged or loaded, and the
// products two at a time (rnd2).
// ---------------------------------------------------------------------
constexpr int GRP_NT = 512;           // threads of a K7 g-major block
constexpr int GRP_NW = GRP_NT / 32;
constexpr int GRP_COLS = 32;          // features a lane holds
constexpr size_t GRP_SMEM_MAX = 227 * 1024;  // sm_90's opt-in per block

// A K7 g-major plan (made by the wrapper, ops/attn_kernels.py grp_plan):
// hs heads a stripe (a power of two), g lanes a head (a power of two,
// 32 g >= d), cpl features a lane (a multiple of 4, at most 32, g cpl >=
// d), staged rows ws floats apart, nbuf batches staged at once (window
// and slots), slots a batch's staged a, b and eid hold at most (abcap, a
// multiple of 4), ctsh 1 where the group's ct rows are staged too.
struct GrpPlan {
  int hs, g, cpl, ws, nbuf, abcap, ctsh;
};

// Floats of one staged batch: the ft window, its el, and the slots' a, b
// and eid.
__host__ __device__ __forceinline__ int grp_buf(const GrpPlan& p) {
  return BLK * (p.ws + p.hs) + 3 * p.abcap;
}

size_t grp_smem(const GrpPlan& p) {
  // nbuf staged batches, the group's ct rows, its er, lse and rho, and
  // each warp's partial of q.
  return sizeof(float) *
         (static_cast<size_t>(p.nbuf) * grp_buf(p) +
          static_cast<size_t>(p.ctsh) * BLK * p.ws +
          static_cast<size_t>(3 + GRP_NW) * BLK * p.hs);
}

bool grp_plan_ok(const GrpPlan& p, int h, int d, int chunk) {
  const bool pow2 = (p.hs & (p.hs - 1)) == 0 && (p.g & (p.g - 1)) == 0;
  return p.hs >= 1 && p.g >= 1 && pow2 && p.hs * p.g <= 32 &&
         (p.hs == 1 || p.hs <= h) && p.cpl >= 4 && p.cpl % 4 == 0 &&
         p.cpl <= GRP_COLS && p.g * p.cpl >= d && p.ws >= p.hs * d &&
         ((d & 3) != 0 || p.ws % 4 == 0) && (p.nbuf == 1 || p.nbuf == 2) &&
         chunk >= 1 && p.abcap >= chunk &&
         p.abcap % 4 == 0 && (p.ctsh == 0 || p.ctsh == 1) &&
         grp_smem(p) <= GRP_SMEM_MAX;
}

// Calls f(r, c) for this thread's elements tid, tid + GRP_NT, ... of a
// 128 x n tile in row-major order, stepping rows and columns without a
// division an element.
template <typename Fn>
__device__ __forceinline__ void grp_tile(int n, Fn f) {
  const int dr = GRP_NT / n, dc = GRP_NT - dr * n;
  int r = threadIdx.x / n, c = threadIdx.x - r * n;
  while (r < BLK) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// Stages batch [tb, te)'s window w (the stripe of ft for its 128 rows,
// zeros past n_src; and their el) and its slots' a, b and (DROP) eid into
// one buffer, and commits. With BF16 the same thread later rounds the ft
// elements it copied (grp_round).
template <bool VEC, bool DROP>
__device__ void grp_stage(float* buf, const GrpPlan& pl, int w, int64_t s0,
                          int ns, const int* __restrict__ a,
                          const int* __restrict__ b,
                          const int* __restrict__ eid,
                          const float* __restrict__ ft,
                          const float* __restrict__ el, int n_src, int h,
                          int F, const Stripe& st, bool abvec) {
  const int64_t row0 = static_cast<int64_t>(w) * BLK;
  const int ws = pl.ws, hs = pl.hs;
  float* ebuf = buf + BLK * ws;
  int* abuf = reinterpret_cast<int*>(ebuf + BLK * hs);
  int* bbuf = abuf + pl.abcap;
  int* ibuf = bbuf + pl.abcap;
  if (VEC) {
    grp_tile(st.nf / 4, [&](int r, int u) {
      const bool ok = row0 + r < n_src;
      cp_async16(buf + r * ws + 4 * u,
                 ok ? ft + (row0 + r) * F + st.c0 + 4 * u : ft, ok ? 16 : 0);
    });
  } else {
    grp_tile(st.nf, [&](int r, int c) {
      const bool ok = row0 + r < n_src;
      cp_async4(buf + r * ws + c, ok ? ft + (row0 + r) * F + st.c0 + c : ft,
                ok ? 4 : 0);
    });
  }
  grp_tile(hs, [&](int r, int k) {
    const bool ok = k < st.nh && row0 + r < n_src;
    cp_async4(ebuf + r * hs + k, ok ? el + (row0 + r) * h + st.h0 + k : el,
              ok ? 4 : 0);
  });
  if (abvec) {
    for (int i = 4 * threadIdx.x; i < ns; i += 4 * GRP_NT) {
      cp_async16(abuf + i, a + s0 + i, 16);
      cp_async16(bbuf + i, b + s0 + i, 16);
      if (DROP) cp_async16(ibuf + i, eid + s0 + i, 16);
    }
  } else {
    for (int i = threadIdx.x; i < ns; i += GRP_NT) {
      cp_async4(abuf + i, a + s0 + i, 4);
      cp_async4(bbuf + i, b + s0 + i, 4);
      if (DROP) cp_async4(ibuf + i, eid + s0 + i, 4);
    }
  }
  cp_async_commit();
}

// bf16 mode: rounds x and y to bfloat16 (nearest even) with one packed
// conversion, where rnd<true> takes one each: the conversion pipe runs at
// a quarter of the FMA rate, and it bounds the bf16 dots.
__device__ __forceinline__ void rnd2(float& x, float& y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  x = __low2float(v);
  y = __high2float(v);
}

// BF16: rounds the ft elements this thread staged (grp_stage's loops),
// once they have landed.
template <bool VEC>
__device__ void grp_round(float* wbuf, const Stripe& st, int ws) {
  if (VEC) {
    grp_tile(st.nf / 4, [&](int r, int u) {
      float4* p = reinterpret_cast<float4*>(wbuf + r * ws + 4 * u);
      float4 v = *p;
      rnd2(v.x, v.y);
      rnd2(v.z, v.w);
      *p = v;
    });
  } else {
    grp_tile(st.nf, [&](int r, int c) {
      wbuf[r * ws + c] = rnd<true>(wbuf[r * ws + c]);
    });
  }
}

// A batch: its window, group and end, the first chunk from tb on with
// another window or group, or past maxc chunks, or t1. Lane i of the
// warp gives chunk tb + i's window and group (dw, dg; loaded ahead).
struct GrpBatch {
  int w, g, te;
};

__device__ __forceinline__ GrpBatch grp_batch(const int* __restrict__ in_id,
                                              const int* __restrict__ out_id,
                                              int tb, int t1, int maxc,
                                              int dw, int dg) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  GrpBatch bt;
  bt.w = __shfl_sync(FULL, dw, 0);
  bt.g = __shfl_sync(FULL, dg, 0);
  const int end = min(t1, tb + maxc);
  unsigned m = __ballot_sync(FULL,
                             tb + lane >= end || dw != bt.w || dg != bt.g);
  int base = tb;
  while (m == 0) {  // a batch of more than 32 chunks
    base += 32;
    const int t = base + lane;
    const int w = t < end ? in_id[t] : -1, g = t < end ? out_id[t] : -1;
    m = __ballot_sync(FULL, t >= end || w != bt.w || g != bt.g);
  }
  bt.te = base + __ffs(m) - 1;
  return bt;
}

// VM: 0 rows of any width through 4-byte loads, 1 rows of a multiple of 4
// floats through 16-byte loads, 2 the same where every lane holds 32
// features (eight 16-byte chunks: no guards, rotations by a mask).
template <bool DROP, bool BF16, int VM>
__global__ void __launch_bounds__(GRP_NT, 1)
    attn_bwd_grp_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        const int* __restrict__ eid,
                        const int* __restrict__ in_id,
                        const int* __restrict__ out_id, int n_chunks,
                        int chunk, int cpb, const float* __restrict__ el,
                        int n_src, const float* __restrict__ er_g,
                        const float* __restrict__ lse_g,
                        const float* __restrict__ rho_g,
                        const float* __restrict__ ft,
                        const float* __restrict__ ct_g, int h, int d,
                        GrpPlan pl, float slope, const int* __restrict__ seed,
                        int thresh, float inv_keep, int n_seg,
                        float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int hs = pl.hs, ws = pl.ws, F = h * d, nbf = grp_buf(pl);
  float* ct_sh = smem + pl.nbuf * nbf;         // ctsh x BLK x ws: ct rows
  float* st_sh = ct_sh + pl.ctsh * BLK * ws;   // er, lse, rho: 3 x BLK x hs
  float* wp_sh = st_sh + 3 * BLK * hs;         // GRP_NW x BLK x hs partials
  const Stripe st = stripe_of(blockIdx.y, hs, h, d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned FULL = 0xffffffffu;
  // Lane (slot j, part p, head k), j fastest.
  const int R = 32 / (hs * pl.g);
  const int lj = lane % R, lp = (lane / R) % pl.g, lk = lane / (R * pl.g);
  const int hc0 = lp * pl.cpl;  // the part's first feature in its head
  const bool live = lk < st.nh && hc0 < d;
  const int ncol = live ? min(pl.cpl, d - hc0) : 0;
  const int col = lk * d + hc0;  // ... and column in the stripe
  constexpr bool VEC = VM > 0, F8 = VM == 2;
  const int nch = F8 ? 8 : (ncol + 3) / 4;
  const int rot = nch > 0 ? (lane & 7) % nch : 0;  // VEC: first chunk read
  // VEC: the offset of the lane's c-th chunk of a row, 4 ((c + rot) %
  // nch) floats (the ft reads, the ct loads and cv's order).
  int coff[GRP_COLS / 4];
#pragma unroll
  for (int c = 0; c < GRP_COLS / 4; ++c)
    coff[c] =
        4 * (F8 ? (c + rot) & 7 : (c + rot < nch ? c + rot : c + rot - nch));
  float* wp = wp_sh + warp * BLK * hs;
  const int sd = DROP ? seed[0] : 0;
  const bool rstats = BF16 && 3 * h > BLK;
  const int maxc = pl.abcap / chunk;  // chunks a batch at most
  const bool abvec = chunk % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b) |
                       (DROP ? reinterpret_cast<uintptr_t>(eid) : 0)) & 15) ==
                         0;

  for (int i = tid; i < GRP_NW * BLK * hs; i += GRP_NT) wp_sh[i] = 0.f;

  const int t0 = blockIdx.x * cpb, t1 = min(n_chunks, t0 + cpb);
  if (t0 >= t1) return;
  const int g_first = out_id[0];

  // The lane's ct part of hub row crow (VEC: register chunk c holds the
  // row's chunk (c + rot) % nch) and the row's er, lse and rho for head k.
  float cv[GRP_COLS];
  int crow = -1;
  float erv = 0.f, lsev = 0.f, rhov = 0.f;
  // The warp's current hub row (the same in every lane) and the lanes'
  // running sums of its q.
  int cur = -1;
  float qacc = 0.f;
  // Adds the running sums, summed over the j lanes, to the warp's partial.
  auto flush_q = [&]() {
    float s = qacc;
    for (int o = 1; o < R; o <<= 1) s += __shfl_xor_sync(FULL, s, o);
    if (cur >= 0 && lj == 0 && lp == 0 && live) wp[cur * hs + lk] += s;
    qacc = 0.f;
  };
  // The warps' partials of group g, summed in warp order, to the block's
  // slot; the partials are zeroed.
  auto merge = [&](int g) {
    __syncthreads();
    float* dst = part + (static_cast<int64_t>(blockIdx.y) * n_seg +
                         blockIdx.x + g - g_first) * BLK * hs;
    for (int i = tid; i < BLK * hs; i += GRP_NT) {
      float s = 0.f;
      for (int w = 0; w < GRP_NW; ++w) {
        s += wp_sh[w * BLK * hs + i];
        wp_sh[w * BLK * hs + i] = 0.f;
      }
      dst[i] = s;
    }
    __syncthreads();
  };
  // Lane i's chunk descriptors from chunk tx on: loaded a batch ahead.
  int dw, dg;
  auto load_desc = [&](int tx) {
    dw = tx + lane < t1 ? in_id[tx + lane] : -1;
    dg = tx + lane < t1 ? out_id[tx + lane] : -1;
  };
  auto stage = [&](float* buf, const GrpBatch& bt, int tx) {
    grp_stage<VEC, DROP>(buf, pl, bt.w, static_cast<int64_t>(tx) * chunk,
                         (bt.te - tx) * chunk, a, b, eid, ft, el, n_src, h, F,
                         st, abvec);
  };
  load_desc(t0);
  GrpBatch cb = grp_batch(in_id, out_id, t0, t1, maxc, dw, dg);  // this
  GrpBatch nbt = cb;                                              // next
  if (cb.te < t1) {
    load_desc(cb.te);
    nbt = grp_batch(in_id, out_id, cb.te, t1, maxc, dw, dg);
  }
  int tb = t0, buf = 0, cur_g = -1;
  if (pl.nbuf == 2) stage(smem, cb, t0);
  while (tb < t1) {
    const int te = cb.te, tn = te;
    const int g = cb.g;
    const int64_t grp0 = static_cast<int64_t>(g) * BLK;
    if (g != cur_g) {  // the same in every thread of the block
      flush_q();
      cur = -1;
      crow = -1;
      if (cur_g >= 0) merge(cur_g);
      cur_g = g;
      grp_tile(hs, [&](int r, int k) {
        float er = 0.f, lse = 0.f, rho = 0.f;
        if (k < st.nh) {
          const int64_t o = (grp0 + r) * h + st.h0 + k;
          er = er_g[o];
          lse = lse_g[o];
          rho = rho_g[o];
          if (rstats) {
            lse = rnd<true>(lse);
            rho = rnd<true>(rho);
          }
        }
        st_sh[r * hs + k] = er;
        st_sh[(BLK + r) * hs + k] = lse;
        st_sh[(2 * BLK + r) * hs + k] = rho;
      });
      if (pl.ctsh) {
        grp_tile(st.nf, [&](int r, int c) {
          ct_sh[r * ws + c] =
              rnd<BF16>(__ldg(ct_g + (grp0 + r) * F + st.c0 + c));
        });
      }
    }
    float* cbuf = smem;
    if (pl.nbuf == 2) {
      // The next batch goes into the other buffer meanwhile.
      if (tn < t1)
        stage(smem + (buf ^ 1) * nbf, nbt, tn);
      else
        cp_async_commit();
      cp_async_wait_prev();
      cbuf += buf * nbf;
    } else {
      stage(smem, cb, tb);
      cp_async_wait_all();
    }
    const float* wb = cbuf;
    const float* eb = cbuf + BLK * ws;
    const int* ab = reinterpret_cast<const int*>(eb + BLK * hs);
    const int* bbv = ab + pl.abcap;
    const int* ib = bbv + pl.abcap;
    if (BF16) grp_round<VEC>(cbuf, st, ws);
    // The batch after the next: its descriptors load during this walk.
    if (nbt.te < t1) load_desc(nbt.te);
    __syncthreads();

    // The walk: warp w takes the batch's rounds of 32 slots w, w + 16, ...
    const int S = (te - tb) * chunk;
    for (int base = 32 * warp; base < S; base += 32 * GRP_NW) {
      {
        const int i = base + lane;
        const bool r0 = i < S && ab[i] >= 0 && bbv[i] >= 0;
        if (!__any_sync(FULL, r0)) continue;  // a run's padding tail
      }
      for (int s0 = 0; s0 < 32; s0 += R) {
        const int i = base + s0 + lj;
        const int aa = i < S ? ab[i] : -1, bb = i < S ? bbv[i] : -1;
        const bool real = aa >= 0 && bb >= 0;
        const bool on = real && live;
        const float elv = on ? eb[aa * hs + lk] : 0.f;
        if (on && bb != crow) {  // this lane's hub row changed
          crow = bb;
          if (pl.ctsh) {
            const float* cg = ct_sh + bb * ws + col;
            if (VEC) {
#pragma unroll
              for (int c = 0; c < GRP_COLS / 4; ++c) {
                if (F8 || c < nch) {
                  const float4 v =
                      *reinterpret_cast<const float4*>(cg + coff[c]);
                  cv[4 * c] = v.x;
                  cv[4 * c + 1] = v.y;
                  cv[4 * c + 2] = v.z;
                  cv[4 * c + 3] = v.w;
                }
              }
            } else {
#pragma unroll
              for (int c = 0; c < GRP_COLS; ++c)
                if (c < ncol) cv[c] = cg[c];
            }
          } else {
            const float* cg = ct_g + (grp0 + bb) * F + st.c0 + col;
            if (VEC) {
#pragma unroll
              for (int c = 0; c < GRP_COLS / 4; ++c) {
                if (F8 || c < nch) {
                  float4 v =
                      __ldg(reinterpret_cast<const float4*>(cg + coff[c]));
                  if (BF16) {
                    rnd2(v.x, v.y);
                    rnd2(v.z, v.w);
                  }
                  cv[4 * c] = v.x;
                  cv[4 * c + 1] = v.y;
                  cv[4 * c + 2] = v.z;
                  cv[4 * c + 3] = v.w;
                }
              }
            } else {
#pragma unroll
              for (int c = 0; c < GRP_COLS; ++c)
                if (c < ncol) cv[c] = rnd<BF16>(__ldg(cg + c));
            }
          }
          const int hr = bb * hs + lk;
          erv = st_sh[hr];
          lsev = st_sh[BLK * hs + hr];
          rhov = st_sh[2 * BLK * hs + hr];
        }
        // The dot over the lane's part (its ft loads first, then four
        // partial sums), then over the head's g parts.
        float pp[4] = {0.f, 0.f, 0.f, 0.f};
        if (on) {
          const float* fr = wb + aa * ws + col;
          if (VEC) {
            float4 x[GRP_COLS / 4];
#pragma unroll
            for (int c = 0; c < GRP_COLS / 4; ++c) {
              if (F8 || c < nch) {
                x[c] = *reinterpret_cast<const float4*>(fr + coff[c]);
              }
            }
#pragma unroll
            for (int c = 0; c < GRP_COLS / 4; ++c) {
              if (F8 || c < nch) {
                if (BF16) {
                  float y[4] = {x[c].x * cv[4 * c], x[c].y * cv[4 * c + 1],
                                x[c].z * cv[4 * c + 2],
                                x[c].w * cv[4 * c + 3]};
                  rnd2(y[0], y[1]);
                  rnd2(y[2], y[3]);
#pragma unroll
                  for (int e = 0; e < 4; ++e) pp[e] += y[e];
                } else {
                  pp[0] = fmaf(x[c].x, cv[4 * c], pp[0]);
                  pp[1] = fmaf(x[c].y, cv[4 * c + 1], pp[1]);
                  pp[2] = fmaf(x[c].z, cv[4 * c + 2], pp[2]);
                  pp[3] = fmaf(x[c].w, cv[4 * c + 3], pp[3]);
                }
              }
            }
          } else {
#pragma unroll
            for (int c = 0; c < GRP_COLS; ++c)
              if (c < ncol)
                pp[c & 3] = BF16 ? pp[c & 3] + rnd<true>(fr[c] * cv[c])
                                 : fmaf(fr[c], cv[c], pp[c & 3]);
          }
        }
        float gv = (pp[0] + pp[1]) + (pp[2] + pp[3]);
        for (int o = R; o < R * pl.g; o <<= 1)
          gv += __shfl_xor_sync(FULL, gv, o);
        float q = 0.f;
        if (on) {
          const float sv = elv + erv;
          const float acoef = expf(leaky(sv, slope) - lsev);
          const float dl = sv >= 0.f ? 1.f : slope;
          const float m =
              DROP ? drop_scale(ib[i], st.h0 + lk, sd, thresh, inv_keep)
                   : 1.f;
          q = rnd<BF16>(acoef * (gv * m - rhov) * dl);
        }
        // q onto its hub row.
        if (__all_sync(FULL, !real || bb == cur)) {
          qacc += q;
          continue;
        }
        qacc += real && bb == cur ? q : 0.f;
        // The row of the step's last real slot goes on in registers.
        const int last = 31 - __clz(__ballot_sync(FULL, real));
        const int ncur = __shfl_sync(FULL, bb, last);
        const int old = cur;
        if (ncur != cur) {
          flush_q();
          cur = ncur;
          qacc = real && bb == ncur ? q : 0.f;
        }
        // Slots of other rows: one at a time, in order of j.
        unsigned todo = __ballot_sync(
            FULL, real && bb != old && bb != ncur && lp == 0 && lk == 0);
        while (todo) {
          const int jj = __ffs(todo) - 1;
          todo &= todo - 1;
          if (lj == jj && lp == 0 && live) wp[bb * hs + lk] += q;
          __syncwarp();
        }
      }
    }
    __syncthreads();
    tb = tn;
    cb = nbt;
    if (cb.te < t1) nbt = grp_batch(in_id, out_id, cb.te, t1, maxc, dw, dg);
    buf ^= 1;
  }
  flush_q();
  if (cur_g >= 0) merge(cur_g);
}

// Sums the slots of the blocks whose run of chunks met each group, in
// block order, into every element of grad_er (zero where no chunk names
// the group). A thread per output element.
__global__ void __launch_bounds__(NT)
    attn_grp_fold_kernel(const int* __restrict__ out_id, int n_chunks,
                         int cpb, int n_groups, int h, int hs, int n_seg,
                         const float* __restrict__ part,
                         float* __restrict__ ger) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<int64_t>(n_groups) * BLK * h) return;
  const int64_t row = i / h;
  const int k = static_cast<int>(i - row * h);
  const int g = static_cast<int>(row / BLK), r = static_cast<int>(row % BLK);
  const int y = k / hs, kk = k - y * hs;
  const int t0 = first_chunk(out_id, n_chunks, g);
  const int t1 = first_chunk(out_id, n_chunks, g + 1);
  float s = 0.f;
  if (t0 < t1) {
    const int seg0 = g - out_id[0];
    for (int x = t0 / cpb; x <= (t1 - 1) / cpb; ++x)
      s += part[((static_cast<int64_t>(y) * n_seg + x + seg0) * BLK + r) * hs +
                kk];
  }
  ger[i] = s;
}

// ---------------------------------------------------------------------
// K8: out[g] = the sum of gerp[gperm[k]] over the chunks k with
// gout[k] = g, blocks of (128 x H) floats; zero for a group no chunk
// reaches.
//
// Replaces _ger_reduce_kernel (attention.py:612), an in-order sweep over
// the chunks in gperm order that adds each partial block to its group's
// accumulator and flushes it at the next group's gfirst.
//
// Bound on the H100: bytes, one read of the partials (21.7 MB at arxiv
// layer 1: 6.5 us) and one write of the output. At arxiv every chunk
// folds into one group, so the fold is a column sum of a 5,292 x 1,024
// matrix: it has to be split along the chunks and the pieces summed
// again, without 5,292 / n adds landing on one address.
//
// Design: two passes, no atomics and a fixed order of summation, so every
// run gives the same bits. Pass 1 (ger_part_kernel): n_parts blocks (two
// an SM, ger_parts), block b over the chunks [b * cpb, (b + 1)
// * cpb) in gperm order, whose gperm and gout entries it stages in
// shared memory first (one round of loads). The (128 x H) block is read
// as float4 columns, W = min(32 H, NT) columns a pass, so at H = 1 a
// block's 256 threads take 8 chunks at a time (NT / W sub-streams)
// rather than idling half of them. gout is sorted, so the range splits
// into group segments where it changes; a thread sums its column over
// its sub-stream's chunks of a segment in registers, X8_UNROLL 16-byte
// loads in flight, and the sub-streams are added in shared memory in
// order. A segment that holds its whole group is written to out; any
// other to the scratch slot part[b + g], distinct for every (block,
// group) pair since consecutive ranges share at most one group. Pass 2
// (ger_fold_kernel): a block per (group, FOLD_W float4 columns) finds the
// group's chunks by a search of the whole block over gout (NT samples a
// round), then adds the slots of the blocks whose ranges split the
// group, in block order (NT / FOLD_W sub-streams, then shared memory),
// writes zeros for a group no chunk reaches and leaves the groups pass 1
// wrote. Pass 2 is a programmatic dependent launch, so its launch and its
// search overlap pass 1.
// ---------------------------------------------------------------------
constexpr int X8_UNROLL = 8;
constexpr int FOLD_W = 8;
// Chunks a pass-1 block takes at most: its gperm and gout entries are
// staged in shared memory (8 bytes a chunk). ger_parts sizes n_parts so.
constexpr int GER_CPB_MAX = 4096;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// First index in [lo, hi) whose gout exceeds g (gout sorted).
__device__ __forceinline__ int group_end(const int* gout, int lo, int hi,
                                         int g) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gout[mid] <= g)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The group's chunks [lo, hi) in the sorted gout[0, n), found by the
// whole block: each round loads NT samples at once and keeps the slices
// that hold the two boundaries, so n = 5,292 takes two rounds of loads.
__device__ int2 block_group_range(const int* __restrict__ gout, int n,
                                  int g) {
  int lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;  // ranges of lo and of hi
  while (hi0 - lo0 > NT || hi1 - lo1 > NT) {
    const int s0 = max(1, (hi0 - lo0 + NT - 1) / NT);
    const int s1 = max(1, (hi1 - lo1 + NT - 1) / NT);
    const int i0 = lo0 + (threadIdx.x + 1) * s0 - 1;
    const int i1 = lo1 + (threadIdx.x + 1) * s1 - 1;
    const int v0 = i0 < hi0 ? gout[i0] : 0, v1 = i1 < hi1 ? gout[i1] : 0;
    const int c0 = __syncthreads_count(i0 < hi0 && v0 < g);
    const int c1 = __syncthreads_count(i1 < hi1 && v1 <= g);
    hi0 = min(hi0, lo0 + (c0 + 1) * s0);
    lo0 += c0 * s0;
    hi1 = min(hi1, lo1 + (c1 + 1) * s1);
    lo1 += c1 * s1;
  }
  const int i0 = lo0 + threadIdx.x, i1 = lo1 + threadIdx.x;
  const int v0 = i0 < hi0 ? gout[i0] : 0, v1 = i1 < hi1 ? gout[i1] : 0;
  const int c0 = __syncthreads_count(i0 < hi0 && v0 < g);
  const int c1 = __syncthreads_count(i1 < hi1 && v1 <= g);
  return make_int2(lo0 + c0, lo1 + c1);
}

__global__ void __launch_bounds__(NT)
    ger_part_kernel(const int* __restrict__ gperm,
                    const int* __restrict__ gout, int n_chunks, int cpb,
                    int n_groups, const float4* __restrict__ gerp, int blk4,
                    float4* __restrict__ part, float4* __restrict__ out) {
  extern __shared__ int stage[];  // gperm[k0, k1), then gout[k0 - 1, k1]
  __shared__ float4 sh[NT];
  // Pass 2 may start now: it searches gout, then waits for this grid.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int b = blockIdx.x;
  const int k0 = b * cpb, nk = min(n_chunks, k0 + cpb) - k0;
  int* perm_s = stage;
  int* gout_s = stage + cpb + 1;  // gout_s[i] = gout[k0 + i], -1 off the ends
  for (int i = threadIdx.x; i < nk; i += NT) perm_s[i] = gperm[k0 + i];
  for (int i = static_cast<int>(threadIdx.x) - 1; i <= nk; i += NT)
    gout_s[i] = k0 + i >= 0 && k0 + i < n_chunks ? gout[k0 + i] : -1;
  __syncthreads();
  const int w = min(blk4, NT), n_sub = NT / w;
  const int sub = threadIdx.x / w, col = threadIdx.x % w;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cbase = 0; cbase < blk4; cbase += w) {
    const int c = cbase + col;
    const bool live = sub < n_sub && c < blk4;
    for (int ks = 0; ks < nk;) {
      const int g = gout_s[ks];
      const int ke = group_end(gout_s, ks, nk, g);
      float4 acc = zero;
      if (live) {
        for (int k = ks + sub; k < ke; k += X8_UNROLL * n_sub) {
          float4 v[X8_UNROLL];
#pragma unroll
          for (int u = 0; u < X8_UNROLL; ++u) {
            const int kk = k + u * n_sub;
            v[u] = kk < ke ? gerp[static_cast<size_t>(perm_s[kk]) * blk4 + c]
                           : zero;
          }
#pragma unroll
          for (int u = 0; u < X8_UNROLL; ++u) acc = add4(acc, v[u]);
        }
      }
      const bool whole = gout_s[ks - 1] != g && gout_s[ke] != g;
      float4* dst = whole ? out + static_cast<size_t>(g) * blk4
                          : part + static_cast<size_t>(b + g) * blk4;
      const bool valid = g >= 0 && g < n_groups;
      if (n_sub == 1) {
        if (live && valid) dst[c] = acc;
      } else {
        sh[threadIdx.x] = acc;
        __syncthreads();
        if (sub == 0 && c < blk4 && valid) {
          float4 r = sh[col];
          for (int q = 1; q < n_sub; ++q) r = add4(r, sh[q * w + col]);
          dst[c] = r;
        }
        __syncthreads();
      }
      ks = ke;
    }
  }
}

__global__ void __launch_bounds__(NT)
    ger_fold_kernel(const int* __restrict__ gout, int n_chunks, int cpb,
                    int blk4, const float4* __restrict__ part,
                    float4* __restrict__ out) {
  __shared__ float4 sh[NT];
  constexpr int n_sub = NT / FOLD_W;
  const int g = blockIdx.y;
  const int col = threadIdx.x % FOLD_W, sub = threadIdx.x / FOLD_W;
  const int c = blockIdx.x * FOLD_W + col;
  // The group's chunks [lo, hi) and the pass-1 blocks b0..b1 over them.
  const int2 r = block_group_range(gout, n_chunks, g);
  const int lo = r.x, hi = r.y;
  const int b0 = lo / cpb, b1 = hi > lo ? (hi - 1) / cpb : b0 - 1;
  if (b0 == b1) return;  // one block held the whole group and wrote it
  // Pass 1 (the grid launched before this one) has finished and its
  // slots are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < blk4)
    for (int b = b0 + sub; b <= b1; b += n_sub)
      acc = add4(acc, part[static_cast<size_t>(b + g) * blk4 + c]);
  sh[threadIdx.x] = acc;
  __syncthreads();
  if (sub == 0 && c < blk4) {
    float4 r = sh[col];
    for (int q = 1; q < n_sub; ++q) r = add4(r, sh[q * FOLD_W + col]);
    out[static_cast<size_t>(g) * blk4 + c] = r;
  }
}

int g_num_sms = 0;

int num_sms() {
  if (g_num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_num_sms <= 0) g_num_sms = 132;
  }
  return g_num_sms;
}

// K8's pass-1 blocks: two an SM, more where a block would stage more than
// GER_CPB_MAX chunks, never more than the chunks.
int ger_parts(int n_chunks) {
  int n = (n_chunks + GER_CPB_MAX - 1) / GER_CPB_MAX;
  if (n < 2 * num_sms()) n = 2 * num_sms();
  if (n > n_chunks) n = n_chunks;
  return n < 1 ? 1 : n;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The instantiation of a kernel template <bool DROP, bool BF16> that the
// run asks for.
#define PICK(kernel, drop, bf16)                                  \
  ((drop) ? ((bf16) ? kernel<true, true> : kernel<true, false>)   \
          : ((bf16) ? kernel<false, true> : kernel<false, false>))

// Chunks per block: about four blocks per SM over all stripes.
int chunks_per_block(int n_chunks, int n_stripes) {
  const int target = 4 * num_sms();
  const int cpc = static_cast<int>(
      (static_cast<int64_t>(n_chunks) * n_stripes + target - 1) / target);
  return cpc < 1 ? 1 : cpc;
}

// K6's instantiation: template <bool DROP, bool BF16, bool HEAD4>.
using FwdKernel = void (*)(const int*, const int*, const int*, const int*,
                           const int*, int, int, int, const float*,
                           const float*, const float*, int, const int*,
                           const float*, const float*, const float*, int, int,
                           FwdPlan, float, const int*, int, float, int,
                           float*);

template <bool DROP, bool BF16>
FwdKernel pick_fwd2(bool head4) {
  return head4 ? attn_fwd_kernel<DROP, BF16, true>
               : attn_fwd_kernel<DROP, BF16, false>;
}

FwdKernel pick_fwd(bool drop, bool bf16, bool head4) {
  return drop ? (bf16 ? pick_fwd2<true, true>(head4)
                      : pick_fwd2<true, false>(head4))
              : (bf16 ? pick_fwd2<false, true>(head4)
                      : pick_fwd2<false, false>(head4));
}

// K6's grid: about as many blocks as the card holds at once, split over
// the stripes, each a run of cpb chunks; n_seg partials a stripe (the
// blocks' segments are block + group - out_id[0]).
struct FwdLaunch {
  size_t smem;
  int n_stripes, cpb, nblk, n_seg;
};

bool fwd_plan_ok(const FwdPlan& p, int h, int d) {
  const int widest = d > FWD_COLS ? FWD_COLS : p.nhs * d;
  return p.nhs >= 1 && p.nhs <= h && p.nhs <= 32 && p.nsub >= 1 &&
         (d > FWD_COLS ? p.nhs == 1 && p.nsub * FWD_COLS >= d
                       : p.nhs * d <= FWD_COLS) &&
         p.g >= 1 && p.g <= 32 && (p.g & (p.g - 1)) == 0 &&
         4 * p.g >= widest && p.ws % 4 == 0 && p.ws - 4 >= widest &&
         fwd_smem(p) <= FWD_SMEM_MAX;
}

cudaError_t fwd_launch(int n_chunks, int n_groups, int h, int d,
                       const FwdPlan& pl, FwdKernel kern, FwdLaunch* out) {
  out->smem = fwd_smem(pl);
  out->n_stripes = fwd_stripes(pl, h, d);
  cudaError_t e = set_smem(kern, out->smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FWD_NT,
                                                    out->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  int per_stripe = per_sm * num_sms() / out->n_stripes;
  if (per_stripe < 1) per_stripe = 1;
  out->cpb = (n_chunks + per_stripe - 1) / per_stripe;
  if (out->cpb < 1) out->cpb = 1;
  out->nblk = (n_chunks + out->cpb - 1) / out->cpb;
  out->n_seg = out->nblk + n_groups;
  return cudaSuccess;
}

// Floats of K6's scratch: in the bf16 mode cmax and run (n_chunks x h),
// fden and fnum (n_chunks x 128 x h) and the segment products (2 x n_seg
// x 128 x h); then the partials (stripes x n_seg x 128 x (ws - 4 + nhs));
// each part rounded up to 4 floats.
int64_t fwd_scratch(int n_chunks, int h, int bf16, const FwdPlan& pl,
                    const FwdLaunch& ln) {
  auto r4 = [](int64_t n) { return (n + 3) / 4 * 4; };
  int64_t n = r4(static_cast<int64_t>(ln.n_stripes) * ln.n_seg * BLK *
                 (pl.ws - 4 + pl.nhs));
  if (bf16) {
    const int64_t n_seg = (n_chunks + FWD_SEG - 1) / FWD_SEG;
    n += 2 * r4(static_cast<int64_t>(n_chunks) * h) +
         2 * r4(static_cast<int64_t>(n_chunks) * BLK * h) +
         2 * r4(n_seg * BLK * h);
  }
  return n;
}

// K7 g-major's instantiation: template <bool DROP, bool BF16, int VM>.
using GrpKernel = void (*)(const int*, const int*, const int*, const int*,
                           const int*, int, int, int, const float*, int,
                           const float*, const float*, const float*,
                           const float*, const float*, int, int, GrpPlan,
                           float, const int*, int, float, int, float*);

template <bool DROP, bool BF16>
GrpKernel pick_grp2(int vm) {
  return vm == 2   ? attn_bwd_grp_kernel<DROP, BF16, 2>
         : vm == 1 ? attn_bwd_grp_kernel<DROP, BF16, 1>
                   : attn_bwd_grp_kernel<DROP, BF16, 0>;
}

GrpKernel pick_grp(bool drop, bool bf16, int vm) {
  return drop ? (bf16 ? pick_grp2<true, true>(vm)
                      : pick_grp2<true, false>(vm))
              : (bf16 ? pick_grp2<false, true>(vm)
                      : pick_grp2<false, false>(vm));
}

// K7 g-major's grid: as many blocks as the card holds at once (as the
// float32 instantiation without dropout fits them, so that the scratch
// does not depend on the instantiation), split over the stripes, each a
// run of cpb chunks; n_seg partial slots a stripe (a block's slot for a
// group is block + group - out_id[0]).
struct GrpLaunch {
  size_t smem;
  int n_stripes, cpb, nblk, n_seg;
};

cudaError_t grp_launch(int n_chunks, int n_groups, int h, const GrpPlan& pl,
                       GrpLaunch* out) {
  out->smem = grp_smem(pl);
  out->n_stripes = (h + pl.hs - 1) / pl.hs;
  auto ref = attn_bwd_grp_kernel<false, false, 1>;
  cudaError_t e = set_smem(ref, out->smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ref, GRP_NT,
                                                    out->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  int per_stripe = per_sm * num_sms() / out->n_stripes;
  if (per_stripe < 1) per_stripe = 1;
  out->cpb = (n_chunks + per_stripe - 1) / per_stripe;
  if (out->cpb < 1) out->cpb = 1;
  out->nblk = (n_chunks + out->cpb - 1) / out->cpb;
  out->n_seg = out->nblk + n_groups;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K6's scratch in floats for this call (see fwd_scratch); -1 for a plan
// the kernel does not take.
long long attn_fwd_scratch(int n_chunks, int h, int d, int nhs, int nsub,
                           int ws, int g, int n_groups, int drop, int bf16) {
  const FwdPlan pl{nhs, nsub, ws, g};
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS || !fwd_plan_ok(pl, h, d))
    return -1;
  if (n_chunks <= 0) return 0;
  FwdLaunch ln;
  if (fwd_launch(n_chunks, n_groups, h, d, pl,
                 pick_fwd(drop, bf16, (d & 3) == 0),
                 &ln) != cudaSuccess)
    return -1;
  return fwd_scratch(n_chunks, h, bf16, pl, ln);
}

// The plan (nhs, nsub, ws, g) is ops/attn_kernels.py's fwd_plan. el and
// ft have n_src rows. Every element of num, den and mraw is written. mkey
// is (n_groups, h) int32 scratch, scratch attn_fwd_scratch's floats. seed
// null: no dropout. bf16: 1 for the bf16 mode.
int attn_fwd(const int* a, const int* b, const int* eid, const int* in_id,
             const int* out_id, int n_chunks, int chunk, const float* el,
             int n_src, const float* er_g, const float* ft, int h, int d,
             int nhs, int nsub, int ws, int g, float slope, const int* seed,
             int thresh, float inv_keep, int n_groups, int* mkey, int bf16,
             float* scratch, float* num, float* den, float* mraw,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdPlan pl{nhs, nsub, ws, g};
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS || !fwd_plan_ok(pl, h, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_keys = n_groups * h;
  if (n_keys > 0)
    attn_init_kernel<<<(n_keys + NT - 1) / NT, NT, 0, s>>>(mkey, n_keys);
  if (n_chunks > 0) {
    const bool drop = seed != nullptr;
    FwdKernel kern = pick_fwd(drop, bf16, (d & 3) == 0);
    FwdLaunch ln;
    cudaError_t e = fwd_launch(n_chunks, n_groups, h, d, pl, kern, &ln);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // The scratch's parts, in fwd_scratch's order.
    float* p = scratch;
    auto take = [&p](int64_t n) {
      float* q = p;
      p += (n + 3) / 4 * 4;
      return q;
    };
    const int n_seg = (n_chunks + FWD_SEG - 1) / FWD_SEG;
    float *cmax = nullptr, *run = nullptr, *fden = nullptr, *fnum = nullptr;
    if (bf16) {
      cmax = take(static_cast<int64_t>(n_chunks) * h);
      run = take(static_cast<int64_t>(n_chunks) * h);
      fden = take(static_cast<int64_t>(n_chunks) * BLK * h);
      fnum = take(static_cast<int64_t>(n_chunks) * BLK * h);
    }
    float* lden = bf16 ? take(static_cast<int64_t>(n_seg) * BLK * h) : nullptr;
    float* lnum = bf16 ? take(static_cast<int64_t>(n_seg) * BLK * h) : nullptr;
    float* part = p;
    const int cpb_max = chunks_per_block(n_chunks, 1);
    const int grid_max = (n_chunks + cpb_max - 1) / cpb_max;
    if (bf16) {
      attn_max_kernel<true><<<grid_max, NT, 0, s>>>(
          a, b, in_id, out_id, n_chunks, chunk, cpb_max, el, n_src, h, mkey,
          cmax);
      attn_run_kernel<<<dim3(n_groups, h), NT, 0, s>>>(out_id, n_chunks,
                                                       cmax, h, run);
      const int64_t n_sk = static_cast<int64_t>(n_seg) * BLK * h;
      const int sblocks = static_cast<int>((n_sk + NT - 1) / NT);
      attn_seg_kernel<<<sblocks, NT, 0, s>>>(out_id, n_chunks, run, er_g, h,
                                             slope, lden, lnum);
      attn_segscan_kernel<<<(BLK * h + NT - 1) / NT, NT, 0, s>>>(
          out_id, n_chunks, h, lden, lnum);
      attn_segapply_kernel<<<sblocks, NT, 0, s>>>(
          out_id, n_chunks, run, er_g, h, slope, lden, lnum, fden, fnum);
    } else {
      attn_max_kernel<false><<<grid_max, NT, 0, s>>>(
          a, b, in_id, out_id, n_chunks, chunk, cpb_max, el, n_src, h, mkey,
          nullptr);
    }
    cudaMemsetAsync(part, 0,
                    sizeof(float) * ln.n_stripes * ln.n_seg * BLK *
                        (pl.ws - 4 + pl.nhs),
                    s);
    kern<<<dim3(ln.nblk, ln.n_stripes), FWD_NT, ln.smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, ln.cpb, el, er_g, ft,
        n_src, mkey, run, fden, fnum, h, d, pl, slope, seed,
        drop ? thresh : 0, drop ? inv_keep : 1.f, ln.n_seg, part);
    const int64_t n_out = static_cast<int64_t>(n_groups) * BLK * (h * d + h);
    attn_fold_kernel<<<static_cast<int>((n_out + NT - 1) / NT), NT, 0, s>>>(
        out_id, n_chunks, ln.cpb, n_groups, h, d, pl, ln.n_seg, part, num,
        den);
  } else if (n_groups > 0) {
    const size_t rows = static_cast<size_t>(n_groups) * BLK;
    cudaMemsetAsync(num, 0, sizeof(float) * rows * h * d, s);
    cudaMemsetAsync(den, 0, sizeof(float) * rows * h, s);
  }
  const int64_t n_out = static_cast<int64_t>(n_groups) * BLK * h;
  if (n_out > 0)
    attn_bcast_kernel<<<static_cast<int>((n_out + NT - 1) / NT), NT, 0, s>>>(
        mkey, mraw, n_groups, h);
  return static_cast<int>(cudaGetLastError());
}

// Writes every element of gft (n_win*128, h*d), gel (n_win*128, h) and
// gerp (n_chunks*128, h). seed null: no dropout. bf16: 1 for the bf16
// mode. Chunks of more than 4,096 slots (1,024 when d > 128) are refused.
int attn_bwd_src(const int* a, const int* b, const int* eid, const int* in_id,
                 const int* out_id, int n_chunks, int chunk, const float* el,
                 const float* er_g, const float* lse_g, const float* rho_g,
                 const float* ft, const float* ct_g, int h, int d,
                 float slope, const int* seed, int thresh, float inv_keep,
                 int n_win, int bf16, float* gft, float* gel, float* gerp,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_win > 0) {
    SrcPlan pl = src_plan(h, d, chunk, seed != nullptr);
    if (n_chunks > 0 && (chunk < 1 || pl.nb < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    if (pl.nb < 1) pl.nb = 1;
    const size_t smem = src_smem(pl, seed != nullptr);
    dim3 grid(n_win, (h + pl.hs - 1) / pl.hs);
    auto kern = PICK(attn_bwd_src_kernel, seed != nullptr, bf16);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, NT, smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, el, er_g, lse_g, rho_g, ft,
        ct_g, h, d, pl, slope, seed, seed != nullptr ? thresh : 0,
        seed != nullptr ? inv_keep : 1.f, gft, gel, gerp);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7 g-major's scratch in floats for this call (see grp_launch); -1 for
// a plan the kernel does not take.
long long attn_grp_scratch(int n_chunks, int chunk, int n_groups, int h,
                           int d, int hs, int g, int cpl, int ws, int nbuf,
                           int abcap, int ctsh) {
  const GrpPlan pl{hs, g, cpl, ws, nbuf, abcap, ctsh};
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS) return -1;
  if (n_chunks <= 0) return 0;
  if (!grp_plan_ok(pl, h, d, chunk)) return -1;
  GrpLaunch ln;
  if (grp_launch(n_chunks, n_groups, h, pl, &ln) != cudaSuccess) return -1;
  return static_cast<long long>(ln.n_stripes) * ln.n_seg * BLK * pl.hs;
}

// K7 g-major over the forward layout. The plan (hs, g, cpl, ws, nbuf,
// abcap, ctsh) is ops/attn_kernels.py's grp_plan; el and ft have n_src rows;
// scratch holds attn_grp_scratch's floats. Every element of ger
// (n_groups*128, h) is written. seed null: no dropout. bf16: 1 for the
// bf16 mode.
int attn_bwd_grp(const int* a, const int* b, const int* eid, const int* in_id,
                 const int* out_id, int n_chunks, int chunk, const float* el,
                 int n_src, const float* er_g, const float* lse_g,
                 const float* rho_g, const float* ft, const float* ct_g, int h,
                 int d, int hs, int g, int cpl, int ws, int nbuf, int abcap,
                 int ctsh, float slope, const int* seed, int thresh,
                 float inv_keep, int n_groups, int bf16, float* scratch,
                 float* ger, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GrpPlan pl{hs, g, cpl, ws, nbuf, abcap, ctsh};
  if (h < 1 || h > BLK || d < 1 || d > MAX_COLS ||
      (n_chunks > 0 && !grp_plan_ok(pl, h, d, chunk)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return static_cast<int>(cudaGetLastError());
  int cpb = 1, n_seg = 0;
  if (n_chunks > 0) {
    if (scratch == nullptr || chunk < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    GrpLaunch ln;
    cudaError_t e = grp_launch(n_chunks, n_groups, h, pl, &ln);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool vec = (d & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(ft) |
                       reinterpret_cast<uintptr_t>(ct_g)) & 15) == 0;
    const bool drop = seed != nullptr;
    GrpKernel kern =
        pick_grp(drop, bf16, !vec ? 0 : cpl == 32 && d % 32 == 0 ? 2 : 1);
    e = set_smem(kern, ln.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(ln.nblk, ln.n_stripes), GRP_NT, ln.smem, s>>>(
        a, b, eid, in_id, out_id, n_chunks, chunk, ln.cpb, el, n_src, er_g,
        lse_g, rho_g, ft, ct_g, h, d, pl, slope, seed, drop ? thresh : 0,
        drop ? inv_keep : 1.f, ln.n_seg, scratch);
    cpb = ln.cpb;
    n_seg = ln.n_seg;
  }
  const int64_t n_out = static_cast<int64_t>(n_groups) * BLK * h;
  attn_grp_fold_kernel<<<static_cast<int>((n_out + NT - 1) / NT), NT, 0, s>>>(
      out_id, n_chunks, cpb, n_groups, h, hs, n_seg, scratch, ger);
  return static_cast<int>(cudaGetLastError());
}

// K8's scratch in floats: a (128 x h) slot for each pass-1 block and each
// group (see ger_part_kernel).
long long attn_ger_scratch(int n_chunks, int n_groups, int h) {
  return (static_cast<long long>(ger_parts(n_chunks)) + n_groups) * BLK * h;
}

// gerp (n_chunks*128, h) and out (n_groups*128, h) on 16-byte boundaries;
// part: attn_ger_scratch's floats. Every element of out is written.
int attn_ger_reduce(const int* gperm, const int* gout, int n_chunks,
                    int n_groups, const float* gerp, int h, float* part,
                    float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blk4 = 32 * h;
  if (n_groups <= 0 || blk4 <= 0) return static_cast<int>(cudaGetLastError());
  if (n_groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int n_parts = ger_parts(n_chunks);
  const int cpb = n_chunks > 0 ? (n_chunks + n_parts - 1) / n_parts : 1;
  const float4* g4 = reinterpret_cast<const float4*>(gerp);
  float4* p4 = reinterpret_cast<float4*>(part);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (n_chunks > 0)
    ger_part_kernel<<<(n_chunks + cpb - 1) / cpb, NT,
                      sizeof(int) * (2 * static_cast<size_t>(cpb) + 2), s>>>(
        gperm, gout, n_chunks, cpb, n_groups, g4, blk4, p4, o4);
  // Pass 2 as a programmatic dependent launch: its blocks start while
  // pass 1 runs (pass 1 lets them at once) and wait for it only after
  // their search of gout, which hides the launch gap and the search.
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blk4 + FOLD_W - 1) / FOLD_W, n_groups);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ger_fold_kernel, static_cast<const int*>(gout),
                         n_chunks, cpb, blk4,
                         static_cast<const float4*>(p4), o4);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
