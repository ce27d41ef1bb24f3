// Fused gather + weighted Gram build for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_gram_vector_pallas / _gram_kernel in
// predictionio_tpu/ops/pallas_kernels.py.  For every solve row r of an
// ALS bucket it computes the row's normal-equation pieces
//
//   A[r] = sum_l w[r,l] * f_l f_l^T     (K x K, float32)
//   b[r] = sum_l c[r,l] * f_l           (K,     float32)
//
// where f_l = factors[idx[r,l]] is a row of the other side's factor
// matrix.  Unlike the Pallas kernel, which receives the gathered
// [R,L,K] block from an XLA gather, this kernel gathers inside: the
// [R,L,K] block never exists in device memory.  Padded slots carry
// w = c = 0 (and index 0), so they add exactly zero.  Every entry of A
// and b is one float32 FMA chain over the slots in order, l = 0, 1, ...:
// A[i][j] += (f_i * w) * f_j, b[i] += c * f_i.
//
// What bounds it on this card: per slot, K(K+1) flops for the symmetric
// A (its upper triangle), 2K for b and K multiplies for w*f, against 12
// bytes of index/weight/value reads; plus one read of the factor matrix
// and the A/b writes.  At rank 64 that is ~4.4K flops per 12-byte slot,
// far above the float32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// flop/byte): the CUDA cores' float32 FMA rate bounds it (full float32:
// no TF32, no tensor cores).  Two more terms have to hide under the
// FMAs: the row gathers, K*4 bytes a slot (256 B at rank 64, ~15 GB over
// one ML-25M iteration, mostly from the 50 MB L2, which holds both
// factor matrices of that shape), and the A writes, K*K*4 bytes a solve
// row (16 KB at rank 64, ~4.4 GB an iteration, ~1.3 ms of HBM).
//
// Design for K <= 128 (sym_gram_kernel):
// - Symmetric tiles.  A is cut into TM x TM register tiles and only the
//   tiles on or above the diagonal are computed, one thread each: with
//   TM = 8, 36 threads a row at rank 64 (2,304 FMAs a slot where the
//   full A takes 4,096).  A bucket with fewer than 16 solve rows an SM
//   (the long item rows of ML-25M: R 120..1,336 at L 4,096) would leave
//   most SMs with one or two warps, so there, and up to rank 32, TM = 4:
//   136 tiles a row at rank 64, laid out as 2 x 4 blocks of tiles, one
//   a quarter warp (160 threads, 24 of them in blocks that straddle the
//   diagonal with no tile to write).  A quarter then reads two f_i and
//   four f_j a slot: shared memory serves a warp's 16-byte reads in half
//   the time when each quarter reads at most four addresses.
// - Several solve rows of the bucket share a block (rb rows, up to 256
//   threads), so small ranks fill the block too; rb shrinks when R is
//   too small to give every SM two blocks.
// - The row is staged once, raw (float32 or bfloat16, converted as it is
//   loaded into registers); each thread scales its TM row values by w in
//   registers (TM multiplies against TM*TM FMAs).  b is spread over the
//   diagonal threads: thread (ti, ti) adds c * f to b's TM entries; with
//   TM = 8 those threads come last in the block, so that b's work falls
//   on whole warps.
// - The gather is asynchronous: a ring of three stages of 16 slots (32
//   with TM = 4) in dynamic shared memory, filled with cp.async (16-byte
//   copies; 8, 4 or 2 bytes when the row width or the base address
//   allows no more; 2 bytes, for a bfloat16 row of odd rank, are plain
//   loads).  The copies go through L1 (.ca): the most popular items of a
//   Zipf catalog, and row 0 that padded slots point at, are read by many
//   rows at once, and copies that skip L1 (.cg) queue on those L2 lines.
//   A stage's rows are issued two steps before they are used, so two
//   stages' gathers are in flight while one is computed, and its indices
//   and weights (cp.async of 4 bytes, zero-filled past L and past R)
//   four steps before, because the gather addresses depend on them.
//   Slots past L gather row 0 with w = c = 0.
// - The epilogue stages the block's rows of A in the freed shared memory
//   (each tile and its transpose, so A is full and exactly symmetric)
//   and writes them with coalesced 16-byte stores: every block ends at
//   once, and scattered 32-byte runs written in halves stall the card.

// Above rank 128 (to kMaxK = 256) gram_kernel keeps the first design:
// 256 threads per block form a 16 x 16 grid over a 128 x 128 tile of A,
// each thread keeping an 8 x 8 register tile of it.  A is cut into T x T
// tiles (T = ceil(K / 128)): the grid is R x T*T blocks, and block
// (r, ti*T + tj) builds tile (ti, tj) of A[r] from columns ti*128.. (w*f)
// and tj*128.. (f) of the gathered rows; the blocks with ti = 0 also
// build b[r]'s tj-th slice.  The row's slots are walked in tiles of
// kTile: the tile's indices and weights are staged in shared memory,
// then its factor rows' two column slices are gathered (converted to
// float32 on load) into two shared arrays, f and w*f.  Each thread then
// does 64 FMAs per slot from 16 shared-memory reads (float4).  Threads
// t < 128 also accumulate b.  It computes the whole of its tiles and
// does not overlap the gather with the FMAs.
//
// The same source also holds kernel T1, the port of
// pallas_vmem_gather_gram in tools/exp_gram.py: A[r] = sum_l w[r,l] *
// f_l f_l^T with Y resident, i.e. exactly this kernel's A without b.  It
// is these kernels compiled with WITH_B = false (no c reads, no b
// accumulation), behind its own entry point pio_gather_gram.  The same
// bound holds: at the tool's shape (R 20,000, L 256, K 64) 2.2e10 flops
// against 0.4 GB of reads and A writes, so the float32 FMA rate bounds
// T1 too.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/fused_gram.py) checks shapes and types,
// allocates A and b, and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // tiled kernel: a 16 x 16 grid of threads
constexpr int kTile = 32;      // tiled kernel: slots staged per step
constexpr int kTileK = 128;    // tiled kernel: 16 * TM with TM = 8
constexpr int kMaxK = 256;     // T = 2 tiles a side

constexpr int kSymMaxK = 128;       // sym_gram_kernel up to this rank
constexpr int kSymThreads = 256;    // most threads a block
constexpr int kSymSmemBudget = 112 * 1024;  // two blocks an SM
// Up to rank 64, 8 x 8 tiles (36 threads a row at rank 64) once R gives
// every SM this many solve rows; below it 4 x 4 tiles (160 threads a
// row), which keep the SMs busy with fewer rows.
constexpr int kSymWideRowsPerSm = 16;
// Slots a pipeline step: 16 with 8 x 8 tiles, whose rows of several
// solve rows share the shared memory; 32 with 4 x 4 tiles, which run
// few long rows, one a block.
__host__ __device__ constexpr int slots_for(int tm) { return tm == 4 ? 32 : 16; }
constexpr int kFDist = 2;           // steps from a tile's gather to its use
constexpr int kMDist = 2 * kFDist;  // steps from its indices to its use
constexpr int kFStages = kFDist + 1;
constexpr int kMStages = kMDist + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// n consecutive floats of shared memory into registers; float4 loads
// where n allows (the caller keeps the address 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// TM (4 or 8) consecutive bfloat16 of shared memory into float32
// registers: one 8- or 16-byte load, each half-word shifted into the
// top of a float (exact).
__device__ __forceinline__ void unpack2(float* d, uint32_t v) {
  d[0] = __uint_as_float(v << 16);
  d[1] = __uint_as_float(v & 0xffff0000u);
}
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N],
                                         const __nv_bfloat16* src) {
  static_assert(N == 4 || N == 8, "bfloat16 rows load 4 or 8 at a time");
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    unpack2(dst, v.x);
    unpack2(dst + 2, v.y);
    unpack2(dst + 4, v.z);
    unpack2(dst + 6, v.w);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    unpack2(dst, v.x);
    unpack2(dst + 2, v.y);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of `bytes` (16, 8 or 4) from global to shared
// memory; src_bytes = 0 fills the destination with zeros instead.  A
// 2-byte copy (no cp.async that small) is a plain load and store.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes, int src_bytes) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    *static_cast<uint16_t*>(dst) =
        src_bytes ? *static_cast<const uint16_t*>(src) : uint16_t{0};
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory of sym_gram_kernel, the same on host and device:
// kFStages stages of gathered rows (rb rows x slots_for(TM) slots x KP
// elements, each row's buffer padded by 16 bytes against bank
// conflicts between rows), then kMStages stages of indices, w (and c);
// at least one K x K row of A, which the epilogue stages there.
struct SymLayout {
  int nt;           // register tiles a side
  int threads;      // threads a solve row (see sym_gram_kernel)
  int row_bytes;    // one solve row's buffer in a stage
  int stage_bytes;  // one stage of gathered rows
  int meta_stage;   // one stage of indices and weights
  int smem;         // all of it
  int stage_rows;   // rows of A the epilogue stages at a time

  __host__ __device__ SymLayout(int k, int tm, int kp, int elem, int rb,
                                bool with_b) {
    nt = (k + tm - 1) / tm;
    if (tm == 4) {  // 2 x 4 blocks of tiles reaching the diagonal, 8 each
      const int nq = (nt + 3) / 4;
      threads = 0;
      for (int i = 0; i < (nt + 1) / 2; ++i) threads += 8 * (nq - i / 2);
    } else {        // one thread a tile on or above the diagonal
      threads = nt * (nt + 1) / 2;
    }
    row_bytes = slots_for(tm) * kp * elem + 16;
    stage_bytes = rb * row_bytes;
    meta_stage = rb * slots_for(tm) * (with_b ? 3 : 2) * 4;
    smem = kFStages * stage_bytes + kMStages * meta_stage;
    if (smem < k * k * 4) smem = k * k * 4;  // the epilogue stages a row of A
    stage_rows = smem / (k * k * 4);
  }
};

// TM consecutive float32 values to device memory: two or one float4
// stores when the run is whole and 16-byte aligned, else one by one.
template <int TM>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[TM],
                                          int n, bool vec) {
  if (vec && n == TM) {
#pragma unroll
    for (int i = 0; i < TM; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (i < n) dst[i] = v[i];
  }
}

template <typename T, int TM, int KP, bool WITH_B>
__global__ void __launch_bounds__(kSymThreads, 2)
    sym_gram_kernel(const T* __restrict__ factors,
                    const int* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ c, int R, int L, int K, int rb,
                    int copy_bytes, float* __restrict__ A,
                    float* __restrict__ bvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SymLayout lay(K, TM, KP, sizeof(T), rb, WITH_B);
  unsigned char* const fring = smem;
  unsigned char* const mring = smem + kFStages * lay.stage_bytes;
  constexpr int kSlots = slots_for(TM);
  const int n_meta = rb * kSlots;  // slots of a stage, all rows

  // This thread's solve row and its tile (ti, tj) of A; it writes the
  // tile if `live`, i.e. ti <= tj < nt.  With TM = 8 every thread has a
  // live tile: the first rb * off threads take the tiles above the
  // diagonal, row by row, the last rb * nt the diagonal tiles, which
  // also build b, so that b's extra work falls on whole warps.  With
  // TM = 4 each 8 threads (a quarter of a warp) take a 2 x 4 block of
  // tiles, tile rows 2I, 2I+1 and tile columns 4J..4J+3 for every J that
  // reaches the diagonal: shared memory serves a warp's 16-byte read at
  // half the cost when each quarter reads at most four addresses, and a
  // quarter then reads two f_i and four f_j a slot.  The blocks that
  // straddle the diagonal leave some threads without a tile.
  int r_loc, ti = 0, tj;
  if constexpr (TM == 4) {
    r_loc = threadIdx.x / lay.threads;
    const int u = threadIdx.x - r_loc * lay.threads;
    const int nq = (lay.nt + 3) / 4;
    int blk = u >> 3;
    while (blk >= nq - ti / 2) {  // ti counts row pairs here
      blk -= nq - ti / 2;
      ++ti;
    }
    tj = 4 * (ti / 2 + blk) + (u & 3);
    ti = 2 * ti + ((u >> 2) & 1);
  } else {
    const int off = lay.threads - lay.nt;
    if (static_cast<int>(threadIdx.x) < rb * off) {
      r_loc = threadIdx.x / off;
      int u = threadIdx.x - r_loc * off;
      while (u >= lay.nt - 1 - ti) {
        u -= lay.nt - 1 - ti;
        ++ti;
      }
      tj = ti + 1 + u;
    } else {
      const int d = threadIdx.x - rb * off;
      r_loc = d / lay.nt;
      ti = tj = d - r_loc * lay.nt;
    }
  }
  const bool live = ti <= tj && tj < lay.nt;
  const bool diag = ti == tj;
  const int row0 = blockIdx.x * rb;
  const int n_tiles = (L + kSlots - 1) / kSlots;
  const int src_row = K * static_cast<int>(sizeof(T));  // bytes
  const int copies = src_row / copy_bytes;  // copies a gathered row
  // This thread's first copy of a stage (slot row, part) and its stride,
  // kept as quotient and remainder so that the copy loop divides nothing.
  const int c_rs = threadIdx.x / copies, c_pt = threadIdx.x % copies;
  const int d_rs = blockDim.x / copies, d_pt = blockDim.x % copies;

  // Indices, w and c of slot tile t into meta stage t % kMStages.
  auto issue_meta = [&](int t) {
    int* mi = reinterpret_cast<int*>(mring + (t % kMStages) * lay.meta_stage);
    for (int e = threadIdx.x; e < n_meta; e += blockDim.x) {
      const int row = row0 + e / kSlots;
      const int l = t * kSlots + e % kSlots;
      const bool live = row < R && l < L;
      const size_t at = live ? static_cast<size_t>(row) * L + l : 0;
      const int nb = live ? 4 : 0;
      copy_async(mi + e, idx + at, 4, nb);
      copy_async(mi + n_meta + e, w + at, 4, nb);
      if constexpr (WITH_B) copy_async(mi + 2 * n_meta + e, c + at, 4, nb);
    }
  };
  // The factor rows of slot tile t into row stage t % kFStages.
  auto issue_rows = [&](int t) {
    const int* mi =
        reinterpret_cast<const int*>(mring + (t % kMStages) * lay.meta_stage);
    unsigned char* dst0 = fring + (t % kFStages) * lay.stage_bytes;
    const unsigned char* src0 = reinterpret_cast<const unsigned char*>(factors);
    for (int rs = c_rs, pt = c_pt; rs < n_meta;) {  // rs = r * kSlots + s
      const int part = pt * copy_bytes;
      copy_async(dst0 + (rs / kSlots) * lay.row_bytes +
                     (rs % kSlots) * (KP * sizeof(T)) + part,
                 src0 + static_cast<size_t>(mi[rs]) * src_row + part,
                 copy_bytes, copy_bytes);
      rs += d_rs;
      pt += d_pt;
      if (pt >= copies) {
        pt -= copies;
        ++rs;
      }
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  float bacc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) bacc[i] = 0.f;

  // Step t issues the rows of tile t + kFDist and the indices of tile
  // t + kMDist, then computes tile t.  One commit group a step, so
  // waiting for all but the newest kFDist - 1 groups completes the
  // groups of step t - kFDist and before: the rows of tile t and the
  // indices of tile t + kFDist.
  for (int t = -kMDist; t < n_tiles; ++t) {
    copy_wait<kFDist - 1>();
    __syncthreads();  // every copy visible; step t - 1's reads are done
    if (t + kFDist >= 0 && t + kFDist < n_tiles) issue_rows(t + kFDist);
    if (t + kMDist < n_tiles) issue_meta(t + kMDist);
    copy_commit();
    if (t < 0) continue;
    const T* fs = reinterpret_cast<const T*>(
        fring + (t % kFStages) * lay.stage_bytes + r_loc * lay.row_bytes);
    const float* ms = reinterpret_cast<const float*>(
        mring + (t % kMStages) * lay.meta_stage);
    const float* ws = ms + n_meta + r_loc * kSlots;
    const float* cs = ms + 2 * n_meta + r_loc * kSlots;
#pragma unroll 8
    for (int s = 0; s < kSlots; ++s) {
      float fi[TM], fj[TM];
      load_row<TM>(fi, fs + s * KP + ti * TM);
      load_row<TM>(fj, fs + s * KP + tj * TM);
      if constexpr (WITH_B) {
        if (diag) {
          const float cv = cs[s];
#pragma unroll
          for (int i = 0; i < TM; ++i) bacc[i] = fmaf(cv, fi[i], bacc[i]);
        }
      }
      const float wv = ws[s];
#pragma unroll
      for (int i = 0; i < TM; ++i) fi[i] *= wv;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(fi[i], fj[j], acc[i][j]);
    }
  }
  copy_wait<0>();
  __syncthreads();  // the stages are free: A goes out through them

  // Each thread puts its tile of A, and the tile's transpose, into a
  // staged copy of its solve row, stage_rows rows at a time; then the
  // block writes those rows, which are contiguous in A, with coalesced
  // 16-byte stores.  b goes straight out.
  const int row = row0 + r_loc;
  const bool vec = K % 4 == 0;
  const int gi0 = ti * TM, gj0 = tj * TM;
  const int ni = min(TM, K - gi0), nj = min(TM, K - gj0);
  if (WITH_B && live && diag && row < R)
    store_run<TM>(bvec + static_cast<size_t>(row) * K + gi0, bacc, ni, vec);
  float* const staged = reinterpret_cast<float*>(smem);
  const int kk = K * K;
#pragma unroll 1
  for (int r0 = 0; r0 < rb && row0 + r0 < R; r0 += lay.stage_rows) {
    if (live && r_loc >= r0 && r_loc < r0 + lay.stage_rows) {
      float* a_s = staged + (r_loc - r0) * kk;
      if (diag) {  // the upper entries, mirrored below the diagonal
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i >= ni) break;
          float v[TM];
#pragma unroll
          for (int j = 0; j < TM; ++j) v[j] = j < i ? acc[j][i] : acc[i][j];
          store_run<TM>(a_s + (gi0 + i) * K + gj0, v, nj, vec);
        }
      } else {  // the tile, then its transpose
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (i < ni) store_run<TM>(a_s + (gi0 + i) * K + gj0, acc[i], nj, vec);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          if (j >= nj) break;
          float v[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) v[i] = acc[i][j];
          store_run<TM>(a_s + (gj0 + j) * K + gi0, v, ni, vec);
        }
      }
    }
    __syncthreads();
    const int n_rows = min(lay.stage_rows, min(rb - r0, R - row0 - r0));
    float* a_out = A + static_cast<size_t>(row0 + r0) * kk;
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(staged);
      float4* dst = reinterpret_cast<float4*>(a_out);
      for (int e = threadIdx.x; e < n_rows * kk / 4; e += blockDim.x)
        dst[e] = src[e];
    } else {
      for (int e = threadIdx.x; e < n_rows * kk; e += blockDim.x)
        a_out[e] = staged[e];
    }
    __syncthreads();
  }
}

template <typename T, int TM, bool WITH_B>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const T* __restrict__ factors, const int* __restrict__ idx,
                const float* __restrict__ w, const float* __restrict__ c,
                int L, int K, float* __restrict__ A,
                float* __restrict__ bvec) {
  constexpr int KP = 16 * TM;  // padded width of a staged row
  __shared__ __align__(16) float fs[kTile][KP];   // gathered rows
  __shared__ __align__(16) float fws[kTile][KP];  // rows scaled by w
  __shared__ int is[kTile];
  __shared__ float ws[kTile];
  __shared__ float cs[kTile];

  const size_t row = static_cast<size_t>(blockIdx.x) * L;
  const int n_tiles = (K + KP - 1) / KP;           // T: 1 unless K > 128
  const int ci = (blockIdx.y / n_tiles) * KP;      // A's rows (w*f columns)
  const int cj = (blockIdx.y % n_tiles) * KP;      // A's columns (f columns)
  const bool diag = ci == cj;                      // one gather serves both
  const bool with_b = WITH_B && ci == 0;           // b's slice cj..cj+KP
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  float bacc = 0.f;

  for (int l0 = 0; l0 < L; l0 += kTile) {
    const int n = min(kTile, L - l0);
    if (threadIdx.x < kTile) {
      const int s = threadIdx.x;
      const bool live = s < n;
      is[s] = live ? idx[row + l0 + s] : 0;
      ws[s] = live ? w[row + l0 + s] : 0.f;
      if constexpr (WITH_B) cs[s] = live ? c[row + l0 + s] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * KP; e += kThreads) {
      const int s = e / KP;
      const int k = e - s * KP;
      const T* frow = factors + static_cast<size_t>(is[s]) * K;
      const bool live = s < n;
      const float fj = live && cj + k < K ? to_f32(frow[cj + k]) : 0.f;
      const float fi =
          diag ? fj : (live && ci + k < K ? to_f32(frow[ci + k]) : 0.f);
      fs[s][k] = fj;
      fws[s][k] = fi * ws[s];
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kTile; ++s) {
      float a[TM], bb[TM];
      load_row<TM>(a, &fws[s][ty * TM]);
      load_row<TM>(bb, &fs[s][tx * TM]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (with_b && threadIdx.x < KP) {
#pragma unroll 8
      for (int s = 0; s < kTile; ++s)
        bacc = fmaf(cs[s], fs[s][threadIdx.x], bacc);
    }
    __syncthreads();
  }

  float* a_out = A + static_cast<size_t>(blockIdx.x) * K * K;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = ci + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int gj = cj + tx * TM + j;
      if (gi < K && gj < K) a_out[static_cast<size_t>(gi) * K + gj] = acc[i][j];
    }
  }
  if (with_b && threadIdx.x < KP && cj + threadIdx.x < K)
    bvec[static_cast<size_t>(blockIdx.x) * K + cj + threadIdx.x] = bacc;
}

// The widest copy (16, 8, 4 or 2 bytes) that every gathered row's start
// and width allow.
int copy_bytes(const void* factors, int row_bytes) {
  const auto base = reinterpret_cast<uintptr_t>(factors);
  for (int b = 16; b > 2; b /= 2)
    if (row_bytes % b == 0 && base % b == 0) return b;
  return 2;
}

template <typename T, int TM, int KP, bool WITH_B>
cudaError_t launch_sym(const T* f, const int* idx, const float* w,
                       const float* c, int R, int L, int K, float* A,
                       float* b, int n_sm, cudaStream_t st) {
  // Rows a block: as many as 256 threads hold, but no more than leave
  // every SM two blocks, and within the shared-memory budget.
  const int threads = SymLayout(K, TM, KP, sizeof(T), 1, WITH_B).threads;
  int rb = kSymThreads / threads;
  const int fill = R / (2 * n_sm);
  rb = fill < 1 ? 1 : (fill < rb ? fill : rb);
  while (rb > 1 &&
         SymLayout(K, TM, KP, sizeof(T), rb, WITH_B).smem > kSymSmemBudget)
    --rb;
  const int smem = SymLayout(K, TM, KP, sizeof(T), rb, WITH_B).smem;
  auto kernel = sym_gram_kernel<T, TM, KP, WITH_B>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(R + rb - 1) / rb, rb * threads, smem, st>>>(
      f, idx, w, c, R, L, K, rb, copy_bytes(f, K * sizeof(T)), A, b);
  return cudaGetLastError();
}

template <typename T, bool WITH_B>
cudaError_t launch(const void* factors, const int* idx, const float* w,
                   const float* c, int R, int L, int K, float* A, float* b,
                   cudaStream_t st) {
  const T* f = static_cast<const T*>(factors);
  if (K > kSymMaxK) {
    const int n_tiles = (K + kTileK - 1) / kTileK;  // A tiles a side (TM = 8)
    const dim3 grid(R, n_tiles * n_tiles);
    gram_kernel<T, 8, WITH_B><<<grid, kThreads, 0, st>>>(f, idx, w, c, L, K,
                                                         A, b);
    return cudaGetLastError();
  }
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (K <= 32)
    return launch_sym<T, 4, 32, WITH_B>(f, idx, w, c, R, L, K, A, b, n_sm, st);
  if (K <= 64 && R < kSymWideRowsPerSm * n_sm)
    return launch_sym<T, 4, 64, WITH_B>(f, idx, w, c, R, L, K, A, b, n_sm, st);
  if (K <= 64)
    return launch_sym<T, 8, 64, WITH_B>(f, idx, w, c, R, L, K, A, b, n_sm, st);
  return launch_sym<T, 8, 128, WITH_B>(f, idx, w, c, R, L, K, A, b, n_sm, st);
}

}  // namespace

// A [R,K,K] and b [R,K] (float32) from factors [N,K] (float32 when
// bf16 == 0, bfloat16 when bf16 == 1), idx [R,L] int32 in [0, N), and
// w, c [R,L] float32, all contiguous, on `stream`.  Returns
// cudaGetLastError() after the launch (0 = launched); faults during the
// run surface at the next synchronisation.
extern "C" int pio_fused_gram(const void* factors, int bf16, const int* idx,
                              const float* w, const float* c, int R, int L,
                              int K, float* A, float* b, void* stream) {
  if (R < 1 || L < 1 || K < 1 || K > kMaxK || (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, true>(factors, idx, w, c, R, L, K, A, b, st)
           : launch<float, true>(factors, idx, w, c, R, L, K, A, b, st);
  return static_cast<int>(err);
}

// Kernel T1, the weighted Gram of gathered rows without b:
// A [R,K,K] float32 from factors [N,K] (float32 when bf16 == 0, bfloat16
// when bf16 == 1), idx [R,L] int32 in [0, N) and w [R,L] float32, all
// contiguous, on `stream`.  The same kernels as pio_fused_gram with b
// compiled out.  Returns cudaGetLastError() after the launch.
extern "C" int pio_gather_gram(const void* factors, int bf16, const int* idx,
                               const float* w, int R, int L, int K, float* A,
                               void* stream) {
  if (R < 1 || L < 1 || K < 1 || K > kMaxK || (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, false>(factors, idx, w, nullptr, R, L, K,
                                          A, nullptr, st)
           : launch<float, false>(factors, idx, w, nullptr, R, L, K, A,
                                  nullptr, st);
  return static_cast<int>(err);
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
