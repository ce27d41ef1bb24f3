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

// Above rank 128 (to kMaxK = 256; band_gram_kernel) the bound shifts.
// A solve row writes K*K*4 bytes of A (256 KB at rank 256) against about
// L*K*(K+1) flops, about L/4 flop a byte: below L ~ 80 the A write over
// HBM bounds the call, above it the float32 FMA rate.  The design keeps
// both streams busy and spends nothing twice:
// - Symmetric 8 x 8 register tiles, one thread each on or above the
//   diagonal: nt(nt+1)/2 threads, nt = ceil(K / 8) (153 at rank 136,
//   496 at rank 248), so one solve row at a time a block, and K pads
//   only to a multiple of 8 (K(K+1)/2 + 4K FMAs a slot, not the full A).
//   Thread k < K builds b[k] from the staged slots, one register.  At
//   nt = 32 (ranks 249..256) the 528 tiles would take 17 warps, which
//   leave a thread 96 registers and spill the tile; there the tiles
//   cover the first 31 tile rows, and the last tile's 8 indices G pair
//   with the other 248 as 512 strips of 1 x 4 entries, one a thread
//   beside its tile (the 16 threads past the 496 tiles take G's own
//   diagonal tile): 512 threads, 16 warps, 128 registers, no spill.
// - A tile's eight indices are two runs of four, 4t..4t+3 and
//   h+4t..h+4t+3 with h = 4*nt, so that a warp's threads, which share
//   their tile row and walk consecutive tile columns, read f_j as
//   neighbouring 16-byte pieces (a quarter warp's reads in one pass of
//   the banks; runs of eight 32 bytes apart take two), and f_i as a
//   broadcast.
// - The pipeline of the kernel below 128: each slot gathered once by
//   cp.async.ca into a ring of three stages, raw, converted as it is
//   loaded into registers; indices and weights four steps ahead.  A
//   stage holds 32 slots (16 at KP 160, where the blocks that share an
//   SM need the room for A): half the barriers.  Within a stage the
//   next slot's f_i and first f_j load while this slot's FMAs run
//   (not with the strips, whose registers leave no room).
// - Persistent blocks, as many as the SMs hold, each taking rows
//   blockIdx.x, + gridDim.x, ...; their slot tiles are numbered on
//   across the rows, so a row's first gathers go out during the last
//   steps of the row before and land during its epilogue.
// - The epilogue stages A in shared memory beside the ring: each thread
//   puts its tile and, off the diagonal, the tile's transpose there, so
//   A is exactly symmetric at every rank, as 16-byte chunks swizzled by
//   row so that the transposed stores, eight rows four apart, hit
//   distinct banks; the block then writes the rows with coalesced
//   16-byte stores.  A row of A that does not fit (rank 256: 256 KB)
//   goes in bands; the last band (all of A where it fits) stays staged
//   and goes out during the next row's first steps, so that the A
//   write, the bound at short rows, overlaps the FMAs: at once, every
//   SM would write at the same moment.

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

constexpr int kMaxK = 256;     // band_gram_kernel up to this rank

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

// Above rank 128: one solve row at a time a block of at most 512 threads
// (16 warps, 128 registers each).  Slots a pipeline step: 32, half the
// barriers of 16, except at KP 160, where 32 slots' stages would leave
// the blocks that share an SM too little room for A.
constexpr int kBandMaxThreads = 512;
__host__ __device__ constexpr int band_slots(int kp) {
  return kp <= 160 ? 16 : 32;
}
// A row's last band of A goes out over the next row's first steps, at
// most this many: each share costs its own address arithmetic.
constexpr int kDripSteps = 4;
// At nt = 32 tiles a side (ranks 249..256) the 528 tiles on or above the
// diagonal would take 17 warps, and 17 warps leave a thread 96 registers.
// There the tiles cover the first 31 tile rows and columns only; the last
// tile's 8 indices, G, pair with every index as strips of 1 x 4 entries
// (8 x 64 strips), one a thread beside its tile: 512 threads.
constexpr int kStripTiles = 32;

// Dynamic shared memory of band_gram_kernel, the same on host and
// device: kFStages stages of gathered rows (band_slots(KP) slots of KP
// elements), then kMStages stages of indices, w (and c) (the ring), then
// a band of A's rows, a_stride floats a row.
struct BandLayout {
  int nt;           // tiles of 8 indices a side: ceil(K / 8)
  int h;            // index where a tile's second run of four starts
  int tiles;        // tile rows the threads' 8 x 8 tiles cover
  int threads;      // a block
  int stage_bytes;  // one stage of gathered rows
  int meta_stage;   // one stage of indices and weights
  int ring;         // the pipeline's shared memory
  int a_stride;     // floats a staged row of A: a multiple of 32

  __host__ __device__ BandLayout(int k, int kp, int elem, bool with_b,
                                 bool strip) {
    nt = (k + 7) / 8;
    h = 4 * nt;
    tiles = strip ? nt - 1 : nt;
    threads = strip ? 8 * 2 * nt : tiles * (tiles + 1) / 2;
    stage_bytes = band_slots(kp) * kp * elem;
    meta_stage = band_slots(kp) * (with_b ? 3 : 2) * 4;
    ring = kFStages * stage_bytes + kMStages * meta_stage;
    a_stride = (k + 31) / 32 * 32;
  }
};

// N (2 or 4) consecutive elements of a staged row into float32
// registers: one 8- or 16-byte load of float32, one 4- or 8-byte load of
// bfloat16.
template <int N, typename T>
__device__ __forceinline__ void load_n(float (&d)[N], const T* s) {
  if constexpr (N == 4) {
    load_row<4>(d, s);
  } else if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    unpack2(d, *reinterpret_cast<const uint32_t*>(s));
  }
}

// Where 16-byte chunk q of row r of a staged band lives: the chunk
// index XOR bits 2..4 of the row, so that rows four apart (a warp's
// transposed stores) fall in distinct banks, and a row's chunks stay
// within its a_stride floats.
__device__ __forceinline__ float* band_at(float* band, int r, int q,
                                          int stride) {
  return band + r * stride + 4 * (q ^ ((r >> 2) & 7));
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// 0, which the compiler cannot see through: what derives from it is
// computed again where it is used, not held in a register (or a
// predicate) from the start of the kernel.
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}

// threadIdx.x, read anew where it is used: the compiler cannot keep
// what derives from it (the copy loops' walk) in registers across the
// slot loop, which needs most of a thread's registers.
__device__ __forceinline__ int thread_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

template <typename T, int KP, bool WITH_B, bool STRIP>
__global__ void __launch_bounds__(kBandMaxThreads, 1)
    band_gram_kernel(const T* __restrict__ factors,
                     const int* __restrict__ idx, const float* __restrict__ w,
                     const float* __restrict__ c, int R, int L, int K,
                     int band, int copy_bytes, float* __restrict__ A,
                     float* __restrict__ bvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSlots = band_slots(KP);
  // f_j loaded kJ at a time: 2 with STRIP, whose strip takes the
  // registers that a second pair would
  constexpr int kJ = STRIP ? 2 : 4;
  const BandLayout lay(K, KP, sizeof(T), WITH_B, STRIP);
  unsigned char* const fring = smem;
  unsigned char* const mring = smem + kFStages * lay.stage_bytes;
  float* const staged = reinterpret_cast<float*>(smem + lay.ring);

  // This thread's tile (ti, tj), ti <= tj < lay.tiles: the first threads
  // take the tiles above the diagonal, tile row by tile row, then the
  // diagonal ones.  Tile t covers indices 4t..4t+3 and h+4t..h+4t+3 of
  // A's rows and columns (of the staged rows).  With STRIP the last 16
  // threads all take the diagonal tile of G, t = 31: its entries are
  // the same FMA chains, bit for bit, in each of them.
  int ti = 0, tj;
  {
    const int n = lay.tiles;
    const int off = n * (n - 1) / 2;
    const int u0 = threadIdx.x;
    if (u0 < off) {
      int u = u0;
      while (u >= n - 1 - ti) {
        u -= n - 1 - ti;
        ++ti;
      }
      tj = ti + 1 + u;
    } else {
      ti = tj = min(u0 - off, n);
    }
  }
  const int ci0 = 4 * ti, ci1 = lay.h + 4 * ti;  // f_i's two runs
  const int cj0 = 4 * tj, cj1 = lay.h + 4 * tj;  // f_j's
  // With STRIP, this thread's strip: entries (g, 4q..4q+3) of A, g the
  // index of G at position threadIdx.x / 64 (4t+p or h+4t+p-4, t = 31);
  // its entries within G are the diagonal tile's.
  const int sg = STRIP ? 4 * lay.tiles + (threadIdx.x >> 6 & 3) +
                             (threadIdx.x >> 8) * lay.h
                       : 0;
  const int sq = STRIP ? 4 * (threadIdx.x & 63) : 0;
  const int n_tiles = (L + kSlots - 1) / kSlots;
  const int sk = lay.a_stride;

  // Elements e0..e1 of the staged band (16-byte chunks when K allows,
  // else floats; row-major) to their place in A, rows from dst:
  // coalesced.  Whether K allows is worked out anew at each call.
  auto copy_out = [&](float* dst, int e0, int e1) {
    const int kk = K + opaque_zero();
    const bool vec = kk % 4 == 0;
    const int q = vec ? kk / 4 : kk;  // elements a row
    const int first = e0 + thread_x();
    int r = first / q, e = first - r * q;
    const int d_r = blockDim.x / q, d_e = blockDim.x % q;
    // one element a thread at a time: the copy runs inside the slot
    // loop's steps too, where the accumulators hold the registers
#pragma unroll 1
    for (int f = first; f < e1; f += blockDim.x) {
      if (vec)
        *reinterpret_cast<float4*>(dst + r * K + 4 * e) =
            *reinterpret_cast<const float4*>(band_at(staged, r, e, sk));
      else
        dst[r * K + e] = band_at(staged, r, e >> 2, sk)[e & 3];
      r += d_r;
      e += d_e;
      if (e >= q) {
        e -= q;
        ++r;
      }
    }
  };

  // The last band of a row's A (its rows from (K - 1) / band * band on)
  // stays staged while the block computes its next row, and goes out a
  // share at each of that row's pipeline steps: share j of n of row p's,
  // worked out at each call rather than held through the slot loop.
  auto write_last = [&](int p, int j, int n) {
    const int k = K + opaque_zero();
    const int r0 = (k - 1) / band * band;
    const int elems = (k - r0) * (k % 4 == 0 ? k / 4 : k);
    copy_out(A + (static_cast<size_t>(p) * k + r0) * k, j * elems / n,
             (j + 1) * elems / n);
  };

  // The block's rows are blockIdx.x, + gridDim.x, ...; their slot
  // tiles, n_tiles a row, are numbered on across them, so that the
  // gathers of a row's first tiles go out during the last steps of the
  // row before and are in flight through its epilogue.
  const int total =
      ((R - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * n_tiles;
  // Indices, w and c of the block's slot tile t into meta stage
  // t % kMStages: one slot a thread.
  auto issue_meta = [&](int t) {
    const int s = thread_x();
    if (s >= kSlots) return;
    int* mi =
        reinterpret_cast<int*>(mring + (t % kMStages) * lay.meta_stage);
    const int rl = t / n_tiles;  // the block's row and its slot tile
    const int l = (t - rl * n_tiles) * kSlots + s;
    const bool live = l < L;
    const size_t at =
        live ? static_cast<size_t>(blockIdx.x + rl * gridDim.x) * L + l
             : 0;
    const int nb = live ? 4 : 0;
    copy_async(mi + s, idx + at, 4, nb);
    copy_async(mi + kSlots + s, w + at, 4, nb);
    if constexpr (WITH_B)
      copy_async(mi + 2 * kSlots + s, c + at, 4, nb);
  };
  // The factor rows of the block's slot tile t into row stage
  // t % kFStages: the
  // block walks (slot, part) in steps of its size, each thread from
  // its own start, as quotient and remainder (one division a step).
  auto issue_rows = [&](int t) {
    const int* mi = reinterpret_cast<const int*>(
        mring + (t % kMStages) * lay.meta_stage);
    unsigned char* dst0 = fring + (t % kFStages) * lay.stage_bytes;
    const unsigned char* src0 =
        reinterpret_cast<const unsigned char*>(factors);
    const int src_row = K * static_cast<int>(sizeof(T));  // bytes
    const int copies = src_row / copy_bytes;  // copies a gathered row
    const int tid = thread_x();
    const int d_s = blockDim.x / copies, d_pt = blockDim.x % copies;
    for (int s = tid / copies, pt = tid % copies; s < kSlots;) {
      const int part = pt * copy_bytes;
      copy_async(dst0 + s * (KP * sizeof(T)) + part,
                 src0 + static_cast<size_t>(mi[s]) * src_row + part,
                 copy_bytes, copy_bytes);
      s += d_s;
      pt += d_pt;
      if (pt >= copies) {
        pt -= copies;
        ++s;
      }
    }
  };

  // Step t of sym_gram_kernel's pipeline: it issues the rows of tile
  // t + kFDist and the indices of tile t + kMDist, then tile t is
  // computed.
  auto step = [&](int t) {
    copy_wait<kFDist - 1>();
    __syncthreads();  // every copy visible; step t - 1's reads are done
    if (t + kFDist >= 0 && t + kFDist < total) issue_rows(t + kFDist);
    if (t + kMDist < total) issue_meta(t + kMDist);
    copy_commit();
  };
  for (int t = -kMDist; t < 0; ++t) step(t);  // the first row's

  int t0 = 0;  // the row's first slot tile
#pragma unroll 1
  for (int row = blockIdx.x; row < R; row += gridDim.x, t0 += n_tiles) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};  // the strip
    float bsum = 0.f;  // b[threadIdx.x], for the first K threads

    // The row's steps; the first kDripSteps of them also write out a
    // share each of the row before's last band.
    for (int t = t0; t < t0 + n_tiles; ++t) {
      step(t);
      if (row != static_cast<int>(blockIdx.x) && t - t0 < kDripSteps)
        write_last(row - gridDim.x, t - t0, min(n_tiles, kDripSteps));
      const T* fs = reinterpret_cast<const T*>(fring + (t % kFStages) *
                                                           lay.stage_bytes);
      const float* ms = reinterpret_cast<const float*>(
          mring + (t % kMStages) * lay.meta_stage);
      const float* ws = ms + kSlots;
      const float* cs = ms + 2 * kSlots;
      // The tile: f_i scaled by w, then f_j kJ at a time; the strip:
      // f_g scaled by w times four f.  Without the strip, the next
      // slot's f_i and first f_j load while this slot's FMAs run (the
      // strip's registers leave no room for them).
      float fi[2][4], fjn[kJ];
      if constexpr (!STRIP) {
        load_row<4>(fi[0], fs + ci0);
        load_row<4>(fi[1], fs + ci1);
        load_n<kJ>(fjn, fs + cj0);
      }
#pragma unroll 2
      for (int s = 0; s < kSlots; ++s) {
        const T* fr = fs + s * KP;
        if constexpr (STRIP) {
          load_row<4>(fi[0], fr + ci0);
          load_row<4>(fi[1], fr + ci1);
          load_n<kJ>(fjn, fr + cj0);
        }
        const float wv = ws[s];
        float fw[8], fj[kJ];
#pragma unroll
        for (int i = 0; i < 8; ++i) fw[i] = fi[i / 4][i % 4] * wv;
#pragma unroll
        for (int j = 0; j < kJ; ++j) fj[j] = fjn[j];
        if constexpr (!STRIP) {
          if (s + 1 < kSlots) {
            load_row<4>(fi[0], fr + KP + ci0);
            load_row<4>(fi[1], fr + KP + ci1);
            load_n<kJ>(fjn, fr + KP + cj0);
          }
        }
#pragma unroll
        for (int part = 0; part < 8 / kJ; ++part) {
          const int j0 = part * kJ;  // acc's first column of this part
          if (part > 0)
            load_n<kJ>(fj, fr + (j0 < 4 ? cj0 + j0 : cj1 + j0 - 4));
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < kJ; ++j)
              acc[i][j0 + j] = fmaf(fw[i], fj[j], acc[i][j0 + j]);
        }
        if constexpr (STRIP) {
          const float fg = to_f32(fr[sg]) * wv;
#pragma unroll
          for (int j0 = 0; j0 < 4; j0 += kJ) {
            load_n<kJ>(fj, fr + sq + j0);
#pragma unroll
            for (int j = 0; j < kJ; ++j)
              sacc[j0 + j] = fmaf(fg, fj[j], sacc[j0 + j]);
          }
        }
      }
      // b: thread k adds c * f_k over the stage's slots
      if constexpr (WITH_B) {
        const int k = thread_x();
        if (k < K) {
#pragma unroll 4
          for (int s = 0; s < kSlots; ++s)
            bsum = fmaf(cs[s], to_f32(fs[s * KP + k]), bsum);
        }
      }
    }
    __syncthreads();  // the pending band is out and the stages are read

    if (WITH_B && static_cast<int>(threadIdx.x) < K)
      bvec[static_cast<size_t>(row) * K + threadIdx.x] = bsum;
    // a diagonal tile: its upper entries mirrored below, in place
    const bool diag = ci0 == cj0;
#pragma unroll
    for (int i = 1; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) acc[i][j] = diag ? acc[j][i] : acc[i][j];
    // Band by band: each thread stores the runs of four rows of its tile
    // (and, off the diagonal, of its transpose) that fall in the band,
    // whole 16-byte chunks, padding included (rows and columns past K
    // land in the band's own slack and are not written out); then the
    // block writes the band's rows, contiguous in A, with coalesced
    // stores, except the last band, which stays pending.  A strip stores
    // its row's chunk and its four transposed entries.
    float* const a_out = A + static_cast<size_t>(row) * K * K;
#pragma unroll 1
    for (int r0 = 0; r0 < K; r0 += band) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ri = (p ? ci1 : ci0) - r0;  // ti's run p, band-local
        if (ri >= 0 && ri < band) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = 4 * p + a;
            store4(band_at(staged, ri + a, cj0 / 4, sk), acc[i][0], acc[i][1],
                   acc[i][2], acc[i][3]);
            store4(band_at(staged, ri + a, cj1 / 4, sk), acc[i][4], acc[i][5],
                   acc[i][6], acc[i][7]);
          }
        }
        const int rj = (p ? cj1 : cj0) - r0;  // tj's run p: the transpose
        if (!diag && rj >= 0 && rj < band) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = 4 * p + b;
            store4(band_at(staged, rj + b, ci0 / 4, sk), acc[0][j],
                   acc[1][j], acc[2][j], acc[3][j]);
            store4(band_at(staged, rj + b, ci1 / 4, sk), acc[4][j],
                   acc[5][j], acc[6][j], acc[7][j]);
          }
        }
      }
      if constexpr (STRIP) {
        // the strip's four entries and their mirror images, outside G
        if (sq / 4 != lay.tiles && sq / 4 != lay.h / 4 + lay.tiles) {
          if (sg - r0 >= 0 && sg - r0 < band)
            store4(band_at(staged, sg - r0, sq / 4, sk), sacc[0], sacc[1],
                   sacc[2], sacc[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (sq + j - r0 >= 0 && sq + j - r0 < band)
              band_at(staged, sq + j - r0, sg / 4, sk)[sg & 3] = sacc[j];
        }
      }
      __syncthreads();
      if (r0 + band >= K) break;  // the last band: the next row writes it
      copy_out(a_out + static_cast<size_t>(r0) * K, 0,
               band * (K % 4 == 0 ? K / 4 : K));
      __syncthreads();
    }
  }
  // The block's last row's last band
  write_last(blockIdx.x + (R - 1 - blockIdx.x) / gridDim.x * gridDim.x, 0, 1);
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

template <typename T, int KP, bool WITH_B, bool STRIP>
cudaError_t launch_band(const T* f, const int* idx, const float* w,
                        const float* c, int R, int L, int K, float* A,
                        float* b, cudaStream_t st) {
  // The blocks an SM holds by registers and the pipeline's shared
  // memory set each block's share of the SM's shared memory.
  const BandLayout lay(K, KP, sizeof(T), WITH_B, STRIP);
  auto kernel = band_gram_kernel<T, KP, WITH_B, STRIP>;
  int dev = 0, smem_sm = 0, smem_block = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_block);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        lay.threads, lay.ring);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // Each block's share of the SM's shared memory beyond the pipeline's
  // ring holds the bands of A: as many rows as fit (a multiple of 8, in
  // bands of equal size), the whole of A where it fits.
  int budget = smem_sm / per_sm - 1024;  // 1 KB an SM keeps for each block
  if (budget > smem_block) budget = smem_block;
  const int row_bytes = lay.a_stride * 4;
  const int k8 = 8 * lay.nt;
  int fit = (budget - lay.ring) / row_bytes / 8 * 8;
  if (fit < 8) fit = 8;
  const int n_bands = (k8 + fit - 1) / fit;
  const int band = (k8 / 8 + n_bands - 1) / n_bands * 8;
  const int smem = lay.ring + band * row_bytes;
  // Persistent blocks: as many as the SMs hold at this shared memory
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        lay.threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = R < per_sm * n_sm ? R : per_sm * n_sm;
  kernel<<<grid, lay.threads, smem, st>>>(f, idx, w, c, R, L, K, band,
                                          copy_bytes(f, K * sizeof(T)), A, b);
  return cudaGetLastError();
}

template <typename T, bool WITH_B>
cudaError_t launch(const void* factors, const int* idx, const float* w,
                   const float* c, int R, int L, int K, float* A, float* b,
                   cudaStream_t st) {
  const T* f = static_cast<const T*>(factors);
  if (K > kSymMaxK) {
    if (K <= 160)
      return launch_band<T, 160, WITH_B, false>(f, idx, w, c, R, L, K, A, b,
                                                st);
    if (K <= 192)
      return launch_band<T, 192, WITH_B, false>(f, idx, w, c, R, L, K, A, b,
                                                st);
    if (K <= 224)
      return launch_band<T, 224, WITH_B, false>(f, idx, w, c, R, L, K, A, b,
                                                st);
    if ((K + 7) / 8 < kStripTiles)
      return launch_band<T, 256, WITH_B, false>(f, idx, w, c, R, L, K, A, b,
                                                st);
    return launch_band<T, 256, WITH_B, true>(f, idx, w, c, R, L, K, A, b, st);
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
