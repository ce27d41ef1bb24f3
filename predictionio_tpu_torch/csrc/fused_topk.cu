// Fused corpus score + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_topk_pallas / _topk_kernel in
// predictionio_tpu/ops/pallas_kernels.py: the top-k of
// queries[B,D] . items[N,D]^T in float32, corpus rows at or past n_real
// masked out, returned as ([B,k] f32 sorted descending, [B,k] int32)
// without ever writing the [B,N] score block to device memory.
//
// What bounds it on this card: it does 2*B*N*D float32 flops over
// 4*N*D bytes of corpus, B/2 flop/byte.  Scores stay in full float32
// (no TF32), so the ridge is the CUDA cores' 67 TFLOP/s over 3.35 TB/s,
// 20 flop/byte: bytes bound it below B = 40 (one read of the corpus at
// the memory rate; the serving path's B = 1), float32 FMAs above.
//
// The Pallas kernel walks the corpus in order with one running top-k in
// VMEM; Hopper's blocks run in parallel and in no order, so the work is
// split in two launches, a score pass and a merge pass.  The score pass
// has two routes; the wrapper's plan (predictionio_tpu_torch/ops/
// fused_topk.py) picks one and passes it in `tiled`: the tiled route
// wherever its block fits, for rows of whole float4s at every B and for
// other rows from B = TILED_MIN_BATCH (there its 4-byte copies lose to
// 1a's row reads below that B on a corpus read from device memory).
//
//   1a. topk_score_pass, one thread a row (small B on rows that are not
//      whole float4s; k or D too large for a tiled block): block (g, c)
//      owns query group g (up to 8 queries, staged in shared memory) and
//      the contiguous corpus range c.  Each thread scores one item row
//      per tile with float32 FMAs (read straight from global memory,
//      float4 where the row allows) and keeps, per query, a running
//      top-k in shared memory by threshold-and-compact: a score that
//      beats the current k-th best is appended to a candidate buffer;
//      when the buffer could overflow in the next tile, the block
//      bitonic-sorts it with the running top-k and keeps the best k.
//      Blocks of one corpus range differ only in their query group and
//      are launched side by side (blockIdx.x = query group), so the
//      range is read from device memory once and the other groups hit
//      in L2.
//   1b. topk_tiled_pass (FMA bound at batched B, bytes bound at B 1).
//      Route 1a runs at about a tenth of the float32 rate at B 64: one
//      thread scores a whole row, so each lane of a warp reads its own
//      256-byte row (a load touches 32 cache lines); every query value
//      is read again from shared memory for every item (32 FMAs a
//      16-byte load); every score is offered on its own; and its 8-query
//      blocks leave 2 blocks an SM.  The tiled route: a block owns QB
//      queries (64, or 32, 16, 8 when k's buffers need the room), staged
//      once in shared memory, and walks its corpus range in tiles of 128
//      rows that come in through a two-stage cp.async ring, in coalesced
//      16-byte copies (4-byte copies, zero-padded to whole float4s, when
//      D % 4 != 0), the next tile in flight while one is scored.  A
//      staged row takes an odd number of 16 bytes, so eight lanes
//      reading eight rows' float4s hit distinct banks.  Each of the 256
//      threads keeps a TQ x TI (query x item) register tile, 8 x 4 at QB
//      64: per four d it reads TI item float4s and TQ query float4s (a
//      broadcast: a warp holds one query group) and does 4 * TQ * TI
//      FMAs, the sum in d order as route 1a.  The tile's scores go to
//      the per-query buffers through offer_block (topk_select.cuh),
//      which merges and offers again when a buffer fills, so a buffer
//      needs no room for a whole tile: it holds the next power of two >=
//      2k slots, and more queries fit.
//   2. topk_merge_pass (topk_select.cuh): each score-pass block writes
//      its k best (score, id) pairs to a scratch tensor [B, chunks, k];
//      one block per query folds its chunks*k candidates into the final
//      sorted [k].
//
// Ties: on exactly equal scores the lower item id ranks first.  The
// Pallas kernel instead keeps the lowest running slot, so tie ORDER may
// differ between the two; callers compare id sets where scores tie.
// Slots the corpus cannot fill (fewer than k rows below n_real) come
// back as score -3.4e38 and id -1.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/fused_topk.py) plans the grid, allocates
// every output and scratch tensor, and passes PyTorch's current stream.

#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;         // threads per block = rows per tile
constexpr int kMaxQ = 8;              // queries per score-pass block
static_assert(kThreads == kMergeThreads, "one tile width for both passes");

__global__ void __launch_bounds__(kThreads)
topk_score_pass(const float* __restrict__ queries,
                const float* __restrict__ items, int B, int D, int n_real,
                int k, int S, int log_s, int qb, int rows, int n_chunks,
                int vec4, float* __restrict__ part_s,
                int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cand* buf = reinterpret_cast<Cand*>(smem);                  // [qb][S]
  float* qs = reinterpret_cast<float*>(smem + sizeof(Cand) * qb * S);
  __shared__ int cnt[kMaxQ];
  __shared__ float thr_s[kMaxQ];
  __shared__ int thr_i[kMaxQ];

  const int q0 = blockIdx.x * qb;
  const int nq = min(qb, B - q0);
  const int chunk = blockIdx.y;
  const int lo = chunk * rows;
  const int hi = min(lo + rows, n_real);  // the wrapper keeps it in int

  for (int t = threadIdx.x; t < nq * D; t += blockDim.x)
    qs[t] = queries[static_cast<size_t>(q0) * D + t];
  init_rows(buf, nq, log_s, kMaxQ, cnt, thr_s, thr_i);
  __syncthreads();

  const int limit = S - k - kThreads;  // counts above this may overflow
  for (int base = lo; base < hi; base += kThreads) {
    bool full = false;
    for (int q = 0; q < nq; ++q) full |= cnt[q] > limit;
    // The barrier also keeps every count read ahead of this tile's appends.
    if (__syncthreads_or(full)) merge_rows(buf, nq, S, log_s, k, cnt, thr_s, thr_i);
    const int i = base + threadIdx.x;
    if (i < hi) {
      float acc[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;
      const float* row = items + static_cast<size_t>(i) * D;
      if (vec4) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        const int d4 = D >> 2;
        for (int d = 0; d < d4; ++d) {
          const float4 x = __ldg(r4 + d);
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q) {
            if (q < nq) {
              const float4 y = q4[q * d4 + d];
              acc[q] = fmaf(x.x, y.x, acc[q]);
              acc[q] = fmaf(x.y, y.y, acc[q]);
              acc[q] = fmaf(x.z, y.z, acc[q]);
              acc[q] = fmaf(x.w, y.w, acc[q]);
            }
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float x = __ldg(row + d);
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q)
            if (q < nq) acc[q] = fmaf(x, qs[q * D + d], acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < nq) offer(buf, q, log_s, k, cnt, thr_s, thr_i, acc[q], i);
    }
    __syncthreads();
  }
  merge_rows(buf, nq, S, log_s, k, cnt, thr_s, thr_i);
  write_partial(buf, nq, log_s, k, q0, n_chunks, chunk, part_s, part_i);
}

// The tiled route: rows a tile, stages of the copy ring.
constexpr int kTileRows = 128;
constexpr int kStages = 2;

// Register tile of the tiled route for QB queries a block: TQ queries x
// TI items a thread, warp w on query group w % (QB / TQ) and the item
// slice w / (QB / TQ); the warps cover QB queries x kTileRows items.
template <int QB>
struct TileShape;
template <>
struct TileShape<64> {
  static constexpr int TQ = 8, TI = 4;
};
template <>
struct TileShape<32> {
  static constexpr int TQ = 8, TI = 2;
};
template <>
struct TileShape<16> {
  static constexpr int TQ = 8, TI = 1;
};
template <>
struct TileShape<8> {
  static constexpr int TQ = 4, TI = 1;
};

// D padded to whole float4s, and the floats a staged row takes: an odd
// number of 16-byte units, so eight consecutive rows start in eight
// distinct groups of four banks.
__host__ __device__ inline int padded_d(int D) { return (D + 3) & ~3; }
__host__ __device__ inline int tile_pitch(int D) {
  const int d4 = padded_d(D);
  return (d4 >> 2) % 2 == 0 ? d4 + 4 : d4;
}

// Dynamic shared memory of a tiled-pass block; ops/fused_topk.py's
// tiled_smem_bytes computes the same.
inline size_t tiled_smem(int qb, int D, int S) {
  return sizeof(float) * kStages * kTileRows * tile_pitch(D) +
         sizeof(float) * qb * padded_d(D) + sizeof(Cand) * qb * S +
         sizeof(Cand) * qb * kBoundSlots + 3 * sizeof(int) * qb;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Queue the copies of corpus rows [row0, min(row0 + kTileRows, hi)) into
// a stage (row r at r * pitch); rows past hi are left as they are.
__device__ __forceinline__ void load_tile(float* stage,
                                          const float* __restrict__ items,
                                          int D, int pitch, int row0, int hi,
                                          int vec4) {
  if (vec4) {
    const int c4 = D >> 2;
    for (int c = threadIdx.x; c < kTileRows * c4; c += kThreads) {
      const int r = c / c4;
      const int e = (c - r * c4) << 2;
      if (row0 + r < hi)
        cp_async16(stage + r * pitch + e,
                   items + static_cast<size_t>(row0 + r) * D + e);
    }
  } else {
    for (int c = threadIdx.x; c < kTileRows * D; c += kThreads) {
      const int r = c / D;
      const int e = c - r * D;
      if (row0 + r < hi)
        cp_async4(stage + r * pitch + e,
                  items + static_cast<size_t>(row0 + r) * D + e);
    }
  }
}

template <int QB>
__global__ void __launch_bounds__(kThreads, 2)
topk_tiled_pass(const float* __restrict__ queries,
                const float* __restrict__ items, int B, int D, int n_real,
                int k, int S, int log_s, int rows, int n_chunks, int vec4,
                float* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int TQ = TileShape<QB>::TQ;
  constexpr int TI = TileShape<QB>::TI;
  constexpr int QG = QB / TQ;  // query groups
  static_assert((kThreads / 32) % QG == 0 &&
                    (kThreads / 32 / QG) * 32 * TI == kTileRows,
                "the warps cover QB queries x kTileRows items");
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = padded_d(D);
  const int pitch = tile_pitch(D);
  float* tiles = reinterpret_cast<float*>(smem);   // [kStages][128][pitch]
  float* qs = tiles + kStages * kTileRows * pitch;  // [QB][d4]
  Cand* buf = reinterpret_cast<Cand*>(qs + QB * d4);             // [QB][S]
  Cand* bound = buf + (QB << log_s);               // [QB][kBoundSlots]
  int* cnt = reinterpret_cast<int*>(bound + QB * kBoundSlots);
  float* thr_s = reinterpret_cast<float*>(cnt + QB);
  int* thr_i = reinterpret_cast<int*>(thr_s + QB);

  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, B - q0);
  const int chunk = blockIdx.y;
  const int lo = chunk * rows;
  const int hi = min(lo + rows, n_real);  // the wrapper keeps it in int
  const int n_tiles = hi > lo ? (hi - lo + kTileRows - 1) / kTileRows : 0;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile(tiles + t * kTileRows * pitch, items, D, pitch,
                lo + t * kTileRows, hi, vec4);
    cp_async_commit();
  }
  // Queries zero past nq and past D; the staged rows' columns [D, d4)
  // stay zero (no copy writes them), so padded d add exact zeros.
  for (int t = threadIdx.x; t < QB * d4; t += kThreads) {
    const int q = t / d4;
    const int d = t - q * d4;
    qs[t] = q < nq && d < D ? queries[static_cast<size_t>(q0 + q) * D + d]
                            : 0.f;
  }
  if (d4 != D) {
    const int pad = d4 - D;
    for (int t = threadIdx.x; t < kStages * kTileRows * pad; t += kThreads)
      tiles[(t / pad) * pitch + D + t % pad] = 0.f;
  }
  init_rows(buf, nq, log_s, QB, cnt, thr_s, thr_i, bound);

  const int warp = threadIdx.x >> 5;
  const int qrow = (warp % QG) * TQ;  // the warp's first query row
  const int irow = (warp / QG) * 32 * TI + (threadIdx.x & 31);
  const Rows sel{buf, cnt, thr_s, thr_i, bound, nq, S, log_s, k};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    // Tile t is in; every thread is done with the stage refilled next.
    __syncthreads();
    if (t + kStages - 1 < n_tiles)
      load_tile(tiles + ((t + kStages - 1) % kStages) * kTileRows * pitch,
                items, D, pitch, lo + (t + kStages - 1) * kTileRows, hi,
                vec4);
    cp_async_commit();

    const float* tile = tiles + (t % kStages) * kTileRows * pitch;
    float acc[TQ * TI];
#pragma unroll
    for (int u = 0; u < TQ * TI; ++u) acc[u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < d4; d += 4) {
      float4 x[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i)
        x[i] = *reinterpret_cast<const float4*>(tile + (irow + 32 * i) * pitch
                                                + d);
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const float4 y =
            *reinterpret_cast<const float4*>(qs + (qrow + j) * d4 + d);
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          float a = acc[j * TI + i];
          a = fmaf(x[i].x, y.x, a);
          a = fmaf(x[i].y, y.y, a);
          a = fmaf(x[i].z, y.z, a);
          a = fmaf(x[i].w, y.w, a);
          acc[j * TI + i] = a;
        }
      }
    }
    const int base = lo + t * kTileRows + irow;
    int id[TQ * TI];
    unsigned valid = 0;
#pragma unroll
    for (int j = 0; j < TQ; ++j)
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        id[j * TI + i] = base + 32 * i;
        if (qrow + j < nq && base + 32 * i < hi) valid |= 1u << (j * TI + i);
      }
    offer_block<TQ * TI, TI, QG>(acc, id, valid, sel, qrow);
  }
  cp_async_wait<0>();
  __syncthreads();
  merge_rows(buf, nq, S, log_s, k, cnt, thr_s, thr_i);
  write_partial(buf, nq, log_s, k, q0, n_chunks, chunk, part_s, part_i);
}

using TiledPass = void (*)(const float*, const float*, int, int, int, int,
                           int, int, int, int, int, float*, int*);

TiledPass tiled_pass(int qb) {
  switch (qb) {
    case 64: return &topk_tiled_pass<64>;
    case 32: return &topk_tiled_pass<32>;
    case 16: return &topk_tiled_pass<16>;
    case 8: return &topk_tiled_pass<8>;
    default: return nullptr;
  }
}

}  // namespace

// Launch both passes on `stream`.  tiled selects the score pass: 0 the
// small-B route (qb 1..8 queries a block, S the per-query buffer, a
// power of two of at least k + 256, rows a multiple of 256), 1 the tiled
// route (qb 8, 16, 32 or 64; S a power of two above k; rows a multiple
// of 128).  merge_s is the merge pass's buffer (a power of two of at
// least k + 256), rows the corpus rows per chunk, vec4 whether rows may
// be read as float4s (D % 4 == 0, items 16-byte aligned), part_s/part_i
// the [B, n_chunks, k] scratch.  Returns cudaGetLastError() after the
// launches (0 = both launched); faults during the run surface at the
// next synchronisation.
extern "C" int pio_fused_topk(const float* queries, const float* items,
                              int B, int D, int n_real, int k, int S, int qb,
                              int rows, int n_chunks, int vec4, int tiled,
                              int merge_s, float* part_s, int* part_i,
                              float* out_s, int* out_i, void* stream) {
  const int log_s = log2_exact(S);
  const int log_m = log2_exact(merge_s);
  const TiledPass tiled_fn = tiled ? tiled_pass(qb) : nullptr;
  if (log_s < 0 || log_m < 0 || merge_s < k + kThreads || k < 1 ||
      rows < 1 || n_chunks < 1 || B < 1 || D < 1 ||
      (tiled ? tiled_fn == nullptr || S <= k || rows % kTileRows
             : S < k + kThreads || qb < 1 || qb > kMaxQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = tiled ? tiled_smem(qb, D, S)
                             : sizeof(Cand) * qb * S + sizeof(float) * qb * D;
  const size_t smem2 = sizeof(Cand) * merge_s;
  cudaError_t err =
      tiled ? cudaFuncSetAttribute(tiled_fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem1))
            : cudaFuncSetAttribute(topk_score_pass,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(topk_merge_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + qb - 1) / qb, n_chunks);
  if (tiled)
    tiled_fn<<<grid1, kThreads, smem1, st>>>(queries, items, B, D, n_real, k,
                                             S, log_s, rows, n_chunks, vec4,
                                             part_s, part_i);
  else
    topk_score_pass<<<grid1, kThreads, smem1, st>>>(
        queries, items, B, D, n_real, k, S, log_s, qb, rows, n_chunks, vec4,
        part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_pass<<<B, kThreads, smem2, st>>>(part_s, part_i, n_chunks * k,
                                              k, merge_s, log_m, out_s,
                                              out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
