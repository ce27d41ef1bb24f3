// Asymmetric PQ LUT scan + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel pq_scan_pallas / _pq_scan_kernel in
// predictionio_tpu/ops/pallas_kernels.py: for B queries' lookup tables
// luts[B, T, 256] (float32; T = 1 + M tables, the coarse table first) and
// a packed code matrix codes[T, N] (uint8), the top-k over items n of
//
//   score[b, n] = sum_t luts[b, t, codes[t, n]]
//
// with items at or past n_real masked out, returned as ([B,k] f32 sorted
// descending, [B,k] int32) without ever writing the [B,N] score block.
//
// What bounds it on this card.  At B = 1 the T*N bytes of codes: one
// read of the quantized corpus (17.8 MB at N = 2^20, T = 17, ~5 us at
// 3.35 TB/s).  At large B the B*T*N table lookups in shared memory: 32
// banks of 4 bytes per SM per clock; a warp's 32 lookups into one 256-entry
// table land in random banks, so they conflict.
//
// Design.  The Pallas kernel expands each table's codes into a one-hot
// [256, tile] block and multiplies it on the MXU, because Mosaic has no
// vector gather.  Hopper gathers from shared memory directly, so:
//
//   1. pq_score_pass: block (g, c) owns query group g (up to 8 queries)
//      and the contiguous item range c.  It stages the group's tables in
//      shared memory (T*256*4 bytes per query: 17,408 B at T = 17).  A
//      round of the block scores 256 * IPT consecutive items, IPT a
//      thread: 16 in a block of one query, 4 in a block of several (its
//      scores then take 4 registers a query).  A thread reads its IPT
//      codes of a table with one 16- or 4-byte load (neighbouring threads
//      on neighbouring words; byte loads when the rows are not so
//      aligned, N % IPT != 0), eight tables' loads issued together, and
//      adds luts[q, t, code] for each item and query in the order of t,
//      so the sum is bit-identical to the plain version's.  The round's scores then go to the per-query
//      threshold-and-compact buffer through offer_block (topk_select.cuh)
//      with one block barrier a round: while a query has no threshold
//      yet, the round's own candidates give it one (per-warp shuffle
//      ranks), so the first round appends about k candidates, not all of
//      them.  Each block writes its k best to a scratch tensor
//      [B, chunks, k].
//   2. topk_merge_pass (topk_select.cuh): one block per query folds its
//      chunks*k candidates, 16 a thread a round, through offer_block into
//      the final sorted [k].
//
// One item a thread per 256-item tile, with a block barrier a tile, a
// sort of the whole buffer after the first tile and a merge pass that
// folds 256 candidates a tile, is bound by latency, not bytes: few loads
// in flight and many barriers.  This design is built against that.  At
// B = 1 what is left is mostly the lookups' bank conflicts (about 3.5
// shared-memory wavefronts a warp-wide lookup of random codes) and the
// latency of each block's one round and final buffer sort.
//
// Ties: on exactly equal scores the lower item id ranks first (as K3).
// Slots no item fills (fewer than k items below n_real) come back as
// score -3.4e38 and id -1.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/pq_scan.py) plans the grid, allocates every
// output and scratch tensor, and passes PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kMaxQ = 8;       // queries per score-pass block
constexpr int kLut = 256;      // entries per table
constexpr int kRowBatch = 8;   // tables whose code loads a thread issues
                               // together
static_assert(kThreads == kMergeThreads, "one block width for both passes");

// IPT codes of one table row from p (the codes of item n0 onwards, n0 + IPT
// <= N when vec), as IPT / 4 little-endian words.
template <int IPT>
__device__ __forceinline__ void load_codes(const uint8_t* p, int vec, int n0,
                                           int N, uint32_t (&w)[IPT / 4]) {
  if (vec) {
    if constexpr (IPT == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < IPT / 4; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n0 + 4 * i + u < N) x |= static_cast<uint32_t>(__ldg(p + 4 * i + u))
                                   << (8 * u);
    w[i] = x;
  }
}

// QB: the most queries a block takes (1, or kMaxQ with nq <= kMaxQ at run
// time); IPT: items a thread scores a round.
template <int IPT, int QB>
__global__ void __launch_bounds__(kThreads, QB == 1 ? 2 : 1)
pq_score_pass(const float* __restrict__ luts,
              const uint8_t* __restrict__ codes, int B, int T, int N,
              int n_real, int k, int S, int log_s, int qb, int rows,
              int n_chunks, int vec, float* __restrict__ part_s,
              int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                 // [qb][T][256]
  Cand* buf = reinterpret_cast<Cand*>(smem + sizeof(float) * qb * T * kLut);
  __shared__ int cnt[kMaxQ];
  __shared__ float thr_s[kMaxQ];
  __shared__ int thr_i[kMaxQ];
  __shared__ Cand bound[kMaxQ * kBoundSlots];

  const int q0 = blockIdx.x * qb;
  const int nq = min(qb, B - q0);
  const int chunk = blockIdx.y;
  const int lo = chunk * rows;
  const int hi = min(lo + rows, n_real);  // the wrapper keeps it in int
  const int per_q = T * kLut;             // floats of one query's tables

  // One query's tables are T*256 floats: whole float4s, 16-byte aligned.
  // Four loads a thread in flight.
  const float4* src =
      reinterpret_cast<const float4*>(luts + static_cast<size_t>(q0) * per_q);
  float4* dst = reinterpret_cast<float4*>(lut);
  const int n4 = (nq * per_q) >> 2;
  for (int t0 = threadIdx.x; t0 < n4; t0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + i * kThreads < n4) v[i] = __ldg(src + t0 + i * kThreads);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + i * kThreads < n4) dst[t0 + i * kThreads] = v[i];
  }
  init_rows(buf, nq, log_s, kMaxQ, cnt, thr_s, thr_i, bound);
  __syncthreads();
  const Rows sel{buf, cnt, thr_s, thr_i, bound, nq, S, log_s, k};

  for (int base = lo; base < hi; base += kThreads * IPT) {
    const int n0 = base + threadIdx.x * IPT;
    float acc[QB * IPT];
#pragma unroll
    for (int u = 0; u < QB * IPT; ++u) acc[u] = 0.f;
    if (n0 < hi) {
      const uint8_t* col = codes + n0;
      for (int t0 = 0; t0 < T; t0 += kRowBatch) {
        uint32_t w[kRowBatch][IPT / 4];  // a batch of rows' loads in flight
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i)
          if (t0 + i < T)
            load_codes<IPT>(col + static_cast<size_t>(t0 + i) * N, vec, n0,
                            N, w[i]);
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i) {
          if (t0 + i >= T) break;
          const float* row = lut + (t0 + i) * kLut;
#pragma unroll
          for (int u = 0; u < IPT; ++u) {
            const int code = (w[i][u / 4] >> (8 * (u % 4))) & 0xff;
#pragma unroll
            for (int q = 0; q < QB; ++q)
              if (q < nq) acc[q * IPT + u] += row[q * per_q + code];
          }
        }
      }
    }
    int id[QB * IPT];
    unsigned valid = 0;
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int u = 0; u < IPT; ++u) {
        id[q * IPT + u] = n0 + u;
        if (q < nq && n0 + u < hi) valid |= 1u << (q * IPT + u);
      }
    offer_block<QB * IPT, IPT>(acc, id, valid, sel);
  }
  __syncthreads();
  merge_rows(buf, nq, S, log_s, k, cnt, thr_s, thr_i);
  write_partial(buf, nq, log_s, k, q0, n_chunks, chunk, part_s, part_i);
}

// Items a thread scores a round in a block of qb queries.
inline int items_per_thread(int qb) { return qb == 1 ? 16 : 4; }

}  // namespace

// Launch both passes on `stream`.  luts [B, T, 256] float32 (16-byte
// aligned), codes [T, N] uint8, both contiguous; S is the per-query
// buffer length (a power of two, at least k + 256), qb the queries per
// score-pass block (1..8), rows the items per chunk (a multiple of 256
// times the items a thread scores a round: 16 at qb 1, else 4),
// part_s/part_i the [B, n_chunks, k] scratch.  Returns cudaGetLastError()
// after the launches (0 = both launched); faults during the run surface
// at the next synchronisation.
extern "C" int pio_pq_scan(const float* luts, const uint8_t* codes, int B,
                           int T, int N, int n_real, int k, int S, int qb,
                           int rows, int n_chunks, float* part_s,
                           int* part_i, float* out_s, int* out_i,
                           void* stream) {
  const int log_s = log2_exact(S);
  if (log_s < 0 || S < k + kThreads || k < 1 || qb < 1 || qb > kMaxQ ||
      rows < 1 || rows % (kThreads * items_per_thread(qb)) ||
      n_chunks < 1 || B < 1 || T < 1 || N < 1 || n_real < 0 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ipt = items_per_thread(qb);
  const int vec = N % ipt == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const size_t smem1 =
      sizeof(float) * qb * T * kLut + sizeof(Cand) * qb * S;
  const size_t smem2 = sizeof(Cand) * S;
  using ScorePass = void (*)(const float*, const uint8_t*, int, int, int,
                            int, int, int, int, int, int, int, int, float*,
                            int*);
  const ScorePass score =
      qb == 1 ? &pq_score_pass<16, 1> : &pq_score_pass<4, kMaxQ>;
  cudaError_t err = cudaFuncSetAttribute(
      score, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(topk_merge_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + qb - 1) / qb, n_chunks);
  score<<<grid1, kThreads, smem1, st>>>(luts, codes, B, T, N, n_real, k, S,
                                        log_s, qb, rows, n_chunks, vec,
                                        part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_pass<<<B, kThreads, smem2, st>>>(part_s, part_i, n_chunks * k,
                                              k, S, log_s, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
