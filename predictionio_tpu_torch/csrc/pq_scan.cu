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
//      shared memory (T*256*4 bytes per query: 17,408 B at T = 17).  Each
//      thread owns one code column per tile of 256 items: for t = 0..T-1
//      it reads codes[t, n] (neighbouring threads read neighbouring
//      bytes) and adds luts[q, t, code] for each query, in that order of
//      t, so the sum is bit-identical to the plain version's.  Scores
//      then go through the same per-query threshold-and-compact buffer
//      and bitonic merges as the fused top-k kernel (K3), shared through
//      topk_select.cuh, and each block writes its k best to a scratch
//      tensor [B, chunks, k].
//   2. topk_merge_pass (topk_select.cuh): one block per query folds its
//      chunks*k candidates into the final sorted [k].
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

constexpr int kThreads = 256;  // threads per block = items per tile
constexpr int kMaxQ = 8;       // queries per score-pass block
constexpr int kLut = 256;      // entries per table
static_assert(kThreads == kMergeThreads, "one tile width for both passes");

__global__ void __launch_bounds__(kThreads)
pq_score_pass(const float* __restrict__ luts,
              const uint8_t* __restrict__ codes, int B, int T, int N,
              int n_real, int k, int S, int log_s, int qb, int rows,
              int n_chunks, float* __restrict__ part_s,
              int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                 // [qb][T][256]
  Cand* buf = reinterpret_cast<Cand*>(smem + sizeof(float) * qb * T * kLut);
  __shared__ int cnt[kMaxQ];
  __shared__ float thr_s[kMaxQ];
  __shared__ int thr_i[kMaxQ];

  const int q0 = blockIdx.x * qb;
  const int nq = min(qb, B - q0);
  const int chunk = blockIdx.y;
  const int lo = chunk * rows;
  const int hi = min(lo + rows, n_real);  // the wrapper keeps it in int
  const int per_q = T * kLut;             // floats of one query's tables

  // One query's tables are T*256 floats: whole float4s, 16-byte aligned.
  const float4* src =
      reinterpret_cast<const float4*>(luts + static_cast<size_t>(q0) * per_q);
  float4* dst = reinterpret_cast<float4*>(lut);
  for (int t = threadIdx.x; t < (nq * per_q) >> 2; t += blockDim.x)
    dst[t] = __ldg(src + t);
  init_rows(buf, nq, log_s, kMaxQ, cnt, thr_s, thr_i);
  __syncthreads();

  const int limit = S - k - kThreads;  // counts above this may overflow
  for (int base = lo; base < hi; base += kThreads) {
    bool full = false;
    for (int q = 0; q < nq; ++q) full |= cnt[q] > limit;
    // The barrier also keeps every count read ahead of this tile's appends.
    if (__syncthreads_or(full)) merge_rows(buf, nq, S, log_s, k, cnt, thr_s, thr_i);
    const int n = base + threadIdx.x;
    if (n < hi) {
      float acc[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;
      const uint8_t* col = codes + n;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        const float* row = lut + t * kLut + __ldg(col + static_cast<size_t>(t) * N);
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q)
          if (q < nq) acc[q] += row[q * per_q];
      }
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < nq) offer(buf, q, log_s, k, cnt, thr_s, thr_i, acc[q], n);
    }
    __syncthreads();
  }
  merge_rows(buf, nq, S, log_s, k, cnt, thr_s, thr_i);
  write_partial(buf, nq, log_s, k, q0, n_chunks, chunk, part_s, part_i);
}

}  // namespace

// Launch both passes on `stream`.  luts [B, T, 256] float32 (16-byte
// aligned), codes [T, N] uint8, both contiguous; S is the per-query
// buffer length (a power of two, at least k + 256), qb the queries per
// score-pass block (1..8), rows the items per chunk (a multiple of 256),
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
      rows < 1 || rows % kThreads || n_chunks < 1 || B < 1 || T < 1 ||
      N < 1 || n_real < 0 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 =
      sizeof(float) * qb * T * kLut + sizeof(Cand) * qb * S;
  const size_t smem2 = sizeof(Cand) * S;
  cudaError_t err = cudaFuncSetAttribute(
      pq_score_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(topk_merge_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + qb - 1) / qb, n_chunks);
  pq_score_pass<<<grid1, kThreads, smem1, st>>>(luts, codes, B, T, N, n_real,
                                                k, S, log_s, qb, rows,
                                                n_chunks, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_pass<<<B, kThreads, smem2, st>>>(part_s, part_i, n_chunks * k,
                                              k, S, log_s, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
