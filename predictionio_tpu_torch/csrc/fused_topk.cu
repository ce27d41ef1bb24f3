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
// Design.  The Pallas kernel walks the corpus in order with one running
// top-k in VMEM; Hopper's blocks run in parallel and in no order, so the
// work is split in two launches:
//
//   1. topk_score_pass: block (g, c) owns query group g (up to 8
//      queries, staged in shared memory) and the contiguous corpus range
//      c.  Each thread scores one item row per tile with float32 FMAs
//      (read straight from global memory, float4 where the row allows)
//      and keeps, per query, a running top-k in shared memory by
//      threshold-and-compact: a score that beats the current k-th best
//      is appended to a candidate buffer; when the buffer could overflow
//      in the next tile, the block bitonic-sorts it with the running
//      top-k and keeps the best k.  Blocks of one corpus range differ
//      only in their query group and are launched side by side
//      (blockIdx.x = query group), so the range is read from device
//      memory once and the other groups hit in L2.  The block writes its
//      k best (score, id) pairs to a scratch tensor [B, chunks, k].
//   2. topk_merge_pass: one block per query streams its chunks*k
//      candidates through the same threshold-and-compact buffer and
//      writes the final sorted [k].
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

}  // namespace

// Launch both passes on `stream`.  S is the per-query buffer length (a
// power of two, at least k + 256), qb the queries per score-pass block
// (1..8), rows the corpus rows per chunk, part_s/part_i the [B,
// n_chunks, k] scratch.  Returns cudaGetLastError() after the launches
// (0 = both launched); faults during the run surface at the next
// synchronisation.
extern "C" int pio_fused_topk(const float* queries, const float* items,
                              int B, int D, int n_real, int k, int S, int qb,
                              int rows, int n_chunks, int vec4,
                              float* part_s, int* part_i, float* out_s,
                              int* out_i, void* stream) {
  const int log_s = log2_exact(S);
  if (log_s < 0 || S < k + kThreads || k < 1 || qb < 1 ||
      qb > kMaxQ || rows < 1 || n_chunks < 1 || B < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = sizeof(Cand) * qb * S + sizeof(float) * qb * D;
  const size_t smem2 = sizeof(Cand) * S;
  cudaError_t err = cudaFuncSetAttribute(
      topk_score_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(topk_merge_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + qb - 1) / qb, n_chunks);
  topk_score_pass<<<grid1, kThreads, smem1, st>>>(
      queries, items, B, D, n_real, k, S, log_s, qb, rows, n_chunks, vec4,
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
