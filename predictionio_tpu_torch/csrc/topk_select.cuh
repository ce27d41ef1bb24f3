// Block-level top-k selection shared by the fused top-k kernel (K3,
// fused_topk.cu) and the PQ scan kernel (K5, pq_scan.cu).
//
// A score pass keeps, per query, a running top-k in shared memory by
// threshold-and-compact: a candidate that beats the query's current k-th
// best is appended to a buffer of S = 2^log_s slots (the first k hold
// the running top-k); when the buffer could overflow in the next tile,
// merge_rows bitonic-sorts it and keeps the best k.  Each score-pass
// block writes its k best (score, id) pairs to a scratch tensor
// [B, chunks, k]; topk_merge_pass then folds each query's chunks*k
// candidates through the same buffer into the final sorted [k].
//
// Ranking: higher score first, lower id first among equal scores.  Slots
// that no candidate fills come out as score -3.4e38 and id -1.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

// Internal linkage: every .cu that includes this header builds into its
// own shared library.
namespace {

constexpr int kMergeThreads = 256;    // threads of the merge pass
constexpr int kFillerId = INT_MAX;    // empty slot; sorts after every item
constexpr float kNegInf = -3.4e38f;   // ops.topk.NEG_INF

struct Cand {
  float s;
  int id;
};

// Ranking order: higher score first, lower id first among equal scores.
__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Sort the first nq rows of buf (row stride S = 1 << log_s) best-first
// and keep the k best at the front of each row.  Row q holds its running
// top-k in [0, k) and cnt[q] fresh candidates in [k, k + cnt[q]); the
// rest is filled with empty slots before the bitonic sort.  Resets the
// counts and publishes each row's k-th best as the new threshold.
// Every thread of the block must call it, after a barrier.
__device__ void merge_rows(Cand* buf, int nq, int S, int log_s, int k,
                           int* cnt, float* thr_s, int* thr_i) {
  const int total = nq << log_s;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int q = t >> log_s;
    if ((t & (S - 1)) >= k + cnt[q]) buf[t] = Cand{-INFINITY, kFillerId};
  }
  __syncthreads();
  const int half_mask = (S >> 1) - 1;
  for (int size = 2; size <= S; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (total >> 1); t += blockDim.x) {
        Cand* row = buf + ((t >> (log_s - 1)) << log_s);
        const int j = t & half_mask;
        const int i = ((j & ~(stride - 1)) << 1) | (j & (stride - 1));
        const Cand a = row[i];
        const Cand c = row[i + stride];
        const bool best_first = (i & size) == 0;
        if (best_first ? better(c.s, c.id, a.s, a.id)
                       : better(a.s, a.id, c.s, c.id)) {
          row[i] = c;
          row[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x < nq) {
    const Cand kth = buf[(threadIdx.x << log_s) + k - 1];
    cnt[threadIdx.x] = 0;
    thr_s[threadIdx.x] = kth.s;
    thr_i[threadIdx.x] = kth.id;
  }
  __syncthreads();
}

// Append (s, id) to query q's buffer when it beats the query's current
// threshold.  The caller keeps cnt[q] <= S - k - (appends per tile).
__device__ __forceinline__ void offer(Cand* buf, int q, int log_s, int k,
                                      int* cnt, const float* thr_s,
                                      const int* thr_i, float s, int id) {
  if (better(s, id, thr_s[q], thr_i[q])) {
    const int p = atomicAdd(&cnt[q], 1);
    buf[(q << log_s) + k + p] = Cand{s, id};
  }
}

// Empty buffers and thresholds for a block's nq queries.
__device__ __forceinline__ void init_rows(Cand* buf, int nq, int log_s,
                                          int max_q, int* cnt, float* thr_s,
                                          int* thr_i) {
  for (int t = threadIdx.x; t < (nq << log_s); t += blockDim.x)
    buf[t] = Cand{-INFINITY, kFillerId};
  if (threadIdx.x < max_q) {
    cnt[threadIdx.x] = 0;
    thr_s[threadIdx.x] = -INFINITY;
    thr_i[threadIdx.x] = kFillerId;
  }
}

// Write each of the block's nq rows' k best to the [B, n_chunks, k]
// scratch at query q0 + q, chunk `chunk`.
__device__ __forceinline__ void write_partial(const Cand* buf, int nq,
                                              int log_s, int k, int q0,
                                              int n_chunks, int chunk,
                                              float* part_s, int* part_i) {
  for (int t = threadIdx.x; t < nq * k; t += blockDim.x) {
    const int q = t / k;
    const int j = t - q * k;
    const Cand c = buf[(q << log_s) + j];
    const size_t o = (static_cast<size_t>(q0 + q) * n_chunks + chunk) * k + j;
    part_s[o] = c.s;
    part_i[o] = c.id;
  }
}

// One block per query: stream its c = chunks*k candidates through the
// threshold-and-compact buffer and write the final sorted [k].
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_pass(const float* __restrict__ part_s,
                const int* __restrict__ part_i, int c, int k, int S,
                int log_s, float* __restrict__ out_s,
                int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cand* buf = reinterpret_cast<Cand*>(smem);                  // [S]
  __shared__ int cnt[1];
  __shared__ float thr_s[1];
  __shared__ int thr_i[1];

  const size_t b = blockIdx.x;
  const float* ps = part_s + b * c;
  const int* pi = part_i + b * c;
  init_rows(buf, 1, log_s, 1, cnt, thr_s, thr_i);
  __syncthreads();

  const int limit = S - k - kMergeThreads;
  for (int base = 0; base < c; base += kMergeThreads) {
    if (__syncthreads_or(cnt[0] > limit)) merge_rows(buf, 1, S, log_s, k, cnt, thr_s, thr_i);
    const int j = base + threadIdx.x;
    if (j < c) {
      const int id = pi[j];
      if (id != kFillerId) offer(buf, 0, log_s, k, cnt, thr_s, thr_i, ps[j], id);
    }
    __syncthreads();
  }
  merge_rows(buf, 1, S, log_s, k, cnt, thr_s, thr_i);

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const Cand x = buf[j];
    const bool empty = x.id == kFillerId;
    out_s[b * k + j] = empty ? kNegInf : x.s;
    out_i[b * k + j] = empty ? -1 : x.id;
  }
}

// log2 of S when S is a power of two of at least 2, else -1.
inline int log2_exact(int S) {
  int log_s = 1;
  while ((1 << log_s) < S && log_s < 30) ++log_s;
  return (1 << log_s) == S ? log_s : -1;
}

}  // namespace
