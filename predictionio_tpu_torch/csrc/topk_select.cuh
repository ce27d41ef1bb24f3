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
// offer_block is the round-at-a-time form of the same buffer, for
// passes whose threads hold many candidates each (the PQ scan's score
// pass, K3's tiled score pass and topk_merge_pass): every thread offers
// all of its candidates at once, with one block barrier a round instead
// of one a tile.  While a query's buffer has no threshold yet, the round
// itself gives one: each warp ranks its lanes' best candidates with a
// shuffle sort, and the worst of the warps' c-th best, c = ceil(k /
// warps offering that query), is beaten or matched by at least k
// candidates, so nothing below it can rank.  That keeps the first round
// from filling the buffer with every candidate.
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
constexpr int kMergeItems = 16;       // candidates a merge thread takes a round
constexpr int kBoundWarps = kMergeThreads / 32;  // warps of an offer_block
constexpr int kBoundSlots = kBoundWarps + 1;     // per query, in Rows
constexpr int kFillerId = INT_MAX;    // empty slot; sorts after every item
constexpr float kNegInf = -3.4e38f;   // ops.topk.NEG_INF
constexpr unsigned kAllLanes = 0xffffffffu;

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

// Empty buffers and thresholds for a block's nq queries, and, given
// `bound` (offer_block's slots), their best bounds so far.
__device__ __forceinline__ void init_rows(Cand* buf, int nq, int log_s,
                                          int max_q, int* cnt, float* thr_s,
                                          int* thr_i, Cand* bound = nullptr) {
  for (int t = threadIdx.x; t < (nq << log_s); t += blockDim.x)
    buf[t] = Cand{-INFINITY, kFillerId};
  if (threadIdx.x < max_q) {
    cnt[threadIdx.x] = 0;
    thr_s[threadIdx.x] = -INFINITY;
    thr_i[threadIdx.x] = kFillerId;
    if (bound != nullptr)
      bound[threadIdx.x * kBoundSlots + kBoundWarps] =
          Cand{-INFINITY, kFillerId};
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

// The selection state of a block in shared memory: per query, S = 1 <<
// log_s buffer slots (the running top-k first), the count of fresh
// candidates, the threshold (the k-th best after the last merge), and
// kBoundSlots slots for offer_block's bounds: one a warp, then the best
// bound so far (init_rows leaves it empty).
struct Rows {
  Cand* buf;
  int* cnt;
  float* thr_s;
  int* thr_i;
  Cand* bound;
  int nq, S, log_s, k;
};

// The c-th best (1 <= c <= 32) of the warp's lanes' m: a bitonic sort
// over shuffles, best first.  Every lane of the warp must call it.
__device__ __forceinline__ Cand warp_rank(Cand m, int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Cand o{__shfl_xor_sync(kAllLanes, m.s, stride),
                   __shfl_xor_sync(kAllLanes, m.id, stride)};
      // the lower lane of a pair keeps the better in a best-first run
      const bool keep_better = ((lane & size) == 0) == ((lane & stride) == 0);
      if (keep_better ? better(o.s, o.id, m.s, m.id)
                      : better(m.s, m.id, o.s, o.id))
        m = o;
    }
  }
  return Cand{__shfl_sync(kAllLanes, m.s, c - 1),
              __shfl_sync(kAllLanes, m.id, c - 1)};
}

// Offer every thread's NC candidates (score s[u], id[u], of row
// q0 + u / PER_Q; only those whose bit is set in `valid`) to the block's
// rows.  A candidate that beats its row's threshold is appended; when a
// row is full, the block merges the rows and offers what is left again.
// Every thread of the block (kBoundWarps warps) must call it; it starts
// and ends with no barrier pending, so merge_rows may follow directly
// only after a __syncthreads().
//
// GROUPS splits the block's warps into query groups: warp w offers for
// the rows of group w % GROUPS, and every lane of a warp passes the same
// q0.  With GROUPS = 1 (the PQ scan and the merge pass) every thread
// offers for the same rows and q0 is 0.
template <int NC, int PER_Q, int GROUPS = 1>
__device__ void offer_block(const float (&s)[NC], const int (&id)[NC],
                            unsigned valid, const Rows& r, int q0 = 0) {
  static_assert(NC <= 32 && NC % PER_Q == 0, "one bit a candidate");
  static_assert(kBoundWarps % GROUPS == 0, "whole warps a group");
  constexpr int NQ = NC / PER_Q;
  constexpr int kRowWarps = kBoundWarps / GROUPS;  // warps offering a row
  const int c = (r.k + kRowWarps - 1) / kRowWarps;
  // While a row has no threshold, this round's candidates bound it.
  bool open[NQ];
  bool any_open = false;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    open[q] = q0 + q < r.nq && r.thr_i[q0 + q] == kFillerId && c <= 32;
    any_open |= open[q];
  }
  // Thresholds change only between barriers, so with one group any_open
  // is uniform; groups hold other rows and agree on it first.
  if (GROUPS == 1 ? any_open : __syncthreads_or(any_open)) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (!open[q]) continue;
      Cand m{-INFINITY, kFillerId};
#pragma unroll
      for (int u = q * PER_Q; u < (q + 1) * PER_Q; ++u)
        if ((valid >> u & 1) && better(s[u], id[u], m.s, m.id))
          m = Cand{s[u], id[u]};
      const Cand t = warp_rank(m, c);
      if ((threadIdx.x & 31) == 0)
        r.bound[(q0 + q) * kBoundSlots + (threadIdx.x >> 5) / GROUPS] = t;
    }
    __syncthreads();
  }
  float eff_s[NQ];
  int eff_i[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    eff_s[q] = q0 + q < r.nq ? r.thr_s[q0 + q] : INFINITY;
    eff_i[q] = q0 + q < r.nq ? r.thr_i[q0 + q] : kFillerId;
    if (open[q]) {
      // At least c candidates of every warp of the row are as good as its
      // bound, so k or more are as good as the worst bound: a candidate
      // below it cannot rank.  The bound itself may: the threshold is the
      // pair just below it, (score, id + 1).  An earlier round's bound
      // holds too; the best so far is kept (every thread of the group
      // computes the same, so the unordered write is harmless).
      Cand* slots = r.bound + (q0 + q) * kBoundSlots;
      Cand w = slots[0];
#pragma unroll
      for (int v = 1; v < kRowWarps; ++v)
        if (better(w.s, w.id, slots[v].s, slots[v].id)) w = slots[v];
      if (w.id != kFillerId) w.id += 1;
      const Cand best = slots[kBoundWarps];
      if (better(best.s, best.id, w.s, w.id)) w = best;
      const bool writer = GROUPS == 1 ? threadIdx.x == 0
                                      : (threadIdx.x & 31) == 0 &&
                                            (threadIdx.x >> 5) < GROUPS;
      if (writer) slots[kBoundWarps] = w;
      eff_s[q] = w.s;
      eff_i[q] = w.id;
    }
  }
  unsigned pend = 0;
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if ((valid >> u & 1) &&
        better(s[u], id[u], eff_s[u / PER_Q], eff_i[u / PER_Q]))
      pend |= 1u << u;
  const int cap = r.S - r.k;  // fresh slots a row holds
  while (true) {
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      if (!(pend >> u & 1)) continue;
      const int q = q0 + u / PER_Q;
      const int p = atomicAdd(&r.cnt[q], 1);
      if (p < cap) {
        r.buf[(q << r.log_s) + r.k + p] = Cand{s[u], id[u]};
        pend &= ~(1u << u);
      }
    }
    if (!__syncthreads_or(pend != 0)) break;
    if (threadIdx.x < r.nq)
      r.cnt[threadIdx.x] = min(r.cnt[threadIdx.x], cap);
    __syncthreads();
    merge_rows(r.buf, r.nq, r.S, r.log_s, r.k, r.cnt, r.thr_s, r.thr_i);
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int q = q0 + u / PER_Q;
      if ((pend >> u & 1) && !better(s[u], id[u], r.thr_s[q], r.thr_i[q]))
        pend &= ~(1u << u);
    }
  }
}

// One block per query: its c = chunks*k candidates, kMergeItems a thread
// a round (coalesced: thread t takes every kMergeThreads-th from t),
// through offer_block, then the final sorted [k].
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
  __shared__ Cand bound[kBoundSlots];

  const size_t b = blockIdx.x;
  const float* ps = part_s + b * c;
  const int* pi = part_i + b * c;
  init_rows(buf, 1, log_s, 1, cnt, thr_s, thr_i, bound);
  __syncthreads();
  const Rows rows{buf, cnt, thr_s, thr_i, bound, 1, S, log_s, k};

  for (int base = 0; base < c; base += kMergeThreads * kMergeItems) {
    float s[kMergeItems];
    int id[kMergeItems];
    unsigned valid = 0;
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int j = base + u * kMergeThreads + threadIdx.x;
      s[u] = j < c ? ps[j] : -INFINITY;
      id[u] = j < c ? pi[j] : kFillerId;
      if (id[u] != kFillerId) valid |= 1u << u;
    }
    offer_block<kMergeItems, kMergeItems>(s, id, valid, rows);
  }
  __syncthreads();
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
