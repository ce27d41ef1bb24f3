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
// w = c = 0 (and index 0), so they add exactly zero.
//
// What bounds it on this card: per slot, K multiplies for w*f, K(K+1)
// flops for the symmetric A (its upper triangle) and 2K for b, against
// 12 bytes of index/weight/value reads; plus one read of the factor
// matrix and the A/b writes.  At rank 64 that is ~4.4K flops per 12-byte
// slot, far above the float32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// flop/byte): the CUDA cores' float32 FMA rate bounds it.  (Full float32:
// no TF32, no tensor cores in this first version; the kernel computes
// the whole of A, not only its upper triangle.)  The factor matrices of
// the ML-25M shape (15 MB items, 42 MB users at rank 64) fit in the
// 50 MB L2, so the random row gathers mostly hit L2.
//
// Design.  256 threads per block form a 16 x 16 grid over a KP x KP tile
// of A, each thread keeping a TM x TM register tile of it (TM = 1, 2, 4
// or 8; KP = 16 * TM).  Up to rank 128 one block covers the whole of a
// solve row's A (KP >= K).  Above it KP = 128 and A is cut into T x T
// tiles (T = ceil(K / 128)): the grid is R x T*T blocks, and block
// (r, ti*T + tj) builds tile (ti, tj) of A[r] from columns ti*128.. (w*f)
// and tj*128.. (f) of the gathered rows; the blocks with ti = 0 also
// build b[r]'s tj-th slice.  The row's slots are walked in tiles of
// kTile: the tile's indices and weights are staged in shared memory,
// then its factor rows' two column slices are gathered (converted to
// float32 on load, bfloat16 or float32 in) into two shared arrays, f and
// w*f.  Each thread then does TM*TM FMAs per slot from 2*TM
// shared-memory reads (float4 where TM allows).  Threads t < KP also
// accumulate b.  Every accumulation is float32.
//
// The same source also holds kernel T1, the port of
// pallas_vmem_gather_gram in tools/exp_gram.py: A[r] = sum_l w[r,l] *
// f_l f_l^T with Y resident, i.e. exactly this kernel's A without b.  It
// is this kernel compiled with WITH_B = false (no c reads, no b
// accumulation), behind its own entry point pio_gather_gram: the
// gather-inside design T1 experimented with on the TPU is the one K1
// already runs and is tested with.  The same bound holds: at the tool's
// shape (R 20,000, L 256, K 64) 2.2e10 flops against 0.4 GB of reads
// and A writes, so the float32 FMA rate bounds T1 too.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/fused_gram.py) checks shapes and types,
// allocates A and b, and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads over A
constexpr int kTile = 32;      // slots staged per step
constexpr int kTileK = 128;    // 16 * TM with TM = 8: the widest A tile
constexpr int kMaxK = 256;     // T = 2 tiles a side

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

template <typename T, bool WITH_B>
cudaError_t launch(const void* factors, const int* idx, const float* w,
                   const float* c, int R, int L, int K, float* A, float* b,
                   cudaStream_t st) {
  const T* f = static_cast<const T*>(factors);
  const int n_tiles = (K + kTileK - 1) / kTileK;   // A tiles a side (TM = 8)
  const dim3 grid(R, n_tiles * n_tiles);
  if (K <= 16)
    gram_kernel<T, 1, WITH_B><<<grid, kThreads, 0, st>>>(f, idx, w, c, L, K, A, b);
  else if (K <= 32)
    gram_kernel<T, 2, WITH_B><<<grid, kThreads, 0, st>>>(f, idx, w, c, L, K, A, b);
  else if (K <= 64)
    gram_kernel<T, 4, WITH_B><<<grid, kThreads, 0, st>>>(f, idx, w, c, L, K, A, b);
  else
    gram_kernel<T, 8, WITH_B><<<grid, kThreads, 0, st>>>(f, idx, w, c, L, K, A, b);
  return cudaGetLastError();
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
// contiguous, on `stream`.  The same kernel as pio_fused_gram with b
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
