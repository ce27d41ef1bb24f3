// Batched SPD ridge solves for Hopper (sm_90a): shrinking elimination
// (LU) and Gauss-Jordan, one source for both.
//
// Replaces the TPU kernels ridge_solve_lu_pallas / _lu_kernel (K2) and
// ridge_solve_gj_pallas / _gj_kernel (K4) in
// predictionio_tpu/ops/pallas_kernels.py, which share the scaffolding of
// _ridge_solve_lanes.  Both solve, for every system s of a batch,
//
//   (A[s] + diag(reg[s])) x[s] = b[s]      A [B,K,K], b [B,K], reg [B]
//
// in float32 with no pivoting: ALS-WR gives reg = lambda * max(degree, 1)
// > 0 on a Gram matrix, so every system is SPD and every pivot positive.
// LU eliminates below the pivot only (the trailing rows shrink) and then
// back-substitutes, about K^3 * 2/3 flops; Gauss-Jordan eliminates above
// and below, about K^3, and reads x off the last column.
//
// What bounds it on this card: the A reads.  A rank-64 system is 16 KB
// of A for ~175 Kflop (LU), ~11 flop/byte, under the float32 ridge of 20
// flop/byte (67 TFLOP/s over 3.35 TB/s), so one read of A at the memory
// rate is the least time.  This first version is bound instead by
// shared-memory traffic: each FMA of the elimination reads its
// multiplier and reads and writes one matrix entry in shared memory.
//
// Design.  One warp per system, several warps per block.  The Pallas
// kernels put 128 systems on the TPU's vector lanes; on Hopper a warp's
// 32 lanes share one system instead.  The warp stages the augmented
// K x (K+1) matrix [A + diag(reg) | b] in shared memory with an odd row
// stride (no bank conflicts when lanes walk a column), then for each
// pivot j the lanes take the columns right of j, one each (and every
// 32nd after), and update them down the rows; the pivot's column is not
// written during its step, so a __syncwarp between steps is the only
// barrier.  Back substitution runs the lanes down the rows of the
// right-hand side.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/ridge_solve.py) checks shapes and types,
// allocates x, and passes PyTorch's current stream.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 128;
constexpr int kMaxWarps = 8;
constexpr size_t kBlockSmem = 64 * 1024;  // shared memory a block aims at

enum Method { kLU = 0, kGJ = 1 };

__host__ __device__ constexpr int row_stride(int K) { return (K + 1) | 1; }

template <int METHOD>
__global__ void ridge_kernel(const float* __restrict__ A,
                             const float* __restrict__ b,
                             const float* __restrict__ reg, int B, int K,
                             float* __restrict__ x) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long s =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (s >= B) return;  // no block-wide barrier follows
  const int S = row_stride(K);
  float* M = smem + static_cast<size_t>(warp) * K * S;

  // Stage [A + diag(reg) | b].
  const float* a = A + s * K * K;
  const float r = reg[s];
  for (int e = lane; e < K * K; e += kWarp) {
    const int i = e / K;
    const int j = e - i * K;
    const float v = a[e];
    M[i * S + j] = i == j ? v + r : v;
  }
  for (int i = lane; i < K; i += kWarp) M[i * S + K] = b[s * K + i];
  __syncwarp();

  if (METHOD == kLU) {
    // Forward elimination: rows below the pivot only.
    for (int j = 0; j < K; ++j) {
      const float inv = 1.f / M[j * S + j];
      for (int col = j + 1 + lane; col <= K; col += kWarp) {
        const float pj = M[j * S + col] * inv;
        for (int i = j + 1; i < K; ++i)
          M[i * S + col] = fmaf(-M[i * S + j], pj, M[i * S + col]);
      }
      __syncwarp();
    }
    // Back substitution on the upper triangle; column K holds the
    // eliminated right-hand side.
    for (int j = K - 1; j >= 0; --j) {
      const float xj = M[j * S + K] * (1.f / M[j * S + j]);
      if (lane == 0) x[s * K + j] = xj;
      for (int i = lane; i < j; i += kWarp)
        M[i * S + K] = fmaf(-M[i * S + j], xj, M[i * S + K]);
      __syncwarp();
    }
  } else {
    // Gauss-Jordan: normalise the pivot row, eliminate every other row.
    for (int j = 0; j < K; ++j) {
      const float inv = 1.f / M[j * S + j];
      for (int col = j + 1 + lane; col <= K; col += kWarp) {
        const float pj = M[j * S + col] * inv;
        for (int i = 0; i < K; ++i)
          if (i != j) M[i * S + col] = fmaf(-M[i * S + j], pj, M[i * S + col]);
        M[j * S + col] = pj;
      }
      __syncwarp();
    }
    for (int i = lane; i < K; i += kWarp) x[s * K + i] = M[i * S + K];
  }
}

int warps_per_block(int K) {
  const size_t per_warp = sizeof(float) * K * row_stride(K);
  size_t w = kBlockSmem / per_warp;
  if (w < 1) w = 1;
  if (w > kMaxWarps) w = kMaxWarps;
  return static_cast<int>(w);
}

template <int METHOD>
cudaError_t launch(const float* A, const float* b, const float* reg, int B,
                   int K, float* x, cudaStream_t st) {
  const int w = warps_per_block(K);
  const size_t smem = sizeof(float) * w * K * row_stride(K);
  cudaError_t err = cudaFuncSetAttribute(
      ridge_kernel<METHOD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((B + w - 1) / w);
  ridge_kernel<METHOD><<<blocks, w * kWarp, smem, st>>>(A, b, reg, B, K, x);
  return cudaGetLastError();
}

}  // namespace

// x [B,K] from A [B,K,K], b [B,K], reg [B] (float32, contiguous) on
// `stream`; method 0 = LU (K2), 1 = Gauss-Jordan (K4).  Returns
// cudaGetLastError() after the launch (0 = launched); faults during the
// run surface at the next synchronisation.
extern "C" int pio_ridge_solve(int method, const float* A, const float* b,
                               const float* reg, int B, int K, float* x,
                               void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || (method != kLU && method != kGJ))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = method == kLU
                              ? launch<kLU>(A, b, reg, B, K, x, st)
                              : launch<kGJ>(A, b, reg, B, K, x, st);
  return static_cast<int>(err);
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
