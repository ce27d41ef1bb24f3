// Row gather + sum for Hopper (sm_90a).
//
// Replaces the TPU kernel pallas_gather (kernel from make_kernel) in
// tools/exp_gather2.py, whose modes "take", "loop8" and "loop" are three
// TPU spellings of one function:
//
//   out[r] = sum_l y[idx[r, l]]        idx [R, L] int32, y [I, K] float32
//
// What bounds it on this card.  R*L gathered rows of K floats, K adds
// each: at the tool's shape (R 20,000, L 256, K 64) 1.3 GB of row reads
// for 0.33 GFLOP, so memory traffic bounds it.  The contract's bound
// counts each input once (idx, y, out: 41 MB, ~12 us at 3.35 TB/s); y
// (15 MB at I 59,047) fits in the 50 MB L2, so the repeated row reads of
// the Zipf(1.25) indices mostly hit L2, and L2 bandwidth is the real
// limit.
//
// Design.  One warp owns one output row (and one block of its columns).
// The lanes load 32 indices at a time, coalesced, and broadcast them one
// by one with __shfl_sync; for each index every lane reads its own
// columns of the gathered row (a float2 per lane at K = 64: the warp
// reads the 256-byte row in one pass) and adds them into float32
// registers, in l order.  Rows wider than a warp's column block (256
// floats) take more blocks along grid.y; odd K takes one float per lane.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/gather.py) checks shapes and types,
// allocates the output and passes PyTorch's current stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps = 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

// Each lane owns NV vectors of VEC floats: columns
// col0 + (v * 32 + lane) * VEC + e of the block's column range.
template <int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const float* __restrict__ y, const int* __restrict__ idx,
                  int R, int L, int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warps leave together
  const int col0 = blockIdx.y * (32 * VEC * NV);
  float acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[v][e] = 0.f;
  const int* ix = idx + static_cast<size_t>(r) * L;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    const int mine = lane < n ? __ldg(ix + l0 + lane) : 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int row = __shfl_sync(0xffffffffu, mine, j);
      const float* yr = y + static_cast<size_t>(row) * K;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = col0 + (v * 32 + lane) * VEC;
        if (c < K) {
          if constexpr (VEC == 2) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(yr + c));
            acc[v][0] += x.x;
            acc[v][1] += x.y;
          } else {
            acc[v][0] += __ldg(yr + c);
          }
        }
      }
    }
  }
  float* o = out + static_cast<size_t>(r) * K;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = col0 + (v * 32 + lane) * VEC;
    if (c < K) {
      if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(o + c) = make_float2(acc[v][0], acc[v][1]);
      } else {
        o[c] = acc[v][0];
      }
    }
  }
}

template <int VEC, int NV>
cudaError_t launch(const float* y, const int* idx, int R, int L, int K,
                   float* out, cudaStream_t st) {
  constexpr int width = 32 * VEC * NV;  // columns per block along grid.y
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  (K + width - 1) / width);
  gather_sum_kernel<VEC, NV><<<grid, kThreads, 0, st>>>(y, idx, R, L, K, out);
  return cudaGetLastError();
}

}  // namespace

// out [R, K] float32 from y [I, K] float32 and idx [R, L] int32 in
// [0, I), all contiguous (y and out 8-byte aligned), on `stream`.
// Returns cudaGetLastError() after the launch (0 = launched); faults
// during the run surface at the next synchronisation.
extern "C" int pio_gather_sum(const float* y, const int* idx, int R, int L,
                              int K, float* out, void* stream) {
  if (R < 1 || L < 1 || K < 1 || (K + 255) / 256 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K % 2 == 0) {  // float2 lanes: 64 columns per vector pass
    if (K <= 64)
      err = launch<2, 1>(y, idx, R, L, K, out, st);
    else if (K <= 128)
      err = launch<2, 2>(y, idx, R, L, K, out, st);
    else
      err = launch<2, 4>(y, idx, R, L, K, out, st);
  } else {
    if (K <= 32)
      err = launch<1, 1>(y, idx, R, L, K, out, st);
    else if (K <= 64)
      err = launch<1, 2>(y, idx, R, L, K, out, st);
    else if (K <= 128)
      err = launch<1, 4>(y, idx, R, L, K, out, st);
    else
      err = launch<1, 8>(y, idx, R, L, K, out, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
