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
// for 0.33 GFLOP.  The contract's bound counts each input once (idx, y,
// out: 41 MB, ~12 us at 3.35 TB/s); y (15 MB at I 59,047) fits in the
// 50 MB L2, and the Zipf(1.25) indices mostly hit the few rows at the
// head of y, so the row reads come from L1.  Timed under four index
// distributions (tools/exp_gather2.py dist), the warp design below takes
// as long on the tool's Zipf indices as when every index is 0 and 1.6x
// longer on uniform ones: it is bound by L1 and the issue of its load
// and shuffle instructions, two a gathered row, not by L2 or HBM.
//
// Design (vec4, K % 4 == 0 and K <= 128).  G = K/4 rounded up to 8, 16
// or 32 lanes own one output row, a float4 of its columns each, so a
// warp holds 32/G rows and one 16-byte load instruction reads a row for
// each of them (two 256-byte rows at K = 64).  The indices need no
// shuffles: every lane of a row's group loads the same 16 of them as
// four int4s (broadcast loads), then issues four row loads before it
// adds them, in l order, into float32 registers; registers are capped so
// that 40 warps an SM keep their loads in flight.  At K = 64 a warp
// gathers 32 rows with 20 load instructions where the warp design
// issues 64 (32 shuffles, 32 loads).
//
// The warp design (any K; the only one for K % 4 != 0 or K > 128): one
// warp owns one output row (and one block of its columns).  The lanes
// load 32 indices at a time, coalesced, and broadcast them one by one
// with __shfl_sync; for each index every lane reads its own columns of
// the gathered row (a float2 per lane at even K) and adds them into
// float32 registers, in l order.  Rows wider than a warp's column block
// (256 floats) take more blocks along grid.y; odd K takes one float per
// lane.  Both designs add each column's L terms in the same order, so
// they give the same bits.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/gather.py) checks shapes and types, picks
// the design, allocates the output and passes PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

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

cudaError_t launch_warp(const float* y, const int* idx, int R, int L, int K,
                        float* out, cudaStream_t st) {
  if (K % 2 == 0) {  // float2 lanes: 64 columns per vector pass
    if (K <= 64) return launch<2, 1>(y, idx, R, L, K, out, st);
    if (K <= 128) return launch<2, 2>(y, idx, R, L, K, out, st);
    return launch<2, 4>(y, idx, R, L, K, out, st);
  }
  if (K <= 32) return launch<1, 1>(y, idx, R, L, K, out, st);
  if (K <= 64) return launch<1, 2>(y, idx, R, L, K, out, st);
  if (K <= 128) return launch<1, 4>(y, idx, R, L, K, out, st);
  return launch<1, 8>(y, idx, R, L, K, out, st);
}

constexpr int kIdxRound = 16;  // indices a lane holds a round
constexpr int kInFlight = 4;   // row loads issued before their adds
// Blocks an SM the vec4 kernel's registers allow (at most 51 a thread):
// it waits on load latency, so warps in flight count more than registers.
constexpr int kVec4BlocksPerSM = 5;

// G lanes a row, a float4 of columns c = 4 * (lane % G) each; ivec:
// whether idx rows may be read as int4s (L % 4 == 0, 16-byte aligned).
template <int G>
__global__ void __launch_bounds__(kThreads, kVec4BlocksPerSM)
gather_sum_vec4_kernel(const float* __restrict__ y,
                       const int* __restrict__ idx, int R, int L, int K,
                       int ivec, float* __restrict__ out) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int r = (blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5)) *
                    kRowsPerWarp + lane / G;
  const int c = 4 * (lane % G);
  if (r >= R || c >= K) return;  // no shuffles: lanes may leave alone
  const int* ix = idx + static_cast<size_t>(r) * L;
  const float* yc = y + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l0 = 0; l0 < L; l0 += kIdxRound) {
    const int n = min(kIdxRound, L - l0);
    int j[kIdxRound];
    if (ivec && n == kIdxRound) {
#pragma unroll
      for (int v = 0; v < kIdxRound / 4; ++v) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(ix + l0) + v);
        j[4 * v] = w.x;
        j[4 * v + 1] = w.y;
        j[4 * v + 2] = w.z;
        j[4 * v + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kIdxRound; ++u)
        j[u] = u < n ? __ldg(ix + l0 + u) : 0;
    }
#pragma unroll
    for (int u0 = 0; u0 < kIdxRound; u0 += kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (u0 + u < n)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              yc + static_cast<size_t>(j[u0 + u]) * K));
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (u0 + u < n) {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
        }
      }
    }
  }
  *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * K + c) = acc;
}

template <int G>
cudaError_t launch_vec4(const float* y, const int* idx, int R, int L, int K,
                        int ivec, float* out, cudaStream_t st) {
  constexpr int rows = kRowsPerBlock * (32 / G);  // output rows a block
  gather_sum_vec4_kernel<G><<<(R + rows - 1) / rows, kThreads, 0, st>>>(
      y, idx, R, L, K, ivec, out);
  return cudaGetLastError();
}

}  // namespace

// out [R, K] float32 from y [I, K] float32 and idx [R, L] int32 in
// [0, I), all contiguous, on `stream`.  design 0 is the warp design (y
// and out 8-byte aligned), 1 the vec4 design (K % 4 == 0, K <= 128, y and
// out 16-byte aligned).  Returns cudaGetLastError() after the launch (0 =
// launched); faults during the run surface at the next synchronisation.
extern "C" int pio_gather_sum(const float* y, const int* idx, int R, int L,
                              int K, int design, float* out, void* stream) {
  if (R < 1 || L < 1 || K < 1 || (K + 255) / 256 > 65535 ||
      (design == 1 && (K % 4 || K > 128)) || design < 0 || design > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0)
    return static_cast<int>(launch_warp(y, idx, R, L, K, out, st));
  const int ivec = L % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  cudaError_t err;
  if (K <= 32)
    err = launch_vec4<8>(y, idx, R, L, K, ivec, out, st);
  else if (K <= 64)
    err = launch_vec4<16>(y, idx, R, L, K, ivec, out, st);
  else
    err = launch_vec4<32>(y, idx, R, L, K, ivec, out, st);
  return static_cast<int>(err);
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
