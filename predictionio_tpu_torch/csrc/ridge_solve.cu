// Batched SPD ridge solves for Hopper (sm_90a): Cholesky and shrinking
// elimination (K2) and Gauss-Jordan (K4), one source for both.
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
// rate is the least time.
//
// K2 (method 0) is a Cholesky factorisation A + diag(reg) = L Lᵀ with the
// system in registers; it reads only the lower triangle of A (on and
// below the diagonal), so A must be symmetric.  ALS's A is: K1 writes it
// bitwise symmetric up to rank 128, and the sums after K1 (split rows,
// + YᵀY) keep it so up to float32 rounding.  Two designs by rank:
//
// - K <= 16, chol_thread_kernel: one thread per system.  A warp stages
//   its 32 systems' matrices through shared memory in one coalesced
//   16-byte pass (odd per-system stride: the threads then read their own
//   matrix without bank conflicts), and each thread holds the packed
//   lower triangle of its system, padded to a compiled size KP of 4, 8,
//   12 or 16, in registers: every index is a compile-time constant.
// - 17 <= K <= 64, chol_warp_kernel: one warp per system, KP 32 or 64.
//   Lane l holds row l (columns 0..31) and, at KP 64, row l + 32 in
//   registers.  The warp reads the lower triangle once with coalesced
//   loads (16 bytes a lane when K % 4 == 0) into shared memory, and each
//   lane lifts its rows out.  At pivot j the lanes scale column j of
//   their rows, broadcast it through a 64-float shared vector (every
//   lane reads it with broadcast LDS.128), and update their rows'
//   trailing entries with FMAs on registers: one shared-memory read per
//   four FMAs, not three accesses per FMA.  The forward solve L y = b
//   rides along; the back solve Lᵀ x = y reads L back from shared
//   memory by rows.  A system's time is then the latency of its 64
//   pivot chains (shuffles, square root and division, the broadcast),
//   hidden by 12 warps an SM.  Tried and dropped (ptxas spilled, or no
//   gain): rsqrt in place of 1/sqrt, and updating by column j only
//   after pivot j + 1 has started.
//
// A runtime rank K below KP is padded with an identity block and a zero
// right-hand side, which never touches the first K unknowns.  Ranks 65
// to 128 keep the shared-memory kernel below, ridge_kernel<kLU>: one warp per
// system, the augmented matrix in shared memory, three shared-memory
// accesses per FMA.  Methods 2-4 force one K2 design whatever the rank
// (the shared-memory LU; the warp design; one thread a system at KP 16),
// only so that the tools can time the designs on the same calls; the
// entry reports which kernel it launched, in the codes of enum Method.
//
// K4 (method 1) is Gauss-Jordan: it reads all of A and assumes no
// symmetry, as the TPU kernel solves A as it is given.  Its cost is the
// same as K2's was: every FMA of the shared-memory kernel takes three
// shared-memory accesses.  So it keeps the augmented rows
// [A + diag(reg) | b] in registers, in the style of K2, with two designs
// by rank:
//
// - K <= 12, gj_thread_kernel: one thread per system, the K x (K + 1)
//   system padded to KP 4, 8 or 12 (GJ needs all of it, not a packed
//   triangle: 156 floats at KP 12, and KP 16's 272 do not fit), staged
//   as K2's one-thread kernel stages it.  The arithmetic of the plain
//   version: pivot row normalised, column j eliminated from every other
//   row.
// - 12 < K <= 64, gj_warp_kernel: one warp per system, KP 32 or 64.  Lane
//   l owns rows l and (KP 64) l + 32, all their columns and their
//   right-hand sides, so each lane already holds its multipliers A_ij.
//   At pivot j only row j crosses lanes: its owner writes it, as it
//   stands, to a shared vector, and every lane reads it back with
//   broadcast LDS.128, one shared read per four FMAs a row.  A lane's
//   multiplier is A_ij / A_jj; row j itself is left as it stands and
//   keeps its pivot as a factor until x_j = y_j / A_jj at the end, so
//   that no lane scales a row alone while the others wait.  Columns at
//   or left of the pivot are dead in the unrolled code, so a row's live
//   set shrinks from KP + 1 to KP - j.
//
// Ranks 65-128 run ridge_kernel<kGJ>, the shared-memory kernel.
//
// The shared-memory kernel.  One warp per system, several warps per block.  The
// Pallas kernels put 128 systems on the TPU's vector lanes; on Hopper a
// warp's 32 lanes share one system instead.  The warp stages the
// augmented K x (K+1) matrix [A + diag(reg) | b] in shared memory with an
// odd row stride (no bank conflicts when lanes walk a column), then for
// each pivot j the lanes take the columns right of j, one each (and
// every 32nd after), and update them down the rows; the pivot's column
// is not written during its step, so a __syncwarp between steps is the
// only barrier.  Back substitution runs the lanes down the rows of the
// right-hand side.
//
// Plain C interface, built with nvcc and loaded with ctypes; the wrapper
// (predictionio_tpu_torch/ops/ridge_solve.py) checks shapes and types,
// allocates x, and passes PyTorch's current stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 128;
constexpr int kMaxWarps = 8;
constexpr size_t kBlockSmem = 64 * 1024;  // shared memory a block aims at

// Method codes of pio_ridge_solve (0-4); the kernel launched is reported
// in codes 2-7 (kLU resolves to one of 2-4 by rank, kGJ to one of 5-7).
enum Method {
  kLU = 0, kGJ = 1, kLUShared = 2, kCholWarp = 3, kCholThread = 4,
  kGJShared = 5, kGJWarp = 6, kGJThread = 7
};

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

// ---- K2 on Hopper: Cholesky with the system in registers ----------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadMaxK = 16;   // one thread per system up to this rank
constexpr int kRegMaxK = 64;      // one warp per system up to this rank
constexpr int kRegWarps = 4;      // systems (warps) a block, warp design
// Blocks an SM for the warp design: its shared memory (18 KB a warp at
// KP 64) allows 3, and the 168-register cap that implies is what the
// kernel needs without spills.
constexpr int kRegBlocksPerSM = 3;

// Index of entry (i, j), j <= i, of a packed lower triangle.
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// Stage a tile of n systems' matrices, n * K * K contiguous floats from
// a, into shared memory at a per-system stride P (odd: thread t then
// reads its own matrix from bank (t*P + e) % 32, without conflicts).
// Element e of the tile goes to system e / kk (a float quotient,
// corrected by one either way).  One warp; vec4: a is 16-byte aligned.
__device__ __forceinline__ void stage_tile(const float* __restrict__ a,
                                           int n, int kk, int P, int vec4,
                                           int lane, float* smem) {
  const int total = n * kk;
  const float inv_kk = 1.f / static_cast<float>(kk);
  auto put = [&](int e, float v) {
    int t = __float2int_rz(static_cast<float>(e) * inv_kk);
    int off = e - t * kk;
    if (off < 0) {
      --t;
      off += kk;
    } else if (off >= kk) {
      ++t;
      off -= kk;
    }
    smem[t * P + off] = v;
  };
  int e0 = 0;
  if (vec4) {  // every tile starts on 16 bytes
    const float4* a4 = reinterpret_cast<const float4*>(a);
    for (int q = lane; q < total / 4; q += kWarp) {
      const float4 v = __ldg(a4 + q);
      put(4 * q, v.x);
      put(4 * q + 1, v.y);
      put(4 * q + 2, v.z);
      put(4 * q + 3, v.w);
    }
    e0 = total / 4 * 4;
  }
  for (int e = e0 + lane; e < total; e += kWarp) put(e, __ldg(a + e));
}

// One thread per system, rank K <= KP <= 16.
template <int KP>
__global__ void __launch_bounds__(kWarp)
    chol_thread_kernel(const float* __restrict__ A,
                       const float* __restrict__ b,
                       const float* __restrict__ reg, int B, int K,
                       int vec4, float* __restrict__ x) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.x) * kWarp;
  const int n = static_cast<int>(
      s0 + kWarp <= B ? kWarp : B - s0);  // systems of this tile
  const int kk = K * K;
  const int P = kk | 1;  // odd stride: thread t reads bank (t*P + e) % 32
  stage_tile(A + s0 * kk, n, kk, P, vec4, lane, smem);
  __syncwarp();
  if (lane >= n) return;

  const long long s = s0 + lane;
  const float* m = smem + lane * P;
  const float r = reg[s];
  float L[tri(KP, 0)];
  float y[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    y[i] = i < K ? b[s * K + i] : 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = i == j ? 1.f : 0.f;  // identity padding past K
      if (i < K) v = i == j ? m[i * K + j] + r : m[i * K + j];
      L[tri(i, j)] = v;
    }
  }
  // L Lᵀ = A + diag(reg) in place, with L y = b alongside.
  float dinv[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    const float inv = 1.f / sqrtf(L[tri(j, j)]);
    dinv[j] = inv;
    y[j] *= inv;
#pragma unroll
    for (int i = j + 1; i < KP; ++i) {
      L[tri(i, j)] *= inv;
      y[i] = fmaf(-L[tri(i, j)], y[j], y[i]);
    }
#pragma unroll
    for (int i = j + 1; i < KP; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k)
        L[tri(i, k)] = fmaf(-L[tri(i, j)], L[tri(k, j)], L[tri(i, k)]);
  }
  // Lᵀ x = y.
#pragma unroll
  for (int j = KP - 1; j >= 0; --j) {
    y[j] *= dinv[j];
#pragma unroll
    for (int i = 0; i < j; ++i) y[i] = fmaf(-L[tri(j, i)], y[j], y[i]);
  }
#pragma unroll
  for (int i = 0; i < KP; ++i)
    if (i < K) x[s * K + i] = y[i];
}

// Row i of A + diag(reg), columns 0..N-1, from the staged rows M (stride
// S) into registers; identity past K.  LOWER: only the lower triangle
// was staged, and entries right of the diagonal are 0.
template <int N, int S, bool LOWER>
__device__ __forceinline__ void lift_row(const float* M, int i, int K,
                                         float rg, float (&r)[N]) {
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < K && (LOWER ? c <= i : c < K))
      v = *reinterpret_cast<const float4*>(M + i * S + c);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = c + q;
      float out = k == i ? 1.f : 0.f;
      if (i < K)
        out = k == i ? e[q] + rg : ((LOWER ? k < i : k < K) ? e[q] : 0.f);
      r[k] = out;
    }
  }
}

// One warp per system, 16 < K <= KP, KP 32 or 64: lane l owns row l
// (r0, columns 0..31) and, at KP 64, row l + 32 (r1, columns 0..63).
// Entries right of a row's diagonal hold scratch and are never read.
template <int KP>
__global__ void __launch_bounds__(kRegWarps * kWarp, kRegBlocksPerSM)
    chol_warp_kernel(const float* __restrict__ A,
                     const float* __restrict__ b,
                     const float* __restrict__ reg, int B, int K, int vec4,
                     float* __restrict__ x) {
  constexpr int R = KP / kWarp;        // rows a lane owns
  constexpr int S = KP + 4;            // staged row stride: LDS.128 by
                                       // rows is conflict-free
  constexpr int CB = KP + 4;           // one broadcast column
  constexpr int WS = KP * S + 2 * CB;  // floats a warp uses
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long s =
      static_cast<long long>(blockIdx.x) * kRegWarps + warp;
  if (s >= B) return;  // no block-wide barrier follows
  float* M = reinterpret_cast<float*>(smem4) + warp * WS;
  float* col = M + KP * S;

  // Stage the lower triangle of A[s], rows 0..K-1, read once.
  const float* a = A + s * K * K;
  if (vec4) {  // K % 4 == 0, A 16-byte aligned: a row's quads on lanes
    constexpr int LPR = KP / 4;        // lanes a row
    constexpr int RPP = kWarp / LPR;   // rows a pass
    const int c = lane % LPR;
#pragma unroll
    for (int i0 = 0; i0 < KP; i0 += RPP) {
      const int i = i0 + lane / LPR;
      if (i < K && 4 * c <= i)
        *reinterpret_cast<float4*>(M + i * S + 4 * c) =
            __ldg(reinterpret_cast<const float4*>(a + i * K) + c);
    }
  } else {
#pragma unroll
    for (int i = 0; i < KP; ++i)
#pragma unroll
      for (int j0 = 0; j0 < i + 1; j0 += kWarp) {
        const int j = j0 + lane;
        if (i < K && j <= i) M[i * S + j] = __ldg(a + i * K + j);
      }
  }
  __syncwarp();

  const float rg = reg[s];
  const int i1 = lane + kWarp;  // the second row, at KP 64
  float r0[kWarp];
  float r1[R == 2 ? KP : 1];
  lift_row<kWarp, S, true>(M, lane, K, rg, r0);
  if constexpr (R == 2) lift_row<KP, S, true>(M, i1, K, rg, r1);
  float y0 = lane < K ? b[s * K + lane] : 0.f;
  float y1 = R == 2 && i1 < K ? b[s * K + i1] : 0.f;
  float inv0 = 0.f, inv1 = 0.f;

  // L Lᵀ = A + diag(reg), with L y = b alongside, one pivot a step.
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    const int j0 = j % kWarp;            // in range of r0
    const int j1 = R == 2 ? j : 0;       // in range of r1 (size 1 at KP 32)
    const bool first = j < kWarp;        // row j is r0 of lane j, else
                                         // r1 of lane j - 32
    float* buf = col + (j & 1) * CB;     // column j (two buffers: one
                                         // __syncwarp a pivot suffices)
    const float d = __shfl_sync(kFull, first ? r0[j0] : r1[j1], j0);
    const float bj = __shfl_sync(kFull, first ? y0 : y1, j0);
    const float inv = 1.f / sqrtf(d);   // 1 / L_jj
    const float yj = bj * inv;
    // Scale column j of this lane's rows (all of it: a row at or above
    // the pivot holds scratch there), then y -= L_ij y_j below the pivot;
    // selects, not branches.
    if (first) {
      r0[j0] *= inv;
      y0 = lane > j ? fmaf(-r0[j0], yj, y0) : (lane == j ? yj : y0);
      inv0 = lane == j ? inv : inv0;
      buf[lane] = r0[j0];
    }
    if constexpr (R == 2) {
      r1[j1] *= inv;
      y1 = i1 > j ? fmaf(-r1[j1], yj, y1) : (i1 == j ? yj : y1);
      inv1 = i1 == j ? inv : inv1;
      buf[i1] = r1[j1];
    }
    __syncwarp();
    // The columns right of j, by column j from the buffer, four at a time.
#pragma unroll
    for (int c = (j + 1) / 4 * 4; c < KP; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(buf + c);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = c + q;
        if (k <= j) continue;
        if (k < kWarp) r0[k % kWarp] = fmaf(-r0[j0], e[q], r0[k % kWarp]);
        if constexpr (R == 2) r1[k] = fmaf(-r1[j1], e[q], r1[k]);
      }
    }
  }

  // Lᵀ x = y: L back to shared memory by rows (the staged rows are no
  // longer read), then x_j from its owner, one pivot at a time.
#pragma unroll
  for (int c = 0; c < kWarp; c += 4)
    *reinterpret_cast<float4*>(M + lane * S + c) =
        make_float4(r0[c], r0[c + 1], r0[c + 2], r0[c + 3]);
  if constexpr (R == 2) {
#pragma unroll
    for (int c = 0; c < KP; c += 4)
      *reinterpret_cast<float4*>(M + i1 * S + c) =
          make_float4(r1[c], r1[c + 1], r1[c + 2], r1[c + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int j = KP - 1; j >= 0; --j) {
    const bool first = j < kWarp;
    const float xj = __shfl_sync(
        kFull, first ? y0 * inv0 : y1 * inv1, j % kWarp);
    // Row j of L at and right of its diagonal is scratch: selected away.
    const float t0 = fmaf(-M[j * S + lane], xj, y0);
    y0 = lane < j ? t0 : (lane == j ? xj : y0);
    if constexpr (R == 2) {
      const float t1 = fmaf(-M[j * S + i1], xj, y1);
      y1 = i1 < j ? t1 : (i1 == j ? xj : y1);
    }
  }
  if (lane < K) x[s * K + lane] = y0;
  if (R == 2 && i1 < K) x[s * K + i1] = y1;
}

// ---- K4 on Hopper: Gauss-Jordan with the system in registers ------------

// Ranks K4 takes in registers: one thread a system up to kGJThreadMaxK
// (KP 4, 8, 12), one warp a system up to kGJRegMaxK (KP 32, 64), the
// shared-memory kernel above.
constexpr int kGJThreadMaxK = 12;
constexpr int kGJRegMaxK = 64;
static_assert(kGJRegMaxK <= kRegMaxK, "K4's warp design stops at rank 64");

// One thread per system, rank K <= KP <= 12: the augmented matrix
// [A + diag(reg) | b], KP x (KP + 1) floats, in registers, every index a
// compile-time constant.  The arithmetic of the plain version: the pivot
// row normalised, then column j eliminated from every other row.
template <int KP>
__global__ void __launch_bounds__(kWarp)
    gj_thread_kernel(const float* __restrict__ A,
                     const float* __restrict__ b,
                     const float* __restrict__ reg, int B, int K, int vec4,
                     float* __restrict__ x) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.x) * kWarp;
  const int n = static_cast<int>(s0 + kWarp <= B ? kWarp : B - s0);
  const int kk = K * K;
  const int P = kk | 1;
  stage_tile(A + s0 * kk, n, kk, P, vec4, lane, smem);
  __syncwarp();
  if (lane >= n) return;

  const long long s = s0 + lane;
  const float* m = smem + lane * P;
  const float r = reg[s];
  float M[KP][KP + 1];  // column KP: the right-hand side
#pragma unroll
  for (int i = 0; i < KP; ++i) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      float v = i == j ? 1.f : 0.f;  // identity padding past K
      if (i < K && j < K) v = i == j ? m[i * K + j] + r : m[i * K + j];
      M[i][j] = v;
    }
    M[i][KP] = i < K ? b[s * K + i] : 0.f;
  }
  // Columns at or left of the pivot are never read again.
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < K) {  // a pivot of the identity padding changes nothing
      const float inv = 1.f / M[j][j];
#pragma unroll
      for (int c = j + 1; c <= KP; ++c) M[j][c] *= inv;
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        if (i == j) continue;
        const float f = M[i][j];
#pragma unroll
        for (int c = j + 1; c <= KP; ++c)
          M[i][c] = fmaf(-f, M[j][c], M[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KP; ++i)
    if (i < K) x[s * K + i] = M[i][KP];
}

// One warp per system, 12 < K <= KP, KP 32 or 64: lane l owns row l (r0)
// and, at KP 64, row l + 32 (r1), each with all KP columns, and their
// right-hand sides (y0, y1).  At pivot j the lane that owns row j
// publishes it, as it stands, to a shared vector; every lane reads it
// back with broadcast LDS.128 (one read per four FMAs a row) and
// eliminates column j from its rows with its own multipliers
// A_ij / A_jj, already in its registers.  Row j itself is left as it
// stands: it keeps its pivot as a factor, and x_j = y_j / A_jj at the
// end.  The same elimination as the plain version, with the pivot row's
// scaling moved to the end, so that no lane works alone on it.
template <int KP>
__global__ void __launch_bounds__(kRegWarps * kWarp,
                                  KP == 64 ? kRegBlocksPerSM : 8)
    gj_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
                   const float* __restrict__ reg, int B, int K, int vec4,
                   float* __restrict__ x) {
  constexpr int R = KP / kWarp;        // rows a lane owns
  constexpr int S = KP + 4;            // staged row stride
  constexpr int CB = KP + 4;           // a pivot row: KP columns, then b
  constexpr int WS = KP * S + 2 * CB;  // floats a warp uses
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long s =
      static_cast<long long>(blockIdx.x) * kRegWarps + warp;
  if (s >= B) return;  // no block-wide barrier follows
  float* M = reinterpret_cast<float*>(smem4) + warp * WS;
  float* piv = M + KP * S;

  // Stage all of A[s], read once.
  const float* a = A + s * K * K;
  if (vec4) {  // K % 4 == 0, A 16-byte aligned: a row's quads on lanes
    constexpr int LPR = KP / 4;        // lanes a row
    constexpr int RPP = kWarp / LPR;   // rows a pass
    const int c = lane % LPR;
#pragma unroll
    for (int i0 = 0; i0 < KP; i0 += RPP) {
      const int i = i0 + lane / LPR;
      if (i < K && 4 * c < K)
        *reinterpret_cast<float4*>(M + i * S + 4 * c) =
            __ldg(reinterpret_cast<const float4*>(a + i * K) + c);
    }
  } else {  // element e of A[s] to row e / K (a float quotient,
            // corrected by one either way), eight loads a lane in flight
    const int kk = K * K;
    const float inv_k = 1.f / static_cast<float>(K);
    for (int e0 = lane; e0 < kk; e0 += 8 * kWarp) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kWarp;
        v[u] = e < kk ? __ldg(a + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kWarp;
        if (e >= kk) break;
        int i = __float2int_rz(static_cast<float>(e) * inv_k);
        int j = e - i * K;
        if (j < 0) {
          --i;
          j += K;
        } else if (j >= K) {
          ++i;
          j -= K;
        }
        M[i * S + j] = v[u];
      }
    }
  }
  __syncwarp();

  const float rg = reg[s];
  const int i1 = lane + kWarp;  // the second row, at KP 64
  float r0[KP];
  float r1[R == 2 ? KP : 1];
  lift_row<KP, S, false>(M, lane, K, rg, r0);
  if constexpr (R == 2) lift_row<KP, S, false>(M, i1, K, rg, r1);
  float y0 = lane < K ? b[s * K + lane] : 0.f;
  float y1 = R == 2 && i1 < K ? b[s * K + i1] : 0.f;
  float inv0 = 1.f, inv1 = 1.f;

#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < K) {  // uniform: a pivot of the identity padding is a no-op
      const int o = j % kWarp;           // the lane that owns row j
      const bool first = j < kWarp;      // row j is its r0, else its r1
      const int j1 = R == 2 ? j : 0;     // in range of r1
      float* buf = piv + (j & 1) * CB;   // two buffers: one __syncwarp a
                                         // pivot suffices
      const int c0 = (j + 1) / 4 * 4;
      if (lane == o) {
#pragma unroll
        for (int c = c0; c < KP; c += 4) {
          float e[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = c + q;
            const int k1 = R == 2 ? k : 0;
            e[q] = k <= j ? 0.f : (first ? r0[k] : r1[k1]);
          }
          *reinterpret_cast<float4*>(buf + c) =
              make_float4(e[0], e[1], e[2], e[3]);
        }
        buf[KP] = first ? y0 : y1;
      }
      const float p = __shfl_sync(kFull, first ? r0[j] : r1[j1], o);
      __syncwarp();
      const float inv = 1.f / p;
      // Multipliers; the owner's row j takes 0 and keeps its pivot.
      float f0 = r0[j] * inv;
      float f1 = R == 2 ? r1[j1] * inv : 0.f;
      if (first) {
        f0 = lane == o ? 0.f : f0;
        inv0 = lane == o ? inv : inv0;
      } else {
        f1 = lane == o ? 0.f : f1;
        inv1 = lane == o ? inv : inv1;
      }
#pragma unroll
      for (int c = c0; c < KP; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(buf + c);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = c + q;
          if (k <= j) continue;
          r0[k] = fmaf(-f0, e[q], r0[k]);
          if constexpr (R == 2) r1[k] = fmaf(-f1, e[q], r1[k]);
        }
      }
      const float bj = buf[KP];
      y0 = fmaf(-f0, bj, y0);
      if constexpr (R == 2) y1 = fmaf(-f1, bj, y1);
    }
  }
  if (lane < K) x[s * K + lane] = y0 * inv0;
  if (R == 2 && i1 < K) x[s * K + i1] = y1 * inv1;
}

// A register kernel: (A, b, reg, B, K, vec4, x).
using RegKernel = void (*)(const float*, const float*, const float*, int, int,
                           int, float*);

// One thread a system, tiles of 32 systems staged in shared memory.
cudaError_t launch_thread(RegKernel kernel, const float* A, const float* b,
                          const float* reg, int B, int K, int vec4, float* x,
                          cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarp * ((K * K) | 1);
  const unsigned blocks = static_cast<unsigned>((B + kWarp - 1) / kWarp);
  kernel<<<blocks, kWarp, smem, st>>>(A, b, reg, B, K, vec4, x);
  return cudaGetLastError();
}

// One warp a system at compiled size KP, kRegWarps systems a block.
template <int KP>
cudaError_t launch_warp(RegKernel kernel, const float* A, const float* b,
                        const float* reg, int B, int K, float* x,
                        cudaStream_t st) {
  constexpr int S = KP + 4, CB = KP + 4;
  const size_t smem = sizeof(float) * kRegWarps * (KP * S + 2 * CB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec4 = (reinterpret_cast<uintptr_t>(A) & 15) == 0 && K % 4 == 0;
  const unsigned blocks =
      static_cast<unsigned>((B + kRegWarps - 1) / kRegWarps);
  kernel<<<blocks, kRegWarps * kWarp, smem, st>>>(A, b, reg, B, K, vec4, x);
  return cudaGetLastError();
}

// The Cholesky warp design at any K <= kRegMaxK.
cudaError_t launch_cholesky_warp(const float* A, const float* b,
                                 const float* reg, int B, int K, float* x,
                                 cudaStream_t st, int* kernel) {
  *kernel = kCholWarp;
  if (K <= 32)
    return launch_warp<32>(chol_warp_kernel<32>, A, b, reg, B, K, x, st);
  return launch_warp<64>(chol_warp_kernel<64>, A, b, reg, B, K, x, st);
}

// K2 by rank: the register designs to kRegMaxK, the shared-memory kernel
// above; `*kernel` is set to the design launched.
cudaError_t launch_cholesky(const float* A, const float* b, const float* reg,
                            int B, int K, float* x, cudaStream_t st,
                            int* kernel) {
  const bool aligned = (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  if (K <= kThreadMaxK) {
    *kernel = kCholThread;
    const RegKernel kp = K <= 4    ? chol_thread_kernel<4>
                         : K <= 8  ? chol_thread_kernel<8>
                         : K <= 12 ? chol_thread_kernel<12>
                                   : chol_thread_kernel<16>;
    return launch_thread(kp, A, b, reg, B, K, aligned, x, st);
  }
  if (K <= kRegMaxK) return launch_cholesky_warp(A, b, reg, B, K, x, st,
                                                 kernel);
  *kernel = kLUShared;
  return launch<kLU>(A, b, reg, B, K, x, st);
}

// K4 by rank: one thread a system to kGJThreadMaxK, one warp to
// kGJRegMaxK, the shared-memory kernel above.  At 131,072 systems on an
// H100 (tools/exp_gram_calls.py gj) the warp design ties the
// shared-memory kernel at rank 33, where it still runs at KP 64 (1.99 vs
// 1.98 ms), and wins at the other ranks measured, 13-32 and 40-64 (2.13
// vs 3.32 ms at rank 40).
cudaError_t launch_gauss_jordan(const float* A, const float* b,
                                const float* reg, int B, int K, float* x,
                                cudaStream_t st, int* kernel) {
  if (K <= kGJThreadMaxK) {
    *kernel = kGJThread;
    const bool aligned = (reinterpret_cast<uintptr_t>(A) & 15) == 0;
    const RegKernel kp = K <= 4   ? gj_thread_kernel<4>
                         : K <= 8 ? gj_thread_kernel<8>
                                  : gj_thread_kernel<12>;
    return launch_thread(kp, A, b, reg, B, K, aligned, x, st);
  }
  if (K <= kGJRegMaxK) {
    *kernel = kGJWarp;
    if (K <= 32)
      return launch_warp<32>(gj_warp_kernel<32>, A, b, reg, B, K, x, st);
    return launch_warp<64>(gj_warp_kernel<64>, A, b, reg, B, K, x, st);
  }
  *kernel = kGJShared;
  return launch<kGJ>(A, b, reg, B, K, x, st);
}

}  // namespace

// x [B,K] from A [B,K,K], b [B,K], reg [B] (float32, contiguous) on
// `stream`; method 0 = K2 (Cholesky in registers to rank 64, the
// shared-memory LU above; A symmetric), 1 = K4 (Gauss-Jordan in registers
// to rank 64, in shared memory above; all of A), 2-4 = one K2 design
// forced, for timing: 2 the shared-memory LU (any rank), 3 the warp
// design (K <= 64), 4 one thread a system at KP 16 (K <= 16).  `*kernel`
// gets the code (2-7) of the kernel launched.  Returns
// cudaGetLastError() after the launch (0 = launched); faults during the
// run surface at the next synchronisation.
extern "C" int pio_ridge_solve(int method, const float* A, const float* b,
                               const float* reg, int B, int K, float* x,
                               void* stream, int* kernel) {
  const int max_k = method == kCholWarp     ? kRegMaxK
                    : method == kCholThread ? kThreadMaxK
                                            : kMaxK;
  if (B < 1 || K < 1 || K > max_k || method < kLU || method > kCholThread)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  *kernel = method;
  cudaError_t err;
  if (method == kLU)
    err = launch_cholesky(A, b, reg, B, K, x, st, kernel);
  else if (method == kGJ)
    err = launch_gauss_jordan(A, b, reg, B, K, x, st, kernel);
  else if (method == kLUShared)
    err = launch<kLU>(A, b, reg, B, K, x, st);
  else if (method == kCholWarp)
    err = launch_cholesky_warp(A, b, reg, B, K, x, st, kernel);
  else
    err = launch_thread(chol_thread_kernel<16>, A, b, reg, B, K, aligned, x,
                        st);
  return static_cast<int>(err);
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
