"""K1 on the calls of one ALS iteration at the MovieLens-25M shape, and the
shared-memory read costs its tile layout rests on, on the card.

    python -m predictionio_tpu_torch.tools.exp_gram_calls [calls] [smem]

``calls`` makes 25,000,000 ratings shaped like MovieLens-25M (the
repository's benchmark generator: uniform users, Zipf(1.25) items,
half-star ratings; seed 0), buckets them as ``models.als`` does at rank
64, runs one iteration on the card with K1's calls recorded, and times
each call: K1 (``fused_gram_vector_cuda``) against ``torch.bmm(fwᵀ, f)``
on the pre-gathered block, the yardstick ``chip_smoke.py`` uses (the
gather is not timed).  One row per call (R, L and both times, median of
three single calls between CUDA events), then the sums.

``smem`` builds a small CUDA kernel with nvcc that streams 16-byte
shared-memory reads (``LDS.128``, 64 warps an SM) in eight address
patterns and prints each pattern's cost in SM cycles per warp-wide read,
at the maximum SM clock ``nvidia-smi`` reports.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.tools import require_cuda

USERS, ITEMS, RATINGS = 162_541, 59_047, 25_000_000
SECTIONS = ("calls", "smem")

SMEM_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void lds128(int pattern, int iters, float* out) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int offs[8] = {lane * 4, (lane >> 3) * 4, (lane & 7) * 4, 0,
                       (lane & 7) * 8, (lane >> 2) * 4, (lane >> 1) * 4,
                       (lane >> 4) * 4};
  const int off = offs[pattern];
  float a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(
          sm + off + u * 512 + (it & 3) * 128);
      a0 += v.x; a1 += v.y; a2 += v.z; a3 += v.w;
    }
  }
  if (a0 + a1 + a2 + a3 == 1234.5f) out[threadIdx.x] = a0;
}
extern "C" int run(int blocks, int pattern, int iters, float* out,
                   void* stream) {
  lds128<<<blocks, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      pattern, iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""
SMEM_PATTERNS = ("32 addresses, 16 bytes apart",
                 "1 address a quarter warp (4 in all)",
                 "the same 8 addresses in every quarter",
                 "1 address for the warp",
                 "8 addresses 32 bytes apart in every quarter",
                 "2 addresses a quarter",
                 "4 addresses a quarter",
                 "1 address a half warp")


def single_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """Median device ms of single calls, each between its own CUDA events,
    behind a spin kernel that hides the host's enqueue."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


def ml25m_ratings(seed: int = 0):
    """The repository's MovieLens-25M-shaped generator, copied from
    ``bench.py`` ``synth_ml25m`` (bench.py imports JAX): uniform users,
    Zipf(1.25) items, ratings 0.5..5.  ``chip_smoke.py`` trains on it."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, USERS, RATINGS)
    items = (rng.zipf(1.25, size=RATINGS) % ITEMS).astype(np.int64)
    ratings = (rng.integers(1, 11, RATINGS) * 0.5).astype(np.float32)
    return users, items, ratings


def recorded_gram_calls(dev: torch.device) -> List[tuple]:
    """(factors, indices, w, c) of every K1 call of one rank-64 iteration."""
    users, items, ratings = ml25m_ratings()
    cfg = als.ALSConfig(rank=64, iterations=1, reg=0.01, solver="auto",
                        seed=0)
    inputs = als.prepare_als_inputs(users, items, ratings, USERS, ITEMS, cfg,
                                    device=dev)
    calls, route = [], fg.fused_gram_vector

    def recording(*args):
        calls.append(tuple(t.clone() for t in args))
        return route(*args)

    fg.fused_gram_vector = recording
    try:
        als.train_als_prepared(inputs, cfg)
    finally:
        fg.fused_gram_vector = route
    torch.cuda.synchronize()
    return calls


def time_calls(dev: torch.device) -> None:
    calls = recorded_gram_calls(dev)
    total = {"kernel": 0.0, "bmm": 0.0}
    for src, idx, w, c in calls:
        (r, l), k = idx.shape, src.shape[1]
        f = src.index_select(0, idx.reshape(-1)).reshape(r, l, k).float()
        fw = f * w[..., None]
        row = {"kernel": single_ms(lambda: fg.fused_gram_vector_cuda(
                   src, idx, w, c)),
               "bmm": single_ms(lambda: torch.bmm(fw.mT, f))}
        del f, fw
        for name in total:
            total[name] += row[name]
        print(f"R {r:6d}  L {l:5d}  kernel {row['kernel']:.4f} ms  "
              f"bmm {row['bmm']:.4f} ms")
    print(f"{len(calls)} calls: kernel {total['kernel']:.3f} ms, "
          f"bmm {total['bmm']:.3f} ms")


def time_smem(dev: torch.device) -> None:
    src = _build.BUILD_DIR / "exp_smem.cu"
    lib_path = _build.BUILD_DIR / "libexp_smem.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(SMEM_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(1024, device=dev)
    iters = 4096
    rc = lib.run(2 * n_sm, 0, 1, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the shared-memory probe did not launch (code "
                           f"{rc})")
    reads_per_sm = 2 * 32 * iters * 8    # blocks an SM x warps x reads
    for pattern, what in enumerate(SMEM_PATTERNS):
        ms = single_ms(lambda: lib.run(
            2 * n_sm, pattern, iters, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), 5)
        print(f"LDS.128, {what}: {ms * 1e-3 * mhz * 1e6 / reads_per_sm:.2f} "
              f"cycles a warp-wide read ({ms:.3f} ms at {mhz:.0f} MHz)")


def main(argv: Optional[List[str]] = None) -> None:
    which = (sys.argv[1:] if argv is None else list(argv)) or list(SECTIONS)
    dev = require_cuda()
    if "calls" in which:
        time_calls(dev)
    if "smem" in which:
        time_smem(dev)


if __name__ == "__main__":
    main()
