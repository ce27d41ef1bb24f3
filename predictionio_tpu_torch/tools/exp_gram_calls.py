"""K1 and K2 on the calls of one ALS iteration at the MovieLens-25M shape,
and the shared-memory read costs K1's tile layout rests on, on the card.

    python -m predictionio_tpu_torch.tools.exp_gram_calls \
        [calls] [solve] [designs] [gj] [smem] [wide]

``calls`` makes 25,000,000 ratings shaped like MovieLens-25M (the
repository's benchmark generator: uniform users, Zipf(1.25) items,
half-star ratings; seed 0), buckets them as ``models.als`` does at rank
64, runs one iteration on the card with K1's calls recorded, and times
each call: K1 (``fused_gram_vector_cuda``) against ``torch.bmm(fwᵀ, f)``
on the pre-gathered block, the yardstick ``chip_smoke.py`` uses (the
gather is not timed).  One row per call (R, L and both times, median of
three single calls between CUDA events), then the sums.

``solve`` records the K2 calls of the same iteration (one per bucket
chunk, users then items) and times each under K2 (``ridge_solve_cuda``
"lu": the Cholesky kernels with the system in registers), the
shared-memory LU kernel ("lu_shared"), and ``torch.linalg.cholesky`` +
``torch.cholesky_solve`` on ``A + diag(reg)`` (the yardstick; building
``A + diag(reg)`` is not timed), beside the call's bound: the larger of
its bytes over 3.35 TB/s and its flops over 67 TFLOP/s, as
``ridge_solve.solve_cost`` counts them (A's lower triangle by 32-byte
sectors, b and reg read, x written; the Cholesky flops).  It prints the
dead rows of the chunks first (rows of padding, index -1, that K1 and K2
still compute), then one row per call, then the sums by kind of bucket
and in all.

``designs`` times K2's register designs against each other at small
ranks: 131,072 systems at each rank of ``DESIGN_RANKS``, then the
recorded K2 calls of one rank-10 iteration at the same ML-25M shape
(the rank every shipped ``engine.json`` trains at), each under K2 by
rank (one thread a system, padded to the next of 4, 8, 12, 16), one
thread a system padded to 16 (``"chol_thread16"``) and one warp a
system (``"chol_warp"``), beside the bound.

``gj`` times K4's designs against each other.  The package's source
has one design a rank; each entry of ``GJ_VARIANTS`` is a copy of
``csrc/ridge_solve.cu`` in the build directory with a few constants or
lines edited so that it launches another design (one thread a system at
KP 12 for every rank to 12; one warp a system from rank 1; the warp
design with its column loops stopped at a rank K below KP; the
shared-memory kernel, K4's first design, at every rank).  Each copy and the package's
source are built by their own ``nvcc``, all started together, and timed
on 131,072 systems at each rank of ``GJ_RANKS`` and on the recorded
calls of one ML-25M iteration at rank 64 and at rank 10
(``solver="gj"`` makes the same calls as K2), beside the bound
(``ridge_solve.solve_cost``, all of A).  Each variant's answers are held
against the package's build.

``wide`` times K1 above rank 128 (``band_gram_kernel``) at the shapes
of ``WIDE_SHAPES`` against ``torch.bmm(fwᵀ, f)`` on the pre-gathered
block and the bound (``gram_bound_ms``), beside the variants of
``WIDE_VARIANTS``: edited copies of ``csrc/fused_gram.cu`` (the slot
loop not unrolled; 16 slots a step at every KP; and two diagnostics,
wrong by design and not checked: the epilogue without its A stores, and
no epilogue), built with ``edited_libraries``.  Each other variant's A
and b must equal the package's build bit for bit (none changes an
entry's sum order).

``smem`` builds a small CUDA kernel with nvcc that streams 16-byte
shared-memory reads (``LDS.128``, 64 warps an SM) in eight address
patterns and prints each pattern's cost in SM cycles per warp-wide read,
at the maximum SM clock ``nvidia-smi`` reports.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import ridge_solve as rs
from predictionio_tpu_torch.ops.ragged import LEN_ALIGN
from predictionio_tpu_torch.tools import (edited_libraries, require_cuda,
                                          single_ms)

USERS, ITEMS, RATINGS = 162_541, 59_047, 25_000_000
RANK = 64
SECTIONS = ("calls", "solve", "designs", "gj", "smem", "wide")
DESIGN_RANKS = (2, 4, 8, 10, 12, 16)
GJ_RANKS = (2, 4, 8, 10, 12, 13, 16, 17, 24, 32, 33, 40, 48, 56, 64)
# K4's variants: edits (old text -> new) of a copy of csrc/ridge_solve.cu
GJ_VARIANTS = {
    "k4": {},
    "thread12": {"gj_thread_kernel<4>": "gj_thread_kernel<12>",
                 "gj_thread_kernel<8>": "gj_thread_kernel<12>"},
    "warp": {"kGJThreadMaxK = 12;": "kGJThreadMaxK = 0;"},
    # the warp design's column loops stopped at K (tried; ptxas spills)
    "column_bound": {"for (int c = c0; c < KP; c += 4) {":
                     "for (int c = c0; c < KP; c += 4) { if (c >= K) break;"},
    "shared": {"kGJThreadMaxK = 12;": "kGJThreadMaxK = 0;",
               "kGJRegMaxK = 64;": "kGJRegMaxK = 0;"},
}
# K1 above rank 128: (R, L, K, N factor rows); chip_smoke.py's timed
# shapes and phase 28b's largest rank-256 bucket
WIDE_SHAPES = ((4096, 64, 256, 50_000), (9136, 32, 256, 5000),
               (4096, 64, 136, 50_000), (4096, 64, 192, 50_000),
               (512, 1000, 256, 50_000), (8, 4096, 256, 50_000),
               (4096, 64, 248, 50_000), (512, 1000, 248, 50_000))
_SLOT_LOOP = "#pragma unroll 2\n      for (int s = 0; s < kSlots; ++s) {"
WIDE_VARIANTS = {
    "unroll1": {_SLOT_LOOP: _SLOT_LOOP.replace("unroll 2", "unroll 1")},
    "slots16": {"return kp <= 160 ? 16 : 32;": "return 16;"},
    # diagnostics, wrong by design: A staged but not written out; no
    # epilogue at all
    "diag_nostore": {"for (int f = first; f < e1; f += blockDim.x) {":
                     "for (int f = first; f < 0; f += blockDim.x) {"},
    "diag_noepi": {"    if (WITH_B && static_cast<int>(threadIdx.x) < K)\n":
                   "    if (acc[0][0] != 12345.f) continue;\n"
                   "    if (WITH_B && static_cast<int>(threadIdx.x) < K)\n"},
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores

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


def ml25m_ratings(seed: int = 0):
    """The repository's MovieLens-25M-shaped generator, copied from
    ``bench.py`` ``synth_ml25m`` (bench.py imports JAX): uniform users,
    Zipf(1.25) items, ratings 0.5..5.  ``chip_smoke.py`` trains on it."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, USERS, RATINGS)
    items = (rng.zipf(1.25, size=RATINGS) % ITEMS).astype(np.int64)
    ratings = (rng.integers(1, 11, RATINGS) * 0.5).astype(np.float32)
    return users, items, ratings


def ml25m_inputs(dev: torch.device, seed: int = 0, rank: int = RANK):
    """(config, uploaded inputs) of the ML-25M training run (rank 64
    unless asked)."""
    users, items, ratings = ml25m_ratings(seed)
    cfg = als.ALSConfig(rank=rank, iterations=1, reg=0.01, solver="auto",
                        seed=seed)
    return cfg, als.prepare_als_inputs(users, items, ratings, USERS, ITEMS,
                                       cfg, device=dev)


def bucket_kinds(inputs) -> List[str]:
    """The kind of bucket of each chunk, in the sweep's order (users, then
    items): one K1 call and one K2 call each."""
    return (["user"] * len(inputs.user_buckets)
            + [f"{c.kind} item" for c in inputs.item_buckets])


def recorded_calls(cfg, inputs):
    """The K1 calls (factors, indices, w, c) and the K2 calls (a, b, reg)
    of one iteration over ``inputs``, and the kind of bucket of each
    chunk."""
    gram, solve = [], []
    routes = fg.fused_gram_vector, rs.ridge_solve_lu

    def recording(calls, route):
        def call(*args):
            calls.append(tuple(t.clone() for t in args))
            return route(*args)
        return call

    fg.fused_gram_vector = recording(gram, routes[0])
    rs.ridge_solve_lu = recording(solve, routes[1])
    try:
        als.train_als_prepared(inputs, cfg)
    finally:
        fg.fused_gram_vector, rs.ridge_solve_lu = routes
    if inputs.uf0.device.type == "cuda":
        torch.cuda.synchronize()
    return gram, solve, bucket_kinds(inputs)


def dead_rows(chunks, rank: int, max_block_floats: int,
              pad_rows: int = LEN_ALIGN) -> dict:
    """Rows of padding (id -1) in uploaded chunks, which K1 and K2 still
    compute: K1's gathered slots in them and K2's systems, now and as
    they were when a bucket's last row chunk was padded up to the full
    chunk (``rows_max``).  Only plain buckets changed: a split bucket's
    chunks were already cut to a multiple of ``pad_rows``."""
    out = {"k1_slots": 0, "k1_dead_slots": 0, "k2_rows": 0,
           "k2_dead_rows": 0}
    by_len = {}
    for c in chunks:
        r, l = c.indices.shape
        solved = c.n_seg if c.kind == "merged" else r
        live = len(c.keep)
        dead_k1 = (int((c.seg_ids == c.n_seg).sum()) if c.kind == "merged"
                   else r - live)
        out["k1_slots"] += r * l
        out["k1_dead_slots"] += dead_k1 * l
        out["k2_rows"] += solved
        out["k2_dead_rows"] += solved - live
        if c.kind == "plain":
            by_len.setdefault(l, []).append(r)
    extra_rows = extra_slots = 0
    for l, rows in by_len.items():
        rows_max = max(pad_rows, (max_block_floats // max(l * rank, 1))
                       // pad_rows * pad_rows)
        if len(rows) > 1:
            extra_rows += rows_max - rows[-1]
            extra_slots += (rows_max - rows[-1]) * l
    out["k1_dead_slots_untrimmed"] = out["k1_dead_slots"] + extra_slots
    out["k2_dead_rows_untrimmed"] = out["k2_dead_rows"] + extra_rows
    out["k1_slots_untrimmed"] = out["k1_slots"] + extra_slots
    out["k2_rows_untrimmed"] = out["k2_rows"] + extra_rows
    return out


def solve_bound_ms(n: int, k: int) -> float:
    """Least time for K2 on n rank-k systems: its bytes over the memory
    rate or its flops over the float32 peak (``ridge_solve.solve_cost``),
    whichever is larger."""
    n_bytes, flops = rs.solve_cost(n, k, "lu")
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def time_calls(dev: torch.device) -> None:
    calls, _, _ = recorded_calls(*ml25m_inputs(dev))
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


SOLVE_COLUMNS = ("k2", "lu_shared", "cholesky", "bound")


def time_solves(dev: torch.device) -> None:
    cfg, inputs = ml25m_inputs(dev)
    print("dead rows: " + json.dumps(dead_rows(
        inputs.user_buckets + inputs.item_buckets, RANK,
        cfg.max_block_floats)))
    _, calls, kinds = recorded_calls(cfg, inputs)
    del inputs
    sums = {}
    for (a, b, reg), kind in zip(calls, kinds):
        n, k = b.shape
        a_reg = a + torch.diag_embed(reg[:, None].expand(-1, k))
        row = {"k2": single_ms(lambda: rs.ridge_solve_cuda(a, b, reg, "lu")),
               "lu_shared": single_ms(
                   lambda: rs.ridge_solve_cuda(a, b, reg, "lu_shared")),
               "cholesky": single_ms(lambda: torch.cholesky_solve(
                   b[..., None], torch.linalg.cholesky(a_reg))),
               "bound": solve_bound_ms(n, k)}
        del a_reg
        for key in (kind, "all"):
            acc = sums.setdefault(key, dict.fromkeys(SOLVE_COLUMNS, 0.0))
            acc["calls"] = acc.get("calls", 0) + 1
            for col in SOLVE_COLUMNS:
                acc[col] += row[col]
        print(f"{kind:11s} B {n:7d}  " + "  ".join(
            f"{col} {row[col]:.4f} ms" for col in SOLVE_COLUMNS))
    for key, acc in sums.items():
        print(f"sum over {acc['calls']} {key} calls: " + ", ".join(
            f"{col} {acc[col]:.3f} ms" for col in SOLVE_COLUMNS))


DESIGN_COLUMNS = ("lu", "chol_thread16", "chol_warp", "bound")


def time_designs(dev: torch.device) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)

    def row(a, b, reg):
        out = {m: single_ms(lambda: rs.ridge_solve_cuda(a, b, reg, m))
               for m in DESIGN_COLUMNS[:-1]}
        out["bound"] = solve_bound_ms(*b.shape)
        return out

    n = 131_072
    for k in DESIGN_RANKS:
        m = torch.randn((n, k, 16), generator=gen, device=dev)
        a = (m @ m.mT) / 16
        b = torch.randn((n, k), generator=gen, device=dev)
        reg = torch.full((n,), 0.5, device=dev)
        times = row(a, b, reg)
        del m, a, b, reg
        print(f"B {n} K {k:2d}  " + "  ".join(
            f"{col} {times[col]:.5f} ms" for col in DESIGN_COLUMNS))
    _, calls, _ = recorded_calls(*ml25m_inputs(dev, rank=10))
    total = dict.fromkeys(DESIGN_COLUMNS, 0.0)
    for a, b, reg in calls:
        for col, ms in row(a, b, reg).items():
            total[col] += ms
    print(f"{len(calls)} K2 calls of a rank-10 ML-25M iteration: " + ", ".join(
        f"{col} {total[col]:.4f} ms" for col in DESIGN_COLUMNS))


def gj_variants() -> dict:
    """The K4 variants' libraries by name: each an edited copy of
    ``csrc/ridge_solve.cu`` in the build directory, one ``nvcc`` each,
    all started together."""
    libs = edited_libraries("ridge_solve", GJ_VARIANTS, report="gj_")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.pio_ridge_solve.argtypes = [i, p, p, p, i, i, p, p,
                                        ctypes.POINTER(i)]
        lib.pio_ridge_solve.restype = ctypes.c_int
    return libs


def gj_solve(lib, a, b, reg) -> torch.Tensor:
    """K4 (method 1) of one variant's library on PyTorch's stream."""
    n, k = b.shape
    x = torch.empty((n, k), dtype=torch.float32, device=a.device)
    kernel = ctypes.c_int(0)
    rc = lib.pio_ridge_solve(1, a.data_ptr(), b.data_ptr(), reg.data_ptr(),
                             n, k, x.data_ptr(),
                             torch.cuda.current_stream().cuda_stream,
                             ctypes.byref(kernel))
    if rc != 0:
        raise RuntimeError(f"K4 variant launch failed (code {rc}, B={n}, "
                           f"K={k})")
    return x


def gj_bound_ms(n: int, k: int) -> float:
    n_bytes, flops = rs.solve_cost(n, k, "gj")
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def time_gj(dev: torch.device) -> None:
    libs = gj_variants()
    gen = torch.Generator(device=dev).manual_seed(0)

    def row(a, b, reg):
        want = gj_solve(libs["k4"], a, b, reg)
        out = {}
        for name, lib in libs.items():
            x = gj_solve(lib, a, b, reg)
            err = float((x - want).abs().max())
            if not err <= 1e-3 * float(want.abs().max()):
                raise RuntimeError(f"K4 variant {name} differs from the "
                                   f"package's build by {err}")
            out[name] = single_ms(lambda: gj_solve(lib, a, b, reg))
        out["bound"] = gj_bound_ms(*b.shape)
        return out

    n = 131_072
    for k in GJ_RANKS:
        m = torch.randn((n, k, 16), generator=gen, device=dev)
        a = (m @ m.mT) / 16
        b = torch.randn((n, k), generator=gen, device=dev)
        reg = torch.full((n,), 0.5, device=dev)
        times = row(a, b, reg)
        del m, a, b, reg
        print(f"gj B {n} K {k:2d}  " + "  ".join(
            f"{col} {ms:.5f} ms" for col, ms in times.items()))
    for rank in (RANK, 10):
        _, calls, _ = recorded_calls(*ml25m_inputs(dev, rank=rank))
        total = {}
        for a, b, reg in calls:
            for col, ms in row(a, b, reg).items():
                total[col] = total.get(col, 0.0) + ms
        print(f"gj {len(calls)} calls of a rank-{rank} ML-25M iteration: "
              + ", ".join(f"{col} {ms:.4f} ms" for col, ms in total.items()))
        del calls

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


def gram_bound_ms(r: int, l: int, k: int, n: int, elem: int = 4) -> float:
    """Least time for K1 on one [R, L] block against an [N, K] factor
    matrix: bytes (index, weight and value reads, one read of the
    factors, the A and b writes) over the memory rate or flops (K·(K+1)
    + 3K a slot) over the float32 peak, whichever is larger; the count
    of ``chip_smoke.gram_cost``."""
    n_bytes = r * l * 12 + n * k * elem + r * k * (k + 1) * 4
    flops = float(r * l * (k * (k + 1) + 3 * k))
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def variant_gram(lib, factors, idx, w, c):
    """K1 through one variant's library on PyTorch's stream."""
    (r, l), k = idx.shape, factors.shape[1]
    a = torch.empty((r, k, k), dtype=torch.float32, device=factors.device)
    b = torch.empty((r, k), dtype=torch.float32, device=factors.device)
    rc = lib.pio_fused_gram(factors.data_ptr(),
                            int(factors.dtype == torch.bfloat16),
                            idx.data_ptr(), w.data_ptr(), c.data_ptr(), r, l,
                            k, a.data_ptr(), b.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 variant launch failed (code {rc}, R={r}, "
                           f"L={l}, K={k})")
    return a, b


def time_wide(dev: torch.device) -> None:
    libs = edited_libraries("fused_gram", WIDE_VARIANTS, report="band_")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.pio_fused_gram.argtypes = [p, i, p, p, p, i, i, i, p, p, p]
        lib.pio_fused_gram.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)
    for r, l, k, n in WIDE_SHAPES:
        fac = torch.randn((n, k), generator=gen, device=dev)
        idx = torch.randint(0, n, (r, l), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((r, l), generator=gen, device=dev)
        c = torch.randn((r, l), generator=gen, device=dev)
        want = fg.fused_gram_vector_cuda(fac, idx, w, c)
        row = {"package": single_ms(
            lambda: fg.fused_gram_vector_cuda(fac, idx, w, c))}
        for name, lib in libs.items():
            got = variant_gram(lib, fac, idx, w, c)
            if not name.startswith("diag_") and not all(
                    torch.equal(g, x) for g, x in zip(got, want)):
                raise RuntimeError(f"K1 variant {name} differs from the "
                                   f"package's build at R={r} L={l} K={k}")
            row[name] = single_ms(lambda: variant_gram(lib, fac, idx, w, c))
        del want
        f = fac.index_select(0, idx.reshape(-1)).reshape(r, l, k)
        fw = f * w[..., None]
        row["bmm"] = single_ms(lambda: torch.bmm(fw.mT, f))
        del f, fw
        row["bound"] = gram_bound_ms(r, l, k, n)
        print(f"wide R {r} L {l} K {k} N {n}  " + "  ".join(
            f"{col} {ms:.4f} ms" for col, ms in row.items()), flush=True)
        del fac, idx, w, c
        torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None) -> None:
    which = (sys.argv[1:] if argv is None else list(argv)) or list(SECTIONS)
    dev = require_cuda()
    if "calls" in which:
        time_calls(dev)
    if "solve" in which:
        time_solves(dev)
    if "designs" in which:
        time_designs(dev)
    if "gj" in which:
        time_gj(dev)
    if "smem" in which:
        time_smem(dev)
    if "wide" in which:
        time_wide(dev)


if __name__ == "__main__":
    main()
