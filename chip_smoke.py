#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (predictionio_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA Hopper card, PyTorch built for CUDA, and nvcc (on PATH
or under /usr/local/cuda/bin): the kernels are compiled from
predictionio_tpu_torch/csrc at first use into build/torch_kernels/.
Exits non-zero, printing no result, when CUDA is absent, when the port
cannot be imported, or when any phase fails.  Phases, in order:

1. device  — the card's name and power limit, and the kernel builds
   (every csrc/*.cu compiled by its own nvcc, all started together).
2. kernel  — the fused top-k kernel (K3) against its plain PyTorch
   version on the card (float32, TF32 off), then CUDA-event timings of
   kernel, plain version, one library call as a yardstick, and the least
   time the card could take (bound).
3. kernel  — the training kernels, fused gram (K1), LU solve (K2) and
   Gauss-Jordan solve (K4), against their plain versions over a grid of
   shapes, then timed as in phase 2 at representative shapes.
4. serve   — the ALS recommendation template at the MovieLens-25M shape
   (162,541 users x 59,047 items, rank 64, seeded random factors) carried
   in with wrapper_from_numpy, persisted, deployed on an EngineServer
   with PIO_RETRIEVAL_RUNG=chunked, asked 16 /queries.json over HTTP and
   one 64-user query_batch; every answer is held against the plain top-k
   on the card, and the fused top-k kernel must have launched.
5. catalog — a 4,194,304-item corpus with no rung forced: the router's
   own thresholds must pick the chunked rung; 8 queries, checked as in 4.
6. train   — ALS training at the MovieLens-25M shape (25,000,000 seeded
   ratings, rank 64, reg 0.01, 10 iterations, solver "auto"): host prep
   time, ms per iteration, ratings/s, final RMSE, and the K1/K2 launches
   of the run; one iteration from the same init with the plain versions
   must agree with the kernels' iteration; a solver="gj" iteration must
   launch K4; then each training kernel timed over the calls that the
   first iteration made (their own arguments, kept as the run made
   them) against its plain version, its library yardstick and its
   bound.
7. dase    — seeded rate/buy events in the port's in-memory event store
   → run_train with the template's engine.json at rank 64 → the
   COMPLETED instance deployed on an EngineServer → 16 /queries.json,
   each held against the plain top-k of the trained factors; K1, K2 and
   K3 must have launched.
8. kernel  — the PQ scan kernel (K5) against its plain version over a
   grid of B, S (tables), N, k and n_valid, then timed at N = 1,048,576,
   S = 17, k = 40 (B = 1 and 64) beside its plain version, a library
   yardstick (torch.topk over the decoded corpus) and its bound.
9. kernel  — the gather experiments' kernels, T1 (gather + weighted
   Gram) and T2 (gather + sum), against their plain versions at the
   tools' shape, timed likewise, then driven through the tools' own
   entry points (exp_gram, exp_gather2), which must launch them.
10. pq     — a 1,048,576-item catalog (rank 64): an IVF index
   (PIO_IVF=on) and PQ codes on top of it (the default policy: M = 16)
   built as ALSAlgorithm.train builds them, persisted, deployed; 16
   /queries.json and a 64-user query_batch under
   PIO_RETRIEVAL_RUNG=pq_flat (K5 once per request), a 64-user
   query_batch under auto routing (ivf_pq), every answer held against the
   port's host search over the same structures.
11. dase+pq — phase 7's events trained again with PIO_PQ_MIN_ITEMS=5000,
   so the template's own policy builds PQ codes; deployed; 16
   /queries.json on the device pq_flat rung, each held against the host
   PQ search of the trained factors; K1, K2 and K5 must have launched.
12. report — one JSON line of per-kernel numbers, the card's name and
   power limit, and the final status line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

RTOL = 1e-5   # float32 sums in another order than the plain matmul
ATOL = 1e-5
GRAM_RTOL = 1e-5   # K1: the same float32 products summed in another order;
GRAM_SIGMAS = 5.0  # atol: this many standard deviations of a float32 sum
                   # of L terms, 5·√L·2^-24·Σ|terms| (the kernel adds its
                   # L slots one after another)
SOLVE_RTOL = 1e-4  # K2/K4: the same float32 elimination, FMAs contracted
SOLVE_ATOL = 1e-5  # differently; atol times max |x|
# One ALS iteration, kernels vs plain versions at the full shape: float32
# Gram sums of up to 4,096 terms per partial row and segment sums by
# atomics, in another order, then solved and carried into the item side.
TRAIN_RTOL = 1e-3
TRAIN_ATOL = 1e-3
RANK = 64
ML25M_USERS, ML25M_ITEMS = 162_541, 59_047
ML25M_RATINGS = 25_000_000
TRAIN_ITERS = 10
BIG_ITEMS = 4_194_304
DASE_EVENTS, DASE_USERS, DASE_ITEMS = 300_000, 20_000, 10_000
# Phase 3 grids: K1 over R x L x K, K2/K4 over B x K; then the timed shapes.
GRAM_ROWS, GRAM_LENS, TRAIN_RANKS = (8, 4096), (8, 64, 1000, 4096), (10, 64, 128)
# K1 above rank 128, where it cuts A into 2 x 2 tiles: (R, L, K)
GRAM_TILED = ((8, 4096, 256), (512, 1000, 256), (4096, 64, 200),
              (8, 1000, 129))
SOLVE_BATCHES = (1, 127, 128, 131_072)
GRAM_TIMED = ((4096, 64, 64), (4096, 1000, 64), (4096, 64, 256))  # (R, L, K)
SOLVE_TIMED = 131_072                      # B at rank 64
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SMEM_BANKS = 32             # 4-byte shared-memory banks per SM, one access
                            # each per clock (CUDA programming guide)
SPIN_CYCLES = 4_000_000     # ~2 ms of device spin: covers any host enqueue
# Phase 8 grid (K5): queries, tables S = 1 + M, items, k (k <= N), plus
# cases with n_valid < N; then the timed shape.
PQ_BATCHES, PQ_TABLES = (1, 3, 8, 64), (1, 5, 17, 33, 65)
PQ_ITEMS_GRID, PQ_KS = (1, 511, 100_003, 1_048_576), (1, 10, 40, 1000, 4000)
PQ_N_VALID = ((8, 17, 100_003, 40, 50_000), (3, 5, 511, 10, 300),
              (64, 65, 1_048_576, 1000, 1_048_576 - 777),
              (1, 1, 100_003, 4000, 4000))        # (B, S, N, k, n_valid)
PQ_TIMED = (1_048_576, 17, 40)                     # (N, S, k) at B 1 and 64
PQ_ITEMS = 1_048_576        # phase 10: 5x PIO_PQ_MIN_ITEMS, the 1e6 scale
PQ_USERS = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(b: int, n: int, d: int, k: int):
    """Least time for the fused top-k: each input read once, each output
    written once, over the memory rate; 2*B*N*D float32 flops over the
    float32 peak.  Returns (ms, 'bytes' | 'operations')."""
    t_bytes = (n * d * 4 + b * d * 4 + b * k * 8) / HBM_BYTES_PER_S
    t_ops = 2.0 * b * n * d / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Bound:
    """Least time the card could take for a sequence of calls: for each
    call the larger of its bytes over the memory rate and its float32
    flops over the float32 peak, summed; ``by`` names the term that
    binds most of the total."""

    def __init__(self):
        self.ms = 0.0
        self.ms_by = {"bytes": 0.0, "operations": 0.0}

    def add(self, n_bytes: float, flops: float) -> "Bound":
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.ms += max(t_bytes, t_ops)
        self.ms_by[by] += max(t_bytes, t_ops)
        return self

    @property
    def by(self) -> str:
        return max(self.ms_by, key=self.ms_by.get)


def gram_cost(r: int, l: int, k: int, n: int, elem: int = 4):
    """K1 on one [R, L] block against an [N, K] factor matrix of
    ``elem``-byte elements: (bytes, flops).  Bytes: the index, weight and
    value reads, one read of the factor matrix, the A and b writes.
    Flops, per slot: K multiplies for w·f, K(K+1) for the symmetric A
    (its upper triangle, the SYRK count) and 2K for b, so
    R·L·(K(K+1) + 3K)."""
    return (r * l * 12 + n * k * elem + r * k * (k + 1) * 4,
            float(r * l * (k * (k + 1) + 3 * k)))


def solve_cost(b: int, k: int, method: str, rs):
    """K2/K4 on B rank-k systems: (bytes, flops).  Bytes: A, b and reg
    read, x written; flops: the kernel's elimination count
    (``rs.solve_flops``)."""
    return b * (k * k + 2 * k + 1) * 4, b * rs.solve_flops(k, method)


def synth_ml25m(seed: int):
    """MovieLens-25M-shaped ratings, the repository's benchmark generator
    (bench.py synth_ml25m, copied: bench.py imports JAX): uniform users,
    Zipf(1.25) items, half-star ratings 0.5..5.0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    users = rng.integers(0, ML25M_USERS, ML25M_RATINGS)
    items = (rng.zipf(1.25, size=ML25M_RATINGS) % ML25M_ITEMS).astype(
        np.int64)
    ratings = (rng.integers(1, 11, ML25M_RATINGS) * 0.5).astype(np.float32)
    return users, items, ratings


def time_stream(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events,
    after a warm-up.  Where the host enqueues slower than the card runs,
    this is the host's rate, not the card's."""
    import torch

    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def time_single(fn, reps: int, flush=None, *, warmup: int = 3,
                spin: int = SPIN_CYCLES) -> float:
    """Median device ms of single calls, each between its own CUDA
    events.  A spin kernel queued first keeps the card busy while the
    host enqueues the call, so the events see the call's kernels (and
    the gaps between them), not the host's enqueue time; a call made of
    many small launches needs a longer ``spin``.  With ``flush`` (a
    callable that evicts L2) each call starts cold."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


def check_against_plain(got_s, got_i, q, items, k, n_valid, what, ft,
                        topk_mismatch) -> float:
    """Hold a [B, k] answer against the plain top-k on the card; returns
    the largest score error."""
    n_real = items.shape[0] if n_valid is None else n_valid
    rs, ri = ft.fused_topk_reference(q, items, min(k + 1, n_real),
                                     n_valid=n_valid)
    next_s = rs[:, k].cpu().numpy() if rs.shape[1] > k else None
    ref_s, ref_i = rs[:, :k].cpu().numpy(), ri[:, :k].cpu().numpy()
    why = topk_mismatch(got_s, got_i, ref_s, ref_i, next_s, rtol=RTOL,
                        atol=ATOL)
    if why is not None:
        die(f"{what}: {why}")
    import numpy as np

    return float(np.max(np.abs(np.asarray(got_s) - ref_s))) \
        if ref_s.size else 0.0


def assert_close(got, want, rtol: float, atol, what: str) -> float:
    """Die unless ``got`` is finite and within ``atol`` (a number or a
    tensor of per-element bounds) + rtol·|want| of ``want``; returns the
    largest absolute error."""
    import torch

    if not bool(torch.isfinite(got).all()):
        die(f"{what}: non-finite values")
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if bool(bad.any()):
        die(f"{what}: max |err| {err:.3g} beyond rtol {rtol} + atol "
            f"(largest {float(torch.as_tensor(atol).max()):.3g})")
    return err


def scaled(rel: float, want) -> float:
    """``rel`` times the largest magnitude of ``want``."""
    return rel * float(want.abs().max()) if want.numel() else 0.0


def gram_atol(l: int, abs_sum):
    """K1's absolute tolerance per entry: GRAM_SIGMAS standard deviations
    of the rounding of a float32 sum of ``l`` terms whose magnitudes sum
    to ``abs_sum``."""
    return GRAM_SIGMAS * math.sqrt(l) * 2.0 ** -24 * abs_sum


def training_kernels_phase(dev, fg, rs, card: str):
    """Phase 3: K1, K2 and K4 against their plain versions over a grid
    of shapes, then timed at representative shapes.  Returns the
    largest error of each kernel."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n_fac = 50_000
    base = torch.randn((n_fac, 256), generator=gen, device=dev)
    err = {"fused_gram": 0.0, "ridge_solve_lu": 0.0, "ridge_solve_gj": 0.0}

    def gram_block(r, l):
        idx = torch.randint(0, n_fac, (r, l), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((r, l), generator=gen, device=dev)
        c = torch.randn((r, l), generator=gen, device=dev)
        # ragged rows: slots past a row's degree carry index 0, w = c = 0
        deg = torch.randint(1, l + 1, (r, 1), generator=gen, device=dev)
        tail = torch.arange(l, device=dev)[None, :] >= deg
        idx[tail] = 0
        w[tail] = 0.0
        c[tail] = 0.0
        return idx, w, c

    n_gram = 0
    shapes = [(r, l, k) for k in TRAIN_RANKS for r in GRAM_ROWS
              for l in GRAM_LENS] + list(GRAM_TILED)
    for r, l, k in shapes:
        fac32 = base[:, :k].contiguous()
        idx, w, c = gram_block(r, l)
        for fac in (fac32, fac32.bfloat16()):
            a, b = fg.fused_gram_vector_cuda(fac, idx, w, c)
            torch.cuda.synchronize()
            ra, rb = fg.fused_gram_vector_reference(fac, idx, w, c)
            abs_a, abs_b = fg.fused_gram_vector_reference(
                fac.abs(), idx, w.abs(), c.abs())
            what = f"fused_gram R={r} L={l} K={k} {fac.dtype}"
            err["fused_gram"] = max(
                err["fused_gram"],
                assert_close(a, ra, GRAM_RTOL, gram_atol(l, abs_a), what),
                assert_close(b, rb, GRAM_RTOL, gram_atol(l, abs_b), what))
            del a, b, ra, rb, abs_a, abs_b
            n_gram += 1
    n_solve = 0
    for k in TRAIN_RANKS:
        for bsz in SOLVE_BATCHES:
            m = torch.randn((bsz, k, 16), generator=gen, device=dev)
            a = (m @ m.mT) / 16
            del m
            rhs = torch.randn((bsz, k), generator=gen, device=dev)
            reg = 0.05 * torch.randint(1, 40, (bsz,), generator=gen,
                                       device=dev).float()
            for method, plain in (("lu", rs.ridge_solve_lu_reference),
                                  ("gj", rs.ridge_solve_gj_reference)):
                x = rs.ridge_solve_cuda(a, rhs, reg, method)
                torch.cuda.synchronize()
                name = f"ridge_solve_{method}"
                want = plain(a, rhs, reg)
                err[name] = max(err[name], assert_close(
                    x, want, SOLVE_RTOL, scaled(SOLVE_ATOL, want),
                    f"{name} B={bsz} K={k}"))
                n_solve += 1
            del a, rhs, reg
    log(f"phase 3 kernel: fused_gram matches its plain version in "
        f"{n_gram} cases (R in {GRAM_ROWS}, L in {GRAM_LENS}, K in "
        f"{TRAIN_RANKS}, and (R, L, K) in {GRAM_TILED}; float32 and "
        f"bfloat16 factors, ragged rows), max "
        f"|err| {err['fused_gram']:.3g} (rtol {GRAM_RTOL} + "
        f"{GRAM_SIGMAS}·√L·2^-24·Σ|terms|); ridge_solve lu and gj match theirs in "
        f"{n_solve} cases (B in {SOLVE_BATCHES}, K in {TRAIN_RANKS}), max "
        f"|err| lu {err['ridge_solve_lu']:.3g}, gj "
        f"{err['ridge_solve_gj']:.3g} (rtol {SOLVE_RTOL} + "
        f"{SOLVE_ATOL}·max|x|)")

    for r, l, k in GRAM_TIMED:
        fac = base[:, :k].contiguous()
        idx, w, c = gram_block(r, l)
        f = fac.index_select(0, idx.reshape(-1)).reshape(r, l, k)
        fw = f * w[..., None]
        row = {"kernel_ms": time_single(
                   lambda: fg.fused_gram_vector_cuda(fac, idx, w, c), 20),
               "plain_ms": time_single(
                   lambda: fg.fused_gram_vector_reference(fac, idx, w, c),
                   10),
               "library_ms": time_single(lambda: torch.bmm(fw.mT, f), 20)}
        bnd = Bound().add(*gram_cost(r, l, k, n_fac))
        row.update(bound_ms=bnd.ms, bound_by=bnd.by,
                   share_of_bound=bnd.ms / row["kernel_ms"])
        log("phase 3 timing: " + json.dumps(
            {"kernel": "fused_gram", "R": r, "L": l, "K": k, "N": n_fac,
             "library": "torch.bmm(fw^T, f) on the pre-gathered block",
             "card": card, **row}))
        del f, fw
    bsz, k = SOLVE_TIMED, RANK
    m = torch.randn((bsz, k, 16), generator=gen, device=dev)
    a = (m @ m.mT) / 16
    del m
    rhs = torch.randn((bsz, k), generator=gen, device=dev)
    reg = 0.05 * torch.randint(1, 40, (bsz,), generator=gen,
                               device=dev).float()
    a_reg = a + torch.diag_embed(reg[:, None].expand(bsz, k))
    lib = time_single(lambda: torch.cholesky_solve(
        rhs[..., None], torch.linalg.cholesky(a_reg)), 10)
    for method, plain in (("lu", rs.ridge_solve_lu_reference),
                          ("gj", rs.ridge_solve_gj_reference)):
        bnd = Bound().add(*solve_cost(bsz, k, method, rs))
        row = {"kernel_ms": time_single(
                   lambda: rs.ridge_solve_cuda(a, rhs, reg, method), 10),
               "plain_ms": time_single(lambda: plain(a, rhs, reg), 3,
                                       warmup=1, spin=20 * SPIN_CYCLES),
               "library_ms": lib, "bound_ms": bnd.ms, "bound_by": bnd.by}
        row["share_of_bound"] = bnd.ms / row["kernel_ms"]
        log("phase 3 timing: " + json.dumps(
            {"kernel": f"ridge_solve_{method}", "B": bsz, "K": k,
             "library": "torch.linalg.cholesky + torch.cholesky_solve on "
                        "A + diag(reg)", "card": card, **row}))
    return err


class swapped_routes:
    """Within the block, the training sweep's K1 and K2 routes
    (``fg.fused_gram_vector``, ``rs.ridge_solve_lu``) are ``gram`` and
    ``solve`` instead."""

    def __init__(self, fg, rs, gram, solve):
        self.fg, self.rs, self.routes = fg, rs, (gram, solve)

    def __enter__(self):
        self.saved = (self.fg.fused_gram_vector, self.rs.ridge_solve_lu)
        self.fg.fused_gram_vector, self.rs.ridge_solve_lu = self.routes
        return self

    def __exit__(self, *exc):
        self.fg.fused_gram_vector, self.rs.ridge_solve_lu = self.saved


def plain_versions(fg, rs) -> swapped_routes:
    """The sweep runs the plain PyTorch versions of K1 and K2."""
    return swapped_routes(fg, rs, fg.fused_gram_vector_reference,
                          rs.ridge_solve_lu_reference)


class recorded_calls(swapped_routes):
    """The sweep's K1 and K2 calls run as usual, and a copy of each
    call's arguments is kept (the sweep updates its factor matrices in
    place afterwards): ``gram`` holds (factors, indices, w, c) per K1
    call, ``solve`` (a, b, reg) per K2 call."""

    def __init__(self, fg, rs):
        self.gram, self.solve = [], []
        gram_fn, solve_fn = fg.fused_gram_vector, rs.ridge_solve_lu

        def gram(*args):
            self.gram.append(tuple(t.clone() for t in args))
            return gram_fn(*args)

        def solve(*args):
            self.solve.append(tuple(t.clone() for t in args))
            return solve_fn(*args)

        super().__init__(fg, rs, gram, solve)


def iteration_kernel_times(calls: recorded_calls, fg, rs):
    """Each training kernel timed over the recorded calls of one ALS
    iteration, on their own arguments: the kernel, its plain version,
    its library yardstick and its bound, summed over the calls.  K4 is
    timed on K2's arguments (``solver="gj"`` makes the same calls).
    Returns {kernel name: row}."""
    import torch

    rows = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound": Bound(), "calls": 0}
            for n in ("fused_gram", "ridge_solve_lu", "ridge_solve_gj")}
    long_spin = 20 * SPIN_CYCLES        # plain versions: many launches each
    row = rows["fused_gram"]
    for args in calls.gram:
        src, idx, w, _ = args
        (r, l), k = idx.shape, src.shape[1]
        row["ms"] += time_single(lambda: fg.fused_gram_vector_cuda(*args),
                                 3, warmup=1)
        row["plain_ms"] += time_single(
            lambda: fg.fused_gram_vector_reference(*args), 1, warmup=1,
            spin=long_spin)
        f = src.index_select(0, idx.reshape(-1)).reshape(r, l, k).float()
        fw = f * w[..., None]
        row["library_ms"] += time_single(lambda: torch.bmm(fw.mT, f), 3,
                                         warmup=1)
        del f, fw
        row["bound"].add(*gram_cost(r, l, k, src.shape[0],
                                    src.element_size()))
        row["calls"] += 1
    for a, b, reg in calls.solve:
        k = b.shape[1]
        a_reg = a + torch.diag_embed(reg[:, None].expand(-1, k))
        lib = time_single(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(a_reg)), 3, warmup=1)
        del a_reg
        for method, plain in (("lu", rs.ridge_solve_lu_reference),
                              ("gj", rs.ridge_solve_gj_reference)):
            row = rows[f"ridge_solve_{method}"]
            row["ms"] += time_single(
                lambda: rs.ridge_solve_cuda(a, b, reg, method), 3, warmup=1)
            row["plain_ms"] += time_single(lambda: plain(a, b, reg), 1,
                                           warmup=1, spin=long_spin)
            row["library_ms"] += lib
            row["bound"].add(*solve_cost(a.shape[0], k, method, rs))
            row["calls"] += 1
    for row in rows.values():
        bnd = row.pop("bound")
        row.update(bound_ms=bnd.ms, bound_by=bnd.by)
    return rows


def train_phase(dev, seed: int, als, fg, rs, card: str) -> dict:
    """Phase 6: ALS training at the MovieLens-25M shape."""
    import dataclasses

    import torch

    t0 = time.perf_counter()
    users, items, ratings = synth_ml25m(seed)
    gen_s = time.perf_counter() - t0
    cfg = als.ALSConfig(rank=RANK, iterations=TRAIN_ITERS, reg=0.01,
                        solver="auto", seed=seed)
    statics = als._resolve_loop_statics(cfg, dev)
    if statics["solver"] != "lu":
        die(f"training routes {statics} on the card; expected the LU "
            "kernel")
    t0 = time.perf_counter()
    inputs = als.prepare_als_inputs(users, items, ratings, ML25M_USERS,
                                    ML25M_ITEMS, cfg, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    n_chunks = (len(inputs.user_buckets), len(inputs.item_buckets))
    n_merged = sum(c.kind == "merged" for c in inputs.item_buckets)
    one = dataclasses.replace(cfg, iterations=1)
    t0 = time.perf_counter()
    with recorded_calls(fg, rs) as calls:   # the calls timed below
        first = als.train_als_prepared(inputs, one)
    first_s = time.perf_counter() - t0

    fg.LAUNCHES = 0                         # main path starts here
    rs.LU_LAUNCHES = 0
    rs.GJ_LAUNCHES = 0
    t0 = time.perf_counter()
    model = als.train_als_prepared(inputs, cfg)
    wall_s = time.perf_counter() - t0
    launches = {"fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES}
    if rs.GJ_LAUNCHES:
        die(f"ridge_solve_gj launched {rs.GJ_LAUNCHES} times under "
            "solver='auto'")
    for name, n in launches.items():     # main path ends here
        if n == 0:
            die(f"{name} never launched in the training run")
    ms_iter = wall_s * 1e3 / TRAIN_ITERS
    rmse = als.rmse(model, users, items, ratings, device=dev)
    if not 0.0 < rmse < 5.0:
        die(f"training RMSE {rmse} out of range")

    with plain_versions(fg, rs):
        before = (fg.LAUNCHES, rs.LU_LAUNCHES)
        plain = als.train_als_prepared(inputs, one)
        if (fg.LAUNCHES, rs.LU_LAUNCHES) != before:
            die("the plain iteration launched a kernel")
    err_plain = max(
        assert_close(torch.from_numpy(first.user_factors),
                     torch.from_numpy(plain.user_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(plain.user_factors)),
                     "one iteration, kernels vs plain: users"),
        assert_close(torch.from_numpy(first.item_factors),
                     torch.from_numpy(plain.item_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(plain.item_factors)),
                     "one iteration, kernels vs plain: items"))
    rs.GJ_LAUNCHES = 0                      # the gj path starts here
    t0 = time.perf_counter()
    gj = als.train_als_prepared(inputs,
                                dataclasses.replace(one, solver="gj"))
    gj_s = time.perf_counter() - t0
    gj_launches = rs.GJ_LAUNCHES            # and ends here
    if gj_launches == 0:
        die("solver='gj' did not launch ridge_solve_gj")
    err_gj = max(
        assert_close(torch.from_numpy(gj.user_factors),
                     torch.from_numpy(first.user_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(first.user_factors)),
                     "one iteration, gj vs lu: users"),
        assert_close(torch.from_numpy(gj.item_factors),
                     torch.from_numpy(first.item_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(first.item_factors)),
                     "one iteration, gj vs lu: items"))
    log(f"phase 6 train: ML-25M shape {ML25M_USERS}x{ML25M_ITEMS}, "
        f"{ML25M_RATINGS} ratings (made in {gen_s:.1f} s), rank {RANK}, "
        f"reg 0.01, solver auto -> {statics['solver']}: host prep + "
        f"upload {prep_s:.2f} s ({n_chunks[0]} user / {n_chunks[1]} item "
        f"chunks, {n_merged} split); first iteration (its calls recorded) "
        f"{first_s * 1e3:.1f} ms; "
        f"{TRAIN_ITERS} iterations {wall_s:.3f} s = {ms_iter:.2f} ms/iter "
        f"= {ML25M_RATINGS / (ms_iter / 1e3):.4g} ratings/s; final RMSE "
        f"{rmse:.6f}; launches fused_gram {launches['fused_gram']}, "
        f"ridge_solve_lu {launches['ridge_solve_lu']}; one iteration "
        f"kernels vs plain versions max |err| {err_plain:.3g}, gj vs lu "
        f"{err_gj:.3g} (rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}·max|ref|); "
        f"solver gj iteration {gj_s * 1e3:.1f} ms, ridge_solve_gj launches "
        f"{gj_launches}; card {card}")
    per_iter = iteration_kernel_times(calls, fg, rs)
    del calls
    for name, row in per_iter.items():
        log("phase 6 timing (one iteration's calls): " + json.dumps(
            {"kernel": name, "card": card, **row}))
    launches["ridge_solve_gj"] = gj_launches
    return {"launches": launches, "per_iter": per_iter,
            "err": max(err_plain, err_gj)}


def dase_phase(dev, seed: int, home: str, mods: dict, card: str) -> dict:
    """Phase 7: events → run_train → deploy → /queries.json on the card.
    Returns the K3 launches of the phase, and the storage, engine variant
    and engine that phase 11 trains again."""
    import numpy as np
    import torch

    fg, rs, ft = mods["fg"], mods["rs"], mods["ft"]
    rng = np.random.default_rng(seed + 1)
    storage = mods["get_storage"](os.path.join(home, "dase"))
    app_id = storage.get_apps().insert(mods["App"](id=None, name="chipsmoke"))
    events = storage.get_events()
    events.init(app_id)
    t0 = time.perf_counter()
    users = rng.integers(0, DASE_USERS, DASE_EVENTS).tolist()
    items = (rng.zipf(1.25, DASE_EVENTS) % DASE_ITEMS).tolist()
    stars = (rng.integers(1, 11, DASE_EVENTS) * 0.5).tolist()
    buys = (rng.random(DASE_EVENTS) < 0.1).tolist()
    Event, DataMap = mods["Event"], mods["DataMap"]
    events.insert_batch([
        Event(event="buy" if buy else "rate", entity_type="user",
              entity_id=f"u{u}", target_entity_type="item",
              target_entity_id=f"i{i}",
              properties=DataMap({} if buy else {"rating": r}))
        for u, i, r, buy in zip(users, items, stars, buys)], app_id)
    insert_s = time.perf_counter() - t0
    spec = json.loads((mods["csrc"].parent / "templates" / "recommendation"
                       / "engine.json").read_text())
    spec["datasource"]["params"]["appName"] = "chipsmoke"
    spec["algorithms"][0]["params"].update(rank=RANK, numIterations=10)
    variant = mods["EngineVariant"].from_dict(spec)
    eng = mods["engine"]()
    ctx = mods["RuntimeContext"].create(storage=storage)   # the card
    os.environ["PIO_RETRIEVAL_RUNG"] = "chunked"
    server = None
    try:
        fg.LAUNCHES = 0                     # main path starts here
        rs.LU_LAUNCHES = 0
        ft.LAUNCHES = 0
        t0 = time.perf_counter()
        iid = mods["run_train"](eng, variant, ctx)
        train_s = time.perf_counter() - t0
        server = mods["EngineServer"](eng, variant, storage,
                                      host="127.0.0.1", port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        wrapper = server._models[0]
        names = list(wrapper.user_index.keys())
        asked = [names[j] for j in rng.choice(len(names), 16,
                                              replace=False)]
        answers, lats = [], []
        for user in asked:
            t0 = time.perf_counter()
            ans, _ = post_json(f"{base}/queries.json",
                               {"user": user, "num": 10})
            lats.append(time.perf_counter() - t0)
            answers.append(ans)
        counts = {"fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES,
                  "fused_topk": ft.LAUNCHES}   # main path ends here
        for name, n in counts.items():
            if n == 0:
                die(f"DASE phase: {name} never launched")
        if counts["fused_topk"] < 16:
            die(f"DASE phase: fused_topk launched {counts['fused_topk']} "
                "times for 16 queries")
        status = storage.get_engine_instances().get(iid).status
        if status != "COMPLETED":
            die(f"DASE phase: instance {iid} is {status}")
        uf, itf = wrapper.host_factors()
        items_d = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
        err = 0.0
        for user, ans in zip(asked, answers):
            hits = ans["itemScores"]
            if len(hits) != 10:
                die(f"DASE answer for {user} has {len(hits)} items")
            s = [[h["score"] for h in hits]]
            i = [[wrapper.item_index[h["item"]] for h in hits]]
            q = torch.from_numpy(uf[[wrapper.user_index[user]]]).to(dev)
            err = max(err, check_against_plain(
                s, i, q, items_d, 10, None, f"DASE /queries.json {user}",
                ft, mods["topk_mismatch"]))
        phases = mods["get_registry"]().get("pio_train_phase_ms")
        spans = {p: round(phases.sum(phase=p), 3) for p in (
            "train.datasource", "train.prepare", "train.algorithm",
            "train.persist")}
    finally:
        if server is not None:
            server.stop()
        os.environ.pop("PIO_RETRIEVAL_RUNG", None)
    log(f"phase 7 dase: {DASE_EVENTS} rate/buy events ({DASE_USERS} "
        f"users, {DASE_ITEMS} items, generator distributions) inserted in "
        f"{insert_s:.2f} s; run_train rank {RANK} COMPLETED in "
        f"{train_s:.2f} s (phase ms {json.dumps(spans)}; trained "
        f"{len(wrapper.user_index)} users x {len(wrapper.item_index)} "
        f"items); 16 /queries.json p50 {sorted(lats)[8] * 1e3:.2f} ms, each "
        f"held against the plain top-k of the trained factors, max |score "
        f"err| {err:.3g}; launches {json.dumps(counts)}; card {card}")
    return {"fused_topk": counts["fused_topk"], "storage": storage,
            "variant": variant, "engine": eng}


class env_vars:
    """Within the block, the environment variables given are set (a value
    of None unsets one); the previous values come back afterwards."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def smem_lookups_per_s() -> tuple:
    """Shared-memory lookups per second of this card: SMs x 32 banks x
    the maximum SM clock (nvidia-smi clocks.max.sm), one 4-byte access
    per bank per clock.  Returns (rate, how it was derived)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SMEM_BANKS * mhz * 1e6
    return rate, (f"{sms} SMs x {SMEM_BANKS} banks x {mhz:.0f} MHz "
                  f"(nvidia-smi clocks.max.sm) = {rate:.4g} lookups/s")


def pq_bound(b: int, s: int, n: int, k: int, smem_rate: float):
    """Least time for K5: the bytes (codes S*N, tables 4*B*S*256, output
    8*B*k) over the memory rate, or the B*S*N table lookups over the
    shared-memory rate, whichever is larger.  Returns (ms, by)."""
    t_bytes = (s * n + 4 * b * s * 256 + 8 * b * k) / HBM_BYTES_PER_S
    t_ops = b * s * n / smem_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def pq_kernel_phase(dev, seed: int, pqs, tpq, topk_mismatch, card: str):
    """Phase 8: K5 against its plain version over the grid, then timed.
    Returns (largest score error, {B: timing row})."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    codes_all = torch.randint(0, 256, (max(PQ_TABLES), max(PQ_ITEMS_GRID)),
                              generator=gen, device=dev, dtype=torch.uint8)
    luts_all = torch.randn((max(PQ_BATCHES), max(PQ_TABLES), 256),
                           generator=gen, device=dev)
    cases = [(b, t, n, k, None) for b in PQ_BATCHES for t in PQ_TABLES
             for n in PQ_ITEMS_GRID for k in PQ_KS if k <= n]
    cases += list(PQ_N_VALID)
    err = 0.0
    for b, t, n, k, n_valid in cases:
        luts = luts_all[:b, :t].contiguous()
        codes = codes_all[:t, :n].contiguous()
        got_s, got_i = pqs.pq_scan_cuda(luts, codes, k, n_valid=n_valid)
        torch.cuda.synchronize()
        n_real = n if n_valid is None else n_valid
        ref_s, ref_i = pqs.pq_scan_reference(luts, codes, min(k + 1, n_real),
                                             n_valid=n_valid)
        next_s = ref_s[:, k].cpu().numpy() if ref_s.shape[1] > k else None
        got_s, got_i = got_s.cpu().numpy(), got_i.cpu().numpy()
        ref_s = ref_s[:, :k].cpu().numpy()
        why = topk_mismatch(got_s, got_i, ref_s, ref_i[:, :k].cpu().numpy(),
                            next_s, rtol=RTOL, atol=ATOL)
        if why is None and int(got_i.max()) >= n_real:
            why = f"id {int(got_i.max())} at or past n_valid {n_real}"
        if why is not None:
            die(f"pq_scan B={b} S={t} N={n} k={k} n_valid={n_valid}: {why}")
        err = max(err, float(abs(got_s - ref_s).max()))
    del luts_all
    torch.cuda.empty_cache()
    log(f"phase 8 kernel: pq_scan matches its plain version in {len(cases)} "
        f"cases (B in {PQ_BATCHES}, S in {PQ_TABLES}, N in {PQ_ITEMS_GRID}, "
        f"k in {PQ_KS} with k <= N, and (B, S, N, k, n_valid) in "
        f"{PQ_N_VALID}; S = 1 is the tie case: ids compared only above the "
        f"k-th score); max |score err| {err:.3g} (rtol {RTOL}, atol {ATOL})")

    # Timed on a real codebook's tables, so that one library call computes
    # the same function: sum_t lut[t, code_t] = q . decode(n).
    n, t, k = PQ_TIMED
    m = t - 1
    coarse = torch.randn((256, RANK), generator=gen, device=dev) / 8
    books = torch.randn((m, 256, RANK // m), generator=gen, device=dev) / 8
    codes = codes_all[:t].contiguous()
    del codes_all
    decoded = coarse[codes[0].long()] + torch.cat(
        [books[j][codes[1 + j].long()] for j in range(m)], dim=1)
    queries = torch.randn((64, RANK), generator=gen, device=dev) / 8
    smem_rate, rate_note = smem_lookups_per_s()
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for b in (1, 64):
        q = queries[:b].contiguous()
        luts = tpq.device_luts(q, coarse, books)
        fns = {"": lambda: pqs.pq_scan_cuda(luts, codes, k),
               "plain_": lambda: pqs.pq_scan_reference(luts, codes, k),
               "library_": lambda: torch.topk(q @ decoded.T, k)}
        row = {}
        for _ in range(2):   # kernel, plain, library; twice, in turns
            for tag, fn in fns.items():
                row.setdefault(f"{tag}ms", []).append(time_single(fn, 20))
        row = {name: min(v) for name, v in row.items()}
        row["ms_cold"] = time_single(fns[""], 20, flush=flush_buf.zero_)
        row["bound_ms"], row["bound_by"] = pq_bound(b, t, n, k, smem_rate)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[b] = row
        log("phase 8 timing: " + json.dumps(
            {"kernel": "pq_scan", "B": b, "S": t, "N": n, "k": k,
             "library": "torch.topk(q @ decoded.T, k), decode not timed",
             "card": card, **row}))
    log(f"phase 8 bound: bytes S*N + 4*B*S*256 + 8*B*k at "
        f"{HBM_BYTES_PER_S:.4g} B/s, or B*S*N lookups at {rate_note}")
    del flush_buf, decoded, codes
    torch.cuda.empty_cache()
    return err, rows


def gather_kernels_phase(dev, seed: int, mods, card: str):
    """Phase 9: T1 and T2 against their plain versions at the tools'
    shape, timed, then driven through the tools' entry points.  Returns
    {kernel name: report fields}."""
    import torch

    fg, gt = mods["fg"], mods["gt"]
    exp_gram, exp_gather2 = mods["exp_gram"], mods["exp_gather2"]
    t = exp_gram.make_inputs(dev, seed)
    y, idx, w = t["y"], t["idx"], t["w"]
    r, l = idx.shape
    i_rows, k = y.shape
    k1_before = fg.LAUNCHES
    a = fg.gather_gram_cuda(y, idx, w)
    torch.cuda.synchronize()
    if fg.LAUNCHES != k1_before:
        die("gather_gram counted as a fused_gram (K1) launch")
    want = fg.gather_gram_reference(y, idx, w)
    abs_a = fg.gather_gram_reference(y.abs(), idx, w)
    err_t1 = assert_close(a, want, GRAM_RTOL, gram_atol(l, abs_a),
                          f"gather_gram R={r} L={l} K={k}")
    del a, want, abs_a
    out = gt.gather_sum_cuda(y, idx)
    torch.cuda.synchronize()
    want = gt.gather_sum_reference(y, idx)
    abs_s = gt.gather_sum_reference(y.abs(), idx)
    err_t2 = assert_close(out, want, 0.0, gram_atol(l, abs_s),
                          f"gather_sum R={r} L={l} K={k}")
    del out, want, abs_s
    log(f"phase 9 kernel: gather_gram (T1) and gather_sum (T2) match their "
        f"plain versions at I {i_rows}, K {k}, R {r}, L {l} (Zipf(1.25) "
        f"indices, seed {seed}); max |err| T1 {err_t1:.3g} (rtol "
        f"{GRAM_RTOL} + {GRAM_SIGMAS}·√L·2^-24·Σ|terms|), T2 {err_t2:.3g} "
        f"({GRAM_SIGMAS}·√L·2^-24·Σ|terms|)")

    f = y.index_select(0, idx.reshape(-1).long()).reshape(r, l, k)
    fw = f * w[..., None]
    idx64 = idx.long()
    rows = {}
    specs = {
        "gather_gram": (
            lambda: fg.gather_gram_cuda(y, idx, w),
            lambda: fg.gather_gram_reference(y, idx, w),
            lambda: torch.bmm(fw.mT, f),
            "torch.bmm(fw^T, f) on the pre-gathered block, gather not timed",
            Bound().add(r * l * 8 + i_rows * k * 4 + r * k * k * 4,
                        float(r * l * (k * (k + 1) + k))), err_t1),
        "gather_sum": (
            lambda: gt.gather_sum_cuda(y, idx),
            lambda: gt.gather_sum_reference(y, idx),
            lambda: torch.nn.functional.embedding_bag(idx64, y, mode="sum"),
            "torch.nn.functional.embedding_bag(idx, y, mode='sum')",
            Bound().add(r * l * 4 + i_rows * k * 4 + r * k * 4,
                        float(r * l * k)), err_t2),
    }
    for name, (kern, plain, lib, lib_note, bnd, err) in specs.items():
        row = {"ms": [], "plain_ms": [], "library_ms": []}
        for _ in range(2):   # kernel, plain, library; twice, in turns
            row["ms"].append(time_single(kern, 10))
            row["plain_ms"].append(time_single(plain, 5))
            row["library_ms"].append(time_single(lib, 10))
        row = {n_: min(v) for n_, v in row.items()}
        row.update(bound_ms=bnd.ms, bound_by=bnd.by,
                   share_of_bound=bnd.ms / row["ms"], max_abs_err=err)
        rows[name] = row
        log("phase 9 timing: " + json.dumps(
            {"kernel": name, "I": i_rows, "K": k, "R": r, "L": l,
             "library": lib_note, "card": card, **row}))
    del f, fw, idx64, t, y, idx, w
    torch.cuda.empty_cache()

    fg.GATHER_GRAM_LAUNCHES = 0             # main path (T1) starts here
    exp_gram.main(["pallas"])
    rows["gather_gram"]["launches"] = fg.GATHER_GRAM_LAUNCHES  # and ends
    gt.LAUNCHES = 0                         # main path (T2) starts here
    exp_gather2.main(["take"])
    rows["gather_sum"]["launches"] = gt.LAUNCHES               # and ends
    for name, row in rows.items():
        if row["launches"] == 0:
            die(f"the tool's entry point never launched {name}")
    log(f"phase 9 tools: exp_gram pallas launched gather_gram "
        f"{rows['gather_gram']['launches']} times, exp_gather2 take "
        f"launched gather_sum {rows['gather_sum']['launches']} times")
    torch.cuda.empty_cache()
    return rows


def pq_answers_agree(answers, host_s, host_i, what: str, topk_mismatch,
                     num: int = 10) -> float:
    """Hold served answers against a host search that returned num + 1
    columns (the extra one is the next score, for ties); returns the
    largest score error."""
    import numpy as np

    err = 0.0
    for row, ans in enumerate(answers):
        s, i = answer_arrays(ans, num)
        why = topk_mismatch(s, i, host_s[row:row + 1, :num],
                            host_i[row:row + 1, :num], host_s[row:row + 1, num],
                            rtol=RTOL, atol=ATOL)
        if why is not None:
            die(f"{what} row {row}: {why}")
        err = max(err, float(np.max(np.abs(np.asarray(s)
                                           - host_s[row:row + 1, :num]))))
    return err


def pq_serve_phase(seed: int, home: str, users_np, mods, card: str) -> dict:
    """Phase 10: a 1,048,576-item catalog with an IVF index and PQ codes,
    served on pq_flat (K5) and ivf_pq.  Returns K5's launches and the
    answers' largest score error."""
    import numpy as np

    pqs, tpq = mods["pqs"], mods["tpq"]
    retrieval = mods["retrieval"]
    rng = np.random.default_rng(seed + 10)
    t0 = time.perf_counter()
    items = rng.standard_normal((PQ_ITEMS, RANK), np.float32) \
        / np.float32(np.sqrt(RANK))
    gen_s = time.perf_counter() - t0
    with env_vars(PIO_IVF="on", PIO_IVF_MIN_ITEMS=None, PIO_IVF_NLIST=None,
                  PIO_PQ=None, PIO_PQ_M=None, PIO_PQ_MIN_ITEMS=None):
        t0 = time.perf_counter()
        ivf = retrieval.build_train_index(items, name="als", seed=seed,
                                          require_explicit=True)
        ivf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pq = retrieval.build_train_pq(items, name="als", ivf=ivf, seed=seed)
        pq_s = time.perf_counter() - t0
    if ivf is None or pq is None or pq.n_tables != 17:
        die(f"phase 10: the train policy built ivf={ivf is not None}, "
            f"pq={pq is not None and pq.n_tables}")
    log(f"phase 10 build: {PQ_ITEMS} x {RANK} items made in {gen_s:.1f} s; "
        f"IVF (PIO_IVF=on) nlist {ivf.nlist}, pad_len {ivf.pad_len}, built "
        f"in {ivf_s:.2f} s; PQ (default policy) M {pq.m}, "
        f"{pq.bytes_per_item()} B/item, built in {pq_s:.2f} s (host, numpy)")
    eng = mods["engine"]()
    spec = json.loads((mods["csrc"].parent / "templates" / "recommendation"
                       / "engine.json").read_text())
    spec["algorithms"][0]["params"]["rank"] = RANK
    variant = mods["EngineVariant"].from_dict(spec)
    storage = mods["get_storage"](os.path.join(home, "pq"))
    wrapper = mods["wrapper_from_numpy"](
        users_np[:PQ_USERS], items, [f"u{j}" for j in range(PQ_USERS)],
        [f"i{j}" for j in range(PQ_ITEMS)], rank=RANK, ivf=ivf, pq=pq)
    t0 = time.perf_counter()
    mods["persist_instance"](eng, variant, [wrapper], storage)
    persist_s = time.perf_counter() - t0
    del wrapper
    server = None
    try:
        with env_vars(PIO_RETRIEVAL_RUNG="pq_flat", PIO_SERVE_HOST_MACS="0",
                      PIO_PQ_RERANK=None, PIO_IVF_NPROBE=None,
                      PIO_CORPUS_DTYPE=None):
            t0 = time.perf_counter()
            server = mods["EngineServer"](eng, variant, storage,
                                          host="127.0.0.1", port=0)
            server.start()
            load_s = time.perf_counter() - t0
            base = f"http://127.0.0.1:{server.port}"
            loaded = server._models[0]
            users = rng.choice(PQ_USERS, size=16 + 64 + 64, replace=False)
            one_u, flat_u, auto_u = users[:16], users[16:80], users[80:]
            pqs.LAUNCHES = 0                  # main path starts here
            lats, answers = [], []
            for u in one_u:
                t0 = time.perf_counter()
                ans, _ = post_json(f"{base}/queries.json",
                                   {"user": f"u{u}", "num": 10})
                lats.append(time.perf_counter() - t0)
                answers.append(ans)
            t0 = time.perf_counter()
            flat = server.query_batch([{"user": f"u{u}", "num": 10}
                                       for u in flat_u])
            flat_s = time.perf_counter() - t0
            flat_launches = pqs.LAUNCHES
            plan_flat = loaded.retriever().plan(64, 10)
            with env_vars(PIO_RETRIEVAL_RUNG=None):
                plan_auto = loaded.retriever().plan(64, 10)
                t0 = time.perf_counter()
                auto = server.query_batch([{"user": f"u{u}", "num": 10}
                                           for u in auto_u])
                auto_s = time.perf_counter() - t0
            launches = pqs.LAUNCHES           # main path ends here
            with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
                metrics = r.read().decode()
    finally:
        if server is not None:
            server.stop()
    if flat_launches != 17 or launches != 17:
        die(f"phase 10: pq_scan launched {flat_launches} times for 17 "
            f"pq_flat requests and {launches - flat_launches} times for the "
            "ivf_pq batch")
    if plan_flat.rung != "pq_flat" or plan_auto.rung != "ivf_pq":
        die(f"phase 10: planned {plan_flat} forced and {plan_auto} auto")
    lines = [ln for ln in metrics.splitlines()
             if ln.startswith("pio_retrieval_requests_total{")]
    if not any('rung="ivf_pq"' in ln for ln in lines) \
            or not any('rung="pq_flat"' in ln for ln in lines):
        die(f"phase 10: /metrics lacks the PQ rungs: {lines}")
    topk_mismatch = mods["topk_mismatch"]
    uf = users_np[:PQ_USERS]
    t0 = time.perf_counter()
    err = 0.0
    hs, hi, _ = tpq.search_pq_host(pq, items, uf[one_u], 11,
                                   plan_flat.rerank)
    err = max(err, pq_answers_agree(answers, hs, hi, "pq_flat /queries.json",
                                    topk_mismatch))
    hs, hi, _ = tpq.search_pq_host(pq, items, uf[flat_u], 11,
                                   plan_flat.rerank)
    err = max(err, pq_answers_agree(flat, hs, hi, "pq_flat query_batch",
                                    topk_mismatch))
    hs, hi, _ = tpq.search_ivf_pq_host(ivf, pq, items, uf[auto_u], 11,
                                       plan_auto.nprobe, plan_auto.rerank)
    err = max(err, pq_answers_agree(auto, hs, hi, "ivf_pq query_batch",
                                    topk_mismatch))
    check_s = time.perf_counter() - t0
    log(f"phase 10 pq: persisted in {persist_s:.2f} s, deployed in "
        f"{load_s:.2f} s; pq_flat (rerank {plan_flat.rerank}): 16 "
        f"/queries.json p50 {sorted(lats)[8] * 1e3:.2f} ms (first "
        f"{lats[0] * 1e3:.2f} ms, max {max(lats) * 1e3:.2f} ms), "
        f"query_batch of 64 in {flat_s * 1e3:.2f} ms; auto -> ivf_pq "
        f"(nprobe {plan_auto.nprobe}, rerank {plan_auto.rerank}): "
        f"query_batch of 64 in {auto_s * 1e3:.2f} ms; pq_scan launches "
        f"{launches}; every answer equals the host search on the same "
        f"structures (checked in {check_s:.1f} s), max |score err| "
        f"{err:.3g}; {' '.join(lines)}; card {card}")
    return {"launches": launches, "err": err}


def pq_dase_phase(dase, mods, card: str) -> dict:
    """Phase 11: phase 7's events trained again with PIO_PQ_MIN_ITEMS=5000
    (the template builds codes), deployed, 16 /queries.json on pq_flat."""
    import numpy as np

    fg, rs, pqs, tpq = mods["fg"], mods["rs"], mods["pqs"], mods["tpq"]
    storage, variant, eng = dase["storage"], dase["variant"], dase["engine"]
    server = None
    try:
        with env_vars(PIO_PQ_MIN_ITEMS="5000", PIO_SERVE_HOST_MACS="0",
                      PIO_IVF=None, PIO_PQ=None, PIO_PQ_M=None,
                      PIO_RETRIEVAL_RUNG=None, PIO_PQ_RERANK=None):
            ctx = mods["RuntimeContext"].create(storage=storage)  # the card
            fg.LAUNCHES = 0                     # main path starts here
            rs.LU_LAUNCHES = 0
            pqs.LAUNCHES = 0
            t0 = time.perf_counter()
            iid = mods["run_train"](eng, variant, ctx)
            train_s = time.perf_counter() - t0
            server = mods["EngineServer"](eng, variant, storage,
                                          host="127.0.0.1", port=0)
            server.start()
            base = f"http://127.0.0.1:{server.port}"
            wrapper = server._models[0]
            names = list(wrapper.user_index.keys())
            rng = np.random.default_rng(len(names))
            asked = [names[j] for j in rng.choice(len(names), 16,
                                                  replace=False)]
            answers, lats = [], []
            for user in asked:
                t0 = time.perf_counter()
                ans, _ = post_json(f"{base}/queries.json",
                                   {"user": user, "num": 10})
                lats.append(time.perf_counter() - t0)
                answers.append(ans)
            counts = {"fused_gram": fg.LAUNCHES,
                      "ridge_solve_lu": rs.LU_LAUNCHES,
                      "pq_scan": pqs.LAUNCHES}    # main path ends here
            plan = wrapper.retriever().plan(1, 10)
    finally:
        if server is not None:
            server.stop()
    status = storage.get_engine_instances().get(iid).status
    if status != "COMPLETED":
        die(f"phase 11: instance {iid} is {status}")
    if not isinstance(wrapper.pq, tpq.PQCodebook) or wrapper.ivf is not None:
        die(f"phase 11: the generation carries pq={type(wrapper.pq)}, "
            f"ivf={type(wrapper.ivf)}")
    for name, n in counts.items():
        if n == 0:
            die(f"phase 11: {name} never launched")
    if counts["pq_scan"] != 16 or plan.rung != "pq_flat":
        die(f"phase 11: pq_scan launched {counts['pq_scan']} times for 16 "
            f"queries on the {plan.rung} rung")
    uf, itf = wrapper.host_factors()
    q = uf[[wrapper.user_index[u] for u in asked]]
    hs, hi, _ = tpq.search_pq_host(wrapper.pq, itf, q, 11, plan.rerank)
    rows = wrapper.item_index      # answer_arrays reads "i<row>"
    answers = [{"itemScores": [{"item": f"i{rows[h['item']]}",
                                "score": h["score"]}
                               for h in a["itemScores"]]} for a in answers]
    err = pq_answers_agree(answers, hs, hi, "DASE+PQ /queries.json",
                           mods["topk_mismatch"])
    log(f"phase 11 dase+pq: run_train with PIO_PQ_MIN_ITEMS=5000 COMPLETED "
        f"in {train_s:.2f} s ({len(wrapper.user_index)} users x "
        f"{len(wrapper.item_index)} items; codes M {wrapper.pq.m}, "
        f"{wrapper.pq.bytes_per_item()} B/item); 16 /queries.json on "
        f"{plan.rung} (rerank {plan.rerank}) p50 "
        f"{sorted(lats)[8] * 1e3:.2f} ms, each equal to the host PQ search "
        f"of the trained factors, max |score err| {err:.3g}; launches "
        f"{json.dumps(counts)}; card {card}")
    return {"launches": counts["pq_scan"], "err": err}


def post_json(url: str, obj):
    """POST one query; returns (answer, the server's own wall ms)."""
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read()), float(r.headers["X-PIO-Server-Ms"])


def answer_arrays(answer, num):
    """itemScores of one answer → ([1, num] scores, [1, num] int ids)."""
    hits = answer["itemScores"]
    if len(hits) != num:
        die(f"answer has {len(hits)} items, expected {num}")
    return ([[h["score"] for h in hits]],
            [[int(h["item"][1:]) for h in hits]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false; this smoke run needs an "
            "NVIDIA card")
    try:
        from predictionio_tpu_torch.controller import (
            EngineVariant, RuntimeContext)
        from predictionio_tpu_torch.data.event import DataMap, Event
        from predictionio_tpu_torch.data.storage import App, get_storage
        from predictionio_tpu_torch.device import set_float32_precision
        from predictionio_tpu_torch.models import als
        from predictionio_tpu_torch.obs import get_registry
        from predictionio_tpu_torch.ops import _build
        from predictionio_tpu_torch.ops import fused_gram as fg
        from predictionio_tpu_torch.ops import fused_topk as ft
        from predictionio_tpu_torch.ops import gather as gt
        from predictionio_tpu_torch.ops import pq_scan as pqs
        from predictionio_tpu_torch.ops import ridge_solve as rs
        from predictionio_tpu_torch.ops.topk import topk_mismatch
        from predictionio_tpu_torch import retrieval
        from predictionio_tpu_torch.retrieval import pq as tpq
        from predictionio_tpu_torch.server.engine_server import EngineServer
        from predictionio_tpu_torch.templates.recommendation import (
            engine, wrapper_from_numpy)
        from predictionio_tpu_torch.tools import exp_gather2, exp_gram
        from predictionio_tpu_torch.workflow.core_workflow import (
            persist_instance, run_train)
    except ImportError as e:
        die(f"cannot import the port (run from the repository root): {e}")

    # -- phase 1: device ------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    log(f"phase 1 device: {card} | {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | built {sorted(built)} in {build_s:.2f} s "
        f"(parallel nvcc; per source {json.dumps(built)})")
    for name in built:
        rep = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log").read_text()
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name} ptxas: {line.strip()}")
    set_float32_precision()
    dev = torch.device("cuda")

    # -- data (seeded; made in bulk) -----------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    scale = np.float32(np.sqrt(RANK))
    users_np = rng.standard_normal((ML25M_USERS, RANK), np.float32) / scale
    items_np = rng.standard_normal((ML25M_ITEMS, RANK), np.float32) / scale
    big_np = rng.standard_normal((BIG_ITEMS, RANK), np.float32) / scale
    items_d = torch.from_numpy(items_np).to(dev)
    big_d = torch.from_numpy(big_np).to(dev)
    queries_d = torch.from_numpy(users_np[:64]).to(dev).contiguous()
    log(f"data: seed {args.seed}, factors made in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernel vs plain version --------------------------------
    max_err = 0.0
    cases = [(n, b, k, None) for n in (ML25M_ITEMS, BIG_ITEMS)
             for b in (1, 8, 64) for k in (10, 100, 1000)]
    cases += [(ML25M_ITEMS, 8, 100, 50_000),          # n_valid < N
              (BIG_ITEMS, 64, 1000, BIG_ITEMS - 777)]  # ragged, n_valid
    corpus = {ML25M_ITEMS: items_d, BIG_ITEMS: big_d}
    for n, b, k, n_valid in cases:
        q = queries_d[:b].contiguous()
        s, i = ft.fused_topk_cuda(q, corpus[n], k, n_valid=n_valid)
        torch.cuda.synchronize()
        max_err = max(max_err, check_against_plain(
            s.cpu().numpy(), i.cpu().numpy(), q, corpus[n], k, n_valid,
            f"kernel N={n} B={b} k={k} n_valid={n_valid}", ft,
            topk_mismatch))
    # rank 10 (the shipped engine.json) takes the scalar load path
    q10 = queries_d[:8, :10].contiguous()
    it10 = items_d[:, :10].contiguous()
    s, i = ft.fused_topk_cuda(q10, it10, 10)
    torch.cuda.synchronize()
    max_err = max(max_err, check_against_plain(
        s.cpu().numpy(), i.cpu().numpy(), q10, it10, 10, None,
        "kernel D=10", ft, topk_mismatch))
    log(f"phase 2 kernel: fused_topk matches the plain version in "
        f"{len(cases) + 1} cases (N in {{{ML25M_ITEMS}, {BIG_ITEMS}}}, "
        f"B in {{1, 8, 64}}, k in {{10, 100, 1000}}, n_valid < N, "
        f"N % 256 != 0, D=10); max |score err| {max_err:.3g} "
        f"(rtol {RTOL}, atol {ATOL})")

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = {}
    for n in (ML25M_ITEMS, BIG_ITEMS):
        for b in (1, 64):
            k = 10
            q = queries_d[:b].contiguous()
            items = corpus[n]
            reps = 50 if n == ML25M_ITEMS else 10
            fns = {"": lambda: ft.fused_topk_cuda(q, items, k),
                   "plain_": lambda: ft.fused_topk_reference(q, items, k),
                   "library_": lambda: torch.topk(q @ items.T, k)}
            row = {}
            for _ in range(2):   # kernel, plain, library; twice, in turns
                for tag, fn in fns.items():
                    row.setdefault(f"{tag}ms", []).append(
                        time_single(fn, reps))
                    row.setdefault(f"{tag}ms_stream", []).append(
                        time_stream(fn, reps))
            row = {name: min(v) for name, v in row.items()}
            if n == ML25M_ITEMS:   # the corpus fits in L2: time it cold too
                row["ms_cold"] = time_single(fns[""], 20,
                                             flush=flush_buf.zero_)
            row["bound_ms"], row["bound_by"] = bound(b, n, RANK, k)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            timings[(n, b, k)] = row
            log("phase 2 timing: " + json.dumps(
                {"N": n, "B": b, "D": RANK, "k": k, "card": card, **row}))
    del flush_buf

    # -- phase 3: training kernels vs their plain versions ----------------
    train_kernel_err = training_kernels_phase(dev, fg, rs, card)
    torch.cuda.empty_cache()

    # -- phase 4: serve at the MovieLens-25M shape ------------------------
    home = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    server = None
    try:
        eng = engine()
        spec = json.loads((_build.CSRC_DIR.parent / "templates" /
                           "recommendation" / "engine.json").read_text())
        spec["algorithms"][0]["params"]["rank"] = RANK
        variant = EngineVariant.from_dict(spec)
        storage = get_storage(home)
        wrapper = wrapper_from_numpy(
            users_np, items_np, [f"u{j}" for j in range(ML25M_USERS)],
            [f"i{j}" for j in range(ML25M_ITEMS)], rank=RANK)
        persist_instance(eng, variant, [wrapper], storage)
        os.environ["PIO_RETRIEVAL_RUNG"] = "chunked"
        server = EngineServer(eng, variant, storage, host="127.0.0.1",
                              port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        users = rng.choice(ML25M_USERS, size=16 + 64, replace=False)
        ft.LAUNCHES = 0                       # main path starts here
        lats, server_ms, answers = [], [], []
        for u in users[:16]:
            t0 = time.perf_counter()
            ans, ms = post_json(f"{base}/queries.json",
                                {"user": f"u{u}", "num": 10})
            lats.append(time.perf_counter() - t0)
            answers.append(ans)
            server_ms.append(ms)
        retrieval_ms = get_registry().get("pio_retrieval_ms")
        n_ret = retrieval_ms.count(rung="chunked")
        ret_mean = retrieval_ms.sum(rung="chunked") / max(n_ret, 1)
        batch_users = users[16:]
        t0 = time.perf_counter()
        batch = server.query_batch([{"user": f"u{u}", "num": 10}
                                    for u in batch_users])
        batch_s = time.perf_counter() - t0
        main_launches = ft.LAUNCHES           # main path ends here
        if main_launches < 17:
            die(f"fused_topk launched {main_launches} times on the main "
                "path; expected one per request and one for the batch")
        err = 0.0
        for u, ans in zip(users[:16], answers):
            s, i = answer_arrays(ans, 10)
            err = max(err, check_against_plain(
                s, i, torch.from_numpy(users_np[[u]]).to(dev), items_d, 10,
                None, f"/queries.json user u{u}", ft, topk_mismatch))
        bs, bi = zip(*(answer_arrays(a, 10) for a in batch))
        err = max(err, check_against_plain(
            np.concatenate(bs), np.concatenate(bi),
            torch.from_numpy(users_np[batch_users]).to(dev), items_d, 10,
            None, "query_batch", ft, topk_mismatch))
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        if 'pio_retrieval_requests_total{rung="chunked",corpus="als"}' \
                not in metrics:
            die("/metrics lacks pio_retrieval_requests_total for the "
                "chunked rung")
        p50_ms = sorted(lats)[len(lats) // 2] * 1e3
        log(f"phase 4 serve: ML-25M shape {ML25M_USERS}x{ML25M_ITEMS} "
            f"rank {RANK}, rung chunked: 16 /queries.json p50 "
            f"{p50_ms:.2f} ms (first {lats[0] * 1e3:.2f} ms, max "
            f"{max(lats) * 1e3:.2f} ms; server-side p50 "
            f"{sorted(server_ms)[8]:.2f} ms; retrieval mean "
            f"{ret_mean:.3f} ms over {n_ret}), sequential "
            f"{16 / sum(lats):.1f} recs/s; query_batch of 64 in "
            f"{batch_s * 1e3:.2f} ms = {64 / batch_s:.1f} recs/s; "
            f"fused_topk launches {main_launches}; max |score err| "
            f"{err:.3g}; card {card}")
        server.stop()
        server = None
        del wrapper

        # -- phase 5: the large catalog routes to chunked unforced -------
        os.environ.pop("PIO_RETRIEVAL_RUNG", None)
        n_users4 = 1024
        wrapper = wrapper_from_numpy(
            users_np[:n_users4], big_np, [f"u{j}" for j in range(n_users4)],
            [f"i{j}" for j in range(BIG_ITEMS)], rank=RANK)
        rung = wrapper.retriever().plan(1, 10).rung
        if rung != "chunked":
            die(f"a {BIG_ITEMS}-item corpus routed to {rung!r}, "
                "expected 'chunked'")
        persist_instance(eng, variant, [wrapper], storage)
        del wrapper
        server = EngineServer(eng, variant, storage, host="127.0.0.1",
                              port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        before = ft.LAUNCHES
        users4 = rng.choice(n_users4, size=8, replace=False)
        lats4 = []
        err4 = 0.0
        for u in users4:
            t0 = time.perf_counter()
            ans, _ = post_json(f"{base}/queries.json",
                               {"user": f"u{u}", "num": 10})
            lats4.append(time.perf_counter() - t0)
            s, i = answer_arrays(ans, 10)
            err4 = max(err4, check_against_plain(
                s, i, torch.from_numpy(users_np[[u]]).to(dev), big_d, 10,
                None, f"large catalog user u{u}", ft, topk_mismatch))
        if ft.LAUNCHES - before != 8:
            die(f"large catalog: {ft.LAUNCHES - before} fused_topk "
                "launches for 8 queries")
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        line = next((ln for ln in metrics.splitlines() if ln.startswith(
            'pio_retrieval_requests_total{rung="chunked",corpus="als"}')),
            "")
        log(f"phase 5 catalog: {BIG_ITEMS} items routed to chunked by "
            f"the default thresholds; 8 /queries.json p50 "
            f"{sorted(lats4)[4] * 1e3:.2f} ms; max |score err| "
            f"{err4:.3g}; {line}")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(home, ignore_errors=True)
    del items_d, big_d, queries_d, big_np
    torch.cuda.empty_cache()

    # -- phase 6: ALS training at the MovieLens-25M shape -----------------
    train = train_phase(dev, args.seed, als, fg, rs, card)
    torch.cuda.empty_cache()

    mods = {
        "fg": fg, "rs": rs, "ft": ft, "gt": gt, "pqs": pqs, "tpq": tpq,
        "retrieval": retrieval, "exp_gram": exp_gram,
        "exp_gather2": exp_gather2, "get_storage": get_storage, "App": App,
        "Event": Event, "DataMap": DataMap, "csrc": _build.CSRC_DIR,
        "EngineVariant": EngineVariant, "engine": engine,
        "RuntimeContext": RuntimeContext, "run_train": run_train,
        "EngineServer": EngineServer, "topk_mismatch": topk_mismatch,
        "get_registry": get_registry, "wrapper_from_numpy": wrapper_from_numpy,
        "persist_instance": persist_instance,
    }
    home = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    try:
        # -- phase 7: events → run_train → deploy → /queries.json ---------
        dase = dase_phase(dev, args.seed, home, mods, card)
        dase_topk = dase["fused_topk"]
        torch.cuda.empty_cache()

        # -- phase 8: the PQ scan kernel vs its plain version --------------
        pq_err, pq_rows = pq_kernel_phase(dev, args.seed, pqs, tpq,
                                          topk_mismatch, card)

        # -- phase 9: the gather experiments' kernels ----------------------
        gather_rows = gather_kernels_phase(dev, args.seed, mods, card)

        # -- phase 10: a 1,048,576-item catalog on the PQ rungs ------------
        pq_serve = pq_serve_phase(args.seed, home, users_np, mods, card)
        torch.cuda.empty_cache()

        # -- phase 11: phase 7's events trained again with PQ codes --------
        pq_dase = pq_dase_phase(dase, mods, card)
        del dase
    finally:
        shutil.rmtree(home, ignore_errors=True)

    # -- phase 12: report --------------------------------------------------
    main_shape = timings[(ML25M_ITEMS, 1, 10)]
    kernels = [{
        "name": "fused_topk",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/pallas_kernels.py:444",
        "launches": main_launches,
        "max_abs_err": max(max_err, err, err4),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]
    replaces = {"fused_gram": "predictionio_tpu/ops/pallas_kernels.py:135",
                "ridge_solve_lu": "predictionio_tpu/ops/pallas_kernels.py:358",
                "ridge_solve_gj": "predictionio_tpu/ops/pallas_kernels.py:300"}
    for name, where in replaces.items():
        row = train["per_iter"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "predictionio_tpu_torch/csrc/" + (
                "fused_gram.cu" if name == "fused_gram" else
                "ridge_solve.cu"),
            "replaces": where,
            "launches": train["launches"][name],
            "max_abs_err": train_kernel_err[name],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    pq_main = pq_rows[1]     # B = 1: the shape of one pq_flat request
    kernels.append({
        "name": "pq_scan",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/pq_scan.cu",
        "replaces": "predictionio_tpu/ops/pallas_kernels.py:592",
        "launches": pq_serve["launches"] + pq_dase["launches"],
        "max_abs_err": pq_err,
        "ms": pq_main["ms"],
        "plain_ms": pq_main["plain_ms"],
        "bound_ms": pq_main["bound_ms"],
        "bound_by": pq_main["bound_by"],
        "library_ms": pq_main["library_ms"],
    })
    for name, source, where in (
            ("gather_gram", "fused_gram.cu", "tools/exp_gram.py:90"),
            ("gather_sum", "gather_sum.cu", "tools/exp_gather2.py:69")):
        row = gather_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "predictionio_tpu_torch/csrc/" + source,
            "replaces": where,
            "launches": row["launches"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    log(f"launches: pq_scan {pq_serve['launches']} on the PQ serve path "
        f"(phase 10) + {pq_dase['launches']} on the DASE+PQ path (phase "
        f"11), timed at B = 1 (one pq_flat request's shape); gather_gram "
        f"and gather_sum per their tools' entry points (phase 9)")
    log(f"launches: fused_topk {main_launches} on the serve path, "
        f"{dase_topk} on the DASE path; training kernels per the train "
        f"run (fused_gram, ridge_solve_lu) and the solver='gj' run "
        f"(ridge_solve_gj); timings of the training kernels are over one "
        f"iteration's calls at the ML-25M shape")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
