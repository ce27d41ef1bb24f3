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
8. report  — one JSON line of per-kernel numbers, the card's name and
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
SPIN_CYCLES = 4_000_000     # ~2 ms of device spin: covers any host enqueue


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


def dase_phase(dev, seed: int, home: str, mods: dict, card: str) -> int:
    """Phase 7: events → run_train → deploy → /queries.json on the card.
    Returns the K3 launches of the phase."""
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
    return counts["fused_topk"]


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
        from predictionio_tpu_torch.ops import ridge_solve as rs
        from predictionio_tpu_torch.ops.topk import topk_mismatch
        from predictionio_tpu_torch.server.engine_server import EngineServer
        from predictionio_tpu_torch.templates.recommendation import (
            engine, wrapper_from_numpy)
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

    # -- phase 7: events → run_train → deploy → /queries.json -------------
    home = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    try:
        dase_topk = dase_phase(dev, args.seed, home, {
            "fg": fg, "rs": rs, "ft": ft, "get_storage": get_storage,
            "App": App, "Event": Event, "DataMap": DataMap,
            "csrc": _build.CSRC_DIR, "EngineVariant": EngineVariant,
            "engine": engine, "RuntimeContext": RuntimeContext,
            "run_train": run_train, "EngineServer": EngineServer,
            "topk_mismatch": topk_mismatch, "get_registry": get_registry,
        }, card)
    finally:
        shutil.rmtree(home, ignore_errors=True)

    # -- phase 8: report ---------------------------------------------------
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
