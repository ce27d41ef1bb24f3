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
2. kernel  — each kernel against its plain PyTorch version on the card
   (float32, TF32 off), then CUDA-event timings of kernel, plain version,
   one library call as a yardstick, and the least time the card could
   take (bound).
3. serve   — the ALS recommendation template at the MovieLens-25M shape
   (162,541 users x 59,047 items, rank 64, seeded random factors) carried
   in with wrapper_from_numpy, persisted, deployed on an EngineServer
   with PIO_RETRIEVAL_RUNG=chunked, asked 16 /queries.json over HTTP and
   one 64-user query_batch; every answer is held against the plain top-k
   on the card, and the fused top-k kernel must have launched.
4. catalog — a 4,194,304-item corpus with no rung forced: the router's
   own thresholds must pick the chunked rung; 8 queries, checked as in 3.
5. report  — one JSON line of per-kernel numbers, the card's name and
   power limit, and the final status line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

RTOL = 1e-5   # float32 sums in another order than the plain matmul
ATOL = 1e-5
RANK = 64
ML25M_USERS, ML25M_ITEMS = 162_541, 59_047
BIG_ITEMS = 4_194_304
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


def time_single(fn, reps: int, flush=None) -> float:
    """Median device ms of single calls, each between its own CUDA
    events.  A spin kernel queued first keeps the card busy while the
    host enqueues the call, so the events see the call's kernels (and
    the gaps between them), not the host's enqueue time.  With ``flush``
    (a callable that evicts L2) each call starts cold."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
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
        from predictionio_tpu_torch.controller import EngineVariant
        from predictionio_tpu_torch.data.storage import get_storage
        from predictionio_tpu_torch.device import set_float32_precision
        from predictionio_tpu_torch.obs import get_registry
        from predictionio_tpu_torch.ops import _build
        from predictionio_tpu_torch.ops import fused_topk as ft
        from predictionio_tpu_torch.ops.topk import topk_mismatch
        from predictionio_tpu_torch.server.engine_server import EngineServer
        from predictionio_tpu_torch.templates.recommendation import (
            engine, wrapper_from_numpy)
        from predictionio_tpu_torch.workflow.core_workflow import (
            persist_instance)
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

    # -- phase 3: serve at the MovieLens-25M shape ------------------------
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
        log(f"phase 3 serve: ML-25M shape {ML25M_USERS}x{ML25M_ITEMS} "
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

        # -- phase 4: the large catalog routes to chunked unforced -------
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
        log(f"phase 4 catalog: {BIG_ITEMS} items routed to chunked by "
            f"the default thresholds; 8 /queries.json p50 "
            f"{sorted(lats4)[4] * 1e3:.2f} ms; max |score err| "
            f"{err4:.3g}; {line}")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(home, ignore_errors=True)

    # -- phase 5: report ---------------------------------------------------
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
