"""The PQ scan (K5) split into its kernels, on the card.

    python -m predictionio_tpu_torch.tools.exp_pq [split] [chunks] [queries]

Inputs as ``chip_smoke.py`` phase 8 times them: 1,048,576 items, S = 17
tables (the coarse table and M = 16 subspaces of a rank-64 codebook), k
= 40 (one ``pq_flat`` request's shortlist), seeded random codes and
codebooks, the tables of B = 1 and B = 64 random queries.

``split`` times one ``pq_scan_cuda`` call (``tools.single_ms``: the
median of 20 single calls between CUDA events) and splits its device time by kernel with ``torch.profiler``
(mean device ms a call of each kernel it launched).  ``chunks`` does
the same with the plan's target block count (``pq_scan.TARGET_BLOCKS``)
set to each of ``CHUNK_TARGETS`` in turn, which moves the work between
the score pass and the merge; ``queries`` at B = 64 with the most
queries a block takes (``pq_scan.MAX_QUERIES_PER_BLOCK``) set to each of
``QUERY_CAPS``: fewer queries a block read the codes more often from L2
but leave shared memory for more blocks an SM.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Callable, Dict, List, Optional

import torch

from predictionio_tpu_torch.ops import pq_scan as pqs
from predictionio_tpu_torch.retrieval import pq as tpq
from predictionio_tpu_torch.tools import require_cuda, single_ms

N, S, K = 1_048_576, 17, 40
RANK = 64
BATCHES = (1, 64)
CHUNK_TARGETS = (66, 132, 264, 528, 1056)
QUERY_CAPS = (2, 4, 8)
SECTIONS = ("split", "chunks", "queries")


def kernel_ms(fn: Callable[[], object], reps: int = 20) -> Dict[str, float]:
    """Mean device ms a call of each kernel that ``fn`` launches, by the
    kernel's name, from ``torch.profiler`` over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        key = ev.key.replace("(anonymous namespace)::", "")
        found = re.search(r"(\w+(?:<[^()]*>)?)\(", key)
        name = found.group(1) if found else key
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def inputs(dev: torch.device, seed: int = 0):
    """(codes [S, N] uint8, {B: tables [B, S, 256]}) from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = S - 1
    codes = torch.randint(0, 256, (S, N), generator=gen, device=dev,
                          dtype=torch.uint8)
    coarse = torch.randn((256, RANK), generator=gen, device=dev) / 8
    books = torch.randn((m, 256, RANK // m), generator=gen, device=dev) / 8
    queries = torch.randn((max(BATCHES), RANK), generator=gen,
                          device=dev) / 8
    luts = {b: tpq.device_luts(queries[:b].contiguous(), coarse, books)
            for b in BATCHES}
    return codes, luts


def row(codes, luts) -> dict:
    fn = lambda: pqs.pq_scan_cuda(luts, codes, K)   # noqa: E731
    p = pqs.plan(luts.shape[0], N, S, K)
    return {"B": luts.shape[0], "ms": single_ms(fn, 20),
            "by_kernel": kernel_ms(fn),
            "plan": {"queries_per_block": p.queries_per_block,
                     "n_chunks": p.n_chunks,
                     "rows_per_chunk": p.rows_per_chunk,
                     "buffer": p.buffer}}


def main(argv: Optional[List[str]] = None) -> None:
    which = (sys.argv[1:] if argv is None else list(argv)) or list(SECTIONS)
    dev = require_cuda()
    codes, luts = inputs(dev)
    card = torch.cuda.get_device_name(dev)
    if "split" in which:
        for b in BATCHES:
            print("split: " + json.dumps({"card": card, "N": N, "S": S,
                                          "k": K, **row(codes, luts[b])}))
    if "chunks" in which:
        saved = pqs.TARGET_BLOCKS
        try:
            for target in CHUNK_TARGETS:
                pqs.TARGET_BLOCKS = target
                for b in BATCHES:
                    print("chunks: " + json.dumps(
                        {"target_blocks": target, **row(codes, luts[b])}))
        finally:
            pqs.TARGET_BLOCKS = saved
    if "queries" in which:
        saved = pqs.MAX_QUERIES_PER_BLOCK
        try:
            for cap in QUERY_CAPS:
                pqs.MAX_QUERIES_PER_BLOCK = cap
                print("queries: " + json.dumps(
                    {"max_queries_per_block": cap,
                     **row(codes, luts[max(BATCHES)])}))
        finally:
            pqs.MAX_QUERIES_PER_BLOCK = saved


if __name__ == "__main__":
    main()
