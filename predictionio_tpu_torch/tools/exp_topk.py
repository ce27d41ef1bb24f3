"""The fused top-k (K3) split into its kernels, on the card.

    python -m predictionio_tpu_torch.tools.exp_topk [passes] [blocks] [routes] [variants]

Inputs: two corpora of seeded random rank-64 rows (standard normal / 8),
N = 59,047 (the ML-25M catalog) and N = 4,194,304 (``chip_smoke.py``'s
large catalog), and 128 queries drawn the same way; k = 10.

``passes`` times one ``fused_topk_cuda`` call (``tools.single_ms``: the
median of single calls between CUDA events) for each B of ``BATCHES``
at both N, splits its device time by kernel with ``torch.profiler``
(mean device ms a call of each kernel: the score pass and the merge
pass), and prints the plan, ``torch.topk(q @ itemsᵀ)`` as the library
yardstick and the bound.  ``blocks`` does the same at B = 64 with the
plan's target block count (the module constant ``TARGET_BLOCKS``)
multiplied by each of ``BLOCK_FACTORS`` in turn.  ``routes`` times every B of ``ROUTE_BATCHES``
at each D of ``ROUTE_RANKS`` (the first D columns) on both score
passes, under ``small_plan`` and then ``tiled_plan``: the sweep that
places the crossover ``TILED_MIN_BATCH``.  ``variants`` times edited
copies of ``csrc/fused_topk.cu`` (``VARIANTS``) on the tiled route at
``VARIANT_BATCHES``, each held to the package's answers except the
diagnostic ``no_select`` (the score loop and copy ring alone, its
answers unused).  The tool changes module constants of the imported
package for the length of a section only; the package reads no setting
of its own.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.tools import (edited_libraries, require_cuda,
                                          single_ms)
from predictionio_tpu_torch.tools.exp_pq import kernel_ms

NS = (59_047, 4_194_304)
RANK, K = 64, 10
BATCHES = (1, 8, 16, 32, 64, 128)
BLOCK_FACTORS = (0.5, 1, 2, 4)
ROUTE_BATCHES = (1, 2, 4, 8, 16, 32, 64)
ROUTE_RANKS = (64, 10)        # the catalog's rank, and every engine.json's
VARIANT_BATCHES = (16, 64)
SECTIONS = ("passes", "blocks", "routes", "variants")
# The tiled route: edits (old text -> new) of a copy of csrc/fused_topk.cu
VARIANTS = {
    "package": {},
    "unroll2": {"#pragma unroll 4\n    for (int d = 0; d < d4; d += 4)":
                "#pragma unroll 2\n    for (int d = 0; d < d4; d += 4)"},
    "one_block": {"__launch_bounds__(kThreads, 2)\ntopk_tiled_pass":
                  "__launch_bounds__(kThreads, 1)\ntopk_tiled_pass"},
    "no_select": {
        "    offer_block<TQ * TI, TI, QG>(acc, id, valid, sel, qrow);":
            "    float m = acc[0];\n"
            "    for (int u = 1; u < TQ * TI; ++u) m = fmaxf(m, acc[u]);\n"
            "    if (m == 1234.5f && valid) thr_s[0] = m;"},
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


def bound_ms(b: int, n: int, d: int, k: int) -> float:
    """The larger of the call's bytes (corpus, queries, answers) over the
    memory rate and its 2·B·N·D float32 flops over the float32 peak."""
    return max((4 * n * d + 4 * b * d + 8 * b * k) / HBM_BYTES_PER_S,
               2.0 * b * n * d / FP32_FLOPS) * 1e3


def inputs(dev: torch.device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """{"q": [128, 64] queries, N: [N, 64] corpus for each N} from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"q": torch.randn((max(BATCHES), RANK), generator=gen,
                            device=dev) / 8}
    for n in NS:
        out[n] = torch.randn((n, RANK), generator=gen, device=dev) / 8
    return out


def row(q: torch.Tensor, items: torch.Tensor, library: bool = True) -> dict:
    b, n = q.shape[0], items.shape[0]
    reps = 20 if n < 10 ** 6 else 5
    fn = lambda: ft.fused_topk_cuda(q, items, K)   # noqa: E731
    p = ft.plan(b, n, RANK, K)
    out = {"B": b, "N": n, "k": K, "ms": single_ms(fn, reps),
           "by_kernel": kernel_ms(fn, reps),
           "plan": {f: getattr(p, f) for f in p.__dataclass_fields__},
           "bound_ms": bound_ms(b, n, RANK, K)}
    if library:
        out["library_ms"] = single_ms(lambda: torch.topk(q @ items.T, K),
                                      reps)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    which = (sys.argv[1:] if argv is None else list(argv)) or list(SECTIONS)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    t = inputs(dev)
    card = torch.cuda.get_device_name(dev)
    if "passes" in which:
        for n in NS:
            for b in BATCHES:
                print("passes: " + json.dumps(
                    {"card": card, **row(t["q"][:b].contiguous(), t[n])}),
                    flush=True)
    if "blocks" in which:
        saved = ft.TARGET_BLOCKS
        try:
            for factor in BLOCK_FACTORS:
                ft.TARGET_BLOCKS = int(saved * factor)
                for n in NS:
                    print("blocks: " + json.dumps(
                        {"factor": factor, "TARGET_BLOCKS": ft.TARGET_BLOCKS,
                         **row(t["q"][:64].contiguous(), t[n], False)}),
                        flush=True)
        finally:
            ft.TARGET_BLOCKS = saved
    if "routes" in which:
        lib = ft.bind(_build.load("fused_topk"))
        for n in NS:
            for d in ROUTE_RANKS:
                items = t[n][:, :d].contiguous()
                for b in ROUTE_BATCHES:
                    q = t["q"][:b, :d].contiguous()
                    out = {"B": b, "N": n, "D": d,
                           "tiled": ft.plan(b, n, d, K).tiled,
                           "bound_ms": bound_ms(b, n, d, K)}
                    for route, p in (("small", ft.small_plan(b, n, d, K)),
                                     ("tiled", ft.tiled_plan(b, n, d, K))):
                        out[f"{route}_ms"] = single_ms(
                            lambda: ft.launch(lib, q, items, K, n, p),
                            20 if n < 10 ** 6 else 5)
                    print("routes: " + json.dumps({"card": card, **out}),
                          flush=True)
                del items
    if "variants" in which:
        libs = {name: ft.bind(lib) for name, lib in edited_libraries(
            "fused_topk", VARIANTS, report="tiled").items()}
        for n in NS:
            for b in VARIANT_BATCHES:
                q = t["q"][:b].contiguous()
                p = ft.plan(b, n, RANK, K)
                want = ft.fused_topk_cuda(q, t[n], K)
                out = {"B": b, "N": n, "bound_ms": bound_ms(b, n, RANK, K)}
                for name, lib in libs.items():
                    fn = lambda: ft.launch(lib, q, t[n], K, n, p)  # noqa
                    got = fn()
                    if name != "no_select" and not all(
                            torch.equal(g, w) for g, w in zip(got, want)):
                        raise RuntimeError(f"K3 variant {name} differs from "
                                           f"the package's answers")
                    out[name] = single_ms(fn, 20 if n < 10 ** 6 else 5)
                print("variants: " + json.dumps({"card": card, **out}),
                      flush=True)


if __name__ == "__main__":
    main()
