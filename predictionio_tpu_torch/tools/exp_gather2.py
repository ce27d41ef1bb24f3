"""Gather mechanism shootout, on the card.

Port of ``tools/exp_gather2.py``: the same shapes (I 59,047 rows of
rank 64, R 20,000 × L 256 Zipf(1.25) indices from numpy
``default_rng(0)``), the same sections and the same printed rows.  The
reference's XLA rows are the plain PyTorch gather + sum here
(``ops.gather.gather_sum_reference``); its Pallas modes ``take``,
``loop8`` and ``loop`` are three TPU spellings of one function, so any of
them selects the one kernel row, kernel T2 (``ops.gather.gather_sum``).
Times are CUDA events over back-to-back calls, not a ``fori_loop`` slope.

``dist`` times the kernel at the tool's shape under four index
distributions (``DISTRIBUTIONS``): the tool's Zipf, the same clipped to
the 2,048 hottest rows (``idx_head``), every index 0 (each gather hits
one row: the load-issue and L1 limit), and uniform over [0, I) (most
gathers miss L1 and come from L2).  Where Zipf reads like all-zero, the
kernel is bound by L1 and load issue; where it reads like uniform, by L2.
Each row also times every design of ``ops.gather.DESIGNS`` forced.
``variants`` times edited copies of ``csrc/gather_sum.cu``
(``VARIANTS``: indices a round, row loads in flight, the register cap
that sets blocks an SM)
against the package's vec4 design under the same four distributions.

    python -m predictionio_tpu_torch.tools.exp_gather2 [xla] [take] [loop8]
        [loop] [dist] [variants]
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops import gather as gt
from predictionio_tpu_torch.tools import (cuda_ms, edited_libraries,
                                          require_cuda, single_ms)

I, K = 59_047, 64
R, L = 20_000, 256
NNZ = R * L
KERNEL_MODES = ("take", "loop8", "loop")
DISTRIBUTIONS = ("zipf", "head", "zero", "uniform")
# T2's vec4 design: edits (old text -> new) of a copy of csrc/gather_sum.cu
VARIANTS = {
    "vec4": {},
    "round8": {"kIdxRound = 16;": "kIdxRound = 8;"},
    "round32": {"kIdxRound = 16;": "kIdxRound = 32;"},
    "flight8": {"kInFlight = 4;": "kInFlight = 8;"},   # spills at 48
    "blocks4": {"kVec4BlocksPerSM = 5;": "kVec4BlocksPerSM = 4;"},
    "blocks6": {"kVec4BlocksPerSM = 5;": "kVec4BlocksPerSM = 6;"},
}


def make_inputs(dev: torch.device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The tool's seeded inputs on ``dev``: Y [I, K] standard normal
    (float32 and bfloat16), idx [R, L] Zipf(1.25) mod I, and idx_head,
    the same indices clipped to the 2,048 hottest rows."""
    rng = np.random.default_rng(seed)
    y32 = torch.from_numpy(rng.standard_normal((I, K), dtype=np.float32))
    idx = torch.from_numpy((rng.zipf(1.25, size=(R, L)) % I)
                           .astype(np.int32))
    t = {"y32": y32.to(dev), "idx": idx.to(dev)}
    t["y16"] = t["y32"].bfloat16()
    t["idx_head"] = torch.clamp(t["idx"], max=2047)
    return t


def distributions(t: Dict[str, torch.Tensor], seed: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """The [R, L] index sets of ``DISTRIBUTIONS``, on the device of
    ``t``."""
    dev = t["idx"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return {"zipf": t["idx"], "head": t["idx_head"],
            "zero": torch.zeros_like(t["idx"]),
            "uniform": torch.randint(0, I, (R, L), generator=gen,
                                     device=dev, dtype=torch.int32)}


def main(argv: Optional[List[str]] = None) -> None:
    which = (sys.argv[1:] if argv is None else list(argv)) \
        or ["xla", "take", "loop8"]
    dev = require_cuda()
    t = make_inputs(dev)
    if "xla" in which:
        for name, y, ix, elem in (("f32 zipf ", t["y32"], t["idx"], 4),
                                  ("bf16 zipf", t["y16"], t["idx"], 2),
                                  ("f32 head ", t["y32"], t["idx_head"], 4)):
            ms = cuda_ms(lambda: gt.gather_sum_reference(y, ix))
            print(f"torch {name}: {ms:8.2f} ms  "
                  f"{NNZ*K*elem/ms/1e6:7.1f} GB/s {NNZ/ms/1e6:6.2f} Gnnz/s")
    if any(mode in which for mode in KERNEL_MODES):
        ms = cuda_ms(lambda: gt.gather_sum_cuda(t["y32"], t["idx"]))
        print(f"cuda T2 f32  : {ms:8.2f} ms  {NNZ*K*4/ms/1e6:7.1f} GB/s "
              f"{NNZ/ms/1e6:6.2f} Gnnz/s")
    if "dist" in which:
        card = torch.cuda.get_device_name(dev)
        for name, ix in distributions(t).items():
            out = {"dist": name, "card": card, "I": I, "K": K, "R": R,
                   "L": L, "distinct_rows": int(torch.unique(ix).numel())}
            out["ms"] = single_ms(lambda: gt.gather_sum_cuda(t["y32"], ix),
                                  20)
            for design in getattr(gt, "DESIGNS", ()):
                out[f"ms_{design}"] = single_ms(
                    lambda: gt.gather_sum_cuda(t["y32"], ix, design=design),
                    20)
            out["gather_bytes_per_s"] = NNZ * K * 4 / out["ms"] * 1e3
            print("dist: " + json.dumps(out), flush=True)
    if "variants" in which:
        libs = {name: gt.bind(lib) for name, lib in edited_libraries(
            "gather_sum", VARIANTS, report="vec4").items()}
        y = t["y32"]

        def run(lib, ix):
            out = torch.empty((R, K), dtype=torch.float32, device=dev)
            rc = lib.pio_gather_sum(y.data_ptr(), ix.data_ptr(), R, L, K, 1,
                                    out.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"T2 variant launch failed (code {rc})")
            return out

        for name, ix in distributions(t).items():
            want = gt.gather_sum_cuda(y, ix)
            out = {"dist": name}
            for v, lib in libs.items():
                if not torch.equal(run(lib, ix), want):
                    raise RuntimeError(f"T2 variant {v} differs from the "
                                       f"package's vec4 design")
                out[v] = single_ms(lambda: run(lib, ix), 20)
            print("variants: " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
