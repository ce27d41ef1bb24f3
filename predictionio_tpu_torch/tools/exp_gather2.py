"""Gather mechanism shootout, on the card.

Port of ``tools/exp_gather2.py``: the same shapes (I 59,047 rows of
rank 64, R 20,000 × L 256 Zipf(1.25) indices from numpy
``default_rng(0)``), the same sections and the same printed rows.  The
reference's XLA rows are the plain PyTorch gather + sum here
(``ops.gather.gather_sum_reference``); its Pallas modes ``take``,
``loop8`` and ``loop`` are three TPU spellings of one function, so any of
them selects the one kernel row, kernel T2 (``ops.gather.gather_sum``).
Times are CUDA events over back-to-back calls, not a ``fori_loop`` slope.

    python -m predictionio_tpu_torch.tools.exp_gather2 [xla] [take] [loop8] [loop]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops import gather as gt
from predictionio_tpu_torch.tools import cuda_ms, require_cuda

I, K = 59_047, 64
R, L = 20_000, 256
NNZ = R * L
KERNEL_MODES = ("take", "loop8", "loop")


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


if __name__ == "__main__":
    main()
