"""Micro-experiments for the ALS gather + Gram build, on the card.

Port of ``tools/exp_gram.py``: the same shapes (I 59,047 items of rank
64; one user bucket of R 20,000 rows × L 256 slots, Zipf(1.25) indices
from numpy ``default_rng(0)``), the same sections and the same printed
rows.  The reference's XLA rows are plain PyTorch here; its Pallas row
(``pallas_vmem_gather_gram``) is kernel T1, ``ops.fused_gram.gather_gram``.
Times are CUDA events over back-to-back calls, not a ``fori_loop`` slope.

    python -m predictionio_tpu_torch.tools.exp_gram [gather] [gram] [fused] [pallas]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.tools import cuda_ms, require_cuda

I, K = 59_047, 64
R, L = 20_000, 256          # one representative user bucket: 5.1M nnz slots
NNZ = R * L
GB = NNZ * K * 4 / 1e9
GF = 2 * NNZ * K * K / 1e9
SECTIONS = ("gather", "gram", "fused", "pallas")


def make_inputs(dev: torch.device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The tool's seeded inputs on ``dev``: Y [I, K] standard normal,
    idx [R, L] Zipf(1.25) mod I (and each row sorted), w [R, L]
    uniform."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((I, K), dtype=np.float32)
    idx = (rng.zipf(1.25, size=(R, L)) % I).astype(np.int32)
    w = rng.random((R, L), dtype=np.float32)
    t = {name: torch.from_numpy(a).to(dev)
         for name, a in (("y", y), ("idx", idx), ("w", w))}
    t["idx_sorted"] = torch.sort(t["idx"], dim=1).values.contiguous()
    return t


def main(argv: Optional[List[str]] = None) -> None:
    which = (sys.argv[1:] if argv is None else list(argv)) or list(SECTIONS)
    dev = require_cuda()
    t = make_inputs(dev)
    y, idx, idx_sorted, w = t["y"], t["idx"], t["idx_sorted"], t["w"]

    def gathered(ix):
        return y.index_select(0, ix.reshape(-1).long()).reshape(R, L, K)

    if "gather" in which:
        ms = cuda_ms(lambda: gathered(idx))
        print(f"gather zipf      : {ms:8.2f} ms  {GB/ms*1e3:7.1f} GB/s")
        ms = cuda_ms(lambda: gathered(idx_sorted))
        print(f"gather sorted    : {ms:8.2f} ms  {GB/ms*1e3:7.1f} GB/s")
    if "gram" in which:
        g = gathered(idx) * w[..., None]
        ms = cuda_ms(lambda: torch.bmm(g.mT, g))
        print(f"gram mat f32     : {ms:8.2f} ms  {GF/ms*1e3/1e3:7.2f} TF/s")
        gb = g.bfloat16()
        ms = cuda_ms(lambda: torch.bmm(gb.mT, gb))
        print(f"gram mat bf16    : {ms:8.2f} ms  {GF/ms*1e3/1e3:7.2f} TF/s")
        del g, gb
    if "fused" in which:
        def fused(ix, dtype):
            g = (gathered(ix) * w[..., None]).to(dtype)
            return torch.bmm(g.mT, g)

        ms = cuda_ms(lambda: fused(idx, torch.float32))
        print(f"gather+gram f32  : {ms:8.2f} ms  {GF/ms*1e3/1e3:7.2f} TF/s")
        ms = cuda_ms(lambda: fused(idx, torch.bfloat16))
        print(f"gather+gram bf16 : {ms:8.2f} ms  {GF/ms*1e3/1e3:7.2f} TF/s")
        ms = cuda_ms(lambda: fused(idx_sorted, torch.float32))
        print(f"gather+gram srt32: {ms:8.2f} ms  {GF/ms*1e3/1e3:7.2f} TF/s")
    if "pallas" in which:
        ms = cuda_ms(lambda: fg.gather_gram_cuda(y, idx, w))
        print(f"cuda T1 gthr-gram: {ms:8.2f} ms  {GF/ms*1e3/1e3:7.2f} TF/s "
              f"({NNZ/ms*1e3/1e9:5.2f} Gnnz/s)")


if __name__ == "__main__":
    main()
