"""Micro-experiments on the card, ports of the reference's ``tools/`` scratch
experiments.  Each runs as ``python -m predictionio_tpu_torch.tools.<name>
[section ...]``, needs an NVIDIA card, and builds its inputs inside
``main()``, never at import.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_ms", "require_cuda"]


def require_cuda() -> torch.device:
    """The CUDA card; raises when there is none (the tools time the card
    and have no CPU mode)."""
    if not torch.cuda.is_available():
        raise RuntimeError("this tool times kernels on an NVIDIA card and "
                           "CUDA is not available")
    return torch.device("cuda")


def cuda_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3
            ) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, between
    two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps
