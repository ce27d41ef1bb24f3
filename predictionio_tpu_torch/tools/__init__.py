"""Micro-experiments on the card, ports of the reference's ``tools/`` scratch
experiments.  Each runs as ``python -m predictionio_tpu_torch.tools.<name>
[section ...]``, needs an NVIDIA card, and builds its inputs inside
``main()``, never at import.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_ms", "require_cuda", "single_ms"]


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


def single_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """Median device ms of single calls of ``fn``, each between its own
    CUDA events, after one warm-up call; a spin kernel queued ahead of
    each call hides the host's enqueue."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]
