"""Training supervision: the divergence error and the finiteness check.

Port of ``TrainDiverged`` and ``all_finite`` from
``predictionio_tpu/resilience/supervision.py``.  The reference walks a
pytree with ``jax.tree_util``; the port takes tensors, numpy arrays,
floats, and (nested) lists, tuples and dicts of them.  A tensor is
reduced where it lives, so only one boolean crosses to the host.
Rollback, the step watchdog and preemption arrive with the checkpoint
slice.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

__all__ = ["TrainDiverged", "all_finite"]


class TrainDiverged(RuntimeError):
    """Training produced non-finite state and exhausted its rollbacks."""

    def __init__(self, fn: str, step: int, what: str, rollbacks: int):
        super().__init__(
            f"{fn} training diverged at step {step} ({what}) after "
            f"{rollbacks} rollback(s) to the last-good checkpoint; the "
            "non-finite model was NOT persisted.  Lower the learning "
            "rate or inspect the data for this window.")
        self.fn = fn
        self.step = step
        self.rollbacks = rollbacks


def all_finite(tree: Any) -> bool:
    """Every floating-point leaf of ``tree`` is finite."""
    if isinstance(tree, torch.Tensor):
        if not (tree.is_floating_point() or tree.is_complex()):
            return True
        return bool(torch.isfinite(tree).all())
    if isinstance(tree, np.ndarray):
        if not np.issubdtype(tree.dtype, np.inexact):
            return True
        return bool(np.isfinite(tree).all())
    if isinstance(tree, float):
        return math.isfinite(tree)
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    return True
