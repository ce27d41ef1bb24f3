"""Run supervision: the divergence and preemption errors, the
finiteness checks, and the reload's model validation.

Port of the parts of ``predictionio_tpu/resilience/supervision.py`` that
the port's paths use: ``TrainDiverged`` and ``all_finite`` (training),
``TrainPreempted`` with :data:`PREEMPTED_EXIT_CODE` and the process-wide
preemption flag (``pio train --follow`` stops on it), and
``ModelValidationError`` / :func:`iter_model_arrays` /
:func:`validate_model_finite` — the finite-params gate of the engine
server's staged reload.  The reference walks pytrees with
``jax.tree_util`` and reads each leaf's dtype through ``np.dtype``; the
port takes tensors, numpy arrays, floats, and (nested) lists, tuples and
dicts of them.  A tensor is reduced where it lives, so one boolean
crosses to the host; integer leaves (PQ codes, IVF lists) are skipped.
The step watchdog and the divergence guard's rollback arrive with the
checkpoint slice.
"""

from __future__ import annotations

import logging
import math
import signal
import threading
from typing import Any, Iterator, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "PREEMPTED_EXIT_CODE",
    "TrainDiverged",
    "TrainPreempted",
    "ModelValidationError",
    "install_preemption_handler",
    "request_preemption",
    "preemption_requested",
    "clear_preemption",
    "all_finite",
    "iter_model_arrays",
    "validate_model_finite",
]

# Exit code `pio train` uses after a SIGTERM-triggered preemption:
# 128 + SIGTERM, the code a supervisor already expects from a
# terminated process.
PREEMPTED_EXIT_CODE = 143


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


class TrainPreempted(RuntimeError):
    """SIGTERM during training: the run handed back.

    ``checkpointed`` says whether a resume point exists (False when the
    run had no checkpoint directory — the rerun then starts fresh)."""

    def __init__(self, fn: str, step: int, checkpointed: bool):
        how = ("final checkpoint written — a rerun resumes from it"
               if checkpointed else
               "no checkpoint dir — a rerun restarts from scratch")
        super().__init__(
            f"{fn} training preempted at step {step} ({how}).")
        self.fn = fn
        self.step = step
        self.checkpointed = checkpointed


class ModelValidationError(RuntimeError):
    """A candidate model failed reload validation (finite check/canary)."""


# -- preemption flag ---------------------------------------------------------

_preempted = threading.Event()


def request_preemption() -> None:
    """Ask the running training loops to hand back."""
    _preempted.set()


def preemption_requested() -> bool:
    return _preempted.is_set()


def clear_preemption() -> None:
    _preempted.clear()


def install_preemption_handler() -> bool:
    """SIGTERM → preemption flag (idempotent; False off the main thread).
    SIGINT keeps its KeyboardInterrupt semantics."""

    def _handler(signum, frame):
        logger.warning("SIGTERM: preemption requested — training will "
                       "hand back at the next step boundary and exit %d",
                       PREEMPTED_EXIT_CODE)
        request_preemption()

    try:
        signal.signal(signal.SIGTERM, _handler)
        return True
    except (ValueError, OSError):  # non-main thread / exotic platform
        return False


# -- finiteness --------------------------------------------------------------

def _leaf_finite(x: Any) -> bool:
    """True when ``x`` is not a non-finite float tensor/array/scalar."""
    if isinstance(x, torch.Tensor):
        if not (x.is_floating_point() or x.is_complex()):
            return True
        # Reduced where it lives: one boolean crosses to the host.
        return bool(torch.isfinite(x).all())
    if isinstance(x, np.ndarray):
        if not np.issubdtype(x.dtype, np.inexact):
            return True
        return bool(np.isfinite(x).all())
    if isinstance(x, (float, np.floating)):
        return math.isfinite(float(x))
    return True


def all_finite(tree: Any) -> bool:
    """Every floating-point leaf of ``tree`` is finite."""
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    return _leaf_finite(tree)


_ATOMIC = (str, bytes, bool, int, float, complex, type(None))


def iter_model_arrays(obj: Any, max_depth: int = 6,
                      _path: str = "model") -> Iterator[Tuple[str, Any]]:
    """Yield ``(path, array)`` for every tensor or numpy array (or
    numpy scalar) reachable
    inside an arbitrary model object (dataclasses, dicts, sequences,
    plain ``__dict__`` objects), bounded by ``max_depth``.  Attributes
    starting with ``_`` (transient serving state) are not walked."""
    if max_depth < 0 or isinstance(obj, _ATOMIC):
        return
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        yield _path, obj
        return
    # Atomic children are filtered BEFORE any path-string formatting: a
    # model holding a large plain dict (str → score) costs one
    # isinstance per entry here, not a formatted path per entry.
    if isinstance(obj, dict):
        items = ((f"{_path}[{k!r}]", v) for k, v in obj.items()
                 if not isinstance(v, _ATOMIC))
    elif isinstance(obj, (list, tuple)):
        items = ((f"{_path}[{i}]", v) for i, v in enumerate(obj)
                 if not isinstance(v, _ATOMIC))
    elif hasattr(obj, "__dict__"):
        items = ((f"{_path}.{k}", v) for k, v in vars(obj).items()
                 if not k.startswith("_") and not isinstance(v, _ATOMIC))
    else:
        return
    for p, v in items:
        yield from iter_model_arrays(v, max_depth - 1, p)


def validate_model_finite(model: Any, name: str = "model") -> None:
    """Raise :class:`ModelValidationError` naming the first non-finite
    array found anywhere inside ``model`` (the reload sanity gate)."""
    for path, arr in iter_model_arrays(model, _path=name):
        if not _leaf_finite(arr):
            raise ModelValidationError(
                f"candidate model has non-finite values at {path} "
                f"(shape {tuple(arr.shape)}) — refusing to "
                "serve it")
