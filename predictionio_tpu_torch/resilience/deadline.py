"""Request-deadline propagation (``X-PIO-Deadline-Ms``).

Port of ``predictionio_tpu/resilience/deadline.py``.  A client sends the
remaining budget of its request as a header; every server enters a
:func:`deadline_scope` for the handled request, and any layer beneath it
can ask :func:`remaining_ms` / :func:`check` whether the work is still
worth doing.  A request that cannot finish in budget sheds early with
504 instead of queueing behind a saturated backend.

Scopes nest by taking the MINIMUM: an inner layer can only tighten the
budget, never extend the caller's.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

__all__ = [
    "DEADLINE_HEADER",
    "DeadlineExceeded",
    "deadline_scope",
    "remaining_ms",
    "exceeded",
    "check",
]

DEADLINE_HEADER = "X-PIO-Deadline-Ms"

# Absolute deadline in time.monotonic() seconds; None = no deadline.
_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "pio_deadline", default=None)


class DeadlineExceeded(RuntimeError):
    """The request's time budget ran out; mapped to HTTP 504 upstream."""

    retriable = True


@contextlib.contextmanager
def deadline_scope(budget_ms: Optional[float]) -> Iterator[None]:
    """Bound everything inside to ``budget_ms`` from now (no-op on None);
    nested scopes keep the tighter of the two deadlines."""
    if budget_ms is None:
        yield
        return
    new = time.monotonic() + max(float(budget_ms), 0.0) / 1e3
    cur = _DEADLINE.get()
    tok = _DEADLINE.set(new if cur is None else min(cur, new))
    try:
        yield
    finally:
        _DEADLINE.reset(tok)


def remaining_ms() -> Optional[float]:
    """Budget left in the current scope (may be negative); None outside."""
    d = _DEADLINE.get()
    if d is None:
        return None
    return (d - time.monotonic()) * 1e3


def exceeded() -> bool:
    r = remaining_ms()
    return r is not None and r <= 0.0


def check(what: str = "request") -> None:
    """Raise :class:`DeadlineExceeded` when the budget is spent — called
    before each unit of expensive work so a doomed request sheds instead
    of burning backend time."""
    r = remaining_ms()
    if r is not None and r <= 0.0:
        raise DeadlineExceeded(
            f"deadline exceeded before {what} ({-r:.0f}ms over budget)")
