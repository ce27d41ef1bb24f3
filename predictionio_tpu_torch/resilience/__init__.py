"""Resilience of the port: retries, the circuit breaker, deadlines,
fault injection, the spill journal and the shared spill queue, and the
training divergence check.

Port of ``predictionio_tpu/resilience/``:

- :mod:`.policy` — :class:`RetryPolicy` (jittered exponential backoff,
  ``Retry-After``-aware) and :class:`CircuitBreaker` (closed / open /
  half-open, exported as ``pio_breaker_state``);
- :mod:`.deadline` — ``X-PIO-Deadline-Ms`` budget propagation;
- :mod:`.faults` — the ``PIO_FAULTS`` / ``PIO_FAULTS_SEED`` drill
  harness hooked into the storage registry and the HTTP handlers;
- :mod:`.spill` — the storage-outage spill journal and its replay
  worker; :mod:`.shared_spill` — the storage-backed fleet queue and its
  lease drainer;
- :mod:`.supervision` — the step watchdog, the divergence guard and its
  rollback, preemption, and the reload's finite-params check.

:func:`idempotency_key` pins the token a write is issued under, so a
replayed spill record re-issues the identical write.  The breaker and
the spill journals publish the reference's trace-ring events
(``breaker.transition``, ``spill.*``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

from predictionio_tpu_torch.resilience.deadline import (
    DEADLINE_HEADER,
    DeadlineExceeded,
    deadline_scope,
    remaining_ms,
)
from predictionio_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    fault_point,
)
from predictionio_tpu_torch.resilience.policy import (
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
)
from predictionio_tpu_torch.resilience.spill import ReplayWorker, SpillJournal

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "RetryPolicy",
    "DEADLINE_HEADER",
    "DeadlineExceeded",
    "deadline_scope",
    "remaining_ms",
    "FaultInjected",
    "FaultPlan",
    "fault_point",
    "ReplayWorker",
    "SpillJournal",
    "idempotency_key",
    "current_idempotency_key",
]


# -- idempotency-token plumbing --------------------------------------------
#
# The spill replay worker pins the token PERSISTED in the journal so that
# a replay retried after a lost reply re-issues the identical write.

_IDEM_TOKEN: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pio_idempotency_token", default=None)


@contextlib.contextmanager
def idempotency_key(token: str) -> Iterator[str]:
    """Pin the idempotency token used by the NEXT storage write on this
    thread/context (nested scopes override)."""
    tok = _IDEM_TOKEN.set(token)
    try:
        yield token
    finally:
        _IDEM_TOKEN.reset(tok)


def current_idempotency_key() -> Optional[str]:
    return _IDEM_TOKEN.get()
