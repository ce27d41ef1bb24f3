"""Retry and circuit-breaker policies (Dean & Barroso, CACM 2013).

Port of ``predictionio_tpu/resilience/policy.py``: the same backoff
sequence under the same ``random.Random`` seed, the same breaker state
machine and the same ``pio_breaker_*`` series, on the port's registry.
Both classes take injectable ``clock``/``sleep``/``rng`` so a test can
prove a backoff schedule or a breaker's state sequence on a fake clock
without sleeping.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional, Tuple, Type

from predictionio_tpu_torch.obs import get_registry, publish_event

__all__ = ["RetryPolicy", "CircuitBreaker", "CircuitOpenError"]


class RetryPolicy:
    """Jittered exponential backoff, ``Retry-After``-aware.

    ``run(fn)`` retries ``fn`` up to ``max_attempts`` times.  A raised
    exception is retried when ``retriable(exc)`` says so (default: a
    truthy ``exc.retriable`` attribute, else not retried).  When the
    exception carries ``retry_after_s`` (parsed from an HTTP
    ``Retry-After`` header or a breaker's remaining recovery time), that
    server-provided hint replaces the computed backoff, capped at
    ``retry_after_cap_ms``.
    """

    def __init__(self, max_attempts: int = 3, base_delay_ms: float = 50.0,
                 max_delay_ms: float = 5_000.0, multiplier: float = 2.0,
                 jitter: float = 0.25, retry_after_cap_ms: float = 30_000.0,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_ms = float(base_delay_ms)
        self.max_delay_ms = float(max_delay_ms)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_after_cap_ms = float(retry_after_cap_ms)
        self._sleep = sleep
        self._rng = rng or random.Random()

    def backoff_ms(self, attempt: int,
                   retry_after_ms: Optional[float] = None) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        if retry_after_ms is not None:
            return min(max(retry_after_ms, 0.0), self.retry_after_cap_ms)
        d = min(self.max_delay_ms,
                self.base_delay_ms * (self.multiplier ** attempt))
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)

    def sleep_backoff(self, attempt: int,
                      retry_after_ms: Optional[float] = None) -> float:
        ms = self.backoff_ms(attempt, retry_after_ms)
        self._sleep(ms / 1e3)
        return ms

    def run(self, fn: Callable[[], Any], *,
            retriable: Optional[Callable[[BaseException], bool]] = None,
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            deadline_ts: Optional[float] = None,
            clock: Callable[[], float] = time.monotonic) -> Any:
        """``deadline_ts`` (absolute ``clock()`` seconds) bounds the WHOLE
        run: when the computed backoff — including a server's Retry-After
        hint, which can be far larger than any budget — would sleep past
        it, the last failure is re-raised immediately instead of
        sleeping through a budget that is already lost."""
        if retriable is None:
            retriable = lambda e: bool(getattr(e, "retriable", False))  # noqa: E731
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except Exception as e:
                if attempt == self.max_attempts - 1 or not retriable(e):
                    raise
                ra = getattr(e, "retry_after_s", None)
                backoff_ms = self.backoff_ms(
                    attempt, None if ra is None else float(ra) * 1e3)
                if deadline_ts is not None and \
                        clock() + backoff_ms / 1e3 >= deadline_ts:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(backoff_ms / 1e3)


class CircuitOpenError(RuntimeError):
    """Shed without touching the backend: the breaker is open."""

    retriable = True

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit breaker {name!r} is open "
            f"(retry in ~{retry_after_s:.1f}s)")
        self.breaker = name
        self.retry_after_s = retry_after_s


# pio_breaker_state gauge encoding
_STATE_VALUE = {"closed": 0, "half-open": 1, "open": 2}


class CircuitBreaker:
    """closed → open after ``failure_threshold`` consecutive failures;
    open → half-open after ``recovery_time_s``; half-open → closed after
    ``half_open_successes`` successful probes (one failure re-opens).

    Only exceptions matching ``failure_types`` count as failures — a
    validation error must not open the breaker that guards availability.
    State is exported as ``pio_breaker_state{breaker=<name>}``
    (0 closed / 1 half-open / 2 open).
    """

    def __init__(self, name: str, failure_threshold: int = 5,
                 recovery_time_s: float = 10.0,
                 half_open_successes: int = 1,
                 failure_types: Tuple[Type[BaseException], ...] = (Exception,),
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.recovery_time_s = float(recovery_time_s)
        self.half_open_successes = max(1, int(half_open_successes))
        self.failure_types = failure_types
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._successes = 0
        self._opened_at: Optional[float] = None
        reg = registry or get_registry()
        self._gauge = reg.gauge(
            "pio_breaker_state",
            "Circuit breaker state: 0 closed, 1 half-open, 2 open.",
            ("breaker",))
        self._transitions = reg.counter(
            "pio_breaker_transitions_total",
            "Circuit breaker state transitions.", ("breaker", "to"))
        self._gauge.set(0, breaker=name)

    # -- state machine (call with self._lock held) -------------------------

    def _set_state(self, state: str) -> None:
        if state == self._state:
            return
        prev, self._state = self._state, state
        self._gauge.set(_STATE_VALUE[state], breaker=self.name)
        self._transitions.inc(breaker=self.name, to=state)
        # Trace-ring correlation: a request that trips or probes the
        # breaker carries the transition in its span tree.
        publish_event("breaker.transition", breaker=self.name,
                      to=state, **{"from": prev})

    def _tick(self) -> None:
        if self._state == "open" and self._opened_at is not None and \
                self._clock() - self._opened_at >= self.recovery_time_s:
            self._successes = 0
            self._set_state("half-open")

    # -- public API --------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until the next probe is allowed (0 when not open)."""
        with self._lock:
            self._tick()
            if self._state != "open" or self._opened_at is None:
                return 0.0
            return max(
                0.0,
                self.recovery_time_s - (self._clock() - self._opened_at))

    def allow(self) -> bool:
        with self._lock:
            self._tick()
            return self._state != "open"

    def record_success(self) -> None:
        with self._lock:
            self._tick()
            self._failures = 0
            if self._state == "half-open":
                self._successes += 1
                if self._successes >= self.half_open_successes:
                    self._set_state("closed")
            elif self._state == "closed":
                pass  # steady state

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            if self._state == "half-open":
                self._opened_at = self._clock()
                self._set_state("open")
                return
            self._failures += 1
            if self._state == "closed" and \
                    self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._set_state("open")

    def call(self, fn: Callable[..., Any], *args, **kwargs) -> Any:
        """Run ``fn`` under the breaker; shed with
        :class:`CircuitOpenError` when open."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())
        try:
            out = fn(*args, **kwargs)
        except self.failure_types:
            self.record_failure()
            raise
        except BaseException:
            raise  # non-availability errors are neutral: no state change
        self.record_success()
        return out
