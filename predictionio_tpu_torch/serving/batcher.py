"""Deadline-aware micro-batcher: queue → one vectorized dispatch per window.

Port of ``predictionio_tpu/serving/batcher.py``.  One dispatcher thread
per model drains the admission queue into batches and hands each batch to
the engine's vectorized ``batch_predict`` path in a SINGLE call —
concurrent requests share one retrieval call, and so one launch of the
top-k kernel at B = cohort size, instead of paying one launch each.

Window policy — the part that keeps tail latency honest:

- a batch OPENS when the first request arrives and CLOSES after
  ``window_s`` (autotuner-owned), when it reaches ``max_size``, or — the
  deadline-aware clause — at the latest instant the most-constrained
  member could still be dispatched and answered within its
  ``X-PIO-Deadline-Ms`` budget (estimated from an EWMA of recent
  dispatch times).  Batching must never convert an in-budget request
  into a deadline miss.
- entries whose deadline already expired are shed with
  ``DeadlineExceeded`` (HTTP 504 upstream) BEFORE the dispatch — a dead
  request must not occupy device work.

Generation safety: the whole batch goes through ONE ``dispatch_fn`` call,
and the engine server's dispatch snapshots (models, generation) once
under its swap lock — a reload that lands mid-gather flips the NEXT
batch, never splits this one.  ``dispatch_fn(queries) -> (results,
generation)`` returns the generation it served, and every member's
:class:`~predictionio_tpu_torch.serving.queue.Pending` carries it back
to its submitter, where the result cache fills under it.

Failure isolation: when a batch dispatch raises, the batcher retries the
members individually so one malformed query (bind error) 400s itself
instead of failing its whole cohort.

The reference also roots a trace per dispatch and stamps each member's
latency waterfall; the port has neither layer yet.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.serving.queue import (
    Clock,
    ModelQueue,
    MonotonicClock,
    Pending,
    SchedulerClosed,
)

logger = logging.getLogger(__name__)

__all__ = ["MicroBatcher", "BATCH_SIZE_BUCKETS"]

# Batch-size histogram buckets: powers of two up to the native frontend's
# ceiling — the distribution, not just the mean, shows coalescing health.
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# Coalescing-ratio buckets (dispatches per request = 1/batch_size):
# 1.0 = no coalescing, 1/64 = perfect 64-way sharing.
COALESCE_BUCKETS = (0.015625, 0.03125, 0.0625, 0.125, 0.25, 0.5, 1.0)

_FAR_FUTURE = float("inf")


class MicroBatcher:
    """Drains one :class:`ModelQueue` into windowed vectorized dispatches.

    ``dispatch_fn(queries) -> (results, generation)`` runs the whole
    batch against ONE atomically-snapshotted model generation.
    ``window_s`` and ``max_size`` are attributes (not constructor-frozen)
    because the autotuner retunes them live.
    """

    def __init__(
        self,
        model: str,
        queue: ModelQueue,
        dispatch_fn: Callable[[List[Any]], Tuple[List[Any], int]],
        *,
        window_s: float = 0.002,
        max_size: int = 64,
        clock: Optional[Clock] = None,
        autotuner=None,
        registry=None,
    ):
        self.model = model
        self.queue = queue
        self.dispatch_fn = dispatch_fn
        self.window_s = float(window_s)
        self.max_size = int(max_size)
        self.clock = clock or MonotonicClock()
        self.autotuner = autotuner
        # EWMA of recent dispatch wall times — the service-time estimate
        # the deadline-aware window close uses.  Seeded at 0 ("dispatch
        # is instant") so the first requests are never shed on a guess;
        # it converges within a few batches.
        self._est_dispatch_s = 0.0
        # Consecutive gathers that ended as singletons: after 2, the
        # stream is a lone client and the window wait is pure latency
        # tax — skip it until companions reappear (the backlog scoop
        # re-forms batches the moment concurrency returns, which resets
        # the streak).
        self._lone_streak = 0
        self._thread: Optional[threading.Thread] = None
        reg = registry or get_registry()
        self._m_batch_size = reg.histogram(
            "pio_batch_size", "Queries coalesced per dispatch.",
            ("model",), buckets=BATCH_SIZE_BUCKETS)
        self._m_coalesce = reg.histogram(
            "pio_batch_dispatches_per_request",
            "1/batch_size observed per member request — mean < 1 means "
            "the scheduler is coalescing.",
            ("model",), buckets=COALESCE_BUCKETS)
        self._m_dispatch_ms = reg.histogram(
            "pio_batch_dispatch_ms", "Wall time of one batched dispatch.",
            ("model",))
        self._m_wait_ms = reg.histogram(
            "pio_queue_wait_ms",
            "Queue wait from admission to dispatch start.", ("model",))
        self._m_dispatches = reg.counter(
            "pio_batch_dispatch_total", "Batched dispatches.", ("model",))
        self._m_requests = reg.counter(
            "pio_batch_requests_total",
            "Requests served through the batcher.", ("model",))
        self._m_shed = reg.counter(
            "pio_queue_shed_total",
            "Queue entries shed before dispatch.", ("model", "reason"))
        self._m_window = reg.gauge(
            "pio_batch_window_ms", "Current batch gather window.",
            ("model",))
        self._m_max = reg.gauge(
            "pio_batch_max_size", "Current max batch size.", ("model",))
        self._publish_knobs()

    # -- knobs (autotuner writes through these) -----------------------------

    def _publish_knobs(self) -> None:
        self._m_window.set(self.window_s * 1e3, model=self.model)
        self._m_max.set(self.max_size, model=self.model)

    def set_knobs(self, window_s: Optional[float] = None,
                  max_size: Optional[int] = None) -> None:
        if window_s is not None:
            self.window_s = max(float(window_s), 0.0)
        if max_size is not None:
            self.max_size = max(int(max_size), 1)
        self._publish_knobs()

    # -- gather -------------------------------------------------------------

    def _latest_dispatch_s(self, entry: Pending) -> float:
        """Latest clock time this entry could still be dispatched and
        (per the EWMA estimate) answered inside its deadline."""
        if entry.deadline_s is None:
            return _FAR_FUTURE
        return entry.deadline_s - self._est_dispatch_s

    def gather(self, first: Optional[Pending] = None) -> List[Pending]:
        """Form one batch: block for the first entry, then fill until the
        window closes, the most-constrained member's slack runs out, or
        ``max_size`` is reached.  Returns [] only when the queue closed.
        """
        if first is None:
            first = self.queue.take(self.clock, timeout=None)
            if first is None:
                return []
        batch = [first]
        opened = self.clock.now()
        window_s = self.window_s if self._lone_streak < 2 else 0.0
        close = opened + window_s
        close = min(close, self._latest_dispatch_s(first))
        # Scoop the backlog FIRST: entries already queued coalesce for
        # free (no added latency), so even a zero window batches under
        # load — the window only governs waiting for FUTURE arrivals.
        while len(batch) < self.max_size:
            entry = self.queue.take(self.clock, timeout=0)
            if entry is None:
                break
            batch.append(entry)
            close = min(close, self._latest_dispatch_s(entry))
        while len(batch) < self.max_size:
            now = self.clock.now()
            if now >= close:
                break
            entry = self.queue.take(self.clock, timeout=close - now)
            if entry is None:
                if self.queue.closed() or self.clock.now() >= close:
                    break
                continue
            batch.append(entry)
            close = min(close, self._latest_dispatch_s(entry))
        self._lone_streak = self._lone_streak + 1 if len(batch) == 1 else 0
        return batch

    # -- dispatch -----------------------------------------------------------

    def dispatch(self, batch: Sequence[Pending]) -> int:
        """Claim, shed expired, run ONE vectorized dispatch, finish all.

        Returns the number of entries actually dispatched (after sheds
        and abandons) — 0 means the whole batch evaporated.
        """
        now = self.clock.now()
        live: List[Pending] = []
        for e in batch:
            if not e.claim():
                continue  # waiter already walked (deadline) — silent drop
            if e.deadline_s is not None and now >= e.deadline_s:
                # Expired in the queue: 504 upstream, no device work.
                self._m_shed.inc(model=self.model, reason="expired")
                e.finish(error=DeadlineExceeded(
                    "deadline expired while queued for batch dispatch "
                    f"({(now - e.deadline_s) * 1e3:.0f}ms over budget)"))
                continue
            live.append(e)
        if not live:
            return 0
        t0 = self.clock.now()
        try:
            results, generation = self.dispatch_fn([e.query for e in live])
            if len(results) != len(live):
                raise ValueError(
                    f"dispatch returned {len(results)} results for "
                    f"{len(live)} queries")
        except Exception as exc:
            if len(live) == 1:
                # Retrying a singleton would replay the IDENTICAL call —
                # pure double work for the same error.
                live[0].finish(error=exc)
            else:
                self._finish_individually(live)
            return len(live)
        dt = self.clock.now() - t0
        # EWMA (alpha .25): reactive enough to track a model swap,
        # smooth enough that one slow dispatch doesn't shed the queue.
        self._est_dispatch_s = (0.75 * self._est_dispatch_s + 0.25 * dt
                                if self._est_dispatch_s else dt)
        n = len(live)
        self._m_dispatches.inc(model=self.model)
        self._m_requests.inc(n, model=self.model)
        self._m_batch_size.observe(n, model=self.model)
        self._m_dispatch_ms.observe(dt * 1e3, model=self.model)
        for e, r in zip(live, results):
            self._m_wait_ms.observe((t0 - e.enqueued_s) * 1e3,
                                    model=self.model)
            self._m_coalesce.observe(1.0 / n, model=self.model)
            if self.autotuner is not None:
                self.autotuner.observe((self.clock.now() - e.enqueued_s)
                                       * 1e3)
            e.finish(result=r, generation=generation)
        if self.autotuner is not None:
            self.autotuner.after_dispatch(self)
        return n

    def _finish_individually(self, live: List[Pending]) -> None:
        """Batch dispatch raised: isolate the failure per member so one
        poisoned query cannot 500 its cohort."""
        for e in live:
            # Re-check each member's budget: deadlines keep expiring
            # during the failed attempt and these serial retries, and a
            # systemic failure (dead backend) must not be amplified
            # N-fold with device work whose 200s get discarded anyway.
            now = self.clock.now()
            if e.deadline_s is not None and now >= e.deadline_s:
                self._m_shed.inc(model=self.model, reason="expired")
                e.finish(error=DeadlineExceeded(
                    "deadline expired during batch retry "
                    f"({(now - e.deadline_s) * 1e3:.0f}ms over budget)"))
                continue
            try:
                results, generation = self.dispatch_fn([e.query])
                self._m_dispatches.inc(model=self.model)
                self._m_requests.inc(model=self.model)
                self._m_batch_size.observe(1, model=self.model)
                self._m_coalesce.observe(1.0, model=self.model)
                e.finish(result=results[0], generation=generation)
            except Exception as exc:  # noqa: BLE001 - per-item verdict
                e.finish(error=exc)

    # -- loop / lifecycle ---------------------------------------------------

    def run_once(self) -> int:
        """One gather+dispatch cycle (the unit tests' entry point)."""
        batch = self.gather()
        if not batch:
            return 0
        return self.dispatch(batch)

    def _loop(self) -> None:
        while not self.queue.closed():
            try:
                self.run_once()
            except Exception:
                # The dispatcher thread must survive anything — a dead
                # batcher turns every request into a stall timeout.
                logger.exception("micro-batcher loop error (model %s)",
                                 self.model)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"pio-batcher-{self.model}",
            daemon=True)
        self._thread.start()

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the loop and fail whatever is still queued (503)."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        for e in self.queue.drain():
            if e.claim():
                e.finish(error=SchedulerClosed(
                    "serving scheduler shut down before dispatch"))
