"""Admission-controlled request queue for the serving scheduler.

Port of ``predictionio_tpu/serving/queue.py``.  The bounded per-model
queue is the admission-control half of continuous batching: a server that
accepts every connection and lets requests pile up behind a saturated
card turns overload into unbounded latency for everyone.  A bounded queue
rejects the marginal request fast — HTTP 429 + ``Retry-After`` — so the
requests already admitted keep their latency and the client knows to
back off.

Pieces:

- :class:`Clock` / :class:`MonotonicClock` — the scheduler's time source.
  ``wait`` is ON the clock so tests drive the batcher with a fake clock
  and zero wall sleeps.
- :class:`Pending` — one submitted query's lifecycle: ``queued`` →
  ``claimed`` (a batcher owns it) → ``done``; or ``queued`` →
  ``abandoned`` when the submitting thread gave up (deadline) before any
  batch took it.  The claim/abandon race is settled by one lock so a
  request is never both answered and re-dispatched.  A finished entry
  carries the model generation its dispatch answered under
  (``generation``): the result cache fills under it.
- :class:`ModelQueue` — bounded FIFO + condition variable, one per
  registered model, with a depth hook for the gauge.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

__all__ = [
    "Clock",
    "MonotonicClock",
    "Pending",
    "ModelQueue",
    "QueueFull",
    "SchedulerClosed",
    "SchedulerStalled",
]


class QueueFull(RuntimeError):
    """Admission rejected: the model's queue is at capacity (HTTP 429)."""

    retriable = True


class SchedulerClosed(RuntimeError):
    """Submitted to a scheduler that is shutting down (HTTP 503)."""

    retriable = True


class SchedulerStalled(RuntimeError):
    """A pending query saw no dispatch within the stall budget — the
    batcher thread is wedged or the dispatch fn hung (HTTP 503)."""

    retriable = True


class Clock:
    """Time source + condition wait, both injectable.

    ``wait`` takes the condition variable so a fake clock can ADVANCE
    TIME instead of sleeping — the deadline-window tests run the full
    gather/dispatch logic with zero wall-clock waits.
    """

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def wait(self, cond: threading.Condition,
             timeout: Optional[float]) -> bool:  # pragma: no cover
        raise NotImplementedError


class MonotonicClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def wait(self, cond: threading.Condition,
             timeout: Optional[float]) -> bool:
        return cond.wait(timeout)


class Pending:
    """One admitted query awaiting its batch.

    The submitting (HTTP handler) thread blocks on :meth:`wait_done`;
    the batcher thread claims, dispatches, and :meth:`finish`\\ es it with
    the result and the generation the dispatch returned.
    """

    __slots__ = ("query", "enqueued_s", "deadline_s", "state", "result",
                 "generation", "error", "_lock", "_done")

    QUEUED = "queued"
    CLAIMED = "claimed"
    ABANDONED = "abandoned"
    DONE = "done"

    def __init__(self, query: Any, enqueued_s: float,
                 deadline_s: Optional[float] = None):
        self.query = query
        self.enqueued_s = enqueued_s
        self.deadline_s = deadline_s
        self.state = Pending.QUEUED
        self.result: Any = None
        # The model generation that answered (None until a dispatch did).
        self.generation: Optional[int] = None
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._done = threading.Event()

    def claim(self) -> bool:
        """Batcher takes ownership; False if the waiter already walked."""
        with self._lock:
            if self.state != Pending.QUEUED:
                return False
            self.state = Pending.CLAIMED
            return True

    def abandon(self) -> bool:
        """Waiter gives up (deadline); False if a batch already owns it."""
        with self._lock:
            if self.state != Pending.QUEUED:
                return False
            self.state = Pending.ABANDONED
            return True

    def finish(self, result: Any = None,
               error: Optional[BaseException] = None,
               generation: Optional[int] = None) -> None:
        with self._lock:
            self.state = Pending.DONE
        self.result = result
        self.generation = generation
        self.error = error
        self._done.set()

    def wait_done(self, timeout: Optional[float]) -> bool:
        return self._done.wait(timeout)


class ModelQueue:
    """Bounded FIFO of :class:`Pending` entries for ONE model.

    ``depth`` is the per-model concurrency limit: queued-but-undispatched
    requests.  Depth 0 is legal and means "no queueing at all" — every
    submit rejects, which the admission tests use to force deterministic
    429s.
    """

    def __init__(self, name: str, depth: int,
                 on_depth: Optional[Callable[[int], None]] = None):
        self.name = name
        self.depth = int(depth)
        self._items: List[Pending] = []
        self._cond = threading.Condition()
        self._closed = False
        # gauge hook (queue depth after every put/take), injected by the
        # scheduler so this module stays metrics-agnostic.
        self._on_depth = on_depth

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def put(self, entry: Pending) -> None:
        with self._cond:
            if self._closed:
                raise SchedulerClosed(
                    f"serving scheduler for model {self.name!r} is closed")
            if len(self._items) >= self.depth:
                # Before rejecting, sweep corpses: entries whose waiter
                # abandoned (deadline) still sit here until a gather
                # drains them — they must not hold admission slots
                # against live traffic during a long dispatch.
                self._items = [e for e in self._items
                               if e.state == Pending.QUEUED]
            if len(self._items) >= self.depth:
                raise QueueFull(
                    f"model {self.name!r} queue full "
                    f"({len(self._items)}/{self.depth} queued)")
            self._items.append(entry)
            if self._on_depth:
                self._on_depth(len(self._items))
            self._cond.notify()

    def take(self, clock: Clock,
             timeout: Optional[float] = None) -> Optional[Pending]:
        """Pop the oldest entry, waiting up to ``timeout`` (None = until
        an item or close).  Returns None on timeout or close — the caller
        distinguishes via :meth:`closed`."""
        with self._cond:
            while not self._items:
                if self._closed:
                    return None
                if timeout is not None and timeout <= 0:
                    return None
                if not clock.wait(self._cond, timeout) and timeout is not None:
                    # timed out; re-check once in case of a late notify
                    if not self._items:
                        return None
            entry = self._items.pop(0)
            # Gauge updates stay under the lock: put/take callbacks
            # interleaving after release would publish depths out of
            # order and freeze a stale reading on the status page.
            if self._on_depth:
                self._on_depth(len(self._items))
        return entry

    def drain(self) -> List[Pending]:
        """Remove and return everything queued (close path)."""
        with self._cond:
            items, self._items = self._items, []
            if self._on_depth:
                self._on_depth(0)
        return items

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def closed(self) -> bool:
        with self._cond:
            return self._closed
