"""Shared spill queue: the fleet-wide durable home for failed event
writes.

Port of ``predictionio_tpu/resilience/shared_spill.py``.  The local
:class:`~predictionio_tpu_torch.resilience.spill.SpillJournal` is a
per-instance JSONL file: durable, but a crashed event server strands its
journaled events until THAT box comes back.  This module moves the
durable home into the storage layer's shared queue
(:class:`~predictionio_tpu_torch.data.storage.base.SpillQueues` — sqlite
and memory implement it), with lease/ack semantics:

- every instance's failed writes land in ONE queue, under the original
  write's idempotency token (enqueue is token-idempotent, so a lost
  enqueue reply resent by a retry cannot duplicate the record);
- a :class:`LeaseDrainer` on ANY instance leases a batch with a TTL,
  replays it into storage, and acks; a drainer that crashes mid-lease
  simply stops renewing — the lease expires and another instance's
  drainer re-leases the batch.  Replay is at-least-once by construction
  and exactly-once for a bulk record, which replays through
  ``create_batch`` under its pinned per-item tokens;
- transient replay failures (storage still down) nack the untouched
  records back to pending; permanent failures dead-letter THAT record
  and keep draining — one poison record must not wedge the queue.

Backend selection (``PIO_SPILL_BACKEND``):

- ``local`` — the local journal only (single-instance default shape);
- ``shared`` — the storage-backed queue, with the local journal kept as
  the LAST-RESORT spill-of-the-spill: when storage itself is the outage
  the shared enqueue fails too, and the failed write degrades to the
  local file exactly as before;
- ``auto`` (default) — ``shared`` when the EVENTDATA source is a
  genuinely out-of-process store (``pioserver``, which the port does
  not have yet), ``local`` otherwise.  A sqlite fleet sharing one
  database file opts in explicitly with ``PIO_SPILL_BACKEND=shared``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from predictionio_tpu_torch.obs import get_registry, publish_event
from predictionio_tpu_torch.resilience.policy import CircuitOpenError

logger = logging.getLogger(__name__)

__all__ = ["SharedSpillQueue", "LeaseDrainer", "resolve_spill_backend",
           "SPILL_QUEUE_NAME"]

# One logical queue for event-write spill; other subsystems may claim
# their own names on the same SpillQueues repo later.
SPILL_QUEUE_NAME = "events"

_BACKENDS = ("auto", "local", "shared")


def resolve_spill_backend(explicit: Optional[str],
                          eventdata_type: Optional[str]) -> str:
    """``local`` or ``shared`` per precedence: explicit arg >
    ``PIO_SPILL_BACKEND`` env > ``auto``.  ``auto`` resolves to shared
    only for an out-of-process EVENTDATA source (pioserver) — the one
    shape where N instances already share a store across boxes."""
    raw = (explicit if explicit is not None
           else os.environ.get("PIO_SPILL_BACKEND", "auto"))
    raw = (raw or "auto").strip().lower()
    if raw not in _BACKENDS:
        logger.warning("PIO_SPILL_BACKEND=%r is not auto|local|shared — "
                       "falling back to auto", raw)
        raw = "auto"
    if raw == "auto":
        return "shared" if eventdata_type == "pioserver" else "local"
    return raw


class SharedSpillQueue:
    """Journal-shaped facade over a storage ``SpillQueues`` repo.

    Mirrors the :class:`SpillJournal` operator surface (append / depth /
    dead_records / requeue_dead / summary) so the event server and ``pio
    spill`` treat both homes uniformly, and adds the lease-cycle verbs
    the :class:`LeaseDrainer` runs.  The repo handle is re-fetched from
    ``storage`` per call — the registry re-wraps fault seams per call,
    and a remote client reconnects lazily."""

    def __init__(self, storage, registry=None,
                 clock: Callable[[], float] = time.time,
                 queue: str = SPILL_QUEUE_NAME):
        self._storage = storage
        self._clock = clock
        self.queue = queue
        # Last depth a real read observed: health endpoints report THIS
        # (cached_depth) instead of issuing a storage RPC — a /ready
        # probe must never block on the very storage whose outage the
        # queue exists to absorb.
        self._last_depth = 0
        reg = registry or get_registry()
        self._depth_gauge = reg.gauge(
            "pio_spill_shared_depth",
            "Events pending (or leased) in the shared spill queue.")
        self._spilled = reg.counter(
            "pio_spill_shared_spilled_total",
            "Events enqueued to the shared spill queue during storage "
            "outages.")
        self._replayed = reg.counter(
            "pio_spill_shared_replayed_total",
            "Shared-queue events successfully replayed into storage.")
        self._dead = reg.counter(
            "pio_spill_shared_dead_total",
            "Shared-queue events dead-lettered after a permanent replay "
            "failure.")
        self._lease_lost = reg.counter(
            "pio_spill_lease_lost_total",
            "Leased records another drainer took over after this "
            "instance's lease expired (detected at ack).")

    def _repo(self):
        return self._storage.get_spill_queues()

    # -- journal-shaped surface ---------------------------------------------

    def append(self, events_json: List[Dict[str, Any]], app_id: int,
               channel_id: Optional[int], token: Optional[str] = None,
               tokens: Optional[List[str]] = None) -> str:
        """Durably enqueue one failed write under its idempotency token.
        Raises on storage failure — the caller (event server) degrades
        to the local journal, the spill-of-the-spill.  ``tokens`` are the
        bulk endpoint's per-item sub-tokens (see SpillJournal.append)."""
        token = token or uuid.uuid4().hex
        record = {"token": token, "appId": app_id, "channelId": channel_id,
                  "events": list(events_json)}
        if tokens is not None:
            record["tokens"] = list(tokens)
        self._repo().enqueue(self.queue, record, token=token,
                             events=len(record["events"]),
                             now_s=self._clock())
        self._spilled.inc(len(record["events"]))
        # Incremental depth bump — NO stats round-trip on the degraded
        # request path (it already paid the enqueue RPC); the drainer's
        # end-of-tick refresh reconciles against the real queue.
        self._last_depth += len(record["events"])
        self._depth_gauge.set(self._last_depth)
        publish_event("spill.shared.append", token=token,
                      events=len(record["events"]))
        return token

    def depth(self) -> int:
        """Events not yet replayed (pending + leased), fleet-wide.
        One storage read — health/status paths use :meth:`cached_depth`
        instead."""
        st = self.stats()
        d = int(st.get("pendingEvents", 0)) + \
            int(st.get("leasedEvents", 0))
        self._last_depth = d
        return d

    def cached_depth(self) -> int:
        """The last observed depth, NO storage round-trip — refreshed by
        every append, drain tick, and explicit :meth:`depth` read."""
        return self._last_depth

    def stats(self) -> Dict[str, Any]:
        return self._repo().stats(self.queue, now_s=self._clock())

    def dead_records(self) -> List[Dict[str, Any]]:
        return [r.payload for r in
                self._repo().peek(self.queue, n=1_000_000, state="dead")]

    def requeue_dead(self) -> int:
        n = self._repo().requeue_dead(self.queue)
        if n:
            publish_event("spill.shared.requeue_dead", events=n)
        self._publish_depth()
        return n

    def _publish_depth(self) -> None:
        try:
            self._depth_gauge.set(self.depth())
        except Exception:  # depth is observability, never the hot path
            logger.debug("shared spill depth probe failed", exc_info=True)

    # -- lease cycle (the drainer's verbs) ----------------------------------

    def lease(self, owner: str, n: int, ttl_s: float):
        return self._repo().lease(self.queue, owner, n, ttl_s,
                                  now_s=self._clock())

    def ack(self, ids: List[str], owner: str) -> int:
        got = self._repo().ack(self.queue, ids, owner)
        if got < len(ids):
            # Some leases expired and were re-leased elsewhere mid-replay:
            # those records will be replayed again by the new owner, and
            # the idempotency tokens make that a no-op server-side.
            self._lease_lost.inc(len(ids) - got)
        return got

    def nack(self, ids: List[str], owner: str) -> int:
        return self._repo().nack(self.queue, ids, owner)

    def dead_letter(self, record, owner: str, reason: str) -> bool:
        ok = self._repo().dead_letter(self.queue, record.id, owner, reason)
        if ok:
            self._dead.inc(record.events)
            publish_event("spill.shared.dead_letter",
                          token=record.token, events=record.events,
                          reason=reason[:200])
        return ok

    def note_replayed(self, n_events: int) -> None:
        self._replayed.inc(n_events)


# Same transient taxonomy as the local ReplayWorker: these mean "storage
# still down, try next tick"; anything else dead-letters the record.
_DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    CircuitOpenError, ConnectionError, OSError)


class LeaseDrainer:
    """Background lease→replay→ack worker over a :class:`SharedSpillQueue`.

    Any fleet instance runs one; the queue's lease TTL is the crash
    contract — a drainer that dies mid-batch leaves its records leased,
    they expire after ``lease_ttl_s``, and a peer's next lease picks them
    up.  ``insert_fn(payload)`` performs one replay write (the event
    server routes it through its breaker and pins the record's token via
    ``idempotency_key``)."""

    def __init__(self, shared: SharedSpillQueue,
                 insert_fn: Callable[[Dict[str, Any]], Any],
                 owner: Optional[str] = None, *,
                 interval_s: float = 0.5, batch: int = 100,
                 lease_ttl_s: Optional[float] = None,
                 transient_types: Tuple[Type[BaseException], ...]
                 = _DEFAULT_TRANSIENT,
                 wait: Optional[Callable[[threading.Event, float], bool]]
                 = None):
        self.shared = shared
        self.insert_fn = insert_fn
        self.owner = owner or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.interval_s = float(interval_s)
        self.batch = int(batch)
        self.lease_ttl_s = float(
            lease_ttl_s if lease_ttl_s is not None
            else os.environ.get("PIO_SPILL_LEASE_TTL_S", "30"))
        self.transient_types = transient_types
        self._stop = threading.Event()
        self._wait = wait if wait is not None else \
            (lambda ev, timeout: ev.wait(timeout))
        self._thread = threading.Thread(
            target=self._run, name="pio-spill-lease-drain", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._wait(self._stop, self.interval_s):
            try:
                self.drain_once()
            except Exception:
                # The drainer must outlive any surprise — it may be the
                # only instance currently draining the fleet's queue.
                logger.exception("shared spill drain tick failed")

    def drain_once(self) -> int:
        """Lease and replay as much as currently possible; returns events
        landed.  A transient failure nacks the untouched remainder (so a
        recovered peer can drain it immediately instead of waiting out
        this instance's lease) and pauses until the next tick."""
        try:
            return self._drain_once_inner()
        finally:
            # Refresh the cached depth ONCE per tick, even when this
            # instance leased nothing — a PEER draining the queue must
            # not leave this instance's /ready and the fleet status
            # reporting phantom backlog forever.
            self.shared._publish_depth()

    def _drain_once_inner(self) -> int:
        landed = 0
        while not self._stop.is_set():
            try:
                records = self.shared.lease(self.owner, self.batch,
                                            self.lease_ttl_s)
            except Exception as e:
                logger.debug("shared spill lease failed: %s", e)
                break
            if not records:
                break
            done_ids: List[str] = []
            batch_events = 0
            paused = False
            for i, rec in enumerate(records):
                try:
                    self.insert_fn(rec.payload)
                except self.transient_types as e:
                    logger.debug("shared spill replay paused after "
                                 "%d/%d: %s", i, len(records), e)
                    try:
                        self.shared.nack([r.id for r in records[i:]],
                                         self.owner)
                    except Exception:
                        logger.debug("shared spill nack failed "
                                     "(leases will expire)",
                                     exc_info=True)
                    paused = True
                    break
                except Exception as e:
                    try:
                        self.shared.dead_letter(
                            rec, self.owner, f"{type(e).__name__}: {e}")
                    except Exception:
                        logger.debug("dead-letter failed (lease will "
                                     "expire and replay retries)",
                                     exc_info=True)
                else:
                    done_ids.append(rec.id)
                    batch_events += rec.events
            if done_ids:
                try:
                    acked = self.shared.ack(done_ids, self.owner)
                except Exception:
                    # Storage error mid-ack: the records stay leased and
                    # expire; a peer re-replays them and the idempotency
                    # tokens dedup.  Never fatal.
                    logger.warning("shared spill ack failed — records "
                                   "re-lease after TTL and replay dedups "
                                   "by token", exc_info=True)
                    acked = 0
                if acked:
                    self.shared.note_replayed(batch_events)
                    publish_event("spill.shared.replayed",
                                  events=batch_events, owner=self.owner)
                landed += batch_events
            if paused or len(records) < self.batch:
                break
        return landed

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
