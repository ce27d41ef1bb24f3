"""Event Server — always-on ingestion REST service.

Port of ``predictionio_tpu/server/event_server.py``: the same routes,
status codes and JSON bodies, the same exactly-once batch ids, the same
breaker, spill and admission behaviour, and the same entry for the
native frontend (``native_fallback_batch``: ``pio eventserver
--native``).  It never touches the card; the verbs that train and serve
what it ingested do.  A landed feedback event that echoes a served
recommendation's id (``properties.pioServeId``) joins back to the served
items in the quality layer (:func:`~predictionio_tpu_torch.obs.quality.
note_feedback_events`; process-local, as in the reference).  Every
landed write is teed into the columnar segment store
(:class:`~predictionio_tpu_torch.data.columnar.SegmentStore`) with the
ids the store gave it, so a warm refresh reads its delta from sealed
segments; ``/ready`` reports the tee's disk state and segment counts.
Departure: one server a segment root tees, under the root's writer lock
(the reference lets every server on a root write, and its lazy open may
unlink another's active window).  Another server on the root bypasses
the tee, marks what it lands so readers fall back to the primary store,
counts ``pio_segment_tee_errors_total{kind="writer_locked"}`` and
reports ``"segmentTee": "bypassed"`` in ``/ready``.

Reference: data/.../data/api/EventServer.scala + EventServiceActor routes
(SURVEY.md §3.3).  API parity (Appendix A):

- ``POST /events.json?accessKey=K[&channel=C]`` → 201 ``{"eventId": ...}``
- ``POST /batch/events.json`` → 200 ``[{"status":201,"eventId":...}, ...]``
  (per-item status; malformed items get their error inline, max 50/batch)
- ``GET /events.json?accessKey=K&...`` filters: startTime, untilTime,
  entityType, entityId, event, targetEntityType, targetEntityId, limit,
  reversed
- ``GET /events/<id>.json`` / ``DELETE /events/<id>.json``
- ``GET /`` → ``{"status": "alive"}``; ``GET /stats.json`` ingest counters
  (reference keeps these behind a flag; always on here)
- ``GET /metrics`` — Prometheus text exposition of the process registry
- ``GET /ready`` — readiness: breaker state, spill depths, admission
- ``GET /traces.json?accessKey=K`` — the trace ring (``?request_id=``,
  ``?min_ms=``, ``?limit=``), behind the access key

Auth: accessKey query param or ``Authorization`` header (the reference
accepts basic-auth with the key as username).  Per-key event allowlists
enforced on write.
"""

from __future__ import annotations

import base64
import datetime as _dt
import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, parse_qsl, urlparse

from predictionio_tpu_torch.data.columnar import (
    SegmentDiskPressure,
    SegmentStore,
)
from predictionio_tpu_torch.data.event import EventValidationError
from predictionio_tpu_torch.data.json_support import (
    event_from_json,
    event_to_json,
    parse_iso8601,
)
from predictionio_tpu_torch.data.storage import (
    Storage,
    StorageError,
    StorageUnavailable,
    get_storage,
)
from predictionio_tpu_torch.data.storage.base import epoch_us
from predictionio_tpu_torch.data.webhooks import ConnectorError, get_connector
from predictionio_tpu_torch.obs import (
    get_registry,
    start_runtime_introspection,
)
from predictionio_tpu_torch.obs.quality import note_feedback_events
from predictionio_tpu_torch.resilience import idempotency_key
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.resilience.faults import fault_point
from predictionio_tpu_torch.resilience.policy import (
    CircuitBreaker,
    CircuitOpenError,
)
from predictionio_tpu_torch.resilience.shared_spill import (
    LeaseDrainer,
    SharedSpillQueue,
    resolve_spill_backend,
)
from predictionio_tpu_torch.resilience.spill import (
    ReplayWorker,
    SpillJournal,
    resolve_spill_dir,
)
from predictionio_tpu_torch.server.http import (
    BaseHandler,
    ThreadingHTTPServer,
    param_bool,
    traces_payload,
)
from predictionio_tpu_torch.server.plugins import PluginManager

logger = logging.getLogger(__name__)

__all__ = ["EventServer", "MAX_BATCH_SIZE", "max_batch_size"]

MAX_BATCH_SIZE = 50  # reference: EventServer batch cap


def max_batch_size() -> int:
    """Batch cap for /batch/events.json — reference parity default (50),
    raisable via PIO_MAX_BATCH_SIZE for bulk-load clients (the server's
    group commit is O(batch), so a larger cap costs memory, not
    correctness)."""
    raw = os.environ.get("PIO_MAX_BATCH_SIZE")
    if not raw:
        return MAX_BATCH_SIZE
    try:
        return max(1, int(raw))
    except ValueError:
        logger.warning("bad PIO_MAX_BATCH_SIZE=%r; using %d", raw,
                       MAX_BATCH_SIZE)
        return MAX_BATCH_SIZE

# Availability failures (vs client faults): these trip the breaker and
# route to spill/503, never to a 400.
_UNAVAILABLE = (CircuitOpenError, StorageUnavailable, ConnectionError)

# Client-supplied batch idempotency tokens become event-id material —
# keep them filesystem/URL-safe.
_TOKEN_RE = re.compile(r"[A-Za-z0-9._-]+")


class _EventMetrics:
    """Ingest instruments over the shared registry (reference:
    Stats/StatsActor).  ``/stats.json`` and ``/metrics`` are both views
    of these series — there is no second set of counters."""

    def __init__(self, registry=None):
        self.registry = registry or get_registry()
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self.requests = self.registry.counter(
            "pio_event_requests_total",
            "Event API requests by HTTP status.", ("status",))
        self.events = self.registry.counter(
            "pio_event_events_total",
            "Accepted events by event name.", ("event",))
        self.latency = self.registry.histogram(
            "pio_event_request_latency_ms",
            "Event API request handling latency.")
        # Ingest high-watermark: the newest event_time STORED per app,
        # epoch seconds — the freshness anchor a refresh compares against
        # the serving generation's data watermark.  Spilled (202) events
        # do not advance it until replay lands them: the gauge tracks what
        # is *servable from the store*, not what was accepted.
        self.latest_ts = self.registry.gauge(
            "pio_events_latest_ts",
            "Newest stored event_time per app (ingest high-watermark), "
            "epoch seconds.", ("app",))

    def record(self, status: int, event_name: Optional[str], ms: float) -> None:
        self.requests.inc(status=str(status))
        if event_name:
            self.events.inc(event=event_name)
        self.latency.observe(ms)

    def snapshot(self) -> Dict[str, Any]:
        """The legacy /stats.json shape, read back off the registry
        (quantiles are bucket-interpolated estimates)."""
        return {
            "startTime": self.start_time.isoformat(),
            "statusCounts": {k[0]: int(v)
                             for k, v in self.requests.series().items()},
            "eventCounts": {k[0]: int(v)
                            for k, v in self.events.series().items()},
            "latencyMs": {"p50": self.latency.quantile(0.5),
                          "p95": self.latency.quantile(0.95),
                          "p99": self.latency.quantile(0.99)},
        }


class EventServer:
    """Owns the HTTP server; one instance per process (reference: main)."""

    def __init__(self, storage: Optional[Storage] = None, host: str = "0.0.0.0",
                 port: int = 7070, plugins=None, *,
                 breaker: Optional[CircuitBreaker] = None,
                 spill_dir: Optional[str] = None,
                 spill_backend: Optional[str] = None,
                 replay_interval_s: Optional[float] = None,
                 replay_wait=None,
                 drain_wait=None):
        self.storage = storage or get_storage()
        self.host = host
        self.port = port
        self.stats = _EventMetrics()
        # Runtime introspection (the device-memory instruments + the
        # memory-sampler thread); a process that never touched CUDA
        # samples no device, so this never initialises the card.
        start_runtime_introspection()
        # Positive accessKey cache (5 s TTL): the ingest hot path otherwise
        # pays a metadata SELECT per request.  Key revocation propagates
        # within the TTL; auth FAILURES are never cached.
        self._auth_cache: Dict[str, Tuple[float, Any]] = {}
        self._auth_ttl = 5.0
        # Stale-if-error window: how old a cached key may be and still
        # authenticate while the metadata store is unreachable.
        self._auth_stale_max_s = float(
            os.environ.get("PIO_AUTH_STALE_MAX_S", "300"))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Resilience layer: breaker around every event-store touch, spill
        # journal + replay worker for write outages, Retry-After hint on
        # 202/429/503 answers (knobs: PIO_BREAKER_THRESHOLD,
        # PIO_BREAKER_RECOVERY_S, PIO_SPILL_DIR, PIO_RETRY_AFTER_S).
        self._breaker = breaker or CircuitBreaker(
            "eventdata",
            failure_threshold=int(os.environ.get(
                "PIO_BREAKER_THRESHOLD", "5")),
            recovery_time_s=float(os.environ.get(
                "PIO_BREAKER_RECOVERY_S", "10")),
            failure_types=(StorageUnavailable, ConnectionError))
        self.retry_after_s = int(os.environ.get("PIO_RETRY_AFTER_S", "5"))
        self._shed = self.stats.registry.counter(
            "pio_deadline_shed_total",
            "Requests shed with 504 because their deadline expired.",
            ("server",))
        # Per-app ingest high-watermark cache behind pio_events_latest_ts
        # (seeded from the store on an app's first insert, then advanced
        # in memory — one MAX query per app per process, not per event).
        self._latest_ts: Dict[int, int] = {}
        self._latest_lock = threading.Lock()
        # Columnar segment tee: landed writes are appended to per-(app,
        # channel) segment files so warm-refresh delta reads become
        # window-sized columnar slices.  Segments are derived data: a tee
        # failure degrades (counted, /ready-visible), never fails the
        # ingest that already committed to the primary store.  One server
        # a root tees: it holds the root's writer lock, and discards a
        # crashed writer's open windows now, at start.  Another server
        # on the root bypasses the tee and marks what it lands, so
        # readers fall back to the primary store there.
        self._segment_degraded = False
        self._segment_bypass = False
        self._segment_errors = self.stats.registry.counter(
            "pio_segment_tee_errors_total",
            "Segment tee failures (ingest unaffected).", ("kind",))
        try:
            self.segments = SegmentStore.open_default()
            if self.segments is not None:
                if self.segments.acquire_writer():
                    self.segments.recover()
                else:
                    logger.warning(
                        "segment root %s has another writer — this server "
                        "bypasses the tee", self.segments.root)
                    self.segments.enter_bypass()
                    self._segment_bypass = True
                    self._segment_errors.inc(kind="writer_locked")
        except Exception:
            logger.exception("segment store unavailable — tee disabled")
            self.segments = None
        # Write-path admission: one shared budget over events
        # queued anywhere on the write plane (local journal + shared
        # backplane + in-flight requests).  When the backlog exceeds it,
        # new writes answer 429 + Retry-After instead of growing the
        # spill without bound — bounded memory/disk beats a stalled
        # /events.json.  0 disables (default).
        self.ingest_budget = int(os.environ.get(
            "PIO_INGEST_QUEUE_BUDGET", "0") or 0)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._overload = self.stats.registry.counter(
            "pio_ingest_overload_total",
            "Writes rejected 429 by the ingest admission budget.")
        self.spill: Optional[SpillJournal] = None
        self._replay: Optional[ReplayWorker] = None
        self.shared_spill: Optional[SharedSpillQueue] = None
        self._lease_drainer: Optional[LeaseDrainer] = None
        replay_interval = (replay_interval_s if replay_interval_s is not None
                           else float(os.environ.get(
                               "PIO_SPILL_REPLAY_INTERVAL_S", "0.5")))
        # Shared spill queue: failed writes enqueue into
        # the storage-backed fleet queue; this instance also runs a lease
        # drainer so ANY instance (including a freshly restarted one) can
        # replay a crashed peer's batch.  The local journal below stays
        # as the last-resort spill-of-the-spill — when storage itself is
        # the outage, the shared enqueue fails too.
        try:
            ev_type = self.storage.config.source_for("EVENTDATA").type
        except Exception:
            ev_type = None
        self.spill_backend = resolve_spill_backend(spill_backend, ev_type)
        if self.spill_backend == "shared":
            try:
                self.storage.get_spill_queues()  # probe support
                self.shared_spill = SharedSpillQueue(self.storage)
            except Exception as e:
                logger.warning("shared spill backend unavailable (%s) — "
                               "falling back to the local journal", e)
                self.spill_backend = "local"
            else:
                # Owner must be globally unique — ack/dead_letter use it
                # to detect lease steals, and host:port collides when
                # port=0 is not yet resolved or two servers share a pid.
                self._lease_drainer = LeaseDrainer(
                    self.shared_spill, self._replay_insert,
                    owner=f"{host}:{os.getpid()}-{uuid.uuid4().hex[:6]}",
                    interval_s=replay_interval,
                    transient_types=_UNAVAILABLE + (OSError,),
                    wait=drain_wait)
                self._lease_drainer.start()
        spill_path = resolve_spill_dir(
            spill_dir, getattr(self.storage.config, "home", None))
        if spill_path is not None:
            self.spill = SpillJournal(spill_path)
            self._replay = ReplayWorker(
                self.spill, self._replay_insert,
                interval_s=replay_interval,
                transient_types=_UNAVAILABLE + (OSError,),
                # Injectable tick wait (tests drive replay with a fake
                # clock / direct drain instead of wall-clock polling).
                wait=replay_wait)
            self._replay.start()
        # Server plugin seam (reference: EventServerPlugin): env-discovered
        # request instrumentation.  Started LAST so plugins see a fully
        # constructed server.
        self.plugins = (plugins if plugins is not None
                        else PluginManager.from_env("PIO_EVENTSERVER_PLUGINS"))
        self.plugins.start(self)

    # -- spill / replay -----------------------------------------------------

    def _spill_events(self, events_json: List[Any], app_id: int,
                      channel_id: Optional[int], token: str,
                      tokens: Optional[List[str]] = None) -> Optional[str]:
        """Durably queue one failed write (single event or whole batch)
        under the SAME idempotency token the write was issued with — if
        the "outage" was really a lost reply, the backend committed and
        replay must dedup against it, not re-insert.

        Shared backend first (the fleet queue: any instance's drainer
        replays it, a crash here strands nothing); the local journal is
        the fallback for when storage itself is the outage — the shared
        enqueue rides the same storage that just failed the write, so it
        usually fails too and the record degrades to the local file.
        Returns the token, or None when no home accepted it (caller
        503s)."""
        # Breaker-open = storage is KNOWN down, and the shared queue
        # rides that same storage: skip the doomed enqueue (which would
        # stack one RPC timeout onto every degraded request) and go
        # straight to the local journal; the drainer replays it into the
        # shared path's store once the breaker recloses.
        if self.shared_spill is not None and self._breaker.state != "open":
            try:
                return self.shared_spill.append(events_json, app_id,
                                                channel_id, token=token,
                                                tokens=tokens)
            except Exception:
                logger.warning("shared spill enqueue failed — degrading "
                               "to the local journal", exc_info=True)
        if self.spill is None:
            return None
        try:
            return self.spill.append(events_json, app_id, channel_id,
                                     token=token, tokens=tokens)
        except (OSError, ValueError):  # ValueError: journal closed itself
            logger.exception("spill journal write failed")
            return None

    def _replay_insert(self, record: Dict[str, Any]) -> None:
        """One journal record → storage, through the breaker (this worker
        is the half-open prober), re-issuing the ORIGINAL write: same
        token, same event set, so a dedup-capable backend answers from
        its window if the original actually committed.

        A record carrying per-item sub-``tokens`` (a bulk-ingest batch)
        replays through ``create_batch``: event ids derive from
        the sub-tokens, so a batch the crashed attempt PARTIALLY landed
        dedups row-by-row — each event lands exactly once even when the
        original commit split down the middle."""
        evs = [event_from_json(e) for e in record["events"]]
        events = self.storage.get_events()
        tokens = record.get("tokens")
        with idempotency_key(record["token"]):
            if tokens is not None:
                ids = self._breaker.call(
                    events.create_batch, evs, record["appId"],
                    record.get("channelId"), tokens=tokens)
            else:
                ids = self._breaker.call(
                    events.insert_batch, evs, record["appId"],
                    record.get("channelId"))
        # Replayed events are now servable — advance the watermark they
        # could not advance while journaled.
        self._note_ingest(record["appId"], evs)
        self._segment_tee(record["appId"], record.get("channelId"), evs,
                          ids)

    # -- segment tee ----------------------------------------------------------

    def _segment_tee(self, app_id: int, channel_id, evs, ids) -> None:
        """Append landed events, each under the id the store gave it, to
        the columnar segment store.  Disk pressure flips the degraded
        flag (and stops segment writes; the primary path keeps
        ingesting); any other failure is counted and swallowed: a
        derived file must never fail an ingest that already committed."""
        if self.segments is None or not evs:
            return
        try:
            if self._segment_bypass:
                self.segments.mark_bypassed(app_id, channel_id)
                return
            self.segments.append_events(app_id, channel_id, evs,
                                        event_ids=ids)
            if self._segment_degraded:
                logger.info("segment tee recovered (disk pressure cleared)")
            self._segment_degraded = False
        except SegmentDiskPressure as e:
            if not self._segment_degraded:
                logger.warning("segment tee degraded: %s — ingest "
                               "continues without segment coverage", e)
            self._segment_degraded = True
            self._segment_errors.inc(kind="disk_pressure")
        except Exception:
            logger.exception("segment tee failed (ingest unaffected)")
            self._segment_errors.inc(kind="error")

    # -- write-plane admission ----------------------------------------------

    def _backlog_depth(self) -> int:
        depth = self.spill.depth() if self.spill is not None else 0
        if self.shared_spill is not None:
            # cached: admission must never pay a storage RPC per request
            depth += self.shared_spill.cached_depth()
        return depth

    def _admit(self, n: int) -> Optional[Tuple[int, Any]]:
        """Reserve ``n`` events of write-plane budget, or answer the 429
        (the transport adds Retry-After).  Pair with :meth:`_release` in
        a finally.  Returns None on admission."""
        fault_point("ingest.admit")
        if self.ingest_budget <= 0:
            with self._inflight_lock:
                self._inflight += n
            return None
        depth = self._backlog_depth()
        with self._inflight_lock:
            if depth + self._inflight + n > self.ingest_budget:
                self._overload.inc()
                return 429, {"message":
                             "Ingest backlog exceeds "
                             f"PIO_INGEST_QUEUE_BUDGET={self.ingest_budget} "
                             f"({depth} queued, {self._inflight} in "
                             "flight); retry later."}
            self._inflight += n
        return None

    def _release(self, n: int) -> None:
        with self._inflight_lock:
            self._inflight -= n

    def _note_ingest(self, app_id: int, evs) -> None:
        """Advance the per-app ingest high-watermark gauge after events
        LANDED in the store.  First touch of an app seeds the floor from
        the backend's own MAX so a restarted server reports the true
        store-wide watermark, not just this process's ingest.  Spilled
        (202) events advance it only when replay lands them.

        Also the feedback-join hook: a landed buy/rate event echoing a
        served recommendation's id (``properties.pioServeId``) joins back
        to the served item set → online hit rate per model generation.
        Joining here — not at accept time — means spilled (202) events
        count only when replay lands them, the watermark's contract."""
        try:
            note_feedback_events(evs)
        except Exception:
            logger.exception("feedback join failed (ingest unaffected)")
        newest = None
        for ev in evs:
            us = epoch_us(ev.event_time)
            if us is not None and (newest is None or us > newest):
                newest = us
        if newest is None:
            return
        with self._latest_lock:
            cur = self._latest_ts.get(app_id)
            if cur is None:
                # The gauge is APP-level; the store's MAX is per channel,
                # so the seed must cover the default channel AND every
                # named channel — else a restart under channel traffic
                # would republish a regressed watermark.
                try:
                    events = self.storage.get_events()
                    maxes = [epoch_us(events.latest_event_time(app_id))]
                    for ch in self.storage.get_channels() \
                            .get_by_app_id(app_id):
                        maxes.append(epoch_us(
                            events.latest_event_time(app_id, ch.id)))
                    known = [m for m in maxes if m is not None]
                    cur = max(known) if known else newest
                except Exception:
                    # Seeding is best-effort; the in-process max is still
                    # a valid (conservative) watermark.
                    cur = newest
            val = max(cur, newest)
            self._latest_ts[app_id] = val
            # set under the lock: two concurrent ingests must publish in
            # watermark order, never let a smaller max land last
            self.stats.latest_ts.set(val / 1e6, app=str(app_id))

    # -- request-handling core (transport-independent, used by tests) ------

    def _auth(self, params: Dict[str, List[str]], headers) -> Tuple[Optional[Any], Optional[int]]:
        """Resolve accessKey → AccessKey row; (None, status) on failure."""
        key = None
        if "accessKey" in params:
            key = params["accessKey"][0]
        else:
            auth = headers.get("Authorization", "") if headers else ""
            if auth.startswith("Basic "):
                try:
                    key = base64.b64decode(auth[6:]).decode().split(":")[0]
                except Exception:
                    key = None
        if not key:
            return None, 401
        now = time.monotonic()
        hit = self._auth_cache.get(key)
        if hit is not None and now - hit[0] < self._auth_ttl:
            return hit[1], None
        try:
            row = self.storage.get_access_keys().get(key)
        except _UNAVAILABLE:
            if hit is not None and now - hit[0] < self._auth_stale_max_s:
                # Stale-if-error: metadata store down but this key was
                # RECENTLY valid (bounded by PIO_AUTH_STALE_MAX_S so a
                # long-revoked key cannot ride every future blip) —
                # degraded ingest (spill) beats turning a metadata
                # outage into rejected events.
                return hit[1], None
            raise
        if row is None:
            return None, 401
        self._auth_cache[key] = (now, row)
        return row, None

    def _resolve_channel(self, app_id: int, params) -> Tuple[Optional[int], Optional[str]]:
        if "channel" not in params:
            return None, None
        name = params["channel"][0]
        chans = self.storage.get_channels().get_by_app_id(app_id)
        match = next((c for c in chans if c.name == name), None)
        if match is None:
            return None, f"Invalid channel: {name}"
        return match.id, None

    def handle(self, method: str, path: str, params: Dict[str, List[str]],
               body: bytes, headers=None) -> Tuple[int, Any]:
        """Dispatch one request; returns (status, JSON-able payload)."""
        try:
            fault_point("http.event")
            return self._handle(method, path, params, body, headers)
        except DeadlineExceeded as e:
            self._shed.inc(server="event")
            return 504, {"message": str(e)}
        except _UNAVAILABLE as e:
            # Availability failure, NOT a client fault: 503 + Retry-After
            # (the transport adds the header) so well-behaved clients back
            # off instead of hammering a dying backend.
            return 503, {"message": f"Storage temporarily unavailable: {e}"}
        except (EventValidationError, StorageError) as e:
            return 400, {"message": str(e)}
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            # bad JSON or a bad-UTF-8 body — a client fault, per-item 400
            # (NOT bare ValueError: that would mislabel e.g. limit=abc)
            return 400, {"message": f"Invalid JSON: {e}"}
        except Exception:
            logger.exception("Event server internal error")
            return 500, {"message": "Internal server error."}

    def _insert_one(self, ev, key_row, channel_id) -> Tuple[int, Any]:
        """Single-event ingest through the breaker; degrades to the spill
        journal (202 + token) when the store is unavailable.  The token
        is pinned BEFORE the attempt so the spilled record replays the
        identical write (dedup'd if the original secretly committed).
        What spills is event_to_json(ev) — the PARSED event, with
        eventTime/creationTime frozen at ingest — not the raw client
        body, so replay after a long outage cannot re-stamp times."""
        events = self.storage.get_events()
        token = uuid.uuid4().hex
        denied = self._admit(1)
        if denied is not None:
            return denied
        try:
            with idempotency_key(token):
                event_id = self._breaker.call(
                    events.insert, ev, key_row.app_id, channel_id)
            self._note_ingest(key_row.app_id, [ev])
            self._segment_tee(key_row.app_id, channel_id, [ev], [event_id])
            return 201, {"eventId": event_id}
        except _UNAVAILABLE:
            spilled = self._spill_events([event_to_json(ev)],
                                         key_row.app_id, channel_id,
                                         token)
            if spilled is None:
                raise  # no journal → handle() maps to 503
            return 202, {"message": "Storage unavailable; event journaled "
                                    "for replay.", "token": spilled}
        finally:
            self._release(1)

    def _handle(self, method, path, params, body, headers) -> Tuple[int, Any]:
        if path == "/" and method == "GET":
            return 200, {"status": "alive"}
        if path == "/ready" and method == "GET":
            # Readiness (vs the "/" liveness ping): storage reachable —
            # breaker closed.  503 tells the load balancer to rotate this
            # instance out while it probes recovery.
            st = self._breaker.state
            disk_degraded = self._segment_degraded or (
                self.segments is not None and self.segments.disk_pressure())
            status_word = ("unavailable" if st != "closed"
                           else "degraded" if disk_degraded else "ready")
            body_ = {"status": status_word,
                     "breaker": st,
                     "spillBackend": self.spill_backend,
                     "spillQueueDepth": self.spill.depth() if self.spill
                     else 0,
                     "ingestInflight": self._inflight,
                     "ingestBudget": self.ingest_budget,
                     "diskDegraded": disk_degraded}
            if self.shared_spill is not None:
                # cached: a readiness probe must never block on a
                # storage RPC while storage is the thing that is down
                body_["sharedSpillDepth"] = \
                    self.shared_spill.cached_depth()
            if self.segments is not None:
                segs = self.segments.status()
                body_["segmentDirs"] = len(segs)
                body_["segmentCount"] = sum(s["segments"] for s in segs)
                if self._segment_bypass:
                    body_["segmentTee"] = "bypassed"
            # Disk-degraded is still ready (200): the primary store and
            # the spill journal keep accepting; only segment coverage
            # stopped growing.
            return (200 if st == "closed" else 503), body_
        if path == "/stats.json" and method == "GET":
            return 200, self.stats.snapshot()
        if path == "/metrics" and method == "GET":
            # THE process-wide exposition: every subsystem's instruments
            # (ingest, serving, training, plugins) in one scrape.
            # ?exemplars=1 opts into the OpenMetrics exemplar suffixes
            # (the port's histograms carry none yet).
            return 200, self.stats.registry.render(
                exemplars=param_bool(params, "exemplars"))

        key_row, err = self._auth(params, headers)
        if err:
            return err, {"message": "Invalid accessKey."}

        if path == "/traces.json" and method == "GET":
            # Behind accessKey, unlike the aggregate /metrics and
            # /stats.json views: traces carry per-request paths, timings
            # and request ids.
            return 200, traces_payload(params)
        channel_id, cerr = self._resolve_channel(key_row.app_id, params)
        if cerr:
            return 400, {"message": cerr}
        events = self.storage.get_events()

        if path == "/events.json" and method == "POST":
            obj = json.loads(body.decode("utf-8"))
            ev = event_from_json(obj)
            if key_row.events and ev.event not in key_row.events:
                return 403, {"message": f"Event {ev.event!r} not allowed by this key."}
            return self._insert_one(ev, key_row, channel_id)

        if path == "/batch/events.json" and method == "POST":
            arr = self._parse_batch_body(body, headers)
            if not isinstance(arr, list):
                return 400, {"message": "Batch body must be a JSON array "
                                        "or NDJSON lines."}
            cap = max_batch_size()
            if len(arr) > cap:
                return 400, {"message":
                             f"Batch size exceeds the limit of {cap}."}
            # Client-supplied batch idempotency token (?batchToken=):
            # sub-tokens derive deterministically from it, so a client
            # RETRY of the whole batch produces the same event ids and
            # dedups row-by-row — exactly-once from the SDK on down.
            bt = params.get("batchToken", [None])[0]
            if bt is not None and (len(bt) > 120
                                   or not _TOKEN_RE.fullmatch(bt)):
                return 400, {"message": "batchToken must be 1-120 chars "
                                        "of [A-Za-z0-9._-]."}
            # Validate per item, then ONE group-committed insert for the
            # valid ones — per-item inserts each paid a transaction commit
            # (48 µs apiece measured), capping batch ingest at ~10k ev/s.
            folded = self._fold_insert(key_row, channel_id, arr,
                                       batch_token=bt)
            if folded and all(s == 429 for s, _, _ in folded):
                # whole batch refused at admission: answer at the HTTP
                # layer so the transport attaches Retry-After
                return 429, folded[0][1]
            return 200, [{"status": s, **p} for s, p, _ in folded]

        if path == "/events.json" and method == "GET":
            q = {}
            if "startTime" in params:
                q["start_time"] = parse_iso8601(params["startTime"][0])
            if "untilTime" in params:
                q["until_time"] = parse_iso8601(params["untilTime"][0])
            for http_name, kw in (("entityType", "entity_type"),
                                  ("entityId", "entity_id"),
                                  ("targetEntityType", "target_entity_type"),
                                  ("targetEntityId", "target_entity_id")):
                if http_name in params:
                    q[kw] = params[http_name][0]
            if "event" in params:
                q["event_names"] = params["event"]
            limit = int(params.get("limit", ["20"])[0])
            if limit < -1:
                return 400, {"message": "limit must be >= -1."}
            q["limit"] = None if limit == -1 else limit
            q["reversed"] = params.get("reversed", ["false"])[0].lower() == "true"
            found = self._breaker.call(
                lambda: list(events.find(key_row.app_id, channel_id, **q)))
            # Deliberate divergence from upstream (the reference's
            # PARITY.md): upstream's event server answers an empty list
            # query with 404 {"message":"Not Found"}; here an empty match
            # is a valid result — 200 [].  Only the single-event
            # GET /events/<id> 404s.
            return 200, [event_to_json(e) for e in found]

        if path.startswith("/webhooks/") and method == "POST":
            # Reference: webhooks routes — JSON connectors at
            # /webhooks/<name>.json, form connectors at /webhooks/<name>.
            name = path[len("/webhooks/"):]
            is_json = name.endswith(".json")
            if is_json:
                name = name[:-len(".json")]
            try:
                connector = get_connector(name)
                if is_json:
                    payload = json.loads(body.decode("utf-8"))
                else:
                    payload = dict(parse_qsl(body.decode("utf-8")))
                # Burst coalescing: one provider delivery may
                # carry N messages (segment.io batches) — ALL of them ride
                # the batched-ingest fold as one group commit, never a
                # per-row create_event loop.  Malformed messages inside a
                # burst come back as Exception placeholders → per-item
                # 400, the rest of the delivery lands.
                items = connector.to_events_json(payload)
            except ConnectorError as e:
                return 400, {"message": str(e)}
            if not items:
                return 200, []
            folded = self._fold_insert(key_row, channel_id, items)
            if len(folded) == 1:
                # single-event deliveries keep the historical one-object
                # response shape (201 {"eventId": ...})
                s, p, _ = folded[0]
                return s, p
            return 200, [{"status": s, **p} for s, p, _ in folded]

        if path.startswith("/events/") and path.endswith(".json"):
            event_id = path[len("/events/"):-len(".json")]
            if method == "GET":
                ev = self._breaker.call(
                    events.get, event_id, key_row.app_id, channel_id)
                if ev is None:
                    return 404, {"message": "Not Found"}
                return 200, event_to_json(ev)
            if method == "DELETE":
                ok = self._breaker.call(
                    events.delete, event_id, key_row.app_id, channel_id)
                return (200, {"message": "Found"}) if ok else (404, {"message": "Not Found"})

        return 404, {"message": "Not Found"}

    # -- HTTP plumbing ------------------------------------------------------

    def _make_handler(server_self):
        class Handler(BaseHandler):
            server_log_name = "event-server"
            trace_server_name = "event"
            shed_pre_handle = True  # shed BEFORE auth/storage

            def pio_handle(self, method, path, params, body):
                return server_self.handle(method, path, params, body,
                                          self.headers)

            def pio_shed(self):
                server_self._shed.inc(server="event")

            def pio_retry_after_s(self):
                return server_self.retry_after_s

            def pio_on_complete(self, method, path, status, ms, body,
                                params):
                name = None
                if method == "POST" and path == "/events.json" \
                        and status == 201:
                    try:
                        name = json.loads(body).get("event")
                    except Exception:
                        name = None
                server_self.stats.record(status, name, ms)
                return server_self.plugins.on_request(
                    f"{method} {path}", status, ms) \
                    if server_self.plugins else None

            def do_GET(self):  # noqa: N802
                self.dispatch("GET")

            def do_POST(self):  # noqa: N802
                self.dispatch("POST")

            def do_DELETE(self):  # noqa: N802
                self.dispatch("DELETE")

        return Handler

    # -- native frontend entry ---------------------------------------------

    def native_fallback_batch(self, method: str, path_with_qs: str,
                              bodies: List[bytes]):
        """Batch entry for the C++ frontend: a run of same-route requests.

        A run of concurrent single-event POSTs becomes ONE group-committed
        ``create_batch`` through the same fold as ``/batch/events.json``
        — the per-request transaction commit is the single-event ingest
        ceiling.  Auth is query-param accessKey only (the native layer
        does not forward headers, so basic-auth clients must use the
        Python frontend).  Every item gets its own answer.
        """
        t0 = time.perf_counter()
        parsed = urlparse(path_with_qs)
        params = parse_qs(parsed.query)
        path = parsed.path
        if method == "POST" and path == "/events.json" and len(bodies) > 1:
            outs_named = self._ingest_group(params, bodies)
        else:
            outs_named = []
            for b in bodies:
                # handle() is total (decode errors → 400, the rest → 500);
                # the guard keeps the answered-every-item invariant should
                # that ever regress, so peers whose inserts committed are
                # never 500'd into client-retry duplicates.
                try:
                    status, payload = self.handle(method, path, params, b)
                except Exception:
                    logger.exception("native fallback item failed")
                    status, payload = 500, {"message":
                                            "Internal server error."}
                name = None
                if method == "POST" and path == "/events.json" \
                        and status == 201:
                    try:  # single body, cold path — one extra parse is fine
                        name = json.loads(b).get("event")
                    except Exception:
                        name = None
                outs_named.append((status, payload, name))
        dt = (time.perf_counter() - t0) * 1e3 / max(len(bodies), 1)
        for status, _, name in outs_named:
            self.stats.record(status, name, dt)
        if method == "GET" and path == "/metrics":
            # Explicit Prometheus exposition content type on the wire —
            # the native layer would otherwise label the text plain UTF-8.
            return [(s, p, "text/plain; version=0.0.4")
                    if isinstance(p, str) else (s, p)
                    for s, p, _ in outs_named]
        return [(s, p) for s, p, _ in outs_named]

    def _ingest_group(self, params, bodies: List[bytes]):
        """Decode each body, then the shared validate+group-insert fold;
        a bad key or channel answers every item alike."""
        key_row, err = self._auth(params, None)
        if err:
            return [(err, {"message": "Invalid accessKey."}, None)] \
                * len(bodies)
        channel_id, cerr = self._resolve_channel(key_row.app_id, params)
        if cerr:
            return [(400, {"message": cerr}, None)] * len(bodies)
        items: List[Any] = []
        for body in bodies:
            try:
                items.append(json.loads(body.decode("utf-8")))
            except ValueError as e:  # JSONDecodeError + UnicodeDecodeError
                items.append(ValueError(f"Invalid JSON: {e}"))
        return self._fold_insert(key_row, channel_id, items)

    @staticmethod
    def _parse_batch_body(body: bytes, headers) -> Any:
        """Decode a /batch/events.json body: a JSON array, or NDJSON —
        one event object per line (Content-Type ``application/x-ndjson``
        or any body whose first non-space byte is not ``[``).  A
        malformed NDJSON line becomes an Exception placeholder so
        ``_fold_insert`` answers it 400 PER-ITEM: one bad line never
        fails its cohort.  (A malformed JSON *array* is still a
        whole-request 400 — there are no item boundaries to salvage.)"""
        ctype = (headers.get("Content-Type", "") if headers else "") or ""
        text = body.decode("utf-8")
        ndjson = "ndjson" in ctype.lower() or "jsonlines" in ctype.lower()
        if not ndjson:
            head = text.lstrip()[:1]
            ndjson = bool(head) and head != "["
        if not ndjson:
            return json.loads(text)
        items: List[Any] = []
        for n, line in enumerate(text.splitlines(), start=1):
            if not line.strip():
                continue
            try:
                items.append(json.loads(line))
            except ValueError as e:
                items.append(ValueError(f"Invalid JSON on line {n}: {e}"))
        return items

    def _fold_insert(self, key_row, channel_id, items: List[Any],
                     batch_token: Optional[str] = None):
        """THE batched-ingest fold, shared by /batch/events.json and the
        webhook burst path:
        per-item validation against the key's event allowlist, then ONE
        group-committed ``create_batch`` for the valid events.  ``items``
        are parsed event JSON objects; an Exception instance stands for a
        body that failed to decode (reported per-item as 400).  Returns
        ``(status, payload, event_name)`` triples.

        Exactly-once: the whole batch is covered by ONE
        idempotency token (whole-call dedup at a hosted backend) plus a
        per-item sub-token each — event ids derive from the sub-tokens,
        so a replay after a crashed reply or a partial landing dedups
        row-by-row instead of all-or-nothing.  On storage outage the
        batch spills as ONE journal record carrying both token layers."""
        denied = self._admit(len(items))
        if denied is not None:
            st, payload = denied
            return [(st, payload, None)] * len(items)
        try:
            fault_point("ingest.batch")
            events = self.storage.get_events()
            outs: List[Any] = [None] * len(items)
            valid: List[Tuple[int, Any]] = []
            for i, item in enumerate(items):
                if isinstance(item, Exception):
                    outs[i] = (400, {"message": str(item)}, None)
                    continue
                try:
                    ev = event_from_json(item)
                    if key_row.events and ev.event not in key_row.events:
                        outs[i] = (403, {"message":
                                         f"Event {ev.event!r} not allowed "
                                         "by this key."}, None)
                        continue
                    valid.append((i, ev))
                except (EventValidationError, StorageError) as e:
                    outs[i] = (400, {"message": str(e)}, None)
                except Exception:
                    logger.exception("ingest item failed")
                    outs[i] = (500, {"message": "Internal server error."},
                               None)
            if valid:
                if batch_token is not None:
                    # Deterministic sub-tokens from the CLIENT's token,
                    # keyed by item position: a client retry of the same
                    # batch re-derives the same event ids → per-item
                    # dedup even when the first reply was lost.
                    token = batch_token
                    subtoks = [f"{batch_token}.{i}" for i, _ in valid]
                else:
                    token = uuid.uuid4().hex  # pinned BEFORE the attempt
                    subtoks = [uuid.uuid4().hex for _ in valid]
                try:
                    with idempotency_key(token):
                        ids = self._breaker.call(
                            events.create_batch, [ev for _, ev in valid],
                            key_row.app_id, channel_id, tokens=subtoks)
                    for (i, ev), eid in zip(valid, ids):
                        outs[i] = (201, {"eventId": eid}, ev.event)
                    self._note_ingest(key_row.app_id,
                                      [ev for _, ev in valid])
                    self._segment_tee(key_row.app_id, channel_id,
                                      [ev for _, ev in valid], ids)
                except _UNAVAILABLE as e:
                    # Mid-batch storage outage: EVERY valid item gets an
                    # explicit answer — spilled (202 + the batch's token)
                    # when the journal is on, 503 when it is not.  Never
                    # a partial silent drop.  The whole batch journals as
                    # ONE record under the token it was attempted with
                    # PLUS its per-item sub-tokens, so the replay
                    # re-issues the identical create_batch and any rows
                    # the crashed attempt already committed dedup away.
                    spilled = self._spill_events(
                        [event_to_json(ev) for _, ev in valid],
                        key_row.app_id, channel_id, token, tokens=subtoks)
                    for i, _ in valid:
                        outs[i] = ((202, {"message":
                                          "Storage unavailable; event "
                                          "journaled for replay.",
                                          "token": spilled}, None)
                                   if spilled is not None else
                                   (503, {"message":
                                          "Storage temporarily "
                                          f"unavailable: {e}"}, None))
                except StorageError as e:
                    for i, _ in valid:
                        outs[i] = (400, {"message": str(e)}, None)
            return outs
        finally:
            self._release(len(items))

    def start(self, block: bool = False) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0
        logger.info("Event Server listening on %s:%d", self.host, self.port)
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        if self._httpd:
            # shutdown() stops accepting; server_close() joins in-flight
            # handler threads (socketserver block_on_close), so responses
            # already being written complete before we tear down.
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._lease_drainer is not None:
            self._lease_drainer.stop()
        if self._replay is not None:
            self._replay.stop()
        elif self.spill is not None:
            self.spill.close()
        if self.segments is not None:
            try:
                # seal open windows so a clean shutdown leaves the whole
                # ingest history claimable by the next refresh read
                if not self._segment_bypass:
                    self.segments.seal_all()
            except Exception:
                logger.exception("segment seal on shutdown failed")
            self.segments.release()
        self.plugins.stop()

    def drain(self) -> None:
        """Graceful SIGTERM/SIGINT path: stop accepting, finish in-flight
        requests, flush the spill journal to disk (it replays on next
        boot or when storage recovers)."""
        shared = (self.shared_spill.cached_depth()
                  if self.shared_spill is not None else None)
        logger.info("Event server draining (local spill depth=%d, shared "
                    "queue depth=%s)",
                    self.spill.depth() if self.spill else 0, shared)
        self.stop()
