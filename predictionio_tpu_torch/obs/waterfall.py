"""Per-request serving latency waterfall.

Port of ``predictionio_tpu/obs/waterfall.py``.  ``pio_request_ms`` says
ONE number about a request that crosses six subsystems (admission queue →
micro-batch window → generation snapshot → retrieval rung → the card's
dispatch → transport shed).  This module carries a per-stage
decomposition on every ``/queries.json`` request:

========== ==============================================================
stage       meaning
========== ==============================================================
ingress     transport receipt → bind start (socket body read, trace
            setup, routing, pre-admission deadline check)
queue_wait  admission → a batcher gather picked the entry up
batch_wait  gather pickup → dispatch start (window / deadline-close wait)
bind        JSON parse + query-dataclass bind (handler thread)
cache       result-cache key canonicalization + lookup (on a
            hit this is the ONLY serving stage — queue/dispatch never
            run — so attribution stays honest about the fast path)
dispatch    the ONE vectorized model dispatch the batch shared
resume      dispatch done → the handler thread actually running again
            (event wake-up under GIL/thread contention)
retrieval   corpus top-K inside the dispatch (rung-tagged; ⊂ dispatch,
            NOT additive with it)
serialize   result → JSON bytes (the ``http.respond`` write path)
shed_check  scheduler return → the respond write (span unwind, late-shed
            verdict, stats hooks, response-header assembly)
========== ==============================================================

Three consumers, one collector:

- ``pio_serve_stage_ms{stage}`` histogram family, every bucket carrying
  an exemplar trace id that resolves via ``/traces.json?request_id=``;
- a ``waterfall`` event attached to the request's own span tree;
- an opt-in wide-event JSONL (``PIO_REQUEST_LOG=path``): one
  self-contained line per request for offline attribution
  (the reference's ``tools/attribute_serve.py`` reads it).

Thread model: the handler thread owns the :class:`Waterfall` (contextvar
``begin_request``); the batcher thread stamps its stages through the
``Pending`` hand-off, and the retrieval facade — which runs on the
batcher thread with no request context — records into a per-DISPATCH
sink (:func:`dispatch_sink`) that the batcher then merges into every
member.  All writes go through one lock; a waiter that walked (deadline)
closes the collector, after which late stamps are dropped instead of
racing the final observation.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from predictionio_tpu_torch.obs.metrics import get_registry

logger = logging.getLogger(__name__)

__all__ = [
    "ATTESTED_STAGES",
    "SERVE_STAGES",
    "WALL_STAGES",
    "Waterfall",
    "active_sample_u",
    "begin_request",
    "current_waterfall",
    "dispatch_sink",
    "note_transport_start",
    "record_stage",
    "stage_histogram",
    "transport_start",
]

SERVE_STAGES = ("ingress", "queue_wait", "batch_wait", "bind", "cache",
                "dispatch", "resume", "retrieval", "serialize",
                "shed_check")
# The additive stages: their sum should reconcile with the request's
# total wall (retrieval is a sub-component of dispatch; resume is the
# handler thread's post-dispatch wake-up — event set → actually running
# again under GIL/thread contention).
WALL_STAGES = ("ingress", "queue_wait", "batch_wait", "bind", "cache",
               "dispatch", "resume", "serialize", "shed_check")
# The stages the server-attested X-PIO-Server-Ms wall CONTAINS: the
# attestation header is read before the response is written (headers
# must be assembled first), so serialize — the respond/socket write —
# lies outside it by construction.  Reconciling against the attestation
# must sum exactly these.
ATTESTED_STAGES = ("ingress", "queue_wait", "batch_wait", "bind", "cache",
                   "dispatch", "resume", "shed_check")


def stage_histogram(registry=None):
    """THE per-stage latency family (get-or-create on the registry)."""
    return (registry or get_registry()).histogram(
        "pio_serve_stage_ms",
        "Per-request serving latency by pipeline stage "
        "(retrieval is a sub-stage of dispatch, not additive).",
        ("stage",))


class Waterfall:
    """One request's stage collector (thread-safe, close-once)."""

    __slots__ = ("stages", "attrs", "_lock", "_closed", "_marks",
                 "sample_u")

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._marks: Dict[str, float] = {}
        # THE request's shared uniform sample draw: set once
        # by the engine handler; the wide-event log sampler
        # (PIO_REQUEST_LOG_SAMPLE) and the prediction record stream
        # (PIO_QUALITY_SAMPLE) each compare it against their own rate —
        # one RNG draw per request, many thresholds.
        self.sample_u: Optional[float] = None

    def attr(self, name: str, default: Any = None) -> Any:
        """One attribute under the lock (the engine handler reads the
        generation the batcher stamped onto the dispatch)."""
        with self._lock:
            return self.attrs.get(name, default)

    def note(self, **attrs) -> None:
        """Attach attributes without a stage stamp (the serve id rides
        here into the wide event AND to the transport's response-header
        hook)."""
        with self._lock:
            if not self._closed:
                self.attrs.update(attrs)

    def mark(self, name: str) -> None:
        """Record a wall-clock boundary (``time.perf_counter``) another
        layer closes into a stage later — the engine handler marks
        ``handler_done`` when the scheduler hands the result back, and
        the transport driver stamps ``shed_check`` from that mark so the
        span-unwind / stats-hook segment between them is accounted."""
        with self._lock:
            if not self._closed:
                self._marks[name] = time.perf_counter()

    def take_mark(self, name: str) -> Optional[float]:
        with self._lock:
            return self._marks.pop(name, None)

    def stamp(self, stage: str, ms: float, **attrs) -> None:
        """Add ``ms`` to a stage (accumulates: a retried dispatch bills
        both attempts).  Dropped once the request finalized."""
        with self._lock:
            if self._closed:
                return
            self.stages[stage] = self.stages.get(stage, 0.0) + float(ms)
            if attrs:
                self.attrs.update(attrs)

    def merge(self, stages: Dict[str, float], **attrs) -> None:
        with self._lock:
            if self._closed:
                return
            for k, v in stages.items():
                self.stages[k] = self.stages.get(k, 0.0) + float(v)
            if attrs:
                self.attrs.update(attrs)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.stages)

    def export(self) -> "tuple[Dict[str, float], Dict[str, Any]]":
        """(stages, attrs) copy — the batcher reads its per-dispatch sink
        once and fans the result out to every member request."""
        with self._lock:
            return dict(self.stages), dict(self.attrs)

    def finalize(self, *, trace_id: Optional[str], status: int,
                 total_ms: float, attested_ms: Optional[float] = None,
                 registry=None) -> Dict[str, Any]:
        """Close the collector and publish: histogram observations (with
        the request's trace id as each bucket's exemplar) + the wide
        event to ``PIO_REQUEST_LOG``.  ``attested_ms`` is the SAME
        reading the ``X-PIO-Server-Ms`` header carried, recorded so the
        wide event is self-contained for the stage-sum-vs-attestation
        reconciliation.  Returns the wide-event document (the caller may
        attach it to the request span)."""
        with self._lock:
            if self._closed:
                return {}
            self._closed = True
            stages = dict(self.stages)
            attrs = dict(self.attrs)
        hist = stage_histogram(registry)
        for stage, ms in stages.items():
            hist.observe(ms, exemplar=trace_id, stage=stage)
        doc: Dict[str, Any] = {
            "ts": round(time.time(), 3),
            "traceId": trace_id,
            "status": int(status),
            "totalMs": round(total_ms, 3),
            "stages": {k: round(v, 3) for k, v in stages.items()},
            "stageSumMs": round(
                sum(stages.get(s, 0.0) for s in WALL_STAGES), 3),
            "attestedSumMs": round(
                sum(stages.get(s, 0.0) for s in ATTESTED_STAGES), 3),
            **{k: v for k, v in attrs.items()},
        }
        if attested_ms is not None:
            doc["serverMs"] = round(attested_ms, 3)
        _request_log_write(doc, self.sample_u)
        return doc


# -- context plumbing -------------------------------------------------------

_current: contextvars.ContextVar[Optional[Waterfall]] = \
    contextvars.ContextVar("pio_waterfall", default=None)
# Per-DISPATCH sink: set by the batcher around the model dispatch so
# library code below it (retrieval facade) can record stages without any
# notion of the member requests sharing the dispatch.
_sink: contextvars.ContextVar[Optional[Waterfall]] = \
    contextvars.ContextVar("pio_waterfall_sink", default=None)
# The transport driver's request-receipt wall clock (perf_counter):
# noted at the top of BaseHandler.dispatch — BEFORE any collector exists
# — so the engine handler can stamp ``ingress`` (receipt → bind) when it
# arms the waterfall mid-handle.  Overwritten per request on keep-alive
# handler threads.
_transport_t0: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("pio_waterfall_t0", default=None)


def note_transport_start(t0: float) -> None:
    _transport_t0.set(t0)


def transport_start() -> Optional[float]:
    return _transport_t0.get()


@contextlib.contextmanager
def begin_request():
    """Attach a fresh :class:`Waterfall` to the current context (the
    handler thread's request scope)."""
    wf = Waterfall()
    token = _current.set(wf)
    try:
        yield wf
    finally:
        _current.reset(token)


def activate() -> Waterfall:
    """Unscoped variant of :func:`begin_request`: the engine handler
    arms the collector mid-``pio_handle`` and the TRANSPORT driver
    (``BaseHandler.dispatch``) finalizes it after the response is
    written — the serialize/shed_check stages live outside the handler's
    own scope, so a ``with`` block there would strip the contextvar too
    early.  :func:`deactivate` clears it (keep-alive connections reuse
    the handler thread; a leaked collector would swallow the NEXT
    request's stamps)."""
    wf = Waterfall()
    _current.set(wf)
    return wf


def deactivate() -> None:
    _current.set(None)


def current_waterfall() -> Optional[Waterfall]:
    return _current.get()


@contextlib.contextmanager
def dispatch_sink(wf: Waterfall):
    """Route :func:`record_stage` calls in this context into ``wf`` (the
    batcher's per-dispatch collector)."""
    token = _sink.set(wf)
    try:
        yield wf
    finally:
        _sink.reset(token)


def active_sample_u() -> Optional[float]:
    """The active collector's shared per-request sample draw
    — dispatch sink first (the batcher stamps the members' draw onto it),
    else the request's own waterfall.  None when unsampled or outside any
    request, so samplers below the facade (retrieval recall capture) cost
    one contextvar read on the common path."""
    wf = _sink.get() or _current.get()
    return wf.sample_u if wf is not None else None


def record_stage(stage: str, ms: float, **attrs) -> None:
    """Stamp a stage onto whatever collector is active — the dispatch
    sink first (batcher thread), else the request's own waterfall.  A
    no-op outside both, so instrumented library code costs one
    contextvar read on un-instrumented paths."""
    wf = _sink.get() or _current.get()
    if wf is not None:
        wf.stamp(stage, ms, **attrs)


# -- wide-event request log (PIO_REQUEST_LOG) -------------------------------

_log_lock = threading.Lock()


def _log_sample_rate() -> float:
    """``PIO_REQUEST_LOG_SAMPLE`` (default 1.0 = every request): the
    wide-event log's share of requests.  Read per write, like the path —
    an operator can turn a hot server's log down live."""
    raw = os.environ.get("PIO_REQUEST_LOG_SAMPLE")
    if raw is None or not str(raw).strip():
        return 1.0
    try:
        return min(max(float(raw), 0.0), 1.0)
    except (TypeError, ValueError):
        return 1.0


def _request_log_write(doc: Dict[str, Any],
                       sample_u: Optional[float] = None) -> None:
    path = os.environ.get("PIO_REQUEST_LOG")
    if not path:
        return
    rate = _log_sample_rate()
    if rate < 1.0:
        # One sampling decision per request: reuse the handler's shared
        # draw when it made one (so the wide event and the prediction
        # stream describe the SAME sampled population), else draw here.
        import random as _random

        u = sample_u if sample_u is not None else _random.random()
        if u >= rate:
            return
    line = json.dumps(doc, separators=(",", ":"))
    try:
        # Handle not cached: the path may change/rotate live (same
        # discipline as PIO_TRACE_FILE).
        with _log_lock, open(path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
    except OSError:
        logger.exception("cannot append request log to %s", path)
