"""Request tracing: span trees, trace ids, JSONL export, slow-call logs.

Port of ``predictionio_tpu/obs/trace.py`` (pure Python, the same
behaviour and the same record format)::

    with trace("http.request", trace_id=req_id, server="engine") as t:
        with span("predict.algorithm", algo=name):
            ...

- :func:`trace` opens a ROOT span and binds a trace id for the current
  context (``contextvars``, so concurrent request-handler threads never
  share state).  On exit the finished span tree is handed to the
  process :class:`TraceRecorder`.
- :func:`span` opens a child of the innermost open span.  Outside any
  trace it still times the block but records nothing, so instrumented
  library code costs two ``perf_counter`` calls when tracing is not
  active.
- Trace ids are accepted and propagated over HTTP through
  ``X-Request-ID`` (:mod:`predictionio_tpu_torch.server.http`); ids are
  sanitized here so a hostile header cannot smuggle newlines into the
  JSONL export or the response headers.

Recorder outputs, all optional and all process-wide:

- an in-memory ring of the last N finished traces (``GET /traces.json``
  on both servers; N from ``PIO_TRACE_RING``, default 256);
- a JSONL append to ``PIO_TRACE_FILE`` (one trace a line);
- a WARNING log for any trace slower than its ``slow_ms`` threshold (the
  HTTP frontends pass ``PIO_SLOW_REQUEST_MS``, default 1000; 0
  disables).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "Span",
    "span",
    "trace",
    "attach_event",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "sanitize_trace_id",
    "TraceRecorder",
    "get_recorder",
    "set_recorder",
]

# Innermost open span for this context (None = tracing inactive).
_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("pio_current_span", default=None)
_current_trace_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("pio_current_trace_id", default=None)

_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9._:-]")
_TRACE_ID_MAX = 128


def new_trace_id() -> str:
    return uuid.uuid4().hex


def sanitize_trace_id(raw: Optional[str]) -> Optional[str]:
    """Clamp a client-supplied X-Request-ID to a safe charset/length;
    None/empty (or fully-invalid) ids mean "generate one"."""
    if not raw:
        return None
    cleaned = _TRACE_ID_RE.sub("", str(raw))[:_TRACE_ID_MAX]
    return cleaned or None


def current_trace_id() -> Optional[str]:
    return _current_trace_id.get()


def current_span() -> Optional[Span]:
    """The innermost OPEN span of this context (None = tracing inactive).
    Lets out-of-band instrumentation (``obs.runtime.publish_event``)
    attach annotations to the request or run that triggered them."""
    return _current_span.get()


# Map perf_counter readings to wall clock ONCE: spans then pay a single
# perf_counter call at open instead of an extra time.time() each — the
# span tree sits on ~ms-scale request hot paths and must cost µs.
_EPOCH_WALL = time.time() - time.perf_counter()


class Span:
    """One timed node of a trace tree (name, attrs, children)."""

    __slots__ = ("name", "attrs", "children", "_t0", "duration_ms")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.attrs: Dict[str, Any] = attrs if attrs is not None else {}
        self.children: List[Span] = []
        self._t0 = time.perf_counter()
        self.duration_ms: Optional[float] = None

    @property
    def start_s(self) -> float:
        return _EPOCH_WALL + self._t0

    def finish(self) -> None:
        if self.duration_ms is None:
            self.duration_ms = (time.perf_counter() - self._t0) * 1e3

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def children_ms(self) -> float:
        return sum(c.duration_ms or 0.0 for c in self.children)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "startS": round(self.start_s, 6),
            "durationMs": round(self.duration_ms or 0.0, 4),
        }
        if self.attrs:
            d["attrs"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        # Structured attrs keep their shape in the recorded trace instead
        # of collapsing to repr strings.
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


class span:
    """Child span of the innermost open span; no-op-cheap outside a trace.

    A hand-rolled context manager (not ``contextlib``): the generator
    protocol costs several µs per use, and several spans ride every
    served query.  Detached use (no open trace) still times the block — callers
    may read ``.duration_ms`` — but records nothing.
    """

    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, **attrs):
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        parent = _current_span.get()
        s = self._span = Span(self._name, self._attrs)
        if parent is None:
            self._token = None
        else:
            parent.children.append(s)
            self._token = _current_span.set(s)
        return s

    def __exit__(self, *exc) -> bool:
        self._span.finish()
        if self._token is not None:
            _current_span.reset(self._token)
        return False


def attach_event(parent: Optional[Span], name: str, **attrs) -> Span:
    """Zero-duration annotation on an EXPLICIT parent span.

    ``obs.runtime.publish_event`` attaches to the caller's contextvar
    span — useless for a cross-thread producer, which annotates a
    REQUEST span from its own thread.  The caller guarantees the parent's owning thread is parked
    (the request handler blocks on its pending result while the batcher
    writes), so the child append needs no lock.  ``parent=None`` records
    a standalone single-span trace instead, so the evidence is never
    silently dropped.
    """
    ev = Span(name, attrs)
    ev.duration_ms = 0.0
    if parent is not None:
        parent.children.append(ev)
        return ev
    get_recorder().record(new_trace_id(), ev)
    return ev


@contextlib.contextmanager
def trace(name: str, trace_id: Optional[str] = None,
          slow_ms: Optional[float] = None, recorder: Optional["TraceRecorder"] = None,
          **attrs):
    """Root span + trace id binding; records the finished tree on exit.

    Nested ``trace()`` calls degrade to plain child spans of the enclosing
    trace (one tree per request/run, never silently dropped timing).
    """
    if _current_span.get() is not None:
        with span(name, **attrs) as s:
            yield s
        return
    tid = sanitize_trace_id(trace_id) or new_trace_id()
    root = Span(name, attrs)
    tok_span = _current_span.set(root)
    tok_tid = _current_trace_id.set(tid)
    try:
        yield root
    finally:
        root.finish()
        _current_span.reset(tok_span)
        _current_trace_id.reset(tok_tid)
        (recorder or get_recorder()).record(tid, root, slow_ms=slow_ms)


class TraceRecorder:
    """Ring buffer + JSONL sink + slow-trace logging for finished traces."""

    def __init__(self, ring_size: Optional[int] = None):
        if ring_size is None:
            try:
                ring_size = int(os.environ.get("PIO_TRACE_RING", "256"))
            except ValueError:
                ring_size = 256
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(ring_size, 1))
        self._file_lock = threading.Lock()

    def record(self, trace_id: str, root: Span,
               slow_ms: Optional[float] = None) -> None:
        doc = {"traceId": trace_id, **root.to_dict()}
        with self._lock:
            self._ring.append(doc)
        path = os.environ.get("PIO_TRACE_FILE")
        if path:
            line = json.dumps(doc, separators=(",", ":"))
            try:
                # One atomic-ish append per trace; the file handle is not
                # cached so PIO_TRACE_FILE may change (or rotate) live.
                with self._file_lock, open(path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                logger.exception("cannot append trace to %s", path)
        dur = root.duration_ms or 0.0
        if slow_ms is not None and slow_ms > 0 and dur >= slow_ms:
            logger.warning(
                "slow %s: %.1f ms (threshold %.0f ms) trace=%s attrs=%s",
                root.name, dur, slow_ms, trace_id, root.attrs)

    def recent(self, n: int = 50, *, request_id: Optional[str] = None,
               min_ms: Optional[float] = None) -> List[Dict[str, Any]]:
        """Last ``n`` finished traces, most recent first (/traces.json).

        ``request_id`` filters to exact trace-id matches: one request's
        trace, not the whole ring.  ``min_ms`` keeps only traces at least
        that slow."""
        with self._lock:
            items = list(self._ring)
        out = items[::-1]
        if request_id is not None:
            out = [t for t in out if t.get("traceId") == request_id]
        if min_ms is not None:
            out = [t for t in out if (t.get("durationMs") or 0.0) >= min_ms]
        return out[:max(n, 0)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_recorder = TraceRecorder()
_recorder_lock = threading.Lock()


def get_recorder() -> TraceRecorder:
    return _recorder


def set_recorder(recorder: TraceRecorder) -> TraceRecorder:
    global _recorder
    with _recorder_lock:
        prev, _recorder = _recorder, recorder
    return prev


def slow_request_ms() -> float:
    """The HTTP frontends' slow-request threshold (``PIO_SLOW_REQUEST_MS``,
    default 1000 ms; 0 or negative disables the WARNING log)."""
    try:
        return float(os.environ.get("PIO_SLOW_REQUEST_MS", "1000"))
    except ValueError:
        return 1000.0
