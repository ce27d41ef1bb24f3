"""Shared HTTP plumbing for the port's servers.

Port of ``predictionio_tpu/server/http.py``:

- :class:`ThreadingHTTPServer` — stdlib ``ThreadingHTTPServer`` with a
  128-deep accept backlog (the default of 5 resets connections under
  load bursts).
- ``X-Request-ID`` handling: :func:`incoming_request_id` pulls and
  sanitizes the client-supplied id (or a fresh one is generated); every
  response carries the effective id back.
- :class:`BaseHandler` — HTTP/1.1 keep-alive, Nagle off (Nagle plus
  delayed ACK between a multi-write response and a keep-alive client
  stalls every request ~40 ms), debug-level access logs, and the one
  request path :meth:`BaseHandler.dispatch`: the trace root
  ``http.request`` with its ``http.read`` / ``http.handle`` /
  ``http.respond`` spans (the trace id is the request id), the
  ``X-PIO-Deadline-Ms`` scope with optional pre-handle shedding (504),
  the never-late-200 rewrite of a read-only answer that came back past
  its budget (504, ``shed_late_responses``) with its
  ``X-PIO-Deadline-Remaining-Ms`` attestation, the per-server completion
  hook (stats and plugins), the server's own wall time
  (``X-PIO-Server-Ms``) and the ``Retry-After`` hint on degraded
  answers.  Subclasses implement :meth:`BaseHandler.pio_handle` and
  override the small hooks below it.  A handler answers ``(status,
  payload)``, ``(status, payload, content_type)`` when the payload is
  already the body (the result cache's hit bytes), or ``(status,
  payload, content_type, headers)`` when it also sets response headers
  (the profiler artifact's ``Content-Disposition``).  The path also closes
  the request's latency waterfall when a handler armed one
  (:mod:`predictionio_tpu_torch.obs.waterfall`): it notes the receipt
  time for ``ingress``, stamps ``shed_check`` and ``serialize``,
  finalizes the collector and attaches its ``waterfall`` event to the
  request's span.
- :func:`traces_payload` / :func:`timeline_payload` — the shared
  ``GET /traces.json`` and ``GET /timeline.json`` views.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import (
    BaseHTTPRequestHandler,
    ThreadingHTTPServer as _ThreadingHTTPServer,
)
from typing import Any, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.obs import waterfall as _waterfall
from predictionio_tpu_torch.obs.trace import (
    attach_event,
    current_trace_id,
    get_recorder,
    sanitize_trace_id,
    slow_request_ms,
    span,
    trace,
)
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience.deadline import DEADLINE_HEADER

logger = logging.getLogger(__name__)

__all__ = [
    "ThreadingHTTPServer",
    "BaseHandler",
    "HandlerResult",
    "REQUEST_ID_HEADER",
    "DEADLINE_HEADER",
    "PROMETHEUS_CTYPE",
    "incoming_request_id",
    "incoming_deadline_ms",
    "param_bool",
    "payload_bytes",
    "timeline_payload",
    "traces_payload",
]

REQUEST_ID_HEADER = "X-Request-ID"
PROMETHEUS_CTYPE = "text/plain; version=0.0.4"

class ThreadingHTTPServer(_ThreadingHTTPServer):
    # Default accept backlog (5) resets connections under load bursts.
    request_queue_size = 128


def incoming_request_id(headers) -> Optional[str]:
    """Sanitized client-supplied ``X-Request-ID`` (None → generate one):
    clamped to ``[A-Za-z0-9._:-]`` and 128 characters."""
    if headers is None:
        return None
    return sanitize_trace_id(headers.get(REQUEST_ID_HEADER))


def incoming_deadline_ms(headers) -> Optional[float]:
    """Client-declared time budget (``X-PIO-Deadline-Ms``); None when
    absent or unparseable — a garbage header must not 500 the request."""
    if headers is None:
        return None
    raw = headers.get(DEADLINE_HEADER)
    if not raw:
        return None
    try:
        budget = float(raw)
    except ValueError:
        return None
    return budget if budget >= 0 else None


def payload_bytes(payload: Any) -> Tuple[bytes, str]:
    """(body, content-type) for a handler payload: ``str`` means
    Prometheus text exposition, anything else is JSON."""
    if isinstance(payload, str):
        return payload.encode(), PROMETHEUS_CTYPE
    return json.dumps(payload).encode(), "application/json; charset=UTF-8"


def param_bool(params: Optional[Dict[str, List[str]]], key: str,
               default: bool = False) -> bool:
    """Boolean query param in the same dialect as env_bool — so
    ``?exemplars=0`` / ``?exemplars=off`` actually means OFF (a bare
    presence check would read an explicit opt-out as opt-in)."""
    vals = (params or {}).get(key) or [""]
    return env_bool(vals[0], default)


def timeline_payload(params: Dict[str, List[str]]) -> Dict[str, Any]:
    """The shared ``GET /timeline.json`` view over the process step
    timeline.  ``?model=`` filters, ``?n=`` bounds the record count, and
    ``?format=chrome`` returns Chrome-trace JSON (chrome://tracing /
    Perfetto); ``?format=summary`` returns only the per-model phase
    aggregation."""
    from predictionio_tpu_torch.obs.runtime import get_timeline

    tl = get_timeline()
    model = params.get("model", [None])[0]
    try:
        n = int(params.get("n", ["256"])[0])
    except ValueError:
        n = 256
    fmt = params.get("format", ["raw"])[0]
    if fmt == "chrome":
        return tl.to_chrome_trace(max(n, 1), model=model)
    models = tl.models() if model is None else [model]
    summaries = {m: tl.summary(m) for m in models}
    if fmt == "summary":
        return {"models": summaries}
    return {"steps": tl.recent(n, model=model), "models": summaries}


def traces_payload(params: Dict[str, List[str]]) -> Dict[str, Any]:
    """The shared ``GET /traces.json`` view (every frontend).

    ``?request_id=`` resolves one exact trace, ``?min_ms=`` keeps only
    traces at least that slow, ``?limit=`` bounds the count (default 50,
    clamped to the ring)."""
    request_id = sanitize_trace_id(params.get("request_id", [None])[0])
    try:
        limit = int(params.get("limit", ["50"])[0])
    except ValueError:
        limit = 50
    min_ms: Optional[float] = None
    raw = params.get("min_ms", [None])[0]
    if raw:
        try:
            min_ms = float(raw)
        except ValueError:
            min_ms = None
    return {"traces": get_recorder().recent(
        limit, request_id=request_id, min_ms=min_ms)}


# A handler hook's result: (status, payload) with the content type
# inferred by payload_bytes, (status, payload, ctype) when the frontend
# picks its own (the dashboard's HTML pages), or
# (status, payload, ctype, headers) when it also sets response headers
# (the profiler artifact's Content-Disposition).
HandlerResult = Union[Tuple[int, Any], Tuple[int, Any, str],
                      Tuple[int, Any, str, Dict[str, str]]]


class BaseHandler(BaseHTTPRequestHandler):
    """Shared request-handler skeleton; subclasses implement
    :meth:`pio_handle` and route their do_* methods through
    :meth:`dispatch`."""

    protocol_version = "HTTP/1.1"
    # See module docstring: keep-alive + Nagle stalls every request ~40 ms.
    disable_nagle_algorithm = True
    server_log_name = "server"
    # Short server tag on the trace root ("engine", "event").
    trace_server_name = "server"
    # Shed with 504 BEFORE pio_handle when the deadline is already spent
    # (the event server's pre-auth shed).
    shed_pre_handle = False
    # Rewrite a 2xx whose budget ran out DURING handling into a 504 (an
    # expired request gets 504, never a slow 200).  The verdict and the
    # X-PIO-Deadline-Remaining-Ms attestation are ONE measurement, so a
    # 200 always attests positive remaining budget.  Only safe on
    # non-mutating frontends — the engine server opts in; an event-server
    # write that SUCCEEDED must report its success.
    shed_late_responses = False
    # Degraded answers that carry the Retry-After backoff hint: spill
    # accepts (202), admission rejections (429), and unavailability
    # (503) all want the client to come back, just later.
    retry_after_statuses = (202, 429, 503)

    # -- per-frontend hooks --------------------------------------------------

    def pio_handle(self, method: str, path: str,
                   params: Dict[str, List[str]], body: bytes
                   ) -> HandlerResult:
        """Handle one request inside the trace and deadline scope;
        returns (status, payload), (status, body, content_type) or
        (status, body, content_type, headers)."""
        raise NotImplementedError

    def pio_on_complete(self, method: str, path: str, status: int,
                        ms: float, body: bytes,
                        params: Dict[str, List[str]]
                        ) -> Optional[Dict[str, str]]:
        """Post-handle hook (stats recording, plugins); runs BEFORE the
        response is written — a client reading /stats.json right after
        its own request completes must see it counted.  May return extra
        response headers."""
        return None

    def pio_retry_after_s(self) -> Optional[int]:
        """Backoff hint attached to ``retry_after_statuses`` answers."""
        return None

    def pio_shed(self) -> None:
        """Count a transport-level deadline shed (pre-handle 504)."""

    # -- the request path ---------------------------------------------------

    def dispatch(self, method: str) -> None:
        t0 = time.perf_counter()
        # Receipt wall for the waterfall's ingress stage (the engine
        # handler arms the collector mid-handle, after body read+routing
        # already happened — it reads this to bill them).
        _waterfall.note_transport_start(t0)
        with trace("http.request",
                   trace_id=incoming_request_id(self.headers),
                   slow_ms=slow_request_ms(),
                   server=self.trace_server_name, method=method) as troot:
            parsed = urlparse(self.path)
            troot.set(path=parsed.path)
            params = parse_qs(parsed.query)
            with span("http.read"):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
            remaining: Optional[float] = None
            with _deadline.deadline_scope(
                    incoming_deadline_ms(self.headers)):
                if self.shed_pre_handle and _deadline.exceeded():
                    # A request whose budget is already gone must not
                    # queue behind auth/storage.
                    self.pio_shed()
                    out: Tuple = (504, {"message": "Deadline exceeded."})
                else:
                    with span("http.handle"):
                        out = self.pio_handle(method, parsed.path, params,
                                              body)
                    remaining = _deadline.remaining_ms()
            t_shed = time.perf_counter()
            status, payload = out[0], out[1]
            ctype = out[2] if len(out) >= 3 else None
            handler_headers = out[3] if len(out) == 4 else {}
            if (self.shed_late_responses and remaining is not None
                    and remaining <= 0 and 200 <= status < 300):
                # The handler answered, but past its budget: the client
                # stopped waiting — 504, not a slow 2xx (see class attr).
                self.pio_shed()
                status, payload, ctype = 504, {
                    "message": "Deadline exceeded before response."}, None
            troot.set(status=status)
            ms = (time.perf_counter() - t0) * 1e3
            extra = dict(self.pio_on_complete(method, parsed.path, status,
                                              ms, body, params) or {})
            for k, v in handler_headers.items():
                extra.setdefault(k, v)
            # The server's own read+handle wall time: clients use it to
            # attribute client-vs-server latency.
            extra.setdefault("X-PIO-Server-Ms", f"{ms:.1f}")
            if remaining is not None:
                # Deadline attestation: the SAME reading the late-shed
                # verdict used (only NEGATIVE values are late; formatting
                # may floor a sliver to 0.00).
                extra.setdefault("X-PIO-Deadline-Remaining-Ms",
                                 f"{remaining:.2f}")
            retry_after = self.pio_retry_after_s()
            if retry_after is not None and \
                    status in self.retry_after_statuses:
                extra.setdefault("Retry-After", str(retry_after))
            wf = _waterfall.current_waterfall()
            if wf is not None:
                # shed_check: scheduler hand-back → the respond write —
                # the handler's span unwind + stats hooks (from the
                # handler_done mark when the engine set one), the
                # late-shed verdict, and response-header assembly, so the
                # stage sum reconciles with X-PIO-Server-Ms.
                t_fin = wf.take_mark("handler_done") or t_shed
                wf.stamp("shed_check",
                         (time.perf_counter() - t_fin) * 1e3)
            with span("http.respond") as rspan:
                if ctype is None:
                    data, ctype = payload_bytes(payload)
                else:
                    data = (payload.encode() if isinstance(payload, str)
                            else payload)
                self.respond(status, data, ctype, extra,
                             request_id=current_trace_id())
            if wf is not None:
                # serialize: the respond write (body bytes + the socket).
                wf.stamp("serialize", rspan.duration_ms or 0.0)
                doc = wf.finalize(
                    trace_id=current_trace_id(), status=status,
                    total_ms=(time.perf_counter() - t0) * 1e3,
                    attested_ms=ms)
                if doc:
                    attach_event(troot, "waterfall",
                                 **{k: v for k, v in doc.items()
                                    if k not in ("ts", "traceId")})
                _waterfall.deactivate()

    def respond(self, status: int, data: bytes, ctype: str,
                extra_headers: Optional[Dict[str, str]] = None,
                request_id: Optional[str] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        if request_id:
            self.send_header(REQUEST_ID_HEADER, request_id)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        logger.debug("%s %s", self.server_log_name, fmt % args)
