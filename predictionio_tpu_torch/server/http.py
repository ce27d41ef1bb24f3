"""Shared HTTP plumbing for the port's servers.

Port of the transport of ``predictionio_tpu/server/http.py``:

- :class:`ThreadingHTTPServer` — stdlib ``ThreadingHTTPServer`` with a
  128-deep accept backlog (the default of 5 resets connections under
  load bursts).
- :class:`BaseHandler` — HTTP/1.1 keep-alive, Nagle off (Nagle plus
  delayed ACK between a multi-write response and a keep-alive client
  stalls every request ~40 ms), debug-level access logs, and the
  request driver :meth:`BaseHandler.dispatch`: read the body, call
  :meth:`BaseHandler.pio_handle`, write a JSON or Prometheus-text answer
  with ``Content-Length`` and the server's own wall time
  (``X-PIO-Server-Ms``).

The trace, waterfall and deadline hooks of the reference driver arrive
with the port's observability layer.
"""

from __future__ import annotations

import json
import logging
import time
from http.server import (
    BaseHTTPRequestHandler,
    ThreadingHTTPServer as _ThreadingHTTPServer,
)
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

__all__ = ["ThreadingHTTPServer", "BaseHandler", "PROMETHEUS_CTYPE",
           "payload_bytes"]

PROMETHEUS_CTYPE = "text/plain; version=0.0.4"


class ThreadingHTTPServer(_ThreadingHTTPServer):
    # Default accept backlog (5) resets connections under load bursts.
    request_queue_size = 128


def payload_bytes(payload: Any) -> Tuple[bytes, str]:
    """(body, content-type) for a handler payload: ``str`` means
    Prometheus text exposition, anything else is JSON."""
    if isinstance(payload, str):
        return payload.encode(), PROMETHEUS_CTYPE
    return json.dumps(payload).encode(), "application/json; charset=UTF-8"


class BaseHandler(BaseHTTPRequestHandler):
    """Shared request-handler skeleton; subclasses implement
    :meth:`pio_handle` and route their do_* methods through
    :meth:`dispatch`."""

    protocol_version = "HTTP/1.1"
    # See module docstring: keep-alive + Nagle stalls every request ~40 ms.
    disable_nagle_algorithm = True
    server_log_name = "server"

    def pio_handle(self, method: str, path: str, body: bytes
                   ) -> Tuple[int, Any]:
        """Handle one request; returns (status, payload)."""
        raise NotImplementedError

    def dispatch(self, method: str) -> None:
        t0 = time.perf_counter()
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, payload = self.pio_handle(method, urlparse(self.path).path,
                                          body)
        data, ctype = payload_bytes(payload)
        ms = (time.perf_counter() - t0) * 1e3
        self.respond(status, data, ctype, {"X-PIO-Server-Ms": f"{ms:.1f}"})

    def respond(self, status: int, data: bytes, ctype: str,
                extra_headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        logger.debug("%s %s", self.server_log_name, fmt % args)
