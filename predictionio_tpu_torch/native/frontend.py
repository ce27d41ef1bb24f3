"""Python binding for the C++ continuous-batching serving frontend.

Port of ``predictionio_tpu/native/frontend.py``.  Architecture
(``predictionio_tpu_torch/native/serving_frontend.cc``, the port's own
copy, built by :mod:`predictionio_tpu_torch.native.build`): C++ owns
sockets, HTTP parsing, and request batching; Python registers ONE
callback that receives a whole batch and answers it through an engine's
serving pipeline — typically the engine server's ``query_batch``, so the
top-k kernel launches once per batch instead of once per request.  The
callback runs on the C++ batcher threads (ctypes takes the GIL); the
server's models stage on its own device, whatever thread calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable, List, Optional

from predictionio_tpu_torch.native.build import load_library

logger = logging.getLogger(__name__)

__all__ = ["NativeFrontend"]

_BATCH_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int)


class NativeFrontend:
    """Wraps pio_frontend_* for a batch-handler function.

    ``handler(batch: List[dict]) -> List[Any]`` maps parsed query JSONs
    (POST /queries.json) to JSON-able results, one per input (exceptions
    → per-item 500s).  ``fallback(method, path_with_query, body) ->
    (status, payload)`` answers every OTHER route the C++ layer forwards
    (event ingest, webhooks, reload, …); without one those routes 404.
    Same-route fallback items within a batch are handed to
    ``fallback_batch(method, path, bodies) -> [(status, payload), ...]``
    when provided — the event server uses this for group-committed
    ingest.
    """

    def __init__(self, handler: Optional[Callable[[List[Any]], List[Any]]],
                 host: str = "0.0.0.0", port: int = 8000,
                 max_batch: int = 64, max_wait_us: int = 2000,
                 n_batchers: int = 4,
                 fallback: Optional[Callable[[str, str, bytes],
                                             Any]] = None,
                 fallback_batch: Optional[Callable[[str, str, List[bytes]],
                                                   List[Any]]] = None,
                 plugin_hook: Optional[Callable[[str, int, float],
                                                str]] = None):
        # Raises with the compiler's message when the build fails.
        lib = load_library("serving_frontend")
        lib.pio_frontend_start.restype = ctypes.c_int
        lib.pio_frontend_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _BATCH_CB]
        lib.pio_batch_request.restype = ctypes.c_char_p
        lib.pio_batch_request.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.pio_batch_route.restype = ctypes.c_char_p
        lib.pio_batch_route.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.pio_batch_respond.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_char_p]
        lib.pio_batch_respond_ex.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_char_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_char_p,
                                             ctypes.c_char_p]
        self._lib = lib
        self._handler = handler
        self._fallback = fallback
        self._fallback_batch = fallback_batch
        # Server plugin seam: ``plugin_hook(route, status, ms) -> str``
        # returns CRLF-joined header lines to inject into the response
        # (PluginManager.header_block); responses then go through
        # pio_batch_respond_ex so the C++ writer emits them.
        self._plugin_hook = plugin_hook
        self._host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.max_batch = max_batch
        self.max_wait_us = max_wait_us
        # Batches in flight at once: each batcher thread independently
        # forms a batch and drives the callback, so parse / predict /
        # response writes overlap across batches.
        self.n_batchers = n_batchers
        # Keep a reference — ctypes callbacks are GC'd otherwise.
        self._cb = _BATCH_CB(self._on_batch)

    # -- callback from the C++ batcher thread ------------------------------

    def _on_batch(self, batch_handle, n: int) -> None:
        t0 = time.perf_counter()
        try:
            datas: List[bytes] = []
            routes: List[str] = []
            for i in range(n):
                ln = ctypes.c_int(0)
                datas.append(self._lib.pio_batch_request(
                    batch_handle, i, ctypes.byref(ln)) or b"")
                routes.append((self._lib.pio_batch_route(
                    batch_handle, i, ctypes.byref(ln)) or b"").decode(
                        "utf-8", "replace"))

            # Split query-path items (POST only, like the python server)
            # from everything else the C++ layer forwarded (event ingest,
            # webhooks, reload, ...).  With no query handler
            # (event-server mode) EVERY item is fallback.
            fb_idx = [i for i, r in enumerate(routes)
                      if self._handler is None
                      or not r.startswith("POST ")
                      or r.split(" ", 1)[-1].split("?", 1)[0]
                      != "/queries.json"]
            if fb_idx:
                self._dispatch_mixed(batch_handle, n, datas, routes,
                                     set(fb_idx), t0)
                return
            self._answer_queries(batch_handle, range(n), datas, t0)
        except Exception:
            logger.exception("native frontend callback error")

    def _dispatch_mixed(self, batch_handle, n, datas, routes, fb_set, t0):
        results: List[Any] = [None] * n
        # Consecutive same-route fallback runs batch together (the event
        # server group-commits a run of POST /events.json singles).
        i = 0
        while i < n:
            if i not in fb_set:
                i += 1
                continue
            j = i
            while j < n and j in fb_set and routes[j] == routes[i]:
                j += 1
            method, _, path = routes[i].partition(" ")
            group = list(range(i, j))
            try:
                if self._fallback_batch is not None:
                    outs = self._fallback_batch(method, path,
                                                [datas[g] for g in group])
                elif self._fallback is not None:
                    outs = [self._fallback(method, path, datas[g])
                            for g in group]
                else:
                    outs = [(404, {"message": "Not Found"})] * len(group)
                # Every item MUST get a response: an unanswered Pending
                # blocks its C++ worker forever (and stop() then deadlocks
                # joining it), so a miscounting handler fails safe here.
                if len(outs) != len(group) or any(
                        not isinstance(o, tuple) or len(o) not in (2, 3)
                        for o in outs):
                    raise ValueError(
                        f"fallback returned {len(outs)} results for "
                        f"{len(group)} requests")
            except Exception:
                logger.exception("fallback handler failed")
                outs = [(500, {"message": "Internal server error."})] \
                    * len(group)
            for g, out in zip(group, outs):
                results[g] = out
            i = j
        for i, res in enumerate(results):
            if res is None:
                continue
            self._respond(batch_handle, i, res, routes[i], t0)
        q_idx = [i for i in range(n) if i not in fb_set]
        if q_idx:
            self._answer_queries(batch_handle, q_idx,
                                 [datas[i] for i in q_idx], t0)

    def _respond(self, batch_handle, i, res, route: str, t0: float) -> None:
        """Encode + answer one Pending, injecting plugin headers when the
        server's plugin hook returns any (pio_batch_respond_ex)."""
        status, body, ctype = self._encode(res)
        if self._plugin_hook is not None:
            try:
                # "METHOD /path" only — the query string may carry an
                # accessKey and the python transport doesn't pass it either
                extra = self._plugin_hook(
                    route.split("?", 1)[0], status,
                    (time.perf_counter() - t0) * 1e3)
            except Exception:
                logger.exception("plugin hook failed")
                extra = ""
            if extra:
                self._lib.pio_batch_respond_ex(
                    batch_handle, i, body, len(body), status, ctype,
                    extra.encode())
                return
        self._lib.pio_batch_respond(batch_handle, i, body, len(body),
                                    status, ctype)

    def _answer_queries(self, batch_handle, idxs, datas,
                        t0: Optional[float] = None) -> None:
        if t0 is None:
            t0 = time.perf_counter()
        idxs = list(idxs)
        try:
            raw: List[Optional[dict]] = []
            try:
                # One C-level parse for the whole batch instead of n
                # json.loads calls under the GIL.  Empty bodies become
                # `null` placeholders (-> per-item 400 below).
                raw = json.loads(b"[" + b",".join(d if d else b"null"
                                                 for d in datas) + b"]")
            except json.JSONDecodeError:
                raw = []
            if len(raw) != len(idxs):
                # Parse failed — or a crafted body like '1,2' smuggled
                # EXTRA array elements through the join, which would
                # misalign every response in the batch.
                raw = []
                for data in datas:  # isolate the malformed item(s)
                    try:
                        raw.append(json.loads(data))
                    except json.JSONDecodeError:
                        raw.append(None)
            # Malformed JSON answered inline; valid ones go to the handler.
            valid = [k for k, r in enumerate(raw) if r is not None]
            results: List[Any] = [None] * len(idxs)
            if valid:
                try:
                    outs = self._handler([raw[k] for k in valid])
                    # Miscounting handlers fail safe (same invariant as
                    # the fallback path: every Pending MUST be answered
                    # or its C++ worker blocks forever).
                    if len(outs) != len(valid):
                        raise ValueError(
                            f"handler returned {len(outs)} results for "
                            f"{len(valid)} queries")
                    for k, out in zip(valid, outs):
                        results[k] = (200, out)
                except Exception:
                    logger.exception("batch handler failed")
                    for k in valid:
                        results[k] = (500, {"message": "Internal server error."})
            for k in range(len(idxs)):
                if raw[k] is None:
                    results[k] = (400, {"message": "Invalid JSON."})
            for k, res in enumerate(results):
                self._respond(batch_handle, idxs[k], res,
                              "POST /queries.json", t0)
        except Exception:
            logger.exception("native frontend callback error")

    @staticmethod
    def _encode(res) -> "tuple[int, bytes, bytes]":
        """(status, payload[, content_type]) → (status, body, ctype).

        A non-JSON-able payload must not abort the response loop (every
        unanswered Pending hangs its C++ worker), so it degrades to a
        per-item 500.  A handler that needs a specific content type on
        the wire (the /metrics Prometheus exposition) returns a 3-tuple;
        bare string payloads default to plain UTF-8 text.
        """
        if len(res) == 3:
            status, payload, ctype = res
            try:
                body = (payload.encode() if isinstance(payload, str)
                        else payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                if isinstance(ctype, str):
                    ctype = ctype.encode()
                return status, body, ctype
            except (TypeError, ValueError, AttributeError):
                logger.exception("non-serializable 3-tuple response")
                return (500, b'{"message": "Internal server error."}',
                        b"application/json; charset=UTF-8")
        status, payload = res
        if isinstance(payload, str):
            return status, payload.encode(), b"text/plain; charset=utf-8"
        try:
            return (status, json.dumps(payload).encode(),
                    b"application/json; charset=UTF-8")
        except (TypeError, ValueError):
            logger.exception("non-serializable response payload")
            return (500, b'{"message": "Internal server error."}',
                    b"application/json; charset=UTF-8")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        # Event-server mode (no query handler): / and /metrics forward to
        # Python too, so the event server's own status page and ingest
        # metrics stay reachable behind the native layer.
        forward_all = 1 if self._handler is None else 0
        port = self._lib.pio_frontend_start(
            self._host.encode(), self._requested_port, self.max_batch,
            self.max_wait_us, self.n_batchers, forward_all, self._cb)
        if port < 0:
            raise RuntimeError(f"pio_frontend_start failed ({port})")
        self.port = port
        logger.info("Native serving frontend on %s:%d (max_batch=%d)",
                    self._host, port, self.max_batch)
        return port

    def stop(self) -> None:
        self._lib.pio_frontend_stop()
