"""Out-of-process storage: the storage server and the ``pioserver`` source.

Port of ``predictionio_tpu/data/storage/remote.py`` (reference: the
JDBC / HBase / Elasticsearch storage plugins of upstream PredictionIO,
``storage/{jdbc,hbase,elasticsearch}/``, whose defining property is that
the event, metadata and model stores live in ANOTHER PROCESS reached
over the network, selected purely by ``PIO_STORAGE_*`` configuration).
The protocol is the reference's, so a port client talks to a reference
server and a reference client to a port server.  Both halves:

- :class:`StorageServer` — a TCP daemon hosting any configured local
  backend (sqlite by default) behind a length-prefixed JSON-RPC protocol.
  ``pio storageserver`` runs it as the "database process".
- ``type=pioserver`` backend — client adapters for the nine repository
  traits (events, apps, access keys, channels, engine/evaluation
  instances, models, the shared spill queue and KV) that forward every
  call over the wire.  Selected with::

      PIO_STORAGE_SOURCES_REMOTE_TYPE=pioserver
      PIO_STORAGE_SOURCES_REMOTE_HOSTS=127.0.0.1
      PIO_STORAGE_SOURCES_REMOTE_PORTS=7077
      PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=REMOTE

Wire format: 4-byte big-endian length + UTF-8 JSON per message.
Requests are ``{"m": "events.insert", "a": [...], "k": {...}}``; replies
``{"ok": ...}`` or ``{"err": "...", "storage_error": bool}``.  Values are
JSON with tagged encodings: ``{"__dt__": iso8601}`` for datetimes,
``{"__b64__": ...}`` for byte blobs (model payloads), ``{"__map__": ...}``
for a ``DataMap`` and ``{"__dc__": name, "f": {...}}`` for the storage
records.

Scans STREAM: ``events.find_open`` returns the first batch plus a cursor
token, ``events.find_next`` continues it, ``events.find_close`` abandons
it — so a 25M-event scan never materializes on either end.  Cursors live
on the connection that opened them; the client pins a pooled connection
per open scan.

Optional auth: when the server is started with a shared ``secret``, the
first message on every connection must be ``{"auth": <secret>}`` — anything
else closes the connection.  Configure clients with a
``PIO_STORAGE_SOURCES_<NAME>_SECRET`` property.

Write idempotency: every mutating request carries a client-generated
token (``"t"``).  The server keeps a bounded dedup window of recently
answered write tokens, so a client that loses the REPLY (connection
killed after the server committed) can resend the same request and get
the original answer back instead of a duplicate insert.  This is what
makes remote writes safely retriable — the client retries ALL RPCs with
jittered backoff, not just reads.  A server that stays unreachable
raises :class:`StorageUnavailable`; nothing falls back to a local store.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import datetime as _dt
import json
import logging
import socket
import socketserver
import struct
import threading
import uuid
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey, AccessKeys, App, Apps, Channel, Channels, EngineInstance,
    EngineInstances, EvaluationInstance, EvaluationInstances, Events, KV,
    Model, Models, QueueRecord, SpillQueues, StorageError,
    StorageUnavailable,
)
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.resilience import current_idempotency_key
from predictionio_tpu_torch.resilience.deadline import check as _deadline_check
from predictionio_tpu_torch.resilience.faults import fault_point
from predictionio_tpu_torch.resilience.policy import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = ["StorageServer", "RemoteClient", "RemoteBackendError"]


class RemoteBackendError(StorageError):
    pass


# -- value (de)serialization ------------------------------------------------

_DATACLASSES = {
    "Event": Event, "App": App, "AccessKey": AccessKey, "Channel": Channel,
    "EngineInstance": EngineInstance,
    "EvaluationInstance": EvaluationInstance, "Model": Model,
    "QueueRecord": QueueRecord,
}


def _enc(v: Any) -> Any:
    if isinstance(v, _dt.datetime):
        return {"__dt__": v.isoformat()}
    if isinstance(v, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(v)).decode()}
    if isinstance(v, DataMap):
        return {"__map__": v.to_dict()}
    if dataclasses.is_dataclass(v) and type(v).__name__ in _DATACLASSES:
        return {"__dc__": type(v).__name__,
                "f": {f.name: _enc(getattr(v, f.name))
                      for f in dataclasses.fields(v)}}
    if isinstance(v, (list, tuple)):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    return v


def _dec(v: Any) -> Any:
    if isinstance(v, dict):
        if "__dt__" in v:
            return _dt.datetime.fromisoformat(v["__dt__"])
        if "__b64__" in v:
            return base64.b64decode(v["__b64__"])
        if "__map__" in v:
            return DataMap(v["__map__"])
        if "__dc__" in v:
            cls = _DATACLASSES[v["__dc__"]]
            fields = {k: _dec(x) for k, x in v["f"].items()}
            if cls is AccessKey and isinstance(fields.get("events"), list):
                fields["events"] = tuple(fields["events"])  # JSON drops tuples
            return cls(**fields)
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


# Per-message size cap: streamed scan pages stay far below this; only a
# legacy one-shot ``events.find`` of a huge store could hit it.
_MAX_MESSAGE = 256 << 20


def _send(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv(sock: socket.socket, max_len: Optional[int] = None) -> Any:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            raise ConnectionError("storage server closed the connection")
        head += chunk
    (n,) = struct.unpack(">I", head)
    # Same frame cap both directions (client AND server): a corrupt or
    # malicious length prefix must not make either side buffer gigabytes
    # before failing.  The module-level cap is read at call time so tests
    # can shrink it.
    cap = _MAX_MESSAGE if max_len is None else max_len
    if n > cap:
        raise RemoteBackendError(
            f"oversized frame ({n} bytes > cap {cap})")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("storage server closed mid-reply")
        buf += chunk
    return json.loads(bytes(buf))


# -- server -----------------------------------------------------------------

# Exact RPC surface per repository — nothing outside this table is
# callable over the wire (getattr dispatch would otherwise expose
# private/backing methods).
_ALLOWED = {
    "events": {"init", "remove", "insert", "insert_batch", "create_batch",
               "get", "delete", "find", "latest_event_time"},
    "apps": {"insert", "get", "get_by_name", "get_all", "update", "delete"},
    "access_keys": {"insert", "get", "get_all", "get_by_app_id", "update",
                    "delete"},
    "channels": {"_insert", "get", "get_by_app_id", "delete"},
    "engine_instances": {"insert", "get", "get_all", "get_latest_completed",
                         "get_completed", "update", "delete"},
    "evaluation_instances": {"insert", "get", "get_all", "get_completed",
                             "update", "delete"},
    "models": {"insert", "get", "delete"},
    # Shared spill queue + KV: the fleet backplane rides the
    # same RPC surface, so N event servers on type=pioserver share one
    # queue/cache exactly like they share one event store.
    "spill_queues": {"enqueue", "lease", "ack", "nack", "dead_letter",
                     "requeue_dead", "stats", "peek"},
    "kv": {"put", "get", "delete", "count", "prune"},
}


_FIND_BATCH = 2000  # events per streamed batch (well under the reply cap)


class _DedupWindow:
    """Bounded token → reply cache shared across connections.

    Holds the last ``capacity`` successful WRITE replies keyed by the
    client's idempotency token; a resent write whose token is still in
    the window gets the original reply without re-executing.  Bounded so
    an adversarial client cannot grow server memory; a token falling out
    of the window degrades to at-least-once (documented in README).

    ``begin``/``finish`` also track IN-FLIGHT tokens: a retry that
    arrives while the original dispatch is still executing (write slower
    than the client's retry backoff) blocks until the original finishes
    instead of re-executing concurrently — the duplicate-insert race the
    tokens exist to close."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._replies: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._inflight: Dict[str, threading.Event] = {}

    def begin(self, token: str, wait_s: float = 60.0) -> Optional[Any]:
        """Claim ``token`` for execution.  Returns the cached reply when
        the write already committed; None when the caller should run the
        dispatch (and MUST later call :meth:`finish`).  Waits out an
        in-flight original first; if it is still running after
        ``wait_s`` the caller proceeds (bounded at-least-once beats a
        wedged connection)."""
        while True:
            with self._lock:
                reply = self._replies.get(token)
                if reply is not None:
                    self._replies.move_to_end(token)
                    return reply
                ev = self._inflight.get(token)
                if ev is None:
                    self._inflight[token] = threading.Event()
                    return None
            if not ev.wait(wait_s):
                with self._lock:
                    # original wedged: steal the claim if still unset
                    if self._inflight.get(token) is ev:
                        self._inflight[token] = threading.Event()
                        return None
                # else: original finished in the window — loop re-checks

    def finish(self, token: str, reply: Optional[Any]) -> None:
        """Release the in-flight claim; ``reply`` is cached only when the
        write succeeded (a transient failure must re-execute on retry)."""
        with self._lock:
            if reply is not None:
                self._replies[token] = reply
                self._replies.move_to_end(token)
                while len(self._replies) > self.capacity:
                    self._replies.popitem(last=False)
            ev = self._inflight.pop(token, None)
        if ev is not None:
            ev.set()


class StorageServer:
    """Host a local :class:`~predictionio_tpu_torch.data.storage.Storage` (or any
    object exposing the repository getters) over TCP."""

    def __init__(self, storage, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None,
                 dedup_window: int = 4096):
        self.storage = storage
        self.secret = secret
        self._dedup = _DedupWindow(dedup_window)
        if secret is None and host not in ("127.0.0.1", "localhost", "::1"):
            logger.warning(
                "Storage server binding %s WITHOUT a shared secret: anything "
                "that can reach this address gets full read/write access to "
                "every app's events, models, and access keys.  Pass "
                "secret=... (pio storageserver --secret / "
                "PIO_STORAGE_SERVER_SECRET).", host)
        self._repos = {
            "events": storage.get_events,
            "apps": storage.get_apps,
            "access_keys": storage.get_access_keys,
            "channels": storage.get_channels,
            "engine_instances": storage.get_engine_instances,
            "evaluation_instances": storage.get_evaluation_instances,
            "models": storage.get_models,
        }
        # Backplane repos are optional on the hosted storage (a backend
        # without queue support answers "unknown method", not a crash).
        for name, getter in (("spill_queues",
                              getattr(storage, "get_spill_queues", None)),
                             ("kv", getattr(storage, "get_kv", None))):
            if getter is not None:
                self._repos[name] = getter
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                import hmac

                # Per-connection scan cursors: live iterators keyed by a
                # monotonic token (never reused within a connection, so a
                # stale find_next errors instead of silently reading a
                # later scan's pages); dropped with the connection.
                cursors: Dict[int, Any] = {"_next": 1}
                authed = outer.secret is None
                first = True
                while True:
                    try:
                        # Pre-auth, a peer knows nothing worth 256 MB: cap
                        # the first frame of a secured connection at 1 KB
                        # so strangers can't make the server buffer/parse
                        # attacker-sized payloads before the secret check.
                        req = _recv(self.request,
                                    max_len=(1 << 10) if not authed
                                    else None)
                    except RemoteBackendError:
                        # Oversized pre-auth frame — likely a legitimate
                        # client missing its SECRET property whose first
                        # RPC was big: tell it why before dropping, so the
                        # operator doesn't chase a phantom network fault.
                        try:
                            _send(self.request, {"err": "auth required",
                                                 "storage_error": False})
                        except (ConnectionError, OSError):
                            pass
                        return
                    except (ConnectionError, OSError):
                        return
                    if authed and first and isinstance(req, dict) \
                            and set(req) == {"auth"}:
                        # Client configured with a secret, server without
                        # one: acknowledge the handshake instead of
                        # dispatching it as an RPC (which would fail with
                        # a misleading KeyError-shaped reply).
                        first = False
                        try:
                            _send(self.request, {"ok": True})
                            continue
                        except (ConnectionError, OSError):
                            return
                    first = False
                    if not authed:
                        # Compare as bytes: compare_digest raises on
                        # non-ASCII str inputs.
                        ok = isinstance(req, dict) and isinstance(
                            req.get("auth"), str) and hmac.compare_digest(
                            req["auth"].encode(), outer.secret.encode())
                        try:
                            _send(self.request, {"ok": True} if ok else
                                  {"err": "auth required", "storage_error": False})
                        except (ConnectionError, OSError):
                            return
                        if not ok:
                            return  # close: no unauthenticated dispatch
                        authed = True
                        continue
                    token = req.get("t") if isinstance(req, dict) else None
                    if token:
                        cached = outer._dedup.begin(token)
                        if cached is not None:
                            # Retried write whose first execution
                            # committed but whose reply was lost: answer
                            # from the dedup window, do NOT re-execute.
                            # (begin() also serialized us behind a still-
                            # running original with the same token.)
                            try:
                                _send(self.request, cached)
                                continue
                            except (ConnectionError, OSError):
                                return
                    reply = None
                    try:
                        result = outer._dispatch(req, cursors)
                        reply = {"ok": _enc(result)}
                    except StorageError as e:
                        reply = {"err": str(e), "storage_error": True}
                    except Exception as e:  # backend bug → client exception
                        logger.exception("storage RPC failed: %s", req.get("m"))
                        reply = {"err": f"{type(e).__name__}: {e}",
                                 "storage_error": False}
                    finally:
                        if token:
                            # Only successes enter the window: a transient
                            # failure must re-execute on retry.  Always
                            # releases the in-flight claim.
                            outer._dedup.finish(
                                token,
                                reply if reply and "ok" in reply else None)
                    try:
                        _send(self.request, reply)
                    except (ConnectionError, OSError):
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._srv = Server((host, port), Handler)
        self.host, self.port = self._srv.server_address
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _cursor_page(cursors: Dict[int, Any], cid: int, n: int) -> Dict:
        it = cursors[cid]
        batch = []
        for ev in it:
            batch.append(ev)
            if len(batch) >= n:
                break
        done = len(batch) < n
        if done:
            del cursors[cid]
        return {"cursor": None if done else cid, "batch": batch,
                "done": done}

    def _dispatch(self, req: Dict, cursors: Dict[int, Any]) -> Any:
        fault_point("rpc.dispatch")
        repo_name, _, method = req["m"].partition(".")
        args = [_dec(a) for a in req.get("a", [])]
        kwargs = {k: _dec(v) for k, v in req.get("k", {}).items()}
        if repo_name == "events" and method in ("find_open", "find_next",
                                                "find_close"):
            if method == "find_open":
                n = int(kwargs.pop("_n", _FIND_BATCH))
                cid = cursors["_next"]
                cursors["_next"] = cid + 1
                cursors[cid] = iter(self._repos["events"]().find(
                    *args, **kwargs))
                return self._cursor_page(cursors, cid, n)
            if method == "find_next":
                cid, n = int(args[0]), int(args[1])
                if cid not in cursors:
                    raise RemoteBackendError(f"unknown scan cursor {cid}")
                return self._cursor_page(cursors, cid, n)
            cursors.pop(int(args[0]), None)  # find_close
            return True
        if repo_name not in self._repos or \
                method not in _ALLOWED.get(repo_name, ()):
            raise RemoteBackendError(f"unknown storage method {req['m']!r}")
        repo = self._repos[repo_name]()
        out = getattr(repo, method)(*args, **kwargs)
        if method in ("find",):  # iterator → list on the wire (legacy path)
            out = list(out)
        return out

    def start(self) -> int:
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("storage server on %s:%d", self.host, self.port)
        return self.port

    def serve_forever(self) -> None:
        self._srv.serve_forever()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=5)


# -- client -----------------------------------------------------------------

class _PooledConn:
    """One lazily-(re)connecting socket; leased exclusively per RPC/scan."""

    def __init__(self, client: "RemoteClient"):
        self._client = client
        self.sock: Optional[socket.socket] = None

    def ensure(self) -> socket.socket:
        if self.sock is None:
            self.sock = self._client._connect()
        return self.sock

    def drop(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class RemoteClient:
    """A small connection pool (thread-safe, lazily reconnecting) + adapters.

    ``pool_size`` connections run RPCs concurrently instead of serializing
    every storage call behind one socket lock; an open
    scan pins its connection until the cursor drains.

    Every RPC retries on connection failure with jittered backoff
    (``retry`` policy, ``retries`` attempts after the first): reads are
    idempotent by nature, and writes carry an idempotency token the
    server dedups on, so a resend after a lost reply cannot duplicate.
    Only cursor continuations (``find_next``) stay fail-fast — a
    half-consumed cursor died with its connection and resuming it
    transparently could silently skip events.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 secret: Optional[str] = None, pool_size: int = 2,
                 retries: int = 2, retry: Optional[RetryPolicy] = None):
        self.addr = (host, int(port))
        self.timeout = timeout
        self.secret = secret
        self.retry = retry or RetryPolicy(
            max_attempts=max(1, int(retries) + 1),
            base_delay_ms=20.0, max_delay_ms=500.0)
        self._retries_total = get_registry().counter(
            "pio_rpc_retries_total",
            "Remote-storage RPCs resent after a connection failure.")
        self._pool_size = max(1, int(pool_size))
        self._idle: List[_PooledConn] = [_PooledConn(self)
                                         for _ in range(self._pool_size)]
        self._pool_lock = threading.Lock()
        self._closed = False

    def _lease(self) -> _PooledConn:
        """Take an idle connection, or mint a fresh one when all are busy.

        Never blocks: a thread holding ``pool_size`` pinned scan
        connections that issues another storage call (nested iteration)
        must not deadlock waiting on itself — overflow connections are
        simply closed instead of pooled on release.
        """
        with self._pool_lock:
            if self._idle:
                return self._idle.pop()
        return _PooledConn(self)

    def _release(self, conn: _PooledConn) -> None:
        with self._pool_lock:
            if not self._closed and len(self._idle) < self._pool_size:
                self._idle.append(conn)
                return
        conn.drop()  # overflow conn, or the client was closed mid-lease

    def _connect(self) -> socket.socket:
        s = socket.create_connection(self.addr, timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.secret is not None:
            _send(s, {"auth": self.secret})
            # Auth replies are tiny; mirror the server's pre-auth 1 KB cap
            # so a corrupt/malicious length prefix can't OOM the client.
            reply = _recv(s, max_len=1 << 10)
            if "err" in reply:
                s.close()
                raise RemoteBackendError(
                    f"storage server {self.addr} rejected auth: "
                    f"{reply['err']}")
        return s

    def _roundtrip(self, conn: _PooledConn, req: Dict, *,
                   retriable: bool, method: str) -> Any:
        attempts = self.retry.max_attempts if retriable else 1
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                _deadline_check(f"storage RPC {method}")
                sock = conn.ensure()
                fault_point("rpc.send")
                _send(sock, req)
                # rpc.recv faults fire AFTER the request hit the wire —
                # the server may have committed; this is the lost-reply
                # case the idempotency tokens exist for.
                fault_point("rpc.recv")
                reply = _recv(sock)
                break
            except (ConnectionError, OSError) as e:
                conn.drop()
                last = e
                if attempt == attempts - 1:
                    raise StorageUnavailable(
                        f"storage server {self.addr} unreachable "
                        f"during {method}"
                        + ("" if retriable else " (not retried)")
                        + f": {e}") from e
                self._retries_total.inc()
                self.retry.sleep_backoff(attempt)
            except RemoteBackendError:
                # Framing-level failure (e.g. oversized reply): the payload
                # is still on the wire, so the connection is
                # protocol-desynchronized — never reuse it.
                conn.drop()
                raise
        else:  # pragma: no cover - loop always breaks or raises
            raise StorageUnavailable(
                f"storage server {self.addr} unreachable: {last}")
        if "err" in reply:
            if reply.get("storage_error"):
                raise StorageError(reply["err"])
            raise RemoteBackendError(reply["err"])
        return _dec(reply["ok"])

    def call(self, method: str, *args, **kwargs) -> Any:
        req = {"m": method, "a": [_enc(a) for a in args],
               "k": {k: _enc(v) for k, v in kwargs.items()}}
        verb = method.split(".", 1)[1] if "." in method else method
        if not verb.startswith(("get", "find", "stats", "peek", "count")):
            # Client-generated idempotency token: the server's dedup
            # window makes resending this exact request safe even when
            # the first send committed before the connection died.  The
            # spill replay pins a persisted token via idempotency_key().
            req["t"] = current_idempotency_key() or uuid.uuid4().hex
        conn = self._lease()
        try:
            return self._roundtrip(conn, req, retriable=True,
                                   method=method)
        finally:
            self._release(conn)

    def stream_find(self, *args, _batch: int = _FIND_BATCH, **kwargs):
        """Lazily yield events from a server-side cursor scan.

        The whole scan rides ONE pooled connection (cursors are
        connection-local server-side); other pool connections stay free
        for concurrent RPC.  A connection drop mid-scan raises — resuming
        a half-consumed cursor transparently could silently skip events.
        """
        conn = self._lease()
        page = None
        try:
            req = {"m": "events.find_open", "a": [_enc(a) for a in args],
                   "k": {**{k: _enc(v) for k, v in kwargs.items()},
                         "_n": _batch}}
            page = self._roundtrip(conn, req, retriable=True,
                                   method="events.find_open")
            while True:
                yield from page["batch"]
                if page["done"]:
                    page = None
                    return
                page = self._roundtrip(
                    conn, {"m": "events.find_next",
                           "a": [page["cursor"], _batch], "k": {}},
                    retriable=False, method="events.find_next")
        finally:
            if page is not None and not page.get("done", True) \
                    and conn.sock is not None:
                # Abandoned mid-scan (caller broke out): free the cursor.
                # A dropped socket needs no close — its cursors died with
                # the server-side connection; dialing a fresh connection
                # just to close a cursor it never had would be wasted.
                try:
                    self._roundtrip(
                        conn, {"m": "events.find_close",
                               "a": [page["cursor"]], "k": {}},
                        retriable=False, method="events.find_close")
                except (RemoteBackendError, StorageError):
                    conn.drop()
            self._release(conn)

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            for conn in self._idle:
                conn.drop()
            self._idle.clear()

    # repo accessors
    def events(self) -> "RemoteEvents":
        return RemoteEvents(self)

    def apps(self) -> "RemoteApps":
        return RemoteApps(self)

    def access_keys(self) -> "RemoteAccessKeys":
        return RemoteAccessKeys(self)

    def channels(self) -> "RemoteChannels":
        return RemoteChannels(self)

    def engine_instances(self) -> "RemoteEngineInstances":
        return RemoteEngineInstances(self)

    def evaluation_instances(self) -> "RemoteEvaluationInstances":
        return RemoteEvaluationInstances(self)

    def models(self) -> "RemoteModels":
        return RemoteModels(self)

    def spill_queues(self) -> "RemoteSpillQueues":
        return RemoteSpillQueues(self)

    def kv(self) -> "RemoteKV":
        return RemoteKV(self)


def _forward(repo: str, method: str, iterator: bool = False):
    def impl(self, *args, **kwargs):
        out = self._c.call(f"{repo}.{method}", *args, **kwargs)
        return iter(out) if iterator else out
    impl.__name__ = method
    return impl


class RemoteEvents(Events):
    def __init__(self, client: RemoteClient):
        self._c = client

    init = _forward("events", "init")
    remove = _forward("events", "remove")
    insert = _forward("events", "insert")
    insert_batch = _forward("events", "insert_batch")
    # One RPC per batch; the per-item sub-tokens travel with the call, so
    # the HOSTED backend's create_batch dedups per item even when the
    # whole-call dedup window has already evicted the batch token.
    create_batch = _forward("events", "create_batch")
    get = _forward("events", "get")
    delete = _forward("events", "delete")
    # One RPC to the backend's indexed MAX — the base-class default would
    # stream a whole reversed find page for one timestamp.
    latest_event_time = _forward("events", "latest_event_time")

    def find(self, *args, **kwargs):
        # Streams via server-side cursor pages — never materializes the
        # scan on either end (the legacy one-shot "events.find" RPC
        # remains servable for old clients).
        return self._c.stream_find(*args, **kwargs)

    def close(self) -> None:
        self._c.close()


class RemoteApps(Apps):
    def __init__(self, client: RemoteClient):
        self._c = client

    insert = _forward("apps", "insert")
    get = _forward("apps", "get")
    get_by_name = _forward("apps", "get_by_name")
    get_all = _forward("apps", "get_all")
    update = _forward("apps", "update")
    delete = _forward("apps", "delete")


class RemoteAccessKeys(AccessKeys):
    def __init__(self, client: RemoteClient):
        self._c = client

    insert = _forward("access_keys", "insert")
    get = _forward("access_keys", "get")
    get_all = _forward("access_keys", "get_all")
    get_by_app_id = _forward("access_keys", "get_by_app_id")
    update = _forward("access_keys", "update")
    delete = _forward("access_keys", "delete")


class RemoteChannels(Channels):
    def __init__(self, client: RemoteClient):
        self._c = client

    _insert = _forward("channels", "_insert")
    get = _forward("channels", "get")
    get_by_app_id = _forward("channels", "get_by_app_id")
    delete = _forward("channels", "delete")


class RemoteEngineInstances(EngineInstances):
    def __init__(self, client: RemoteClient):
        self._c = client

    insert = _forward("engine_instances", "insert")
    get = _forward("engine_instances", "get")
    get_all = _forward("engine_instances", "get_all")
    get_latest_completed = _forward("engine_instances", "get_latest_completed")
    get_completed = _forward("engine_instances", "get_completed")
    update = _forward("engine_instances", "update")
    delete = _forward("engine_instances", "delete")


class RemoteEvaluationInstances(EvaluationInstances):
    def __init__(self, client: RemoteClient):
        self._c = client

    insert = _forward("evaluation_instances", "insert")
    get = _forward("evaluation_instances", "get")
    get_all = _forward("evaluation_instances", "get_all")
    get_completed = _forward("evaluation_instances", "get_completed")
    update = _forward("evaluation_instances", "update")
    delete = _forward("evaluation_instances", "delete")


class RemoteModels(Models):
    def __init__(self, client: RemoteClient):
        self._c = client

    insert = _forward("models", "insert")
    get = _forward("models", "get")
    delete = _forward("models", "delete")


class RemoteSpillQueues(SpillQueues):
    """Shared spill queue over the wire — every fleet instance's drainer
    leases from the SAME server-side table, which is what makes a crashed
    drainer's batch another instance's work."""

    def __init__(self, client: RemoteClient):
        self._c = client

    enqueue = _forward("spill_queues", "enqueue")
    lease = _forward("spill_queues", "lease")
    ack = _forward("spill_queues", "ack")
    nack = _forward("spill_queues", "nack")
    dead_letter = _forward("spill_queues", "dead_letter")
    requeue_dead = _forward("spill_queues", "requeue_dead")
    stats = _forward("spill_queues", "stats")
    peek = _forward("spill_queues", "peek")


class RemoteKV(KV):
    def __init__(self, client: RemoteClient):
        self._c = client

    put = _forward("kv", "put")
    delete = _forward("kv", "delete")
    count = _forward("kv", "count")
    prune = _forward("kv", "prune")

    def get(self, ns: str, key: str) -> Optional[bytes]:
        out = self._c.call("kv.get", ns, key)
        # bytes ride the __b64__ tagged encoding; None passes through
        return out if out is None or isinstance(out, bytes) \
            else bytes(out)
