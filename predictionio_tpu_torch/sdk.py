"""Client SDK — EventClient / EngineClient over HTTP.

Port of ``predictionio_tpu/sdk.py``: either package's client talks to
either package's servers.  Reference parity: the PredictionIO ecosystem
ships a ``predictionio`` Python SDK with ``EventClient``
(create_event/get_event/delete_event, ``pio import``-style batch) and
``EngineClient`` (send_query).  Same surface here, stdlib-only, so
reference users can port scripts by changing an import.

Resilience additions:

- ONE exception surface: every transport failure — HTTP error status,
  refused connection, DNS failure, timeout — raises
  :class:`PredictionIOError`.  Connection-level failures carry
  ``status=None`` and ``retriable=True``; 429/502/503/504 are marked
  retriable and surface the server's ``Retry-After`` hint as
  ``retry_after_s``.
- Opt-in retries: construct a client with ``retries=N`` and retriable
  failures are retried with jittered exponential backoff
  (``Retry-After``-aware).  Caveat: the single-event API carries no
  idempotency token, so a retried ``create_event`` whose first attempt
  committed before the reply was lost inserts a duplicate — single
  ingest retries are AT-LEAST-ONCE (that is why they are opt-in).
  ``create_events`` sends a batch token, and its retries are
  exactly-once.
- Deadline propagation: ``deadline_ms=...`` stamps every request with
  ``X-PIO-Deadline-Ms`` so servers can shed work that cannot finish in
  budget (504) instead of queueing it.
- Typed ingest result: ``create_event`` returns :class:`EventResult` — a
  ``str`` (the old return shape) that also says whether the value is a
  durably-stored event id (201) or a 202 spill token.
"""

from __future__ import annotations

import datetime as _dt
import http.client
import json
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Dict, List, Mapping, Optional, Sequence

from predictionio_tpu_torch.resilience.deadline import DEADLINE_HEADER
from predictionio_tpu_torch.resilience.policy import RetryPolicy

__all__ = ["PredictionIOError", "EventResult", "EventClient", "EngineClient"]


class EventResult(str):
    """``create_event``'s typed result.

    A ``str`` subclass, so every existing caller that treated the return
    value as "the id string" keeps working unchanged — but the value a
    202 carries is a spill TOKEN, not an event id (the real id is
    assigned at replay and cannot be fetched/deleted by token).  New
    callers distinguish the two::

        r = client.create_event(...)
        if r.stored:          # 201: durably stored, r.event_id is real
            audit(r.event_id)
        else:                 # 202: journaled server-side, r.token
            metrics.spilled += 1

    ``status`` carries the HTTP status (201 or 202).
    """

    __slots__ = ("event_id", "token", "status")

    def __new__(cls, value: str, *, event_id: Optional[str] = None,
                token: Optional[str] = None, status: Optional[int] = None):
        self = super().__new__(cls, value)
        self.event_id = event_id
        self.token = token
        self.status = status
        return self

    @property
    def stored(self) -> bool:
        """True when the event is durably stored under ``event_id``;
        False when it was 202-journaled for replay (``token``)."""
        return self.event_id is not None


class PredictionIOError(RuntimeError):
    """The SDK's one exception surface.

    ``status`` is the HTTP status, or None for connection-level failures
    (refused, reset, DNS, timeout).  ``retriable`` marks failures a
    retry could plausibly fix; ``retry_after_s`` carries the server's
    ``Retry-After`` backoff hint when present.
    """

    def __init__(self, status: Optional[int], message: str,
                 retriable: bool = False,
                 retry_after_s: Optional[float] = None):
        super().__init__(f"HTTP {status}: {message}" if status is not None
                         else f"connection error: {message}")
        self.status = status
        self.retriable = retriable
        self.retry_after_s = retry_after_s


# Transient server statuses a retry could fix (tail-at-scale playbook).
_RETRIABLE_STATUSES = frozenset({429, 502, 503, 504})


def _retry_after_s(headers) -> Optional[float]:
    try:
        raw = headers.get("Retry-After") if headers else None
        return float(raw) if raw else None
    except (TypeError, ValueError):
        return None


def _request(method: str, url: str, body: Optional[Any] = None,
             timeout: float = 10.0, *, retry: Optional[RetryPolicy] = None,
             deadline_ms: Optional[float] = None,
             want_status: bool = False) -> Any:
    """``want_status=True`` returns ``(http_status, payload)`` — the
    typed create_event result needs to tell a 201 from a 202."""
    data = json.dumps(body).encode() if body is not None else None
    # One absolute deadline for the WHOLE call, retries included: each
    # attempt sends the REMAINING budget (the header's documented
    # meaning) and stops — non-retriably — once it is spent, so retry
    # backoff can never stretch a 200ms-budget call to seconds.
    t_end = (time.monotonic() + deadline_ms / 1e3
             if deadline_ms is not None else None)

    def attempt() -> Any:
        headers = {"Content-Type": "application/json"}
        attempt_timeout = timeout
        if t_end is not None:
            remaining = (t_end - time.monotonic()) * 1e3
            if remaining <= 0:
                raise PredictionIOError(
                    None, f"deadline exhausted before {method} {url}",
                    retriable=False)
            headers[DEADLINE_HEADER] = str(int(remaining))
            attempt_timeout = min(timeout, remaining / 1e3)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=attempt_timeout) as resp:
                payload = resp.read()
                parsed = json.loads(payload) if payload else None
                return (resp.status, parsed) if want_status else parsed
        except urllib.error.HTTPError as e:
            payload = e.read()
            try:
                msg = json.loads(payload).get("message", "") if payload else ""
            except json.JSONDecodeError:
                msg = payload.decode(errors="replace")[:200]
            raise PredictionIOError(
                e.code, msg, retriable=e.code in _RETRIABLE_STATUSES,
                retry_after_s=_retry_after_s(e.headers)) from None
        except (urllib.error.URLError, OSError, TimeoutError,
                http.client.HTTPException) as e:
            # URLError wraps socket errors; ConnectionError/timeout can
            # escape raw; a server dying mid-response raises
            # http.client exceptions (IncompleteRead, BadStatusLine).
            # Normalize ALL of them: one exception surface, status None,
            # retriable.
            reason = getattr(e, "reason", None) or e
            raise PredictionIOError(None, str(reason),
                                    retriable=True) from None

    if retry is not None:
        return retry.run(attempt,
                         retriable=lambda e: isinstance(e, PredictionIOError)
                         and e.retriable,
                         deadline_ts=t_end)
    return attempt()


def _policy(retries: int) -> Optional[RetryPolicy]:
    return RetryPolicy(max_attempts=retries + 1) if retries > 0 else None


class EventClient:
    """Talks to the Event Server (reference: predictionio.EventClient)."""

    def __init__(self, access_key: str, url: str = "http://localhost:7070",
                 channel: Optional[str] = None, timeout: float = 10.0,
                 retries: int = 0, deadline_ms: Optional[float] = None):
        self.access_key = access_key
        self.base = url.rstrip("/")
        self.channel = channel
        self.timeout = timeout
        self.deadline_ms = deadline_ms
        self.retry = _policy(retries)

    def _qs(self, extra: Optional[Mapping[str, Any]] = None) -> str:
        params: Dict[str, Any] = {"accessKey": self.access_key}
        if self.channel:
            params["channel"] = self.channel
        if extra:
            params.update({k: v for k, v in extra.items() if v is not None})
        return urllib.parse.urlencode(params, doseq=True)

    def _request(self, method: str, url: str, body: Optional[Any] = None,
                 **kw) -> Any:
        return _request(method, url, body, self.timeout, retry=self.retry,
                        deadline_ms=self.deadline_ms, **kw)

    @staticmethod
    def _iso(t) -> Optional[str]:
        if t is None:
            return None
        if isinstance(t, _dt.datetime):
            return t.isoformat()
        return str(t)

    def create_event(self, event: str, entity_type: str, entity_id: str,
                     target_entity_type: Optional[str] = None,
                     target_entity_id: Optional[str] = None,
                     properties: Optional[Mapping[str, Any]] = None,
                     event_time=None) -> EventResult:
        body: Dict[str, Any] = {
            "event": event, "entityType": entity_type, "entityId": entity_id}
        if target_entity_type:
            body["targetEntityType"] = target_entity_type
        if target_entity_id:
            body["targetEntityId"] = target_entity_id
        if properties:
            body["properties"] = dict(properties)
        if event_time is not None:
            body["eventTime"] = self._iso(event_time)
        status, out = self._request(
            "POST", f"{self.base}/events.json?{self._qs()}", body,
            want_status=True)
        # 201 carries eventId; a 202 (storage outage, event journaled
        # server-side) carries the spill token instead.  The returned
        # EventResult IS the old string (compat) plus .event_id/.token/
        # .stored so callers can finally tell them apart.
        out = out or {}
        event_id = out.get("eventId")
        token = out.get("token")
        return EventResult(event_id or token or "", event_id=event_id,
                           token=token, status=status)

    def create_events(self, events: Sequence[Mapping[str, Any]],
                      batch_token: Optional[str] = None) -> List[EventResult]:
        """Bulk ingest riding ``POST /batch/events.json``.

        One idempotency ``batch_token`` covers the whole batch
        (auto-generated when not given): the server derives per-item
        sub-tokens — and thus event ids — from it, so an opt-in retry
        (``retries=N``) that re-sends the batch after a lost reply lands
        every row AT MOST once.  Unlike single-event ``create_event``,
        batch retries are exactly-once end-to-end.

        Returns one typed :class:`EventResult` per item, in order:
        ``.stored`` (201) with ``.event_id``, a 202 spill ``.token``, or
        a per-item error (``.status`` 400/403 — one malformed item never
        fails its cohort).  Old servers without the bulk endpoint (404)
        degrade to a per-row ``create_event`` loop — at-least-once, like
        any single-event retry.
        """
        items = [dict(e) for e in events]
        token = batch_token or uuid.uuid4().hex
        try:
            out = self._request(
                "POST",
                f"{self.base}/batch/events.json?"
                f"{self._qs({'batchToken': token})}",
                items)
        except PredictionIOError as e:
            if e.status in (404, 405):  # pre-bulk server: row-loop
                return [self._create_event_json(it) for it in items]
            raise
        results: List[EventResult] = []
        for item in out or []:
            eid = item.get("eventId")
            tok = item.get("token")
            results.append(EventResult(
                eid or tok or "", event_id=eid, token=tok,
                status=item.get("status")))
        return results

    def _create_event_json(self, body: Mapping[str, Any]) -> EventResult:
        """Row-loop fallback: POST one already-shaped event JSON.  A
        per-item failure becomes an errored EventResult (status carried
        over) so the fallback keeps the bulk path's one-bad-row-never-
        fails-the-cohort contract."""
        try:
            status, out = self._request(
                "POST", f"{self.base}/events.json?{self._qs()}", dict(body),
                want_status=True)
        except PredictionIOError as e:
            if e.status is None:
                raise  # connection-level: the whole loop is doomed
            return EventResult("", status=e.status)
        out = out or {}
        return EventResult(out.get("eventId") or out.get("token") or "",
                           event_id=out.get("eventId"),
                           token=out.get("token"), status=status)

    def get_event(self, event_id: str) -> Dict[str, Any]:
        return self._request(
            "GET", f"{self.base}/events/{event_id}.json?{self._qs()}")

    def delete_event(self, event_id: str) -> None:
        self._request("DELETE",
                      f"{self.base}/events/{event_id}.json?{self._qs()}")

    def find_events(self, **filters) -> List[Dict[str, Any]]:
        """Filters: startTime, untilTime, entityType, entityId, event,
        targetEntityType, targetEntityId, limit, reversed."""
        qs = self._qs({k: (str(v).lower() if isinstance(v, bool) else v)
                       for k, v in filters.items()})
        try:
            return self._request("GET", f"{self.base}/events.json?{qs}")
        except PredictionIOError as e:
            if e.status == 404:
                return []
            raise

    # Convenience wrappers (reference SDK surface).
    def set_user(self, uid: str, properties=None, event_time=None) -> str:
        return self.create_event("$set", "user", uid, properties=properties,
                                 event_time=event_time)

    def set_item(self, iid: str, properties=None, event_time=None) -> str:
        return self.create_event("$set", "item", iid, properties=properties,
                                 event_time=event_time)

    def record_user_action_on_item(self, action: str, uid: str, iid: str,
                                   properties=None, event_time=None) -> str:
        return self.create_event(action, "user", uid, "item", iid,
                                 properties, event_time)


class EngineClient:
    """Talks to a deployed engine (reference: predictionio.EngineClient)."""

    def __init__(self, url: str = "http://localhost:8000",
                 timeout: float = 10.0, retries: int = 0,
                 deadline_ms: Optional[float] = None):
        self.base = url.rstrip("/")
        self.timeout = timeout
        self.deadline_ms = deadline_ms
        self.retry = _policy(retries)

    def send_query(self, query: Mapping[str, Any]) -> Dict[str, Any]:
        return _request("POST", f"{self.base}/queries.json", dict(query),
                        self.timeout, retry=self.retry,
                        deadline_ms=self.deadline_ms)

    def status(self) -> Dict[str, Any]:
        return _request("GET", f"{self.base}/", timeout=self.timeout,
                        retry=self.retry, deadline_ms=self.deadline_ms)
