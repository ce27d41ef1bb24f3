"""Storage records and repository traits.

Port of the records and traits of ``predictionio_tpu/data/storage/base.py``
(reference: data/.../data/storage/ — App.scala, AccessKey.scala,
Channel.scala, EngineInstance.scala, EvaluationInstance.scala,
Model.scala, LEvents/PEvents) and of its shared ``KV``.  Where the
reference's columnar scan answers an Arrow table, the port's answers a
dict of numpy columns, and its columnar ingest takes one: the port
needs no ``pyarrow``.  Bulk ingest (``Events.create_batch``) derives
each event id from its idempotency sub-token (:func:`batch_event_id`),
the same string in both packages.
"""

from __future__ import annotations

import abc
import datetime as _dt
import json
import secrets
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import DataMap, Event, PropertyMap

__all__ = [
    "App",
    "AccessKey",
    "Channel",
    "EngineInstance",
    "EvaluationInstance",
    "Model",
    "Apps",
    "AccessKeys",
    "Channels",
    "Events",
    "EngineInstances",
    "EvaluationInstances",
    "Models",
    "SpillQueues",
    "QueueRecord",
    "KV",
    "StorageError",
    "StorageUnavailable",
    "batch_event_id",
    "EVENT_COLUMNS",
    "SEGMENT_FIELDS",
    "epoch_us",
    "from_epoch_us",
    "events_to_columns",
    "events_to_segment_columns",
    "normalize_event_columns",
    "columns_to_events",
]


def batch_event_id(token: str) -> str:
    """Deterministic event id for a bulk-ingest item from its idempotency
    sub-token.  The id IS the dedup key: every backend's ``create_batch``
    keys its conflict-ignoring insert on it, so a replayed batch (same
    tokens) lands each row at most once — even when a crash left the
    first attempt partially committed."""
    return f"bt{token}"


class StorageError(RuntimeError):
    pass


class StorageUnavailable(StorageError):
    """The backend is unreachable / timing out — an AVAILABILITY failure,
    distinct from a bad request: retriable, counted by circuit breakers,
    and mapped to 503 (or a spill-journal 202) by the servers instead of
    a client-fault 400."""

    retriable = True


@dataclass
class App:
    id: Optional[int]
    name: str
    description: Optional[str] = None


@dataclass
class AccessKey:
    key: str
    app_id: int
    events: Sequence[str] = ()          # allowlist; empty = all events

    @staticmethod
    def generate(app_id: int, events: Sequence[str] = ()) -> "AccessKey":
        # Drawn again while it starts with "-": the CLI's argument parser
        # would read such a key as an option (`pio accesskey delete`).
        key = secrets.token_urlsafe(48)
        while key.startswith("-"):
            key = secrets.token_urlsafe(48)
        return AccessKey(key=key, app_id=app_id, events=tuple(events))


@dataclass
class Channel:
    id: Optional[int]
    name: str
    app_id: int

    NAME_MAX = 16

    @staticmethod
    def is_valid_name(name: str) -> bool:
        # Reference: Channel.isValidName — [a-zA-Z0-9-] and 1..16 chars.
        return (0 < len(name) <= Channel.NAME_MAX
                and all((c.isascii() and c.isalnum()) or c == "-"
                        for c in name))


@dataclass
class EngineInstance:
    """One row per train run (reference: EngineInstance.scala)."""

    id: Optional[str]
    status: str                                  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    env: Dict[str, str] = field(default_factory=dict)
    runtime_conf: Dict[str, Any] = field(default_factory=dict)   # reference: sparkConf
    datasource_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclass
class EvaluationInstance:
    """One row per ``pio eval`` run (reference: EvaluationInstance.scala)."""

    id: Optional[str]
    status: str
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    evaluation_class: str
    engine_params_generator_class: str
    env: Dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""                  # text summary
    evaluator_results_html: str = ""
    evaluator_results_json: str = "{}"


@dataclass
class Model:
    """Binary model blob (reference: Model.scala / Models trait)."""

    id: str
    models: bytes


@dataclass
class QueueRecord:
    """One record of a shared spill queue.

    ``payload`` is the journal-record JSON object (token/appId/channelId/
    events); ``state`` walks pending → leased → (acked = deleted | dead).
    ``lease_expires_s`` is epoch seconds — lease math is done against a
    CALLER-supplied ``now_s`` so tests (and clock-skewed fleets) reason
    about expiry explicitly instead of trusting each backend's wall
    clock."""

    id: str
    payload: Dict[str, Any]
    token: Optional[str] = None
    events: int = 1
    attempts: int = 0
    state: str = "pending"            # pending | leased | dead
    lease_owner: Optional[str] = None
    lease_expires_s: Optional[float] = None
    reason: Optional[str] = None      # dead-letter reason
    enqueued_s: float = 0.0


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    def insert(self, channel: Channel) -> Optional[int]:
        """Validate then store: the name rules hold for every backend."""
        if not Channel.is_valid_name(channel.name):
            return None
        return self._insert(channel)

    @abc.abstractmethod
    def _insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class SpillQueues(abc.ABC):
    """Shared durable work queue with lease/ack semantics.

    The fleet-scale home for the event server's failed writes: N event
    servers enqueue into ONE storage-backed queue, and any instance's
    drainer may lease a batch, replay it, and ack.  A crashed drainer's
    lease expires (``lease_expires_s`` vs the caller's ``now_s``) and
    another instance re-leases the batch — replay stays idempotent
    because each record carries the ORIGINAL write's idempotency tokens.

    - :meth:`enqueue` is token-idempotent — re-enqueueing a token already
      queued (lost-reply retry) returns the existing record's id.
    - :meth:`lease` atomically claims up to ``n`` records that are
      pending OR whose lease expired before ``now_s``, oldest first,
      bumping ``attempts`` — two concurrent drainers never hold the same
      record under an unexpired lease.
    - :meth:`ack` deletes ONLY records still leased by ``owner`` — an
      acker whose lease was stolen learns it from the return count.
    - :meth:`nack` releases records back to pending (transient replay
      failure: storage still down, retry next tick).
    - :meth:`dead_letter` parks a permanently unreplayable record (state
      ``dead``) where :meth:`requeue_dead` can resurrect it after the
      operator fixes the cause.
    """

    @abc.abstractmethod
    def enqueue(self, queue: str, payload: Dict[str, Any],
                token: Optional[str] = None, events: int = 1,
                now_s: Optional[float] = None) -> str: ...

    @abc.abstractmethod
    def lease(self, queue: str, owner: str, n: int, ttl_s: float,
              now_s: Optional[float] = None) -> List[QueueRecord]: ...

    @abc.abstractmethod
    def ack(self, queue: str, ids: Sequence[str], owner: str) -> int: ...

    @abc.abstractmethod
    def nack(self, queue: str, ids: Sequence[str], owner: str) -> int: ...

    @abc.abstractmethod
    def dead_letter(self, queue: str, record_id: str, owner: str,
                    reason: str) -> bool: ...

    @abc.abstractmethod
    def requeue_dead(self, queue: str) -> int:
        """Move every dead record back to pending; returns EVENTS
        requeued (the operator-facing unit, matching the journal)."""

    @abc.abstractmethod
    def stats(self, queue: str, now_s: Optional[float] = None
              ) -> Dict[str, Any]:
        """``{"pending","leased","expired","dead"}`` record counts plus
        ``*Events`` sums — ``expired`` counts leased records whose lease
        already lapsed at ``now_s`` (re-leasable work)."""

    @abc.abstractmethod
    def peek(self, queue: str, n: int = 5, state: str = "pending"
             ) -> List[QueueRecord]:
        """Read-only oldest-first view for ``pio spill inspect`` — takes
        no lease, never mutates."""


class KV(abc.ABC):
    """Namespaced shared key-value store (the durable fold-in cache).
    Values are opaque bytes; ``prune`` bounds a namespace by dropping the
    least-recently-written entries, so several servers can share a cache
    without any one of them owning an eviction thread."""

    @abc.abstractmethod
    def put(self, ns: str, key: str, value: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, ns: str, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def delete(self, ns: str, key: str) -> bool: ...

    @abc.abstractmethod
    def count(self, ns: str) -> int: ...

    @abc.abstractmethod
    def prune(self, ns: str, keep: int) -> int:
        """Drop all but the ``keep`` most-recently-written entries of
        ``ns``; returns the number deleted."""


# The columns of a columnar event scan: the reference's Arrow event
# schema, with one property-bag column ``properties`` that holds each
# bag as its backend keeps it — a DataMap (memory) or its JSON text
# (sqlite); ``data.columnar.numeric_property`` reads either.
EVENT_COLUMNS = ("event_id", "event", "entity_type", "entity_id",
                 "target_entity_type", "target_entity_id", "properties",
                 "event_time_us", "pr_id", "creation_time_us")

# The reference's segment schema (``EVENT_ARROW_SCHEMA``) as Arrow field
# types by name, for :mod:`predictionio_tpu_torch.data.ipc`: every field
# nullable, each bag as JSON text in ``properties_json``.
SEGMENT_FIELDS = (("event_id", "utf8"), ("event", "utf8"),
                  ("entity_type", "utf8"), ("entity_id", "utf8"),
                  ("target_entity_type", "utf8"),
                  ("target_entity_id", "utf8"), ("properties_json", "utf8"),
                  ("event_time_us", "int64"), ("pr_id", "utf8"),
                  ("creation_time_us", "int64"))


class Events(abc.ABC):
    """Unified event store trait (reference: LEvents + PEvents).

    All methods take ``app_id`` and optional ``channel_id`` (None = the
    default channel).
    """

    # How find_columnar answers a property bag: "map" (a DataMap, as the
    # default implementation below does) or "json" (the bag's text).
    columnar_properties = "map"

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Create per-app/channel structures (reference: LEvents.init)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop all events of the app/channel (reference: LEvents.remove)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event; the store assigns a fresh event id (any
        ``event.event_id`` is ignored).  Returns the assigned id."""

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    def create_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None,
                     tokens: Optional[Sequence[str]] = None) -> List[str]:
        """One multi-row write with PER-ITEM exactly-once semantics.

        ``tokens`` are the batch's per-item idempotency sub-tokens; each
        item's event id is derived from its sub-token
        (:func:`batch_event_id`), so a replay of the same batch after a
        crashed reply — possibly after a PARTIAL landing — skips the rows
        that already committed and re-inserts only the missing ones,
        returning the same ids either way.  Without tokens a fresh set is
        minted.

        The base default delegates to :meth:`insert_batch` (store-assigned
        ids, at-least-once on replay); sqlite and memory override with a
        single conflict-ignoring write keyed on the derived ids.
        """
        if tokens is not None and len(tokens) != len(events):
            raise StorageError(
                f"create_batch: {len(events)} events but {len(tokens)} "
                "tokens")
        return self.insert_batch(events, app_id, channel_id)

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        *,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Time/entity-filtered scan (reference: LEvents.find), ordered by
        event time; ``start_time`` inclusive, ``until_time`` exclusive."""

    def find_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        *,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        ordered: bool = True,
        columns: Optional[Sequence[str]] = None,
    ) -> Dict[str, np.ndarray]:
        """Columnar scan for the training path (reference: PEvents.find):
        one numpy array per column of :data:`EVENT_COLUMNS` (or of
        ``columns``, in that order), object arrays for strings and
        property bags, int64 for the microsecond times.
        ``ordered=False`` lets a backend skip the event-time sort; this
        default implementation converts the (ordered) :meth:`find`
        scan."""
        evs = list(self.find(
            app_id, channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id))
        return events_to_columns(evs, columns)

    def insert_columnar(self, columns: Mapping[str, Sequence], app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Bulk columnar ingest (reference: ``insert_columnar``): one
        sequence per column of :data:`EVENT_COLUMNS`; ``event_id`` is
        ignored (the store assigns ids), missing optional columns are
        null, a missing creation time is now and a missing event time
        the creation time (:func:`normalize_event_columns`).  Returns
        the number of events ingested.  This default implementation
        inserts :meth:`insert_batch` chunks."""
        cols = normalize_event_columns(columns)
        n = len(cols["event"])
        done = 0
        for start in range(0, n, 65536):
            done += len(self.insert_batch(
                columns_to_events(cols, start, min(start + 65536, n)),
                app_id, channel_id))
        return done

    @abc.abstractmethod
    def latest_event_time(self, app_id: int,
                          channel_id: Optional[int] = None
                          ) -> Optional[_dt.datetime]:
        """The ingest high-watermark: the newest ``event_time`` stored
        for the app/channel, or None when it is empty."""

    def aggregate_properties(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        *,
        entity_type: str,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Aggregate ``$set``/``$unset``/``$delete`` into per-entity
        state: one :class:`PropertyMap` per entity that ends up set,
        keeping only entities holding every ``required`` key.

        Reference: PEventStore.aggregateProperties / LEventAggregator.
        """
        from predictionio_tpu_torch.data.event import (
            aggregate_properties as _agg)

        by_entity: Dict[str, List[Event]] = {}
        for ev in self.find(
            app_id,
            channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        ):
            by_entity.setdefault(ev.entity_id, []).append(ev)
        out: Dict[str, PropertyMap] = {}
        for eid, evs in by_entity.items():
            pm = _agg(evs)
            if pm is None:
                continue
            if required and not all(k in pm for k in required):
                continue
            out[eid] = pm
        return out


def epoch_us(dt: Optional[_dt.datetime]) -> Optional[int]:
    """Microseconds since the epoch; a naive datetime is taken as UTC."""
    if dt is None:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1_000_000)


def from_epoch_us(us: Optional[int]) -> Optional[_dt.datetime]:
    if us is None:
        return None
    return _dt.datetime.fromtimestamp(us / 1_000_000, tz=_dt.timezone.utc)


def events_to_columns(events: Sequence[Event],
                      columns: Optional[Sequence[str]] = None
                      ) -> Dict[str, np.ndarray]:
    """Events → the columnar scan's dict of numpy columns."""
    names = tuple(columns) if columns is not None else EVENT_COLUMNS
    unknown = [c for c in names if c not in EVENT_COLUMNS]
    if unknown:
        raise StorageError(f"unknown event column(s) {unknown}; known: "
                           f"{list(EVENT_COLUMNS)}")
    getters = {
        "event_id": lambda e: e.event_id,
        "event": lambda e: e.event,
        "entity_type": lambda e: e.entity_type,
        "entity_id": lambda e: e.entity_id,
        "target_entity_type": lambda e: e.target_entity_type,
        "target_entity_id": lambda e: e.target_entity_id,
        "properties": lambda e: e.properties,
        "pr_id": lambda e: e.pr_id,
    }
    out: Dict[str, np.ndarray] = {}
    for name in names:
        if name in ("event_time_us", "creation_time_us"):
            attr = name[:-3]
            out[name] = np.fromiter(
                (epoch_us(getattr(e, attr)) for e in events), np.int64,
                count=len(events))
        else:
            # element by element: a DataMap is a Mapping, which a bulk
            # assignment would try to unpack
            col = np.empty(len(events), dtype=object)
            get = getters[name]
            for i, e in enumerate(events):
                col[i] = get(e)
            out[name] = col
    return out


def events_to_segment_columns(events: Sequence[Event],
                              event_ids: Optional[Sequence[str]] = None
                              ) -> Dict[str, List[Any]]:
    """Events → one list per field of :data:`SEGMENT_FIELDS`, each bag
    serialized as the reference's ``events_to_arrow`` does:
    ``json.dumps(properties.to_dict())``.  (``json.dumps(dict(bag))`` of
    :func:`normalize_event_columns` is the same text for a ``DataMap``:
    both give the bag's own dict, nested values and all.)
    ``event_ids``, when given, replace the events' own ids."""
    return {
        "event_id": (list(event_ids) if event_ids is not None
                     else [e.event_id for e in events]),
        "event": [e.event for e in events],
        "entity_type": [e.entity_type for e in events],
        "entity_id": [e.entity_id for e in events],
        "target_entity_type": [e.target_entity_type for e in events],
        "target_entity_id": [e.target_entity_id for e in events],
        "properties_json": [json.dumps(e.properties.to_dict())
                            for e in events],
        "event_time_us": [epoch_us(e.event_time) for e in events],
        "pr_id": [e.pr_id for e in events],
        "creation_time_us": [epoch_us(e.creation_time) for e in events],
    }


def normalize_event_columns(columns: Mapping[str, Sequence]
                            ) -> Dict[str, List[Any]]:
    """Validate and complete a caller's columnar event batch for
    :meth:`Events.insert_columnar` (the reference's
    ``normalize_event_table``): ``event``, ``entity_type`` and
    ``entity_id`` are required and may hold no null; an unknown column
    raises; ``event_id`` is dropped; a property bag may be a mapping, its
    JSON text or null (``{}``); a missing or null creation time is now,
    a missing or null event time the row's creation time.  Answers
    plain lists, the property bags as JSON text."""
    names = set(columns)
    for req in ("event", "entity_type", "entity_id"):
        if req not in names:
            raise StorageError(f"insert_columnar: missing column {req!r}")
        nulls = list(columns[req]).count(None)
        if nulls:
            raise StorageError(
                f"insert_columnar: column {req!r} has {nulls} null "
                "value(s) — required per event (reference: "
                "EventJson4sSupport validation)")
    unknown = names - set(EVENT_COLUMNS)
    if unknown:
        raise StorageError(
            f"insert_columnar: unknown column(s) {sorted(unknown)}")
    n = len(columns["event"])
    lengths = {len(columns[c]) for c in names}
    if lengths != {n}:
        raise StorageError(
            f"insert_columnar: columns of different lengths {sorted(lengths)}")
    now_us = epoch_us(_dt.datetime.now(_dt.timezone.utc))

    def col(name):
        return list(columns[name]) if name in names else [None] * n

    def as_ints(name, defaults):
        """The column as ints, a null or a missing column by row from
        ``defaults``."""
        if name not in names:
            return list(defaults)
        values = columns[name]
        if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
            return values.astype(np.int64).tolist()     # holds no null
        return [d if v is None else int(v) for v, d in zip(values,
                                                             defaults)]

    out: Dict[str, List[Any]] = {
        name: col(name) for name in ("event", "entity_type", "entity_id",
                                     "target_entity_type",
                                     "target_entity_id", "pr_id")}
    out["properties"] = [
        "{}" if p is None else p if isinstance(p, str)
        else json.dumps(dict(p)) for p in col("properties")]
    out["creation_time_us"] = as_ints("creation_time_us", [now_us] * n)
    out["event_time_us"] = as_ints("event_time_us", out["creation_time_us"])
    return out


def columns_to_events(cols: Mapping[str, Sequence], start: int,
                      stop: int) -> List[Event]:
    """Rows ``[start, stop)`` of :func:`normalize_event_columns`' answer
    as events."""
    return [
        Event(event=cols["event"][i], entity_type=cols["entity_type"][i],
              entity_id=cols["entity_id"][i],
              target_entity_type=cols["target_entity_type"][i],
              target_entity_id=cols["target_entity_id"][i],
              properties=DataMap(json.loads(cols["properties"][i])),
              event_time=from_epoch_us(cols["event_time_us"][i]),
              pr_id=cols["pr_id"][i],
              creation_time=from_epoch_us(cols["creation_time_us"][i]))
        for i in range(start, stop)]


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...
