"""Storage records and repository traits that training and deploy need.

Port of the ``App`` / ``EngineInstance`` / ``Model`` records and the
``Apps`` / ``Events`` / ``EngineInstances`` / ``Models`` traits of
``predictionio_tpu/data/storage/base.py`` (reference:
data/.../data/storage/ — App.scala, LEvents/PEvents, EngineInstance.scala,
Model.scala).  Where the reference's columnar scan answers an Arrow
table, the port's answers a dict of numpy columns: the port needs no
``pyarrow``.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event

__all__ = [
    "App",
    "EngineInstance",
    "Model",
    "Apps",
    "Events",
    "EngineInstances",
    "Models",
    "StorageError",
    "EVENT_COLUMNS",
    "epoch_us",
]


class StorageError(RuntimeError):
    pass


@dataclass
class App:
    id: Optional[int]
    name: str
    description: Optional[str] = None


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
class Model:
    """Binary model blob (reference: Model.scala / Models trait)."""

    id: str
    models: bytes


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


# The columns of a columnar event scan (the reference's Arrow event
# schema, with the property bag as DataMap objects instead of JSON text).
EVENT_COLUMNS = ("event_id", "event", "entity_type", "entity_id",
                 "target_entity_type", "target_entity_id", "properties",
                 "event_time_us", "pr_id", "creation_time_us")


class Events(abc.ABC):
    """Unified event store trait (reference: LEvents + PEvents).

    All methods take ``app_id`` and optional ``channel_id`` (None = the
    default channel).
    """

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
        ``columns``), object arrays for strings and property bags, int64
        for the microsecond times.  ``ordered=False`` lets a backend skip
        the event-time sort; this default implementation converts the
        (ordered) :meth:`find` scan."""
        evs = list(self.find(
            app_id, channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id))
        return events_to_columns(evs, columns)


def epoch_us(dt: Optional[_dt.datetime]) -> Optional[int]:
    """Microseconds since the epoch; a naive datetime is taken as UTC."""
    if dt is None:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1_000_000)


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


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...
