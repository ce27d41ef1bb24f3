"""In-memory storage backend, the ``memory`` source type.

Port of ``predictionio_tpu/data/storage/memory.py``: every repository
the registry hands out, kept in one process.  The reference's
``MemorySpillQueues`` waits for the event server.
"""

from __future__ import annotations

import copy
import datetime as _dt
import itertools
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

__all__ = [
    "MemoryApps",
    "MemoryAccessKeys",
    "MemoryChannels",
    "MemoryEngineInstances",
    "MemoryEvaluationInstances",
    "MemoryModels",
    "MemoryEvents",
    "MemoryKV",
]


class MemoryApps(base.Apps):
    def __init__(self):
        self._lock = threading.Lock()
        self._apps: Dict[int, App] = {}
        self._next = itertools.count(1)

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            if any(a.name == app.name for a in self._apps.values()):
                return None
            if app.id is not None:
                app_id = app.id
                if app_id in self._apps:
                    return None
            else:
                app_id = next(self._next)
                while app_id in self._apps:  # skip past explicitly-taken ids
                    app_id = next(self._next)
            self._apps[app_id] = App(id=app_id, name=app.name,
                                     description=app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return copy.copy(self._apps.get(app_id))

    def get_by_name(self, name: str) -> Optional[App]:
        return copy.copy(next((a for a in self._apps.values()
                               if a.name == name), None))

    def get_all(self) -> List[App]:
        return sorted((copy.copy(a) for a in self._apps.values()),
                      key=lambda a: a.id)

    def update(self, app: App) -> bool:
        with self._lock:
            if app.id not in self._apps:
                return False
            self._apps[app.id] = copy.copy(app)
            return True

    def delete(self, app_id: int) -> bool:
        with self._lock:
            return self._apps.pop(app_id, None) is not None


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self):
        self._keys: Dict[str, AccessKey] = {}
        self._lock = threading.Lock()

    def insert(self, access_key: AccessKey) -> Optional[str]:
        with self._lock:
            k = access_key.key or AccessKey.generate(access_key.app_id).key
            if k in self._keys:
                return None
            self._keys[k] = AccessKey(key=k, app_id=access_key.app_id,
                                      events=tuple(access_key.events))
            return k

    def get(self, key: str) -> Optional[AccessKey]:
        return self._keys.get(key)

    def get_all(self) -> List[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._keys.values() if k.app_id == app_id]

    def update(self, access_key: AccessKey) -> bool:
        with self._lock:
            if access_key.key not in self._keys:
                return False
            self._keys[access_key.key] = access_key
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._keys.pop(key, None) is not None


class MemoryChannels(base.Channels):
    def __init__(self):
        self._channels: Dict[int, Channel] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def _insert(self, channel: Channel) -> Optional[int]:
        with self._lock:
            if any(c.app_id == channel.app_id and c.name == channel.name
                   for c in self._channels.values()):
                return None
            if channel.id is not None:
                cid = channel.id
                if cid in self._channels:
                    return None
            else:
                cid = next(self._next)
                while cid in self._channels:
                    cid = next(self._next)
            self._channels[cid] = Channel(id=cid, name=channel.name,
                                          app_id=channel.app_id)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._channels.values() if c.app_id == app_id]

    def delete(self, channel_id: int) -> bool:
        with self._lock:
            return self._channels.pop(channel_id, None) is not None


def _match(ev: Event, start_time, until_time, entity_type, entity_id,
           event_names, target_entity_type, target_entity_id) -> bool:
    # Compare in epoch micros with the naive-datetime-is-UTC rule
    # (base.epoch_us): start_time INCLUSIVE, until_time EXCLUSIVE.
    if start_time is not None and \
            base.epoch_us(ev.event_time) < base.epoch_us(start_time):
        return False
    if until_time is not None and \
            base.epoch_us(ev.event_time) >= base.epoch_us(until_time):
        return False
    if entity_type is not None and ev.entity_type != entity_type:
        return False
    if entity_id is not None and ev.entity_id != entity_id:
        return False
    if event_names is not None and ev.event not in event_names:
        return False
    if target_entity_type is not None \
            and ev.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not None \
            and ev.target_entity_id != target_entity_id:
        return False
    return True


class MemoryEvents(base.Events):
    def __init__(self):
        self._store: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}
        self._lock = threading.Lock()

    def _bucket(self, app_id: int, channel_id: Optional[int]
                ) -> Dict[str, Event]:
        key = (app_id, channel_id)
        if key not in self._store:
            raise base.StorageError(
                f"Events store for app {app_id} channel {channel_id} not "
                "initialized.")
        return self._store[key]

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._store.setdefault((app_id, channel_id), {})
            return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._store.pop((app_id, channel_id), None) is not None

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        with self._lock:
            bucket = self._bucket(app_id, channel_id)
            eid = uuid.uuid4().hex  # store-assigned, any client id ignored
            bucket[eid] = event.with_event_id(eid)
            return eid

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        return self._bucket(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._bucket(app_id, channel_id).pop(
                event_id, None) is not None

    def find(self, app_id: int, channel_id: Optional[int] = None, *,
             start_time=None, until_time=None, entity_type=None,
             entity_id=None, event_names=None, target_entity_type=None,
             target_entity_id=None, limit: Optional[int] = None,
             reversed: bool = False) -> Iterator[Event]:
        names = None if event_names is None else frozenset(event_names)
        evs = [e for e in list(self._bucket(app_id, channel_id).values())
               if _match(e, start_time, until_time, entity_type, entity_id,
                         names, target_entity_type, target_entity_id)]
        # Order by instant (naive and aware stamps interleave), then by
        # creation time.
        evs.sort(key=lambda e: (base.epoch_us(e.event_time),
                                base.epoch_us(e.creation_time) or 0),
                 reverse=reversed)
        if limit is not None and limit >= 0:
            evs = evs[:limit]
        return iter(evs)

    def latest_event_time(self, app_id: int,
                          channel_id: Optional[int] = None
                          ) -> Optional[_dt.datetime]:
        bucket = self._bucket(app_id, channel_id)
        if not bucket:
            return None
        return max((e.event_time for e in bucket.values()),
                   key=base.epoch_us)


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self):
        self._instances: Dict[str, EngineInstance] = {}
        self._lock = threading.Lock()

    def insert(self, instance: EngineInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            instance.id = iid
            # store a snapshot: callers mutating their object must go
            # through update()
            self._instances[iid] = copy.deepcopy(instance)
            return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return copy.deepcopy(self._instances.get(instance_id))

    def get_all(self) -> List[EngineInstance]:
        return [copy.deepcopy(i) for i in self._instances.values()]

    def _completed(self, engine_id, engine_version, engine_variant):
        return sorted(
            (
                copy.deepcopy(i)
                for i in self._instances.values()
                if i.status == "COMPLETED"
                and i.engine_id == engine_id
                and i.engine_version == engine_version
                and i.engine_variant == engine_variant
            ),
            key=lambda i: i.start_time,
            reverse=True,
        )

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        c = self._completed(engine_id, engine_version, engine_variant)
        return c[0] if c else None

    def get_completed(self, engine_id, engine_version, engine_variant):
        return self._completed(engine_id, engine_version, engine_variant)

    def update(self, instance: EngineInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = copy.deepcopy(instance)
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._instances: Dict[str, EvaluationInstance] = {}
        self._lock = threading.Lock()

    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            instance.id = iid
            self._instances[iid] = copy.deepcopy(instance)
            return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return copy.deepcopy(self._instances.get(instance_id))

    def get_all(self) -> List[EvaluationInstance]:
        return [copy.deepcopy(i) for i in self._instances.values()]

    def get_completed(self) -> List[EvaluationInstance]:
        return sorted(
            (copy.deepcopy(i) for i in self._instances.values()
             if i.status == "EVALCOMPLETED"),
            key=lambda i: i.start_time,
            reverse=True,
        )

    def update(self, instance: EvaluationInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = copy.deepcopy(instance)
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemoryModels(base.Models):
    def __init__(self):
        self._models: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def insert(self, model: Model) -> None:
        with self._lock:
            self._models[model.id] = model.models

    def get(self, model_id: str) -> Optional[Model]:
        blob = self._models.get(model_id)
        return Model(id=model_id, models=blob) if blob is not None else None

    def delete(self, model_id: str) -> bool:
        with self._lock:
            return self._models.pop(model_id, None) is not None


class MemoryKV(base.KV):
    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, Tuple[bytes, float]]] = {}

    def put(self, ns: str, key: str, value: bytes) -> None:
        with self._lock:
            self._data.setdefault(ns, {})[key] = (bytes(value), time.time())

    def get(self, ns: str, key: str) -> Optional[bytes]:
        hit = self._data.get(ns, {}).get(key)
        return hit[0] if hit is not None else None

    def delete(self, ns: str, key: str) -> bool:
        with self._lock:
            return self._data.get(ns, {}).pop(key, None) is not None

    def count(self, ns: str) -> int:
        return len(self._data.get(ns, {}))

    def prune(self, ns: str, keep: int) -> int:
        with self._lock:
            entries = self._data.get(ns, {})
            if len(entries) <= keep:
                return 0
            ordered = sorted(entries.items(), key=lambda kv: kv[1][1],
                             reverse=True)
            drop = ordered[max(int(keep), 0):]
            for k, _ in drop:
                del entries[k]
            return len(drop)
