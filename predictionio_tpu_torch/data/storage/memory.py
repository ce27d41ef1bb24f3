"""In-memory storage backend, the ``memory`` source type.

Port of ``predictionio_tpu/data/storage/memory.py``: every repository
the registry hands out, kept in one process, the shared spill queue
included.
"""

from __future__ import annotations

import collections
import copy
import datetime as _dt
import itertools
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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
    "MemorySpillQueues",
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

    def create_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None,
                     tokens: Optional[Sequence[str]] = None) -> List[str]:
        """One pass under the lock; ids derive from the sub-tokens, and a
        key already present (prior partial landing of the same batch) is
        left untouched — per-item exactly-once on replay."""
        if tokens is None:
            # One uuid4 per BATCH, not per event (see sqlite.create_batch).
            pre = uuid.uuid4().hex
            tokens = [f"{pre}{i:x}" for i in range(len(events))]
        else:
            tokens = list(tokens)
        if len(tokens) != len(events):
            raise base.StorageError(
                f"create_batch: {len(events)} events but {len(tokens)} "
                "tokens")
        with self._lock:
            bucket = self._bucket(app_id, channel_id)
            ids = []
            for ev, tok in zip(events, tokens):
                eid = base.batch_event_id(tok)
                ids.append(eid)
                if eid not in bucket:
                    bucket[eid] = ev.with_event_id(eid)
            return ids

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


class MemorySpillQueues(base.SpillQueues):
    """In-process shared spill queue.

    "Shared" here means shared by every server in THIS process that holds
    the same Storage object; cross-process deployments ride sqlite."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queues: Dict[
            str, "collections.OrderedDict[str, base.QueueRecord]"] = {}
        self._by_token: Dict[Tuple[str, str], str] = {}

    def _q(self, queue: str):
        return self._queues.setdefault(queue, collections.OrderedDict())

    def enqueue(self, queue, payload, token=None, events=1, now_s=None):
        now = time.time() if now_s is None else float(now_s)
        with self._lock:
            if token is not None:
                rid = self._by_token.get((queue, token))
                if rid is not None:
                    return rid  # lost-reply retry: already queued
            rid = uuid.uuid4().hex
            self._q(queue)[rid] = base.QueueRecord(
                id=rid, payload=copy.deepcopy(payload), token=token,
                events=int(events), enqueued_s=now)
            if token is not None:
                self._by_token[(queue, token)] = rid
            return rid

    def lease(self, queue, owner, n, ttl_s, now_s=None):
        now = time.time() if now_s is None else float(now_s)
        out: List[base.QueueRecord] = []
        with self._lock:
            for rec in self._q(queue).values():
                if len(out) >= int(n):
                    break
                claimable = rec.state == "pending" or (
                    rec.state == "leased"
                    and rec.lease_expires_s is not None
                    and rec.lease_expires_s < now)
                if not claimable:
                    continue
                rec.state = "leased"
                rec.lease_owner = owner
                rec.lease_expires_s = now + float(ttl_s)
                rec.attempts += 1
                out.append(copy.deepcopy(rec))
        return out

    def _owned(self, queue, ids, owner):
        q = self._q(queue)
        return [rid for rid in ids
                if rid in q and q[rid].state == "leased"
                and q[rid].lease_owner == owner]

    def ack(self, queue, ids, owner):
        with self._lock:
            q = self._q(queue)
            owned = self._owned(queue, ids, owner)
            for rid in owned:
                rec = q.pop(rid)
                if rec.token is not None:
                    self._by_token.pop((queue, rec.token), None)
            return len(owned)

    def nack(self, queue, ids, owner):
        with self._lock:
            q = self._q(queue)
            owned = self._owned(queue, ids, owner)
            for rid in owned:
                q[rid].state = "pending"
                q[rid].lease_owner = None
                q[rid].lease_expires_s = None
            return len(owned)

    def dead_letter(self, queue, record_id, owner, reason):
        with self._lock:
            owned = self._owned(queue, [record_id], owner)
            if not owned:
                return False
            rec = self._q(queue)[record_id]
            rec.state = "dead"
            rec.lease_owner = None
            rec.lease_expires_s = None
            rec.reason = str(reason)[:500]
            return True

    def requeue_dead(self, queue):
        with self._lock:
            n_events = 0
            for rec in self._q(queue).values():
                if rec.state == "dead":
                    rec.state = "pending"
                    rec.reason = None
                    n_events += rec.events
            return n_events

    def stats(self, queue, now_s=None):
        now = time.time() if now_s is None else float(now_s)
        out = {"pending": 0, "leased": 0, "expired": 0, "dead": 0,
               "pendingEvents": 0, "leasedEvents": 0, "deadEvents": 0}
        with self._lock:
            for rec in self._q(queue).values():
                out[rec.state] = out.get(rec.state, 0) + 1
                key = f"{rec.state}Events"
                out[key] = out.get(key, 0) + rec.events
                if rec.state == "leased" and rec.lease_expires_s is not None \
                        and rec.lease_expires_s < now:
                    out["expired"] += 1
        return out

    def peek(self, queue, n=5, state="pending"):
        with self._lock:
            return [copy.deepcopy(rec) for rec in self._q(queue).values()
                    if rec.state == state][: int(n)]


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
