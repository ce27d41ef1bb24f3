"""SQLite storage backend, the zero-config local default.

Port of ``predictionio_tpu/data/storage/sqlite.py`` (reference analogue:
storage/jdbc/).  The schema, indexes and PRAGMAs are the reference's,
table for table, so a ``pio.db`` written by either package reads in the
other; that includes the shared spill-queue table and the bulk-ingest
ids ``create_batch`` derives from its tokens.  Nothing here needs
``pyarrow``: the columnar scan answers numpy columns (property bags as
JSON text) and the columnar ingest takes plain sequences.
"""

from __future__ import annotations

import datetime as _dt
import json
import sqlite3
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

__all__ = ["SQLiteClient"]


# Single source of truth for the naive-datetime-is-UTC rule lives in base.
_us = base.epoch_us
_dt_from = base.from_epoch_us


class SQLiteClient:
    """One client per database file; hands out repository adapters.

    Concurrency: sqlite3 with WAL + a process-wide lock per client.  The
    event-server hot path batches inserts; contention is not the bottleneck
    at local scale (the reference's HBase/PG backends own that regime).
    """

    def __init__(self, path: str, namespace: str = "pio"):
        self.path = path
        self.namespace = namespace
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        # Default wal_autocheckpoint (1000 pages) forces a WAL->db copy
        # every ~4MB, which halves sustained bulk-ingest throughput.  Let
        # the WAL run long between checkpoints and truncate it back after.
        self._conn.execute("PRAGMA wal_autocheckpoint=20000")
        self._conn.execute("PRAGMA journal_size_limit=134217728")
        self._lock = threading.RLock()
        # Positive (app, channel) init-check cache: the ingest hot path
        # otherwise pays a SELECT per insert.  In-process only — a remove()
        # through ANOTHER process is not seen, matching the reference's
        # per-JVM metadata caching.
        self._inited_cache: set = set()
        self._ensure_schema()

    # -- schema -----------------------------------------------------------
    def _ensure_schema(self) -> None:
        ns = self.namespace
        with self._lock, self._conn:
            c = self._conn
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_apps (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    name TEXT NOT NULL UNIQUE,
                    description TEXT)"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_accesskeys (
                    accesskey TEXT PRIMARY KEY,
                    appid INTEGER NOT NULL,
                    events TEXT NOT NULL)"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_channels (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    name TEXT NOT NULL,
                    appid INTEGER NOT NULL,
                    UNIQUE(appid, name))"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_engineinstances (
                    id TEXT PRIMARY KEY,
                    status TEXT NOT NULL,
                    starttime INTEGER NOT NULL,
                    endtime INTEGER,
                    engineid TEXT NOT NULL,
                    engineversion TEXT NOT NULL,
                    enginevariant TEXT NOT NULL,
                    enginefactory TEXT NOT NULL,
                    env TEXT NOT NULL,
                    runtimeconf TEXT NOT NULL,
                    datasourceparams TEXT NOT NULL,
                    preparatorparams TEXT NOT NULL,
                    algorithmsparams TEXT NOT NULL,
                    servingparams TEXT NOT NULL)"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_evaluationinstances (
                    id TEXT PRIMARY KEY,
                    status TEXT NOT NULL,
                    starttime INTEGER NOT NULL,
                    endtime INTEGER,
                    evaluationclass TEXT NOT NULL,
                    engineparamsgeneratorclass TEXT NOT NULL,
                    env TEXT NOT NULL,
                    evaluatorresults TEXT NOT NULL,
                    evaluatorresultshtml TEXT NOT NULL,
                    evaluatorresultsjson TEXT NOT NULL)"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_models (
                    id TEXT PRIMARY KEY,
                    models BLOB NOT NULL)"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_events (
                    id TEXT PRIMARY KEY,
                    appid INTEGER NOT NULL,
                    channelid INTEGER,
                    event TEXT NOT NULL,
                    entitytype TEXT NOT NULL,
                    entityid TEXT NOT NULL,
                    targetentitytype TEXT,
                    targetentityid TEXT,
                    properties TEXT NOT NULL,
                    eventtime INTEGER NOT NULL,
                    prid TEXT,
                    creationtime INTEGER NOT NULL)"""
            )
            c.execute(
                f"""CREATE INDEX IF NOT EXISTS {ns}_events_scan
                    ON {ns}_events (appid, channelid, eventtime)"""
            )
            c.execute(
                f"""CREATE INDEX IF NOT EXISTS {ns}_events_entity
                    ON {ns}_events (appid, channelid, entitytype, entityid)"""
            )
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_events_inited (
                    appid INTEGER NOT NULL,
                    channelid INTEGER,
                    UNIQUE(appid, channelid))"""
            )
            # The shared spill queue (SQLiteSpillQueues).
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_spillqueue (
                    seq INTEGER PRIMARY KEY AUTOINCREMENT,
                    id TEXT NOT NULL UNIQUE,
                    queue TEXT NOT NULL,
                    token TEXT,
                    payload TEXT NOT NULL,
                    events INTEGER NOT NULL,
                    attempts INTEGER NOT NULL DEFAULT 0,
                    state TEXT NOT NULL DEFAULT 'pending',
                    leaseowner TEXT,
                    leaseexpires REAL,
                    reason TEXT,
                    enqueued REAL NOT NULL,
                    UNIQUE(queue, token))"""
            )
            c.execute(
                f"""CREATE INDEX IF NOT EXISTS {ns}_spillqueue_scan
                    ON {ns}_spillqueue (queue, state, seq)"""
            )
            # Shared KV (the durable fold-in cache).
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS {ns}_kv (
                    ns TEXT NOT NULL,
                    key TEXT NOT NULL,
                    value BLOB NOT NULL,
                    updated REAL NOT NULL,
                    PRIMARY KEY (ns, key))"""
            )

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- repository accessors --------------------------------------------
    def apps(self) -> "SQLiteApps":
        return SQLiteApps(self)

    def access_keys(self) -> "SQLiteAccessKeys":
        return SQLiteAccessKeys(self)

    def channels(self) -> "SQLiteChannels":
        return SQLiteChannels(self)

    def engine_instances(self) -> "SQLiteEngineInstances":
        return SQLiteEngineInstances(self)

    def evaluation_instances(self) -> "SQLiteEvaluationInstances":
        return SQLiteEvaluationInstances(self)

    def models(self) -> "SQLiteModels":
        return SQLiteModels(self)

    def events(self) -> "SQLiteEvents":
        return SQLiteEvents(self)

    def spill_queues(self) -> "SQLiteSpillQueues":
        return SQLiteSpillQueues(self)

    def kv(self) -> "SQLiteKV":
        return SQLiteKV(self)


class _Repo:
    def __init__(self, client: SQLiteClient):
        self._c = client
        self._ns = client.namespace

    @property
    def _conn(self):
        return self._c._conn

    @property
    def _lock(self):
        return self._c._lock


class SQLiteApps(_Repo, base.Apps):
    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            try:
                with self._conn:
                    cur = self._conn.execute(
                        f"INSERT INTO {self._ns}_apps (id, name, description) VALUES (?,?,?)",
                        (app.id, app.name, app.description),
                    )
                return cur.lastrowid if app.id is None else app.id
            except sqlite3.IntegrityError:
                return None

    def get(self, app_id: int) -> Optional[App]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id,name,description FROM {self._ns}_apps WHERE id=?", (app_id,)
            ).fetchone()
        return App(*row) if row else None

    def get_by_name(self, name: str) -> Optional[App]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id,name,description FROM {self._ns}_apps WHERE name=?", (name,)
            ).fetchone()
        return App(*row) if row else None

    def get_all(self) -> List[App]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT id,name,description FROM {self._ns}_apps ORDER BY id"
            ).fetchall()
        return [App(*r) for r in rows]

    def update(self, app: App) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"UPDATE {self._ns}_apps SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id),
            )
            return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(f"DELETE FROM {self._ns}_apps WHERE id=?", (app_id,))
            return cur.rowcount > 0


class SQLiteAccessKeys(_Repo, base.AccessKeys):
    def insert(self, access_key: AccessKey) -> Optional[str]:
        key = access_key.key or AccessKey.generate(access_key.app_id).key
        with self._lock:
            try:
                with self._conn:
                    self._conn.execute(
                        f"INSERT INTO {self._ns}_accesskeys (accesskey, appid, events) VALUES (?,?,?)",
                        (key, access_key.app_id, json.dumps(list(access_key.events))),
                    )
                return key
            except sqlite3.IntegrityError:
                return None

    def _row_to_key(self, row) -> AccessKey:
        return AccessKey(key=row[0], app_id=row[1], events=tuple(json.loads(row[2])))

    def get(self, key: str) -> Optional[AccessKey]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT accesskey,appid,events FROM {self._ns}_accesskeys WHERE accesskey=?",
                (key,),
            ).fetchone()
        return self._row_to_key(row) if row else None

    def get_all(self) -> List[AccessKey]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT accesskey,appid,events FROM {self._ns}_accesskeys"
            ).fetchall()
        return [self._row_to_key(r) for r in rows]

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT accesskey,appid,events FROM {self._ns}_accesskeys WHERE appid=?",
                (app_id,),
            ).fetchall()
        return [self._row_to_key(r) for r in rows]

    def update(self, access_key: AccessKey) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"UPDATE {self._ns}_accesskeys SET appid=?, events=? WHERE accesskey=?",
                (access_key.app_id, json.dumps(list(access_key.events)), access_key.key),
            )
            return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_accesskeys WHERE accesskey=?", (key,)
            )
            return cur.rowcount > 0


class SQLiteChannels(_Repo, base.Channels):
    def _insert(self, channel: Channel) -> Optional[int]:
        with self._lock:
            try:
                with self._conn:
                    cur = self._conn.execute(
                        f"INSERT INTO {self._ns}_channels (id, name, appid) VALUES (?,?,?)",
                        (channel.id, channel.name, channel.app_id),
                    )
                return cur.lastrowid if channel.id is None else channel.id
            except sqlite3.IntegrityError:
                return None

    def get(self, channel_id: int) -> Optional[Channel]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id,name,appid FROM {self._ns}_channels WHERE id=?", (channel_id,)
            ).fetchone()
        return Channel(id=row[0], name=row[1], app_id=row[2]) if row else None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT id,name,appid FROM {self._ns}_channels WHERE appid=?", (app_id,)
            ).fetchall()
        return [Channel(id=r[0], name=r[1], app_id=r[2]) for r in rows]

    def delete(self, channel_id: int) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_channels WHERE id=?", (channel_id,)
            )
            return cur.rowcount > 0


class SQLiteEngineInstances(_Repo, base.EngineInstances):
    _COLS = (
        "id,status,starttime,endtime,engineid,engineversion,enginevariant,"
        "enginefactory,env,runtimeconf,datasourceparams,preparatorparams,"
        "algorithmsparams,servingparams"
    )

    def _to_row(self, i: EngineInstance):
        return (
            i.id, i.status, _us(i.start_time), _us(i.end_time), i.engine_id,
            i.engine_version, i.engine_variant, i.engine_factory,
            json.dumps(i.env), json.dumps(i.runtime_conf), i.datasource_params,
            i.preparator_params, i.algorithms_params, i.serving_params,
        )

    def _from_row(self, r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=_dt_from(r[2]), end_time=_dt_from(r[3]),
            engine_id=r[4], engine_version=r[5], engine_variant=r[6],
            engine_factory=r[7], env=json.loads(r[8]), runtime_conf=json.loads(r[9]),
            datasource_params=r[10], preparator_params=r[11],
            algorithms_params=r[12], serving_params=r[13],
        )

    def insert(self, instance: EngineInstance) -> str:
        instance.id = instance.id or uuid.uuid4().hex
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT INTO {self._ns}_engineinstances ({self._COLS}) "
                f"VALUES ({','.join('?' * 14)})",
                self._to_row(instance),
            )
        return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_engineinstances WHERE id=?",
                (instance_id,),
            ).fetchone()
        return self._from_row(row) if row else None

    def get_all(self) -> List[EngineInstance]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_engineinstances ORDER BY starttime DESC"
            ).fetchall()
        return [self._from_row(r) for r in rows]

    def get_completed(self, engine_id, engine_version, engine_variant):
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_engineinstances "
                "WHERE status='COMPLETED' AND engineid=? AND engineversion=? AND enginevariant=? "
                "ORDER BY starttime DESC",
                (engine_id, engine_version, engine_variant),
            ).fetchall()
        return [self._from_row(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        c = self.get_completed(engine_id, engine_version, engine_variant)
        return c[0] if c else None

    def update(self, instance: EngineInstance) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"UPDATE {self._ns}_engineinstances SET status=?, starttime=?, endtime=?, "
                "engineid=?, engineversion=?, enginevariant=?, enginefactory=?, env=?, "
                "runtimeconf=?, datasourceparams=?, preparatorparams=?, algorithmsparams=?, "
                "servingparams=? WHERE id=?",
                self._to_row(instance)[1:] + (instance.id,),
            )
            return cur.rowcount > 0

    def delete(self, instance_id: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_engineinstances WHERE id=?", (instance_id,)
            )
            return cur.rowcount > 0


class SQLiteEvaluationInstances(_Repo, base.EvaluationInstances):
    _COLS = (
        "id,status,starttime,endtime,evaluationclass,engineparamsgeneratorclass,"
        "env,evaluatorresults,evaluatorresultshtml,evaluatorresultsjson"
    )

    def _to_row(self, i: EvaluationInstance):
        return (
            i.id, i.status, _us(i.start_time), _us(i.end_time), i.evaluation_class,
            i.engine_params_generator_class, json.dumps(i.env), i.evaluator_results,
            i.evaluator_results_html, i.evaluator_results_json,
        )

    def _from_row(self, r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=_dt_from(r[2]), end_time=_dt_from(r[3]),
            evaluation_class=r[4], engine_params_generator_class=r[5],
            env=json.loads(r[6]), evaluator_results=r[7],
            evaluator_results_html=r[8], evaluator_results_json=r[9],
        )

    def insert(self, instance: EvaluationInstance) -> str:
        instance.id = instance.id or uuid.uuid4().hex
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT INTO {self._ns}_evaluationinstances ({self._COLS}) "
                f"VALUES ({','.join('?' * 10)})",
                self._to_row(instance),
            )
        return instance.id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_evaluationinstances WHERE id=?",
                (instance_id,),
            ).fetchone()
        return self._from_row(row) if row else None

    def get_all(self) -> List[EvaluationInstance]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_evaluationinstances ORDER BY starttime DESC"
            ).fetchall()
        return [self._from_row(r) for r in rows]

    def get_completed(self) -> List[EvaluationInstance]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_evaluationinstances "
                "WHERE status='EVALCOMPLETED' ORDER BY starttime DESC"
            ).fetchall()
        return [self._from_row(r) for r in rows]

    def update(self, instance: EvaluationInstance) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"UPDATE {self._ns}_evaluationinstances SET status=?, starttime=?, "
                "endtime=?, evaluationclass=?, engineparamsgeneratorclass=?, env=?, "
                "evaluatorresults=?, evaluatorresultshtml=?, evaluatorresultsjson=? "
                "WHERE id=?",
                self._to_row(instance)[1:] + (instance.id,),
            )
            return cur.rowcount > 0

    def delete(self, instance_id: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_evaluationinstances WHERE id=?", (instance_id,)
            )
            return cur.rowcount > 0


class SQLiteModels(_Repo, base.Models):
    def insert(self, model: Model) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {self._ns}_models (id, models) VALUES (?,?)",
                (model.id, model.models),
            )

    def get(self, model_id: str) -> Optional[Model]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id, models FROM {self._ns}_models WHERE id=?", (model_id,)
            ).fetchone()
        return Model(id=row[0], models=row[1]) if row else None

    def delete(self, model_id: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_models WHERE id=?", (model_id,)
            )
            return cur.rowcount > 0


class SQLiteEvents(_Repo, base.Events):
    columnar_properties = "json"

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR IGNORE INTO {self._ns}_events_inited (appid, channelid) VALUES (?,?)",
                (app_id, channel_id),
            )
        self._c._inited_cache.add((app_id, channel_id))
        return True

    def _check_init(self, app_id: int, channel_id: Optional[int]) -> None:
        if (app_id, channel_id) in self._c._inited_cache:
            return
        with self._lock:
            row = self._conn.execute(
                f"SELECT 1 FROM {self._ns}_events_inited WHERE appid=? AND channelid IS ?",
                (app_id, channel_id),
            ).fetchone()
        if row is None:
            raise base.StorageError(
                f"Events store for app {app_id} channel {channel_id} not initialized."
            )
        self._c._inited_cache.add((app_id, channel_id))

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._c._inited_cache.discard((app_id, channel_id))
        with self._lock, self._conn:
            self._conn.execute(
                f"DELETE FROM {self._ns}_events WHERE appid=? AND channelid IS ?",
                (app_id, channel_id),
            )
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_events_inited WHERE appid=? AND channelid IS ?",
                (app_id, channel_id),
            )
            return cur.rowcount > 0

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        self._check_init(app_id, channel_id)
        ids, rows = [], []
        for ev in events:
            eid = uuid.uuid4().hex  # store-assigned, any client id ignored
            ids.append(eid)
            rows.append(
                (
                    eid, app_id, channel_id, ev.event, ev.entity_type, ev.entity_id,
                    ev.target_entity_type, ev.target_entity_id,
                    json.dumps(ev.properties.to_dict()), _us(ev.event_time),
                    ev.pr_id, _us(ev.creation_time),
                )
            )
        with self._lock, self._conn:
            self._conn.executemany(
                f"INSERT INTO {self._ns}_events VALUES ({','.join('?' * 12)})", rows
            )
        return ids

    def create_batch(
        self, events: Sequence[Event], app_id: int,
        channel_id: Optional[int] = None,
        tokens: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """One transaction, one executemany, per-item exactly-once: ids
        derive from the sub-tokens and ``id`` is the PRIMARY KEY, so
        ``INSERT OR IGNORE`` makes a replay after a partial landing skip
        exactly the rows that already committed."""
        self._check_init(app_id, channel_id)
        if tokens is None:
            # One uuid4 per BATCH, not per event: at 100k+ ev/s the
            # per-event uuid4() alone costs more than the sqlite insert.
            pre = uuid.uuid4().hex
            tokens = [f"{pre}{i:x}" for i in range(len(events))]
        else:
            tokens = list(tokens)
        if len(tokens) != len(events):
            raise base.StorageError(
                f"create_batch: {len(events)} events but {len(tokens)} "
                "tokens")
        ids, rows = [], []
        dumps, us, batch_id = json.dumps, _us, base.batch_event_id
        for ev, tok in zip(events, tokens):
            eid = batch_id(tok)
            ids.append(eid)
            props = ev.properties._fields  # skip the to_dict() copy
            rows.append((
                eid, app_id, channel_id, ev.event, ev.entity_type,
                ev.entity_id, ev.target_entity_type, ev.target_entity_id,
                dumps(props) if props else "{}", us(ev.event_time),
                ev.pr_id, us(ev.creation_time),
            ))
        with self._lock, self._conn:
            self._conn.executemany(
                f"INSERT OR IGNORE INTO {self._ns}_events "
                f"VALUES ({','.join('?' * 12)})", rows
            )
        return ids

    def _row_to_event(self, r) -> Event:
        return Event(
            event_id=r[0], event=r[3], entity_type=r[4], entity_id=r[5],
            target_entity_type=r[6], target_entity_id=r[7],
            properties=DataMap(json.loads(r[8])), event_time=_dt_from(r[9]),
            pr_id=r[10], creation_time=_dt_from(r[11]),
        )

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None):
        self._check_init(app_id, channel_id)
        with self._lock:
            row = self._conn.execute(
                f"SELECT * FROM {self._ns}_events WHERE id=? AND appid=? AND channelid IS ?",
                (event_id, app_id, channel_id),
            ).fetchone()
        return self._row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._check_init(app_id, channel_id)
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_events WHERE id=? AND appid=? AND channelid IS ?",
                (event_id, app_id, channel_id),
            )
            return cur.rowcount > 0

    def latest_event_time(
        self, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[_dt.datetime]:
        """Ingest high-watermark: one indexed MAX over (appid, channelid,
        eventtime) — the freshness anchor must stay O(log n), it is
        polled per ingest batch and per refresh cycle."""
        self._check_init(app_id, channel_id)
        with self._lock:
            row = self._conn.execute(
                f"SELECT MAX(eventtime) FROM {self._ns}_events "
                "WHERE appid=? AND channelid IS ?",
                (app_id, channel_id),
            ).fetchone()
        return _dt_from(row[0]) if row and row[0] is not None else None

    def _where(
        self, app_id, channel_id, start_time, until_time, entity_type, entity_id,
        event_names, target_entity_type, target_entity_id,
    ):
        clauses = ["appid=?", "channelid IS ?"]
        params: List[Any] = [app_id, channel_id]
        if start_time is not None:
            clauses.append("eventtime>=?")
            params.append(_us(start_time))
        if until_time is not None:
            clauses.append("eventtime<?")
            params.append(_us(until_time))
        if entity_type is not None:
            clauses.append("entitytype=?")
            params.append(entity_type)
        if entity_id is not None:
            clauses.append("entityid=?")
            params.append(entity_id)
        if event_names is not None:
            clauses.append(f"event IN ({','.join('?' * len(event_names))})")
            params.extend(event_names)
        if target_entity_type is not None:
            clauses.append("targetentitytype=?")
            params.append(target_entity_type)
        if target_entity_id is not None:
            clauses.append("targetentityid=?")
            params.append(target_entity_id)
        return " AND ".join(clauses), params

    def _source(self, entity_type, entity_id) -> str:
        """The events table, pinned to the entity index when one entity
        is asked for.  Left to itself, sqlite's planner serves ``ORDER BY
        eventtime ... LIMIT n`` from the time index and walks the app's
        events until n match: the whole app for a user with fewer than n
        events (about 1 s at a million events).  The reference's SQL
        takes that plan, which leaves rows tied in (eventtime,
        creationtime) in the index's rowid order, walked in the read's
        direction; :meth:`_find_sql` makes that order explicit with a
        last ``rowid`` key, so the pinned plan answers the same rows in
        the same order, ties and limits included."""
        table = f"{self._ns}_events"
        if entity_type is not None and entity_id is not None:
            return f"{table} INDEXED BY {table}_entity"
        return table

    def _find_sql(self, app_id, channel_id, start_time, until_time,
                  entity_type, entity_id, event_names, target_entity_type,
                  target_entity_id, limit, reversed):
        where, params = self._where(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        )
        order = "DESC" if reversed else "ASC"
        sql = (
            f"SELECT * FROM {self._source(entity_type, entity_id)} "
            f"WHERE {where} ORDER BY eventtime {order}, "
            f"creationtime {order}, rowid {order}"
        )
        if limit is not None and limit >= 0:
            sql += f" LIMIT {int(limit)}"
        return sql, params

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
        self._check_init(app_id, channel_id)
        sql, params = self._find_sql(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
            limit, reversed)
        # Lazy batched scan on its OWN connection: a full-store read
        # (training, streamed remote pages) never materializes every Event
        # at once, and WAL gives the reader connection snapshot isolation —
        # concurrent writes through the client's shared connection cannot
        # make an in-progress scan skip or repeat rows (a cursor on the
        # SAME connection as the writer has no such guarantee).  Query
        # errors still surface at call time (execute runs eagerly).
        if self._c.path == ":memory:":
            # No second connection can see a :memory: database.
            with self._lock:
                rows = self._conn.execute(sql, params).fetchall()
            return iter([self._row_to_event(r) for r in rows])
        rc = sqlite3.connect(self._c.path, check_same_thread=False)
        try:
            cur = rc.execute(sql, params)
        except Exception:
            rc.close()
            raise

        def gen():
            try:
                while True:
                    rows = cur.fetchmany(1024)
                    if not rows:
                        return
                    for r in rows:
                        yield self._row_to_event(r)
            finally:
                rc.close()

        return gen()

    # scan column -> SQL column, in EVENT_COLUMNS order
    _SQL_COL = {
        "event_id": "id", "event": "event", "entity_type": "entitytype",
        "entity_id": "entityid", "target_entity_type": "targetentitytype",
        "target_entity_id": "targetentityid", "properties": "properties",
        "event_time_us": "eventtime", "pr_id": "prid",
        "creation_time_us": "creationtime",
    }
    _TIME_COLS = ("event_time_us", "creation_time_us")

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
        """Columnar scan straight out of SQL, no Event objects: the
        reference's SELECT (``columns`` narrows it, ``ordered=False``
        drops the ORDER BY, so rows come in the order sqlite's plan
        reads them, as the reference's do), each fetch chunk transposed
        with ``zip(*rows)`` into numpy columns — object arrays for
        strings, the property bags as their JSON text, int64 for the
        microsecond times."""
        self._check_init(app_id, channel_id)
        names = tuple(columns) if columns is not None else base.EVENT_COLUMNS
        unknown = [c for c in names if c not in self._SQL_COL]
        if unknown:
            raise base.StorageError(
                f"unknown event column(s) {unknown}; known: "
                f"{list(base.EVENT_COLUMNS)}")
        where, params = self._where(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        )
        sel = ", ".join(self._SQL_COL[c] for c in names)
        sql = (f"SELECT {sel} FROM {self._source(entity_type, entity_id)} "
               f"WHERE {where}")
        if ordered:
            sql += " ORDER BY eventtime ASC"
        parts: Dict[str, List[np.ndarray]] = {c: [] for c in names}
        with self._lock:
            cur = self._conn.execute(sql, params)
            while True:
                rows = cur.fetchmany(262_144)
                if not rows:
                    break
                for c, vals in zip(names, zip(*rows)):
                    if c in self._TIME_COLS:
                        parts[c].append(np.array(vals, dtype=np.int64))
                    else:
                        arr = np.empty(len(vals), dtype=object)
                        arr[:] = vals
                        parts[c].append(arr)
        return {c: (np.concatenate(parts[c]) if parts[c] else np.empty(
            0, dtype=np.int64 if c in self._TIME_COLS else object))
            for c in names}

    def insert_columnar(self, columns: Mapping[str, Sequence], app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Bulk ingest through one executemany per chunk, no Event
        objects; ids are ``blk<12 hex>-<row>``, one uuid a call."""
        self._check_init(app_id, channel_id)
        cols = base.normalize_event_columns(columns)
        n = len(cols["event"])
        prefix = f"blk{uuid.uuid4().hex[:12]}-"
        sql = (
            f"INSERT INTO {self._ns}_events (id, appid, channelid, event, "
            f"entitytype, entityid, targetentitytype, targetentityid, "
            f"properties, eventtime, prid, creationtime) "
            f"VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)"
        )
        rows = zip((f"{prefix}{i}" for i in range(n)), [app_id] * n,
                   [channel_id] * n, cols["event"], cols["entity_type"],
                   cols["entity_id"], cols["target_entity_type"],
                   cols["target_entity_id"], cols["properties"],
                   cols["event_time_us"], cols["pr_id"],
                   cols["creation_time_us"])
        with self._lock, self._conn:
            self._conn.executemany(sql, rows)
        return n


class SQLiteSpillQueues(_Repo, base.SpillQueues):
    """Shared spill queue over one sqlite file.

    Lease claims are per-row conditional UPDATEs (``WHERE id=? AND
    (pending OR expired)``), each atomic at the sqlite level, so two
    drainer processes sharing the file can race a lease and exactly one
    wins each record — no table lock held across the batch."""

    _COLS = ("id,queue,token,payload,events,attempts,state,leaseowner,"
             "leaseexpires,reason,enqueued")

    def _from_row(self, r) -> base.QueueRecord:
        return base.QueueRecord(
            id=r[0], payload=json.loads(r[3]), token=r[2], events=r[4],
            attempts=r[5], state=r[6], lease_owner=r[7],
            lease_expires_s=r[8], reason=r[9], enqueued_s=r[10])

    def enqueue(self, queue, payload, token=None, events=1, now_s=None):
        rid = uuid.uuid4().hex
        now = time.time() if now_s is None else float(now_s)
        with self._lock:
            if token is not None:
                row = self._conn.execute(
                    f"SELECT id FROM {self._ns}_spillqueue "
                    "WHERE queue=? AND token=?", (queue, token)).fetchone()
                if row is not None:
                    return row[0]  # lost-reply retry: already queued
            try:
                with self._conn:
                    self._conn.execute(
                        f"INSERT INTO {self._ns}_spillqueue "
                        "(id,queue,token,payload,events,attempts,state,"
                        "leaseowner,leaseexpires,reason,enqueued) "
                        "VALUES (?,?,?,?,?,0,'pending',NULL,NULL,NULL,?)",
                        (rid, queue, token,
                         json.dumps(payload, separators=(",", ":")),
                         int(events), now))
            except sqlite3.IntegrityError:
                # (queue, token) raced another process's enqueue
                row = self._conn.execute(
                    f"SELECT id FROM {self._ns}_spillqueue "
                    "WHERE queue=? AND token=?", (queue, token)).fetchone()
                if row is not None:
                    return row[0]
                raise
        return rid

    def lease(self, queue, owner, n, ttl_s, now_s=None):
        now = time.time() if now_s is None else float(now_s)
        expires = now + float(ttl_s)
        claimed: List[str] = []
        with self._lock, self._conn:
            rows = self._conn.execute(
                f"SELECT id FROM {self._ns}_spillqueue WHERE queue=? AND "
                "(state='pending' OR (state='leased' AND leaseexpires<?)) "
                "ORDER BY seq LIMIT ?", (queue, now, int(n))).fetchall()
            for (rid,) in rows:
                cur = self._conn.execute(
                    f"UPDATE {self._ns}_spillqueue SET state='leased', "
                    "leaseowner=?, leaseexpires=?, attempts=attempts+1 "
                    "WHERE id=? AND (state='pending' OR "
                    "(state='leased' AND leaseexpires<?))",
                    (owner, expires, rid, now))
                if cur.rowcount:
                    claimed.append(rid)
            if not claimed:
                return []
            out = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_spillqueue "
                f"WHERE id IN ({','.join('?' * len(claimed))}) "
                "ORDER BY seq", claimed).fetchall()
        return [self._from_row(r) for r in out]

    def ack(self, queue, ids, owner):
        ids = list(ids)
        if not ids:
            return 0
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_spillqueue WHERE queue=? AND "
                f"leaseowner=? AND state='leased' AND "
                f"id IN ({','.join('?' * len(ids))})",
                [queue, owner] + ids)
            return cur.rowcount

    def nack(self, queue, ids, owner):
        ids = list(ids)
        if not ids:
            return 0
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"UPDATE {self._ns}_spillqueue SET state='pending', "
                f"leaseowner=NULL, leaseexpires=NULL WHERE queue=? AND "
                f"leaseowner=? AND state='leased' AND "
                f"id IN ({','.join('?' * len(ids))})",
                [queue, owner] + ids)
            return cur.rowcount

    def dead_letter(self, queue, record_id, owner, reason):
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"UPDATE {self._ns}_spillqueue SET state='dead', "
                "leaseowner=NULL, leaseexpires=NULL, reason=? "
                "WHERE queue=? AND id=? AND leaseowner=? AND "
                "state='leased'", (str(reason)[:500], queue, record_id,
                                   owner))
            return cur.rowcount > 0

    def requeue_dead(self, queue):
        with self._lock, self._conn:
            row = self._conn.execute(
                f"SELECT COALESCE(SUM(events),0) FROM "
                f"{self._ns}_spillqueue WHERE queue=? AND state='dead'",
                (queue,)).fetchone()
            self._conn.execute(
                f"UPDATE {self._ns}_spillqueue SET state='pending', "
                "reason=NULL WHERE queue=? AND state='dead'", (queue,))
            return int(row[0])

    def stats(self, queue, now_s=None):
        now = time.time() if now_s is None else float(now_s)
        out = {"pending": 0, "leased": 0, "expired": 0, "dead": 0,
               "pendingEvents": 0, "leasedEvents": 0, "deadEvents": 0}
        with self._lock:
            rows = self._conn.execute(
                f"SELECT state, leaseexpires<?, COUNT(*), "
                f"COALESCE(SUM(events),0) FROM {self._ns}_spillqueue "
                "WHERE queue=? GROUP BY state, leaseexpires<?",
                (now, queue, now)).fetchall()
        for state, expired, n, ev in rows:
            out[state] = out.get(state, 0) + n
            out[f"{state}Events"] = out.get(f"{state}Events", 0) + ev
            if state == "leased" and expired:
                out["expired"] += n
        return out

    def peek(self, queue, n=5, state="pending"):
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._ns}_spillqueue "
                "WHERE queue=? AND state=? ORDER BY seq LIMIT ?",
                (queue, state, int(n))).fetchall()
        return [self._from_row(r) for r in rows]


class SQLiteKV(_Repo, base.KV):
    def put(self, ns: str, key: str, value: bytes) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {self._ns}_kv "
                "(ns, key, value, updated) VALUES (?,?,?,?)",
                (ns, key, sqlite3.Binary(bytes(value)), time.time()))

    def get(self, ns: str, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT value FROM {self._ns}_kv WHERE ns=? AND key=?",
                (ns, key)).fetchone()
        return bytes(row[0]) if row else None

    def delete(self, ns: str, key: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_kv WHERE ns=? AND key=?",
                (ns, key))
            return cur.rowcount > 0

    def count(self, ns: str) -> int:
        with self._lock:
            row = self._conn.execute(
                f"SELECT COUNT(*) FROM {self._ns}_kv WHERE ns=?",
                (ns,)).fetchone()
        return int(row[0])

    def prune(self, ns: str, keep: int) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                f"DELETE FROM {self._ns}_kv WHERE ns=? AND key NOT IN "
                f"(SELECT key FROM {self._ns}_kv WHERE ns=? "
                "ORDER BY updated DESC LIMIT ?)",
                (ns, ns, max(int(keep), 0)))
            return cur.rowcount
