"""Append-only Parquet event log, the ``parquetlog`` source type: the
batch-training event store.

Port of ``predictionio_tpu/data/storage/parquet_events.py`` (reference:
storage/hbase/, HBPEvents' full-scan reads), in the reference's own
files: the port reads and writes them with its own codec
(:mod:`predictionio_tpu_torch.data.parquet`), so a directory either
package wrote reads the same in the other.  ``find_columnar`` answers
the port's columnar contract (numpy columns under
:data:`~predictionio_tpu_torch.data.storage.base.EVENT_COLUMNS`, each
bag as its JSON text, kept on disk as ``properties_json``).

Layout: ``<root>/app_<id>/<channel|default>/part-<uuid>.parquet``; one
file per flushed batch, read in sorted name order (so an unordered read
follows file names, not insert order).  Deleting one event rewrites the
part file that holds it; ``remove`` drops the directory.  A part file
is written under a temporary name and renamed into place, so a reader
never sees half a file (the reference writes it in place).

Filters keep the reference's Arrow semantics, which differ from the
segment read's (:func:`~predictionio_tpu_torch.data.columnar.
filter_event_table`): an empty ``event_names`` matches no row, and a
null never equals a value (``target_entity_id=""`` matches no row
whose target is null).
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import shutil
import threading
import uuid
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data import parquet
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    EVENT_COLUMNS,
    SEGMENT_FIELDS,
    epoch_us,
    from_epoch_us,
)

__all__ = ["ParquetEvents"]

# the scan's column names → the file's (the bag is kept as its JSON text)
_ON_DISK = {c: ("properties_json" if c == "properties" else c)
            for c in EVENT_COLUMNS}
_TIME_COLS = ("event_time_us", "creation_time_us")


def _empty(name: str) -> np.ndarray:
    return np.empty(0, dtype=np.int64 if name in _TIME_COLS else object)


def _equal(col: np.ndarray, want: str) -> np.ndarray:
    """Rows whose value equals ``want``; a null equals nothing."""
    return np.asarray(col == want, dtype=bool)


def _times(col: np.ndarray):
    """(int64 values, valid mask or None) of a time column."""
    if col.dtype != object:
        return col, None
    valid = np.fromiter((v is not None for v in col), bool, count=len(col))
    values = np.zeros(len(col), np.int64)
    values[valid] = col[valid].astype(np.int64)
    return values, valid


class ParquetEvents(base.Events):
    """Single-event inserts are buffered in memory and flushed as one part
    file per :data:`FLUSH_THRESHOLD` events (or on any read or close): a
    file an event would make every scan O(events) file opens."""

    FLUSH_THRESHOLD = 256
    columnar_properties = "json"

    def __init__(self, root: str):
        self.root = Path(root)
        self._lock = threading.RLock()
        self._pending: Dict[tuple, List[Event]] = {}
        # create_batch's dedup index: token-derived event ids on disk, by
        # (app, channel), seeded by one projected scan of event_id and
        # then kept up to date (parquet has no key to conflict on)
        self._batch_ids: Dict[tuple, set] = {}

    def _dir(self, app_id: int, channel_id: Optional[int]) -> Path:
        chan = "default" if channel_id is None else str(channel_id)
        return self.root / f"app_{app_id}" / chan

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._dir(app_id, channel_id).mkdir(parents=True, exist_ok=True)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._pending.pop((app_id, channel_id), None)
            self._batch_ids.pop((app_id, channel_id), None)
            d = self._dir(app_id, channel_id)
            if not d.exists():
                return False
            shutil.rmtree(d)
            return True

    def close(self) -> None:
        self.flush()

    def _check_init(self, app_id: int, channel_id: Optional[int]) -> Path:
        d = self._dir(app_id, channel_id)
        if not d.is_dir():
            raise base.StorageError(
                f"Events store for app {app_id} channel {channel_id} not "
                "initialized.")
        return d

    @staticmethod
    def _write(path: Path, columns: Mapping[str, Sequence]) -> None:
        tmp = path.with_name(f".{path.name}.tmp")
        parquet.write_table(tmp, columns, SEGMENT_FIELDS)
        os.replace(tmp, path)

    def _write_part(self, d: Path, columns: Mapping[str, Sequence]) -> None:
        self._write(d / f"part-{uuid.uuid4().hex}.parquet", columns)

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        self._check_init(app_id, channel_id)
        eid = uuid.uuid4().hex          # store-assigned; any client id ignored
        with self._lock:
            pending = self._pending.setdefault((app_id, channel_id), [])
            pending.append(event.with_event_id(eid))
            if len(pending) >= self.FLUSH_THRESHOLD:
                self._flush(app_id, channel_id)
        return eid

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        d = self._check_init(app_id, channel_id)
        ids = [uuid.uuid4().hex for _ in events]
        cols = base.events_to_segment_columns(events, ids)
        with self._lock:
            self._write_part(d, cols)
        return ids

    def _seen_batch_ids(self, d: Path, app_id: int,
                        channel_id: Optional[int]) -> set:
        """Token-derived ids already stored (the caller holds the lock)."""
        key = (app_id, channel_id)
        seen = self._batch_ids.get(key)
        if seen is None:
            table = self._scan(d, app_id, channel_id, ["event_id"])
            seen = set()
            if table is not None:
                seen.update(eid for eid in table["event_id"]
                            if eid and eid.startswith("bt"))
            self._batch_ids[key] = seen
        return seen

    def create_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None,
                     tokens: Optional[Sequence[str]] = None) -> List[str]:
        """One part file for the rows not yet landed; a row whose derived
        id is on disk (an earlier partial landing) is skipped, so a
        replayed batch never duplicates."""
        d = self._check_init(app_id, channel_id)
        if tokens is None:
            pre = uuid.uuid4().hex     # one uuid4 a batch, not an event
            tokens = [f"{pre}{i:x}" for i in range(len(events))]
        else:
            tokens = list(tokens)
        if len(tokens) != len(events):
            raise base.StorageError(
                f"create_batch: {len(events)} events but {len(tokens)} "
                "tokens")
        ids = [base.batch_event_id(t) for t in tokens]
        with self._lock:
            seen = self._seen_batch_ids(d, app_id, channel_id)
            fresh = [(ev, eid) for ev, eid in zip(events, ids)
                     if eid not in seen]
            if fresh:
                self._write_part(d, base.events_to_segment_columns(
                    [ev for ev, _ in fresh], [eid for _, eid in fresh]))
                seen.update(eid for _, eid in fresh)
        return ids

    def insert_columnar(self, columns: Mapping[str, Sequence], app_id: int,
                        channel_id: Optional[int] = None) -> int:
        """Bulk columnar ingest: normalize, stamp ``blk<12 hex>-<row>``
        ids (one uuid a call), write ONE part file; no Event object is
        made."""
        d = self._check_init(app_id, channel_id)
        cols = base.normalize_event_columns(columns)
        n = len(cols["event"])
        prefix = f"blk{uuid.uuid4().hex[:12]}-"
        cols["event_id"] = [f"{prefix}{i}" for i in range(n)]
        cols["properties_json"] = cols.pop("properties")
        with self._lock:
            self._write_part(d, cols)
        return n

    def _flush(self, app_id: int, channel_id: Optional[int]) -> None:
        """Write buffered single inserts as one part file (the caller
        holds the lock; an RLock, so inserts and reads both may)."""
        pending = self._pending.pop((app_id, channel_id), None)
        if not pending:
            return
        self._write_part(self._dir(app_id, channel_id),
                         base.events_to_segment_columns(pending))

    def flush(self) -> None:
        with self._lock:
            for app_id, channel_id in list(self._pending):
                self._flush(app_id, channel_id)

    def _scan(self, d: Path, app_id: int, channel_id: Optional[int],
              columns: Optional[Sequence[str]] = None
              ) -> Optional[Dict[str, np.ndarray]]:
        """Every part's columns (by their names on disk; ``columns``
        projects), the parts in sorted name order; None without a part.
        The caller holds the lock; the write buffer is flushed first, so
        a read sees every insert."""
        self._flush(app_id, channel_id)
        parts = sorted(d.glob("part-*.parquet"))
        if not parts:
            return None
        names = list(columns) if columns is not None else \
            [name for name, _ in SEGMENT_FIELDS]
        tabs = [parquet.read_table(p, names) for p in parts]
        if len(tabs) == 1:
            return tabs[0]
        return {c: np.concatenate([t[c] for t in tabs]) for c in names}

    def _filtered(self, app_id, channel_id, start_time, until_time,
                  entity_type, entity_id, event_names, target_entity_type,
                  target_entity_id, ordered: bool = True,
                  columns: Optional[Sequence[str]] = None
                  ) -> Dict[str, np.ndarray]:
        """The filtered scan by the scan's column names (``columns``, or
        every one of :data:`EVENT_COLUMNS`)."""
        d = self._check_init(app_id, channel_id)
        names = tuple(columns) if columns is not None else EVENT_COLUMNS
        unknown = [c for c in names if c not in _ON_DISK]
        if unknown:
            raise base.StorageError(
                f"unknown event column(s) {unknown}; known: "
                f"{list(EVENT_COLUMNS)}")
        # a filter's column is read even when the caller projects it away
        need = {_ON_DISK[c] for c in names}
        for col, active in (
                ("event_time_us", start_time is not None
                 or until_time is not None or ordered),
                ("creation_time_us", ordered),
                ("entity_type", entity_type is not None),
                ("entity_id", entity_id is not None),
                ("event", event_names is not None),
                ("target_entity_type", target_entity_type is not None),
                ("target_entity_id", target_entity_id is not None)):
            if active:
                need.add(col)
        with self._lock:
            table = self._scan(d, app_id, channel_id,
                               [n for n, _ in SEGMENT_FIELDS if n in need])
        if table is None:
            return {c: _empty(c) for c in names}
        n = len(next(iter(table.values())))
        mask = np.ones(n, bool)
        if start_time is not None or until_time is not None:
            ts, valid = _times(table["event_time_us"])
            if valid is not None:
                mask &= valid
            if start_time is not None:
                mask &= ts >= epoch_us(start_time)
            if until_time is not None:
                mask &= ts < epoch_us(until_time)
        for col, want in (("entity_type", entity_type),
                          ("entity_id", entity_id),
                          ("target_entity_type", target_entity_type),
                          ("target_entity_id", target_entity_id)):
            if want is not None:
                mask &= _equal(table[col], want)
        if event_names is not None:
            wanted = frozenset(event_names)
            mask &= np.fromiter((e in wanted for e in table["event"]), bool,
                                count=n)
        if not mask.all():
            table = {c: v[mask] for c, v in table.items()}
        if ordered:
            # Arrow's stable sort_by: event time, then creation time, a
            # null after every value
            et, et_ok = _times(table["event_time_us"])
            ct, ct_ok = _times(table["creation_time_us"])
            keys = [ct]
            if ct_ok is not None:
                keys.append(~ct_ok)
            keys.append(et)
            if et_ok is not None:
                keys.append(~et_ok)
            order = np.lexsort(keys)
            table = {c: v[order] for c, v in table.items()}
        return {c: table[_ON_DISK[c]] for c in names}

    def latest_event_time(self, app_id: int,
                          channel_id: Optional[int] = None
                          ) -> Optional[_dt.datetime]:
        """The ingest high-watermark: the max of the projected
        ``event_time_us`` column."""
        d = self._check_init(app_id, channel_id)
        with self._lock:
            table = self._scan(d, app_id, channel_id, ["event_time_us"])
        if table is None:
            return None
        ts, valid = _times(table["event_time_us"])
        if valid is not None:
            ts = ts[valid]
        if len(ts) == 0:
            return None
        return from_epoch_us(int(ts.max()))

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        d = self._check_init(app_id, channel_id)
        with self._lock:
            self._flush(app_id, channel_id)
            for p in sorted(d.glob("part-*.parquet")):
                hit = np.flatnonzero(_equal(
                    parquet.read_table(p, ["event_id"])["event_id"],
                    event_id))
                if len(hit):
                    table = parquet.read_table(p)
                    return _events({c: v[hit[:1]]
                                    for c, v in table.items()})[0]
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        d = self._check_init(app_id, channel_id)
        with self._lock:
            self._flush(app_id, channel_id)
            for p in sorted(d.glob("part-*.parquet")):
                hit = _equal(parquet.read_table(p, ["event_id"])["event_id"],
                             event_id)
                if hit.any():
                    kept = ~hit
                    if kept.any():
                        table = parquet.read_table(p)
                        self._write(p, {c: v[kept] for c, v in table.items()})
                    else:
                        p.unlink()
                    # a deleted token-derived row may be created again
                    seen = self._batch_ids.get((app_id, channel_id))
                    if seen is not None:
                        seen.discard(event_id)
                    return True
        return False

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
        table = self._filtered(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id)
        events = _events({_ON_DISK[c]: v for c, v in table.items()})
        if reversed:
            events.reverse()
        if limit is not None and limit >= 0:
            events = events[:limit]
        return iter(events)

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
        """Columnar scan straight out of the part files, no Event
        objects: object arrays for strings (each bag as its JSON text),
        int64 for the microsecond times; ``ordered=False`` keeps the
        files' order (sorted part names, rows as written)."""
        return self._filtered(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
            ordered=ordered, columns=columns)


def _events(table: Mapping[str, np.ndarray]) -> List[Event]:
    """Rows of a scan (by the file's column names) as events, as the
    reference's ``arrow_to_events``: a null bag reads as ``{}``."""
    def time(v):
        return None if v is None else from_epoch_us(int(v))

    return [
        Event(event_id=eid, event=ev, entity_type=et, entity_id=ei,
              target_entity_type=tt, target_entity_id=ti,
              properties=DataMap(json.loads(pj or "{}")),
              event_time=time(t), pr_id=pr, creation_time=time(c))
        for eid, ev, et, ei, tt, ti, pj, t, pr, c in zip(
            table["event_id"], table["event"], table["entity_type"],
            table["entity_id"], table["target_entity_type"],
            table["target_entity_id"], table["properties_json"],
            table["event_time_us"].tolist(), table["pr_id"],
            table["creation_time_us"].tolist())]
