"""User-facing event read API used inside engines.

Port of ``EventStore`` and ``WindowedEventStore`` from
``predictionio_tpu/data/store/__init__.py`` (reference:
data/.../data/store/ — ``PEventStore`` for training reads, ``LEventStore``
for serving reads).  The training read, :meth:`EventStore.find_columnar`,
answers a dict of numpy columns instead of an Arrow table.  A windowed
read serves the prefix that sealed segments cover from them
(:class:`~predictionio_tpu_torch.data.columnar.SegmentStore`) and reads
only the rest from the primary store.
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.event import DataMap, Event, PropertyMap
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.data.storage.base import EVENT_COLUMNS, epoch_us

__all__ = ["EventStore", "PEventStore", "LEventStore",
           "WindowedEventStore"]


class EventStore:
    """Resolves app and channel names to ids and exposes reads
    (reference: data/.../data/store/Common.scala appNameToId plus the
    PEventStore/LEventStore objects)."""

    def __init__(self, storage: Storage):
        self._storage = storage

    def _resolve(self, app_name: str, channel_name: Optional[str]
                 ) -> Tuple[int, Optional[int]]:
        app = self._storage.get_apps().get_by_name(app_name)
        if app is None:
            raise StorageError(f"App {app_name!r} does not exist.")
        channel_id = None
        if channel_name is not None:
            chans = self._storage.get_channels().get_by_app_id(app.id)
            match = next((c for c in chans if c.name == channel_name), None)
            if match is None:
                raise StorageError(f"Channel {channel_name!r} does not exist "
                                   f"in app {app_name!r}.")
            channel_id = match.id
        return app.id, channel_id

    # -- P path (training) -----------------------------------------------
    def find_columnar(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
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
        """Columnar batch read (reference: PEventStore.find returning an
        RDD): a dict of numpy columns.  Training reads should pass
        ``ordered=False`` and project ``columns`` to what they consume."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().find_columnar(
            app_id, channel_id, start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, ordered=ordered,
            columns=columns)

    def insert_columnar(
        self,
        columns,
        app_name: str,
        channel_name: Optional[str] = None,
    ) -> int:
        """Bulk columnar event ingest (reference analogue: HBase bulk
        import): one sequence per event column, as
        :meth:`~predictionio_tpu_torch.data.storage.base.Events.
        insert_columnar` takes them; returns the number of events
        ingested."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().insert_columnar(
            columns, app_id, channel_id)

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        *,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Per-entity ``$set`` state (reference:
        PEventStore.aggregateProperties)."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().aggregate_properties(
            app_id, channel_id, entity_type=entity_type,
            start_time=start_time, until_time=until_time,
            required=required)

    # -- L path (serving) --------------------------------------------------
    def find(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
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
        """Iterator read (reference: LEventStore.find)."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().find(
            app_id, channel_id, start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed=reversed)

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        *,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> List[Event]:
        """Recent events of one entity, newest first unless ``latest`` is
        False (reference: LEventStore.findByEntity); serve-time fold-in
        reads a visitor's events through it.  The entity filter reaches
        the backend's own ``find``: on sqlite the entity index serves
        it."""
        return list(self.find(
            app_name, channel_name, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type, limit=limit,
            reversed=latest))


    def latest_event_time(
        self, app_name: str, channel_name: Optional[str] = None
    ) -> Optional[_dt.datetime]:
        """Ingest high-watermark by app NAME: the freshness anchor the
        refresh daemon compares against the serving generation's data
        watermark."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().latest_event_time(
            app_id, channel_id)


class WindowedEventStore(EventStore):
    """An :class:`EventStore` view scoped to one training data window.

    ``run_train`` stamps a watermark BEFORE the datasource reads and
    hands the datasource this view, so every read sees only
    ``event_time < watermark``: events landing mid-read belong to the
    next generation.  A read that passes no bound of its own inherits
    the window; an explicit bound outside the window is clamped to it.
    Property aggregation takes only the until bound.

    A columnar read with a start bound (a warm refresh's delta) serves
    the prefix the sealed segments cover from them and reads only the
    uncovered tail from the primary store, so its cost follows the
    window, not the store.
    """

    _SEGMENTS_UNSET = object()

    def __init__(self, storage: Storage,
                 start_time: Optional[_dt.datetime],
                 until_time: Optional[_dt.datetime]):
        super().__init__(storage)
        self.window_start = start_time
        self.window_until = until_time
        # the segment store, resolved on the first windowed read
        self._segments = self._SEGMENTS_UNSET

    def _clamped(self, kwargs: dict, *, inject_start: bool = True) -> dict:
        st = kwargs.get("start_time")
        if st is None:
            st = self.window_start if inject_start else None
        elif self.window_start is not None and inject_start \
                and epoch_us(st) < epoch_us(self.window_start):
            st = self.window_start
        ut = kwargs.get("until_time")
        if ut is None:
            ut = self.window_until
        elif self.window_until is not None \
                and epoch_us(ut) > epoch_us(self.window_until):
            ut = self.window_until
        return {**kwargs, "start_time": st, "until_time": ut}

    def _segment_slice(self, app_name, channel_name, kw):
        """The covered prefix from sealed segments: ``(columns,
        covered_until_us)``, or None when the segments cannot prove
        coverage from the window start (then the whole read falls back
        to the primary store: the reader never guesses)."""
        from predictionio_tpu_torch.data.columnar import SegmentStore

        if kw.get("start_time") is None:
            return None  # a full-history read, not a delta
        if self._segments is self._SEGMENTS_UNSET:
            try:
                self._segments = SegmentStore.open_default()
            except Exception:
                self._segments = None
        if self._segments is None:
            return None
        try:
            app_id, channel_id = self._resolve(app_name, channel_name)
            start_us = epoch_us(kw["start_time"])
            until_us = (epoch_us(kw["until_time"])
                        if kw.get("until_time") is not None else 1 << 62)
            return self._segments.read_window(
                app_id, channel_id, start_us, until_us,
                entity_type=kw.get("entity_type"),
                entity_id=kw.get("entity_id"),
                event_names=kw.get("event_names"),
                target_entity_type=kw.get("target_entity_type"),
                target_entity_id=kw.get("target_entity_id"))
        except Exception:
            # any surprise (a damaged manifest, a resolve failure)
            # degrades to the primary-store read, never to a broken scan
            return None

    def find_columnar(self, app_name, channel_name=None, **kwargs):
        kw = self._clamped(kwargs)
        sliced = self._segment_slice(app_name, channel_name, kw)
        if sliced is None:
            return super().find_columnar(app_name, channel_name, **kw)
        seg, covered_us = sliced
        # the tail [covered, until): the uncovered recent sliver
        tail_kw = dict(kw)
        tail_kw["start_time"] = _dt.datetime.fromtimestamp(
            covered_us // 10**6, _dt.timezone.utc
        ) + _dt.timedelta(microseconds=covered_us % 10**6)
        tail = super().find_columnar(app_name, channel_name, **tail_kw)
        # By event time, stably (Arrow's sort_by in the reference), even
        # for ordered=False: the primary store's unordered delta read
        # walks its time index, so the slice then answers in its order.
        order = np.argsort(np.asarray(seg["event_time_us"], dtype=np.int64),
                           kind="stable")
        seg = {c: v[order] for c, v in seg.items()}
        names = tuple(kw.get("columns") or EVENT_COLUMNS)
        seg = self._unified(seg, names)
        if seg is None:
            # a slice with a null time or bag cannot take the backend's
            # form: correctness wins, one full primary read
            return super().find_columnar(app_name, channel_name, **kw)
        return {c: np.concatenate([seg[c], tail[c]]) for c in names}

    def _unified(self, seg, names):
        """``seg``'s columns ``names`` in the form the backend declares
        for its own read (``Events.columnar_properties``): int64 times,
        each bag as its JSON text or as a DataMap.  None when a time or
        a bag is null."""
        out = {}
        for c in names:
            col = seg[c]
            if c in ("event_time_us", "creation_time_us"):
                if col.dtype == object:
                    return None
            elif c == "properties":
                if any(p is None for p in col):
                    return None
                if self._storage.get_events().columnar_properties == "map":
                    maps = np.empty(len(col), dtype=object)
                    for i, text in enumerate(col):
                        maps[i] = DataMap(json.loads(text))
                    col = maps
            out[c] = col
        return out

    def find(self, app_name, channel_name=None, **kwargs):
        return super().find(app_name, channel_name, **self._clamped(kwargs))

    def aggregate_properties(self, app_name, entity_type, channel_name=None,
                             **kwargs):
        # $set/$unset/$delete state is cumulative from t = 0: a windowed
        # aggregation would drop every property written before the
        # window.  Only the until bound applies; the window start is
        # never injected.
        return super().aggregate_properties(
            app_name, entity_type, channel_name,
            **self._clamped(kwargs, inject_start=False))


# The reference's vocabulary: both stores are views of the one class.
PEventStore = EventStore
LEventStore = EventStore
