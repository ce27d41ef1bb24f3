"""User-facing event read API used inside engines.

Port of ``EventStore`` and ``WindowedEventStore`` from
``predictionio_tpu/data/store/__init__.py`` (reference:
data/.../data/store/ — ``PEventStore`` for training reads, ``LEventStore``
for serving reads).  The training read, :meth:`EventStore.find_columnar`,
answers a dict of numpy columns instead of an Arrow table.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.event import Event, PropertyMap
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.data.storage.base import epoch_us

__all__ = ["EventStore", "WindowedEventStore"]


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
    """

    def __init__(self, storage: Storage,
                 start_time: Optional[_dt.datetime],
                 until_time: Optional[_dt.datetime]):
        super().__init__(storage)
        self.window_start = start_time
        self.window_until = until_time

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

    def find_columnar(self, app_name, channel_name=None, **kwargs):
        return super().find_columnar(app_name, channel_name,
                                     **self._clamped(kwargs))

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
