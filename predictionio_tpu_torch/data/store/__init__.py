"""User-facing event read API used inside engines.

Port of ``EventStore`` and ``WindowedEventStore`` from
``predictionio_tpu/data/store/__init__.py`` (reference:
data/.../data/store/ — ``PEventStore`` for training reads, ``LEventStore``
for serving reads).  The training read, :meth:`EventStore.find_columnar`,
answers a dict of numpy columns instead of an Arrow table.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.data.storage.base import epoch_us

__all__ = ["EventStore", "WindowedEventStore"]


class EventStore:
    """Resolves app names to ids and exposes reads (reference:
    data/.../data/store/Common.scala appNameToId plus the
    PEventStore/LEventStore objects).  Only the default channel is
    ported."""

    def __init__(self, storage: Storage):
        self._storage = storage

    def _resolve(self, app_name: str, channel_name: Optional[str]) -> int:
        if channel_name is not None:
            raise StorageError("channels are not ported yet; read the "
                               "default channel (channel_name=None)")
        app = self._storage.get_apps().get_by_name(app_name)
        if app is None:
            raise StorageError(f"App {app_name!r} does not exist.")
        return app.id

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
        app_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().find_columnar(
            app_id, None, start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, ordered=ordered,
            columns=columns)

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
        app_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().find(
            app_id, None, start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed=reversed)


class WindowedEventStore(EventStore):
    """An :class:`EventStore` view scoped to one training data window.

    ``run_train`` stamps a watermark BEFORE the datasource reads and
    hands the datasource this view, so every read sees only
    ``event_time < watermark``: events landing mid-read belong to the
    next generation.  A read that passes no bound of its own inherits
    the window; an explicit bound outside the window is clamped to it.
    """

    def __init__(self, storage: Storage,
                 start_time: Optional[_dt.datetime],
                 until_time: Optional[_dt.datetime]):
        super().__init__(storage)
        self.window_start = start_time
        self.window_until = until_time

    def _clamped(self, kwargs: dict) -> dict:
        st = kwargs.get("start_time")
        if st is None:
            st = self.window_start
        elif self.window_start is not None \
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
