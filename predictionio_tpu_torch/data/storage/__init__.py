"""Storage for training and deploy: apps, events, engine-instance rows
and model blobs.

Port of ``predictionio_tpu/data/storage`` with its in-memory backends.
A :class:`Storage` holds its apps, events and engine-instance rows in
memory and writes model blobs under ``<home>/storage/models`` (``home``
defaults to ``PIO_HOME``, else ``~/.predictionio_tpu``).  There is no
process-wide singleton: the caller creates one Storage and hands the
same object to whatever inserts events, to ``run_train`` and to the
server that loads the instance.  Nothing here needs ``pyarrow``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

from predictionio_tpu_torch.data.storage.base import (
    App,
    Apps,
    EngineInstance,
    EngineInstances,
    Events,
    Model,
    Models,
    StorageError,
)
from predictionio_tpu_torch.data.storage.localfs_models import LocalFSModels
from predictionio_tpu_torch.data.storage.memory import (
    MemoryApps,
    MemoryEngineInstances,
    MemoryEvents,
)

__all__ = [
    "Storage",
    "get_storage",
    "pio_home",
    "App",
    "Apps",
    "Events",
    "EngineInstance",
    "EngineInstances",
    "Model",
    "Models",
    "StorageError",
]


def pio_home() -> Path:
    home = os.environ.get("PIO_HOME")
    if home:
        return Path(home)
    return Path(os.environ.get("HOME", "/tmp")) / ".predictionio_tpu"


class Storage:
    """Typed repository getters (reference: ``Storage.getMetaData*`` /
    ``getLEvents`` / ``getModelDataModels``) over in-memory METADATA and
    EVENTDATA stores and a localfs MODELDATA store."""

    def __init__(self, home: Union[str, Path]):
        self.home = Path(home)
        self._apps = MemoryApps()
        self._events = MemoryEvents()
        self._instances = MemoryEngineInstances()
        self._models = LocalFSModels(str(self.home / "storage" / "models"))

    def get_apps(self) -> Apps:
        return self._apps

    def get_events(self) -> Events:
        return self._events

    def get_engine_instances(self) -> EngineInstances:
        return self._instances

    def get_models(self) -> Models:
        return self._models


def get_storage(home: Optional[Union[str, Path]] = None) -> Storage:
    """A new :class:`Storage` rooted at ``home`` (default: ``PIO_HOME``)."""
    return Storage(home if home is not None else pio_home())
