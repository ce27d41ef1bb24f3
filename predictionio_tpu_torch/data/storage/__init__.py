"""Storage registry: ``PIO_STORAGE_*``-configured backends.

Port of ``predictionio_tpu/data/storage/__init__.py`` (reference:
data/.../data/storage/Storage.scala): it reads the config
(:func:`~predictionio_tpu_torch.config.load_config`), builds one backend
client a (source, namespace) and hands out typed repositories for the
three logical stores (METADATA / EVENTDATA / MODELDATA).  Registered
source types: ``sqlite``, ``localfs``, ``memory``, ``parquetlog``
(events only, in the reference's Parquet part files,
:mod:`predictionio_tpu_torch.data.storage.parquet_events`) and
``pioserver`` (every repository forwarded to a ``pio storageserver``
process, :mod:`predictionio_tpu_torch.data.storage.remote`).  A source
without a kind of repository raises :class:`StorageError` for it (the
spill queue and the KV on ``parquetlog``: their callers degrade).
The events, spill-queue and KV getters pass through the ``PIO_FAULTS``
seam (:mod:`predictionio_tpu_torch.resilience.faults`), a no-op unless a
plan is active.

Two processes on the default config share one sqlite file and one model
directory under ``PIO_HOME``: a ``pio train`` writes what a ``pio
deploy`` in another process loads.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from predictionio_tpu_torch.config import (
    PioConfig,
    StorageSourceConfig,
    load_config,
    pio_home,
)
from predictionio_tpu_torch.data.storage.base import (  # re-export
    AccessKey,
    AccessKeys,
    App,
    Apps,
    Channel,
    Channels,
    EngineInstance,
    EngineInstances,
    EvaluationInstance,
    EvaluationInstances,
    Events,
    KV,
    Model,
    Models,
    SpillQueues,
    StorageError,
    StorageUnavailable,
)
from predictionio_tpu_torch.resilience.faults import (
    wrap_events as _wrap_events,
    wrap_instances as _wrap_instances,
    wrap_kv as _wrap_kv,
    wrap_models as _wrap_models,
    wrap_spill_queues as _wrap_spill_queues,
)

__all__ = [
    "Storage",
    "get_storage",
    "reset_storage",
    "register_backend",
    "pio_home",
    "App", "Apps", "AccessKey", "AccessKeys", "Channel", "Channels",
    "EngineInstance", "EngineInstances", "EvaluationInstance",
    "EvaluationInstances", "Model", "Models", "Events", "KV",
    "SpillQueues", "StorageError", "StorageUnavailable",
]


class _Backend:
    """A constructed storage client for one source; repo accessors per kind."""

    def __init__(self, source: StorageSourceConfig, namespace: str):
        self.source = source
        self.namespace = namespace

    def events(self) -> Events:
        raise StorageError(
            f"Source type {self.source.type} has no events support.")

    def apps(self) -> Apps:
        raise StorageError(
            f"Source type {self.source.type} has no metadata support.")

    def access_keys(self) -> AccessKeys:
        raise StorageError(
            f"Source type {self.source.type} has no metadata support.")

    def channels(self) -> Channels:
        raise StorageError(
            f"Source type {self.source.type} has no metadata support.")

    def engine_instances(self) -> EngineInstances:
        raise StorageError(
            f"Source type {self.source.type} has no metadata support.")

    def evaluation_instances(self) -> EvaluationInstances:
        raise StorageError(
            f"Source type {self.source.type} has no metadata support.")

    def models(self) -> Models:
        raise StorageError(
            f"Source type {self.source.type} has no models support.")

    def spill_queues(self) -> SpillQueues:
        raise StorageError(
            f"Source type {self.source.type} has no spill-queue support.")

    def kv(self) -> KV:
        raise StorageError(
            f"Source type {self.source.type} has no shared-KV support.")

    def close(self) -> None:
        pass


class _SQLiteBackend(_Backend):
    def __init__(self, source, namespace):
        super().__init__(source, namespace)
        from predictionio_tpu_torch.data.storage.sqlite import SQLiteClient

        path = source.path
        if not path:
            raise StorageError(
                f"sqlite source {source.name} needs a PATH property.")
        self._client = SQLiteClient(path, namespace=namespace)

    def events(self): return self._client.events()
    def apps(self): return self._client.apps()
    def access_keys(self): return self._client.access_keys()
    def channels(self): return self._client.channels()
    def engine_instances(self): return self._client.engine_instances()
    def evaluation_instances(self): return self._client.evaluation_instances()
    def models(self): return self._client.models()
    def spill_queues(self): return self._client.spill_queues()
    def kv(self): return self._client.kv()
    def close(self): self._client.close()


class _ParquetBackend(_Backend):
    def __init__(self, source, namespace):
        super().__init__(source, namespace)
        from predictionio_tpu_torch.data.storage.parquet_events import (
            ParquetEvents)

        path = source.path
        if not path:
            raise StorageError(
                f"parquetlog source {source.name} needs a PATH property.")
        self._events = ParquetEvents(path)

    def events(self): return self._events


class _LocalFSBackend(_Backend):
    def __init__(self, source, namespace):
        super().__init__(source, namespace)
        from predictionio_tpu_torch.data.storage.localfs_models import (
            LocalFSModels)

        path = source.path
        if not path:
            raise StorageError(
                f"localfs source {source.name} needs a PATH property.")
        self._models = LocalFSModels(path)

    def models(self): return self._models


class _MemoryBackend(_Backend):
    def __init__(self, source, namespace):
        super().__init__(source, namespace)
        from predictionio_tpu_torch.data.storage import memory as m

        self._events = m.MemoryEvents()
        self._apps = m.MemoryApps()
        self._keys = m.MemoryAccessKeys()
        self._channels = m.MemoryChannels()
        self._engine_instances = m.MemoryEngineInstances()
        self._evaluation_instances = m.MemoryEvaluationInstances()
        self._models = m.MemoryModels()
        self._spill_queues = m.MemorySpillQueues()
        self._kv = m.MemoryKV()

    def events(self): return self._events
    def apps(self): return self._apps
    def access_keys(self): return self._keys
    def channels(self): return self._channels
    def engine_instances(self): return self._engine_instances
    def evaluation_instances(self): return self._evaluation_instances
    def models(self): return self._models
    def spill_queues(self): return self._spill_queues
    def kv(self): return self._kv


class _PioServerBackend(_Backend):
    """Out-of-process backend: every repository call forwarded over TCP to
    a ``pio storageserver`` process (data/storage/remote.py) — the
    reference's JDBC/HBase/ES network-storage property, selected purely
    by PIO_STORAGE_* config (HOSTS/PORTS properties)."""

    def __init__(self, source, namespace):
        super().__init__(source, namespace)
        from predictionio_tpu_torch.data.storage.remote import RemoteClient

        host = source.properties.get("HOSTS", "127.0.0.1").split(",")[0]
        port = source.properties.get("PORTS")
        if not port:
            raise StorageError(
                f"pioserver source {source.name} needs a PORTS property.")
        self._client = RemoteClient(
            host, int(port.split(",")[0]),
            secret=source.properties.get("SECRET"),
            pool_size=int(source.properties.get("CONNECTIONS", "2")),
            retries=int(source.properties.get("RETRIES", "2")))

    def events(self): return self._client.events()
    def apps(self): return self._client.apps()
    def access_keys(self): return self._client.access_keys()
    def channels(self): return self._client.channels()
    def engine_instances(self): return self._client.engine_instances()
    def evaluation_instances(self): return self._client.evaluation_instances()
    def models(self): return self._client.models()
    def spill_queues(self): return self._client.spill_queues()
    def kv(self): return self._client.kv()
    def close(self): self._client.close()


_BACKEND_TYPES: Dict[str, Callable[[StorageSourceConfig, str], _Backend]] = {
    "sqlite": _SQLiteBackend,
    "parquetlog": _ParquetBackend,
    "localfs": _LocalFSBackend,
    "memory": _MemoryBackend,
    "pioserver": _PioServerBackend,
}


def register_backend(type_name: str,
                     factory: Callable[[StorageSourceConfig, str], _Backend]
                     ) -> None:
    """Plugin point for new storage types (reference: reflective client
    load)."""
    _BACKEND_TYPES[type_name] = factory


class Storage:
    """Typed repository getters over the configured backends
    (reference: ``Storage.getLEvents`` / ``getMetaDataApps`` /
    ``getModelDataModels`` ...)."""

    def __init__(self, config: Optional[PioConfig] = None):
        self.config = config or load_config()
        self._backends: Dict[str, _Backend] = {}
        self._lock = threading.Lock()

    def _backend_for(self, repo: str) -> _Backend:
        rc = self.config.repositories[repo.upper()]
        cache_key = f"{rc.source}:{rc.namespace}"
        with self._lock:
            if cache_key not in self._backends:
                source = self.config.source_for(repo)
                try:
                    factory = _BACKEND_TYPES[source.type]
                except KeyError:
                    raise StorageError(
                        f"Unknown storage source type {source.type!r} "
                        f"(registered: {sorted(_BACKEND_TYPES)})"
                    ) from None
                self._backends[cache_key] = factory(source, rc.namespace)
            return self._backends[cache_key]

    # EVENTDATA
    def get_events(self) -> Events:
        # Fault-injection seam: a passthrough unless a PIO_FAULTS plan is
        # active; wrapped per call so a plan installed mid-process takes
        # effect at once.
        return _wrap_events(self._backend_for("EVENTDATA").events())

    # METADATA
    def get_apps(self) -> Apps:
        return self._backend_for("METADATA").apps()

    def get_access_keys(self) -> AccessKeys:
        return self._backend_for("METADATA").access_keys()

    def get_channels(self) -> Channels:
        return self._backend_for("METADATA").channels()

    def get_engine_instances(self) -> EngineInstances:
        # Fault seam like get_events: PIO_FAULTS storage.* rules can
        # break the engine server's reload reads (fail-closed serving).
        return _wrap_instances(
            self._backend_for("METADATA").engine_instances())

    def get_evaluation_instances(self) -> EvaluationInstances:
        return self._backend_for("METADATA").evaluation_instances()

    # MODELDATA
    def get_models(self) -> Models:
        return _wrap_models(self._backend_for("MODELDATA").models())

    # The spill queue and the shared KV ride the EVENTDATA source, as in
    # the reference: the queue holds event payloads and the fold-in cache
    # derives from events.
    def get_spill_queues(self) -> SpillQueues:
        return _wrap_spill_queues(
            self._backend_for("EVENTDATA").spill_queues())

    def get_kv(self) -> KV:
        return _wrap_kv(self._backend_for("EVENTDATA").kv())

    def close(self) -> None:
        with self._lock:
            for b in self._backends.values():
                b.close()
            self._backends.clear()

    def verify(self) -> Dict[str, str]:
        """Touch all three stores; returns repo → source type (``pio
        status``)."""
        out = {}
        for repo, getter in (
            ("METADATA", self.get_apps),
            ("EVENTDATA", self.get_events),
            ("MODELDATA", self.get_models),
        ):
            getter()
            out[repo] = self.config.source_for(repo).type
        return out


_global: Optional[Storage] = None
_global_lock = threading.Lock()


def get_storage(config: Optional[PioConfig] = None) -> Storage:
    """Process-wide storage singleton (reference: the Storage object);
    a ``config`` replaces it."""
    global _global
    with _global_lock:
        if _global is None or config is not None:
            if _global is not None:
                _global.close()
            _global = Storage(config)
        return _global


def reset_storage() -> None:
    global _global
    with _global_lock:
        if _global is not None:
            _global.close()
        _global = None
