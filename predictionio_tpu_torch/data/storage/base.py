"""Storage records and repository traits that deploy needs.

Port of the ``EngineInstance`` / ``Model`` records and the
``EngineInstances`` / ``Models`` traits of
``predictionio_tpu/data/storage/base.py`` (reference:
data/.../data/storage/ — EngineInstance.scala, Model.scala).  The event
traits and their Arrow schema arrive with the event-store slice.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "EngineInstance",
    "Model",
    "EngineInstances",
    "Models",
    "StorageError",
]


class StorageError(RuntimeError):
    pass


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
