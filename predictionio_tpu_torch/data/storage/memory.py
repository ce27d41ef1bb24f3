"""In-memory engine-instances store.

Port of ``MemoryEngineInstances`` from
``predictionio_tpu/data/storage/memory.py``.
"""

from __future__ import annotations

import copy
import threading
import uuid
from typing import Dict, List, Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import EngineInstance

__all__ = ["MemoryEngineInstances"]


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
