"""Filesystem MODELDATA blob store.

Port of ``predictionio_tpu/data/storage/localfs_models.py`` (reference:
storage/localfs/ — ``LocalFSModels``).
"""

from __future__ import annotations

import urllib.parse
from pathlib import Path
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model

__all__ = ["LocalFSModels"]


class LocalFSModels(base.Models):
    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, model_id: str) -> Path:
        safe = urllib.parse.quote(model_id, safe="")  # collision-free encoding
        return self.root / f"pio_model_{safe}.bin"

    def insert(self, model: Model) -> None:
        tmp = self._path(model.id).with_suffix(".tmp")
        tmp.write_bytes(model.models)
        tmp.replace(self._path(model.id))

    def get(self, model_id: str) -> Optional[Model]:
        p = self._path(model_id)
        if not p.exists():
            return None
        return Model(id=model_id, models=p.read_bytes())

    def delete(self, model_id: str) -> bool:
        p = self._path(model_id)
        if not p.exists():
            return False
        p.unlink()
        return True
