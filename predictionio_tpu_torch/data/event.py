"""Entity indexing — port of ``BiMap`` from ``predictionio_tpu/data/event.py``.

The event model (``Event``, ``DataMap``, property aggregation) arrives
with the event-store slice; serving needs only the id ↔ row index maps.
"""

from __future__ import annotations

from typing import Any, Dict, Generic, Iterable, Iterator, Mapping, TypeVar

import numpy as np

__all__ = ["BiMap"]

K = TypeVar("K")


class BiMap(Generic[K]):
    """Immutable bidirectional map, typically key → contiguous int index.

    Reference: BiMap.scala — used to index entity-id strings into dense int
    ids for ML (``BiMap.stringInt``).  Inverse lookups via ``inverse``.
    """

    __slots__ = ("_fwd", "_rev")

    def __init__(self, mapping: Mapping[K, Any]):
        self._fwd: Dict[K, Any] = dict(mapping)
        self._rev: Dict[Any, K] = {v: k for k, v in self._fwd.items()}
        if len(self._rev) != len(self._fwd):
            raise ValueError("BiMap values must be unique.")

    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str]":
        """Assign contiguous ints (0..n-1) to unique keys in first-seen order.

        Reference: BiMap.stringInt / stringLong.
        """
        seen: Dict[str, int] = {}
        for k in keys:
            if k not in seen:
                seen[k] = len(seen)
        return BiMap(seen)

    def __getitem__(self, key: K) -> Any:
        return self._fwd[key]

    def get(self, key: K, default: Any = None) -> Any:
        return self._fwd.get(key, default)

    def __contains__(self, key: K) -> bool:
        return key in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def items(self):
        return self._fwd.items()

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    @property
    def inverse(self) -> "BiMap":
        inv = BiMap.__new__(BiMap)
        inv._fwd = self._rev
        inv._rev = self._fwd
        return inv

    def to_numpy_keys(self) -> np.ndarray:
        """Keys ordered by their int value — decode table for device ids."""
        items = sorted(self._fwd.items(), key=lambda kv: kv[1])
        return np.array([k for k, _ in items])
