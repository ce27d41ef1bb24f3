"""Event model and entity indexing.

Port of ``Event``, ``DataMap``, ``PropertyMap`` and ``BiMap`` from
``predictionio_tpu/data/event.py`` (reference: Event.scala,
DataMap.scala, PropertyMap.scala, BiMap.scala).  Event validation and
property aggregation arrive with the event-server slice.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field, replace
from typing import (Any, Dict, Generic, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, TypeVar)

import numpy as np

__all__ = ["BiMap", "DataMap", "DataMapError", "Event", "PropertyMap"]


class DataMapError(KeyError):
    """Missing / mistyped property access (reference: DataMapException)."""


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


class DataMap(Mapping[str, Any]):
    """An immutable JSON property bag with typed getters.

    Reference: DataMap.scala — wraps a ``JObject`` and exposes
    ``get[T](name)`` / ``getOpt[T](name)``.  Here values are plain Python
    JSON values (None/bool/int/float/str/list/dict).
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: Dict[str, Any] = dict(fields or {})

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        try:
            return self._fields[key]
        except KeyError:
            raise DataMapError(f"The field {key} is required.") from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed getters (reference: DataMap.get[T] / getOpt[T]) ------------
    def _get_typed(self, name: str, types: tuple, conv=None) -> Any:
        v = self[name]
        if v is None:
            raise DataMapError(f"The field {name} is required.")
        if isinstance(v, bool) and bool not in types:
            raise DataMapError(f"The field {name} has type bool, expected {types}.")
        if not isinstance(v, types):
            raise DataMapError(f"The field {name} has type {type(v).__name__}, expected {types}.")
        return conv(v) if conv else v

    def get_string(self, name: str) -> str:
        return self._get_typed(name, (str,))

    def get_int(self, name: str) -> int:
        return self._get_typed(name, (int,))

    def get_double(self, name: str) -> float:
        return float(self._get_typed(name, (int, float)))

    def get_boolean(self, name: str) -> bool:
        return self._get_typed(name, (bool,))

    def get_string_list(self, name: str) -> List[str]:
        v = self._get_typed(name, (list,))
        if not all(isinstance(x, str) for x in v):
            raise DataMapError(f"The field {name} is not a list of strings.")
        return list(v)

    def get_double_list(self, name: str) -> List[float]:
        v = self._get_typed(name, (list,))
        out = []
        for x in v:
            if isinstance(x, bool) or not isinstance(x, (int, float)):
                raise DataMapError(f"The field {name} is not a list of numbers.")
            out.append(float(x))
        return out

    def opt_string(self, name: str) -> Optional[str]:
        return self.get_string(name) if self._has_non_null(name) else None

    def opt_int(self, name: str) -> Optional[int]:
        return self.get_int(name) if self._has_non_null(name) else None

    def opt_double(self, name: str) -> Optional[float]:
        return self.get_double(name) if self._has_non_null(name) else None

    def opt_boolean(self, name: str) -> Optional[bool]:
        return self.get_boolean(name) if self._has_non_null(name) else None

    def opt_string_list(self, name: str) -> Optional[List[str]]:
        return self.get_string_list(name) if self._has_non_null(name) else None

    def _has_non_null(self, name: str) -> bool:
        return self._fields.get(name) is not None

    # -- set algebra (reference: DataMap ++ / --) -------------------------
    def union(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """Right-biased merge (reference ``++``): other's keys win."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def subtract_keys(self, keys: Iterable[str]) -> "DataMap":
        """Remove keys (reference ``--``)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._fields)

    @property
    def fields(self) -> Dict[str, Any]:
        return dict(self._fields)

    def keyset(self) -> frozenset:
        return frozenset(self._fields)

    @property
    def is_empty(self) -> bool:
        return not self._fields


class PropertyMap(DataMap):
    """Aggregated entity state from ``$set``/``$unset``/``$delete`` events.

    Reference: PropertyMap.scala — a DataMap plus ``firstUpdated`` /
    ``lastUpdated`` timestamps.
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]] = None,
        first_updated: Optional[_dt.datetime] = None,
        last_updated: Optional[_dt.datetime] = None,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first_updated={self.first_updated},"
            f" last_updated={self.last_updated})"
        )


@dataclass(frozen=True)
class Event:
    """A single behavioral event (reference: Event.scala case class).

    JSON wire format (Appendix A of SURVEY.md)::

        {"event": ..., "entityType": ..., "entityId": ...,
         "targetEntityType"?: ..., "targetEntityId"?: ...,
         "properties"?: {...}, "eventTime"?: ISO-8601,
         "prId"?: ..., "creationTime"?: ISO-8601}
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=_utcnow)
    event_id: Optional[str] = None

    def with_event_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)


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
