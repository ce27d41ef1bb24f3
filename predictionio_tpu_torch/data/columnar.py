"""Columnar decoding of event scans into training arrays (numpy).

Port of ``encode_ids``, ``numeric_property`` and ``event_mask`` from
``predictionio_tpu/data/columnar.py``.  The reference runs Arrow kernels
over an Arrow table; the port reads the dict of numpy columns that
:meth:`~predictionio_tpu_torch.data.store.EventStore.find_columnar`
answers, with the property bag as ``DataMap`` objects.  Semantics match
the reference's: first-appearance id order, and a numeric property read
from the bag's top-level key.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np

from predictionio_tpu_torch.data.event import BiMap

__all__ = ["encode_ids", "numeric_property", "event_mask"]

_Columns = Mapping[str, np.ndarray]


def encode_ids(col: Sequence) -> Tuple[np.ndarray, BiMap]:
    """Id strings → (dense int64 codes, BiMap), the BiMap built from the
    ids present in first-appearance order (``BiMap.string_int``
    semantics).  Raises ``ValueError`` on a null id."""
    seen: Dict[str, int] = {}
    codes = np.empty(len(col), dtype=np.int64)
    for i, key in enumerate(col):
        if key is None:
            raise ValueError("encode_ids: id column contains a null — "
                             "entity ids must be non-null (filter or fill "
                             "before encoding)")
        code = seen.get(key)
        if code is None:
            code = seen[key] = len(seen)
        codes[i] = code
    return codes, BiMap(seen)


def _number(props, key: str, default: float) -> float:
    """The reference's rule for one bag: the top-level ``key``; a bool,
    null, or anything ``float()`` refuses gives ``default``."""
    if props is None or key not in props:
        return default
    value = props[key]
    if value is None or isinstance(value, bool):
        return default
    try:
        return float(value)
    except (TypeError, ValueError, OverflowError):
        return default


def numeric_property(table_or_col: Union[_Columns, Sequence], key: str,
                     default: float = 0.0) -> np.ndarray:
    """A numeric property per event as float64, ``default`` where absent,
    null, boolean or not a number.  Takes the scan's columns (reads
    ``properties``) or the property column itself."""
    col = table_or_col["properties"] if isinstance(table_or_col, Mapping) \
        else table_or_col
    return np.fromiter((_number(p, key, default) for p in col), np.float64,
                       count=len(col))


def event_mask(table: _Columns, names: Sequence[str],
               column: str = "event") -> np.ndarray:
    """Boolean mask of rows whose event name is in ``names``."""
    wanted = frozenset(names)
    col = table[column]
    return np.fromiter((e in wanted for e in col), bool, count=len(col))
