"""Columnar decoding of event scans into training arrays (numpy).

Port of ``encode_ids``, ``numeric_property`` and ``event_mask`` from
``predictionio_tpu/data/columnar.py``.  The reference runs Arrow kernels
over an Arrow table; the port reads the dict of numpy columns that
:meth:`~predictionio_tpu_torch.data.store.EventStore.find_columnar`
answers, with each property bag as a ``DataMap`` (the memory backend)
or as its JSON text (sqlite).  Semantics match the reference's:
first-appearance id order, and a numeric property read from the bag's
top-level key.
"""

from __future__ import annotations

import json
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
    ``properties``) or the property column itself.  Bags given as JSON
    text are parsed once per distinct string and the values fanned out
    by the inverse index (the reference's dictionary route: ML-style
    data has about ten distinct rating bags); mapping bags are read one
    by one.  The rule per bag is :func:`_number` either way."""
    col = table_or_col["properties"] if isinstance(table_or_col, Mapping) \
        else table_or_col
    if not isinstance(col, np.ndarray):
        # element by element: numpy would unpack equal-length bags
        arr = np.empty(len(col), dtype=object)
        for i, p in enumerate(col):
            arr[i] = p
        col = arr
    out = np.empty(len(col), np.float64)
    is_text = np.fromiter((isinstance(p, str) for p in col), bool,
                          count=len(col))
    text = np.flatnonzero(is_text)
    if len(text):
        uniq, inv = np.unique(col[text].astype(str), return_inverse=True)
        vals = np.fromiter((_number(json.loads(u), key, default)
                            for u in uniq), np.float64, count=len(uniq))
        out[text] = vals[inv]
    rest = np.flatnonzero(~is_text)
    out[rest] = np.fromiter((_number(col[i], key, default) for i in rest),
                            np.float64, count=len(rest))
    return out


def event_mask(table: _Columns, names: Sequence[str],
               column: str = "event") -> np.ndarray:
    """Boolean mask of rows whose event name is in ``names``."""
    wanted = frozenset(names)
    col = table[column]
    return np.fromiter((e in wanted for e in col), bool, count=len(col))
