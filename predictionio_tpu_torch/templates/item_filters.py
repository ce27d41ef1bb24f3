"""Item filters the similar-product and e-commerce templates share.

Item categories come from ``$set`` aggregation, and a query's
``categories`` / ``whiteList`` / ``blackList`` become one exclude mask
over the item corpus, as both reference templates build them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

import numpy as np

from predictionio_tpu_torch.data.event import BiMap

__all__ = ["read_categories", "exclude_mask"]


def read_categories(ctx, app_name: str) -> Dict[str, Set[str]]:
    """Item categories of ``app_name`` from ``$set`` aggregation through
    ``ctx.event_store``: per-entity state, small beside the events."""
    cats: Dict[str, Set[str]] = {}
    for item, pm in ctx.event_store.aggregate_properties(
            app_name, "item").items():
        c = pm.get("categories")
        if c:
            cats[item] = set(c)
    return cats


def exclude_mask(n_items: int, item_index: BiMap,
                 item_categories: Dict[str, Set[str]],
                 categories: Optional[Sequence[str]],
                 white_list: Optional[Sequence[str]],
                 black_list: Optional[Sequence[str]]) -> np.ndarray:
    """The ``[1, n_items]`` mask of the query filters (True = never
    return): items sharing no category with ``categories``, items off a
    given ``white_list``, and the ``black_list`` (the reference builds
    it item by item; the rule is the same)."""
    exclude = np.zeros((1, n_items), dtype=bool)
    inv = item_index.inverse
    if categories is not None:
        want = set(categories)
        exclude[0] |= np.fromiter(
            (not (item_categories.get(inv[i], set()) & want)
             for i in range(n_items)), bool, count=n_items)
    if white_list is not None:
        allowed = np.ones(n_items, dtype=bool)
        allowed[[item_index[i] for i in white_list
                 if i in item_index]] = False
        exclude[0] |= allowed
    if black_list:
        exclude[0, [item_index[i] for i in black_list
                    if i in item_index]] = True
    return exclude
