"""Similar-product template — "people who viewed X also viewed".

Port of ``predictionio_tpu/templates/similarproduct/engine.py``
(reference: scala-parallel-similarproduct).  The contract is the
reference's:

- events: ``view`` (user→item); ``$set`` on "item" entities carries
  ``categories`` (a list of strings)
- query JSON: ``{"items": ["i1"], "num": 4, "categories"?: [...],
  "whiteList"?: [...], "blackList"?: [...]}``
- result JSON: ``{"itemScores": [{"item": ..., "score": ...}]}``

Training runs the port's implicit ALS sweep on ``ctx.device`` (kernels
K1 and K2 on the card) and keeps L2-normalised item factors, so a score
is the cosine of the candidate with the summed query items, plus the raw
user factors for fold-in.  Every request carries an exclude mask (the
query items at least), so serving takes the exact rungs of the port's
retrieval facade: the host scan, or on the card the masked ``chunked``
scan or one matmul and top-k.  A query item this generation never
trained on is folded in at serve time from the users who recently viewed
it (one host ridge solve against the frozen user factors).  A model
trained elsewhere is carried in with :func:`model_from_numpy`.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    RuntimeContext,
)
from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.data.event import BiMap
from predictionio_tpu_torch.models import als as als_lib
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.retrieval import (
    Retriever,
    _env_int,
    cached_retriever,
    iter_hits,
)
from predictionio_tpu_torch.templates.item_filters import (
    exclude_mask,
    read_categories,
)

__all__ = [
    "Query", "ItemScore", "PredictedResult", "ViewData", "DataSourceParams",
    "SimilarProductDataSource", "ALSAlgorithmParams", "ALSAlgorithm",
    "SimilarProductModel", "model_from_numpy", "engine",
]


@dataclasses.dataclass
class Query:
    items: List[str]
    num: int = 10
    categories: Optional[List[str]] = None
    whiteList: Optional[List[str]] = None  # noqa: N815 — reference JSON keys
    blackList: Optional[List[str]] = None  # noqa: N815


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: List[ItemScore]  # noqa: N815


@dataclasses.dataclass
class ViewData:
    user_ids: np.ndarray
    item_ids: np.ndarray
    user_index: BiMap
    item_index: BiMap
    item_categories: Dict[str, Set[str]]
    # Where the view events live, for the trained model's item fold-in.
    app_name: Optional[str] = None
    event_names: Sequence[str] = ("view",)


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815
    eventNames: Sequence[str] = ("view",)  # noqa: N815


class SimilarProductDataSource(DataSource):
    """Reference: DataSource.scala — view events + item $set categories."""

    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> ViewData:
        from predictionio_tpu_torch.data.columnar import encode_ids

        p: DataSourceParams = self.params
        table = ctx.event_store.find_columnar(
            p.appName, entity_type="user", target_entity_type="item",
            event_names=list(p.eventNames),
            ordered=False, columns=["entity_id", "target_entity_id"])
        user_ids, user_index = encode_ids(table["entity_id"])
        item_ids, item_index = encode_ids(table["target_entity_id"])
        return ViewData(
            user_ids=user_ids,
            item_ids=item_ids,
            user_index=user_index,
            item_index=item_index,
            item_categories=read_categories(ctx, p.appName),
            app_name=p.appName,
            event_names=tuple(p.eventNames),
        )


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 10  # noqa: N815
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None


def _item_fold_in_enabled() -> bool:
    # The user-side fold-in's kill switch: one knob turns every
    # serve-time solve off.
    return env_bool(os.environ.get("PIO_FOLD_IN"), True)


def _item_fold_metric():
    return get_registry().counter(
        "pio_fold_in_items_total",
        "Serve-time item-side fold-in attempts by outcome "
        "(cached/solved/no_events/unavailable).", ("result",))


# A brand-new item's first views should fold in within seconds, so a
# negative entry lives only this long.
_ITEM_FOLD_NEG_TTL_S = 30.0


# eq=False: model identity is the generation (the weak-keyed retriever
# cache needs a hashable owner).
@dataclasses.dataclass(eq=False)
class SimilarProductModel:
    """Normalised item factors + categories, and the fold-in context.

    An item unknown to this generation gets one implicit ridge solve
    against the frozen RAW user factors from the users who recently
    viewed it, kept in a bounded per-generation LRU
    (``PIO_FOLD_IN_CACHE``; negative entries 30 s) under the
    ``PIO_FOLD_IN`` kill switch.  ``user_factors`` None disables it.
    """

    item_factors: np.ndarray       # [I, K] L2-normalised
    item_index: BiMap
    item_categories: Dict[str, Set[str]]
    user_factors: Optional[np.ndarray] = None   # [U, K] raw
    user_index: Optional[BiMap] = None
    app_name: Optional[str] = None
    fold_event_names: Sequence[str] = ("view",)
    reg: float = 0.01
    alpha: float = 1.0

    def __post_init__(self):
        self._init_transients()

    def _init_transients(self) -> None:
        # Per-generation serving state, never pickled.
        self._device = None
        self._fold_cache: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._fold_lock = threading.Lock()
        self._event_store = None
        self._uty: Optional[np.ndarray] = None   # UᵀU for implicit solves

    def __getstate__(self):
        d = self.__dict__.copy()
        for k in ("_device", "_fold_cache", "_fold_lock", "_event_store",
                  "_uty"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._init_transients()

    def post_load(self, ctx: RuntimeContext) -> None:
        """Serving-time hook: the device the server runs on and the event
        store fold-in reads."""
        self._device = ctx.device
        store = getattr(ctx, "event_store", None)
        if store is not None:
            self._event_store = store

    def retriever(self) -> Retriever:
        """THE serving route to the item corpus, on the serving device."""
        return cached_retriever(self, lambda: Retriever(
            self.item_factors, n_items=len(self.item_index),
            name="similarproduct", device=self._device))

    def fold_in_item(self, item: str) -> Optional[np.ndarray]:
        """The L2-normalised folded factor of an UNKNOWN item, solved from
        the known users who recently viewed it; None when fold-in is off,
        no event store or user factors are attached, or the item has no
        usable views.  Outcomes count in
        ``pio_fold_in_items_total{result}``."""
        es = self._event_store
        if es is None or self.user_factors is None \
                or self.user_index is None or not self.app_name \
                or not _item_fold_in_enabled():
            return None
        with self._fold_lock:
            hit = self._fold_cache.get(item)
            if hit is not None:
                vec, t = hit
                if vec is not None or \
                        time.monotonic() - t < _ITEM_FOLD_NEG_TTL_S:
                    self._fold_cache.move_to_end(item)
                    _item_fold_metric().inc(result="cached")
                    return vec
                del self._fold_cache[item]
        try:
            events = list(es.find(
                self.app_name, entity_type="user",
                target_entity_type="item", target_entity_id=item,
                event_names=list(self.fold_event_names) or None,
                limit=_env_int("PIO_FOLD_IN_EVENTS", 50), reversed=True))
        except Exception:
            logging.getLogger(__name__).debug(
                "item fold-in event read failed", exc_info=True)
            _item_fold_metric().inc(result="unavailable")
            return None
        uidx = self.user_index
        ids = [int(uidx[ev.entity_id]) for ev in events
               if ev.entity_id in uidx]
        if not ids:
            self._fold_store(item, None)
            _item_fold_metric().inc(result="no_events")
            return None
        if self._uty is None:
            f = np.asarray(self.user_factors, np.float64)
            self._uty = f.T @ f
        # The user-side normal equation with the roles swapped: implicit
        # views (r = 1) against the frozen user factors.
        vec = als_lib.fold_in(
            self.user_factors, np.asarray(ids),
            np.ones(len(ids), np.float32), reg=float(self.reg),
            alpha=float(self.alpha), implicit=True, yty=self._uty)
        norm = float(np.linalg.norm(vec))
        vec = vec / (norm if norm > 1e-9 else 1.0)  # the corpus is normalised
        self._fold_store(item, vec)
        _item_fold_metric().inc(result="solved")
        return vec

    def _fold_store(self, item: str, vec: Optional[np.ndarray]) -> None:
        with self._fold_lock:
            self._fold_cache[item] = (vec, time.monotonic())
            self._fold_cache.move_to_end(item)
            cap = _env_int("PIO_FOLD_IN_CACHE", 10000)
            while len(self._fold_cache) > max(cap, 1):
                self._fold_cache.popitem(last=False)


def model_from_numpy(item_factors, item_ids, *, item_categories=None,
                     user_factors=None, user_ids=None,
                     app_name: Optional[str] = None,
                     fold_event_names: Sequence[str] = ("view",),
                     reg: float = 0.01, alpha: float = 1.0
                     ) -> SimilarProductModel:
    """Carry a trained similar-product generation into the port: the
    NORMALISED item factors and the item id strings of their rows, in
    row order, their categories, and for fold-in the raw user factors
    with their ids."""
    itf = np.require(item_factors, np.float32, ("C", "W"))
    item_index = BiMap({str(t): i for i, t in enumerate(item_ids)})
    if len(item_index) != itf.shape[0]:
        raise ValueError("one item id per factor row")
    user_index = None
    if user_factors is not None:
        user_factors = np.require(user_factors, np.float32, ("C", "W"))
        user_index = BiMap({str(u): i for i, u in enumerate(user_ids)})
        if len(user_index) != user_factors.shape[0]:
            raise ValueError("one user id per factor row")
    return SimilarProductModel(
        item_factors=itf, item_index=item_index,
        item_categories={k: set(v) for k, v in
                         (item_categories or {}).items()},
        user_factors=user_factors, user_index=user_index,
        app_name=app_name, fold_event_names=tuple(fold_event_names),
        reg=float(reg), alpha=float(alpha))


class ALSAlgorithm(Algorithm):
    """Implicit ALS; keeps normalised item factors (the reference's
    similarproduct ALSModel keeps productFeatures only) and the raw user
    factors for fold-in."""

    params_class = ALSAlgorithmParams

    def train(self, ctx: RuntimeContext,
              prepared_data: ViewData) -> SimilarProductModel:
        p: ALSAlgorithmParams = self.params
        if len(prepared_data.user_ids) == 0:
            raise ValueError("No view events found — check appName/eventNames.")
        cfg = als_lib.ALSConfig(
            rank=p.rank, iterations=p.numIterations, reg=p.lambda_,
            alpha=p.alpha, implicit=True,
            seed=p.seed if p.seed is not None else ctx.seed)
        model = als_lib.train_als(
            prepared_data.user_ids, prepared_data.item_ids, None,
            n_users=len(prepared_data.user_index),
            n_items=len(prepared_data.item_index),
            config=cfg, device=ctx.device)
        f = model.item_factors
        norms = np.linalg.norm(f, axis=1, keepdims=True)
        f = f / np.where(norms < 1e-9, 1.0, norms)
        out = SimilarProductModel(
            item_factors=f,
            item_index=prepared_data.item_index,
            item_categories=prepared_data.item_categories,
            user_factors=model.user_factors[: len(prepared_data.user_index)],
            user_index=prepared_data.user_index,
            app_name=prepared_data.app_name,
            fold_event_names=tuple(prepared_data.event_names or ("view",)),
            reg=float(p.lambda_),
            alpha=float(p.alpha),
        )
        # A generation predicts where it trained until a server's
        # post_load moves it.
        out._device = ctx.device
        return out

    def predict(self, model: SimilarProductModel,
                query: Query) -> PredictedResult:
        known = [model.item_index[i] for i in query.items
                 if i in model.item_index]
        # An unknown query item is folded in and counts like a trained one.
        folded: List[np.ndarray] = []
        for i in query.items:
            if i not in model.item_index:
                vec = model.fold_in_item(i)
                if vec is not None:
                    folded.append(vec)
        if not known and not folded:
            return PredictedResult(itemScores=[])
        f = model.item_factors
        parts = []
        if known:
            parts.append(f[np.asarray(known)].sum(axis=0))
        if folded:
            parts.append(np.sum(folded, axis=0))
        q = np.sum(parts, axis=0, keepdims=True) \
            if len(parts) > 1 else parts[0][None, :]  # [1, K]
        n_items = f.shape[0]
        exclude = exclude_mask(n_items, model.item_index,
                               model.item_categories, query.categories,
                               query.whiteList, query.blackList)
        exclude[0, known] = True  # never the query items themselves
        scores, ids, _info = model.retriever().topk(q, query.num,
                                                    exclude=exclude)
        inv = model.item_index.inverse
        return PredictedResult(itemScores=[
            ItemScore(item=inv[i], score=s)
            for i, s in iter_hits(scores[0], ids[0], query.num)])


def engine() -> Engine:
    """Reference: SimilarProductEngine EngineFactory."""
    return Engine(
        datasource_class=SimilarProductDataSource,
        preparator_class=IdentityPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
