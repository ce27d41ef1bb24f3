"""E-commerce recommendation template — ALS + live business rules.

Port of ``predictionio_tpu/templates/ecommerce/engine.py`` (reference:
scala-parallel-ecommercerecommendation): implicit ALS on view/buy
events, with the rules applied at serve time:

- exclude items the user has already seen (the newest 512 of the
  user's ``seenEvents``, read from the event store on each request)
- exclude globally unavailable items (the latest ``$set`` on the
  "constraint" entity ``unavailableItems``, its ``items`` list)
- query-level ``categories`` / ``whiteList`` / ``blackList`` filters
- an unknown user gets the most viewed items (buys weighted
  ``buyWeight``) that pass the filters

Query/result JSON is the reference's:
``{"user": "u1", "num": 4, "categories"?, "whiteList"?, "blackList"?}`` →
``{"itemScores": [{"item", "score"}]}``.

Training runs the port's weighted implicit ALS on ``ctx.device``
(kernels K1 and K2 on the card).  Serving takes the exact rungs of the
port's retrieval facade, every request carrying its exclude mask.  A
model trained elsewhere is carried in with :func:`model_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

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
from predictionio_tpu_torch.retrieval import (
    Retriever,
    cached_retriever,
    iter_hits,
)
from predictionio_tpu_torch.templates.item_filters import (
    exclude_mask,
    read_categories,
)

__all__ = [
    "Query", "ItemScore", "PredictedResult", "TrainingData",
    "DataSourceParams", "ECommerceDataSource", "ECommAlgorithmParams",
    "ECommAlgorithm", "ECommModel", "model_from_numpy", "engine",
]


@dataclasses.dataclass
class Query:
    user: str
    num: int = 10
    categories: Optional[List[str]] = None
    whiteList: Optional[List[str]] = None  # noqa: N815
    blackList: Optional[List[str]] = None  # noqa: N815


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: List[ItemScore]  # noqa: N815


@dataclasses.dataclass
class TrainingData:
    user_ids: np.ndarray
    item_ids: np.ndarray
    weights: np.ndarray
    user_index: BiMap
    item_index: BiMap
    item_categories: Dict[str, Set[str]]
    view_counts: np.ndarray  # [I] popularity fallback


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815
    eventNames: Sequence[str] = ("view", "buy")  # noqa: N815
    buyWeight: float = 5.0  # noqa: N815 — buys count more than views


class ECommerceDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        from predictionio_tpu_torch.data.columnar import (
            encode_ids,
            event_mask,
        )

        p: DataSourceParams = self.params
        table = ctx.event_store.find_columnar(
            p.appName, entity_type="user", target_entity_type="item",
            event_names=list(p.eventNames),
            ordered=False,
            columns=["event", "entity_id", "target_entity_id"])
        user_ids, user_index = encode_ids(table["entity_id"])
        item_ids, item_index = encode_ids(table["target_entity_id"])
        weights = np.where(event_mask(table, ["buy"]), p.buyWeight,
                           1.0).astype(np.float32)
        view_counts = np.bincount(item_ids, weights=weights,
                                  minlength=len(item_index)).astype(np.float32)
        return TrainingData(
            user_ids=user_ids,
            item_ids=item_ids,
            weights=weights,
            user_index=user_index,
            item_index=item_index,
            item_categories=read_categories(ctx, p.appName),
            view_counts=view_counts,
        )


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    appName: str  # noqa: N815 — serving reads live events from this app
    rank: int = 10
    numIterations: int = 10  # noqa: N815
    lambda_: float = 0.01
    alpha: float = 1.0
    seenEvents: Sequence[str] = ("view", "buy")  # noqa: N815
    unseenOnly: bool = True  # noqa: N815
    seed: Optional[int] = None


# eq=False: model identity is the generation (the weak-keyed retriever
# cache needs a hashable owner).
@dataclasses.dataclass(eq=False)
class ECommModel:
    user_factors: np.ndarray
    item_factors: np.ndarray
    user_index: BiMap
    item_index: BiMap
    item_categories: Dict[str, Set[str]]
    view_counts: np.ndarray

    def __post_init__(self):
        self._init_transients()

    def _init_transients(self) -> None:
        # Serving state, never pickled: the device and the event store
        # the live rules read.
        self._device = None
        self._event_store = None

    def __getstate__(self):
        d = self.__dict__.copy()
        for k in ("_device", "_event_store"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._init_transients()

    def post_load(self, ctx: RuntimeContext) -> None:
        """Serving-time hook: the server's device and event store."""
        self._device = ctx.device
        store = getattr(ctx, "event_store", None)
        if store is not None:
            self._event_store = store

    def retriever(self) -> Retriever:
        """THE serving route to the item corpus, on the serving device."""
        return cached_retriever(self, lambda: Retriever(
            self.item_factors, n_items=len(self.item_index),
            name="ecommerce", device=self._device))


def model_from_numpy(user_factors, item_factors, user_ids, item_ids, *,
                     item_categories=None, view_counts=None) -> ECommModel:
    """Carry a trained e-commerce generation into the port: the factor
    arrays and the id strings of their rows, in row order, the item
    categories and the weighted view counts of the popularity fallback
    (zeros when not given)."""
    uf = np.require(user_factors, np.float32, ("C", "W"))
    itf = np.require(item_factors, np.float32, ("C", "W"))
    user_index = BiMap({str(u): i for i, u in enumerate(user_ids)})
    item_index = BiMap({str(t): i for i, t in enumerate(item_ids)})
    if len(user_index) != uf.shape[0] or len(item_index) != itf.shape[0]:
        raise ValueError("one id per factor row")
    counts = np.zeros(itf.shape[0], np.float32) if view_counts is None \
        else np.require(view_counts, np.float32, ("C", "W"))
    return ECommModel(
        user_factors=uf, item_factors=itf, user_index=user_index,
        item_index=item_index,
        item_categories={k: set(v) for k, v in
                         (item_categories or {}).items()},
        view_counts=counts)


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams

    def __init__(self, params=None):
        super().__init__(params)
        self._ctx: Optional[RuntimeContext] = None

    def train(self, ctx: RuntimeContext,
              prepared_data: TrainingData) -> ECommModel:
        p: ECommAlgorithmParams = self.params
        if len(prepared_data.user_ids) == 0:
            raise ValueError("No view/buy events found — check appName.")
        self._ctx = ctx
        cfg = als_lib.ALSConfig(
            rank=p.rank, iterations=p.numIterations, reg=p.lambda_,
            alpha=p.alpha, implicit=True,
            seed=p.seed if p.seed is not None else ctx.seed)
        model = als_lib.train_als(
            prepared_data.user_ids, prepared_data.item_ids,
            prepared_data.weights,
            n_users=len(prepared_data.user_index),
            n_items=len(prepared_data.item_index),
            config=cfg, device=ctx.device)
        out = ECommModel(
            user_factors=model.user_factors,
            item_factors=model.item_factors,
            user_index=prepared_data.user_index,
            item_index=prepared_data.item_index,
            item_categories=prepared_data.item_categories,
            view_counts=prepared_data.view_counts,
        )
        # A generation predicts where it trained until a server's
        # post_load moves it.
        out._device = ctx.device
        return out

    # -- live lookups (reference: LEventStore at predict time) -------------

    def _event_store(self, model: ECommModel):
        """The training context's store; else the store of the server
        that loaded ``model``; else the default storage's (what
        ``RuntimeContext.create()`` would hold, without taking a
        device)."""
        if self._ctx is not None:
            return self._ctx.event_store
        if model._event_store is None:
            from predictionio_tpu_torch.data.storage import get_storage
            from predictionio_tpu_torch.data.store import EventStore

            model._event_store = EventStore(get_storage())
        return model._event_store

    def _seen_items(self, model: ECommModel, query: Query) -> Set[str]:
        p: ECommAlgorithmParams = self.params
        if not p.unseenOnly:
            return set()
        try:
            evs = self._event_store(model).find_by_entity(
                p.appName, "user", query.user,
                event_names=list(p.seenEvents), limit=512)
        except Exception:
            logging.getLogger(__name__).debug("seen-items read failed",
                                              exc_info=True)
            return set()
        return {e.target_entity_id for e in evs if e.target_entity_id}

    def _unavailable_items(self, model: ECommModel) -> Set[str]:
        """The latest $set on constraint/unavailableItems."""
        try:
            evs = self._event_store(model).find_by_entity(
                self.params.appName, "constraint", "unavailableItems",
                event_names=["$set"], limit=1)
        except Exception:
            logging.getLogger(__name__).debug(
                "unavailable-items read failed", exc_info=True)
            return set()
        for e in evs:
            items = e.properties.get("items")
            if items:
                return set(items)
        return set()

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        n_items = model.item_factors.shape[0]
        exclude = exclude_mask(n_items, model.item_index,
                               model.item_categories, query.categories,
                               query.whiteList, query.blackList)
        live = [model.item_index.get(name) for name in
                self._seen_items(model, query)
                | self._unavailable_items(model)]
        exclude[0, [i for i in live if i is not None]] = True
        uidx = model.user_index.get(query.user)
        if uidx is not None:
            scores, ids, _info = model.retriever().topk(
                model.user_factors[uidx][None, :], query.num,
                exclude=exclude)
            pairs = [(s, i) for i, s in iter_hits(scores[0], ids[0],
                                                  query.num)]
        else:
            # Popularity fallback (reference: predictDefault).
            counts = np.where(exclude[0], -np.inf, model.view_counts)
            order = np.argsort(-counts)[: query.num]
            pairs = [(float(counts[i]), int(i)) for i in order
                     if np.isfinite(counts[i])]
        inv = model.item_index.inverse
        return PredictedResult(
            itemScores=[ItemScore(item=inv[i], score=s) for s, i in pairs])


def engine() -> Engine:
    """Reference: ECommerceRecommendationEngine EngineFactory."""
    return Engine(
        datasource_class=ECommerceDataSource,
        preparator_class=IdentityPreparator,
        algorithm_classes={"ecomm": ECommAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
