"""Recommendation template — ALS personal recommendations.

Port of ``predictionio_tpu/templates/recommendation/engine.py``.  The
contract is the reference's:

- events: ``rate`` (user→item, properties.rating) and ``buy`` (user→item,
  implicit, trained as ``buyRating``)
- query JSON: ``{"user": "u1", "num": 4}``
- result JSON: ``{"itemScores": [{"item": "i1", "score": 1.2}, ...]}``
- algorithm params: rank / numIterations / lambda / alpha /
  implicitPrefs / seed — the MLlib ``ALS.train`` knob set

The reference template imports jax at module level, so the port copies
its types instead of importing them.  Training runs the port's ALS
sweep (kernels K1 and K2 on the card), then builds the reference's
train-time retrieval structures on the host: an IVF index under an
explicit ``PIO_IVF=on``, and residual PQ codes under the ``PIO_PQ``
policy on top of it.  Serving goes through the port's retrieval facade
(exact rungs, the chunked one on the fused top-k kernel K3; the IVF and
PQ rungs, ``pq_flat`` on the PQ scan kernel K5).  A generation trained
elsewhere can still be carried in with :func:`wrapper_from_numpy` and
persisted with
:func:`predictionio_tpu_torch.workflow.core_workflow.persist_instance`.
Not ported yet: ``read_eval``, ``warm_start``, the quality and recall
scorecards, and serve-time fold-in.
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    Preparator,
    RuntimeContext,
)
from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.data.event import BiMap
from predictionio_tpu_torch.models import als as als_lib
from predictionio_tpu_torch.retrieval import (
    IVFIndex,
    PQCodebook,
    Retriever,
    build_train_index,
    build_train_pq,
    cached_retriever,
    iter_hits,
)

__all__ = [
    "engine",
    "Query",
    "ItemScore",
    "PredictedResult",
    "Ratings",
    "DataSourceParams",
    "RecommendationDataSource",
    "RecommendationPreparator",
    "ALSAlgorithmParams",
    "ALSAlgorithm",
    "ALSModelWrapper",
    "wrapper_from_numpy",
]


# -- query / result (JSON contract) -----------------------------------------

@dataclasses.dataclass
class Query:
    user: str
    num: int = 10


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: List[ItemScore]  # noqa: N815 — reference JSON field name


# -- training data ----------------------------------------------------------

@dataclasses.dataclass
class Ratings:
    """COO ratings plus the string↔int entity indexes (reference: the
    template's ``TrainingData``), with the fold-in context the trained
    wrapper keeps."""

    user_ids: np.ndarray
    item_ids: np.ndarray
    ratings: np.ndarray
    user_index: BiMap
    item_index: BiMap
    app_name: Optional[str] = None
    event_names: Sequence[str] = ()
    buy_rating: float = 4.0


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815 — engine.json key parity
    eventNames: Sequence[str] = ("rate", "buy")  # noqa: N815
    buyRating: float = 4.0  # noqa: N815 — implicit "buy" becomes this rating
    evalK: Optional[int] = None  # noqa: N815 — folds for pio eval
    evalQueryNum: int = 10  # noqa: N815
    seed: int = 3


class RecommendationDataSource(DataSource):
    """Reads rate/buy events into COO ratings (reference: DataSource.scala)."""

    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> Ratings:
        from predictionio_tpu_torch.data.columnar import (
            encode_ids,
            event_mask,
            numeric_property,
        )

        p: DataSourceParams = self.params
        table = ctx.event_store.find_columnar(
            p.appName,
            entity_type="user",
            target_entity_type="item",
            event_names=list(p.eventNames),
            # training is order-independent, and only these columns
            # feed the COO
            ordered=False,
            columns=["event", "entity_id", "target_entity_id", "properties"],
        )
        user_ids, user_index = encode_ids(table["entity_id"])
        item_ids, item_index = encode_ids(table["target_entity_id"])
        is_rate = event_mask(table, ["rate"])
        raw = numeric_property(table, "rating", default=np.nan)
        ratings = np.where(is_rate, raw, p.buyRating).astype(np.float32)
        # Decided semantic (PARITY.md): a `rate` event with no numeric
        # `rating` property is DROPPED with a warning — never trained as
        # rating 0.0, a strong negative signal in explicit ALS.
        bad = is_rate & ~np.isfinite(ratings)
        if bad.any():
            logging.getLogger(__name__).warning(
                "dropping %d rate event(s) without a numeric 'rating' "
                "property", int(bad.sum()))
            keep = ~bad
            user_ids, item_ids = user_ids[keep], item_ids[keep]
            ratings = ratings[keep]
        return Ratings(
            user_ids=user_ids,
            item_ids=item_ids,
            ratings=ratings,
            user_index=user_index,
            item_index=item_index,
            app_name=p.appName,
            event_names=tuple(p.eventNames),
            buy_rating=p.buyRating,
        )


class RecommendationPreparator(Preparator):
    """Reference: Preparator.scala — identity over the ratings."""

    def prepare(self, ctx: RuntimeContext, training_data: Ratings) -> Ratings:
        return training_data


# -- algorithm --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 10  # noqa: N815 — MLlib knob names
    lambda_: float = 0.01
    alpha: float = 1.0
    implicitPrefs: bool = False  # noqa: N815
    maxDegree: Optional[int] = None  # noqa: N815 — ragged truncation cap
    seed: Optional[int] = None
    # Mesh knobs of the reference; bound for engine.json parity, used by
    # the multi-chip slice.
    factorSharding: str = "auto"  # noqa: N815
    gatherWindow: Union[bool, str] = "auto"  # noqa: N815


# eq=False: wrapper identity IS the model generation — keeps the object
# hashable for the weak-keyed retriever cache.
@dataclasses.dataclass(eq=False)
class ALSModelWrapper:
    """Trained factors + indexes (reference: template ALSModel).

    Everything pickled is numpy or plain Python; the CUDA copies of the
    corpus, index and codes live in the weak-keyed retriever cache and
    die with the wrapper.  ``ivf``/``pq`` are the generation's optional
    IVF index and PQ codebook, pickled with it so a generation swap moves
    model, index and codes together.  Training fills the fold-in fields
    as the reference does, but serve-time fold-in is ported later: until
    then an unseen user gets the cold-start (empty) answer.
    """

    model: als_lib.ALSModel
    user_index: BiMap
    item_index: BiMap
    ivf: Optional[IVFIndex] = None
    pq: Optional[PQCodebook] = None
    app_name: Optional[str] = None
    fold_event_names: Sequence[str] = ()
    buy_rating: float = 4.0
    reg: float = 0.01
    alpha: float = 1.0
    n_examples: int = 0

    def __post_init__(self):
        self._device = None

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_device", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._device = None

    def post_load(self, ctx: RuntimeContext) -> None:
        """Serving-time hook: take the device the server runs on."""
        self._device = ctx.device

    def retriever(self) -> Retriever:
        """THE serving route to the item corpus — one per loaded
        generation, dying with it."""
        # host_fn holds the wrapper WEAKLY: the retriever is the
        # weak-keyed cache's VALUE, so a strong capture would pin its own
        # key alive and leak every swapped-out generation.
        ref = weakref.ref(self)
        return cached_retriever(self, lambda: Retriever(
            self.model.item_factors,
            n_items=len(self.item_index),
            ivf=self.ivf,
            pq=self.pq,
            name="als",
            host_fn=lambda: ref().host_factors()[1],
            device=self._device))

    def host_user_factors(self) -> np.ndarray:
        """User factors, trimmed to the trained users."""
        return self.model.user_factors[: len(self.user_index)]

    def host_factors(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self.model.user_factors[: len(self.user_index)],
                self.model.item_factors[: len(self.item_index)])

    def fold_in_user(self, user: str) -> Optional[np.ndarray]:
        """Serve-time fold-in is ported later: no factor, so an unseen
        user gets the cold-start answer."""
        return None


def wrapper_from_numpy(user_factors, item_factors, user_ids, item_ids, *,
                       rank: int, implicit: bool = False,
                       ivf: Union[IVFIndex, Mapping[str, Any], None] = None,
                       pq: Union[PQCodebook, Mapping[str, Any], None] = None
                       ) -> ALSModelWrapper:
    """Carry a trained ALS generation into the port: factor arrays plus
    the user and item id strings of their rows, in row order, and
    optionally its IVF index and PQ codebook — each an :class:`IVFIndex`
    / :class:`PQCodebook` or a mapping of the reference's fields (numpy
    arrays and plain values, e.g. ``dataclasses.asdict`` of the
    reference's structure)."""
    model = als_lib.als_model_from_numpy(user_factors, item_factors,
                                         rank=rank, implicit=implicit)
    user_index = BiMap({str(u): i for i, u in enumerate(user_ids)})
    item_index = BiMap({str(t): i for i, t in enumerate(item_ids)})
    if len(user_index) > model.user_factors.shape[0] \
            or len(item_index) > model.item_factors.shape[0]:
        raise ValueError("more ids than factor rows")
    if isinstance(ivf, Mapping):
        ivf = IVFIndex(**ivf)
    if isinstance(pq, Mapping):
        pq = PQCodebook(**pq)
    return ALSModelWrapper(model=model, user_index=user_index,
                           item_index=item_index, ivf=ivf, pq=pq)


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams

    def train(self, ctx: RuntimeContext,
              prepared_data: Ratings) -> ALSModelWrapper:
        """Train on ``ctx.device``, then build the IVF index and PQ codes
        the env policy asks for (reference: ``ALSAlgorithm.train``); the
        quality and recall scorecards are not ported yet."""
        p: ALSAlgorithmParams = self.params
        if len(prepared_data.user_ids) == 0:
            raise ValueError(
                "No rating events found — check appName/eventNames "
                "(reference template raises the same assertion).")
        n_items = len(prepared_data.item_index)
        cfg = als_lib.ALSConfig(
            rank=p.rank,
            iterations=p.numIterations,
            reg=p.lambda_,
            alpha=p.alpha,
            implicit=p.implicitPrefs,
            max_degree=p.maxDegree,
            seed=p.seed if p.seed is not None else ctx.seed,
            factor_sharding=p.factorSharding,
            gather_window=p.gatherWindow,
        )
        model = als_lib.train_als(
            prepared_data.user_ids,
            prepared_data.item_ids,
            prepared_data.ratings,
            n_users=len(prepared_data.user_index),
            n_items=n_items,
            config=cfg,
            device=ctx.device,
        )
        itf_host = model.item_factors[:n_items]
        # Train-time coarse index, pickled with the model.  Raw ALS
        # factors carry popularity-scaled norms (a poor IVF fit: cells
        # partition by direction), so it builds only under an explicit
        # PIO_IVF=on, never auto.
        ivf = build_train_index(itf_host, name="als", seed=cfg.seed,
                                require_explicit=True)
        # Residual PQ codes under the PIO_PQ policy (auto by default):
        # the exact re-rank makes quantization safe for norm-variant
        # factors, so no explicit opt-in is required.
        pq = build_train_pq(itf_host, name="als", ivf=ivf, seed=cfg.seed)
        return ALSModelWrapper(
            model=model,
            user_index=prepared_data.user_index,
            item_index=prepared_data.item_index,
            ivf=ivf,
            pq=pq,
            app_name=prepared_data.app_name,
            fold_event_names=tuple(prepared_data.event_names or ()),
            buy_rating=float(prepared_data.buy_rating),
            reg=float(p.lambda_),
            alpha=float(p.alpha),
            n_examples=len(prepared_data.ratings),
        )

    def predict(self, model: ALSModelWrapper, query: Query) -> PredictedResult:
        # One query = a batch of one: the same facade routing applies.
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: ALSModelWrapper, queries):
        """Vectorized serving path — ONE retrieval-facade call for the
        whole cohort; all routing lives in the retrieval facade, this
        template only maps ids.  Unseen users try fold-in first (none
        yet) and otherwise get the cold-start empty result."""
        known = [(i, q) for i, q in queries if q.user in model.user_index]
        rows: List[np.ndarray] = []
        cold: List[Tuple[int, Query]] = []
        folded: List[Tuple[int, Query]] = []
        for i, q in queries:
            if q.user in model.user_index:
                continue
            vec = model.fold_in_user(q.user)
            if vec is None:
                cold.append((i, q))
            else:
                folded.append((i, q))
                rows.append(vec)
        out = [(i, PredictedResult(itemScores=[])) for i, q in cold]
        answerable = known + folded
        if answerable:
            num = max(q.num for _, q in answerable)
            uf = model.host_user_factors()
            qmat_parts = []
            if known:
                idxs = np.asarray([model.user_index[q.user]
                                   for _, q in known])
                qmat_parts.append(uf[idxs])
            if rows:
                qmat_parts.append(np.stack(rows))
            qmat = np.concatenate(qmat_parts, axis=0) \
                if len(qmat_parts) > 1 else qmat_parts[0]
            scores, ids, _info = model.retriever().topk(qmat, num)
            inv = model.item_index.inverse
            for row, (i, q) in enumerate(answerable):
                out.append((i, PredictedResult(itemScores=[
                    ItemScore(item=inv[ii], score=ss)
                    for ii, ss in iter_hits(scores[row], ids[row], q.num)
                ])))
        return out


def engine() -> Engine:
    """Reference: RecommendationEngine EngineFactory."""
    return Engine(
        datasource_class=RecommendationDataSource,
        preparator_class=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
