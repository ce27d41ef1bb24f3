"""Recommendation template — ALS personal recommendations, serving half.

Port of ``predictionio_tpu/templates/recommendation/engine.py``.  The
JSON contract is the reference's:

- query JSON: ``{"user": "u1", "num": 4}``
- result JSON: ``{"itemScores": [{"item": "i1", "score": 1.2}, ...]}``
- algorithm params: rank / numIterations / lambda / alpha /
  implicitPrefs / seed — the MLlib ``ALS.train`` knob set

The reference template imports jax at module level, so the port copies
its types instead of importing them.  Serving goes through the port's
retrieval facade (host, device and chunked rungs; the chunked rung runs
the fused top-k kernel).  Training — the datasource read and
``ALSAlgorithm.train`` — arrives with the training slice; until then a
generation is carried over with :func:`wrapper_from_numpy` and persisted
with :func:`predictionio_tpu_torch.workflow.core_workflow.persist_instance`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, List, Optional, Sequence, Tuple, Union

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
    Retriever,
    cached_retriever,
    iter_hits,
)

__all__ = [
    "engine",
    "Query",
    "ItemScore",
    "PredictedResult",
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

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815 — engine.json key parity
    eventNames: Sequence[str] = ("rate", "buy")  # noqa: N815
    buyRating: float = 4.0  # noqa: N815 — implicit "buy" becomes this rating
    evalK: Optional[int] = None  # noqa: N815 — folds for pio eval
    evalQueryNum: int = 10  # noqa: N815
    seed: int = 3


class RecommendationDataSource(DataSource):
    """Reads rate/buy events into COO ratings (reference: DataSource.scala).
    The event store is ported with the training slice."""

    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext):
        raise NotImplementedError(
            "reading training events is ported with the ALS training slice")


class RecommendationPreparator(Preparator):
    """Reference: Preparator.scala — identity over the ratings."""

    def prepare(self, ctx: RuntimeContext, training_data):
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

    Everything pickled is numpy or plain Python; the CUDA copy of the
    corpus lives in the weak-keyed retriever cache and dies with the
    wrapper.  ``ivf``/``pq`` exist for parity with the reference's
    pickle: a generation that carries either is refused until the IVF
    and PQ rungs are ported.  The fold-in fields keep their defaults:
    serve-time fold-in is ported later, and until then an unseen user
    gets the cold-start (empty) answer.
    """

    model: als_lib.ALSModel
    user_index: BiMap
    item_index: BiMap
    ivf: Any = None
    pq: Any = None
    app_name: Optional[str] = None
    fold_event_names: Sequence[str] = ()
    buy_rating: float = 4.0
    reg: float = 0.01
    alpha: float = 1.0
    n_examples: int = 0

    def __post_init__(self):
        self._check_ported()
        self._device = None

    def _check_ported(self) -> None:
        if self.ivf is not None or self.pq is not None:
            raise NotImplementedError(
                "this ALS generation carries an IVF index or PQ codes; the "
                "IVF/PQ retrieval rungs are not yet ported to PyTorch")

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_device", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._check_ported()
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
                       rank: int, implicit: bool = False) -> ALSModelWrapper:
    """Carry a trained ALS generation into the port: factor arrays plus
    the user and item id strings of their rows, in row order."""
    model = als_lib.als_model_from_numpy(user_factors, item_factors,
                                         rank=rank, implicit=implicit)
    user_index = BiMap({str(u): i for i, u in enumerate(user_ids)})
    item_index = BiMap({str(t): i for i, t in enumerate(item_ids)})
    if len(user_index) > model.user_factors.shape[0] \
            or len(item_index) > model.item_factors.shape[0]:
        raise ValueError("more ids than factor rows")
    return ALSModelWrapper(model=model, user_index=user_index,
                           item_index=item_index)


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams

    def train(self, ctx: RuntimeContext, prepared_data) -> ALSModelWrapper:
        raise NotImplementedError("ALS training is ported in the next slice")

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
