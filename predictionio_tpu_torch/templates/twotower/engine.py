"""Two-tower retrieval template — neural personal recommendations.

Port of ``predictionio_tpu/templates/twotower/engine.py``.  Same external
contract as the recommendation template, so clients switch engines
without changing queries:

- events: any positive-interaction names (default view/buy/rate)
- query JSON: ``{"user": "u1", "num": 4}``
- result JSON: ``{"itemScores": [{"item", "score"}]}``

Training runs :mod:`predictionio_tpu_torch.models.two_tower` on
``ctx.device`` (in-batch sampled softmax with Adam, the native feeder's
batches, the prefetcher and K-step fusion), then encodes every user and
item on that device and keeps the L2-normalised tower outputs as numpy,
with the reference's train-time retrieval structures built from them
(IVF under ``PIO_IVF``, residual PQ codes under ``PIO_PQ``).  Serving
goes through the port's retrieval facade (the chunked rung is the fused
top-k kernel K3 on the card).  ``TwoTowerAlgorithm.warm_start`` is the
refresh loop's delta warm start: the carried train state grows for new
entities and continues training on the delta window.  A generation
trained by the reference is carried in with :func:`model_from_numpy`.
Every generation carries its quality scorecard and, when it built IVF
or PQ, its recall scorecard, both pinned to the item corpus's
fingerprint.  Not ported yet: the serving mesh's sharding in
``post_load``.
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    RuntimeContext,
    WarmStartFallback,
)
from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.data.event import BiMap
from predictionio_tpu_torch.models import two_tower as tt_lib
from predictionio_tpu_torch.obs.quality import (
    Scorecard,
    scorecard_from_mapping,
    scorecard_from_matrix,
)
from predictionio_tpu_torch.obs.recall import (
    RecallScorecard,
    build_recall_scorecard,
    recall_scorecard_from_mapping,
)
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
    "Query", "ItemScore", "PredictedResult", "InteractionData",
    "DataSourceParams", "TwoTowerDataSource", "TwoTowerAlgorithmParams",
    "TwoTowerAlgorithm", "TwoTowerModelWrapper", "model_from_numpy",
    "engine",
]


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
    itemScores: List[ItemScore]  # noqa: N815


@dataclasses.dataclass
class InteractionData:
    user_ids: np.ndarray
    item_ids: np.ndarray
    user_index: BiMap
    item_index: BiMap


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815
    eventNames: Sequence[str] = ("view", "buy", "rate")  # noqa: N815


class TwoTowerDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> InteractionData:
        from predictionio_tpu_torch.data.columnar import encode_ids

        p: DataSourceParams = self.params
        table = ctx.event_store.find_columnar(
            p.appName, entity_type="user", target_entity_type="item",
            event_names=list(p.eventNames),
            ordered=False, columns=["entity_id", "target_entity_id"])
        user_ids, user_index = encode_ids(table["entity_id"])
        item_ids, item_index = encode_ids(table["target_entity_id"])
        return InteractionData(
            user_ids=user_ids,
            item_ids=item_ids,
            user_index=user_index,
            item_index=item_index,
        )


@dataclasses.dataclass(frozen=True)
class TwoTowerAlgorithmParams(Params):
    embedDim: int = 32  # noqa: N815
    hiddenDims: Sequence[int] = (64,)  # noqa: N815
    outDim: int = 32  # noqa: N815
    learningRate: float = 1e-3  # noqa: N815
    temperature: float = 0.05
    batchSize: int = 512  # noqa: N815
    epochs: int = 5
    seed: Optional[int] = None


# eq=False: wrapper identity IS the model generation — keeps the object
# hashable for the weak-keyed retriever cache.
@dataclasses.dataclass(eq=False)
class TwoTowerModelWrapper:
    """Encoded item corpus + user vectors for serving, the generation's
    optional IVF index and PQ codebook (pickled with it, so a generation
    swap moves model and index together), and the warm-start carry: the
    host-numpy train state, the config it was trained under and the
    interaction count (None on a wrapper that carries no state; warm
    start then falls back to a full retrain).

    Everything pickled is numpy or plain Python; the device copies of the
    corpus live in the weak-keyed retriever cache and die with the
    wrapper.  ``quality`` and ``recall`` are the training-time score and
    recall baselines, pinned to ``item_vecs``' fingerprint."""

    user_vecs: np.ndarray   # [U, D] — encoded user representations
    item_vecs: np.ndarray   # [I, D] (L2-normalized tower outputs)
    user_index: BiMap
    item_index: BiMap
    ivf: Optional[IVFIndex] = None
    pq: Optional[PQCodebook] = None
    quality: Optional[Scorecard] = None
    recall: Optional[RecallScorecard] = None
    train_state: Optional[Dict] = None
    train_cfg: Optional[tt_lib.TwoTowerConfig] = None
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
        """Serving-time hook: the device the server runs on.  (The
        reference also row-shards a large corpus over a serving mesh;
        the mesh is not ported.)"""
        self._device = ctx.device

    def retriever(self) -> Retriever:
        """THE serving route to the item corpus — one per loaded
        generation, dying with it."""
        ref = weakref.ref(self)
        return cached_retriever(self, lambda: Retriever(
            self.item_vecs,
            n_items=len(self.item_index),
            ivf=self.ivf,
            pq=self.pq,
            name="twotower",
            host_fn=lambda: ref().item_vecs,
            device=self._device))


def _merge_index(prev: BiMap, delta: BiMap) -> BiMap:
    """Extend ``prev`` with delta-only keys appended AFTER the existing
    range (existing entities keep their embedding rows; new ones map to
    the grown tail), in their first-seen order."""
    m = dict(prev.items())
    for k in delta:
        if k not in m:
            m[k] = len(m)
    return BiMap(m)


def _remap_codes(codes: np.ndarray, delta_index: BiMap,
                 merged: BiMap) -> np.ndarray:
    """Delta-local int codes → merged global ids (one vectorized take)."""
    lookup = np.asarray([merged[k] for k in delta_index.to_numpy_keys()],
                        np.int64)
    return lookup[np.asarray(codes, np.int64)]


def _index_of(ids: Union[Mapping, Sequence]) -> BiMap:
    """A BiMap from a mapping of id → row (either package's BiMap, a
    dict) or from the ids in row order."""
    if hasattr(ids, "items"):
        return BiMap({str(k): int(v) for k, v in ids.items()})
    return BiMap({str(k): i for i, k in enumerate(ids)})


def _port_snapshot(snapshot: Mapping) -> Dict:
    """A train-state snapshot in the port's layout (numpy leaves, the
    port's ``AdamState``) from either package's ``state_to_host``."""
    def arr(a):
        return np.array(a, np.float32)

    def tree(t):
        return {"user_embed": arr(t["user_embed"]),
                "item_embed": arr(t["item_embed"]),
                **{tower: {"layers": [{"w": arr(l_["w"]), "b": arr(l_["b"])}
                                      for l_ in t[tower]["layers"]]}
                   for tower in ("user_mlp", "item_mlp")}}

    count, mu, nu = snapshot["opt_state"][0]
    return {"params": tree(snapshot["params"]),
            "opt_state": (tt_lib.AdamState(
                count=np.asarray(count, np.int32), mu=tree(mu),
                nu=tree(nu)), tt_lib.EmptyState()),
            "step": np.asarray(snapshot["step"], np.int32)}


def model_from_numpy(user_vecs, item_vecs, user_ids, item_ids, *,
                     ivf: Union[IVFIndex, Mapping[str, Any], None] = None,
                     pq: Union[PQCodebook, Mapping[str, Any], None] = None,
                     quality: Union[Scorecard, Mapping[str, Any],
                                    None] = None,
                     recall: Union[RecallScorecard, Mapping[str, Any],
                                   None] = None,
                     train_state: Optional[Mapping] = None,
                     train_cfg: Any = None,
                     n_examples: int = 0) -> TwoTowerModelWrapper:
    """Carry a trained two-tower generation into the port: the encoded
    user and item vectors, the ids of their rows (a BiMap or mapping of
    id → row, e.g. the reference wrapper's ``user_index``, or the ids in
    row order), optionally its IVF index, PQ codebook, quality scorecard
    and recall scorecard (the port's structures or mappings of the
    reference's fields, e.g. ``dataclasses.asdict``), and for warm
    start the reference's ``train_state`` snapshot with its
    ``train_cfg`` (any object with :class:`TwoTowerConfig`'s fields)."""
    user_index, item_index = _index_of(user_ids), _index_of(item_ids)
    uv = np.require(user_vecs, np.float32, ("C", "W"))
    iv = np.require(item_vecs, np.float32, ("C", "W"))
    if len(user_index) != uv.shape[0] or len(item_index) != iv.shape[0]:
        raise ValueError("one id per vector row")
    if isinstance(ivf, Mapping):
        ivf = IVFIndex(**ivf)
    if isinstance(pq, Mapping):
        pq = PQCodebook(**pq)
    cfg = None
    if train_cfg is not None:
        cfg = tt_lib.TwoTowerConfig(**{
            f.name: getattr(train_cfg, f.name)
            for f in dataclasses.fields(tt_lib.TwoTowerConfig)})
        cfg.hidden_dims = tuple(cfg.hidden_dims)
    return TwoTowerModelWrapper(
        user_vecs=uv, item_vecs=iv, user_index=user_index,
        item_index=item_index, ivf=ivf, pq=pq,
        quality=scorecard_from_mapping(quality),
        recall=recall_scorecard_from_mapping(recall),
        train_state=None if train_state is None
        else _port_snapshot(train_state),
        train_cfg=cfg, n_examples=int(n_examples))


class TwoTowerAlgorithm(Algorithm):
    params_class = TwoTowerAlgorithmParams

    def _config(self, ctx: RuntimeContext, n_users: int,
                n_items: int) -> tt_lib.TwoTowerConfig:
        p: TwoTowerAlgorithmParams = self.params
        return tt_lib.TwoTowerConfig(
            n_users=n_users,
            n_items=n_items,
            embed_dim=p.embedDim,
            hidden_dims=tuple(p.hiddenDims),
            out_dim=p.outDim,
            learning_rate=p.learningRate,
            temperature=p.temperature,
            batch_size=p.batchSize,
            epochs=p.epochs,
            seed=p.seed if p.seed is not None else ctx.seed,
        )

    def _wrap(self, ctx: RuntimeContext, state: tt_lib.TwoTowerState,
              cfg: tt_lib.TwoTowerConfig, user_index: BiMap,
              item_index: BiMap, n_examples: int) -> TwoTowerModelWrapper:
        """Encode every user and item on the state's device, keep them as
        numpy, build the train-time IVF index and PQ codes from the
        normalised item vectors (policy-gated: ``PIO_IVF`` /
        ``PIO_PQ``), and the quality and recall scorecards."""
        import torch

        dev = state.params["user_embed"].device
        user_vecs = tt_lib.encode_users(
            state.params, torch.arange(cfg.n_users, device=dev)).cpu().numpy()
        item_vecs = tt_lib.encode_items(
            state.params, torch.arange(cfg.n_items, device=dev)).cpu().numpy()
        ivf = build_train_index(item_vecs, name="twotower", seed=cfg.seed)
        pq = build_train_pq(item_vecs, name="twotower", ivf=ivf,
                            seed=cfg.seed)
        wrapper = TwoTowerModelWrapper(
            user_vecs=user_vecs, item_vecs=item_vecs,
            user_index=user_index, item_index=item_index,
            ivf=ivf, pq=pq,
            # Quality baseline: rank-1 dot-product scores of a seeded
            # user sample against the item corpus.
            quality=scorecard_from_matrix(user_vecs, item_vecs,
                                          seed=cfg.seed or 0,
                                          name="twotower"),
            # Expected-recall baseline of the structures just built.
            recall=build_recall_scorecard(user_vecs, item_vecs, ivf=ivf,
                                          pq=pq, seed=cfg.seed or 0,
                                          name="twotower"),
            train_state=tt_lib.state_to_host(state),
            train_cfg=cfg, n_examples=int(n_examples))
        # A generation predicts where it trained until a server's
        # post_load moves it.
        wrapper._device = ctx.device
        return wrapper

    def train(self, ctx: RuntimeContext,
              prepared_data: InteractionData) -> TwoTowerModelWrapper:
        if len(prepared_data.user_ids) == 0:
            raise ValueError("No interaction events found — check appName.")
        cfg = self._config(ctx, len(prepared_data.user_index),
                           len(prepared_data.item_index))
        state = tt_lib.train(prepared_data.user_ids, prepared_data.item_ids,
                             cfg, mesh=ctx.mesh, device=ctx.device)
        return self._wrap(ctx, state, cfg, prepared_data.user_index,
                          prepared_data.item_index,
                          len(prepared_data.user_ids))

    def warm_start(self, ctx: RuntimeContext, prepared_delta: InteractionData,
                   prev_model: TwoTowerModelWrapper,
                   warm: Any) -> TwoTowerModelWrapper:
        """Delta warm start: restore the previous generation's carried
        train state, grow the embedding tables for entities first seen in
        the delta window, and CONTINUE training on the delta only, through
        the same loop a full train uses.

        Falls back (``WarmStartFallback`` → full retrain in the same
        engine instance) when the previous wrapper carries no train
        state, the algorithm config changed, the delta exceeds
        ``warm.max_delta_fraction`` of the previous corpus, or the
        continued model's loss on a fixed delta sample regresses past
        ``warm.eval_tolerance`` against the state it started from."""
        log = logging.getLogger(__name__)
        snapshot = getattr(prev_model, "train_state", None)
        prev_cfg = getattr(prev_model, "train_cfg", None)
        if snapshot is None or prev_cfg is None:
            raise WarmStartFallback(
                "previous generation carries no train state")
        delta_n = len(prepared_delta.user_ids)
        prev_n = int(getattr(prev_model, "n_examples", 0))
        cfg_now = self._config(ctx, prev_cfg.n_users, prev_cfg.n_items)
        for f in ("embed_dim", "hidden_dims", "out_dim", "learning_rate",
                  "temperature", "batch_size", "seed"):
            if getattr(cfg_now, f) != getattr(prev_cfg, f):
                raise WarmStartFallback(
                    f"algorithm config changed ({f}: "
                    f"{getattr(prev_cfg, f)!r} → {getattr(cfg_now, f)!r})")
        max_frac = getattr(warm, "max_delta_fraction", 0.5)
        if prev_n <= 0 or delta_n > max_frac * prev_n:
            raise WarmStartFallback(
                f"delta window too large for continuation "
                f"({delta_n} events vs {prev_n} trained; "
                f"max fraction {max_frac:g})")
        user_index = _merge_index(prev_model.user_index,
                                  prepared_delta.user_index)
        item_index = _merge_index(prev_model.item_index,
                                  prepared_delta.item_index)
        uids = _remap_codes(prepared_delta.user_ids,
                            prepared_delta.user_index, user_index)
        iids = _remap_codes(prepared_delta.item_ids,
                            prepared_delta.item_index, item_index)
        cfg = dataclasses.replace(prev_cfg, n_users=len(user_index),
                                  n_items=len(item_index),
                                  epochs=self.params.epochs)
        state = tt_lib.grow_state(
            tt_lib.state_from_host(snapshot, ctx.device), cfg)
        if delta_n == 0:
            # Nothing new: re-land the carried state as a fresh
            # generation (its watermark still advances).
            return self._wrap(ctx, state, cfg, user_index, item_index,
                              prev_n)
        # Regression gate sample: a fixed (seeded) subset of the delta,
        # scored before and after continuation at the same temperature.
        rng = np.random.default_rng(cfg.seed)
        sample = rng.choice(delta_n, size=min(delta_n, 1024), replace=False)
        loss_before = tt_lib.eval_loss(state.params, uids[sample],
                                       iids[sample], cfg)
        trained = tt_lib.train(uids, iids, cfg, mesh=ctx.mesh,
                               warm_state=state, device=ctx.device)
        loss_after = tt_lib.eval_loss(trained.params, uids[sample],
                                      iids[sample], cfg)
        tol = getattr(warm, "eval_tolerance", 0.1)
        if not np.isfinite(loss_after) \
                or loss_after > loss_before * (1.0 + tol) + 1e-9:
            raise WarmStartFallback(
                f"warm-started eval regressed on the delta sample "
                f"({loss_before:.4f} → {loss_after:.4f}, "
                f"tolerance {tol:g})")
        log.info("two_tower warm-start: +%d events (%d new users, %d new "
                 "items), delta-sample loss %.4f → %.4f",
                 delta_n, len(user_index) - len(prev_model.user_index),
                 len(item_index) - len(prev_model.item_index),
                 loss_before, loss_after)
        return self._wrap(ctx, trained, cfg, user_index, item_index,
                          prev_n + delta_n)

    def predict(self, model: TwoTowerModelWrapper,
                query: Query) -> PredictedResult:
        # A batch of one: the same facade routing applies.
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: TwoTowerModelWrapper, queries):
        """Vectorized serving path: ONE retrieval-facade call for the
        whole cohort; all routing lives in the facade, this template
        only maps ids.  Unknown users get the empty answer."""
        known = [(i, q) for i, q in queries
                 if model.user_index.get(q.user) is not None]
        out = [(i, PredictedResult(itemScores=[])) for i, q in queries
               if model.user_index.get(q.user) is None]
        if not known:
            return out
        num = max(q.num for _, q in known)
        idxs = np.asarray([model.user_index[q.user] for _, q in known])
        scores, ids, _info = model.retriever().topk(
            model.user_vecs[idxs], num)
        inv = model.item_index.inverse
        for row, (i, q) in enumerate(known):
            out.append((i, PredictedResult(itemScores=[
                ItemScore(item=inv[ii], score=ss)
                for ii, ss in iter_hits(scores[row], ids[row], q.num)])))
        return out


def engine() -> Engine:
    return Engine(
        datasource_class=TwoTowerDataSource,
        preparator_class=IdentityPreparator,
        algorithm_classes={"twotower": TwoTowerAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
