"""DLRM / Wide&Deep CTR ranking template.

Port of ``predictionio_tpu/templates/dlrm/engine.py``.  Event contract:

- impression events (default ``impression``): user→item with a ``clicked``
  property (bool/0/1), optional ``dense`` list property (numeric context
  features, e.g. position, hour)
- query JSON: ``{"user": "u1", "items": ["i1","i2"], "dense"?: [...]}``
  → result ``{"itemScores": [{"item", "score"}]}`` — scores are predicted
  CTRs, items ranked by them

Categorical fields: (user id, item id) hashed into fixed vocabularies —
unseen entities at serve time degrade gracefully to shared hash buckets.
Training runs :mod:`predictionio_tpu_torch.models.dlrm` on
``ctx.device`` (the native feeder's batches, the prefetcher and K-step
fusion); ``DLRMAlgorithm.warm_start`` is the refresh loop's delta warm
start, continuing the carried train state on the delta window.  The
model's state lives on the serving device and travels as host numpy in
its pickle.  Training takes ``ctx.mesh`` (``pio train --mesh
expert=N``: the table row-sharded over ``expert``, the lookup
:func:`~predictionio_tpu_torch.models.dlrm.sharded_embedding_lookup`);
the served state is gathered onto the server's device.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import zlib
from typing import Any, List, Optional, Sequence

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
from predictionio_tpu_torch.models import dlrm as dlrm_lib

__all__ = [
    "Query", "ItemScore", "PredictedResult", "CTRData", "DataSourceParams",
    "DLRMDataSource", "DLRMAlgorithmParams", "DLRMAlgorithm",
    "DLRMModelWrapper", "engine",
]


def _hash(s: str, mod: int) -> int:
    """Stable string→bucket hash (zlib.crc32 is deterministic cross-run)."""
    return zlib.crc32(s.encode()) % mod


@dataclasses.dataclass
class Query:
    user: str
    items: List[str]
    dense: Optional[List[float]] = None


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: List[ItemScore]  # noqa: N815


@dataclasses.dataclass
class CTRData:
    dense: np.ndarray    # [N, n_dense]
    cat: np.ndarray      # [N, 2] — hashed (user, item)
    labels: np.ndarray   # [N]
    n_dense: int


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815
    eventNames: Sequence[str] = ("impression",)  # noqa: N815
    labelProperty: str = "clicked"  # noqa: N815
    denseProperty: str = "dense"  # noqa: N815
    nDense: int = 4  # noqa: N815 — fixed width; shorter lists zero-padded
    userVocab: int = 65536  # noqa: N815
    itemVocab: int = 65536  # noqa: N815


def _dense_row(text: Optional[str], key: str, prop: str,
               n_dense: int) -> List[Any]:
    """One bag's dense list, the reference's rule: a fast substring split
    of a well-formed ``"key": [..]`` value; anything unexpected (a
    scalar, a value the split cannot parse) falls back to a real JSON
    parse of the bag — never silently garbage.  Truncated to
    ``n_dense``, zero-padded to it."""
    d: Any = []
    if text and key in text:
        start = text.index(key) + len(key)
        rest = text[start:].lstrip()
        end = rest.find("]")
        if rest.startswith("[") and end > 0:
            seg = rest[1:end].strip()
            try:
                d = ([float(x) for x in seg.split(",")][:n_dense]
                     if seg else [])
            except ValueError:
                d = None
        else:
            d = None
        if d is None:
            v = json.loads(text).get(prop) or []
            d = list(v)[:n_dense] if isinstance(v, list) else []
    return list(d) + [0.0] * (n_dense - len(d))


class DLRMDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> CTRData:
        from predictionio_tpu_torch.data.columnar import (
            bool_property,
            encode_ids,
        )

        p: DataSourceParams = self.params
        table = ctx.event_store.find_columnar(
            p.appName, entity_type="user", target_entity_type="item",
            event_names=list(p.eventNames),
            ordered=False,
            columns=["entity_id", "target_entity_id", "properties"])
        if len(table["entity_id"]) == 0:
            raise ValueError("No impression events found — check appName.")
        # Hash only the UNIQUE ids, then index by dense codes — cost
        # scales with entities, not events.
        user_codes, user_index = encode_ids(table["entity_id"])
        item_codes, item_index = encode_ids(table["target_entity_id"])
        uhash = np.array([_hash(k, p.userVocab) for k in user_index],
                         np.int64)
        ihash = np.array([_hash(k, p.itemVocab) for k in item_index],
                         np.int64)
        cat = np.stack([uhash[user_codes], ihash[item_codes]], axis=1)
        labels = bool_property(table, p.labelProperty).astype(np.float32)
        # Dense feature lists are the one per-row parse left.  A mapping
        # bag (the memory store) is read as the JSON text the reference's
        # store would hand over, so both backends give its answer.
        key = '"%s":' % p.denseProperty
        dense_rows = [
            _dense_row(bag if bag is None or isinstance(bag, str)
                       else json.dumps(dict(bag)), key, p.denseProperty,
                       p.nDense)
            for bag in table["properties"]]
        return CTRData(
            dense=np.asarray(dense_rows, np.float32),
            cat=cat,
            labels=np.asarray(labels, np.float32),
            n_dense=p.nDense,
        )


@dataclasses.dataclass(frozen=True)
class DLRMAlgorithmParams(Params):
    embedDim: int = 16  # noqa: N815
    bottomMlp: Sequence[int] = (32, 16)  # noqa: N815
    topMlp: Sequence[int] = (32,)  # noqa: N815
    learningRate: float = 0.05  # noqa: N815
    batchSize: int = 512  # noqa: N815
    epochs: int = 3
    userVocab: int = 65536  # noqa: N815 — must match the datasource
    itemVocab: int = 65536  # noqa: N815
    seed: Optional[int] = None


@dataclasses.dataclass
class DLRMModelWrapper:
    """The train state (on the device it trained or serves on), its
    config, the vocabularies and the corpus size the warm start's
    delta-fraction gate reads (0 on a wrapper that does not know it).
    Pickled, the state is host numpy (:func:`~predictionio_tpu_torch.
    models.dlrm.state_to_host`); unpickled it lies on the CPU until a
    server's ``post_load`` moves it to its device."""

    state: dlrm_lib.DLRMState
    cfg: dlrm_lib.DLRMConfig
    user_vocab: int
    item_vocab: int
    n_dense: int
    n_examples: int = 0

    def __getstate__(self):
        d = self.__dict__.copy()
        d["state"] = dlrm_lib.state_to_host(self.state)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.state = dlrm_lib.state_from_host(d["state"], "cpu")

    def post_load(self, ctx: RuntimeContext) -> None:
        """Serving-time hook: the state moves to the server's device."""
        if ctx.device is not None:
            self.state = dlrm_lib.state_to(self.state, ctx.device)


class DLRMAlgorithm(Algorithm):
    params_class = DLRMAlgorithmParams

    def train(self, ctx: RuntimeContext,
              prepared_data: CTRData) -> DLRMModelWrapper:
        p: DLRMAlgorithmParams = self.params
        cfg = dlrm_lib.DLRMConfig(
            vocab_sizes=(p.userVocab, p.itemVocab),
            n_dense=prepared_data.n_dense,
            embed_dim=p.embedDim,
            bottom_mlp=tuple(p.bottomMlp),
            top_mlp=tuple(p.topMlp),
            learning_rate=p.learningRate,
            batch_size=p.batchSize,
            epochs=p.epochs,
            seed=p.seed if p.seed is not None else ctx.seed,
        )
        state = dlrm_lib.train(prepared_data.dense, prepared_data.cat,
                               prepared_data.labels, cfg, mesh=ctx.mesh,
                               device=ctx.device)
        return DLRMModelWrapper(state=state, cfg=cfg, user_vocab=p.userVocab,
                                item_vocab=p.itemVocab,
                                n_dense=prepared_data.n_dense,
                                n_examples=len(prepared_data.labels))

    @staticmethod
    def _sample_logloss(model_state, cfg, dense, cat, labels) -> float:
        proba = dlrm_lib.predict_proba(model_state, dense, cat, cfg)
        p = np.clip(proba.cpu().numpy().astype(np.float64), 1e-7,
                    1.0 - 1e-7)
        y = np.asarray(labels, np.float64)
        return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))

    def warm_start(self, ctx: RuntimeContext, prepared_delta: CTRData,
                   prev_model: DLRMModelWrapper,
                   warm: Any) -> DLRMModelWrapper:
        """Delta warm start: the hashed vocabularies are fixed-size, so
        continuation is just more optimizer steps on the delta window
        from the carried state — unseen entities already land in shared
        hash buckets.  Gates: config compatibility, delta fraction, and
        a log-loss regression check on a fixed delta sample."""
        log = logging.getLogger(__name__)
        p: DLRMAlgorithmParams = self.params
        prev_n = int(getattr(prev_model, "n_examples", 0))
        delta_n = len(prepared_delta.labels)
        cfg = prev_model.cfg
        seed_now = p.seed if p.seed is not None else ctx.seed
        if (cfg.vocab_sizes != (p.userVocab, p.itemVocab)
                or cfg.n_dense != prepared_delta.n_dense
                or cfg.embed_dim != p.embedDim
                or cfg.bottom_mlp != tuple(p.bottomMlp)
                or cfg.top_mlp != tuple(p.topMlp)
                or cfg.learning_rate != p.learningRate
                or cfg.batch_size != p.batchSize
                or cfg.seed != seed_now):
            raise WarmStartFallback("algorithm config changed")
        max_frac = getattr(warm, "max_delta_fraction", 0.5)
        if prev_n <= 0 or delta_n > max_frac * prev_n:
            raise WarmStartFallback(
                f"delta window too large for continuation ({delta_n} "
                f"events vs {prev_n} trained; max fraction {max_frac:g})")
        if delta_n == 0:
            return DLRMModelWrapper(state=prev_model.state, cfg=cfg,
                                    user_vocab=p.userVocab,
                                    item_vocab=p.itemVocab,
                                    n_dense=prepared_delta.n_dense,
                                    n_examples=prev_n)
        cfg = dataclasses.replace(cfg, epochs=p.epochs)
        rng = np.random.default_rng(cfg.seed)
        sample = rng.choice(delta_n, size=min(delta_n, 1024), replace=False)
        sd, sc, sy = (prepared_delta.dense[sample],
                      prepared_delta.cat[sample],
                      prepared_delta.labels[sample])
        loss_before = self._sample_logloss(prev_model.state, cfg, sd, sc, sy)
        # The loop copies the carried state onto ctx.device and never
        # changes it: prev_model keeps serving, and is the baseline above.
        state = dlrm_lib.train(prepared_delta.dense, prepared_delta.cat,
                               prepared_delta.labels, cfg,
                               mesh=ctx.mesh, warm_state=prev_model.state,
                               device=ctx.device)
        loss_after = self._sample_logloss(state, cfg, sd, sc, sy)
        tol = getattr(warm, "eval_tolerance", 0.1)
        if not np.isfinite(loss_after) \
                or loss_after > loss_before * (1.0 + tol) + 1e-9:
            raise WarmStartFallback(
                f"warm-started eval regressed on the delta sample "
                f"({loss_before:.4f} → {loss_after:.4f}, tolerance {tol:g})")
        log.info("dlrm warm-start: +%d events, delta-sample logloss "
                 "%.4f → %.4f", delta_n, loss_before, loss_after)
        return DLRMModelWrapper(state=state, cfg=cfg, user_vocab=p.userVocab,
                                item_vocab=p.itemVocab,
                                n_dense=prepared_delta.n_dense,
                                n_examples=prev_n + delta_n)

    def predict(self, model: DLRMModelWrapper,
                query: Query) -> PredictedResult:
        if not query.items:
            return PredictedResult(itemScores=[])
        n = len(query.items)
        d = list(query.dense or [])[: model.n_dense]
        d += [0.0] * (model.n_dense - len(d))
        dense = np.tile(np.asarray(d, np.float32)[None, :], (n, 1))
        cat = np.stack([
            np.full(n, _hash(query.user, model.user_vocab), np.int64),
            np.array([_hash(i, model.item_vocab) for i in query.items],
                     np.int64),
        ], axis=1)
        proba = dlrm_lib.predict_proba(model.state, dense, cat,
                                       model.cfg).cpu().numpy()
        order = np.argsort(-proba)
        return PredictedResult(itemScores=[
            ItemScore(item=query.items[int(i)], score=float(proba[i]))
            for i in order])


def engine() -> Engine:
    return Engine(
        datasource_class=DLRMDataSource,
        preparator_class=IdentityPreparator,
        algorithm_classes={"dlrm": DLRMAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
