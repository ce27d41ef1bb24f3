"""Classification template — attribute → label prediction.

Port of ``predictionio_tpu/templates/classification/engine.py``
(reference: scala-parallel-classification): ``$set`` events on "user"
entities carry numeric attributes (``attr0``, ``attr1``, ``attr2``) and
a label property (``plan``); naive Bayes or logistic regression learns
label | attrs.  The contract is the reference's:

- query JSON: ``{"attr0": 2.0, "attr1": 0.0, "attr2": 1.0}``
- result JSON: ``{"label": 2.0}``
- ``$set`` aggregation semantics: the latest property value per entity
  wins, and entities missing an attribute or the label are skipped

Both algorithms train and predict with tensors on ``ctx.device`` (the
card unless the caller asks for the CPU): :mod:`models.naive_bayes` and
:mod:`models.linear`; with ``ctx.mesh`` (``pio train --mesh data=N``)
both shard the rows over ``data`` and join the shards' sums in shard
order.  The pickled wrappers hold CPU copies; a server's
``post_load`` moves them to its device.  A model trained elsewhere is
carried in with :func:`model_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    RuntimeContext,
)
from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.models import linear as lr_lib
from predictionio_tpu_torch.models import naive_bayes as nb_lib

__all__ = [
    "Query", "PredictedResult", "LabeledData", "DataSourceParams",
    "ClassificationDataSource", "NaiveBayesAlgorithmParams",
    "NaiveBayesAlgorithm", "NBModelWrapper", "LRAlgorithmParams",
    "LRAlgorithm", "LRModelWrapper", "model_from_numpy", "engine",
]


@dataclasses.dataclass
class Query:
    attr0: float = 0.0
    attr1: float = 0.0
    attr2: float = 0.0

    def vector(self, attrs: Sequence[str]) -> np.ndarray:
        return np.array([getattr(self, a, 0.0) for a in attrs], np.float32)


@dataclasses.dataclass
class PredictedResult:
    label: float


@dataclasses.dataclass
class LabeledData:
    """Dense feature matrix + integer labels + the label decode table."""

    x: np.ndarray            # [N, D] float32
    y: np.ndarray            # [N] int64 — indices into `classes`
    classes: np.ndarray      # [C] original label values (float)
    attrs: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815
    entityType: str = "user"  # noqa: N815
    attrs: Sequence[str] = ("attr0", "attr1", "attr2")
    labelAttr: str = "plan"  # noqa: N815
    evalK: Optional[int] = None  # noqa: N815
    seed: int = 3


class ClassificationDataSource(DataSource):
    """Aggregates ``$set`` properties into (attrs, label) rows, one per
    entity in entity-id order (reference: DataSource.scala,
    ``PEventStore.aggregateProperties`` with required fields)."""

    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> LabeledData:
        p: DataSourceParams = self.params
        required = list(p.attrs) + [p.labelAttr]
        props = ctx.event_store.aggregate_properties(
            p.appName, p.entityType, required=required)
        xs, labels = [], []
        for _entity, pm in sorted(props.items()):
            xs.append([float(pm.get(a)) for a in p.attrs])
            labels.append(float(pm.get(p.labelAttr)))
        if not xs:
            raise ValueError(
                f"No entities with properties {required} found in app "
                f"{p.appName!r} (reference template raises the same).")
        x = np.asarray(xs, np.float32)
        label_arr = np.asarray(labels, np.float32)
        classes = np.unique(label_arr)
        y = np.searchsorted(classes, label_arr)
        return LabeledData(x=x, y=y, classes=classes, attrs=tuple(p.attrs))

    def read_eval(self, ctx: RuntimeContext):
        """``evalK`` folds, one drawn per entity from ``seed``
        (``np.random.default_rng``, the reference's draw)."""
        p: DataSourceParams = self.params
        if not p.evalK:
            return []
        data = self.read_training(ctx)
        rng = np.random.default_rng(p.seed)
        fold_of = rng.integers(0, p.evalK, len(data.y))
        folds = []
        for k in range(p.evalK):
            tr = fold_of != k
            te = ~tr
            td = LabeledData(x=data.x[tr], y=data.y[tr], classes=data.classes,
                             attrs=data.attrs)
            qa = [
                (Query(**{a: float(v) for a, v in zip(data.attrs, row)}),
                 float(data.classes[lbl]))
                for row, lbl in zip(data.x[te], data.y[te])
            ]
            folds.append((td, None, qa))
        return folds


class _Wrapper:
    """Shared serving state of the two wrappers: the model's tensors
    live on ``_device``; the pickle holds a CPU copy."""

    model: Any
    classes: np.ndarray
    attrs: Tuple[str, ...]

    def __getstate__(self):
        d = self.__dict__.copy()
        d["model"] = self.model.to("cpu")
        d.pop("_device", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._device = torch.device("cpu")

    def post_load(self, ctx: RuntimeContext) -> None:
        """Serving-time hook: move the model to the server's device."""
        self._device = ctx.device
        self.model = self.model.to(ctx.device)

    def features(self, queries: Sequence[Query]) -> torch.Tensor:
        x = np.stack([q.vector(self.attrs) for q in queries])
        return torch.as_tensor(x, device=self._device)

    def labels(self, scores: torch.Tensor) -> np.ndarray:
        """The label of each row's highest score (first on a tie)."""
        return self.classes[scores.argmax(dim=1).cpu().numpy()]


@dataclasses.dataclass(frozen=True)
class NaiveBayesAlgorithmParams(Params):
    lambda_: float = 1.0      # Laplace smoothing (reference NB param "lambda")
    modelType: str = "multinomial"  # noqa: N815 — or "gaussian"


@dataclasses.dataclass(eq=False)
class NBModelWrapper(_Wrapper):
    model: nb_lib.NaiveBayesModel
    classes: np.ndarray
    attrs: Tuple[str, ...]

    def __post_init__(self):
        self._device = self.model.class_log_prior.device


class NaiveBayesAlgorithm(Algorithm):
    params_class = NaiveBayesAlgorithmParams

    def train(self, ctx: RuntimeContext,
              prepared_data: LabeledData) -> NBModelWrapper:
        p: NaiveBayesAlgorithmParams = self.params
        if p.modelType == "gaussian":
            model = nb_lib.train_gaussian(
                prepared_data.x, prepared_data.y, len(prepared_data.classes),
                mesh=ctx.mesh, device=ctx.device)
        else:
            model = nb_lib.train_multinomial(
                prepared_data.x, prepared_data.y, len(prepared_data.classes),
                alpha=p.lambda_, mesh=ctx.mesh, device=ctx.device)
        return NBModelWrapper(model=model, classes=prepared_data.classes,
                              attrs=prepared_data.attrs)

    def predict(self, model: NBModelWrapper,
                query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: NBModelWrapper, queries):
        lp = nb_lib.predict_log_proba(model.model,
                                      model.features([q for _, q in queries]))
        return [(i, PredictedResult(label=float(label)))
                for (i, _), label in zip(queries, model.labels(lp))]


@dataclasses.dataclass(frozen=True)
class LRAlgorithmParams(Params):
    regParam: float = 0.0  # noqa: N815 — MLlib knob names
    maxIter: int = 200  # noqa: N815
    stepSize: float = 0.1  # noqa: N815
    seed: int = 0


@dataclasses.dataclass(eq=False)
class LRModelWrapper(_Wrapper):
    model: lr_lib.LogisticRegressionModel
    classes: np.ndarray
    attrs: Tuple[str, ...]

    def __post_init__(self):
        self._device = self.model.weights.device


class LRAlgorithm(Algorithm):
    params_class = LRAlgorithmParams

    def train(self, ctx: RuntimeContext,
              prepared_data: LabeledData) -> LRModelWrapper:
        p: LRAlgorithmParams = self.params
        cfg = lr_lib.LogisticRegressionConfig(
            n_classes=len(prepared_data.classes), reg=p.regParam,
            learning_rate=p.stepSize, steps=p.maxIter, seed=p.seed)
        model = lr_lib.train(prepared_data.x, prepared_data.y, cfg,
                             mesh=ctx.mesh, device=ctx.device)
        return LRModelWrapper(model=model, classes=prepared_data.classes,
                              attrs=prepared_data.attrs)

    def predict(self, model: LRModelWrapper,
                query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: LRModelWrapper, queries):
        proba = lr_lib.predict_proba(model.model,
                                     model.features([q for _, q in queries]))
        return [(i, PredictedResult(label=float(label)))
                for (i, _), label in zip(queries, model.labels(proba))]


def model_from_numpy(model: Mapping[str, Any], classes,
                     attrs: Sequence[str] = ("attr0", "attr1", "attr2"),
                     *, device=None
                     ) -> Union[NBModelWrapper, LRModelWrapper]:
    """Carry a trained classifier into the port: ``model`` maps the
    reference model's field names to numpy arrays (for example
    ``dataclasses.asdict`` of it) — ``weights``/``bias``/``mean``/
    ``scale`` for logistic regression, ``kind``/``class_log_prior`` and
    ``feature_log_prob`` or ``means``/``variances`` for naive Bayes —
    beside the label values of its classes and its attribute names."""
    from predictionio_tpu_torch.device import device as resolve_device

    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.array(a, np.float32), device=dev)

    classes = np.asarray(classes, np.float32)
    if "weights" in model:
        lr = lr_lib.LogisticRegressionModel(
            *(t(model[k]) for k in ("weights", "bias", "mean", "scale")))
        return LRModelWrapper(model=lr, classes=classes, attrs=tuple(attrs))
    nb = nb_lib.NaiveBayesModel(
        kind=str(model["kind"]), class_log_prior=t(model["class_log_prior"]),
        feature_log_prob=t(model.get("feature_log_prob")),
        means=t(model.get("means")), variances=t(model.get("variances")))
    return NBModelWrapper(model=nb, classes=classes, attrs=tuple(attrs))


def engine() -> Engine:
    """Reference: ClassificationEngine EngineFactory."""
    return Engine(
        datasource_class=ClassificationDataSource,
        preparator_class=IdentityPreparator,
        algorithm_classes={"naive": NaiveBayesAlgorithm, "lr": LRAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
