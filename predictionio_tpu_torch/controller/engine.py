"""Engine: the assembled DASE pipeline + engine.json variant parsing.

Counterpart of ``predictionio_tpu/controller/engine.py``; the engine.json
schema is the reference's, verbatim::

    {"id"?, "description"?, "engineFactory",
     "datasource": {"params": {...}},
     "preparator": {"params": {...}},
     "algorithms": [{"name": ..., "params": {...}}, ...],
     "serving": {"params": {...}}}

:meth:`Engine.train` drives DataSource → Preparator → each Algorithm
(``Algorithm.warm_start`` on a delta window when it is given a warm
context);
:meth:`Engine.eval_multi` drives ``read_eval`` folds through each
candidate's algorithms and Serving (the reference's shared-prep sweep,
without its checkpoints).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Preparator,
    RuntimeContext,
    Serving,
    WarmStartFallback,
)
from predictionio_tpu_torch.controller.params import (
    Params,
    ParamsBindingError,
    bind_params,
    params_to_dict,
)

__all__ = ["Engine", "EngineParams", "EngineVariant", "load_engine_factory"]


@dataclasses.dataclass
class EngineParams:
    """One full parameterization of an engine (reference: EngineParams)."""

    datasource_params: Optional[Params] = None
    preparator_params: Optional[Params] = None
    algorithms_params: Sequence[Tuple[str, Optional[Params]]] = ()
    serving_params: Optional[Params] = None

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "datasource": {"params": params_to_dict(self.datasource_params)},
            "preparator": {"params": params_to_dict(self.preparator_params)},
            "algorithms": [
                {"name": name, "params": params_to_dict(p)}
                for name, p in self.algorithms_params
            ],
            "serving": {"params": params_to_dict(self.serving_params)},
        }


class Engine:
    """Binds DASE role classes into a servable pipeline.

    Reference: controller/Engine.scala — constructed by the user's
    EngineFactory with the datasource/preparator class, a named map of
    algorithm classes, and the serving class.
    """

    def __init__(
        self,
        datasource_class: Type[DataSource],
        preparator_class: Type[Preparator] = IdentityPreparator,
        algorithm_classes: Optional[Dict[str, Type[Algorithm]]] = None,
        serving_class: Type[Serving] = FirstServing,
        query_class: Optional[type] = None,
    ):
        self.datasource_class = datasource_class
        self.preparator_class = preparator_class
        self.algorithm_classes = dict(algorithm_classes or {})
        self.serving_class = serving_class
        # Query dataclass the deploy server binds request JSON to.
        self.query_class = query_class

    def bind_engine_params(self, variant_json: Dict[str, Any]) -> EngineParams:
        """Bind an engine.json variant's param blocks to typed Params."""

        def block(name: str) -> Dict[str, Any]:
            b = variant_json.get(name) or {}
            return b.get("params") or {}

        ds = bind_params(self.datasource_class.params_class, block("datasource"))
        prep = bind_params(self.preparator_class.params_class, block("preparator"))
        serving = bind_params(self.serving_class.params_class, block("serving"))
        algos: List[Tuple[str, Params]] = []
        specs = variant_json.get("algorithms")
        if specs is None:
            # Default: every registered algorithm with default params.
            specs = [{"name": n, "params": {}} for n in self.algorithm_classes]
        for spec in specs:
            name = spec.get("name")
            if name not in self.algorithm_classes:
                raise ParamsBindingError(
                    f"Unknown algorithm {name!r}; registered: "
                    f"{sorted(self.algorithm_classes)}"
                )
            cls = self.algorithm_classes[name]
            algos.append((name, bind_params(cls.params_class, spec.get("params") or {})))
        return EngineParams(
            datasource_params=ds,
            preparator_params=prep,
            algorithms_params=tuple(algos),
            serving_params=serving,
        )

    def make_algorithms(self, engine_params: EngineParams) -> List[Algorithm]:
        return [
            self.algorithm_classes[name](params)
            for name, params in engine_params.algorithms_params
        ]

    def make_serving(self, engine_params: EngineParams) -> Serving:
        return self.serving_class(engine_params.serving_params)

    def train(self, ctx: RuntimeContext, engine_params: EngineParams,
              warm: Any = None) -> List[Any]:
        """Run DataSource → Preparator → each Algorithm.train; returns the
        models (reference: Engine.train).  Each stage's wall time lands
        in ``pio_train_phase_ms{phase}``.

        With ``warm`` (a :class:`~predictionio_tpu_torch.refresh.
        WarmStartContext`), the datasource reads through the caller's
        delta-scoped event store and every algorithm continues its
        previous model via :meth:`Algorithm.warm_start`.  Any algorithm
        raising :class:`~predictionio_tpu_torch.controller.
        WarmStartFallback` aborts the WHOLE warm attempt (one generation
        is one consistent data window); ``run_train`` then retrains
        fully.
        """
        from predictionio_tpu_torch.obs import phase

        names = [n for n, _ in engine_params.algorithms_params]
        if warm is not None:
            if len(warm.models) != len(names):
                raise WarmStartFallback(
                    f"algorithm set changed ({len(warm.models)} previous "
                    f"model(s) vs {len(names)} configured)")
            # Decline BEFORE the datasource read: an engine whose
            # algorithms all use the declining default would otherwise
            # pay a full delta read and prepare every refresh cycle just
            # to be told no.
            if all(cls.warm_start is Algorithm.warm_start
                   for cls in self.algorithm_classes.values()):
                raise WarmStartFallback(
                    "no configured algorithm supports warm-start "
                    "continuation")
        datasource = self.datasource_class(engine_params.datasource_params)
        preparator = self.preparator_class(engine_params.preparator_params)
        with phase("train.datasource"):
            td = datasource.read_training(ctx)
        with phase("train.prepare"):
            pd = preparator.prepare(ctx, td)
        models = []
        for i, (name, algo) in enumerate(
                zip(names, self.make_algorithms(engine_params))):
            if warm is not None:
                with phase("train.algorithm.warm", algo=name):
                    models.append(
                        algo.warm_start(ctx, pd, warm.models[i], warm))
            else:
                with phase("train.algorithm", algo=name):
                    models.append(algo.train(ctx, pd))
        return models

    def eval(self, ctx: RuntimeContext, engine_params: EngineParams
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """K folds of (eval_info, [(query, predicted, actual)])
        (reference: Engine.eval): train on each fold's training split,
        batch-predict the fold's queries through Serving."""
        return self.eval_multi(ctx, [engine_params])[0]

    def eval_multi(self, ctx: RuntimeContext,
                   engine_params_list: Sequence[EngineParams]
                   ) -> List[List[Tuple[Any, List[Tuple[Any, Any, Any]]]]]:
        """Shared-prep candidate sweep (reference: ``eval_multi``):
        ``read_eval`` and ``Preparator.prepare`` run once per distinct
        (datasource, preparator) params, folds outer and candidates
        inner, so one prepared fold is live at a time.  Returns each
        candidate's folds, aligned with the input."""
        results: List[Any] = [None] * len(engine_params_list)
        groups: Dict[str, List[int]] = {}
        for i, ep in enumerate(engine_params_list):
            key = repr((ep.datasource_params, ep.preparator_params))
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            first = engine_params_list[idxs[0]]
            datasource = self.datasource_class(first.datasource_params)
            preparator = self.preparator_class(first.preparator_params)
            for ci in idxs:
                results[ci] = []
            for td, eval_info, qa in datasource.read_eval(ctx):
                pd = preparator.prepare(ctx, td)
                for ci in idxs:
                    engine_params = engine_params_list[ci]
                    serving = self.make_serving(engine_params)
                    algos = self.make_algorithms(engine_params)
                    models = [a.train(ctx, pd) for a in algos]
                    indexed = list(enumerate(q for q, _ in qa))
                    per_algo = [dict(_eval_batch_predict(a, m, indexed))
                                for a, m in zip(algos, models)]
                    qpa = [(q, serving.serve(q, [p[i] for p in per_algo]),
                            actual) for i, (q, actual) in enumerate(qa)]
                    results[ci].append((eval_info, qpa))
        return results


def _eval_chunk_size(default: int = 1024) -> int:
    """``PIO_EVAL_BATCH``: queries per eval ``batch_predict`` call (0
    means the whole fold in one call)."""
    try:
        return int(os.environ.get("PIO_EVAL_BATCH", str(default)))
    except ValueError:
        return default


def _eval_batch_predict(algo: Algorithm, model: Any,
                        indexed: Sequence[Tuple[int, Any]]):
    """A fold's queries through ``batch_predict`` in ``PIO_EVAL_BATCH``
    chunks, which bounds the score block of a large fold."""
    chunk = _eval_chunk_size()
    if chunk <= 0:
        chunk = max(len(indexed), 1)
    for start in range(0, len(indexed), chunk):
        yield from algo.batch_predict(model,
                                      list(indexed[start:start + chunk]))


@dataclasses.dataclass
class EngineVariant:
    """A parsed engine.json file (reference: engine variant manifest)."""

    engine_factory: str
    variant_id: str = "default"
    description: str = ""
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_file(path) -> "EngineVariant":
        raw = json.loads(Path(path).read_text())
        return EngineVariant.from_dict(raw)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "EngineVariant":
        if "engineFactory" not in raw:
            raise ParamsBindingError("engine.json must declare engineFactory.")
        return EngineVariant(
            engine_factory=raw["engineFactory"],
            variant_id=raw.get("id", "default"),
            description=raw.get("description", ""),
            raw=raw,
        )


def load_engine_factory(dotted: str):
    """Resolve an engineFactory string to a callable returning an Engine.

    Accepted forms: ``package.module:factory_fn`` or
    ``package.module.factory_fn``.
    """
    if ":" in dotted:
        mod_name, attr = dotted.split(":", 1)
    else:
        mod_name, _, attr = dotted.rpartition(".")
        if not mod_name:
            raise ParamsBindingError(f"Invalid engineFactory {dotted!r}.")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise ParamsBindingError(f"Cannot import engineFactory module {mod_name!r}: {e}") from e
    try:
        factory = getattr(mod, attr)
    except AttributeError:
        raise ParamsBindingError(
            f"Module {mod_name!r} has no attribute {attr!r} (engineFactory)."
        ) from None
    return factory
