"""Engine: the assembled DASE pipeline + engine.json variant parsing.

Counterpart of ``predictionio_tpu/controller/engine.py``; the engine.json
schema is the reference's, verbatim::

    {"id"?, "description"?, "engineFactory",
     "datasource": {"params": {...}},
     "preparator": {"params": {...}},
     "algorithms": [{"name": ..., "params": {...}}, ...],
     "serving": {"params": {...}}}

:meth:`Engine.train` drives DataSource → Preparator → each Algorithm;
the eval drive arrives with the evaluation slice.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
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

    def train(self, ctx: RuntimeContext,
              engine_params: EngineParams) -> List[Any]:
        """Run DataSource → Preparator → each Algorithm.train; returns the
        models (reference: Engine.train).  Each stage's wall time lands
        in ``pio_train_phase_ms{phase}``."""
        from predictionio_tpu_torch.obs import phase

        datasource = self.datasource_class(engine_params.datasource_params)
        preparator = self.preparator_class(engine_params.preparator_params)
        with phase("train.datasource"):
            td = datasource.read_training(ctx)
        with phase("train.prepare"):
            pd = preparator.prepare(ctx, td)
        models = []
        for algo in self.make_algorithms(engine_params):
            with phase("train.algorithm"):
                models.append(algo.train(ctx, pd))
        return models


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
