"""Controller API — the engine SDK (DASE) and its evaluation metrics,
port of ``predictionio_tpu.controller``."""

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    PersistentModel,
    Preparator,
    RuntimeContext,
    Serving,
    WarmStartFallback,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    EngineVariant,
    load_engine_factory,
)
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    EngineParamsGenerator,
    Evaluation,
    Metric,
    MetricEvaluatorResult,
    OptionAverageMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsBindingError,
    bind_params,
    params_to_dict,
)

__all__ = [
    "Algorithm",
    "AverageMetric",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "EngineParamsGenerator",
    "EngineVariant",
    "Evaluation",
    "FirstServing",
    "IdentityPreparator",
    "Metric",
    "MetricEvaluatorResult",
    "OptionAverageMetric",
    "Params",
    "ParamsBindingError",
    "PersistentModel",
    "Preparator",
    "RuntimeContext",
    "Serving",
    "SumMetric",
    "WarmStartFallback",
    "ZeroMetric",
    "bind_params",
    "load_engine_factory",
    "params_to_dict",
]
