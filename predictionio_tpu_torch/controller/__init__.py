"""Controller API — the engine SDK (DASE), port of
``predictionio_tpu.controller``.  Evaluation metrics arrive with the
evaluation slice."""

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    PersistentModel,
    Preparator,
    RuntimeContext,
    Serving,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    EngineVariant,
    load_engine_factory,
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
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "EngineVariant",
    "FirstServing",
    "IdentityPreparator",
    "Params",
    "ParamsBindingError",
    "PersistentModel",
    "Preparator",
    "RuntimeContext",
    "Serving",
    "bind_params",
    "load_engine_factory",
    "params_to_dict",
]
