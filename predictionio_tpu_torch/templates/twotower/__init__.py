from predictionio_tpu_torch.templates.twotower.engine import (
    DataSourceParams,
    InteractionData,
    ItemScore,
    PredictedResult,
    Query,
    TwoTowerAlgorithm,
    TwoTowerAlgorithmParams,
    TwoTowerDataSource,
    TwoTowerModelWrapper,
    engine,
    model_from_numpy,
)

__all__ = [
    "DataSourceParams",
    "InteractionData",
    "ItemScore",
    "PredictedResult",
    "Query",
    "TwoTowerAlgorithm",
    "TwoTowerAlgorithmParams",
    "TwoTowerDataSource",
    "TwoTowerModelWrapper",
    "engine",
    "model_from_numpy",
]
