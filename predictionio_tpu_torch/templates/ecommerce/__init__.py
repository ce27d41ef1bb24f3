from predictionio_tpu_torch.templates.ecommerce.engine import (
    DataSourceParams,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommerceDataSource,
    ECommModel,
    ItemScore,
    PredictedResult,
    Query,
    TrainingData,
    engine,
    model_from_numpy,
)

__all__ = [
    "DataSourceParams",
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommerceDataSource",
    "ECommModel",
    "ItemScore",
    "PredictedResult",
    "Query",
    "TrainingData",
    "engine",
    "model_from_numpy",
]
