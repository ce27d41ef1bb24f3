from predictionio_tpu_torch.templates.similarproduct.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    SimilarProductDataSource,
    SimilarProductModel,
    ViewData,
    engine,
    model_from_numpy,
)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "DataSourceParams",
    "ItemScore",
    "PredictedResult",
    "Query",
    "SimilarProductDataSource",
    "SimilarProductModel",
    "ViewData",
    "engine",
    "model_from_numpy",
]
