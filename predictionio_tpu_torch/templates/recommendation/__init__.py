from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModelWrapper,
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    Ratings,
    RecommendationDataSource,
    RecommendationPreparator,
    engine,
    wrapper_from_numpy,
)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "ALSModelWrapper",
    "DataSourceParams",
    "ItemScore",
    "PredictedResult",
    "Query",
    "Ratings",
    "RecommendationDataSource",
    "RecommendationPreparator",
    "engine",
    "wrapper_from_numpy",
]
