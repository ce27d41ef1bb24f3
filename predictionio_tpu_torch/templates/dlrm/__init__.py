from predictionio_tpu_torch.templates.dlrm.engine import (
    CTRData,
    DataSourceParams,
    DLRMAlgorithm,
    DLRMAlgorithmParams,
    DLRMDataSource,
    DLRMModelWrapper,
    ItemScore,
    PredictedResult,
    Query,
    engine,
)

__all__ = [
    "CTRData",
    "DataSourceParams",
    "DLRMAlgorithm",
    "DLRMAlgorithmParams",
    "DLRMDataSource",
    "DLRMModelWrapper",
    "ItemScore",
    "PredictedResult",
    "Query",
    "engine",
]
