"""Classification evaluation — Accuracy sweep over NB smoothing.

Port of ``predictionio_tpu/templates/classification/evaluation.py``
(reference: the template's Evaluation.scala + EngineParamsGenerator,
run through ``pio eval``).
"""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller import (
    AverageMetric,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_tpu_torch.templates.classification.engine import (
    DataSourceParams,
    NaiveBayesAlgorithmParams,
    PredictedResult,
    Query,
    engine,
)

__all__ = ["Accuracy", "AccuracyEvaluation", "evaluation",
           "default_params_generator", "ParamsList"]


class Accuracy(AverageMetric):
    """Reference: Accuracy extends AverageMetric — 1.0 on exact label match."""

    def calculate_one(self, query: Query, predicted: PredictedResult,
                      actual: float) -> float:
        return 1.0 if predicted.label == actual else 0.0

    @property
    def header(self) -> str:
        return "Accuracy"


class ParamsList(EngineParamsGenerator):
    def __init__(self, candidates: Sequence[EngineParams]):
        self._candidates = list(candidates)

    @property
    def engine_params_list(self):
        return self._candidates


def default_params_generator(app_name: str = "testapp", eval_k: int = 3,
                             lambdas: Sequence[float] = (0.5, 1.0, 5.0)
                             ) -> ParamsList:
    """Reference: EngineParamsList — one candidate per smoothing value."""
    ds = DataSourceParams(appName=app_name, evalK=eval_k)
    return ParamsList([
        EngineParams(
            datasource_params=ds,
            algorithms_params=(("naive",
                                NaiveBayesAlgorithmParams(lambda_=lam)),),
        )
        for lam in lambdas
    ])


class AccuracyEvaluation(Evaluation):
    def __init__(self):
        super().__init__(engine=engine(), metric=Accuracy())


def evaluation() -> AccuracyEvaluation:
    """Factory for ``pio eval
    predictionio_tpu_torch.templates.classification:evaluation ...``."""
    return AccuracyEvaluation()
