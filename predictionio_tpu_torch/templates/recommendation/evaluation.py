"""Recommendation evaluation — Precision@K / Recall@K sweep over rank.

Port of ``predictionio_tpu/templates/recommendation/evaluation.py``
(reference: the template's Evaluation.scala variants): ranking metrics
over held-out positives through ``pio eval``, as OptionAverageMetrics
(users with no held-out positives are skipped, not scored 0).
"""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller import (
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    OptionAverageMetric,
)
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
    PredictedResult,
    Query,
    engine,
)

__all__ = ["PrecisionAtK", "RecallAtK", "RecommendationEvaluation",
           "evaluation", "default_params_generator", "ParamsList"]


class PrecisionAtK(OptionAverageMetric):
    def __init__(self, k: int = 10):
        self.k = k

    def calculate_one(self, query: Query, predicted: PredictedResult,
                      actual: Sequence[str]):
        if not actual:
            return None  # reference: OptionAverageMetric skips empty actuals
        top = [s.item for s in predicted.itemScores[: self.k]]
        if not top:
            return 0.0
        return len(set(top) & set(actual)) / min(self.k, len(top))

    @property
    def header(self) -> str:
        return f"Precision@{self.k}"


class RecallAtK(OptionAverageMetric):
    def __init__(self, k: int = 10):
        self.k = k

    def calculate_one(self, query: Query, predicted: PredictedResult,
                      actual: Sequence[str]):
        if not actual:
            return None
        top = [s.item for s in predicted.itemScores[: self.k]]
        return len(set(top) & set(actual)) / len(actual)

    @property
    def header(self) -> str:
        return f"Recall@{self.k}"


class ParamsList(EngineParamsGenerator):
    def __init__(self, candidates):
        self._candidates = list(candidates)

    @property
    def engine_params_list(self):
        return self._candidates


def default_params_generator(app_name: str = "testapp", eval_k: int = 2,
                             ranks: Sequence[int] = (8, 16),
                             implicit: bool = True,
                             alpha: float = 10.0) -> ParamsList:
    """Candidates sweep rank; implicit by default — ranking metrics are
    meaningless for explicit MF on near-uniform ratings (it fits values,
    not preferences)."""
    ds = DataSourceParams(appName=app_name, evalK=eval_k)
    return ParamsList([
        EngineParams(
            datasource_params=ds,
            algorithms_params=(
                ("als", ALSAlgorithmParams(rank=r, implicitPrefs=implicit,
                                           alpha=alpha)),),
        )
        for r in ranks
    ])


class RecommendationEvaluation(Evaluation):
    def __init__(self, k: int = 10):
        super().__init__(engine=engine(), metric=PrecisionAtK(k),
                         other_metrics=[RecallAtK(k)])


def evaluation() -> RecommendationEvaluation:
    return RecommendationEvaluation()
