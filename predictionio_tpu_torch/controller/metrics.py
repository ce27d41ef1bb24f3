"""Evaluation metrics and the Evaluation / EngineParamsGenerator contracts.

Port of ``predictionio_tpu/controller/metrics.py`` (reference:
core/.../controller/Metric.scala — AverageMetric, OptionAverageMetric,
SumMetric — Evaluation.scala, MetricEvaluator.scala,
EngineParamsGenerator.scala).
"""

from __future__ import annotations

import abc
import dataclasses
import json
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

__all__ = [
    "Metric",
    "AverageMetric",
    "OptionAverageMetric",
    "SumMetric",
    "ZeroMetric",
    "Evaluation",
    "EngineParamsGenerator",
    "MetricEvaluatorResult",
]

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")


class Metric(Generic[EI, Q, P, A], abc.ABC):
    """Reference: Metric — scores a full eval data set.

    ``eval_data``: folds of (eval_info, [(query, predicted, actual)]).
    Higher is better by default (reference: Ordering on the result).
    """

    @abc.abstractmethod
    def calculate(self, eval_data: Sequence[Tuple[EI, List[Tuple[Q, P, A]]]]) -> float: ...

    def compare(self, a: float, b: float) -> int:
        return (a > b) - (a < b)

    @property
    def header(self) -> str:
        return type(self).__name__


class AverageMetric(Metric[EI, Q, P, A]):
    """Mean of a per-(q,p,a) score over all folds (reference: AverageMetric)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A) -> float: ...

    def calculate(self, eval_data) -> float:
        scores = [
            self.calculate_one(q, p, a)
            for _, qpa in eval_data
            for q, p, a in qpa
        ]
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(Metric[EI, Q, P, A]):
    """Mean over non-None per-row scores (reference: OptionAverageMetric)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A) -> Optional[float]: ...

    def calculate(self, eval_data) -> float:
        scores = [
            s
            for _, qpa in eval_data
            for q, p, a in qpa
            if (s := self.calculate_one(q, p, a)) is not None
        ]
        return sum(scores) / len(scores) if scores else float("nan")


class SumMetric(Metric[EI, Q, P, A]):
    """Sum of per-row scores (reference: SumMetric)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A) -> float: ...

    def calculate(self, eval_data) -> float:
        return sum(
            self.calculate_one(q, p, a) for _, qpa in eval_data for q, p, a in qpa
        )


class ZeroMetric(Metric):
    """Reference: ZeroMetric — placeholder that always scores 0."""

    def calculate(self, eval_data) -> float:
        return 0.0


@dataclasses.dataclass
class Evaluation:
    """Reference: Evaluation — pairs an Engine with metric(s).

    ``engine_factory`` is kept as the dotted string so eval runs are
    reproducible from metadata alone (like the reference's class names in
    EvaluationInstance rows).
    """

    engine: Any                      # controller.Engine
    metric: Metric
    other_metrics: Sequence[Metric] = ()

    @property
    def metrics(self) -> List[Metric]:
        return [self.metric, *self.other_metrics]


class EngineParamsGenerator(abc.ABC):
    """Reference: EngineParamsGenerator — the sweep candidates."""

    @property
    @abc.abstractmethod
    def engine_params_list(self) -> Sequence[Any]: ...


@dataclasses.dataclass
class MetricEvaluatorResult:
    """Reference: MetricEvaluator.Result — best params + per-candidate scores."""

    best_score: float
    best_engine_params: Any
    best_index: int
    metric_header: str
    other_metric_headers: List[str]
    candidate_scores: List[Tuple[Any, float, List[float]]]  # (params, score, others)

    def summary(self) -> str:
        lines = [
            "MetricEvaluatorResult:",
            f"  # engine params evaluated: {len(self.candidate_scores)}",
            f"Optimal Engine Params (index {self.best_index}):",
        ]
        lines.append(
            "  " + json.dumps(self.best_engine_params.to_json_dict(), indent=2).replace("\n", "\n  ")
        )
        lines.append("Metrics:")
        lines.append(f"  {self.metric_header}: {self.best_score}")
        for h, s in zip(self.other_metric_headers,
                        self.candidate_scores[self.best_index][2]):
            lines.append(f"  {h}: {s}")
        return "\n".join(lines)
