"""Softmax / logistic regression — full-batch Adam training.

Port of ``predictionio_tpu/models/linear.py`` (reference: Spark MLlib
logistic regression behind the classification template).  The whole
dataset lives on one device (the card unless the caller passes
``device="cpu"``) and each step is one full-batch forward/backward
through autograd.  The loss is the reference's: softmax cross entropy
weighted by sample plus ``reg·Σw²``, from zero init.  The update is
``optax.adam``'s (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), written out
so that its order of operations is optax's.  ``mesh`` must be None
(ROADMAP Queue 1 item 10b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device

__all__ = ["LogisticRegressionConfig", "LogisticRegressionModel", "train",
           "predict_proba"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class LogisticRegressionConfig:
    n_classes: int
    reg: float = 0.0            # L2 (MLlib regParam)
    learning_rate: float = 0.1
    steps: int = 200
    seed: int = 0
    standardize: bool = True    # MLlib standardizes features by default


@dataclasses.dataclass
class LogisticRegressionModel:
    weights: torch.Tensor   # [D, C]
    bias: torch.Tensor      # [C]
    mean: torch.Tensor      # [D] feature standardization
    scale: torch.Tensor     # [D]

    def to(self, device) -> "LogisticRegressionModel":
        """The same model with every tensor on ``device``."""
        return LogisticRegressionModel(
            *(t.to(device) for t in (self.weights, self.bias, self.mean,
                                     self.scale)))


def _loss(w, b, x, y_onehot, w_sample, reg):
    logp = torch.log_softmax(x @ w + b, dim=-1)
    ll = -(y_onehot * logp).sum(dim=-1)
    data = (ll * w_sample).sum() / w_sample.sum().clamp(min=1.0)
    return data + reg * (w ** 2).sum()


def _adam(params, grads, mu, nu, t: int, lr: float) -> None:
    """One ``optax.adam`` step, in place: the moments, their bias
    corrections, then ``p -= lr · m̂ / (√v̂ + eps)``."""
    for p, g, m, v in zip(params, grads, mu, nu):
        m.mul_(_B1).add_(g, alpha=1 - _B1)
        v.mul_(_B2).add_(g * g, alpha=1 - _B2)
        m_hat = m / (1 - _B1 ** t)
        v_hat = v / (1 - _B2 ** t)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + _EPS))


def train(x: np.ndarray, y: np.ndarray, cfg: LogisticRegressionConfig,
          mesh=None, sample_weight: Optional[np.ndarray] = None, *,
          device=None) -> LogisticRegressionModel:
    """``cfg.steps`` full-batch Adam steps at ``cfg.learning_rate`` on
    standardized features (constant features keep scale 1)."""
    if mesh is not None:
        raise NotImplementedError(
            "logistic regression on a device mesh (the put_sharded "
            "batches) is not ported yet (ROADMAP Queue 1 item 10b); pass "
            "mesh=None")
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if cfg.standardize:
        mean = x.mean(axis=0)
        scale = x.std(axis=0)
        scale = np.where(scale < 1e-8, 1.0, scale)
    else:
        mean = np.zeros(d, np.float32)
        scale = np.ones(d, np.float32)
    xs = torch.as_tensor((x - mean) / scale, device=dev)
    y_onehot = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(y, np.int64), device=dev),
        cfg.n_classes).to(torch.float32)
    w_sample = torch.as_tensor(
        np.asarray(sample_weight, np.float32) if sample_weight is not None
        else np.ones(n, np.float32), device=dev)
    w = torch.zeros((d, cfg.n_classes), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((cfg.n_classes,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    mu = [torch.zeros_like(w), torch.zeros_like(b)]
    nu = [torch.zeros_like(w), torch.zeros_like(b)]
    reg = float(cfg.reg)
    for t in range(1, int(cfg.steps) + 1):
        loss = _loss(w, b, xs, y_onehot, w_sample, reg)
        grads = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            _adam((w, b), grads, mu, nu, t, float(cfg.learning_rate))
    return LogisticRegressionModel(
        weights=w.detach(), bias=b.detach(),
        mean=torch.as_tensor(mean, dtype=torch.float32, device=dev),
        scale=torch.as_tensor(scale, dtype=torch.float32, device=dev))


def predict_proba(model: LogisticRegressionModel, x) -> torch.Tensor:
    """[B, C] class probabilities, on the model's device."""
    x = torch.as_tensor(x, dtype=torch.float32, device=model.weights.device)
    xs = (x - model.mean) / model.scale
    return torch.softmax(xs @ model.weights + model.bias, dim=-1)
