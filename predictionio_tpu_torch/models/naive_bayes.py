"""Gaussian / multinomial naive Bayes — one-pass sufficient statistics.

Port of ``predictionio_tpu/models/naive_bayes.py`` (reference: Spark
MLlib ``NaiveBayes.train`` as the classification template calls it).
The per-class counts are one-hot products on the device the caller
names (the card unless it passes ``device="cpu"``); the model keeps
float32 tensors on that device.  One process and one device: ``mesh``
must be None.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device

__all__ = ["NaiveBayesModel", "train_multinomial", "train_gaussian",
           "predict_log_proba"]


@dataclasses.dataclass
class NaiveBayesModel:
    kind: str                        # "multinomial" | "gaussian"
    class_log_prior: torch.Tensor    # [C]
    # multinomial: feature log-likelihoods [C, D]
    # gaussian: means [C, D] and variances [C, D]
    feature_log_prob: Optional[torch.Tensor] = None
    means: Optional[torch.Tensor] = None
    variances: Optional[torch.Tensor] = None

    def to(self, device) -> "NaiveBayesModel":
        """The same model with every tensor on ``device``."""
        def move(t):
            return None if t is None else t.to(device)

        return NaiveBayesModel(
            kind=self.kind, class_log_prior=move(self.class_log_prior),
            feature_log_prob=move(self.feature_log_prob),
            means=move(self.means), variances=move(self.variances))


def _inputs(x, y, n_classes: int, mesh, device):
    if mesh is not None:
        raise NotImplementedError("naive Bayes on a device mesh is not "
                                  "ported yet; pass mesh=None")
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    onehot = torch.nn.functional.one_hot(yt, n_classes).to(torch.float32)
    return xt, onehot


def train_multinomial(x: np.ndarray, y: np.ndarray, n_classes: int, *,
                      alpha: float = 1.0, mesh=None, device=None
                      ) -> NaiveBayesModel:
    """MLlib-parity multinomial NB with Laplace smoothing ``alpha``."""
    xt, onehot = _inputs(x, y, n_classes, mesh, device)
    class_count = onehot.sum(dim=0)                          # [C]
    feat_count = onehot.T @ xt                               # [C, D]
    log_prior = torch.log(class_count) - torch.log(class_count.sum())
    smoothed = feat_count + alpha
    log_prob = torch.log(smoothed) - torch.log(
        smoothed.sum(dim=1, keepdim=True))
    return NaiveBayesModel(kind="multinomial", class_log_prior=log_prior,
                           feature_log_prob=log_prob)


def train_gaussian(x: np.ndarray, y: np.ndarray, n_classes: int, *,
                   var_smoothing: float = 1e-6, mesh=None, device=None
                   ) -> NaiveBayesModel:
    xt, onehot = _inputs(x, y, n_classes, mesh, device)
    n = onehot.sum(dim=0)
    s1 = onehot.T @ xt
    s2 = onehot.T @ (xt * xt)
    n_safe = n.clamp(min=1.0)[:, None]
    means = s1 / n_safe
    variances = (s2 / n_safe - means ** 2).clamp(min=0.0) + var_smoothing
    log_prior = torch.log(n.clamp(min=1e-12)) - torch.log(n.sum())
    return NaiveBayesModel(kind="gaussian", class_log_prior=log_prior,
                           means=means, variances=variances)


def predict_log_proba(model: NaiveBayesModel, x: torch.Tensor
                      ) -> torch.Tensor:
    """[B, C] unnormalized class log-posteriors, on the model's device."""
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=model.class_log_prior.device)
    if model.kind == "multinomial":
        return model.class_log_prior[None, :] + x @ model.feature_log_prob.T
    ll = -0.5 * (
        torch.log(2 * math.pi * model.variances)[None, :, :]
        + (x[:, None, :] - model.means[None, :, :]) ** 2
        / model.variances[None, :, :]
    ).sum(dim=-1)
    return model.class_log_prior[None, :] + ll
