"""Gaussian / multinomial naive Bayes — one-pass sufficient statistics.

Port of ``predictionio_tpu/models/naive_bayes.py`` (reference: Spark
MLlib ``NaiveBayes.train`` as the classification template calls it).
The per-class counts are one-hot products on the device the caller
names (the card unless it passes ``device="cpu"``); the model keeps
float32 tensors on that device.  With a ``mesh`` the rows are sharded
over ``data`` (which must divide their count): each shard computes its
counts on its own device, and the shards' counts add in shard order
(:func:`~predictionio_tpu_torch.parallel.compat.psum`, the reference's
``psum``) on the first shard's device, where the model is kept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.parallel.compat import (
    axis_lane,
    check_gang,
    psum,
)
from predictionio_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    PartitionSpec,
    put_sharded,
)

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


def _sums(x, y, n_classes: int, mesh, device, squares: bool):
    """The per-class row counts and feature sums (and sums of squares
    with ``squares``) of ``x`` by label ``y``: on ``device``, or a shard
    of the ``data`` axis each, added in shard order."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(y, np.int64)), n_classes).to(torch.float32)

    def stats(xt, yt):
        out = [yt.sum(dim=0), yt.T @ xt]
        if squares:
            out.append(yt.T @ (xt * xt))
        return out

    if mesh is None:
        dev = resolve_device(device)
        return stats(x.to(dev), onehot.to(dev))
    spec = PartitionSpec(AXIS_DATA)
    xs, ys = put_sharded(x, mesh, spec), put_sharded(onehot, mesh, spec)
    check_gang(mesh, AXIS_DATA)
    parts = [stats(xs.block(p), ys.block(p))
             for p in axis_lane(mesh, AXIS_DATA) if xs.shards[p] is not None]
    dev = parts[0][0].device
    return [psum([pt[j] for pt in parts], mesh, device=dev)
            for j in range(len(parts[0]))]


def train_multinomial(x: np.ndarray, y: np.ndarray, n_classes: int, *,
                      alpha: float = 1.0, mesh=None, device=None
                      ) -> NaiveBayesModel:
    """MLlib-parity multinomial NB with Laplace smoothing ``alpha``."""
    class_count, feat_count = _sums(x, y, n_classes, mesh, device,
                                    squares=False)
    log_prior = torch.log(class_count) - torch.log(class_count.sum())
    smoothed = feat_count + alpha
    log_prob = torch.log(smoothed) - torch.log(
        smoothed.sum(dim=1, keepdim=True))
    return NaiveBayesModel(kind="multinomial", class_log_prior=log_prior,
                           feature_log_prob=log_prob)


def train_gaussian(x: np.ndarray, y: np.ndarray, n_classes: int, *,
                   var_smoothing: float = 1e-6, mesh=None, device=None
                   ) -> NaiveBayesModel:
    n, s1, s2 = _sums(x, y, n_classes, mesh, device, squares=True)
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
