"""Softmax / logistic regression — full-batch Adam training.

Port of ``predictionio_tpu/models/linear.py`` (reference: Spark MLlib
logistic regression behind the classification template).  The whole
dataset lives on one device (the card unless the caller passes
``device="cpu"``) and each step is one full-batch forward/backward
through autograd.  The loss is the reference's: softmax cross entropy
weighted by sample plus ``reg·Σw²``, from zero init.  The update is
``optax.adam``'s (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), written out
so that its order of operations is optax's.

With a ``mesh`` the rows are sharded over ``data`` (which must divide
their count) and the weights replicated: each shard computes its weighted
loss sum on its own device, the sums add in shard order (the
reference's ``psum``), each replica's gradient is the sum of its
positions' in position order (:mod:`~predictionio_tpu_torch.parallel.
blocks`), and every replica takes the same Adam step.  The model is
returned on the first shard's device.  On a mesh that spans processes
(``data`` split over the gang) each process computes its shards' sums
and its replica of the loss; the sums and the replicas' gradients cross
processes in shard order, so every process returns one process's
model, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.parallel.blocks import (
    flat_blocks,
    grads_by_block,
    position_leaves,
)
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
        check_gang(mesh, AXIS_DATA)
    dev = resolve_device(device) if mesh is None else None
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if cfg.standardize:
        mean = x.mean(axis=0)
        scale = x.std(axis=0)
        scale = np.where(scale < 1e-8, 1.0, scale)
    else:
        mean = np.zeros(d, np.float32)
        scale = np.ones(d, np.float32)
    w_np = (np.asarray(sample_weight, np.float32)
            if sample_weight is not None else np.ones(n, np.float32))
    if mesh is not None:
        w, b = _fit_mesh((x - mean) / scale, np.asarray(y, np.int64), w_np,
                         cfg, mesh)
        return LogisticRegressionModel(
            weights=w, bias=b,
            mean=torch.as_tensor(mean, dtype=torch.float32, device=w.device),
            scale=torch.as_tensor(scale, dtype=torch.float32,
                                  device=w.device))
    xs = torch.as_tensor((x - mean) / scale, device=dev)
    y_onehot = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(y, np.int64), device=dev),
        cfg.n_classes).to(torch.float32)
    w_sample = torch.as_tensor(w_np, device=dev)
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


def _fit_mesh(xs: np.ndarray, y: np.ndarray, w_sample: np.ndarray,
              cfg: LogisticRegressionConfig, mesh):
    """:func:`train`'s steps over ``data``-sharded rows; returns the
    weights and bias on this process's first shard's device."""
    rows = PartitionSpec(AXIS_DATA)
    x_s = put_sharded(np.asarray(xs, np.float32), mesh, rows)
    y_s = put_sharded(torch.nn.functional.one_hot(
        torch.as_tensor(y), cfg.n_classes).to(torch.float32), mesh, rows)
    ws_s = put_sharded(w_sample, mesh, rows)
    params = [put_sharded(np.zeros(shape, np.float32), mesh,
                          PartitionSpec())
              for shape in ((xs.shape[1], cfg.n_classes), (cfg.n_classes,))]
    blocks = flat_blocks(params)
    mu = [torch.zeros_like(b) for b in blocks]
    nu = [torch.zeros_like(b) for b in blocks]
    mine = set(mesh.local_positions())
    lane = [p for p in axis_lane(mesh, AXIS_DATA) if p in mine]
    reg = float(cfg.reg)
    for t in range(1, int(cfg.steps) + 1):
        lw, lb = (position_leaves(p) for p in params)
        nums, dens = [], []
        for p in lane:
            logp = torch.log_softmax(x_s.block(p) @ lw.block(p)
                                     + lb.block(p), dim=-1)
            ll = -(y_s.block(p) * logp).sum(dim=-1)
            nums.append((ll * ws_s.block(p)).sum())
            dens.append(ws_s.block(p).sum())
        num = psum(nums, mesh, each=True)[0]
        loss = num / psum(dens, mesh, device=num.device).clamp(
            min=1.0) + reg * (lw.block(lane[0]) ** 2).sum()
        grads = flat_blocks(grads_by_block(loss, params, (lw, lb)))
        with torch.no_grad():
            _adam(blocks, grads, mu, nu, t, float(cfg.learning_rate))
    return tuple(p.block(lane[0]) for p in params)


def predict_proba(model: LogisticRegressionModel, x) -> torch.Tensor:
    """[B, C] class probabilities, on the model's device."""
    x = torch.as_tensor(x, dtype=torch.float32, device=model.weights.device)
    xs = (x - model.mean) / model.scale
    return torch.softmax(xs @ model.weights + model.bias, dim=-1)
