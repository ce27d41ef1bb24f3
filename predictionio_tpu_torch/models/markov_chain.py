"""First-order Markov chain over item transitions.

Port of ``predictionio_tpu/models/markov_chain.py`` (reference:
e2 MarkovChain.scala): transition counts from observed state pairs,
row-normalized, top-K next-state prediction.  The counts are one
``index_add_`` on the device the caller names (the card unless it
passes ``device="cpu"``); prediction is a row gather and a stable
descending sort, so tied states come lowest id first, as
``lax.top_k`` gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device

__all__ = ["MarkovChainModel", "train_markov_chain", "predict_next"]


@dataclasses.dataclass
class MarkovChainModel:
    transition: torch.Tensor   # [S, S] row-stochastic (Laplace-smoothed)
    n_states: int


def train_markov_chain(prev_states: np.ndarray, next_states: np.ndarray,
                       n_states: int, *, smoothing: float = 0.0,
                       device=None) -> MarkovChainModel:
    """Estimate P(next | prev) from transition pairs."""
    dev = resolve_device(device)
    prev_t = torch.as_tensor(np.asarray(prev_states, np.int64), device=dev)
    next_t = torch.as_tensor(np.asarray(next_states, np.int64), device=dev)
    flat = prev_t * n_states + next_t
    counts = torch.zeros(n_states * n_states, dtype=torch.float32,
                         device=dev)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    counts = counts.reshape(n_states, n_states) + smoothing
    row = counts.sum(dim=1, keepdim=True)
    transition = torch.where(row > 0, counts / row.clamp(min=1e-12),
                             torch.zeros_like(counts))
    return MarkovChainModel(transition=transition, n_states=n_states)


def predict_next(model: MarkovChainModel, states, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k next states per input state: ([B, k] probs, [B, k] ids)."""
    idx = torch.as_tensor(states, dtype=torch.int64,
                          device=model.transition.device)
    rows = model.transition[idx]
    probs, ids = torch.sort(rows, dim=-1, descending=True, stable=True)
    return probs[:, :k], ids[:, :k]
