"""ALS model container and its serving functions.

Port of the serving half of ``predictionio_tpu/models/als.py``: the
:class:`ALSModel` container, ``predict_scores`` and ``recommend``.  The
factors stay numpy at rest (they ride the model pickle); the functions
stage what they need on the device they are given.  Training (the sweep,
``train_als``) and ``fold_in`` arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.ops.topk import chunked_top_k, top_k_scores

__all__ = ["ALSModel", "als_model_from_numpy", "predict_scores", "recommend"]


@dataclasses.dataclass
class ALSModel:
    """Trained factors. ``user_factors [U,K]``, ``item_factors [I,K]``,
    float32 numpy."""

    user_factors: np.ndarray
    item_factors: np.ndarray
    rank: int
    implicit: bool


def als_model_from_numpy(user_factors, item_factors, *, rank: int,
                         implicit: bool) -> ALSModel:
    """Carry trained factors into the port: any array-likes (for example
    the JAX model's factors after ``np.asarray(jax.device_get(...))``)
    become contiguous, writable float32 numpy ``[U, rank]`` /
    ``[I, rank]`` (copied only where the input is not already so)."""
    uf = np.require(user_factors, np.float32, ("C", "W"))
    itf = np.require(item_factors, np.float32, ("C", "W"))
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != rank \
            or itf.shape[1] != rank:
        raise ValueError(f"factors must be [U, {rank}] and [I, {rank}] "
                         f"(got {uf.shape} and {itf.shape})")
    return ALSModel(user_factors=uf, item_factors=itf, rank=int(rank),
                    implicit=bool(implicit))


def _on(x: Union[np.ndarray, torch.Tensor], device: torch.device
        ) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def predict_scores(user_factors: torch.Tensor, item_factors: torch.Tensor,
                   users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Pointwise r̂_ui for parallel (user, item) id vectors, float32."""
    return torch.einsum("bk,bk->b", user_factors[users].float(),
                        item_factors[items].float())


def recommend(
    model: ALSModel,
    user_indices,                  # [B] int
    k: int,
    *,
    seen=None,                     # [B, n_items] bool — exclude
    chunk: Optional[int] = None,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items per user on ``device`` (reference: MLlib
    recommendProducts).  Returns ([B, k] float32, [B, k] int32)."""
    idx = _on(user_indices, device).long()
    q = _on(model.user_factors, device)[idx]
    items = _on(model.item_factors, device)
    if chunk:
        return chunked_top_k(q, items, k, chunk=chunk)
    return top_k_scores(q, items, k,
                        exclude=None if seen is None else _on(seen, device))
