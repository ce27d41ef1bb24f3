"""Batched dense linear algebra for the ALS sweep.

Port of ``predictionio_tpu/ops/linalg.py``.  ``gram`` is one large
product, left to ``torch.matmul`` as the reference leaves it to XLA;
``batched_ridge_solve`` is the Cholesky solve the reference takes off
the accelerator (its ``_ridge`` "cholesky" path), here through
``torch.linalg``.  All results are float32.  On the card, keep TF32 off
(:func:`predictionio_tpu_torch.device.set_float32_precision`): a TF32
``gram`` keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["gram", "masked_gram", "batched_ridge_solve"]


def gram(y: torch.Tensor) -> torch.Tensor:
    """``YᵀY`` for ``[n, k]`` factors, float32."""
    y = y.float()
    return y.T @ y


def masked_gram(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted per-row Gram: ``[B, L, K] × [B, L] → [B, K, K]``,
    ``Σ_l w[b,l] · f[b,l,:] ⊗ f[b,l,:]``."""
    f = f.float()
    return torch.einsum("blk,bl,blm->bkm", f, w.float(), f)


def batched_ridge_solve(a: torch.Tensor, b: torch.Tensor,
                        reg: Union[torch.Tensor, float]) -> torch.Tensor:
    """Solve ``(A + reg·I) x = b`` for a batch of PSD ``A``:
    ``[B,K,K], [B,K] → [B,K]``.  ``reg`` is a scalar or a ``[B]`` vector
    (ALS-WR: λ·degree per row) and must be > 0: A is a Gram matrix plus
    the ridge, so the Cholesky factor exists.  A system whose
    factorization fails (non-finite or not positive definite input)
    solves to NaN, as the reference's does, so the caller's finiteness
    check sees it; nothing raises or synchronises here."""
    k = a.shape[-1]
    reg = torch.as_tensor(reg, dtype=torch.float32, device=a.device)
    if reg.dim() == 1:
        reg = reg[:, None, None]
    a_reg = a.float() + reg * torch.eye(k, dtype=torch.float32,
                                        device=a.device)
    chol, info = torch.linalg.cholesky_ex(a_reg)
    x = torch.cholesky_solve(b.float()[..., None], chol)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.nan)
