"""Embedding-row gathers whose backward is deterministic.

The models' tables are read with ``table[ids]``; the gradient of that
read is a scatter-add of the row gradients into a dense zero table.  On
CUDA the default scatter sums a row's duplicates in whatever order the
atomics land, so one step's bits would differ run to run, and a K-step
fused window could not equal K single steps.  :class:`GatherRows` runs
its backward under ``torch.use_deterministic_algorithms`` scoped to it:
on CUDA that is the sort-based ``index_put_``, which sums each row's
duplicates in index order — the order of XLA's scatter, and of the CPU.
Shared by :mod:`~predictionio_tpu_torch.models.two_tower` and
:mod:`~predictionio_tpu_torch.models.dlrm`.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["deterministic", "GatherRows"]


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block only."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


class GatherRows(torch.autograd.Function):
    """``table[ids]`` (``ids`` one-dimensional) whose backward — the
    scatter-add of the row gradients into a dense zero table — is
    deterministic: each row sums its duplicates in index order, on the
    card as on the CPU."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.table_shape)
        with deterministic():
            out.index_put_((ids.long(),), grad, accumulate=True)
        return out, None
