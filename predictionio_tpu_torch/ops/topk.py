"""Dot-product top-K retrieval — the serving hot path.

Port of ``predictionio_tpu/ops/topk.py``.  The reference's jitted XLA
programs (``einsum`` + ``lax.top_k``) become ``torch.matmul`` +
``torch.topk`` on whatever device the tensors live on; these are library
paths in the reference too, not Pallas kernels.  Ids come back as int32,
like ``lax.top_k``'s (``torch.topk`` returns int64).  The mesh-sharded
:func:`sharded_top_k` scores each shard with the fused top-k (kernel K3
on the card) where the reference's shards take ``top_k_scores``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.parallel.compat import (
    all_gather,
    lane_outputs,
    shard_map,
)
from predictionio_tpu_torch.parallel.mesh import PartitionSpec as P

__all__ = ["top_k_scores", "chunked_top_k", "sharded_top_k", "host_top_k",
           "topk_mismatch", "NEG_INF"]

NEG_INF = -3.4e38


def top_k_scores(
    queries: torch.Tensor,   # [B, K] float
    items: torch.Tensor,     # [N, K] float
    k: int,
    *,
    exclude: Optional[torch.Tensor] = None,  # [B, N] bool — True = mask out
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores+ids of the top-k items per query. Returns ([B,k], [B,k] int32)."""
    scores = queries.float() @ items.float().T
    if exclude is not None:
        scores = scores.masked_fill(exclude, NEG_INF)
    s, i = torch.topk(scores, k, dim=1)
    return s, i.to(torch.int32)


def chunked_top_k(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    *,
    chunk: int = 8192,
    exclude: Optional[torch.Tensor] = None,  # [B, N] bool — True = mask out
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with bounded [B, chunk] score materialization.

    Scores one chunk at a time and merges it with the running top-k, so
    score memory stays at [B, chunk] for any catalog size.  The tail
    chunk reads a clamped (overlapping) window ``[n - chunk, n)`` and
    masks the rows the previous chunk already scored, exactly as the
    reference's ``dynamic_slice`` scan does.  ``n_valid`` masks trailing
    padding rows; ``exclude`` is the per-query mask of
    :func:`top_k_scores`, sliced chunk by chunk.
    """
    n = items.shape[0]
    b = queries.shape[0]
    limit = n if n_valid is None else min(n_valid, n)
    dev = queries.device
    if n <= chunk:
        # Small corpus: fold the n_valid tail mask into exclude and take
        # the one-matmul path.
        excl = exclude
        if limit < n:
            pad_rows = (torch.arange(n, device=dev) >= limit)[None, :] \
                .expand(b, n)
            excl = pad_rows if excl is None else (excl | pad_rows)
        return top_k_scores(queries, items, k, exclude=excl)
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    q = queries.float()
    for nominal in range(0, n, chunk):
        start = min(nominal, n - chunk)
        s = q @ items[start:start + chunk].float().T
        ids = torch.arange(start, start + chunk, dtype=torch.int32,
                           device=dev)[None, :]
        invalid = (ids < nominal) | (ids >= limit)
        if exclude is not None:
            invalid = invalid | exclude[:, start:start + chunk]
        s = s.masked_fill(invalid, NEG_INF)
        merged_s = torch.cat([best_s, s], dim=1)
        merged_i = torch.cat([best_i, ids.expand(b, chunk)], dim=1)
        best_s, pos = torch.topk(merged_s, k, dim=1)
        best_i = torch.gather(merged_i, 1, pos)
    return best_s, best_i


def sharded_top_k(
    mesh,
    axis: str,
    queries: torch.Tensor,   # [B, K] replicated
    items,                   # ShardedTensor [N, K], dim 0 sharded on `axis`
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over item factors row-sharded on a mesh axis.

    Each shard scores its N/shards rows and takes a local top-k with
    :func:`~predictionio_tpu_torch.ops.fused_topk.fused_topk` (K3 on the
    card), masking the rows at or past ``n_valid`` (the mesh padding a
    blocked corpus carries at its tail: zero vectors that would outrank
    genuinely negative scores), and offsets its ids by ``shard·per``.
    The k·shards candidates are gathered in shard order onto the first
    shard's device and reduced to the global top k by a stable sort, so
    among equal scores the lower id comes first, as K3 ranks them.  A
    slot a shard cannot fill keeps id -1 (never offset into a real id).
    Returns ``([B, k] float32, [B, k] int32)`` on the first shard's
    device, the same on every process of a gang.
    """
    # ops.fused_topk imports this module (NEG_INF)
    from predictionio_tpu_torch.ops.fused_topk import fused_topk

    n = items.shape[0]
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"pad catalog ({n}) to a multiple of {n_shards}")
    per = n // n_shards
    kk = min(k, per)

    def local(axis_index, q, it):
        shard = axis_index(axis)
        nv = per if n_valid is None else \
            max(0, min(n_valid - shard * per, per))
        s, i = fused_topk(q.float().contiguous(), it, kk, n_valid=nv)
        return s, torch.where(i >= 0, i + shard * per, i)

    s_parts, i_parts = (lane_outputs(parts, mesh, axis) for parts in shard_map(
        local, mesh=mesh, in_specs=(P(), P(axis)),
        out_specs=(None, None))(queries, items))
    dev = s_parts[0].device
    all_s = all_gather(s_parts, mesh, dim=1, device=dev)
    all_i = all_gather(i_parts, mesh, dim=1, device=dev)
    top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    return (top_s[:, :k].contiguous(),
            torch.gather(all_i, 1, pos[:, :k]).contiguous())


def topk_mismatch(s, i, ref_s, ref_i, next_s=None, *, rtol: float = 1e-5,
                  atol: float = 1e-5) -> Optional[str]:
    """Why a top-k answer ([B, k] scores and ids) disagrees with a
    reference answer, or None when it agrees.

    Scores must match within ``rtol``/``atol`` and run descending; each
    row's id set must equal the reference's, except for slots whose
    reference score ties, within the tolerance, with the reference's
    (k+1)-th score ``next_s`` [B] — any of the tied items may fill them.
    """
    s, i, ref_s, ref_i = (np.asarray(x) for x in (s, i, ref_s, ref_i))
    if s.shape != ref_s.shape or i.shape != ref_i.shape:
        return f"shape {s.shape}/{i.shape} vs {ref_s.shape}/{ref_i.shape}"
    if not np.allclose(s, ref_s, rtol=rtol, atol=atol):
        err = float(np.max(np.abs(s - ref_s)))
        return f"scores differ (max abs err {err:.3g})"
    if (np.diff(s, axis=1) > atol).any():
        return "scores are not sorted descending"
    for row in range(s.shape[0]):
        got, want = set(i[row].tolist()), set(ref_i[row].tolist())
        if got == want:
            continue
        if next_s is None:
            return f"row {row}: id sets differ by {sorted(got ^ want)[:8]}"
        edge = float(next_s[row])
        tied = np.abs(ref_s[row] - edge) <= atol + rtol * abs(edge)
        if not tied.any() or not set(i[row][~tied].tolist()) <= want \
                or not set(ref_i[row][~tied].tolist()) <= got:
            return f"row {row}: id sets differ by {sorted(got ^ want)[:8]}"
    return None


def host_top_k(
    queries,              # np [B, K]
    items,                # np [N, K]
    k: int,
    *,
    exclude=None,         # np [B, N] bool — True = mask out
    biases=None,          # np [N]
):
    """Numpy top-k for the host-resident serving fast path.

    A B=1 predict over even ML-25M-scale item factors is ~4M MACs — far
    below the cost of one device round trip.  Serving keeps a host copy
    of the factors and answers small batches here.  Returns ([B, k],
    [B, k] int32) sorted descending.
    """
    if k <= 0:  # k=0 → empty, never the whole catalog
        return (np.empty((queries.shape[0], 0), np.float32),
                np.empty((queries.shape[0], 0), np.int32))
    scores = queries @ items.T                      # [B, N]
    if biases is not None:
        scores = scores + biases[None, :]
    if exclude is not None:
        scores = np.where(exclude, -3.4e38, scores)
    n = scores.shape[1]
    k = min(k, n)
    if k < n:
        part = np.argpartition(scores, -k, axis=1)[:, -k:]
    else:
        part = np.broadcast_to(np.arange(n), scores.shape).copy()
    part_scores = np.take_along_axis(scores, part, axis=1)
    order = np.argsort(-part_scores, axis=1, kind="stable")
    ids = np.take_along_axis(part, order, axis=1).astype(np.int32)
    return np.take_along_axis(part_scores, order, axis=1), ids
