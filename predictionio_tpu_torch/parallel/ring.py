"""Sequence/context parallelism: ring attention + Ulysses all-to-all.

Port of ``predictionio_tpu/parallel/ring.py``.  The mesh reserves a
``sequence`` axis for sequence engines; this module supplies the two
standard attention strategies over it:

- :func:`ring_attention` — each shard keeps its Q block while the K/V
  blocks rotate one lane position a step (:func:`~predictionio_tpu_torch.
  parallel.compat.ppermute`); the softmax is accumulated online (running
  max, denominator, ``_NEG = -1e30``), so the full ``[S, S]`` score
  matrix never materializes.  Step ``t`` on shard ``me`` scores the
  block of shard ``(me - t) % n``, the reference's ring order, and the
  causal mask compares global positions.
- :func:`ulysses_attention` — an all-to-all re-shards from
  sequence-sharded to head-sharded (``split_dim=2, concat_dim=1``), each
  shard runs :func:`local_attention` over the whole sequence for its
  ``H/n`` heads, and a second all-to-all shards the sequence back.

The arithmetic is the reference's einsums in float32 (the reference
reaches no Pallas kernel here).  On the single-controller mesh the
ring's loop runs over the lane's shards between ``shard_map`` stages,
and ``torch.autograd`` differentiates through it.  On a mesh that spans
processes (``sequence`` split over the gang) each process runs its own
shards' steps; ``ppermute`` and ``all_to_all`` carry the blocks and
their cotangents between processes, so the outputs and gradients are
one process's bits.  Inputs are
``[B, S, H, D]`` tensors (or :class:`~predictionio_tpu_torch.parallel.
mesh.ShardedTensor` s laid out ``P(None, axis)``); the output is a
``ShardedTensor`` laid out ``P(None, axis)`` (``.full()`` assembles it).
"""

from __future__ import annotations

from typing import List

import torch

from predictionio_tpu_torch.parallel.compat import (
    all_to_all,
    check_gang,
    lane_outputs,
    ppermute,
    shard_map,
)
from predictionio_tpu_torch.parallel.mesh import (
    AXIS_SEQUENCE,
    Mesh,
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
)

__all__ = ["ring_attention", "ulysses_attention", "local_attention"]

_NEG = -1e30


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention on one device.  Shapes [B, S, H, D]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None, :, :], scores,
                             torch.full_like(scores, _NEG))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def _lane_blocks(x, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``x``'s sequence blocks, one a shard of ``axis`` this process
    drives, in shard order."""
    outs = shard_map(lambda _ax, blk: blk, mesh=mesh,
                     in_specs=P(None, axis), out_specs=None)(x)
    return lane_outputs(outs, mesh, axis)


def _assemble(blocks: List[torch.Tensor], mesh: Mesh, axis: str,
              shape) -> ShardedTensor:
    """This process's per-shard outputs (``blocks[j]`` of shard
    ``first + j``) as a ``P(None, axis)`` array (the other axes
    replicate: their positions share the lane's block)."""
    first = _first_shard(mesh, axis)
    shards = [None] * mesh.size
    for p in mesh.local_positions():
        shards[p] = blocks[mesh.position(p)[axis] - first]
    return ShardedTensor(NamedSharding(mesh, P(None, axis)), shape, shards)


def _first_shard(mesh: Mesh, axis: str) -> int:
    """The index along ``axis`` of this process's first shard."""
    return min(mesh.position(p)[axis] for p in mesh.local_positions())


def _seq_check(q, mesh: Mesh, n: int, axis: str) -> int:
    check_gang(mesh, axis)
    seq = q.shape[1]
    assert seq % n == 0, f"pad sequence ({seq}) to a multiple of {n}"
    return seq


def ring_attention(q, k, v, mesh: Mesh, *, causal: bool = False,
                   axis: str = AXIS_SEQUENCE) -> ShardedTensor:
    """Exact attention over sequence-sharded Q/K/V with ring K/V
    rotation."""
    n = mesh.shape[axis]
    _seq_check(q, mesh, n, axis)
    qs, ks, vs = (_lane_blocks(x, mesh, axis) for x in (q, k, v))
    first = _first_shard(mesh, axis)
    b, sl, h, d = qs[0].shape
    scale = d ** -0.5
    perm = [(i, (i + 1) % n) for i in range(n)]
    state = []
    for me, qb in enumerate(qs, start=first):
        dev = qb.device
        state.append([
            torch.full((b, h, sl), _NEG, dtype=torch.float32, device=dev),
            torch.zeros((b, h, sl), dtype=torch.float32, device=dev),
            torch.zeros((b, h, sl, d), dtype=torch.float32, device=dev),
            me * sl + torch.arange(sl, device=dev)])
    for t in range(n):
        for j, qb in enumerate(qs):
            me = first + j
            m, l, acc, q_pos = state[j]
            src = (me - t) % n                 # owner of the visiting block
            s = torch.einsum("bqhd,bkhd->bhqk", qb.float(),
                             ks[j].float()) * scale
            if causal:
                k_pos = src * sl + torch.arange(sl, device=qb.device)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, None, :, :], s,
                                torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(dim=-1)
            acc_new = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vs[j].float())
            state[j] = [m_new, l_new, acc_new, q_pos]
        if t < n - 1:
            # Rotate K/V to the next shard on the ring.
            ks = ppermute(ks, mesh, perm=perm)
            vs = ppermute(vs, mesh, perm=perm)
    outs = []
    for (m, l, acc, _), qb in zip(state, qs):
        out = acc / torch.clamp(l, min=1e-30)[..., None]      # [B,H,S/n,D]
        outs.append(out.permute(0, 2, 1, 3).to(qb.dtype))     # [B,S/n,H,D]
    return _assemble(outs, mesh, axis, tuple(q.shape))


def ulysses_attention(q, k, v, mesh: Mesh, *, causal: bool = False,
                      axis: str = AXIS_SEQUENCE) -> ShardedTensor:
    """DeepSpeed-Ulysses-style SP: all_to_all seq→head reshard, local
    attention over the FULL sequence for H/n heads, all_to_all back."""
    n = mesh.shape[axis]
    _seq_check(q, mesh, n, axis)
    heads = q.shape[2]
    assert heads % n == 0, f"heads ({heads}) must divide over {n} devices"
    qf, kf, vf = (all_to_all(_lane_blocks(x, mesh, axis), mesh, split_dim=2,
                             concat_dim=1) for x in (q, k, v))
    outs = [local_attention(a, b_, c, causal=causal)
            for a, b_, c in zip(qf, kf, vf)]
    back = all_to_all(outs, mesh, split_dim=1, concat_dim=2)
    return _assemble(back, mesh, axis, tuple(q.shape))
