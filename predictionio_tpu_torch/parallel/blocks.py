"""Training on :class:`~predictionio_tpu_torch.parallel.mesh.ShardedTensor`
parameters, block by block.

The reference's deep models train on a mesh by annotating shardings and
letting GSPMD partition ``jax.grad``.  On the port's single-controller
mesh a step is written out:

1. :func:`position_leaves` — every mesh position's block becomes an
   autograd leaf of its own (a view: positions that share a tensor
   share its storage);
2. the loss, from per-position stages joined by the collectives of
   :mod:`~predictionio_tpu_torch.parallel.compat`;
3. :func:`grads_by_block` — ``torch.autograd.grad`` on every position's
   leaf, then :func:`block_grads`: a block's gradient is the sum, in
   position order, of the gradients of the positions that hold it (a
   replicated weight: every position; a row block: the positions along
   the other axes), placed on each device that holds the block: GSPMD's
   ``psum`` of a replicated parameter's gradient, in a fixed order;
4. the optimizer on the :func:`flat_blocks` lists, so each block is
   updated where it lives, and :func:`rebuild_all` lays the new blocks
   out as the old ones were.

In a gang (a mesh that spans processes) a process makes leaves for its
own positions only; the collectives carry the cotangents between
processes, a block another process also holds gets its gradient from
every holder's in position order (the holders' gradients gathered
first), and each process updates the blocks it holds.  Every process
computes its replica of the loss; the one of the mesh's first process
seeds the backward (1), the others seed it with 0, so the gradient is
counted once, with one process's bits.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from predictionio_tpu_torch.parallel.compat import _every_process
from predictionio_tpu_torch.parallel.mesh import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    block_slices,
)

__all__ = ["distinct_blocks", "rebuild", "map_blocks", "flat_blocks",
           "rebuild_all", "position_leaves", "block_grads",
           "grads_by_block", "loss_seed", "leading_slot"]


def _distinct(x: ShardedTensor) -> List[Tuple[int, torch.Tensor]]:
    """(first position, tensor) of each of this process's distinct
    blocks, in position order."""
    seen, out = set(), []
    for p in x.mesh.local_positions():
        t = x.shards[p]
        if id(t) not in seen:
            seen.add(id(t))
            out.append((p, t))
    return out


def distinct_blocks(x: ShardedTensor) -> List[torch.Tensor]:
    """This process's blocks of ``x`` without repeats (positions that
    share a tensor give it once), in position order."""
    return [t for _, t in _distinct(x)]


def rebuild(like: ShardedTensor, blocks: Sequence[torch.Tensor]
            ) -> ShardedTensor:
    """A :class:`ShardedTensor` laid out as ``like``, with ``blocks[i]``
    in place of ``like``'s i-th distinct block (shared as it was)."""
    new = {id(t): b for (_, t), b in zip(_distinct(like), blocks)}
    shards = [None if t is None else new[id(t)] for t in like.shards]
    return ShardedTensor(like.sharding, like.shape, shards)


def map_blocks(fn: Callable[[torch.Tensor], torch.Tensor],
               x: ShardedTensor) -> ShardedTensor:
    """``fn`` of each distinct block, laid out as ``x``."""
    return rebuild(x, [fn(t) for t in distinct_blocks(x)])


def flat_blocks(xs: Sequence[ShardedTensor]) -> List[torch.Tensor]:
    """The distinct blocks of every array of ``xs``, one list in order:
    what an elementwise optimizer update takes."""
    return [b for x in xs for b in distinct_blocks(x)]


def rebuild_all(likes: Sequence[ShardedTensor],
                blocks: Sequence[torch.Tensor]) -> List[ShardedTensor]:
    """:func:`flat_blocks`' inverse: ``blocks`` laid out as ``likes``."""
    it = iter(blocks)
    return [rebuild(x, [next(it) for _ in distinct_blocks(x)])
            for x in likes]


def position_leaves(x: ShardedTensor) -> ShardedTensor:
    """``x`` with each of this process's positions holding its own leaf
    view of its block, requiring grad (the gradient a position's stages
    put on it stays apart from the other positions')."""
    shards: List[Optional[torch.Tensor]] = [None] * x.mesh.size
    for p in x.mesh.local_positions():
        shards[p] = x.shards[p].detach().requires_grad_(True)
    return ShardedTensor(x.sharding, x.shape, shards)


def _block_key(x: ShardedTensor, p: int) -> Tuple:
    return tuple((s.start, s.stop)
                 for s in block_slices(x.shape, x.sharding, p))


def _shared_across(x: ShardedTensor) -> bool:
    """Whether a block of ``x`` is held by positions of two processes."""
    mesh = x.mesh
    if not mesh.multi_process:
        return False
    owners: Dict[Tuple, set] = {}
    for p in range(mesh.size):
        owners.setdefault(_block_key(x, p), set()).add(
            int(mesh.process_ids.flat[p]))
    return any(len(o) > 1 for o in owners.values())


def _every_grad(x: ShardedTensor, grads: Dict[int, Optional[torch.Tensor]]
                ) -> Dict[int, Optional[torch.Tensor]]:
    """Every position's gradient, across the gang: each process sends its
    positions' (zeros and a 0 flag where None), in rank order."""
    positions = x.mesh.local_positions()
    like = x.shards[positions[0]]
    sent = [grads.get(p) if grads.get(p) is not None
            else torch.zeros_like(like) for p in positions]
    flags = torch.tensor([float(grads.get(p) is not None)
                          for p in positions], device=like.device)
    got = _every_process([*sent, flags])
    k = len(positions)
    out: Dict[int, Optional[torch.Tensor]] = {}
    for r in range(len(got) // (k + 1)):
        proc = got[r * (k + 1):(r + 1) * (k + 1)]
        for i in range(k):
            out[r * k + i] = proc[i] if bool(proc[k][i]) else None
    return out


def block_grads(x: ShardedTensor, grads: Dict[int, Optional[torch.Tensor]]
                ) -> ShardedTensor:
    """The gradient of each block of ``x``, laid out as ``x``: the sum of
    ``grads[p]`` (position ``p``'s leaf gradient, None where the position
    did not take part) over the positions that hold the same block,
    added in position order on each device that holds it.  Where a
    block's holders span processes, every position's gradient is
    gathered first (the gang's processes hold equal runs of positions,
    in order)."""
    if _shared_across(x):
        grads = _every_grad(x, grads)
        holders = range(x.mesh.size)
    else:
        holders = x.mesh.local_positions()
    by_key: Dict[Tuple, List[torch.Tensor]] = {}
    for p in holders:
        g = grads.get(p)
        if g is not None:
            by_key.setdefault(_block_key(x, p), []).append(g)
    out = []
    for p0, t in _distinct(x):
        gs = by_key.get(_block_key(x, p0), [])
        if not gs:
            out.append(torch.zeros_like(t))
            continue
        acc = gs[0].to(t.device, copy=True)
        for g in gs[1:]:
            acc += g.to(t.device)
        out.append(acc)
    return rebuild(x, out)


def loss_seed(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The backward's seed of this process's replica of ``loss``: 1 on
    the process of the mesh's first position, 0 on the others (each
    replica's backward still runs, to pass the cotangents the
    collectives carry between processes)."""
    from predictionio_tpu_torch.parallel.distributed import process_index

    first = int(mesh.process_ids.flat[0]) == process_index()
    return torch.ones_like(loss) if first else torch.zeros_like(loss)


def grads_by_block(loss: torch.Tensor, xs: Sequence[ShardedTensor],
                   leaves: Sequence[ShardedTensor]) -> List[ShardedTensor]:
    """The gradient of ``loss`` for each array of ``xs``, laid out as it
    is: ``torch.autograd.grad`` on every position's leaf (``leaves``,
    from :func:`position_leaves` of ``xs``), then :func:`block_grads`."""
    mesh = xs[0].mesh
    positions = mesh.local_positions()
    flat = [lv.shards[p] for lv in leaves for p in positions]
    seed = loss_seed(loss, mesh)
    got = torch.autograd.grad(loss, flat, grad_outputs=seed,
                              allow_unused=True)
    n = len(positions)
    with torch.no_grad():
        return [block_grads(x, dict(zip(positions, got[i * n:(i + 1) * n])))
                for i, x in enumerate(xs)]


def leading_slot(x: ShardedTensor, k: int) -> ShardedTensor:
    """Slot ``k`` of a superbatch staged with a leading, replicated slot
    axis (``P(None, axis, ...)``): the ``P(axis, ...)`` batch of that
    step, as views of the staged blocks."""
    spec = PartitionSpec(*list(x.spec)[1:])
    return ShardedTensor(NamedSharding(x.mesh, spec), x.shape[1:],
                         [None if t is None else t[k] for t in x.shards])
