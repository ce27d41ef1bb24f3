"""``shard_map`` and the shard collectives of the single-controller mesh.

Counterpart of ``predictionio_tpu/parallel/compat.py``.  There the shim
picks JAX's ``shard_map`` spelling; here :func:`shard_map` is the
mapping itself: it calls a per-shard function once for each mesh
position this process drives, on that position's block of each input,
and assembles the outputs by ``out_specs`` — the same ``mesh`` /
``in_specs`` / ``out_specs`` meaning.  The per-shard function gets, as
its first argument, ``axis_index(name)``: its position on a mesh axis
(what ``lax.axis_index`` gives).

A collective inside a per-shard function becomes a call on the list of
per-shard values (``out_specs=None`` hands that list back), made
between two ``shard_map`` stages: :func:`psum` and :func:`all_gather`
reduce and concatenate in shard order, so a sum over shards is the same
bits on every run; :func:`psum_scatter`, :func:`ppermute` and
:func:`all_to_all` are ``lax.psum_scatter`` / ``lax.ppermute`` /
``lax.all_to_all`` with ``tiled=True``, their sums in shard order too.
Across processes they first gather every process's shards through
``torch.distributed`` (a fixed rank order), so every process reduces
the same list.

In one process each collective is plain tensor arithmetic (copies
between the shards' devices, slices, sums), so ``torch.autograd``
differentiates through it: a model's loss over shards has gradients on
every shard's block.  Across processes a gathered part carries no
gradient back to the process that sent it, so a collective on parts
that require grad there raises (ROADMAP Queue 1 item 10c) instead of
returning a silently partial gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    block_slices,
)

__all__ = ["shard_map", "psum", "all_gather", "all_to_all", "psum_scatter",
           "ppermute", "axis_lane", "lane_outputs"]


def axis_lane(mesh: Mesh, axis: str,
              at: Optional[Dict[str, int]] = None) -> List[int]:
    """Flat positions along ``axis`` with every other axis at index 0
    (or at its index in ``at``), in axis order: one representative
    position per shard of ``axis``."""
    at = at or {}
    out = []
    for flat in range(mesh.size):
        pos = mesh.position(flat)
        if all(i == at.get(a, 0) for a, i in pos.items() if a != axis):
            out.append(flat)
    return out


def lane_outputs(outs: List, mesh: Mesh, axis: str) -> List:
    """Of a ``shard_map`` 's per-position outputs (``out_specs=None``),
    those of one position per shard of ``axis``, in shard order — what a
    collective over ``axis`` reduces (the other axes replicate)."""
    lane = set(axis_lane(mesh, axis))
    return [o for o, p in zip(outs, mesh.local_positions()) if p in lane]


def _norm(spec) -> PartitionSpec:
    spec = PartitionSpec(*spec) if not isinstance(spec, PartitionSpec) \
        else spec
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def _local(arg, spec, mesh: Mesh, flat: int, cache: Dict):
    """``arg``'s block at position ``flat`` under ``spec``."""
    dev = mesh.devices.flat[flat]
    if isinstance(arg, ShardedTensor):
        if _norm(arg.spec) != _norm(spec):
            raise ValueError(f"input laid out as {arg.spec!r}, in_spec "
                             f"{spec!r}")
        return arg.block(flat)
    if arg is None:
        return None
    t = torch.as_tensor(arg)
    sl = block_slices(t.shape, NamedSharding(mesh, spec), flat)
    key = (id(arg), str(dev), tuple((s.start, s.stop) for s in sl))
    hit = cache.get(key)
    if hit is None:
        hit = t[sl].to(dev)
        cache[key] = hit
    return hit


def _assemble(outs: List, spec, mesh: Mesh, positions: List[int]):
    if spec is None:
        return outs
    spec = _norm(spec)
    if not spec:
        return outs[0]      # replicated: identical on every shard
    shards: List[Optional[torch.Tensor]] = [None] * mesh.size
    for p, o in zip(positions, outs):
        shards[p] = o
    sh = NamedSharding(mesh, spec)
    local = outs[0]
    shape = list(local.shape)
    sizes = mesh.shape
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        for a in axes:
            shape[dim] *= sizes[a]
    return ShardedTensor(sh, shape, shards)


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs):
    """Map ``f(axis_index, *blocks)`` over the mesh positions this
    process drives.

    ``in_specs``: one spec per argument (or one spec for a single
    argument).  A :class:`ShardedTensor` argument must be laid out as its
    spec says and gives its own block; a plain tensor or array is sliced
    (replicated under ``P()``) and copied to each position's device.
    ``out_specs``: ``P()`` — the outputs are replicated, the first
    position's is returned; ``P(axis, ...)`` — a :class:`ShardedTensor`
    of the positions' outputs; ``None`` — the list of per-position
    outputs, for :func:`psum` / :func:`all_gather`.  A tuple of specs
    maps a tuple of outputs.
    """
    single_in = not isinstance(in_specs, (list, tuple)) or \
        isinstance(in_specs, PartitionSpec)

    def run(*args):
        specs = (in_specs,) if single_in else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments, {len(specs)} in_specs")
        positions = mesh.local_positions()
        cache: Dict = {}
        outs = []
        for p in positions:
            pos = mesh.position(p)
            blocks = [_local(a, s, mesh, p, cache)
                      for a, s in zip(args, specs)]
            outs.append(f(pos.__getitem__, *blocks))
        if isinstance(out_specs, tuple) and \
                not isinstance(out_specs, PartitionSpec):
            return tuple(
                _assemble([o[j] for o in outs], s, mesh, positions)
                for j, s in enumerate(out_specs))
        return _assemble(outs, out_specs, mesh, positions)

    return run


def _every_process(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All processes' parts in rank order (each process passes the parts
    of its own positions, all of one shape)."""
    import torch.distributed as dist

    x = torch.stack(list(parts))
    got = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(got, x)
    return [blk for g in got for blk in g.unbind(0)]


def _gathered(parts: Sequence[torch.Tensor], mesh: Optional[Mesh]
              ) -> List[torch.Tensor]:
    if mesh is not None and mesh.multi_process:
        if torch.is_grad_enabled() and any(p.requires_grad for p in parts):
            raise NotImplementedError(
                "autograd through a collective on a mesh that spans "
                "processes is not ported yet (ROADMAP Queue 1 item 10c): "
                "a part gathered from another process carries no gradient "
                "back to it")
        return _every_process(parts)
    return list(parts)


def _first_local(mesh: Optional[Mesh], n_local: int) -> int:
    """Index, in the every-process list, of this process's first part."""
    if mesh is not None and mesh.multi_process:
        from predictionio_tpu_torch.parallel.distributed import process_index

        return process_index() * n_local
    return 0


def psum(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None, *,
         device=None) -> torch.Tensor:
    """Sum of every shard's part, added in shard order on ``device``
    (default: the first part's)."""
    parts = _gathered(parts, mesh)
    dev = parts[0].device if device is None else device
    out = parts[0].to(dev, copy=True)
    for p in parts[1:]:
        out += p.to(dev)
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
               *, dim: int = 0, device=None, stack: bool = False):
    """Every shard's part in shard order: concatenated along ``dim`` on
    ``device`` (default: the first part's), or with ``stack`` the list
    of parts as they arrived."""
    parts = _gathered(parts, mesh)
    if stack:
        return parts
    dev = parts[0].device if device is None else device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def all_to_all(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
               *, split_dim: int = 0, concat_dim: int = 0
               ) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    shard ``i``'s part splits into n pieces along ``split_dim``; shard
    ``j`` gets piece ``j`` of every shard, concatenated in shard order
    along ``concat_dim``, on its own part's device.  Returns the parts of
    this process's shards."""
    local = list(parts)
    every = _gathered(local, mesh)
    n = len(every)
    if every[0].shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size "
                         f"{every[0].shape[split_dim]} does not split over "
                         f"{n} shards")
    pieces = [p.chunk(n, dim=split_dim) for p in every]
    first = _first_local(mesh, len(local))
    return [torch.cat([pieces[i][first + j].to(local[j].device)
                       for i in range(n)], dim=concat_dim)
            for j in range(len(local))]


def psum_scatter(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
                 *, dim: int = 0) -> List[torch.Tensor]:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    every shard's part splits into n pieces along ``dim``; shard ``j``
    gets the sum of piece ``j`` of every shard, added in shard order on
    its own part's device.  Returns the parts of this process's
    shards."""
    local = list(parts)
    every = _gathered(local, mesh)
    n = len(every)
    if every[0].shape[dim] % n:
        raise ValueError(f"dim {dim} of size {every[0].shape[dim]} does not "
                         f"split over {n} shards")
    pieces = [p.chunk(n, dim=dim) for p in every]
    first = _first_local(mesh, len(local))
    out = []
    for j in range(len(local)):
        dev = local[j].device
        acc = pieces[0][first + j].to(dev, copy=True)
        for i in range(1, n):
            acc = acc + pieces[i][first + j].to(dev)
        out.append(acc)
    return out


def ppermute(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
             *, perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute(x, axis, perm)``: shard ``dst`` gets shard
    ``src``'s part for each ``(src, dst)`` of ``perm``, on its own
    part's device; a shard that no pair names gets zeros.  Returns the
    parts of this process's shards."""
    local = list(parts)
    every = _gathered(local, mesh)
    n = len(every)
    srcs = {}
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n) or dst in srcs:
            raise ValueError(f"perm {list(perm)!r} is not a permutation "
                             f"of {n} shards")
        srcs[dst] = src
    first = _first_local(mesh, len(local))
    out = []
    for j in range(len(local)):
        src = srcs.get(first + j)
        out.append(torch.zeros_like(local[j]) if src is None
                   else every[src].to(local[j].device))
    return out
