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

Without gradients each collective is plain tensor arithmetic (copies
between the shards' devices, slices, sums).  On parts that require grad
it is one ``torch.autograd.Function`` whose backward gathers every
process's output cotangents and sums what each part is owed in shard
order (:func:`_fold`), so a model's loss over shards has gradients on
every shard's block, in one process or across a gang, with the same
bits.  :func:`replicate` hands a replicated weight to several shards
the same way.  In a gang the processes split the mesh's first axis
(:func:`check_gang`), as the reference's hosts do.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    block_slices,
)

__all__ = ["shard_map", "psum", "all_gather", "all_to_all", "psum_scatter",
           "ppermute", "replicate", "axis_lane", "lane_outputs",
           "check_gang"]


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


def check_gang(mesh: Optional[Mesh], axis: str) -> None:
    """On a mesh that spans processes, a collective over ``axis`` needs
    the gang laid out as the reference's hosts are: every process holds
    an equal, contiguous run of ``axis`` positions, and ``axis`` is the
    mesh's first axis (the other axes then stay inside a process)."""
    if mesh is None or not mesh.multi_process:
        return
    first = mesh.axis_names[0]
    procs = mesh.process_ids.reshape(mesh.devices.shape)
    rows = procs.reshape(procs.shape[0], -1)
    ok = axis == first and bool((rows == rows[:, :1]).all())
    if ok:
        counts = np.bincount(rows[:, 0])
        ok = bool((counts == counts[0]).all()) and \
            bool((np.diff(rows[:, 0]) >= 0).all())
    if not ok:
        raise ValueError(
            f"a mesh that spans processes splits its first axis "
            f"({first!r}) evenly over them and keeps every other axis in "
            f"one process; a collective over {axis!r} on {mesh.shape} "
            f"with processes {procs.tolist()} cannot run")


def _exchange(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every process's ``tensors`` in rank order, each on the device of
    this process's tensor of the same place (every process passes as
    many tensors, of the same shapes and one dtype).

    One ``all_gather`` of the tensors flattened into one buffer.  On a
    gloo gang a CUDA buffer goes through the host: gloo's all_gather
    carries CPU tensors only (for CUDA tensors it has broadcast and
    all-reduce), so the host copy is the backend's requirement; NCCL
    takes the CUDA buffer as it is."""
    import torch.distributed as dist

    world = dist.get_world_size()
    home = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).to(home) for t in tensors])
    if dist.get_backend() == "gloo" and flat.device.type != "cpu":
        flat = flat.cpu()
    got = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(got, flat)
    out = []
    for g in got:
        off, parts = 0, []
        for t in tensors:
            parts.append(g[off:off + t.numel()].view(t.shape).to(t.device))
            off += t.numel()
        out.append(parts)
    return out


def _every_process(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All processes' parts in rank order (each process passes the parts
    of its own positions, as many as the others)."""
    return [p for proc in _exchange(parts) for p in proc]


def _spans(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.multi_process


def _gathered(parts: Sequence[torch.Tensor], mesh: Optional[Mesh]
              ) -> List[torch.Tensor]:
    if _spans(mesh):
        check_gang(mesh, mesh.axis_names[0])
        return _every_process(parts)
    return list(parts)


def _first_local(mesh: Optional[Mesh], n_local: int) -> int:
    """Index, in the every-process list, of this process's first part."""
    if _spans(mesh):
        from predictionio_tpu_torch.parallel.distributed import process_index

        return process_index() * n_local
    return 0


def _differentiable(parts: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in parts)


def _fold(terms: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """``terms`` added left to right on ``dev``: the one summation order
    every collective uses, forward and backward."""
    out = terms[0].to(dev, copy=True)
    for t in terms[1:]:
        out += t.to(dev)
    return out


# -- collectives with gradients ----------------------------------------------
#
# A collective on parts that require grad is one autograd Function: its
# forward gathers every process's parts (one process: its own), its
# backward gathers every process's output cotangents and hands each of
# this process's parts the sum of what every output sends it, added in
# slot order (process by process, a process's slots in mesh order).  The
# sums are :func:`_fold` s of every consumer's cotangent, never the
# backend's reduce (whose order is not fixed), so a gang of two computes
# a gradient with the bits one process computes for the same mesh: one
# process runs the same Functions with a gang of one.  Every process of
# a gang must run each Function's backward (the gathers pair up in call
# order), so every process holds inputs and outputs of each one.


class _Op:
    """One collective over ``mesh`` (None: one process): ``forward``
    maps this process's parts to the output slots it owns, ``backward``
    those slots' cotangents to the parts' gradients."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def every(self, local: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return _gathered(local, self.mesh)

    def first(self, n_local: int) -> int:
        return _first_local(self.mesh, n_local)


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: _Op, *parts):
        ctx.op = op
        ctx.parts = [(p.shape, p.device, p.dtype) for p in parts]
        with torch.no_grad():
            outs = op.forward(list(parts))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        with torch.no_grad():
            grads = ctx.op.backward(list(cots), ctx.parts)
        return (None, *grads)


class _PSum(_Op):
    """Every part summed; ``devices``: one output slot each."""

    def __init__(self, mesh, devices):
        super().__init__(mesh)
        self.devices = devices

    def forward(self, parts):
        every = self.every(parts)
        made: Dict[str, torch.Tensor] = {}
        outs = []
        for dev in self.devices:
            key = str(dev)
            outs.append(made[key].clone() if key in made
                        else made.setdefault(key, _fold(every, dev)))
        return outs

    def backward(self, cots, parts):
        every = self.every(cots)
        total = _fold(every, every[0].device)
        return [total.to(dev, copy=True) for _, dev, _ in parts]


class _AllGather(_Op):
    """Every part concatenated along ``dim``; one output slot a device."""

    def __init__(self, mesh, devices, dim):
        super().__init__(mesh)
        self.devices, self.dim = devices, dim

    def forward(self, parts):
        every = self.every(parts)
        return [torch.cat([p.to(dev) for p in every], dim=self.dim)
                for dev in self.devices]

    def backward(self, cots, parts):
        every = self.every(cots)
        n = parts[0][0][self.dim]
        first = self.first(len(parts))
        return [_fold([c.narrow(self.dim, (first + i) * n, n)
                       for c in every], dev)
                for i, (_, dev, _) in enumerate(parts)]


class _Replicate(_Op):
    """This process's copy of a replicated value (equal on every
    process), once for each of ``devices``; the gradient of the value is
    every slot's cotangent added in slot order, given to the copy of the
    mesh's first process (another process's copy gets none): a
    replicated weight used by every shard."""

    def __init__(self, mesh, devices):
        super().__init__(mesh)
        self.devices = devices

    def forward(self, parts):
        return [p.to(dev, copy=True) for dev in self.devices for p in parts]

    def backward(self, cots, parts):
        k = len(parts)
        every = self.every(cots)              # slot-major, k values a slot
        if self.first(1) != 0:
            return [None] * k
        return [_fold(every[j::k], dev) for j, (_, dev, _) in
                enumerate(parts)]


class _PSumScatter(_Op):
    def __init__(self, mesh, dim):
        super().__init__(mesh)
        self.dim = dim

    def forward(self, parts):
        every = self.every(parts)
        n = len(every)
        if every[0].shape[self.dim] % n:
            raise ValueError(f"dim {self.dim} of size "
                             f"{every[0].shape[self.dim]} does not split "
                             f"over {n} shards")
        pieces = [p.chunk(n, dim=self.dim) for p in every]
        first = self.first(len(parts))
        return [_fold([pc[first + j] for pc in pieces], p.device)
                for j, p in enumerate(parts)]

    def backward(self, cots, parts):
        every = self.every(cots)
        return [torch.cat([c.to(dev) for c in every], dim=self.dim)
                for _, dev, _ in parts]


class _AllToAll(_Op):
    def __init__(self, mesh, split_dim, concat_dim):
        super().__init__(mesh)
        self.split_dim, self.concat_dim = split_dim, concat_dim

    def forward(self, parts):
        every = self.every(parts)
        n = len(every)
        if every[0].shape[self.split_dim] % n:
            raise ValueError(f"dim {self.split_dim} of size "
                             f"{every[0].shape[self.split_dim]} does not "
                             f"split over {n} shards")
        pieces = [p.chunk(n, dim=self.split_dim) for p in every]
        first = self.first(len(parts))
        return [torch.cat([pieces[i][first + j].to(p.device)
                           for i in range(n)], dim=self.concat_dim)
                for j, p in enumerate(parts)]

    def backward(self, cots, parts):
        every = self.every(cots)
        n = len(every)
        first = self.first(len(parts))
        back = [c.chunk(n, dim=self.concat_dim) for c in every]
        return [torch.cat([back[j][first + i].to(dev) for j in range(n)],
                          dim=self.split_dim)
                for i, (_, dev, _) in enumerate(parts)]


class _PPermute(_Op):
    def __init__(self, mesh, srcs):
        super().__init__(mesh)
        self.srcs = srcs                     # dst -> src

    def forward(self, parts):
        every = self.every(parts)
        first = self.first(len(parts))
        out = []
        for j, p in enumerate(parts):
            src = self.srcs.get(first + j)
            out.append(torch.zeros_like(p) if src is None
                       else every[src].to(p.device, copy=True))
        return out

    def backward(self, cots, parts):
        every = self.every(cots)
        first = self.first(len(parts))
        dst_of = {s: d for d, s in self.srcs.items()}
        out = []
        for i, (shape, dev, dt) in enumerate(parts):
            dst = dst_of.get(first + i)
            out.append(torch.zeros(shape, device=dev, dtype=dt)
                       if dst is None else every[dst].to(dev, copy=True))
        return out


def _apply(op: _Op, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return list(_Collective.apply(op, *parts))


# -- the collectives --------------------------------------------------------


def psum(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None, *,
         device=None, each: bool = False):
    """Sum of every shard's part, added in shard order on ``device``
    (default: the first part's); with ``each``, one sum on each part's
    device (a list, one a position: what a replicated result is)."""
    parts = list(parts)
    devices = ([p.device for p in parts] if each
               else [parts[0].device if device is None else device])
    op = _PSum(mesh, devices)
    outs = _apply(op, parts) if _differentiable(parts) else op.forward(parts)
    return outs if each else outs[0]


def all_gather(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
               *, dim: int = 0, device=None, stack: bool = False,
               each: bool = False):
    """Every shard's part in shard order: concatenated along ``dim`` on
    ``device`` (default: the first part's), with ``each`` one
    concatenation on each part's device (a list), or with ``stack`` the
    list of parts as they arrived."""
    parts = list(parts)
    if stack:
        return _gathered(parts, mesh)
    devices = ([p.device for p in parts] if each
               else [parts[0].device if device is None else device])
    op = _AllGather(mesh, devices, dim)
    outs = _apply(op, parts) if _differentiable(parts) else op.forward(parts)
    return outs if each else outs[0]


def replicate(values: Sequence[torch.Tensor], devices: Sequence,
              mesh: Optional[Mesh] = None) -> List[List[torch.Tensor]]:
    """A replicated value used by several shards: this process's copy of
    ``values`` once for each of ``devices`` (``out[d][j]`` is
    ``values[j]`` on ``devices[d]``).  Without gradients the copies are
    plain ``.to`` s; with them, the gradient of each value is the sum of
    every shard's, across processes, added in shard order before it
    reaches the first process's copy (what one tensor used by every
    shard of one process gets, in a fixed order)."""
    values = list(values)
    if not _differentiable(values):
        return [[v.to(dev) for v in values] for dev in devices]
    flat = _apply(_Replicate(mesh, list(devices)), values)
    k = len(values)
    return [flat[d * k:(d + 1) * k] for d in range(len(devices))]


def all_to_all(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
               *, split_dim: int = 0, concat_dim: int = 0
               ) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    shard ``i``'s part splits into n pieces along ``split_dim``; shard
    ``j`` gets piece ``j`` of every shard, concatenated in shard order
    along ``concat_dim``, on its own part's device.  Returns the parts of
    this process's shards."""
    op = _AllToAll(mesh, split_dim, concat_dim)
    local = list(parts)
    if _differentiable(local):
        return _apply(op, local)
    return op.forward(local)


def psum_scatter(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
                 *, dim: int = 0) -> List[torch.Tensor]:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    every shard's part splits into n pieces along ``dim``; shard ``j``
    gets the sum of piece ``j`` of every shard, added in shard order on
    its own part's device.  Returns the parts of this process's
    shards."""
    op = _PSumScatter(mesh, dim)
    local = list(parts)
    if _differentiable(local):
        return _apply(op, local)
    return op.forward(local)


def ppermute(parts: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
             *, perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute(x, axis, perm)``: shard ``dst`` gets shard
    ``src``'s part for each ``(src, dst)`` of ``perm``, on its own
    part's device; a shard that no pair names gets zeros.  Returns the
    parts of this process's shards."""
    local = list(parts)
    n = len(local) * (len(np.unique(mesh.process_ids)) if _spans(mesh)
                      else 1)
    srcs = {}
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n) or dst in srcs:
            raise ValueError(f"perm {list(perm)!r} is not a permutation "
                             f"of {n} shards")
        srcs[dst] = src
    op = _PPermute(mesh, srcs)
    if _differentiable(local):
        return _apply(op, local)
    return op.forward(local)
