"""Mesh construction, sharding specs and sharded tensors.

Port of ``predictionio_tpu/parallel/mesh.py``.  The standard mesh axes:

- ``data``     — batch/data parallelism (the reference's RDD partitions)
- ``model``    — tensor/factor-block parallelism
- ``sequence`` — sequence/context parallelism (reserved)
- ``expert``   — embedding-table / expert sharding

The mesh is single-controller, as JAX's is within one process: a named
axis array of ``torch.device`` s, one process driving every device of
its host (one ``pio deploy`` serves all of its host's cards).  A
"sharded" array is a :class:`ShardedTensor`: one block per mesh position,
each on that position's device, plus the spec and the mesh.  Across
processes (``parallel.distributed``) a process holds only the blocks of
its own positions; the collectives of ``parallel.compat`` join them
through ``torch.distributed``.

Default devices: on CUDA every visible card; with ``device="cpu"``,
:func:`cpu_devices_requested` positions, all on the CPU (the setting the
reference reads, so the test bootstrap gives both packages 8).  An
explicit ``devices=`` list may name one card more than once: several
shards then share that card (how a 4-shard mesh runs on one card).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "AXIS_DATA",
    "put_sharded",
    "AXIS_MODEL",
    "AXIS_SEQUENCE",
    "AXIS_EXPERT",
    "make_mesh",
    "parse_mesh_spec",
    "mesh_from_spec",
    "sharding",
    "batch_sharding",
    "replicated",
    "cpu_devices_requested",
    "Mesh",
    "PartitionSpec",
    "NamedSharding",
    "ShardedTensor",
]

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQUENCE = "sequence"
AXIS_EXPERT = "expert"


def cpu_devices_requested() -> int:
    """How many virtual CPU devices XLA_FLAGS requests (the CPU mesh's
    default size)."""
    flags = os.environ.get("XLA_FLAGS", "")
    for tok in flags.split():
        if tok.startswith("--xla_force_host_platform_device_count="):
            return int(tok.split("=", 1)[1])
    return 1


class PartitionSpec(tuple):
    """One entry per array dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim splits over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """A named-axis array of devices.  ``process_ids`` (same shape) says
    which process drives each position (all 0 in one process)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 process_ids: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_ids = (np.zeros(devices.shape, np.int64)
                            if process_ids is None else process_ids)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def position(self, flat: int) -> Dict[str, int]:
        """Axis name → index of flat position ``flat``."""
        idx = np.unravel_index(flat, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def local_positions(self) -> List[int]:
        """Flat positions this process drives, in mesh order."""
        from predictionio_tpu_torch.parallel.distributed import process_index

        me = process_index()
        return [i for i, p in enumerate(self.process_ids.flat) if p == me]

    @property
    def multi_process(self) -> bool:
        return bool((self.process_ids != self.process_ids.flat[0]).any())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


class NamedSharding:
    """``mesh`` + :class:`PartitionSpec`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def is_fully_replicated(self) -> bool:
        return all(e is None for e in self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block_slices(shape: Sequence[int], sh: NamedSharding, flat: int
                 ) -> Tuple[slice, ...]:
    """The global slices of the block at flat mesh position ``flat``.
    A sharded dim must divide by the product of its axes' sizes."""
    pos = sh.mesh.position(flat)
    sizes = sh.mesh.shape
    out = []
    for dim, n in enumerate(shape):
        axes = _axes(sh.spec[dim]) if dim < len(sh.spec) else ()
        parts, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + pos[a]
            parts *= sizes[a]
        if n % parts:
            raise ValueError(f"dim {dim} of size {n} does not divide over "
                             f"{axes} ({parts} shards)")
        per = n // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


class ShardedTensor:
    """A global array laid out over a mesh: ``shards[p]`` is the block
    of flat position ``p`` on that position's device (None for positions
    another process drives).  Positions that share a device and a block
    share one tensor."""

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 shards: List[Optional[torch.Tensor]]):
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.shards = shards

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return next(s for s in self.shards if s is not None).dtype

    def block(self, flat: int) -> torch.Tensor:
        t = self.shards[flat]
        if t is None:
            raise ValueError(f"mesh position {flat} belongs to another "
                             "process")
        return t

    def to_host(self) -> np.ndarray:
        """The global array as numpy (gathered from every process)."""
        from predictionio_tpu_torch.parallel.compat import all_gather

        out = np.empty(self.shape, dtype=_np_dtype(self.dtype))
        mesh = self.mesh
        if mesh.multi_process:
            blocks = all_gather([self.shards[p] for p in
                                 mesh.local_positions()], mesh,
                                stack=True)
        else:
            blocks = self.shards
        for p, blk in enumerate(blocks):
            out[block_slices(self.shape, self.sharding, p)] = \
                blk.detach().cpu().numpy()
        return out

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, {self.sharding!r})"


def _np_dtype(dt: torch.dtype):
    return torch.empty((), dtype=dt).numpy().dtype


def _global_devices(device=None) -> Tuple[List[torch.device], List[int]]:
    """Every device of every process, in process order, and their
    process ids.  Local devices: every visible card, or
    :func:`cpu_devices_requested` CPU positions with ``device="cpu"``."""
    from predictionio_tpu_torch.device import device as resolve_device
    from predictionio_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    dev = resolve_device(device)
    if dev.type == "cpu":
        local = [torch.device("cpu")] * cpu_devices_requested()
    else:
        local = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    if process_count() == 1:
        return local, [0] * len(local)
    import torch.distributed as dist

    every: List = [None] * process_count()
    dist.all_gather_object(every, [str(d) for d in local])
    devs, procs = [], []
    for p, names in enumerate(every):
        devs.extend(torch.device(n) for n in names)
        procs.extend([p] * len(names))
    assert procs.count(process_index()) == len(local)
    return devs, procs


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    *,
    devices: Optional[Sequence[torch.device]] = None,
    device=None,
) -> Mesh:
    """Build a named mesh over the available devices.

    ``axis_sizes`` maps axis name → size; at most one axis may be ``-1``
    (absorbs remaining devices).  Default: all devices on the ``data``
    axis.  ``devices`` pins the device list (one process; a device may
    repeat); otherwise the devices of ``device`` (the card by default,
    ``"cpu"`` for the CPU positions) across every process.
    """
    if devices is not None:
        from predictionio_tpu_torch.parallel.distributed import process_index

        devs = [torch.device(d) for d in devices]
        procs = [process_index()] * len(devs)
    else:
        devs, procs = _global_devices(device)
    n = len(devs)
    if not axis_sizes:
        axis_sizes = {AXIS_DATA: n}
    sizes = dict(axis_sizes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("At most one mesh axis may be -1.")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wild:
        if n % fixed != 0:
            raise ValueError(
                f"Cannot infer axis {wild[0]!r}: {n} devices not divisible by {fixed}."
            )
        sizes[wild[0]] = n // fixed
    total = math.prod(sizes.values())
    if total > n:
        raise ValueError(
            f"Mesh axes {sizes} need {total} devices but {n} are available."
        )
    # Fewer than available is allowed (`--mesh data=2` on an 8-card
    # host): take a device prefix so small meshes work anywhere.
    arr = np.empty(total, dtype=object)
    for i in range(total):
        arr[i] = devs[i]
    shape = tuple(sizes.values())
    return Mesh(arr.reshape(shape), tuple(sizes),
                np.asarray(procs[:total], np.int64).reshape(shape))


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse the CLI/env mesh spec (``pio train --mesh`` / ``PIO_MESH``).

    Grammar: ``axis=size[,axis=size...]`` with at most one ``-1`` wildcard
    (``data=-1,model=2``), or the shorthands ``auto`` (all devices on the
    ``data`` axis) and a bare integer N (``data=N``).
    """
    spec = (spec or "").strip()
    if not spec or spec.lower() == "auto":
        return {AXIS_DATA: -1}
    if spec.isdigit():
        return {AXIS_DATA: int(spec)}
    sizes: Dict[str, int] = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(
                f"Bad mesh spec token {tok!r}: expected axis=size "
                "(e.g. 'data=8,model=2', 'data=-1', or 'auto')."
            )
        axis, _, size = tok.partition("=")
        sizes[axis.strip()] = int(size)
    for axis, size in sizes.items():
        if size != -1 and size < 1:
            raise ValueError(
                f"Bad mesh axis size {axis}={size}: must be >= 1 "
                "(or -1 to absorb remaining devices)."
            )
    return sizes


def mesh_from_spec(
    spec: str, *, devices: Optional[Sequence[torch.device]] = None,
    device=None,
) -> Optional[Mesh]:
    """Build a mesh from a CLI/env spec string; ``""``/``"none"`` → None.
    The entry point of ``pio train/deploy --mesh`` and ``PIO_MESH``."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("none", "off"):
        return None
    return make_mesh(parse_mesh_spec(spec), devices=devices, device=device)


def sharding(mesh: Mesh, *spec: Optional[Union[str, Tuple[str, ...]]]
             ) -> NamedSharding:
    """NamedSharding over ``mesh`` with one spec entry per array dim:
    ``sharding(mesh, "data", None)`` shards dim 0 over ``data`` and
    replicates dim 1."""
    return NamedSharding(mesh, PartitionSpec(*spec))


def batch_sharding(mesh: Mesh, axis: str = AXIS_DATA) -> NamedSharding:
    """Shard the leading (batch) dim, replicate the rest."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated (the reference's ``sc.broadcast`` analogue)."""
    return NamedSharding(mesh, PartitionSpec())


def put_sharded(arr, mesh: Mesh, spec) -> ShardedTensor:
    """Place a host array (numpy or a tensor) onto the mesh.

    Every process calls this with the SAME full array and fills only the
    blocks of its own positions (the reference's multi-host contract).
    Positions that share a device and a block share one copy.
    """
    sh = spec if isinstance(spec, NamedSharding) \
        else NamedSharding(mesh, spec)
    src = arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(arr))
    shards: List[Optional[torch.Tensor]] = [None] * mesh.size
    made: Dict = {}
    for p in mesh.local_positions():
        dev = mesh.devices.flat[p]
        sl = block_slices(src.shape, sh, p)
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        t = made.get(key)
        if t is None:
            t = src[sl].to(dev, copy=True).contiguous()
            made[key] = t
        shards[p] = t
    return ShardedTensor(sh, src.shape, shards)
