"""Multi-process control-plane bring-up.

Port of ``predictionio_tpu/parallel/distributed.py``: where the reference
calls ``jax.distributed.initialize``, the port forms a
``torch.distributed`` process group — NCCL for a mesh on the card, gloo
on the CPU — at ``tcp://`` the coordinator's address.  The shard
collectives of :mod:`~predictionio_tpu_torch.parallel.compat` then join
the processes' blocks through it.

Env contract (the reference's):

- ``PIO_COORDINATOR_ADDRESS`` — host:port of process 0
- ``PIO_NUM_PROCESSES``       — gang size
- ``PIO_PROCESS_ID``          — this process's rank

Without ``PIO_COORDINATOR_ADDRESS`` every call is a no-op and the process
is a gang of one.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "is_multi_host", "process_index",
           "process_count", "gang_any", "barrier"]

_initialized = False


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> bool:
    """Join the multi-process gang if configured; no-op otherwise.

    Returns True if distributed mode is active.  Safe to call repeatedly.
    ``backend``: "nccl" or "gloo" (default: NCCL when CUDA is available,
    gloo otherwise).
    """
    global _initialized
    if _initialized or _dist() is not None:
        _initialized = True
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "PIO_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(
        os.environ.get("PIO_NUM_PROCESSES", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PIO_PROCESS_ID", "0")))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    logger.info("torch.distributed.init_process_group(%s, tcp://%s, "
                "world_size=%d, rank=%d)", backend, coordinator_address,
                num_processes, process_id)
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(process_id % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=120))
    _initialized = True
    return True


def is_multi_host() -> bool:
    return process_count() > 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def _flag_device() -> torch.device:
    """Where a gang's small control tensors live: the host on gloo, the
    process's card on NCCL (which carries CUDA tensors only)."""
    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gang_any(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any process of the
    gang (a process alone: ``flag``): how a gang takes one decision —
    to preempt, to roll back — at the same step."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    """Wait for every process of the gang (a no-op alone)."""
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()
