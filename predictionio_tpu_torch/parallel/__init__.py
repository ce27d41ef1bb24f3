"""Mesh, sharding, and collective infrastructure.

Port of ``predictionio_tpu/parallel/``: a single-controller mesh of
``torch.device`` s (``mesh``), ``shard_map`` and the fixed-order shard
collectives (``compat``), the ``torch.distributed`` gang
(``distributed``), the collective micro-benchmark (``collectives``), ring
and Ulysses attention over the ``sequence`` axis (``ring``) and
block-wise training on sharded parameters (``blocks``).
"""

from predictionio_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_SEQUENCE,
    batch_sharding,
    cpu_devices_requested,
    make_mesh,
    replicated,
    sharding,
)
from predictionio_tpu_torch.parallel.ring import (
    local_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_EXPERT",
    "AXIS_MODEL",
    "AXIS_SEQUENCE",
    "batch_sharding",
    "cpu_devices_requested",
    "make_mesh",
    "replicated",
    "sharding",
    "local_attention",
    "ring_attention",
    "ulysses_attention",
]
