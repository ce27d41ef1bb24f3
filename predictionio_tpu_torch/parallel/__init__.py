"""Mesh, sharding, and collective infrastructure.

Port of ``predictionio_tpu/parallel/``: a single-controller mesh of
``torch.device`` s (``mesh``), ``shard_map`` and the fixed-order shard
collectives (``compat``), the ``torch.distributed`` gang
(``distributed``) and the collective micro-benchmark (``collectives``).
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
]
