"""Collective micro-benchmark harness.

Port of ``predictionio_tpu/parallel/collectives.py``: psum (all-reduce),
all-gather and all-to-all timings over one mesh axis, through the shard
collectives of :mod:`~predictionio_tpu_torch.parallel.compat`.  A
regression harness, not a link spec sheet: on a mesh whose shards share
one card it times the copies and the fixed-order sums, not a link.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from predictionio_tpu_torch.parallel.compat import (
    all_gather,
    all_to_all,
    axis_lane,
    psum,
)
from predictionio_tpu_torch.parallel.mesh import Mesh

__all__ = ["collective_microbench"]


def _sync(devices) -> None:
    for d in {str(d): d for d in devices}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timed(fn, devices, iters: int = 5) -> float:
    fn()  # warm-up
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(devices)
    return (time.perf_counter() - t0) / iters


def collective_microbench(
    mesh: Mesh, *, size_mb: float = 4.0, axis: Optional[str] = None,
    iters: int = 5,
) -> Dict[str, Dict[str, float]]:
    """Measure all_reduce / all_gather / all_to_all over one mesh axis.

    Returns {collective: {seconds, algo_bw_gbps, payload_mb,
    axis_size}}, where algo bandwidth is payload bytes / time over the
    whole ``[rows·n, 128]`` float32 array.
    """
    axis = axis or mesh.axis_names[0]
    n = mesh.shape[axis]
    lane = [p for p in axis_lane(mesh, axis)
            if p in set(mesh.local_positions())]
    devices = [mesh.devices.flat[p] for p in lane]
    per_device_rows = max(1, int(size_mb * 1024 * 1024 / 4) // 128)
    per_device_rows = -(-per_device_rows // n) * n   # all_to_all splits
    parts = [torch.zeros((per_device_rows, 128), dtype=torch.float32,
                         device=d) for d in devices]
    bytes_payload = per_device_rows * n * 128 * 4
    fns = (("all_reduce", lambda: psum(parts, mesh)),
           ("all_gather", lambda: all_gather(parts, mesh)),
           ("all_to_all", lambda: all_to_all(parts, mesh)))
    results: Dict[str, Dict[str, float]] = {}
    for name, fn in fns:
        secs = _timed(fn, devices, iters=iters)
        results[name] = {
            "seconds": secs,
            "algo_bw_gbps": bytes_payload / secs / 1e9,
            "payload_mb": bytes_payload / 1e6,
            "axis_size": float(n),
        }
    return results
