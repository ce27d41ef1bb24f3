"""Exact retrieval rungs — host, single-device, chunked, mesh-sharded.

Port of ``predictionio_tpu/retrieval/exact.py``.  Every rung returns the
same answer (the true top-k id set, scores within float tolerance); they
differ only in where the work runs and what memory it touches:

- ``host``    — numpy over host-resident vectors; wins whenever a device
  round trip costs more than the matmul (B=1 serving).
- ``device``  — one ``top_k_scores`` call on the device; the [B, N] score
  block materializes, fine for small and medium corpora.
- ``chunked`` — the fused top-k kernel (K3), which never writes the score
  block; a request that carries an exclude mask takes the
  ``chunked_top_k`` scan instead (the kernel takes no mask), bounded at
  [B, chunk] score memory.
- ``sharded`` — a corpus row-sharded over a mesh axis: K3 on every
  shard, then a tiny merge of the k·shards candidates
  (:func:`~predictionio_tpu_torch.ops.topk.sharded_top_k`).

PyTorch runs eagerly, so there is no compiled-program cache; the
caller-owned ``cache`` dict keeps only request-invariant device state
(the corpus-padding mask row).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.fused_topk import fused_topk
from predictionio_tpu_torch.ops.topk import (
    chunked_top_k,
    host_top_k,
    sharded_top_k,
    top_k_scores,
)

__all__ = ["exact_host", "exact_device", "exact_chunked", "exact_sharded",
           "SERVE_CACHE_LOCK"]

# Guards cold-path serving cache builds (device staging): a burst of
# concurrent first requests on the threaded server must not each stage
# its own corpus copy.
SERVE_CACHE_LOCK = threading.Lock()


def _cached(cache: Dict, key, build):
    value = cache.get(key)
    if value is None:
        with SERVE_CACHE_LOCK:
            value = cache.get(key)
            if value is None:
                value = build()
                cache[key] = value
    return value


def _to_host(*ts: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Each tensor as a host numpy array."""
    return tuple(t.cpu().numpy() for t in ts)


def _exclude_on(exclude: np.ndarray, n: int, dev: torch.device
                ) -> torch.Tensor:
    """Upload a [B, ≤N] exclude mask at its own width and pad it to the
    staged corpus on the device — never a host-built [B, N] block."""
    e = torch.from_numpy(np.ascontiguousarray(exclude, dtype=bool)).to(dev)
    if e.shape[1] < n:
        e = torch.nn.functional.pad(e, (0, n - e.shape[1]))
    return e


def exact_host(queries: np.ndarray, host_vecs: np.ndarray, k: int, *,
               exclude: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    s, i = host_top_k(queries, host_vecs, k, exclude=exclude)
    return np.asarray(s), np.asarray(i)


def exact_device(queries: np.ndarray, items_dev: torch.Tensor, n_items: int,
                 k: int, *, cache: Dict,
                 exclude: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One ``top_k_scores`` call; one host transfer for the results.

    The corpus-padding part of the mask (``n_items < n``) is request-
    invariant — staged on the device once as a [N] row and broadcast.
    """
    dev = items_dev.device
    n = items_dev.shape[0]
    q = torch.from_numpy(queries).to(dev)
    e = None
    if n_items < n:
        pad_row = _cached(cache, ("pad_row", n, n_items),
                          lambda: torch.arange(n, device=dev) >= n_items)
        e = pad_row[None, :].expand(q.shape[0], n)
    if exclude is not None:
        ex = _exclude_on(exclude, n, dev)
        e = ex if e is None else (ex | e)
    return _to_host(*top_k_scores(q, items_dev, k, exclude=e))


def exact_chunked(queries: np.ndarray, items_dev: torch.Tensor, n_items: int,
                  k: int, *, chunk: int = 262_144,
                  exclude: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The fused top-k kernel, or the bounded-memory scan for a request
    that carries an exclude mask."""
    dev = items_dev.device
    n = items_dev.shape[0]
    q = torch.from_numpy(queries).to(dev)
    if exclude is None:
        return _to_host(*fused_topk(q, items_dev, k, n_valid=n_items))
    return _to_host(*chunked_top_k(q, items_dev, k, chunk=min(chunk, n),
                                   n_valid=n_items,
                                   exclude=_exclude_on(exclude, n, dev)))


def exact_sharded(queries: np.ndarray, items_sharded, n_items: int, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh-sharded exact: a local score + top-k on every shard, then a
    tiny merge of the candidates.  ``items_sharded`` is a
    :class:`~predictionio_tpu_torch.parallel.mesh.ShardedTensor` whose
    dim-0 spec names a mesh axis (the facade stages it that way)."""
    mesh, axis = items_sharded.mesh, items_sharded.spec[0]
    return _to_host(*sharded_top_k(mesh, axis, torch.from_numpy(queries),
                                   items_sharded, k, n_valid=n_items))
