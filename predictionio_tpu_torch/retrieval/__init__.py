"""Retrieval subsystem — THE way serving reaches an item corpus.

Port of ``predictionio_tpu/retrieval/__init__.py`` with its exact rungs
(``retrieval/exact.py``): ``host`` (numpy), ``device`` (one matmul +
top-k on the card) and ``chunked`` (the fused top-k kernel, K3).  The
routing is the reference's, knob for knob:

- ``PIO_RETRIEVAL_RUNG`` — auto|host|device|chunked (force); the rungs
  not ported yet (``sharded``, ``ivf``, ``ivf_pq``, ``pq_flat``) warn and
  route automatically, exactly as the reference does when the structure
  a forced rung needs is missing
- ``PIO_SERVE_HOST_MACS`` — host fast path when B·N·D is at or below
  this (default 2e8)
- ``PIO_SERVE_CHUNK_ABOVE`` — chunked rung above this many items
  (default 2,000,000)

A corpus that carries an IVF index or PQ codes is refused: those rungs
(and kernel K5) arrive with a later slice.

Observability: ``pio_retrieval_requests_total{rung,corpus}``,
``pio_retrieval_candidates_total{rung,corpus}`` (rows actually scored)
and ``pio_retrieval_ms{rung}`` — the reference's family and label names.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.retrieval import exact as _exact

logger = logging.getLogger(__name__)

__all__ = ["Retriever", "Plan", "cached_retriever", "arm_on_create",
           "iter_hits", "menu_k", "K_MENU", "RUNGS", "EXCLUDE_RUNGS"]

# K pads up to a short menu so varying ``num`` values share a handful
# of shapes (the reference's compiled-program menu).
K_MENU = (1, 10, 100, 1000)
_NEG_SENTINEL = -1e37  # scores at/below this are padding, never results

RUNGS = ("host", "device", "chunked", "sharded", "ivf", "ivf_pq",
         "pq_flat")
# Rungs that honor a per-request exclude mask.
EXCLUDE_RUNGS = ("host", "device", "chunked")
# Rungs of the reference that this port does not have yet.
_UNPORTED_RUNGS = ("sharded", "ivf", "ivf_pq", "pq_flat")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)) or default)
    except ValueError:
        return default


def menu_k(num: int, n_items: int) -> int:
    return min(n_items, next((m for m in K_MENU if m >= num), num))


@dataclasses.dataclass
class Plan:
    """One routing decision — exposed for tests."""

    rung: str
    k: int
    nprobe: int = 0
    rerank: int = 0


class Retriever:
    """Facade over the exact retrieval rungs for ONE item corpus.

    ``item_vecs`` is the host numpy corpus (possibly carrying padding
    rows past ``n_items``).  The retriever stages a host copy and one
    device copy lazily — at most one of each, built under a lock.
    ``device`` is where the device rungs run (default: the CUDA card,
    raising when there is none; see
    :func:`~predictionio_tpu_torch.device.device`).
    """

    def __init__(self, item_vecs, *, n_items: Optional[int] = None,
                 ivf=None, pq=None, name: str = "default", host_fn=None,
                 device=None):
        if ivf is not None or pq is not None:
            raise NotImplementedError(
                f"corpus {name!r} carries an "
                f"{'IVF index' if ivf is not None else 'PQ codebook'}: the "
                "IVF/PQ retrieval rungs are not yet ported to PyTorch")
        self._vecs = item_vecs
        self.n_items = int(n_items if n_items is not None
                           else item_vecs.shape[0])
        self.dim = int(item_vecs.shape[1])
        self.name = name
        self.device = resolve_device(device)
        self._host_fn = host_fn
        self._host: Optional[np.ndarray] = None
        self._dev: Optional[torch.Tensor] = None
        self._cache: Dict = {}
        self._lock = threading.Lock()
        reg = get_registry()
        self._m_requests = reg.counter(
            "pio_retrieval_requests_total",
            "Corpus retrievals by rung.", ("rung", "corpus"))
        self._m_candidates = reg.counter(
            "pio_retrieval_candidates_total",
            "Candidate item rows actually scored.", ("rung", "corpus"))
        self._m_latency = reg.histogram(
            "pio_retrieval_ms", "Retrieval latency per rung.", ("rung",))

    # -- corpus staging -----------------------------------------------------

    def host_vecs(self) -> np.ndarray:
        """[n_items, D] float32 numpy copy (trimmed of padding rows)."""
        if self._host is None:
            with self._lock:
                if self._host is None:
                    src = self._host_fn() if self._host_fn is not None \
                        else self._vecs
                    self._host = np.ascontiguousarray(
                        np.asarray(src, dtype=np.float32)[: self.n_items])
        return self._host

    def device_vecs(self) -> torch.Tensor:
        """The corpus on ``self.device`` — staged ONCE, reused across
        requests."""
        if self._dev is None:
            with _exact.SERVE_CACHE_LOCK:
                if self._dev is None:
                    self._dev = torch.as_tensor(
                        np.require(self._vecs, np.float32, ("C", "W")),
                        device=self.device)
        return self._dev

    # -- routing ------------------------------------------------------------

    def plan(self, b: int, num: int, *, has_exclude: bool = False) -> Plan:
        k = menu_k(num, self.n_items)
        forced = os.environ.get("PIO_RETRIEVAL_RUNG", "auto").strip().lower()
        if forced not in RUNGS and forced not in ("", "auto"):
            # An unrecognized forcing must degrade as loudly as an
            # impossible one.
            logger.warning("PIO_RETRIEVAL_RUNG=%r is not one of %s; "
                           "auto routing", forced, ("auto",) + RUNGS)
        if forced in RUNGS:
            if has_exclude and forced not in EXCLUDE_RUNGS:
                logger.warning(
                    "PIO_RETRIEVAL_RUNG=%s cannot honor a per-request "
                    "exclude mask for corpus %r; serving exact", forced,
                    self.name)
                forced = "auto"
            if forced == "sharded":
                # The reference serves a corpus that is not mesh-sharded
                # exact-device; the port has no sharded corpora yet.
                logger.warning("PIO_RETRIEVAL_RUNG=sharded but corpus %r "
                               "is not mesh-sharded; serving exact-device",
                               self.name)
                forced = "device"
            if forced in _UNPORTED_RUNGS:
                logger.warning("PIO_RETRIEVAL_RUNG=%s but corpus %r has no "
                               "%s structure; serving exact", forced,
                               self.name,
                               "IVF" if forced == "ivf" else "PQ")
                forced = "auto"
            if forced in RUNGS:
                return Plan(rung=forced, k=k)
        work = b * self.n_items * self.dim
        if work <= _env_int("PIO_SERVE_HOST_MACS", 2 * 10 ** 8):
            return Plan(rung="host", k=k)
        if self.n_items > _env_int("PIO_SERVE_CHUNK_ABOVE", 2_000_000):
            return Plan(rung="chunked", k=k)
        return Plan(rung="device", k=k)

    # -- the one entry point ------------------------------------------------

    def topk(self, queries: np.ndarray, num: int, *,
             exclude: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """Top-k over the corpus for query VECTORS ``[B, D]``.

        Returns ``([B, k] scores, [B, k] int32 ids, info)`` with
        ``k = menu_k(num) ≤ n_items`` — callers slice ``[:num]`` per row
        (:func:`iter_hits` skips padding sentinels).  ``exclude`` is an
        optional ``[B, n_items]`` bool mask (True = never return).
        """
        q = np.ascontiguousarray(queries, dtype=np.float32)
        b = q.shape[0]
        p = self.plan(b, num, has_exclude=exclude is not None)
        t0 = time.perf_counter()
        scores, ids, scanned = self._execute(q, p, exclude)
        ms = (time.perf_counter() - t0) * 1e3
        self._m_requests.inc(rung=p.rung, corpus=self.name)
        self._m_candidates.inc(scanned, rung=p.rung, corpus=self.name)
        self._m_latency.observe(ms, rung=p.rung)
        info = {"rung": p.rung, "k": p.k, "nprobe": p.nprobe,
                "rerank": p.rerank, "candidates": scanned, "ms": ms}
        return scores, ids, info

    def _execute(self, q: np.ndarray, p: Plan,
                 exclude: Optional[np.ndarray]):
        b = q.shape[0]
        if p.rung == "host":
            s, i = _exact.exact_host(q, self.host_vecs(), p.k,
                                     exclude=exclude)
            return s, i, b * self.n_items
        qp = _pow2_pad(q)
        if exclude is not None and len(qp) > b:
            # The pow2 pad added all-zero query rows; give them
            # all-False mask rows so shapes stay aligned.
            exclude = np.concatenate(
                [exclude, np.zeros((len(qp) - b, exclude.shape[1]),
                                   dtype=bool)])
        if p.rung == "chunked":
            s, i = _exact.exact_chunked(qp, self.device_vecs(),
                                        self.n_items, p.k, exclude=exclude)
        else:
            s, i = _exact.exact_device(qp, self.device_vecs(),
                                       self.n_items, p.k,
                                       cache=self._cache, exclude=exclude)
        return s[:b], i[:b], b * self.n_items


def _pow2_pad(q: np.ndarray) -> np.ndarray:
    """Pad the batch to the next power of two (the shape menu)."""
    b = q.shape[0]
    pad = (1 << max(b - 1, 0).bit_length()) - b
    if pad:
        return np.concatenate([q, np.zeros((pad, q.shape[1]), q.dtype)])
    return q


def iter_hits(scores_row, ids_row, num: int) -> Iterator[Tuple[int, float]]:
    """(item_id, score) pairs of one result row, sentinel padding
    skipped, at most ``num``."""
    taken = 0
    for s, i in zip(scores_row, ids_row):
        if taken >= num:
            return
        if i < 0 or s <= _NEG_SENTINEL:
            continue
        yield int(i), float(s)
        taken += 1


# -- per-model retriever cache ----------------------------------------------

_RETRIEVERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_RETRIEVERS_LOCK = threading.Lock()
_PENDING_ARM: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cached_retriever(owner, build) -> Retriever:
    """ONE retriever per loaded model object, built lazily, dying with
    the generation (weak-keyed — a swapped-out model wrapper releases its
    staged CUDA copy of the corpus with itself).  Keeping the cache OUT
    of the wrapper means no tensor ever rides the model pickle."""
    r = _RETRIEVERS.get(owner)
    if r is None:
        pending = None
        with _RETRIEVERS_LOCK:
            r = _RETRIEVERS.get(owner)
            if r is None:
                r = build()
                _RETRIEVERS[owner] = r
                pending = _PENDING_ARM.pop(owner, None)
        if pending is not None:
            try:
                pending(r)
            except Exception:
                logger.debug("retriever arm callback failed",
                             exc_info=True)
    return r


def arm_on_create(owner, fn) -> None:
    """Run ``fn(retriever)`` for ``owner``'s retriever — immediately if
    one is already cached, else right after ``cached_retriever`` builds
    it, so observers attach without forcing retriever creation at model
    load.  At most one pending callback per owner (latest wins)."""
    with _RETRIEVERS_LOCK:
        r = _RETRIEVERS.get(owner)
        if r is None:
            _PENDING_ARM[owner] = fn
            return
    fn(r)
