"""Retrieval subsystem — THE way serving reaches an item corpus.

Port of ``predictionio_tpu/retrieval/__init__.py``.  The rungs:

1. **Exact** (``retrieval/exact.py``): ``host`` (numpy), ``device`` (one
   matmul + top-k on the card), ``chunked`` (the fused top-k kernel, K3)
   and ``sharded`` (K3 on every shard of a mesh-sharded corpus, staged by
   :meth:`Retriever.maybe_shard` at model load).
2. **IVF** (``retrieval/ivf.py``): a train-time k-means coarse index,
   versioned with the generation by a corpus fingerprint (an index that
   does not match the served vectors is dropped and counted).
3. **PQ** (``retrieval/pq.py``): train-time residual product
   quantization; ``ivf_pq`` prunes by cell first, ``pq_flat`` scans every
   code column with the PQ scan kernel (K5); both re-rank a
   ``PIO_PQ_RERANK`` shortlist against the exact embeddings.  Codebooks
   carry the same fingerprint tripwire.

The routing is the reference's, knob for knob:

- ``PIO_RETRIEVAL_RUNG`` — auto|host|device|chunked|sharded|ivf|ivf_pq|
  pq_flat (force); ``sharded`` on a corpus that is not mesh-sharded
  serves exact-device, as the reference does
- ``PIO_SERVE_SHARD_ABOVE`` — ``maybe_shard`` row-shards a corpus of more
  than this many items over the serving mesh (default 1,000,000)
- ``PIO_SERVE_HOST_MACS`` — host fast path when B·N·D (IVF/PQ: the rows
  or code lookups actually scored) is at or below this (default 2e8)
- ``PIO_SERVE_CHUNK_ABOVE`` — chunked rung above this many items
  (default 2,000,000)
- ``PIO_IVF_NPROBE`` — IVF lists probed per query
- ``PIO_PQ_RERANK`` — exact-re-rank shortlist size (default 4·k)
- ``PIO_CORPUS_DTYPE`` — f32|bf16|int8 staged re-rank corpus

Observability: ``pio_retrieval_requests_total{rung,corpus}``,
``pio_retrieval_candidates_total{rung,corpus}`` (rows actually scored),
``pio_retrieval_ms{rung}``, ``pio_retrieval_ivf_rejected_total{corpus}``
and ``pio_retrieval_pq_rejected_total{corpus}`` — the reference's family
and label names.  Each answer stamps the rung-tagged ``retrieval`` stage
on the active latency waterfall (the batcher's per-dispatch sink), timed
until the answer is on the host: every rung returns numpy arrays, and the
copy of a device rung's answer waits for its kernels.  An approximate
rung's answer is offered to ``Retriever.recall_hook`` (armed by
:class:`~predictionio_tpu_torch.obs.recall.RecallMonitor`).
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
from predictionio_tpu_torch.obs import get_registry, span
from predictionio_tpu_torch.obs.waterfall import record_stage
from predictionio_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    PartitionSpec,
    ShardedTensor,
    put_sharded,
)
from predictionio_tpu_torch.retrieval import exact as _exact
from predictionio_tpu_torch.retrieval.ivf import (
    IVFIndex,
    build_ivf,
    corpus_fingerprint,
    ivf_build_config,
    search_ivf_device,
    search_ivf_host,
)
from predictionio_tpu_torch.retrieval.pq import (
    PQCodebook,
    build_pq,
    pq_build_config,
    quantize_int8,
    search_ivf_pq_device,
    search_ivf_pq_host,
    search_pq_device,
    search_pq_host,
)

logger = logging.getLogger(__name__)

__all__ = ["Retriever", "Plan", "cached_retriever", "arm_on_create",
           "iter_hits", "build_train_index", "build_train_pq", "IVFIndex",
           "PQCodebook", "build_ivf", "build_pq", "corpus_fingerprint",
           "menu_k", "K_MENU", "RUNGS", "EXCLUDE_RUNGS"]

# K pads up to a short menu so varying ``num`` values share a handful
# of shapes (the reference's compiled-program menu).
K_MENU = (1, 10, 100, 1000)
_NEG_SENTINEL = -1e37  # scores at/below this are padding, never results

RUNGS = ("host", "device", "chunked", "sharded", "ivf", "ivf_pq",
         "pq_flat")
# Rungs that honor a per-request exclude mask (everything else pins the
# query to an exact rung — a blacklisted id must never be returned).
EXCLUDE_RUNGS = ("host", "device", "chunked")


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
    """Facade over the retrieval rungs for ONE item corpus.

    ``item_vecs`` is the host numpy corpus (possibly carrying padding
    rows past ``n_items``); ``ivf`` and ``pq`` are the generation's
    optional IVF index and PQ codebook.  The retriever stages what its
    rungs need (a host copy, the device corpus, the index and codebook
    constants, the re-rank corpus) lazily, at most one of each.
    ``device`` is where the device rungs run (default: the CUDA card,
    raising when there is none; see
    :func:`~predictionio_tpu_torch.device.device`).
    """

    def __init__(self, item_vecs, *, n_items: Optional[int] = None,
                 ivf: Optional[IVFIndex] = None,
                 pq: Optional[PQCodebook] = None, name: str = "default",
                 host_fn=None, device=None):
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
        # RLock: ivf_index()/pq_codebook() validate fingerprints under
        # the lock and that validation stages host_vecs(), which locks
        # again.
        self._lock = threading.RLock()
        self._ivf_raw = ivf
        self._ivf: Optional[IVFIndex] = None
        self._ivf_checked = False
        self._ivf_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._pq_raw = pq
        self._pq: Optional[PQCodebook] = None
        self._pq_checked = False
        self._pq_dev: Optional[Tuple[torch.Tensor, ...]] = None
        # Recall capture hook: armed per generation by
        # ``obs.recall.RecallMonitor`` — called after approximate-rung
        # answers with (retriever, plan, queries, ids, scanned) so
        # sampled requests can be exactly re-ranked off-thread.  None
        # (the default, and whenever PIO_RECALL=off) costs one attribute
        # read per topk.
        self.recall_hook = None
        self._rerank_dev: Dict = {}
        self._fp: Optional[str] = None
        reg = get_registry()
        self._m_requests = reg.counter(
            "pio_retrieval_requests_total",
            "Corpus retrievals by rung.", ("rung", "corpus"))
        self._m_candidates = reg.counter(
            "pio_retrieval_candidates_total",
            "Candidate item rows actually scored.", ("rung", "corpus"))
        self._m_latency = reg.histogram(
            "pio_retrieval_ms", "Retrieval latency per rung.", ("rung",))
        self._m_ivf_rejected = reg.counter(
            "pio_retrieval_ivf_rejected_total",
            "IVF indexes dropped for a fingerprint mismatch with the "
            "served corpus.", ("corpus",))
        self._m_pq_rejected = reg.counter(
            "pio_retrieval_pq_rejected_total",
            "PQ codebooks dropped for a fingerprint mismatch with the "
            "served corpus.", ("corpus",))

    # -- corpus staging -----------------------------------------------------

    @property
    def vecs(self):
        """The corpus array currently backing retrieval (numpy, or the
        mesh-sharded :class:`~predictionio_tpu_torch.parallel.mesh.
        ShardedTensor` :meth:`maybe_shard` last staged)."""
        return self._vecs

    @property
    def sharded(self) -> bool:
        v = self._vecs
        if not isinstance(v, ShardedTensor):
            return False
        axis = v.spec[0] if v.spec else None
        return axis is not None and v.shape[0] % v.mesh.shape[axis] == 0

    def host_vecs(self) -> np.ndarray:
        """[n_items, D] float32 numpy copy (trimmed of padding rows)."""
        if self._host is None:
            with self._lock:
                if self._host is None:
                    src = self._host_fn() if self._host_fn is not None \
                        else self._vecs
                    if isinstance(src, ShardedTensor):
                        src = src.to_host()
                    self._host = np.ascontiguousarray(
                        np.asarray(src, dtype=np.float32)[: self.n_items])
        return self._host

    def device_vecs(self) -> torch.Tensor:
        """The whole corpus on ``self.device`` — staged ONCE, reused
        across requests (from the host copy when the served corpus is
        mesh-sharded)."""
        if self._dev is None:
            src = self.host_vecs() if self.sharded else self._vecs
            with _exact.SERVE_CACHE_LOCK:
                if self._dev is None:
                    self._dev = torch.as_tensor(
                        np.require(src, np.float32, ("C", "W")),
                        device=self.device)
        return self._dev

    def maybe_shard(self, mesh, *, axis: Optional[str] = None) -> bool:
        """Row-shard the corpus over ``mesh`` at model-load time.

        The post_load hook's contract: above ``PIO_SERVE_SHARD_ABOVE``
        items the corpus is padded HOST-side to a multiple of the axis
        size (a device-side pad would stage the whole corpus on one
        device first) and placed shard by shard; predict then routes
        through the sharded rung.  Returns True when the corpus was
        (re)sharded.
        """
        if mesh is None:
            return False
        axis = axis or AXIS_DATA
        if axis not in mesh.shape:
            return False
        if self.n_items <= _env_int("PIO_SERVE_SHARD_ABOVE", 1_000_000):
            return False
        host = self.host_vecs()
        d = mesh.shape[axis]
        pad = (-host.shape[0]) % d
        vecs = np.pad(host, ((0, pad), (0, 0))) if pad else host
        self._vecs = put_sharded(vecs, mesh, PartitionSpec(axis))
        self._dev = None
        self._cache = {}
        # The f32 re-rank staging may hold the pre-shard device copy —
        # drop it so the old whole-corpus buffer can free.
        self._rerank_dev = {}
        return True

    # -- IVF / PQ lifecycle --------------------------------------------------

    def _corpus_fp(self) -> str:
        """SHA-1 of the served corpus — computed once, shared by the IVF
        and PQ tripwires."""
        if self._fp is None:
            with self._lock:
                if self._fp is None:
                    self._fp = corpus_fingerprint(self.host_vecs())
        return self._fp

    def ivf_index(self) -> Optional[IVFIndex]:
        """The generation's IVF index, fingerprint-validated ONCE against
        the corpus actually being served.  A mismatch (index from another
        generation next to these vectors) drops the index and counts —
        exact serving continues, recall never silently collapses."""
        if self._ivf_checked:
            return self._ivf
        with self._lock:
            if self._ivf_checked:
                return self._ivf
            idx = self._ivf_raw
            if idx is not None:
                if (idx.n_items != self.n_items or idx.dim != self.dim
                        or idx.fingerprint != self._corpus_fp()):
                    logger.error(
                        "IVF index fingerprint mismatch for corpus %r "
                        "(index n=%d/d=%d vs corpus n=%d/d=%d) — dropping "
                        "the index; serving stays exact", self.name,
                        idx.n_items, idx.dim, self.n_items, self.dim)
                    self._m_ivf_rejected.inc(corpus=self.name)
                    idx = None
            self._ivf = idx
            self._ivf_checked = True
        return self._ivf

    def ivf_device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Centroids ``[C, D]`` + padded lists ``[C, L]`` staged on the
        device ONCE per generation — index constants, never re-uploaded
        per request."""
        if self._ivf_dev is None:
            idx = self.ivf_index()   # locks self._lock: before the cache lock
            with _exact.SERVE_CACHE_LOCK:
                if self._ivf_dev is None:
                    self._ivf_dev = (
                        torch.as_tensor(idx.centroids, device=self.device),
                        torch.as_tensor(idx.lists, device=self.device))
        return self._ivf_dev

    def pq_codebook(self) -> Optional[PQCodebook]:
        """The generation's PQ codebook, fingerprint-validated ONCE
        against the served corpus.  A mismatched codebook (codes from
        another generation next to these vectors) is dropped loudly —
        exact serving continues, results are never silently wrong."""
        if self._pq_checked:
            return self._pq
        with self._lock:
            if self._pq_checked:
                return self._pq
            pq = self._pq_raw
            if pq is not None:
                if (pq.n_items != self.n_items or pq.dim != self.dim
                        or pq.fingerprint != self._corpus_fp()):
                    logger.error(
                        "PQ codebook fingerprint mismatch for corpus %r "
                        "(codes n=%d/d=%d vs corpus n=%d/d=%d) — "
                        "dropping the codebook; serving stays exact",
                        self.name, pq.n_items, pq.dim, self.n_items,
                        self.dim)
                    self._m_pq_rejected.inc(corpus=self.name)
                    pq = None
            self._pq = pq
            self._pq_checked = True
        return self._pq

    def pq_device_arrays(self) -> Tuple[torch.Tensor, ...]:
        """Coarse book [256, D] + codebooks [M, 256, D/M] + the packed
        code matrix TRANSPOSED to scan layout [1+M, N] uint8 — staged on
        the device ONCE per generation (the code matrix IS the resident
        quantized corpus)."""
        if self._pq_dev is None:
            pq = self.pq_codebook()  # locks self._lock: before the cache lock
            with _exact.SERVE_CACHE_LOCK:
                if self._pq_dev is None:
                    self._pq_dev = tuple(
                        torch.as_tensor(a, device=self.device) for a in (
                            pq.coarse, pq.codebooks,
                            np.ascontiguousarray(pq.codes.T)))
        return self._pq_dev

    def rerank_arrays(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The staged exact re-rank corpus under ``PIO_CORPUS_DTYPE``:
        ``(vectors, None)`` for f32/bf16 or ``(int8, row_scales)`` —
        per-dtype copies staged once, so a live retune of the env never
        re-uploads on the hot path.  f32 reuses the exact rungs' staged
        device copy outright."""
        raw = os.environ.get("PIO_CORPUS_DTYPE", "f32").strip().lower() \
            or "f32"
        dtype = {"f32": "f32", "float32": "f32", "bf16": "bf16",
                 "bfloat16": "bf16", "int8": "int8"}.get(raw)
        if dtype is None:
            logger.warning("PIO_CORPUS_DTYPE=%r is not one of "
                           "f32|bf16|int8; staging f32", raw)
            dtype = "f32"
        staged = self._rerank_dev.get(dtype)
        if staged is not None:
            return staged
        if dtype == "f32" and self.n_items * self.dim * 4 > 1 << 28:
            # Above ~256 MB the f32 default re-stages the very residency
            # PQ exists to remove — say so once, with the fix.
            logger.warning(
                "PQ re-rank corpus %r stages %.0f MB of fp32 on device "
                "(PIO_CORPUS_DTYPE=f32 default); set "
                "PIO_CORPUS_DTYPE=bf16 or int8 to shrink the resident "
                "re-rank copy 2-4x", self.name,
                self.n_items * self.dim * 4 / 2 ** 20)
        if dtype == "f32":
            # device_vecs() takes SERVE_CACHE_LOCK itself — stage it
            # BEFORE acquiring the lock here (non-reentrant).
            staged = (self.device_vecs(), None)
            self._rerank_dev[dtype] = staged
            return staged
        host = self.host_vecs()      # locks self._lock: before the cache lock
        with _exact.SERVE_CACHE_LOCK:
            staged = self._rerank_dev.get(dtype)
            if staged is None:
                if dtype == "bf16":
                    staged = (torch.as_tensor(host, device=self.device)
                              .to(torch.bfloat16), None)
                else:
                    q8, sc = quantize_int8(host)
                    staged = (torch.as_tensor(q8, device=self.device),
                              torch.as_tensor(sc, device=self.device))
                self._rerank_dev[dtype] = staged
        return staged

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
                # The sharded/IVF/PQ executors take no per-request mask —
                # honoring the exclusion beats honoring the forcing.
                logger.warning(
                    "PIO_RETRIEVAL_RUNG=%s cannot honor a per-request "
                    "exclude mask for corpus %r; serving exact", forced,
                    self.name)
                forced = "auto"
            if forced == "sharded" and not self.sharded:
                logger.warning("PIO_RETRIEVAL_RUNG=sharded but corpus %r "
                               "is not mesh-sharded; serving exact-device",
                               self.name)
                forced = "device"
            if forced == "ivf" and self.ivf_index() is None:
                logger.warning("PIO_RETRIEVAL_RUNG=ivf but corpus %r has "
                               "no valid index; serving exact", self.name)
                forced = "auto"
            if forced in ("ivf_pq", "pq_flat") \
                    and self.pq_codebook() is None:
                logger.warning("PIO_RETRIEVAL_RUNG=%s but corpus %r has "
                               "no valid PQ codebook; serving exact",
                               forced, self.name)
                forced = "auto"
            if forced == "ivf_pq" and self.ivf_index() is None:
                logger.warning("PIO_RETRIEVAL_RUNG=ivf_pq but corpus %r "
                               "has no valid IVF index; serving pq_flat",
                               self.name)
                forced = "pq_flat"
            if forced in RUNGS:
                return self._finish_plan(forced, b, k)
        work = b * self.n_items * self.dim
        host_macs = _env_int("PIO_SERVE_HOST_MACS", 2 * 10 ** 8)
        if has_exclude:
            # Per-request [B, N] masks ride the exact rungs only (an
            # excluded id must never cost recall the way an unprobed IVF
            # cell or a quantized shortlist would).
            if work <= host_macs:
                return self._finish_plan("host", b, k)
            if self.n_items > _env_int("PIO_SERVE_CHUNK_ABOVE", 2_000_000):
                return self._finish_plan("chunked", b, k)
            return self._finish_plan("device", b, k)
        if self.pq_codebook() is not None:
            # Quantized serving when the generation carries codes:
            # IVF-pruned with a valid index, the full LUT scan otherwise —
            # the exact re-rank holds recall either way.
            if self.ivf_index() is not None:
                return self._finish_plan("ivf_pq", b, k)
            return self._finish_plan("pq_flat", b, k)
        if self.ivf_index() is not None:
            return self._finish_plan("ivf", b, k)
        if work <= host_macs:
            return self._finish_plan("host", b, k)
        if self.sharded:
            return self._finish_plan("sharded", b, k)
        if self.n_items > _env_int("PIO_SERVE_CHUNK_ABOVE", 2_000_000):
            return self._finish_plan("chunked", b, k)
        return self._finish_plan("device", b, k)

    def _rerank_count(self, k: int) -> int:
        """PQ shortlist size: ``PIO_PQ_RERANK`` (absolute), default 4·k —
        clamped to [k, n_items].  The top-k the caller sees is always
        computed from exact scores over this many candidates."""
        raw = os.environ.get("PIO_PQ_RERANK", "").strip()
        r = 0
        if raw:
            try:
                r = int(raw)
            except ValueError:
                logger.warning("PIO_PQ_RERANK=%r is not an integer; "
                               "using the 4·k default", raw)
        if r <= 0:
            r = 4 * k
        return min(self.n_items, max(r, k))

    def _finish_plan(self, rung: str, b: int, k: int) -> Plan:
        if rung == "pq_flat":
            return Plan(rung=rung, k=k, rerank=self._rerank_count(k))
        if rung not in ("ivf", "ivf_pq"):
            return Plan(rung=rung, k=k)
        idx = self.ivf_index()
        # Static-shape guard: the probed lists must reach k (or, with a
        # PQ shortlist, rerank) REAL candidates even for the query
        # landing on the shortest lists.
        reach = self._rerank_count(k) if rung == "ivf_pq" else k
        nprobe = min(idx.nlist,
                     max(idx.default_nprobe(), idx.min_nprobe_for(reach)))
        if rung == "ivf_pq":
            return Plan(rung=rung, k=k, nprobe=nprobe, rerank=reach)
        return Plan(rung="ivf", k=k, nprobe=nprobe)

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
        with span("retrieval", corpus=self.name, rung=p.rung, batch=b,
                  k=p.k) as sp:
            scores, ids, scanned = self._execute(q, p, exclude)
            if p.nprobe:
                sp.set(nprobe=p.nprobe)
            if p.rerank:
                sp.set(rerank=p.rerank)
            sp.set(candidates=scanned)
        ms = (time.perf_counter() - t0) * 1e3
        self._m_requests.inc(rung=p.rung, corpus=self.name)
        self._m_candidates.inc(scanned, rung=p.rung, corpus=self.name)
        self._m_latency.observe(ms, rung=p.rung)
        # Waterfall hand-off: the serving batcher routes this into the
        # per-dispatch sink and fans it out to every member of the cohort
        # as the rung-tagged "retrieval" stage (⊂ dispatch).
        record_stage("retrieval", ms, rung=p.rung,
                     retrievalCandidates=scanned)
        hook = self.recall_hook
        if hook is not None and p.rung in ("ivf", "ivf_pq", "pq_flat"):
            # Sampled recall capture — the hook does its own shared-draw
            # sampling and bounded enqueue; it must never be able to fail
            # a serving answer.
            try:
                hook(self, p, q, ids, scanned)
            except Exception:
                logger.debug("recall capture failed", exc_info=True)
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
        if p.rung in ("pq_flat", "ivf_pq"):
            return self._execute_pq(q, p)
        if p.rung == "ivf":
            idx = self.ivf_index()
            # The sub-linear scan keeps the same host-vs-device economics
            # as the exact rungs, judged on the rows actually scored.
            est = b * p.nprobe * idx.pad_len * self.dim
            if est <= _env_int("PIO_SERVE_HOST_MACS", 2 * 10 ** 8):
                return search_ivf_host(idx, self.host_vecs(), q, p.k,
                                       p.nprobe)
            qp = _pow2_pad(q)
            s, i, scanned = search_ivf_device(
                idx, self.device_vecs(), qp, p.k, p.nprobe,
                jit_cache=self._cache, consts=self.ivf_device_arrays())
            # scanned counts the padded batch's probes; rescale to real.
            return s[:b], i[:b], int(scanned * b / max(len(qp), 1))
        qp = _pow2_pad(q)
        if exclude is not None and len(qp) > b:
            # The pow2 pad added all-zero query rows; give them
            # all-False mask rows so shapes stay aligned.
            exclude = np.concatenate(
                [exclude, np.zeros((len(qp) - b, exclude.shape[1]),
                                   dtype=bool)])
        if p.rung == "sharded":
            s, i = _exact.exact_sharded(qp, self._vecs, self.n_items, p.k)
        elif p.rung == "chunked":
            s, i = _exact.exact_chunked(qp, self.device_vecs(),
                                        self.n_items, p.k, exclude=exclude)
        else:
            s, i = _exact.exact_device(qp, self.device_vecs(),
                                       self.n_items, p.k,
                                       cache=self._cache, exclude=exclude)
        return s[:b], i[:b], b * self.n_items

    def _execute_pq(self, q: np.ndarray, p: Plan):
        """Quantized rungs: LUT scan (IVF-pruned or full) → exact
        re-rank.  Same host-vs-device economics as the other rungs,
        judged on code lookups (≈ 1 MAC each) plus the re-rank matmul."""
        b = q.shape[0]
        pq = self.pq_codebook()
        host_macs = _env_int("PIO_SERVE_HOST_MACS", 2 * 10 ** 8)
        rerank_macs = b * p.rerank * self.dim
        if p.rung == "pq_flat":
            est = b * self.n_items * pq.n_tables + rerank_macs
            if est <= host_macs:
                return search_pq_host(pq, self.host_vecs(), q, p.k,
                                      p.rerank)
            qp = _pow2_pad(q)
            s, i, scanned = search_pq_device(
                pq, qp, p.k, p.rerank, consts=self.pq_device_arrays(),
                rerank_consts=self.rerank_arrays())
            return s[:b], i[:b], int(scanned * b / max(len(qp), 1))
        idx = self.ivf_index()
        est = b * p.nprobe * idx.pad_len * pq.n_tables + rerank_macs
        if est <= host_macs:
            return search_ivf_pq_host(idx, pq, self.host_vecs(), q, p.k,
                                      p.nprobe, p.rerank)
        qp = _pow2_pad(q)
        s, i, scanned = search_ivf_pq_device(
            idx, pq, qp, p.k, p.nprobe, p.rerank,
            ivf_consts=self.ivf_device_arrays(),
            pq_consts=self.pq_device_arrays(),
            rerank_consts=self.rerank_arrays())
        # scanned counts the padded batch's probes; rescale to real.
        return s[:b], i[:b], int(scanned * b / max(len(qp), 1))


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


def build_train_index(item_vecs: np.ndarray, *, name: str,
                      seed: Optional[int] = None,
                      require_explicit: bool = False
                      ) -> Optional[IVFIndex]:
    """Train-time IVF build under the env policy (``PIO_IVF`` /
    ``PIO_IVF_NLIST`` / ``PIO_IVF_MIN_ITEMS``) — called by a template's
    ``train()`` so the index is pickled inside the same model artifact.

    ``require_explicit`` is for norm-variant corpora (raw ALS factors,
    popularity-scaled norms): k-means cells partition by direction, so a
    high-norm item in an unprobed cell is an unrecoverable miss — the
    index builds only under an explicit ``PIO_IVF=on``, never ``auto``.
    """
    if require_explicit:
        mode = os.environ.get("PIO_IVF", "auto").strip().lower() or "auto"
        if mode not in ("on", "1", "true", "yes"):
            logger.debug("IVF build skipped for %r: norm-variant corpus "
                         "needs explicit PIO_IVF=on (got %r)", name, mode)
            return None
    build, nlist, min_items = ivf_build_config(len(item_vecs))
    if not build:
        logger.debug("IVF build skipped for %r (n=%d < min=%d or PIO_IVF "
                     "off)", name, len(item_vecs), min_items)
        return None
    t0 = time.perf_counter()
    # seed=None pins to 0: two trains over identical data build identical
    # indexes.
    idx = build_ivf(np.asarray(item_vecs, dtype=np.float32), nlist=nlist,
                    seed=0 if seed is None else seed, force=True)
    logger.info("IVF index for %r built in %.1fs (nlist=%d)", name,
                time.perf_counter() - t0, idx.nlist if idx else -1)
    return idx


def build_train_pq(item_vecs: np.ndarray, *, name: str,
                   ivf: Optional[IVFIndex] = None,
                   seed: Optional[int] = None) -> Optional[PQCodebook]:
    """Train-time residual-PQ build under the env policy (``PIO_PQ`` /
    ``PIO_PQ_M`` / ``PIO_PQ_MIN_ITEMS``) — called by a template's
    ``train()`` AFTER the IVF build, so the residual coarse book can ride
    the same cells, and pickled inside the same model artifact.

    Unlike IVF, PQ needs no norm-variance opt-in: the exact re-rank
    re-scores every returned candidate against the true embeddings.
    """
    vecs = np.asarray(item_vecs, dtype=np.float32)
    build, m, min_items = pq_build_config(len(vecs), vecs.shape[1])
    if not build:
        logger.debug("PQ build skipped for %r (n=%d < min=%d or PIO_PQ "
                     "off)", name, len(vecs), min_items)
        return None
    t0 = time.perf_counter()
    # seed=None pins to 0 like build_train_index.
    pq = build_pq(vecs, m=m, ivf=ivf, seed=0 if seed is None else seed)
    logger.info("PQ codebook for %r built in %.1fs (M=%d, %d B/item)",
                name, time.perf_counter() - t0, pq.m, pq.bytes_per_item())
    return pq
