"""Train-time IVF coarse index — sublinear candidate selection for MIPS.

Port of ``predictionio_tpu/retrieval/ivf.py``.  The host half (the
fingerprint, :class:`IVFIndex`, the build policy, the k-means build and
the numpy search) is a straight copy: the same seed gives identical
arrays.  The device half runs :func:`search_ivf_device` in PyTorch on
the device its tensors live on (``torch.matmul`` for the centroid
scores, a stable sort for the probed cells, gathers on the padded lists
with the ``-1`` slots masked, ``torch.topk``); the reference has no
kernel there either.

- **Padded lists, static shapes.**  Every inverted list is padded to the
  longest list's length with ``-1`` sentinels, so every gather has a
  fixed shape; the host search uses the same arrays.
- **Versioned with the model generation.**  The index carries a
  fingerprint of the exact vector matrix it was built over; the facade
  drops an index whose fingerprint does not match the corpus it is
  served next to.
- **Exact below a size threshold.**  ``PIO_IVF_MIN_ITEMS``: brute force
  over a small corpus beats any index walk.

Knobs: ``PIO_IVF`` (auto|on|off — build policy at train time),
``PIO_IVF_NLIST`` (centroid count, default ~sqrt(N)),
``PIO_IVF_NPROBE`` (lists scanned per query, default ~nlist/8),
``PIO_IVF_MIN_ITEMS`` (exact-fallback threshold, default 50k).

Raw ALS factors carry popularity-scaled norms, a poor fit for cells that
partition by direction: the recommendation template builds an index only
under an explicit ``PIO_IVF=on``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.retrieval.exact import _cached, _to_host

logger = logging.getLogger(__name__)

__all__ = ["IVFIndex", "build_ivf", "ivf_build_config", "corpus_fingerprint",
           "search_ivf_host", "search_ivf_device", "DEFAULT_MIN_ITEMS"]

DEFAULT_MIN_ITEMS = 50_000
_NEG_INF = np.float32(-3.4e38)


def corpus_fingerprint(vecs: np.ndarray) -> str:
    """Stable identity of a vector matrix (shape + content digest), over
    the contiguous float32 bytes, so the same vectors after a pickle
    round trip fingerprint identically."""
    a = np.ascontiguousarray(vecs, dtype=np.float32)
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class IVFIndex:
    """K-means centroids + padded inverted lists over one item corpus,
    pickled inside the model wrapper it indexes."""

    centroids: np.ndarray      # [C, D] f32
    lists: np.ndarray          # [C, L] int32, -1 = padding
    list_lengths: np.ndarray   # [C] int32 — true (unpadded) lengths
    n_items: int
    dim: int
    nlist: int
    pad_len: int               # L
    fingerprint: str           # corpus_fingerprint of the indexed vectors

    def default_nprobe(self) -> int:
        """Serve-time probe width: env override, else ~nlist/8 (≥ 1)."""
        raw = os.environ.get("PIO_IVF_NPROBE", "").strip()
        if raw:
            try:
                return max(1, min(int(raw), self.nlist))
            except ValueError:
                pass
        return max(1, -(-self.nlist // 8))

    def candidates_scanned(self, probe_ids: np.ndarray) -> int:
        """True candidate rows scored for a [B, P] probe assignment."""
        return int(self.list_lengths[probe_ids].sum())

    def min_nprobe_for(self, k: int) -> int:
        """Smallest probe width that guarantees ≥ k real candidates for
        any query: in the worst case it probes the shortest lists, so the
        bound uses true list lengths, not ``nprobe · pad_len``."""
        cum = getattr(self, "_worst_case_cum", None)
        if cum is None:
            cum = np.cumsum(np.sort(np.asarray(self.list_lengths,
                                               dtype=np.int64)))
            self._worst_case_cum = cum
        if cum[-1] < k:
            return self.nlist
        return int(np.searchsorted(cum, k)) + 1


def ivf_build_config(n_items: int) -> Tuple[bool, int, int]:
    """(should_build, nlist, min_items) from the env at train time."""
    mode = os.environ.get("PIO_IVF", "auto").strip().lower() or "auto"
    try:
        min_items = int(os.environ.get("PIO_IVF_MIN_ITEMS",
                                       str(DEFAULT_MIN_ITEMS)))
    except ValueError:
        min_items = DEFAULT_MIN_ITEMS
    if mode in ("off", "0", "false", "no"):
        return False, 0, min_items
    if n_items < min_items:
        # Below the threshold brute force wins — never build (mode=on
        # included; the threshold is the contract).
        return False, 0, min_items
    raw = os.environ.get("PIO_IVF_NLIST", "").strip()
    nlist = 0
    if raw:
        try:
            nlist = max(1, min(int(raw), n_items))
        except ValueError:
            logger.warning("PIO_IVF_NLIST=%r is not an integer; using "
                           "the ~sqrt(N) default", raw)
    if not nlist:
        nlist = max(1, min(int(round(float(n_items) ** 0.5)), n_items))
    return True, nlist, min_items


def build_ivf(item_vecs: np.ndarray, *, nlist: Optional[int] = None,
              iters: int = 6, sample: int = 65_536, seed: int = 0,
              force: bool = False) -> Optional[IVFIndex]:
    """Spherical k-means index over ``item_vecs`` ([N, D] host array).

    Centroids train on a deterministic sample; the full assignment pass
    is the only full-corpus scan.  Returns ``None`` when the env policy
    says exact-only (``force=True`` skips the policy, not the math).
    """
    vecs = np.ascontiguousarray(item_vecs, dtype=np.float32)
    n, d = vecs.shape
    if force:
        c = nlist or max(1, min(int(round(float(n) ** 0.5)), n))
    else:
        build, c, _ = ivf_build_config(n)
        if not build:
            return None
        c = nlist or c
    c = max(1, min(c, n))
    rng = np.random.default_rng(seed)
    # Direction-only clustering: normalize a working copy so cells
    # partition the sphere.
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    unit = vecs / np.where(norms < 1e-9, 1.0, norms)
    train = unit[rng.choice(n, size=min(sample, n), replace=False)] \
        if n > sample else unit
    centroids = train[rng.choice(len(train), size=c, replace=False)].copy()
    for _ in range(iters):
        # [S, C] cosine scores; argmax assignment; mean + renormalize.
        assign = np.argmax(train @ centroids.T, axis=1)
        for ci in range(c):
            members = train[assign == ci]
            if len(members):
                centroids[ci] = members.mean(axis=0)
        cn = np.linalg.norm(centroids, axis=1, keepdims=True)
        centroids = centroids / np.where(cn < 1e-9, 1.0, cn)
    # Full assignment pass, chunked so the [chunk, C] block stays small.
    assign = np.empty(n, dtype=np.int64)
    step = max(1, 4_194_304 // max(c, 1))
    for s in range(0, n, step):
        assign[s:s + step] = np.argmax(unit[s:s + step] @ centroids.T, axis=1)
    counts = np.bincount(assign, minlength=c)
    pad_len = max(1, int(counts.max()))
    lists = np.full((c, pad_len), -1, dtype=np.int32)
    # Members in id order within each cell — the reference's per-item
    # fill loop, in one scatter.
    order = np.argsort(assign, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.arange(n) - np.repeat(starts, counts)
    lists[assign[order], slot] = order
    index = IVFIndex(
        centroids=centroids.astype(np.float32),
        lists=lists,
        list_lengths=counts.astype(np.int32),
        n_items=n, dim=d, nlist=c, pad_len=pad_len,
        fingerprint=corpus_fingerprint(vecs),
    )
    logger.info("built IVF index: %d items → %d lists (pad_len=%d, "
                "mean len %.1f)", n, c, pad_len, counts.mean())
    return index


def search_ivf_host(index: IVFIndex, item_vecs: np.ndarray,
                    queries: np.ndarray, k: int, nprobe: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Numpy IVF search — the serving fast path for small batches.

    Returns ([B, k] f32 scores, [B, k] int32 ids, candidates scanned).
    Rows with fewer than k reachable candidates pad with NEG_INF/-1.
    """
    q = np.ascontiguousarray(queries, dtype=np.float32)
    b = q.shape[0]
    nprobe = max(1, min(nprobe, index.nlist))
    cq = q @ index.centroids.T                         # [B, C]
    if nprobe < index.nlist:
        probe = np.argpartition(-cq, nprobe - 1, axis=1)[:, :nprobe]
    else:
        probe = np.broadcast_to(np.arange(index.nlist), (b, index.nlist))
    out_s = np.full((b, k), _NEG_INF, dtype=np.float32)
    out_i = np.full((b, k), -1, dtype=np.int32)
    for row in range(b):
        cand = index.lists[probe[row]].ravel()
        cand = cand[cand >= 0]
        if cand.size == 0:
            continue
        sc = item_vecs[cand] @ q[row]
        kk = min(k, sc.size)
        part = np.argpartition(-sc, kk - 1)[:kk] if kk < sc.size \
            else np.arange(sc.size)
        order = part[np.argsort(-sc[part], kind="stable")]
        out_s[row, :kk] = sc[order]
        out_i[row, :kk] = cand[order]
    return out_s, out_i, index.candidates_scanned(probe)


def probe_lists(q: torch.Tensor, centroids: torch.Tensor,
                lists: torch.Tensor, nprobe: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``nprobe`` best cells of each query and their padded member
    ids: ([B, P] int64 probe ids, [B, P·L] int64 candidates, -1 = pad).
    Equal centroid scores rank the lower cell first, as ``lax.top_k``
    does (the zero rows of a padded batch tie on every cell)."""
    cq = q @ centroids.T                               # [B, C]
    probe = torch.sort(cq, dim=1, descending=True,
                       stable=True).indices[:, :nprobe]  # [B, P]
    return probe, lists[probe].reshape(q.shape[0], -1).long()


def search_ivf_device(index: IVFIndex, items_dev: torch.Tensor, queries,
                      k: int, nprobe: int, *, jit_cache: Dict,
                      consts: Optional[tuple] = None
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """IVF search on ``items_dev``'s device for larger batches: centroid
    scores, the ``nprobe`` best cells, a gather of their padded members,
    float32 scores with the ``-1`` slots masked, ``torch.topk``.

    ``consts`` is the caller's pre-staged ``(centroids, lists)`` device
    pair; without it the pair is staged once into ``jit_cache``, the
    caller-owned dict of request-invariant device state.
    """
    dev = items_dev.device
    nprobe = max(1, min(nprobe, index.nlist))
    if consts is None:
        consts = _cached(jit_cache, ("ivf_consts",), lambda: (
            torch.as_tensor(index.centroids, device=dev),
            torch.as_tensor(index.lists, device=dev)))
    cent, lists = consts
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32),
                        device=dev)
    probe, cand = probe_lists(q, cent, lists, nprobe)
    vecs = items_dev[cand.clamp(min=0)].float()        # [B, P·L, D]
    sc = torch.einsum("bd,bnd->bn", q, vecs)
    sc = sc.masked_fill(cand < 0, float(_NEG_INF))
    top_s, pos = torch.topk(sc, k, dim=1)
    top_i = torch.gather(cand, 1, pos).to(torch.int32)
    top_s, top_i, probe = _to_host(top_s, top_i, probe)
    return top_s, top_i, index.candidates_scanned(probe)
