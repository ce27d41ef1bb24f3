"""Product-quantized corpora — the memory side of approximate retrieval.

Port of ``predictionio_tpu/retrieval/pq.py``.  Residual product
quantization stores each item as a coarse centroid (1 byte) plus ``M``
per-subspace codebook entries (1 byte each).  Serving scores codes
asymmetrically: the query stays exact, per-query lookup tables (LUTs) of
``query · codebook-entry`` inner products are built once, and the score
of item ``n`` is ``Σ_t lut[t, codes[n, t]]``, exactly ``q · decode(n)``.
A shortlist of ``rerank`` candidates is then re-scored against the exact
embeddings, so recall never rides the quantization error.

The host half (:class:`PQCodebook`, the build policy, the build,
``decode_pq``, ``lut_tables``, the numpy searches, ``quantize_int8``) is
a straight copy: the same seed gives identical arrays.  The device half
is PyTorch on the device its tensors live on: the LUTs and the exact
re-rank are float32 einsums, ``torch.topk`` and gathers; ``pq_flat``
scans every code column with kernel K5 (:func:`~predictionio_tpu_torch.
ops.pq_scan.pq_scan`); ``ivf_pq`` gathers the LUTs over the probed cells'
members with ``torch.gather`` (the reference has no kernel there).

- **Residual on top of the coarse quantizer.**  Codes quantize
  ``x − coarse[c0(x)]``; with an IVF index the coarse book is derived
  from its centroids (reused at nlist ≤ 256, else the 256 heaviest-list
  centroids refined by Lloyd iterations).
- **Uniform [1+M, 256] tables.**  The coarse book is padded to 256 rows,
  so the coarse term is table 0 of the LUT stack and the scan sees one
  [B, S, 256] LUT block and one packed [S, N] uint8 code matrix.
- **Versioned with the generation.**  The codebook carries the same
  corpus fingerprint as the IVF index; the facade drops a mismatch.

Knobs: ``PIO_PQ`` (auto|on|off — build policy), ``PIO_PQ_M``
(subspaces, default ~D/4 rounded to a divisor), ``PIO_PQ_MIN_ITEMS``
(exact-only below, default 200k), ``PIO_PQ_RERANK`` (shortlist size,
default 4·k), ``PIO_CORPUS_DTYPE`` (f32|bf16|int8 re-rank corpus).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.pq_scan import pq_scan
from predictionio_tpu_torch.retrieval.exact import _to_host
from predictionio_tpu_torch.retrieval.ivf import (
    IVFIndex,
    corpus_fingerprint,
    probe_lists,
)

logger = logging.getLogger(__name__)

__all__ = ["PQCodebook", "build_pq", "pq_build_config", "lut_tables",
           "decode_pq", "search_pq_host", "search_ivf_pq_host",
           "search_pq_device", "search_ivf_pq_device", "quantize_int8",
           "DEFAULT_PQ_MIN_ITEMS"]

DEFAULT_PQ_MIN_ITEMS = 200_000
_NEG_INF = np.float32(-3.4e38)
_SENTINEL = -1e37  # at/below = padding (matches the facade's sentinel)


@dataclasses.dataclass
class PQCodebook:
    """Residual PQ codes + codebooks over one item corpus, pickled inside
    the model wrapper next to the IVF index.  ``codes`` column 0 is the
    coarse assignment; columns ``1..M`` the per-subspace residual codes."""

    coarse: np.ndarray     # [256, D] f32 — rows >= n_coarse are zero pad
    codebooks: np.ndarray  # [M, 256, D/M] f32
    codes: np.ndarray      # [N, 1+M] uint8
    n_coarse: int          # real coarse centroids (<= 256)
    n_items: int
    dim: int
    m: int                 # residual subspaces
    fingerprint: str       # corpus_fingerprint of the quantized vectors

    @property
    def dsub(self) -> int:
        return self.dim // self.m

    @property
    def n_tables(self) -> int:
        """LUT stack height: coarse table + one per subspace."""
        return self.m + 1

    def bytes_per_item(self) -> int:
        """Resident bytes per corpus row."""
        return self.codes.shape[1]


def _resolve_m(dim: int, requested: Optional[int]) -> int:
    """Subspace count: requested (or ~D/4), rounded DOWN to a divisor of
    D so every subspace has the same width."""
    m = requested if requested and requested > 0 else max(1, dim // 4)
    m = max(1, min(m, dim))
    while dim % m:
        m -= 1
    return m


def pq_build_config(n_items: int, dim: int) -> Tuple[bool, int, int]:
    """(should_build, m, min_items) from the env at train time."""
    mode = os.environ.get("PIO_PQ", "auto").strip().lower() or "auto"
    try:
        min_items = int(os.environ.get("PIO_PQ_MIN_ITEMS",
                                       str(DEFAULT_PQ_MIN_ITEMS)))
    except ValueError:
        min_items = DEFAULT_PQ_MIN_ITEMS
    if mode in ("off", "0", "false", "no"):
        return False, 0, min_items
    if mode not in ("auto", "on", "1", "true", "yes"):
        # A typo'd opt-out must not silently build (and then serve)
        # codes the operator tried to disable.
        logger.warning("PIO_PQ=%r is not one of auto|on|off; treating "
                       "as auto", mode)
    if n_items < min_items:
        # Below the threshold the exact rungs already meet latency
        # (mode=on included; the threshold is the contract).
        return False, 0, min_items
    req = None
    raw = os.environ.get("PIO_PQ_M", "").strip()
    if raw:
        try:
            req = int(raw)
        except ValueError:
            logger.warning("PIO_PQ_M=%r is not an integer; using the "
                           "~D/4 default", raw)
    return True, _resolve_m(dim, req), min_items


def _assign_euclidean(data: np.ndarray, centroids: np.ndarray,
                      chunk: int = 262_144) -> np.ndarray:
    """Chunked nearest-centroid assignment (Euclidean).  ``-2·x·cᵀ +
    ‖c‖²`` suffices for the argmin — ‖x‖² is row-constant."""
    c2 = np.einsum("cd,cd->c", centroids, centroids)
    out = np.empty(len(data), dtype=np.int64)
    for s in range(0, len(data), chunk):
        d = data[s:s + chunk] @ (-2.0 * centroids.T) + c2[None, :]
        out[s:s + chunk] = np.argmin(d, axis=1)
    return out


def _lloyd(data: np.ndarray, centroids: np.ndarray,
           iters: int) -> np.ndarray:
    """A few Lloyd iterations refining ``centroids`` over ``data``
    (Euclidean: the reconstruction error bounds the score error
    ``|q·x − q·x̂| ≤ ‖q‖·‖x − x̂‖`` whatever the norms).  Empty clusters
    keep their previous centroid."""
    cent = centroids.copy()
    for _ in range(iters):
        assign = _assign_euclidean(data, cent)
        sums = np.zeros_like(cent, dtype=np.float64)
        np.add.at(sums, assign, data)
        counts = np.bincount(assign, minlength=len(cent))
        nz = counts > 0
        cent[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    return cent


def _coarse_book(vecs: np.ndarray, sample: np.ndarray,
                 ivf: Optional[IVFIndex], iters: int,
                 rng: np.random.Generator) -> np.ndarray:
    """<= 256 coarse centroids, derived from the IVF structure when one
    exists (reuse at nlist <= 256; else the heaviest-list centroids,
    refined on the raw vectors)."""
    c0 = min(256, len(vecs))
    if ivf is not None and ivf.dim == vecs.shape[1]:
        if ivf.nlist <= c0:
            return _lloyd(sample, ivf.centroids.astype(np.float32).copy(),
                          max(1, iters // 2))
        heavy = np.argsort(-np.asarray(ivf.list_lengths))[:c0]
        init = ivf.centroids[np.sort(heavy)].astype(np.float32).copy()
        return _lloyd(sample, init, max(1, iters // 2))
    init = sample[rng.choice(len(sample), size=c0, replace=False)].copy()
    return _lloyd(sample, init, iters)


def build_pq(item_vecs: np.ndarray, *, m: Optional[int] = None,
             ivf: Optional[IVFIndex] = None, sample: int = 65_536,
             iters: int = 8, seed: int = 0) -> PQCodebook:
    """Residual PQ over ``item_vecs`` ([N, D] host array).  The coarse
    book and the subspace codebooks train on a deterministic bounded
    sample; the full corpus is touched only by the chunked encode."""
    vecs = np.ascontiguousarray(item_vecs, dtype=np.float32)
    n, d = vecs.shape
    m = _resolve_m(d, m)
    rng = np.random.default_rng(seed)
    sel = rng.choice(n, size=min(sample, n), replace=False) \
        if n > sample else np.arange(n)
    coarse = _coarse_book(vecs, vecs[sel], ivf, iters, rng)
    n_coarse = len(coarse)
    codes = np.zeros((n, 1 + m), dtype=np.uint8)
    codes[:, 0] = _assign_euclidean(vecs, coarse).astype(np.uint8)
    # Residuals of the SAMPLE train the subspace books; the full-corpus
    # residual is recomputed chunk by chunk in the encode pass.
    res_sample = vecs[sel] - coarse[codes[sel, 0]]
    ds = d // m
    books = np.empty((m, 256, ds), dtype=np.float32)
    for mi in range(m):
        sub = np.ascontiguousarray(res_sample[:, mi * ds:(mi + 1) * ds])
        kk = min(256, len(sub))
        init = sub[rng.choice(len(sub), size=kk, replace=False)].copy()
        book = _lloyd(sub, init, iters)
        if kk < 256:
            book = np.pad(book, ((0, 256 - kk), (0, 0)))
        books[mi] = book
    chunk = 262_144
    for s in range(0, n, chunk):
        res = vecs[s:s + chunk] - coarse[codes[s:s + chunk, 0]]
        for mi in range(m):
            sub = np.ascontiguousarray(res[:, mi * ds:(mi + 1) * ds])
            codes[s:s + chunk, 1 + mi] = \
                _assign_euclidean(sub, books[mi]).astype(np.uint8)
    pad = np.zeros((256, d), dtype=np.float32)
    pad[:n_coarse] = coarse
    pq = PQCodebook(coarse=pad, codebooks=books, codes=codes,
                    n_coarse=n_coarse, n_items=n, dim=d, m=m,
                    fingerprint=corpus_fingerprint(vecs))
    err = float(np.mean(np.linalg.norm(
        vecs[sel] - decode_pq(pq, sel), axis=1)))
    logger.info("built PQ codebook: %d items × %dD → %d B/item "
                "(M=%d, coarse=%d), mean residual |x-x̂| %.4f",
                n, d, pq.bytes_per_item(), m, n_coarse, err)
    return pq


def decode_pq(pq: PQCodebook, ids: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """Reconstructed vectors ``x̂`` for ``ids`` (default: all items) —
    the LUT score of an item is exactly ``q · decode(item)``."""
    codes = pq.codes if ids is None else pq.codes[np.asarray(ids)]
    out = pq.coarse[codes[..., 0].astype(np.int64)].copy()
    ds = pq.dsub
    for mi in range(pq.m):
        out[..., mi * ds:(mi + 1) * ds] += \
            pq.codebooks[mi][codes[..., 1 + mi].astype(np.int64)]
    return out


def lut_tables(pq: PQCodebook, queries: np.ndarray) -> np.ndarray:
    """Per-query asymmetric-distance tables ``[B, 1+M, 256]`` f32: table
    0 the coarse inner products, table ``1+m`` the subspace-m residual
    inner products."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    b, d = q.shape
    ds = pq.dsub
    luts = np.empty((b, pq.n_tables, 256), dtype=np.float32)
    luts[:, 0, :] = q @ pq.coarse.T
    qs = q.reshape(b, pq.m, ds)
    luts[:, 1:, :] = np.einsum("bmd,mcd->bmc", qs, pq.codebooks)
    return luts


def _merge_topr(best_s, best_i, s, i, r):
    """Fold a [B, C] score block into the running [B, r] best set."""
    ms = np.concatenate([best_s, s], axis=1)
    mi = np.concatenate([best_i, i], axis=1)
    if ms.shape[1] > r:
        part = np.argpartition(-ms, r - 1, axis=1)[:, :r]
        return (np.take_along_axis(ms, part, axis=1),
                np.take_along_axis(mi, part, axis=1))
    return ms, mi


def _rerank_host(q: np.ndarray, host_vecs: np.ndarray, cand_s, cand_i,
                 k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact re-score of the PQ shortlist; sentinel rows stay sentinel."""
    b, r = cand_i.shape
    safe = np.maximum(cand_i, 0)
    exact = np.einsum("bd,brd->br", q, host_vecs[safe])
    exact = np.where(cand_s <= _SENTINEL, _NEG_INF, exact)
    kk = min(k, r)
    part = np.argpartition(-exact, kk - 1, axis=1)[:, :kk]
    ps = np.take_along_axis(exact, part, axis=1)
    order = np.argsort(-ps, axis=1, kind="stable")
    top = np.take_along_axis(part, order, axis=1)
    out_s = np.take_along_axis(exact, top, axis=1).astype(np.float32)
    out_i = np.take_along_axis(cand_i, top, axis=1).astype(np.int32)
    out_i = np.where(out_s <= _SENTINEL, -1, out_i)
    if kk < k:
        out_s = np.pad(out_s, ((0, 0), (0, k - kk)),
                       constant_values=_NEG_INF)
        out_i = np.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
    return out_s, out_i


def search_pq_host(pq: PQCodebook, host_vecs: np.ndarray,
                   queries: np.ndarray, k: int, rerank: int,
                   chunk: int = 1 << 19
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Numpy full LUT scan + exact re-rank — the pq_flat serving fast
    path.  Returns ([B, k] f32, [B, k] int32, code rows scanned)."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    b = q.shape[0]
    n = pq.n_items
    luts = lut_tables(pq, q)
    r = min(max(rerank, k), n)
    best_s = np.full((b, 0), _NEG_INF, dtype=np.float32)
    best_i = np.zeros((b, 0), dtype=np.int32)
    for s0 in range(0, n, chunk):
        c = pq.codes[s0:s0 + chunk]
        acc = np.ascontiguousarray(luts[:, 0, :][:, c[:, 0]])
        for mi in range(1, pq.n_tables):
            acc += luts[:, mi, :][:, c[:, mi]]
        ids = np.broadcast_to(
            np.arange(s0, s0 + len(c), dtype=np.int32), acc.shape)
        best_s, best_i = _merge_topr(best_s, best_i, acc, ids, r)
    out_s, out_i = _rerank_host(q, host_vecs, best_s, best_i, k)
    return out_s, out_i, b * n


def search_ivf_pq_host(index: IVFIndex, pq: PQCodebook,
                       host_vecs: np.ndarray, queries: np.ndarray,
                       k: int, nprobe: int, rerank: int
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
    """IVF-pruned LUT scan + exact re-rank: probe ``nprobe`` cells, score
    only their members' codes, shortlist, re-rank exactly.  Returns
    ([B, k], [B, k] int32, rows scanned)."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    b = q.shape[0]
    nprobe = max(1, min(nprobe, index.nlist))
    luts = lut_tables(pq, q)
    cq = q @ index.centroids.T
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
        c = pq.codes[cand]
        sc = luts[row, 0][c[:, 0]]
        for mi in range(1, pq.n_tables):
            sc = sc + luts[row, mi][c[:, mi]]
        r = min(max(rerank, k), sc.size)
        part = np.argpartition(-sc, r - 1)[:r] if r < sc.size \
            else np.arange(sc.size)
        short = cand[part]
        exact = host_vecs[short] @ q[row]
        kk = min(k, exact.size)
        top = np.argpartition(-exact, kk - 1)[:kk] if kk < exact.size \
            else np.arange(exact.size)
        order = top[np.argsort(-exact[top], kind="stable")]
        out_s[row, :kk] = exact[order]
        out_i[row, :kk] = short[order]
    return out_s, out_i, index.candidates_scanned(probe)


# -- device paths ------------------------------------------------------------


def quantize_int8(vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of a re-rank corpus:
    ``row ≈ q8 · scale`` with ``scale = max|row| / 127`` (zero rows get
    scale 1 so dequantization is exact zeros)."""
    v = np.ascontiguousarray(vecs, dtype=np.float32)
    peak = np.max(np.abs(v), axis=1)
    scale = np.where(peak > 0, peak / 127.0, 1.0).astype(np.float32)
    q8 = np.clip(np.rint(v / scale[:, None]), -127, 127).astype(np.int8)
    return q8, scale


def device_luts(q: torch.Tensor, coarse: torch.Tensor,
                books: torch.Tensor) -> torch.Tensor:
    """[B, 1+M, 256] float32 LUTs from the staged codebooks."""
    b = q.shape[0]
    m, _, ds = books.shape
    lut0 = q @ coarse.T
    lutm = torch.einsum("bmd,mcd->bmc", q.reshape(b, m, ds), books)
    return torch.cat([lut0[:, None, :], lutm], dim=1).contiguous()


def _rerank_device(q, cand_s, cand_i, rvecs, scales, k: int):
    """Exact re-score of a device shortlist ([B, R] ids) against the
    staged re-rank corpus (f32/bf16, or int8 + per-row scales)."""
    safe = cand_i.long().clamp(min=0)
    vecs = rvecs[safe].float()                          # [B, R, D]
    if scales is not None:
        vecs = vecs * scales[safe][..., None]
    exact = torch.einsum("bd,brd->br", q, vecs)
    exact = exact.masked_fill(cand_s <= _SENTINEL, float(_NEG_INF))
    top_s, pos = torch.topk(exact, min(k, exact.shape[1]), dim=1)
    top_i = torch.gather(cand_i.to(torch.int32), 1, pos)
    return top_s, top_i.masked_fill(top_s <= _SENTINEL, -1)


def search_pq_device(pq: PQCodebook, queries, k: int, rerank: int, *,
                     consts: tuple, rerank_consts: tuple
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Full LUT scan with kernel K5 (its plain version on the CPU) +
    exact re-rank, on the device of the staged constants.  ``consts`` is
    the caller's ``(coarse, codebooks, codes[S, N])`` device triple and
    ``rerank_consts`` its staged ``(vectors, scales|None)`` re-rank
    corpus — generation constants, never re-uploaded per request."""
    coarse, books, codes_sn = consts
    rvecs, scales = rerank_consts
    b = queries.shape[0]
    r = min(max(rerank, k), pq.n_items)
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32),
                        device=coarse.device)
    s_r, i_r = pq_scan(device_luts(q, coarse, books), codes_sn, r,
                       n_valid=pq.n_items)
    s, i = _to_host(*_rerank_device(q, s_r, i_r, rvecs, scales, k))
    return s, i, b * pq.n_items


def search_ivf_pq_device(index: IVFIndex, pq: PQCodebook, queries,
                         k: int, nprobe: int, rerank: int, *,
                         ivf_consts: tuple, pq_consts: tuple,
                         rerank_consts: tuple
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """IVF-pruned LUT scan + exact re-rank: the probed cells' members'
    codes are gathered and their LUT entries summed with
    ``torch.gather`` (no kernel, as in the reference), then the ``-1``
    slots masked, a ``rerank`` shortlist taken and re-ranked exactly."""
    cent, lists = ivf_consts
    coarse, books, codes_sn = pq_consts
    rvecs, scales = rerank_consts
    nprobe = max(1, min(nprobe, index.nlist))
    r = min(max(rerank, k), nprobe * index.pad_len)
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32),
                        device=coarse.device)
    luts = device_luts(q, coarse, books)
    probe, cand = probe_lists(q, cent, lists, nprobe)   # [B, P·L]
    cc = codes_sn[:, cand.clamp(min=0)]                 # [S, B, P·L] u8
    s = torch.gather(luts[:, 0, :], 1, cc[0].long())
    for t in range(1, codes_sn.shape[0]):
        s = s + torch.gather(luts[:, t, :], 1, cc[t].long())
    s = s.masked_fill(cand < 0, float(_NEG_INF))
    s_r, pos = torch.topk(s, min(r, s.shape[1]), dim=1)
    i_r = torch.gather(cand, 1, pos)
    top_s, top_i = _rerank_device(q, s_r, i_r, rvecs, scales, k)
    s, i, probe = _to_host(top_s, top_i, probe)
    return s, i, index.candidates_scanned(probe)
