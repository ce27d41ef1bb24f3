"""Ragged → dense layout transforms (host numpy).

The port's own copy of ``predictionio_tpu/ops/ragged.py``: the same
functions and the same arrays, bit for bit (``tests/test_torch_als_kernels.py``
holds them equal).  Every ragged rating stream is converted host-side into
padded ``[rows, L]`` index / value blocks with a validity mask, bucketed by
row length so that short rows don't pay the max-degree padding cost, with
over-long rows split into partial rows (``split_above``).

All functions here run once per training run, before the blocks are
uploaded to the device.  Row lengths stay aligned to ``LEN_ALIGN`` as in
the reference, so both packages build the same buckets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Padded", "pad_ragged", "bucket_by_length", "segment_counts",
           "fit_bounds"]

# Padded row lengths are rounded up to this multiple.  The reference picks
# 8 for its accelerator's tiling; the port keeps it so that both packages
# build identical buckets (the fused gram kernel takes any L).
LEN_ALIGN = 8


@dataclasses.dataclass
class Padded:
    """A padded ragged batch.

    - ``indices``: int32 ``[rows, L]`` — column ids, 0 where padded
    - ``values``:  float32 ``[rows, L]`` — entry values, 0 where padded
    - ``mask``:    bool ``[rows, L]`` — True on real entries
    - ``row_ids``: int32 ``[rows]`` — original row id of each padded row

    Split buckets (``split_above``) additionally carry:

    - ``seg_ids``: int32 ``[rows]`` — segment slot of each partial row
      (several partial rows of one over-long entity share a slot)
    - ``ent_ids``: int32 ``[n_segments]`` — entity id per slot, -1 padding

    For split buckets ``row_ids`` repeats the entity id per partial row;
    consumers must segment-sum partial results by ``seg_ids`` before any
    per-entity math (ALS does this for the normal-equation pieces).
    """

    indices: np.ndarray
    values: np.ndarray
    mask: np.ndarray
    row_ids: np.ndarray
    seg_ids: Optional[np.ndarray] = None
    ent_ids: Optional[np.ndarray] = None

    @property
    def split(self) -> bool:
        return self.seg_ids is not None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.indices.shape  # type: ignore[return-value]


def segment_counts(rows: np.ndarray, n_rows: int) -> np.ndarray:
    """Entries per row (rows need not be sorted)."""
    return np.bincount(rows, minlength=n_rows).astype(np.int32)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_ragged(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: Optional[np.ndarray],
    n_rows: int,
    *,
    max_len: Optional[int] = None,
    pad_rows_to: int = 1,
) -> Padded:
    """COO triplets → one padded block ``[n_rows_padded, L]``.

    ``L`` = max row length (or ``max_len`` cap — rows beyond it are truncated,
    keeping the *latest* entries, matching the reference's LEventStore
    ``reversed=true, limit=N`` semantics for "recent interactions").
    ``pad_rows_to`` rounds the row count up (``LEN_ALIGN`` on one device).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if vals is None:
        vals = np.ones(len(rows), dtype=np.float32)
    vals = np.asarray(vals, dtype=np.float32)
    counts = segment_counts(rows, n_rows)
    natural = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    # Truncation honors max_len exactly; the ALLOCATED width is rounded up
    # to the sublane granule (the extra columns are masked padding).
    L = max(min(natural, max_len) if max_len else natural, 1)
    L_arr = _round_up(L, LEN_ALIGN)
    R = _round_up(max(n_rows, 1), pad_rows_to)

    # Stable sort by row so each row's entries are contiguous, preserving
    # insertion (event-time) order within a row.
    order = np.argsort(rows, kind="stable")
    r_sorted, c_sorted, v_sorted = rows[order], cols[order], vals[order]
    # Position of each entry within its row.
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(r_sorted)) - starts[r_sorted]
    # Truncate: keep the LAST L entries of overlong rows.
    keep = pos >= (counts[r_sorted] - L)
    r_k, c_k, v_k = r_sorted[keep], c_sorted[keep], v_sorted[keep]
    pos_k = pos[keep] - np.maximum(counts[r_k] - L, 0)

    indices = np.zeros((R, L_arr), dtype=np.int32)
    values = np.zeros((R, L_arr), dtype=np.float32)
    mask = np.zeros((R, L_arr), dtype=bool)
    indices[r_k, pos_k] = c_k
    values[r_k, pos_k] = v_k
    mask[r_k, pos_k] = True
    return Padded(indices=indices, values=values, mask=mask,
                  row_ids=np.arange(R, dtype=np.int32))


def fit_bounds(
    counts: np.ndarray,
    *,
    max_buckets: int = 12,
    align: int = LEN_ALIGN,
    cap: Optional[int] = None,
) -> List[int]:
    """Choose bucket bounds that minimize total padded slots.

    Exact DP over candidate cut points (the aligned unique degrees,
    quantile-thinned to ≤256): ``D[j, b]`` = min padded slots covering all
    rows with degree ≤ candidate j using b buckets.  Candidates are
    multiples of ``align`` so every bucket keeps the tiled lane/sublane
    layout (see LEN_ALIGN).  ``cap`` bounds the largest candidate (rows
    above it are the caller's split bucket).  Replaces the fixed
    power-of-4-ish default bounds: at the ML-25M shape those pad 1.66x on
    the user side; the fitted bounds pad ≤~1.1x.
    """
    counts = np.asarray(counts)
    counts = counts[counts > 0]
    if cap is not None:
        counts = np.minimum(counts, cap)
    if len(counts) == 0:
        return [align]
    aligned = (np.ceil(counts / align) * align).astype(np.int64)
    cands = np.unique(aligned)  # always covers every (clipped) degree
    if len(cands) > 256:  # thin by quantile, keep the extremes
        qs = np.quantile(cands, np.linspace(0, 1, 256))
        cands = np.unique((np.ceil(qs / align) * align).astype(np.int64))
    # rows_le[j] = #rows with aligned degree ≤ cands[j]
    rows_le = np.searchsorted(np.sort(aligned), cands, side="right")
    D = len(cands)
    B = min(max_buckets, D)
    INF = np.inf
    dp = np.full((D, B), INF)
    choice = np.zeros((D, B), dtype=np.int64)
    dp[:, 0] = cands * rows_le
    for b in range(1, B):
        for j in range(D):
            # over i < j: dp[i, b-1] + cands[j] * (rows_le[j] - rows_le[i])
            prev = dp[:j, b - 1] + cands[j] * (rows_le[j] - rows_le[:j])
            if len(prev):
                i = int(np.argmin(prev))
                if prev[i] < dp[j, b]:
                    dp[j, b] = prev[i]
                    choice[j, b] = i
            if dp[j, b - 1] < dp[j, b]:  # fewer buckets is allowed
                dp[j, b] = dp[j, b - 1]
                choice[j, b] = -1
    bounds = []
    j, b = D - 1, B - 1
    while True:
        c = choice[j, b]
        if b == 0:
            bounds.append(int(cands[j]))
            break
        if c == -1:
            b -= 1
            continue
        bounds.append(int(cands[j]))
        j, b = int(c), b - 1
    return sorted(set(bounds))


def bucket_by_length(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: Optional[np.ndarray],
    n_rows: int,
    *,
    bucket_bounds: Union[Sequence[int], str] = "auto",
    max_len: Optional[int] = None,
    pad_rows_to: int = 1,
    split_above: Optional[int] = None,
) -> List[Padded]:
    """COO triplets → per-length-bucket padded blocks.

    Rows are grouped by degree into buckets with padded length equal to the
    bucket bound, so a 3-item user costs 16 slots, not max-degree slots.
    This replaces Spark ALS's ragged shuffle blocks: a handful of dense
    shapes instead of one worst-case shape.
    Returns blocks ordered short→long; ``row_ids`` maps back to real rows.

    ``split_above``: rows longer than this are *split* into partial rows of
    at most ``split_above`` entries instead of padding every such row to the
    global max degree.  Without it, one zipf-head entity forces a bucket of
    shape [few, max_degree] that is mostly padding (measured 3.7x padded
    waste on the item side of an ML-1M-shape workload).  The returned split
    bucket carries ``seg_ids``/``ent_ids`` so consumers can segment-sum the
    partial results — exact, not an approximation (unlike ``max_len``,
    which truncates).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if vals is None:
        vals = np.ones(len(rows), dtype=np.float32)
    vals = np.asarray(vals, dtype=np.float32)
    counts = segment_counts(rows, n_rows)
    cap = max_len or (int(counts.max()) if len(counts) else 1)
    split_at = split_above if (split_above and split_above < cap) else None
    top = split_at if split_at else cap
    if isinstance(bucket_bounds, str):  # "auto": fit to the degree histogram
        bounds = fit_bounds(counts, cap=top)
    else:
        bounds = sorted(set(min(b, top) for b in bucket_bounds if b > 0))
    if not bounds or bounds[-1] < top:
        bounds.append(top)

    out: List[Padded] = []
    all_rows = np.arange(n_rows, dtype=np.int64)
    prev = 0
    for b in bounds:
        sel = all_rows[(counts > prev) & (counts <= b)] if prev else \
            all_rows[counts <= b]
        prev = b
        if len(sel) == 0:
            continue
        # Remap selected rows to 0..len(sel)-1, pad within the bucket.
        remap = np.full(n_rows, -1, dtype=np.int64)
        remap[sel] = np.arange(len(sel))
        in_bucket = remap[rows] >= 0
        p = pad_ragged(
            remap[rows[in_bucket]], cols[in_bucket], vals[in_bucket],
            len(sel), max_len=b, pad_rows_to=pad_rows_to,
        )
        real = np.full(p.indices.shape[0], -1, dtype=np.int32)
        real[: len(sel)] = sel.astype(np.int32)
        p.row_ids = real
        out.append(p)

    if split_at:
        sel = all_rows[counts > split_at]
        if len(sel):
            out.append(_split_bucket(rows, cols, vals, counts, sel,
                                     split_at, max_len, pad_rows_to))
    return out


def _split_bucket(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    counts: np.ndarray,
    sel: np.ndarray,
    seg_len: int,
    max_len: Optional[int],
    pad_rows_to: int,
) -> Padded:
    """Entities in ``sel`` (degree > seg_len) → partial rows of ``seg_len``."""
    n_rows = len(counts)
    in_split = np.isin(rows, sel)
    r_s, c_s, v_s = rows[in_split], cols[in_split], vals[in_split]
    order = np.argsort(r_s, kind="stable")
    r_s, c_s, v_s = r_s[order], c_s[order], v_s[order]
    # Position of each entry within its entity (entries are entity-sorted).
    counts_sel = counts[sel]
    starts = np.zeros(len(sel) + 1, dtype=np.int64)
    np.cumsum(counts_sel, out=starts[1:])
    seg_of_entity = np.full(n_rows, -1, dtype=np.int64)
    seg_of_entity[sel] = np.arange(len(sel))
    ent_slot = seg_of_entity[r_s]
    pos = np.arange(len(r_s)) - starts[ent_slot]
    if max_len is not None:
        # Truncation semantics match pad_ragged: keep the LAST max_len.
        keep = pos >= (counts_sel[ent_slot] - max_len)
        r_s, c_s, v_s = r_s[keep], c_s[keep], v_s[keep]
        ent_slot, pos = ent_slot[keep], pos[keep]
        pos = pos - np.maximum(counts_sel[ent_slot] - max_len, 0)
        counts_sel = np.minimum(counts_sel, max_len)
    partials_per = (counts_sel + seg_len - 1) // seg_len
    part_start = np.zeros(len(sel) + 1, dtype=np.int64)
    np.cumsum(partials_per, out=part_start[1:])
    n_part = int(part_start[-1])
    part_row = part_start[ent_slot] + pos // seg_len
    within = pos % seg_len

    R = _round_up(max(n_part, 1), pad_rows_to)
    n_seg = _round_up(max(len(sel), 1), pad_rows_to)
    indices = np.zeros((R, seg_len), dtype=np.int32)
    values = np.zeros((R, seg_len), dtype=np.float32)
    mask = np.zeros((R, seg_len), dtype=bool)
    indices[part_row, within] = c_s
    values[part_row, within] = v_s
    mask[part_row, within] = True
    row_ids = np.full(R, -1, dtype=np.int32)
    seg_ids = np.full(R, n_seg, dtype=np.int32)  # padding rows → OOB slot
    for e in range(len(sel)):
        sl = slice(int(part_start[e]), int(part_start[e + 1]))
        row_ids[sl] = sel[e]
        seg_ids[sl] = e
    ent_ids = np.full(n_seg, -1, dtype=np.int32)
    ent_ids[: len(sel)] = sel.astype(np.int32)
    return Padded(indices=indices, values=values, mask=mask, row_ids=row_ids,
                  seg_ids=seg_ids, ent_ids=ent_ids)
