"""Ragged → padded bucketing of the ALS ratings on the training device.

Port of ``predictionio_tpu/ops/device_prep.py``.  The host bucketing of
:mod:`predictionio_tpu_torch.ops.ragged` is exact but costs tens of
seconds of single-threaded numpy at the MovieLens-25M shape, plus the
upload of every padded block.  Here the compact COO triplets go up once
(12 bytes a rating) and the whole layout transform — degree counts,
bucket of each entity, stable grouping, padded-block scatter, the split
of zipf-head entities — runs as torch library ops on the device, where
a 25 M-element sort is milliseconds.

- :func:`plan_buckets` (host): the degree histogram → a static
  :class:`BucketPlan` (bucket bounds, padded row counts, flat-buffer
  offsets, memory chunks).  Copied from the reference as it is.
- :func:`degree_histogram` / :func:`build_buckets` (device): plain
  functions on tensors on the device they are given.  Every entry is
  scattered into a flat ``[total_slots]`` buffer at a computed
  destination, and each bucket's ``[R, L]`` block is a view of it.

The output is the reference's: the same bucket order, row order (entity
id within a bucket), slot layout, within-row event order and split
segments for the same plan, with the reference's dtypes (int32 indices
and ids, float32 values, bool mask).  Row ids are normalized as the
reference counts them: an id in ``[-n_rows, 0)`` stands for
``id + n_rows`` and an id outside ``[-n_rows, n_rows)`` is dropped.
Truncation (``max_len``) is not supported here; callers with
``max_degree`` set bucket on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.ops.ragged import LEN_ALIGN, _round_up, fit_bounds

__all__ = ["BucketPlan", "plan_buckets", "build_buckets", "degree_histogram",
           "normalize_ids"]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static layout for one side's buckets."""

    bounds: Tuple[int, ...]          # plain-bucket bounds, ascending
    rows: Tuple[int, ...]            # real rows per plain bucket
    rows_padded: Tuple[int, ...]     # rows rounded to pad_rows_to
    # Split bucket (zipf head), or None:
    split_len: Optional[int]         # seg_len (= split_above)
    split_rows: int                  # partial rows (padded)
    split_segs: int                  # entity slots (padded)
    n_rows: int                      # entities on this side
    pad_rows_to: int
    # Memory chunks, decided at plan time:
    # plain_chunks[i] = ((row_start, n_rows), ...) within bucket i;
    # split_chunks  = ((e0, e1, r0, r1), ...) at entity granularity.
    plain_chunks: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    split_chunks: Tuple[Tuple[int, int, int, int], ...] = ()

    @property
    def row_starts(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for r in self.rows:
            out.append(acc)
            acc += r
        return tuple(out)

    @property
    def slot_starts(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for rp, b in zip(self.rows_padded, self.bounds):
            out.append(acc)
            acc += rp * b
        return tuple(out)

    @property
    def total_plain_slots(self) -> int:
        return sum(rp * b for rp, b in zip(self.rows_padded, self.bounds))

    @property
    def total_plain_rows(self) -> int:
        return sum(self.rows_padded)


def normalize_ids(ids: torch.Tensor, n_rows: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``ids`` as int64 in ``[0, n_rows)``, the way the reference counts
    them (a negative id wraps once, anything else out of range is
    dropped), and the mask of the ids kept, or None when every id is in
    range."""
    r = ids.long()
    r = torch.where(r < 0, r + n_rows, r)
    ok = (r >= 0) & (r < n_rows)
    if bool(ok.all()):
        return r, None
    return r[ok], ok


def degree_histogram(counts: torch.Tensor, cap: int
                     ) -> Tuple[np.ndarray, int, int]:
    """(clipped histogram, n_over, n_partials) pulled off the device: the
    histogram of degrees clipped at ``cap`` (cap+1 bins), the number of
    rows above cap, and the ceil(d/cap) partial rows they need."""
    hist = torch.bincount(counts.clamp(max=cap), minlength=cap + 1)
    over = counts > cap
    n_over = int(over.sum())
    n_part = int(torch.where(over, (counts + cap - 1) // cap, 0).sum())
    return hist.cpu().numpy(), n_over, n_part


def plan_buckets(
    hist: np.ndarray,
    n_over: int,
    n_part: int,
    n_rows: int,
    *,
    split_above: int,
    pad_rows_to: int = 1,
    bucket_bounds="auto",
    max_block_floats: Optional[int] = None,
    rank: int = 64,
    over_degrees: Optional[np.ndarray] = None,
) -> BucketPlan:
    """Degree histogram → static bucket layout (host-side, cheap).

    ``max_block_floats`` (with ``rank``) turns on memory chunking:
    buckets whose gathered [R, L, K] block would exceed the budget are
    cut into several row chunks.  Chunking the split bucket needs
    ``over_degrees``, the degrees of the over-cap entities in entity-id
    order.
    """
    _t0 = time.perf_counter()
    pad_to = max(pad_rows_to, LEN_ALIGN)  # batch dim also sublane-aligned
    degrees = np.arange(len(hist))
    present = degrees[(hist > 0) & (degrees < len(hist))]
    counts_rep = np.repeat(present, hist[present])  # ≤ n_rows ints
    if isinstance(bucket_bounds, str):
        bounds = fit_bounds(counts_rep, cap=split_above)
    else:
        bounds = sorted(set(min(b, split_above) for b in bucket_bounds
                            if b > 0))
        top = int(counts_rep.max()) if len(counts_rep) else 1
        if not bounds or bounds[-1] < top:
            bounds.append(_round_up(top, LEN_ALIGN))
    rows_per = []
    prev = -1  # first bucket includes degree-0 rows
    for b in bounds:
        hi = min(b, len(hist) - 1)
        lo = prev + 1
        n = int(hist[lo:hi + 1].sum())
        if hi >= split_above:
            # cap-bin rows that are genuinely over go to the split bucket
            n -= n_over
        rows_per.append(n)
        prev = b
    # Drop empty buckets (keep at least one).
    kept = [(b, r) for b, r in zip(bounds, rows_per) if r > 0] or \
        [(bounds[0], 0)]
    bounds = tuple(b for b, _ in kept)
    rows = tuple(r for _, r in kept)
    rows_padded = tuple(max(_round_up(r, pad_to), pad_to) for r in rows)
    if n_over > 0:
        split_rows = max(_round_up(n_part, pad_to), pad_to)
        split_segs = max(_round_up(n_over, pad_to), pad_to)
        split_len = split_above
    else:
        split_rows = split_segs = 0
        split_len = None

    def rows_max_for(length: int) -> int:
        return max(LEN_ALIGN,
                   (max_block_floats // max(length * rank, 1))
                   // LEN_ALIGN * LEN_ALIGN)

    plain_chunks: Tuple = ()
    split_chunks: Tuple = ()
    if max_block_floats is not None:
        pc_list = []
        for b, rp in zip(bounds, rows_padded):
            rm = rows_max_for(b)
            ch = []
            s = 0
            while s < rp:
                ch.append((s, min(rm, rp - s)))  # rp, rm multiples of 8
                s += rm
            pc_list.append(tuple(ch))
        plain_chunks = tuple(pc_list)
        if split_len is not None:
            assert over_degrees is not None and len(over_degrees) == n_over
            parts = (np.asarray(over_degrees, np.int64) + split_len - 1) \
                // split_len
            starts = np.zeros(n_over + 1, np.int64)
            np.cumsum(parts, out=starts[1:])
            rm = rows_max_for(split_len)
            sc = []
            e0 = 0
            while e0 < n_over:
                e1 = e0 + 1
                while e1 < n_over and starts[e1 + 1] - starts[e0] <= rm:
                    e1 += 1
                sc.append((e0, e1, int(starts[e0]), int(starts[e1])))
                e0 = e1
            split_chunks = tuple(sc) if len(sc) > 1 else ()
    plan = BucketPlan(bounds=bounds, rows=rows, rows_padded=rows_padded,
                      split_len=split_len, split_rows=split_rows,
                      split_segs=split_segs, n_rows=n_rows,
                      pad_rows_to=pad_to, plain_chunks=plain_chunks,
                      split_chunks=split_chunks)
    # Planning cost and the padded device memory the layout will touch.
    reg = get_registry()
    reg.histogram("pio_device_prep_plan_ms",
                  "Host time planning the bucket layout.").observe(
        (time.perf_counter() - _t0) * 1e3)
    total_slots = plan.total_plain_slots + plan.split_rows * (plan.split_len
                                                              or 0)
    reg.gauge("pio_device_prep_total_slots",
              "Padded entry slots the device layout allocates.").set(
        total_slots)
    reg.gauge("pio_device_prep_padded_rows",
              "Padded rows across plain + split buckets.").set(
        plan.total_plain_rows + plan.split_rows)
    reg.gauge("pio_device_prep_buckets",
              "Plain bucket count of the current plan.").set(
        len(plan.bounds))
    return plan


def _scatter(size: int, dest: torch.Tensor, src, dtype,
             fill=0) -> torch.Tensor:
    """``out[dest] = src`` into a ``[size]`` buffer of ``fill``, with
    every destination outside ``[0, size)`` dropped (the reference's
    ``mode="drop"``): those go to one spare slot past the end, which the
    returned view leaves out."""
    dest = torch.where((dest >= 0) & (dest < size), dest, size)
    out = torch.full((size + 1,), fill, dtype=dtype, device=dest.device)
    out[dest] = src
    return out[:size]


def _pad_rows(a: torch.Tensor, n: int, value=0) -> torch.Tensor:
    if n == 0:
        return a
    return torch.cat([a, a.new_full((n,) + tuple(a.shape[1:]), value)])


def build_buckets(
    rows: torch.Tensor,     # [N] int entity ids (this side)
    cols: torch.Tensor,     # [N] int other-side ids
    vals: torch.Tensor,     # [N] float32
    plan: BucketPlan,
) -> Tuple[Tuple, Optional[Tuple]]:
    """COO → per-bucket padded blocks, on the device of ``rows``.

    Returns ``(plain, split)`` where ``plain`` is a tuple of
    ``(indices [R,L], values, mask, row_ids)`` per plan bucket (or per
    plan chunk) and ``split`` is a tuple of ``(indices, values, mask,
    seg_ids, ent_ids)`` blocks, or None.  Indices are computed in int64
    (torch's index type) and emitted in the reference's dtypes.
    """
    dev = rows.device
    n_rows = plan.n_rows
    r, ok = normalize_ids(rows, n_rows)
    if ok is not None:
        cols, vals = cols[ok], vals[ok]
    n = r.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    counts = torch.bincount(r, minlength=n_rows)

    # --- bucket of each entity ---------------------------------------
    n_plain = len(plan.bounds)
    bucket_of = torch.searchsorted(torch.tensor(plan.bounds, **i64), counts)
    if plan.split_len is not None:
        is_split_row = counts > plan.split_len
        bucket_of = torch.where(is_split_row, n_plain, bucket_of)
    b_clip = bucket_of.clamp(max=n_plain)

    # --- slot of each entity within its bucket (stable by id) --------
    ent = torch.arange(n_rows, **i64)
    order = torch.argsort(bucket_of, stable=True)
    rank = torch.empty(n_rows, **i64)
    rank[order] = ent
    row_start = torch.tensor(plan.row_starts + (sum(plan.rows),), **i64)
    slot_of = rank - row_start[b_clip]

    # row_ids: flat over plain buckets (padded rows stay -1)
    row_starts_pad = []
    acc = 0
    for rp in plan.rows_padded:
        row_starts_pad.append(acc)
        acc += rp
    total_rows = acc
    dest_row = torch.where(
        bucket_of < n_plain,
        torch.tensor(row_starts_pad + [acc], **i64)[b_clip] + slot_of,
        total_rows)  # split rows dropped here
    flat_row_ids = _scatter(total_rows, dest_row, ent.int(), torch.int32,
                            fill=-1)

    # --- entry positions within rows (stable = event order) ----------
    e_order = torch.argsort(r, stable=True)
    starts = torch.zeros(n_rows + 1, **i64)
    torch.cumsum(counts, 0, out=starts[1:])
    pos = torch.empty(n, **i64)
    pos[e_order] = torch.arange(n, **i64) - starts[r[e_order]]

    # --- flat destination per entry ----------------------------------
    slot_starts = torch.tensor(plan.slot_starts + (plan.total_plain_slots,),
                               **i64)
    bounds_full = torch.tensor(plan.bounds + (1,), **i64)
    b_of_e = bucket_of[r]
    be_clip = b_of_e.clamp(max=n_plain)
    slot_e = slot_of[r]
    dest = slot_starts[be_clip] + slot_e * bounds_full[be_clip] + pos
    total_plain = plan.total_plain_slots
    total_slots = total_plain

    if plan.split_len is not None:
        seg_len = plan.split_len
        # entity slot e (0..n_over) within the split bucket = slot_of;
        # its partial-row base = exclusive cumsum of ceil(count/seg_len)
        # over entities ordered by slot.
        n_seg = plan.split_segs
        ent_of_slot = _scatter(n_seg, torch.where(is_split_row, slot_of,
                                                  n_seg),
                               ent.int(), torch.int32, fill=-1)
        cnt_of_slot = torch.where(ent_of_slot >= 0,
                                  counts[ent_of_slot.clamp(min=0).long()], 0)
        parts_of_slot = (cnt_of_slot + seg_len - 1) // seg_len
        part_end = torch.cumsum(parts_of_slot, 0)   # sorted, contiguous
        part_base = part_end - parts_of_slot
        prow = part_base[slot_e.clamp(max=n_seg - 1)] + pos // seg_len
        split_dest = total_plain + prow * seg_len + pos % seg_len
        dest = torch.where(b_of_e < n_plain, dest, split_dest)
        total_slots = total_plain + plan.split_rows * seg_len
        prow_iota = torch.arange(plan.split_rows, **i64)
        seg_ids = torch.searchsorted(part_end, prow_iota, right=True)
        valid_part = (seg_ids < n_seg) & (
            prow_iota < part_end[seg_ids.clamp(max=n_seg - 1)])
        seg_ids = torch.where(valid_part, seg_ids, n_seg).int()

    flat_idx = _scatter(total_slots, dest, cols.int(), torch.int32)
    flat_val = _scatter(total_slots, dest, vals.float(), torch.float32)
    flat_msk = _scatter(total_slots, dest, True, torch.bool)

    plain: List[Tuple] = []
    for i, (b, rp) in enumerate(zip(plan.bounds, plan.rows_padded)):
        s0 = plan.slot_starts[i]
        r0 = row_starts_pad[i]
        chunks = plan.plain_chunks[i] if plan.plain_chunks else ((0, rp),)
        for cs, cn in chunks:
            sl = slice(s0 + cs * b, s0 + (cs + cn) * b)
            plain.append((flat_idx[sl].view(cn, b), flat_val[sl].view(cn, b),
                          flat_msk[sl].view(cn, b),
                          flat_row_ids[r0 + cs:r0 + cs + cn]))
    split = None
    if plan.split_len is not None:
        s0 = total_plain
        sl = plan.split_len
        pr = plan.split_rows
        blocks = (flat_idx[s0:s0 + pr * sl].view(pr, sl),
                  flat_val[s0:s0 + pr * sl].view(pr, sl),
                  flat_msk[s0:s0 + pr * sl].view(pr, sl), seg_ids,
                  ent_of_slot)
        split = tuple(_expand_split(blocks, plan.pad_rows_to,
                                   plan.split_chunks))
    return tuple(plain), split


def _expand_split(blocks: Tuple, pad_to: int,
                 chunks: Tuple[Tuple[int, int, int, int], ...]) -> List[Tuple]:
    """A split bucket's ``(indices, values, mask, seg_ids, ent_ids)`` cut
    at the plan's entity boundaries ``(e0, e1, r0, r1)``: each chunk
    re-bases its segment ids, pads its rows and entity slots to a
    multiple of ``pad_to``, and points its padding rows at the spare
    slot past its entities.  No chunks: the bucket as one block."""
    if not chunks:
        return [blocks]
    idx, vals, msk, seg, ent = blocks
    out = []
    for e0, e1, r0, r1 in chunks:
        n_chunk = e1 - e0
        seg_pad = (-n_chunk) % pad_to
        row_pad = (-(r1 - r0)) % pad_to
        oob = n_chunk + seg_pad  # padding rows → dropped slot
        seg_c = seg[r0:r1]
        seg_c = torch.where((seg_c >= e0) & (seg_c < e1), seg_c - e0,
                            oob).int()
        out.append((_pad_rows(idx[r0:r1], row_pad),
                    _pad_rows(vals[r0:r1], row_pad),
                    _pad_rows(msk[r0:r1], row_pad),
                    _pad_rows(seg_c, row_pad, oob),
                    _pad_rows(ent[e0:e1], seg_pad, -1)))
    return out
