"""Alternating least squares: the training sweep and the serving functions.

Port of ``predictionio_tpu/models/als.py`` (reference behaviour: Spark
MLlib ``ALS.train`` / ``ALS.trainImplicit`` as the recommendation
template calls them).  One training run:

- ragged ratings → degree-bucketed padded blocks: on the card the COO
  triplets go up once and are bucketed there
  (:mod:`predictionio_tpu_torch.ops.device_prep`); elsewhere, or with
  ``max_degree`` truncation, on the host
  (:mod:`predictionio_tpu_torch.ops.ragged`) and uploaded, with index
  blocks as int32;
- per side and bucket, the per-row normal equations
  ``A_u = Σ_i w_ui · y_i y_iᵀ``, ``b_u = Σ_i c_ui · y_i`` (kernel K1,
  which gathers the other side's factor rows itself), then one batched
  SPD solve per bucket (kernel K2 by default on the card, K4 under
  ``solver="gj"``, Cholesky through ``torch.linalg`` on the CPU);
- solved rows written back in place into the side's factor matrix;
  padded rows (``row_id == -1``) are dropped, never clamped.

Regularization follows MLlib's ALS-WR scaling: λ·n_u per user (n_u =
that user's rating count), λ·n_i per item.  Implicit feedback follows
Hu-Koren-Volinsky: confidence c = 1 + α·r, preference p = 1(r>0), with
the ``YᵀY`` term shared across the side.

The factors stay numpy at rest in :class:`ALSModel` (they ride the model
pickle); training works on tensors on the device it is given (the card
unless the caller passes ``device="cpu"``) and returns numpy factors.
The loop runs under supervision (:func:`train_als_prepared`): sweep
checkpoints, rollback of a non-finite chunk, preemption and the step
watchdog; every sweep is bit for bit reproducible, so a resumed train
equals an uninterrupted one.
With a ``mesh`` (:mod:`predictionio_tpu_torch.parallel`) every solve
block's rows split over the ``data`` axis and each shard runs K1 and K2
on its own rows, on its own device; ``factor_sharding`` keeps the
factors replicated or row-sharded, and ``gather_window`` fetches only
the rows a block touches from row-sharded factors.  Every sum over
shards runs in shard order, so a mesh train is as reproducible as a
meshless one.  Without a mesh the two knobs are ignored, as the
reference ignores them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.ops import device_prep as dp
from predictionio_tpu_torch.ops.embedding import deterministic
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import ridge_solve as rs
from predictionio_tpu_torch.ops import threefry
from predictionio_tpu_torch.ops.linalg import batched_ridge_solve, gram
from predictionio_tpu_torch.ops.ragged import (
    LEN_ALIGN,
    Padded,
    bucket_by_length,
)
from predictionio_tpu_torch.ops.topk import chunked_top_k, top_k_scores
from predictionio_tpu_torch.parallel.compat import (
    axis_lane,
    lane_outputs,
    psum,
    shard_map,
)
from predictionio_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    put_sharded,
)
from predictionio_tpu_torch.resilience.supervision import (
    DivergenceGuard,
    RollbackRequested,
    StepWatchdog,
    TrainDiverged,
    TrainPreempted,
    all_finite,
    preemption_requested,
)

__all__ = ["ALSConfig", "ALSModel", "ALSInputs", "als_model_from_numpy",
           "prepare_als_inputs", "train_als", "train_als_prepared",
           "predict_scores", "recommend", "fold_in", "rmse"]


@dataclasses.dataclass
class ALSConfig:
    """Every field of the reference's ``ALSConfig``, so engine.json and
    callers bind the same way."""

    rank: int = 32
    iterations: int = 10
    reg: float = 0.01          # MLlib regParam (λ), ALS-WR scaled by degree
    alpha: float = 1.0         # implicit confidence scale
    implicit: bool = False
    max_degree: Optional[int] = None   # truncate overlong entities (None = exact)
    # "auto" fits bounds to the degree histogram (ops.ragged.fit_bounds);
    # a tuple pins them.
    bucket_bounds: Union[Sequence[int], str] = "auto"
    # Entities longer than this are split into partial rows whose
    # normal-equation pieces are segment-summed before the solve (exact).
    split_above: Optional[int] = 4096
    seed: int = 42
    dtype: str = "float32"     # factor storage dtype; solves always f32
    # Factor dtype the gram kernel gathers (accumulation stays float32):
    # "auto" = float32; "bfloat16" halves the gathered bytes.
    gram_dtype: str = "auto"
    # "auto" = K2 ("lu") on the card when it takes the rank, Cholesky
    # elsewhere; "cholesky" / "gj" (K4) / "lu" force a path.
    solver: str = "auto"
    # The gram build: kernel K1 on the card, its plain version on the
    # CPU.  None and True both mean that; False (the plain gram on the
    # card) is refused there, since the port's plain versions run on CPU
    # tensors only.
    use_pallas: Optional[bool] = None
    # Device-memory guard: a bucket whose [rows, L, K] gathered block
    # would exceed this many floats is solved in row chunks.
    max_block_floats: int = 1 << 27
    # Where the ratings are bucketed: "auto" = on the card when training
    # runs there with no max_degree, else on the host; True = on the
    # training device, whatever it is; False = on the host.
    device_prep: Union[bool, str] = "auto"
    # Mesh knobs of the reference; ignored without a mesh.
    factor_sharding: str = "auto"
    factor_shard_threshold: int = 256 << 20
    gather_window: Union[bool, str] = "auto"


@dataclasses.dataclass
class ALSModel:
    """Trained factors. ``user_factors [U,K]``, ``item_factors [I,K]``,
    float32 numpy."""

    user_factors: np.ndarray
    item_factors: np.ndarray
    rank: int
    implicit: bool

    def tree_flatten(self):
        """The factor arrays by name (the reference's checkpoint split
        of the model's arrays)."""
        return {"user_factors": self.user_factors,
                "item_factors": self.item_factors}


def als_model_from_numpy(user_factors, item_factors, *, rank: int,
                         implicit: bool) -> ALSModel:
    """Carry trained factors into the port: any array-likes (for example
    the JAX model's factors after ``np.asarray(jax.device_get(...))``)
    become contiguous, writable float32 numpy ``[U, rank]`` /
    ``[I, rank]`` (copied only where the input is not already so)."""
    uf = np.require(user_factors, np.float32, ("C", "W"))
    itf = np.require(item_factors, np.float32, ("C", "W"))
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != rank \
            or itf.shape[1] != rank:
        raise ValueError(f"factors must be [U, {rank}] and [I, {rank}] "
                         f"(got {uf.shape} and {itf.shape})")
    return ALSModel(user_factors=uf, item_factors=itf, rank=int(rank),
                    implicit=bool(implicit))


# -- training -----------------------------------------------------------------

_GRAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _init_factors(n_users: int, n_items: int, k: int, seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded scaled-normal factor init (MLlib: normal / √k): the
    reference's draw, made without JAX.

    The key of ``seed`` is split in two, and each half draws a float32
    normal block, users then items, as ``jax.random`` does
    (:mod:`~predictionio_tpu_torch.ops.threefry`).  The bits are JAX's
    exactly and the factors within a few float32 ulps of the
    reference's (another ``log1p`` inside erfinv).  Drawn on the host
    as CPU tensors, so the card starts from the same factors.
    """
    ku, ki = threefry.split(threefry.seed_key(seed))
    scale = np.sqrt(k).astype(np.float32)
    uf = threefry.normal(ku, (n_users, k)) / scale
    itf = threefry.normal(ki, (n_items, k)) / scale
    return torch.from_numpy(uf), torch.from_numpy(itf)


def _resolve_gram_dtype(gram_dtype: str) -> str:
    """"auto" → float32 (on the card too); bfloat16 only by name."""
    if gram_dtype == "auto":
        return "float32"
    if gram_dtype not in _GRAM_DTYPES:
        raise ValueError(f"gram_dtype must be 'auto', 'float32' or "
                         f"'bfloat16' (got {gram_dtype!r})")
    return gram_dtype


def _gram_pieces(indices: torch.Tensor, values: torch.Tensor,
                 mask: torch.Tensor, factors: torch.Tensor, alpha: float,
                 implicit: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row normal-equation pieces: A [R,K,K], b [R,K], degree [R].
    ``factors`` are the other side's, already in the gram dtype; K1 on
    the card, its plain version on the CPU."""
    m = mask.float()
    if implicit:
        # Hu-Koren-Volinsky per MLlib: c = 1 + α·|r|, p = 1(r>0).
        # A = YᵀY + Σ (c-1)·y yᵀ,  b = Σ c·p·y — (c-1) ≥ 0 keeps A PSD.
        w = alpha * values.abs() * m          # c - 1
        cvec = (1.0 + w) * (values > 0).float() * m
    else:
        w = m
        cvec = values * m
    a, b = fg.fused_gram_vector(factors, indices, w, cvec)
    return a, b, m.sum(dim=1)


def _ridge(a: torch.Tensor, b: torch.Tensor, reg_vec: torch.Tensor,
           solver: str = "cholesky") -> torch.Tensor:
    """Batched SPD solve ``(A + diag(reg)) x = b``: "lu" = K2, "gj" =
    K4, "cholesky" = ``torch.linalg``."""
    if solver == "lu":
        return rs.ridge_solve_lu(a, b, reg_vec)
    if solver == "gj":
        return rs.ridge_solve_gj(a, b, reg_vec)
    return batched_ridge_solve(a, b, reg_vec)


def _solve_bucket(indices, values, mask, factors, yty, reg: float,
                  alpha: float, implicit: bool, solver: str) -> torch.Tensor:
    """One padded block of normal equations + batched solves → [R, K]."""
    a, b, degree = _gram_pieces(indices, values, mask, factors, alpha,
                                implicit)
    if implicit:
        a += yty
    return _ridge(a, b, reg * degree.clamp_min(1.0), solver)  # ALS-WR: λ·n_u


def _valid_rows(ids, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The index half of :func:`_scatter_rows`, computed once at prep:
    the positions whose id is valid (``id >= 0``, the mask) and the ids
    there, as int64 tensors on ``device``.  ``ids`` (numpy or a tensor)
    are read where they lie: the device route's never leave the card."""
    ids = torch.as_tensor(ids, device=device)
    keep = torch.nonzero(ids >= 0).squeeze(1)
    return keep, ids[keep].long()


def _scatter_rows(dst: torch.Tensor, keep: torch.Tensor,
                  targets: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write solved rows back into ``dst`` in place: row ``keep[n]`` of
    ``rows`` lands on row ``targets[n]``.  Rows with ``row_id == -1``
    (bucket padding) are not in ``keep``, so they are dropped — never
    clamped onto a real row, whose genuine update they would race."""
    return dst.index_copy_(0, targets, rows.index_select(0, keep))


@dataclasses.dataclass
class _Chunk:
    """One uploaded solve block.  ``plain``: rows are entities, ``keep``
    / ``targets`` come from its row ids.  ``merged`` (a split bucket):
    partial rows segment-sum into ``n_seg`` entity slots through
    ``seg_ids`` (padding rows point at the spare slot ``n_seg``, which
    is discarded), and ``keep`` / ``targets`` come from the entity ids."""

    kind: str
    indices: torch.Tensor      # [R, L] int32
    values: torch.Tensor       # [R, L] float32
    mask: torch.Tensor         # [R, L] bool
    keep: torch.Tensor         # [n] int64
    targets: torch.Tensor      # [n] int64
    seg_ids: Optional[torch.Tensor] = None   # [R] int64, merged only
    n_seg: int = 0
    # On a mesh with row-sharded factors: per destination row block,
    # which solved rows it takes and where (see _mesh_scatter).
    routes: Optional[List[Tuple]] = None


def _merged_solve(ch: _Chunk, dst: torch.Tensor, src: torch.Tensor,
                  yty: Optional[torch.Tensor], reg: float, alpha: float,
                  implicit: bool, solver: str) -> None:
    """Split-bucket step: partial rows → segment-summed normal equations
    → one solve per entity.  The sums are ``index_add_`` under
    :func:`~predictionio_tpu_torch.ops.embedding.deterministic`: on the
    card that is the sort-based ``index_put_``, which adds each entity's
    partial rows in row order, so a sweep's bits are the same from run
    to run and a resumed train equals an uninterrupted one."""
    a, b, deg = _gram_pieces(ch.indices, ch.values, ch.mask, src, alpha,
                             implicit)
    n, k = ch.n_seg, a.shape[-1]
    seg = ch.seg_ids
    with deterministic():
        big_a = a.new_zeros((n + 1, k, k)).index_add_(0, seg, a)[:n]
        big_b = b.new_zeros((n + 1, k)).index_add_(0, seg, b)[:n]
        degree = deg.new_zeros(n + 1).index_add_(0, seg, deg)[:n]
    if implicit:
        big_a += yty
    solved = _ridge(big_a, big_b, reg * degree.clamp_min(1.0), solver)
    _scatter_rows(dst, ch.keep, ch.targets, solved)


def _chunk_split_bucket(
    p: Padded, rank: int, max_block_floats: int, pad_rows: int,
) -> List[Tuple]:
    """Cut a split bucket into memory-bounded chunks at ENTITY boundaries.

    All partial rows of one entity must land in the same chunk (their
    normal-equation pieces segment-sum before the solve), and ragged.py
    lays partial rows out grouped by entity, so cutting between entities
    is always legal.  Each chunk gets re-based seg_ids and its own ent_ids
    slice.
    """
    r, l = p.indices.shape
    rows_max = max(pad_rows, (max_block_floats // max(l * rank, 1))
                   // pad_rows * pad_rows)
    if r <= rows_max:
        return [(p.indices, p.values, p.mask, p.seg_ids, p.ent_ids)]
    n_seg = len(p.ent_ids)
    # First partial row of each segment (segments are contiguous row runs).
    seg_starts = np.searchsorted(p.seg_ids, np.arange(n_seg + 1), side="left")
    chunks = []
    e0 = 0
    while e0 < n_seg:
        e1 = e0 + 1
        while e1 < n_seg and seg_starts[e1 + 1] - seg_starts[e0] <= rows_max:
            e1 += 1
        r0, r1 = int(seg_starts[e0]), int(seg_starts[e1])
        if r1 == r0:  # trailing padding-only segments
            break
        rows = slice(r0, r1)
        seg = p.seg_ids[rows] - e0
        n_seg_chunk = e1 - e0
        row_pad = (-(r1 - r0)) % pad_rows
        seg_pad = (-n_seg_chunk) % pad_rows
        idx = np.pad(p.indices[rows], ((0, row_pad), (0, 0)))
        vals = np.pad(p.values[rows], ((0, row_pad), (0, 0)))
        msk = np.pad(p.mask[rows], ((0, row_pad), (0, 0)))
        seg = np.pad(seg, (0, row_pad),
                     constant_values=n_seg_chunk + seg_pad)  # OOB → dropped
        ent = np.pad(p.ent_ids[e0:e1], (0, seg_pad), constant_values=-1)
        chunks.append((idx, vals, msk, seg.astype(np.int32), ent))
        e0 = e1
    return chunks


def _make_chunk(kind: str, idx: torch.Tensor, vals: torch.Tensor,
                msk: torch.Tensor, ids: torch.Tensor,
                seg: Optional[torch.Tensor] = None) -> _Chunk:
    """A solve block from tensors already on the training device:
    ``ids`` are its row ids (plain) or entity ids (merged, with the
    partial rows' ``seg`` ids, the spare slot ``len(ids)`` at most)."""
    keep, targets = _valid_rows(ids, idx.device)
    n_seg = len(ids) if seg is not None else 0
    return _Chunk(kind=kind, indices=idx, values=vals, mask=msk,
                  keep=keep, targets=targets,
                  seg_ids=None if seg is None
                  else seg.long().clamp(max=n_seg),
                  n_seg=n_seg)


def _upload(kind: str, idx, vals, msk, ids, device: torch.device,
            seg=None) -> _Chunk:
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return _make_chunk(kind, put(idx, np.int32), put(vals, np.float32),
                       put(msk, np.bool_), put(ids, np.int64),
                       None if seg is None else put(seg, np.int64))


@dataclasses.dataclass
class _MeshChunk:
    """One solve block on a mesh: its rows split into equal blocks over
    the ``data`` axis, ``shards[s]`` on shard ``s``'s device.  A merged
    block's shards each hold the entity block ``s`` of its ``n_seg``
    entities (``keep`` / ``targets``) and every entity slot for its
    rows' ``seg_ids``.  ``win`` (windowed blocks): the sorted factor rows
    the block touches, replicated on every shard's device; the indices
    are then window-local."""

    kind: str
    shards: List[_Chunk]
    win: Optional[List[torch.Tensor]] = None


def _chunk_window(idx: np.ndarray, msk: np.ndarray, n_src: int,
                  pad_to: int = 64) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Sorted unique src ids a chunk touches + the window-local remap.

    Returns ``None`` when windowing would not shrink the gather (window
    ≥ half the matrix) — the caller keeps the plain full-matrix path.
    Padding repeats the LAST (max) id so the array stays sorted for
    ``searchsorted``; duplicate fetches of one row are harmless.
    """
    win = np.unique(idx[msk])
    if win.size == 0:
        win = np.zeros(1, idx.dtype)
    padded = -(-win.size // pad_to) * pad_to
    if padded >= n_src // 2:
        return None
    win = np.pad(win, (0, padded - win.size), mode="edge")
    local = np.searchsorted(win, idx).astype(np.int32)
    local[~msk] = 0
    return win.astype(np.int32), local


def _mesh_upload(kind: str, host_arrs: Tuple, win, mesh) -> _MeshChunk:
    """Place one block's host arrays row-sharded over the mesh's
    ``data`` axis (``put_sharded``) and its window replicated, then make
    each shard's solve block on its device."""
    row = PartitionSpec(AXIS_DATA)
    lane = axis_lane(mesh, AXIS_DATA)
    if kind == "merged":
        idx, vals, msk, seg, ent = host_arrs
        n_seg = len(ent)
        arrs = [put_sharded(np.ascontiguousarray(a, dtype=t), mesh, row)
                for a, t in ((idx, np.int32), (vals, np.float32),
                             (msk, np.bool_), (seg, np.int64),
                             (ent, np.int64))]
    else:
        arrs = [put_sharded(np.ascontiguousarray(a, dtype=t), mesh, row)
                for a, t in zip(host_arrs, (np.int32, np.float32, np.bool_,
                                            np.int64))]
    shards = []
    for p in lane:
        blocks = [a.block(p) for a in arrs]
        if kind == "merged":
            idx_s, vals_s, msk_s, seg_s, ent_s = blocks
            keep, targets = _valid_rows(ent_s, idx_s.device)
            shards.append(_Chunk(kind="merged", indices=idx_s,
                                 values=vals_s, mask=msk_s, keep=keep,
                                 targets=targets,
                                 seg_ids=seg_s.clamp(max=n_seg),
                                 n_seg=n_seg))
        else:
            shards.append(_make_chunk("plain", *blocks))
    wins = None
    if win is not None:
        w = put_sharded(np.ascontiguousarray(win, dtype=np.int64), mesh,
                        PartitionSpec())
        wins = [w.block(p) for p in lane]
    return _MeshChunk(kind=kind, shards=shards, win=wins)


def _device_buckets(buckets: List[Padded], rank: int, max_block_floats: int,
                    pad_rows: int, device: Optional[torch.device],
                    mesh=None, window_n_src: Optional[int] = None) -> List:
    """Stage padded buckets, splitting any whose gathered [R, L, K]
    block would exceed ``max_block_floats`` into row chunks of
    ``rows_max`` rows; the last chunk is row-padded (row_id = -1, which
    the scatter drops) only up to a multiple of ``pad_rows``, as
    :func:`_chunk_split_bucket` pads, so K1 and K2 do no work on rows
    that exist only to fill a chunk.  Index blocks go up as int32, once.

    The staging rides a :class:`~predictionio_tpu_torch.data.prefetch.
    DevicePrefetcher` (``model="als"``): its source generator does the
    chunk/pad/window numpy work on the prefetcher's thread and its put
    issues the transfers, so one chunk's padding overlaps the previous
    chunk's copy, and the staging shows in ``pio_prefetch_*``.  The
    prefetcher's thread is joined on every exit.

    Without a mesh: one :class:`_Chunk` per block on ``device``.  With a
    mesh: one :class:`_MeshChunk` per block, rows over the ``data``
    axis; with ``window_n_src`` (factors row-sharded), a block whose
    working set is under half the other side's matrix gets a window
    (:func:`_chunk_window`) and window-local indices.
    """
    from predictionio_tpu_torch.data.prefetch import DevicePrefetcher

    def windowed(kind, idx, msk, rest):
        if window_n_src is None:
            return kind, (idx, *rest), None
        w = _chunk_window(idx, msk, window_n_src)
        if w is None:
            return kind, (idx, *rest), None
        win, local = w
        return kind, (local, *rest), win

    def entries():
        """(kind, host_arrs, win) stream — all chunk/pad/window numpy
        work happens here, on the prefetcher's thread."""
        for p in buckets:
            if p.split:
                for idx, vals, msk, seg, ent in _chunk_split_bucket(
                        p, rank, max_block_floats, pad_rows):
                    yield windowed("merged", idx, msk, (vals, msk, seg, ent))
                continue
            r, l = p.indices.shape
            rows_max = max(pad_rows,
                           (max_block_floats // max(l * rank, 1))
                           // pad_rows * pad_rows)
            for start in range(0, r, rows_max):
                sl = slice(start, start + rows_max)
                idx, vals = p.indices[sl], p.values[sl]
                msk, rid = p.mask[sl], p.row_ids[sl]
                short = (-idx.shape[0]) % pad_rows
                if short:
                    idx = np.pad(idx, ((0, short), (0, 0)))
                    vals = np.pad(vals, ((0, short), (0, 0)))
                    msk = np.pad(msk, ((0, short), (0, 0)))
                    rid = np.pad(rid, (0, short), constant_values=-1)
                yield windowed("plain", idx, msk, (vals, msk, rid))

    def put_entry(entry):
        kind, host_arrs, win = entry
        if mesh is not None:
            return _mesh_upload(kind, host_arrs, win, mesh)
        if kind == "merged":
            idx, vals, msk, seg, ent = host_arrs
            return _upload("merged", idx, vals, msk, ent, device, seg=seg)
        return _upload("plain", *host_arrs, device)

    with DevicePrefetcher(entries(), prep_fn=lambda e: e, put_fn=put_entry,
                          count_fn=lambda e: 1, model="als") as pf:
        return [batch.args for batch in pf]


@dataclasses.dataclass
class ALSInputs:
    """Padded buckets on the device + factor init (prep done once), so a
    caller can run :func:`train_als_prepared` more than once without
    re-bucketing or re-uploading.  On a mesh the factors are
    :class:`~predictionio_tpu_torch.parallel.mesh.ShardedTensor` s
    (row-sharded, padded to the ``data`` axis, or replicated) and the
    buckets :class:`_MeshChunk` s."""

    uf0: Any
    itf0: Any
    user_buckets: List
    item_buckets: List
    n_users: int
    n_items: int
    mesh: Any = None


def _shard_factors(config: ALSConfig, n_users: int, n_items: int) -> bool:
    """Whether a mesh run row-shards the persistent factor matrices."""
    if config.factor_sharding == "sharded":
        return True
    if config.factor_sharding == "replicated":
        return False
    if config.factor_sharding != "auto":
        raise ValueError(
            f"factor_sharding must be 'auto', 'replicated' or 'sharded' "
            f"(got {config.factor_sharding!r})")
    return (n_users + n_items) * config.rank * 4 > config.factor_shard_threshold


def _factor_constraint(arr) -> Optional[NamedSharding]:
    """The sharding a blocked (row-sharded) factor matrix keeps through
    every sweep, or None for replicated / meshless factors."""
    sh = getattr(arr, "sharding", None)
    if isinstance(sh, NamedSharding) and sh.spec and sh.spec[0] == AXIS_DATA:
        return sh
    return None


def _window_gather(src, win: torch.Tensor, *, device=None) -> torch.Tensor:
    """Fetch factor rows ``win`` from (possibly row-sharded) ``src``.

    Sharded case: a masked local take on every shard + the fixed-order
    sum over the ``data`` axis (:func:`~predictionio_tpu_torch.parallel.
    compat.psum`) — each requested row lives in exactly ONE shard, so
    every other shard contributes exact zeros and the float32 sum is
    bitwise the row value.  The transient is ``[len(win), K]`` (the
    chunk's working set), on ``device`` (default: the first shard's).
    """
    if _factor_constraint(src) is None:
        return src[torch.as_tensor(win, device=src.device).long()]
    mesh = src.mesh
    shard_rows = src.shape[0] // mesh.shape[AXIS_DATA]

    def local(axis_index, src_local, win_rep):
        lo = axis_index(AXIS_DATA) * shard_rows
        loc = win_rep.long() - lo
        ok = (loc >= 0) & (loc < shard_rows)
        rows = src_local[torch.where(ok, loc, torch.zeros_like(loc))]
        return torch.where(ok[:, None], rows, torch.zeros_like(rows))

    parts = shard_map(local, mesh=mesh,
                      in_specs=(PartitionSpec(AXIS_DATA, None),
                                PartitionSpec()),
                      out_specs=None)(src, win)
    return psum(lane_outputs(parts, mesh, AXIS_DATA), mesh, device=device)


def prepare_als_inputs(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    ratings: Optional[np.ndarray],
    n_users: int,
    n_items: int,
    config: ALSConfig,
    mesh=None,
    *,
    device=None,
) -> ALSInputs:
    """Bucketing + upload for :func:`train_als_prepared`.
    ``device``: where training runs (default the card; ``"cpu"`` for the
    plain paths); with a ``mesh``, the mesh's devices.

    ``config.device_prep`` picks the route (the reference's dispatch):
    ``"auto"`` buckets on the card when training runs there with no
    ``max_degree`` and no mesh — the COO goes up once and
    :mod:`~predictionio_tpu_torch.ops.device_prep` lays the buckets out
    there — and on the host otherwise
    (:func:`~predictionio_tpu_torch.ops.ragged.bucket_by_length`, then
    the blocks go up through the prefetcher); ``True`` takes the device
    route on ``device``, whatever it is; ``False`` the host route.  A
    failure of the device route raises: nothing falls back to the host.

    On a mesh (the host route, as the reference's): bucket rows pad to
    ``lcm(LEN_ALIGN, data)`` and split over the ``data`` axis;
    ``config.factor_sharding`` row-shards the factors (padded to the
    axis size; ``auto`` above ``factor_shard_threshold`` bytes) or
    replicates them, and ``gather_window`` (``auto``: sharded factors
    on more than one shard) gives each block a window of the other
    side's rows."""
    if mesh is not None:
        return _prepare_als_inputs_mesh(user_ids, item_ids, ratings,
                                        n_users, n_items, config, mesh)
    dev = resolve_device(device)
    use_dev = config.device_prep
    if use_dev == "auto":
        use_dev = dev.type == "cuda" and config.max_degree is None
    elif use_dev not in (True, False):
        raise ValueError(f"device_prep must be 'auto', True or False "
                         f"(got {config.device_prep!r})")
    if use_dev:
        if config.max_degree is not None:
            raise NotImplementedError(
                "device bucketing does not truncate (max_degree); use "
                "device_prep='auto' or False")
        return _prepare_als_inputs_device(user_ids, item_ids, ratings,
                                          n_users, n_items, config, dev)
    k = config.rank
    pad_rows = LEN_ALIGN
    uf, itf = (t.to(dev) for t in _init_factors(n_users, n_items, k,
                                                  config.seed))

    def side(rows, cols, n_rows):
        return _device_buckets(
            bucket_by_length(rows, cols, ratings, n_rows,
                             bucket_bounds=config.bucket_bounds,
                             max_len=config.max_degree, pad_rows_to=pad_rows,
                             split_above=config.split_above),
            k, config.max_block_floats, pad_rows, dev)

    return ALSInputs(uf0=uf, itf0=itf,
                     user_buckets=side(user_ids, item_ids, n_users),
                     item_buckets=side(item_ids, user_ids, n_items),
                     n_users=n_users, n_items=n_items)


def _prepare_als_inputs_mesh(user_ids, item_ids, ratings, n_users: int,
                             n_items: int, config: ALSConfig,
                             mesh) -> ALSInputs:
    """The mesh route of :func:`prepare_als_inputs` (host bucketing)."""
    if AXIS_DATA not in mesh.shape:
        raise ValueError(f"ALS shards its solves over the {AXIS_DATA!r} "
                         f"axis; the mesh has {tuple(mesh.shape)}")
    if mesh.multi_process:
        raise NotImplementedError(
            "ALS on a mesh that spans processes is not ported yet "
            "(ROADMAP Queue 1 item 10b); use one process per mesh")
    if config.device_prep is True:
        raise NotImplementedError(
            "device bucketing (device_prep=True) has no mesh route; use "
            "device_prep='auto' or False")
    k = config.rank
    d = mesh.shape[AXIS_DATA]
    # Rows pad to the lcm of the data axis (the blocks must divide) and
    # LEN_ALIGN, so a mesh of 1, 2, 4 or 8 shards keeps the meshless
    # layout.
    pad_rows = math.lcm(LEN_ALIGN, d)
    uf, itf = _init_factors(n_users, n_items, k, config.seed)
    sharded = _shard_factors(config, n_users, n_items)
    window = config.gather_window
    if window == "auto":
        # A 1-shard mesh has no cross-shard transient to shrink.
        window = sharded and d > 1
    elif not isinstance(window, bool):
        raise ValueError(f"gather_window must be 'auto', True or False "
                         f"(got {config.gather_window!r})")
    window = window and sharded  # windows only exist over sharded factors
    if sharded:
        # Padded rows are never gathered (indices < n) nor scattered to
        # (row ids < n); the final model drops them.
        uf = torch.nn.functional.pad(uf, (0, 0, 0, (-n_users) % d))
        itf = torch.nn.functional.pad(itf, (0, 0, 0, (-n_items) % d))
        spec = PartitionSpec(AXIS_DATA, None)
    else:
        spec = PartitionSpec()
    uf = put_sharded(uf, mesh, spec)
    itf = put_sharded(itf, mesh, spec)

    def side(rows, cols, n_rows, n_src):
        return _device_buckets(
            bucket_by_length(rows, cols, ratings, n_rows,
                             bucket_bounds=config.bucket_bounds,
                             max_len=config.max_degree, pad_rows_to=pad_rows,
                             split_above=config.split_above),
            k, config.max_block_floats, pad_rows, None, mesh=mesh,
            window_n_src=n_src if window else None)

    return ALSInputs(uf0=uf, itf0=itf,
                     user_buckets=side(user_ids, item_ids, n_users, n_items),
                     item_buckets=side(item_ids, user_ids, n_items, n_users),
                     n_users=n_users, n_items=n_items, mesh=mesh)


def _plan_side(rows: torch.Tensor, n_rows: int, config: ALSConfig,
               host_rows: Optional[np.ndarray] = None) -> dp.BucketPlan:
    """One side's :class:`~predictionio_tpu_torch.ops.device_prep.
    BucketPlan` from its COO ids: the degree statistics as one
    ``np.bincount`` when ``host_rows`` (a numpy copy of the same ids) is
    at hand, else on the device of ``rows``.  Both count ids as the
    device build places them (:func:`~predictionio_tpu_torch.ops.
    device_prep.normalize_ids`), so they give the same plan."""
    split_above = config.split_above or 1 << 20
    if host_rows is not None:
        host_rows = np.asarray(host_rows)
        if host_rows.size and host_rows.min() < 0:
            host_rows = np.where(host_rows < 0, host_rows + n_rows,
                                 host_rows)
        in_range = (host_rows >= 0) & (host_rows < n_rows)
        if not in_range.all():
            host_rows = host_rows[in_range]
        counts = np.bincount(host_rows, minlength=n_rows)
        hist = np.bincount(np.minimum(counts, split_above),
                           minlength=split_above + 1)
        over = counts > split_above
        n_over = int(over.sum())
        n_part = int(((counts[over] + split_above - 1)
                      // split_above).sum())
        over_deg = counts[over] if n_over else None
    else:
        counts = torch.bincount(dp.normalize_ids(rows, n_rows)[0],
                                minlength=n_rows)
        hist, n_over, n_part = dp.degree_histogram(counts, split_above)
        # Degrees of the over-cap entities in id order: the plan places
        # the split chunks' boundaries by them.
        over_deg = (counts[counts > split_above].cpu().numpy() if n_over
                    else None)
    return dp.plan_buckets(hist, n_over, n_part, n_rows,
                           split_above=split_above,
                           bucket_bounds=config.bucket_bounds,
                           max_block_floats=config.max_block_floats,
                           rank=config.rank, over_degrees=over_deg)


def _device_side_chunks(rows: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, plan: dp.BucketPlan
                        ) -> List[Tuple[str, Tuple]]:
    """``(kind, arrays)`` of every solve block of one side, in the sweep's
    order: each plain bucket's row chunks (views of its block), then the
    split bucket's entity chunks — the reference's ``_expand_chunks`` of
    its device buckets."""
    plain, split = dp.build_buckets(rows, cols, vals, plan)
    return ([("plain", arrs) for arrs in plain]
            + [("merged", arrs) for arrs in split or ()])


def _device_side(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 plan: dp.BucketPlan) -> List[_Chunk]:
    """One side's solve blocks, laid out on the device of ``rows``."""
    return [_make_chunk(kind, *arrs[:3], arrs[-1],
                        arrs[3] if kind == "merged" else None)
            for kind, arrs in _device_side_chunks(rows, cols, vals, plan)]


def _prepare_als_inputs_device(user_ids, item_ids, ratings, n_users: int,
                               n_items: int, config: ALSConfig,
                               dev: torch.device) -> ALSInputs:
    """The device route: the COO goes up once as int32 / int32 /
    float32, each side is planned on the host (numpy ids) or the device
    (tensor ids) and laid out on ``dev``, and the factors start from
    :func:`_init_factors`."""
    def one_input(ids):
        if isinstance(ids, torch.Tensor):
            return None, ids.to(dev, torch.int32)
        h = np.asarray(ids, dtype=np.int32)
        return h, torch.from_numpy(h).to(dev)

    host_u, rows_u = one_input(user_ids)
    host_i, rows_i = one_input(item_ids)
    if ratings is None:
        vals = torch.ones(rows_u.shape[0], dtype=torch.float32, device=dev)
    else:
        vals = torch.as_tensor(ratings).to(dev, torch.float32)
    plan_u = _plan_side(rows_u, n_users, config, host_rows=host_u)
    plan_i = _plan_side(rows_i, n_items, config, host_rows=host_i)
    uf, itf = (t.to(dev) for t in _init_factors(n_users, n_items,
                                                  config.rank, config.seed))
    return ALSInputs(uf0=uf, itf0=itf,
                     user_buckets=_device_side(rows_u, rows_i, vals, plan_u),
                     item_buckets=_device_side(rows_i, rows_u, vals, plan_i),
                     n_users=n_users, n_items=n_items)


def train_als(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    ratings: Optional[np.ndarray],
    n_users: int,
    n_items: int,
    config: ALSConfig,
    mesh=None,
    *,
    device=None,
    checkpoint_dir=None,
    save_every: int = 0,
) -> ALSModel:
    """Train from COO triplets on ``device`` (default the card); with
    ``checkpoint_dir`` and ``save_every``, under sweep checkpoints
    (:func:`train_als_prepared`)."""
    inputs = prepare_als_inputs(user_ids, item_ids, ratings, n_users,
                                n_items, config, mesh, device=device)
    return train_als_prepared(inputs, config, checkpoint_dir=checkpoint_dir,
                              save_every=save_every)


def train_als_prepared(inputs: ALSInputs, config: ALSConfig, *,
                       checkpoint_dir=None, save_every: int = 0) -> ALSModel:
    """The iteration loop over uploaded buckets, from ``inputs``' init
    (which it does not modify), under supervision.

    With ``checkpoint_dir`` and ``save_every`` the loop runs
    ``save_every`` sweeps a chunk and saves the factors after each
    (:class:`~predictionio_tpu_torch.workflow.checkpoint.
    TrainCheckpointer`, fingerprinted by the config and the data's
    ``n_users`` × ``n_items``); a killed train resumes from the latest
    complete sweep, and because a sweep depends on nothing but the
    factors it starts from (the split buckets sum in a fixed order), the
    resumed factors equal an uninterrupted run's bit for bit.  Each
    chunk is finiteness-checked before it can be saved: a non-finite
    chunk rolls back in place to the last saved sweep (or the init) and
    is replayed, at most ``PIO_DIVERGENCE_RETRIES`` times, then
    :class:`~predictionio_tpu_torch.resilience.supervision.
    TrainDiverged`.  A pending preemption (SIGTERM) saves the current
    sweep and raises ``TrainPreempted``.  ``PIO_STEP_TIMEOUT_S`` arms a
    watchdog around each chunk.  The checkpoints are cleared when the
    train completes.

    Without a checkpoint directory the whole loop is one chunk under the
    watchdog, and a non-finite result raises ``TrainDiverged`` (there is
    nothing to roll back to).  A non-finite model is never returned.

    On a mesh (``inputs.mesh``) the sweeps run :func:`_mesh_train_loop`
    and the returned factors drop the rows padded to the mesh; sweep
    checkpoints are not ported there yet."""
    if inputs.mesh is not None:
        return _train_prepared_mesh(inputs, config, checkpoint_dir,
                                    save_every)
    statics = _resolve_loop_statics(config, inputs.uf0.device)
    reg, alpha = float(config.reg), float(config.alpha)
    total = int(config.iterations)

    def sweeps(uf, itf, n):
        return _train_loop(uf, itf, inputs.user_buckets, inputs.item_buckets,
                           reg, alpha, n, **statics)

    if checkpoint_dir and save_every > 0:
        uf, itf = _supervised_loop(inputs, config, sweeps, checkpoint_dir,
                                   int(save_every))
    else:
        watchdog = StepWatchdog("als")
        watchdog.arm(total)
        try:
            uf, itf = sweeps(inputs.uf0.clone(), inputs.itf0.clone(), total)
            # No checkpoint to roll back to: a non-finite result is a
            # terminal divergence (never silently returned or persisted).
            if not all_finite((uf, itf)):
                raise TrainDiverged("als", total, "non-finite factors", 0)
        finally:
            watchdog.stop()
    return ALSModel(user_factors=uf.cpu().numpy(),
                    item_factors=itf.cpu().numpy(), rank=config.rank,
                    implicit=config.implicit)


def _supervised_loop(inputs: ALSInputs, config: ALSConfig, sweeps,
                     checkpoint_dir, save_every: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The checkpointed loop of :func:`train_als_prepared`: chunks of
    ``save_every`` sweeps, each checked, saved, and rolled back or
    preempted as it says.  Returns the final factors."""
    from predictionio_tpu_torch.workflow.checkpoint import TrainCheckpointer

    total = int(config.iterations)
    guard = DivergenceGuard("als")
    # Fingerprint = config + data dims: checkpoints of another config or
    # a grown dataset are discarded, not resumed into.
    fp = f"als|{config}|{inputs.n_users}x{inputs.n_items}"
    ckpt = TrainCheckpointer(checkpoint_dir, save_every=save_every,
                             fingerprint=fp)
    watchdog = StepWatchdog("als", checkpoint_fn=ckpt.flush)

    def restart() -> Tuple[int, torch.Tensor, torch.Tensor]:
        """The latest saved sweep (or the init at sweep 0), as fresh
        tensors the sweeps may update in place."""
        ckpt.restored_state = None
        done = ckpt.restore_step((inputs.uf0, inputs.itf0),
                                 total_steps=total)
        if ckpt.restored_state is not None:
            uf, itf = ckpt.restored_state
            return done, uf, itf
        return 0, inputs.uf0.clone(), inputs.itf0.clone()

    try:
        done, uf, itf = restart()
        while done < total:
            n = min(save_every, total - done)
            watchdog.arm(done + n)
            uf, itf = sweeps(uf, itf, n)
            finite = all_finite((uf, itf))  # waits for the chunk
            watchdog.disarm()
            if not finite:
                # Roll back IN PLACE to the latest durable sweep and
                # replay; diverged() raises TrainDiverged once the
                # retries are spent.
                try:
                    guard.diverged(done + n, "non-finite factors")
                except RollbackRequested:
                    pass
                done, uf, itf = restart()
                continue
            done += n
            saved = ckpt.maybe_save(done, (uf, itf))
            if preemption_requested():
                if not saved:
                    ckpt.save(done, (uf, itf))
                ckpt.flush()
                raise TrainPreempted("als", done, True)
        ckpt.complete()
    finally:
        watchdog.stop()
        ckpt.close()
    return uf, itf


def _resolve_loop_statics(config: ALSConfig, device: torch.device) -> dict:
    """Route choices, made once before the loop: which solver runs and
    the gram dtype.  The gram build has one route, K1's dispatcher (the
    kernel on the card, its plain version on the CPU), so on the card a
    rank K1 does not take, or ``use_pallas=False``, is refused here.
    ``solver="auto"`` takes K2 on the card where it takes the rank and
    the Cholesky solve elsewhere, as the reference does above
    ``gj_fits_vmem``; a kernel solver asked for by name on the card must
    take the rank."""
    k = config.rank
    on_card = device.type == "cuda"
    if on_card and config.use_pallas is False:
        raise ValueError("use_pallas=False asks for the plain gram on the "
                         "card; the port runs plain versions on CPU "
                         "tensors only (train with device='cpu')")
    if on_card and not fg.supports(k):
        raise NotImplementedError(
            f"the fused gram kernel takes ranks 1..{fg.MAX_RANK} "
            f"(got rank {k}); larger ranks are not ported to the card")
    solver = config.solver
    if solver == "auto":
        solver = "lu" if on_card and rs.supports(k) else "cholesky"
    elif solver not in ("lu", "gj", "cholesky"):
        raise ValueError(f"solver must be 'auto', 'lu', 'gj' or 'cholesky' "
                         f"(got {config.solver!r})")
    if on_card and solver != "cholesky" and not rs.supports(k):
        raise NotImplementedError(
            f"solver {solver!r}: the ridge-solve kernels take ranks "
            f"1..{rs.MAX_RANK} (got rank {k}); use solver='cholesky'")
    return dict(gram_dtype=_resolve_gram_dtype(config.gram_dtype),
                solver=solver, implicit=config.implicit)


def _side(chunks: List[_Chunk], dst: torch.Tensor, src: torch.Tensor,
          reg: float, alpha: float, *, gram_dtype: str, solver: str,
          implicit: bool) -> torch.Tensor:
    """Solve every bucket of one side against the other side's factors
    ``src``, writing into ``dst`` in place."""
    # Hoisted per side: YᵀY and the gram-dtype copy of src are the same
    # for every bucket.
    yty = gram(src) if implicit else None
    src_g = src.to(_GRAM_DTYPES[gram_dtype])
    for ch in chunks:
        if ch.kind == "merged":
            _merged_solve(ch, dst, src_g, yty, reg, alpha, implicit, solver)
        else:
            solved = _solve_bucket(ch.indices, ch.values, ch.mask, src_g,
                                   yty, reg, alpha, implicit, solver)
            _scatter_rows(dst, ch.keep, ch.targets, solved)
    return dst


def _train_loop(uf: torch.Tensor, itf: torch.Tensor,
                user_buckets: List[_Chunk], item_buckets: List[_Chunk],
                reg: float, alpha: float, iterations: int, **statics
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Users first, then items, ``iterations`` times; updates ``uf`` and
    ``itf`` in place."""
    for _ in range(iterations):
        uf = _side(user_buckets, uf, itf, reg, alpha, **statics)
        itf = _side(item_buckets, itf, uf, reg, alpha, **statics)
    return uf, itf


# -- the mesh sweep --------------------------------------------------------------

def _lane_blocks(x: ShardedTensor) -> List[torch.Tensor]:
    """``x``'s block on each shard of the ``data`` axis, in shard order
    (the whole matrix on each, when ``x`` is replicated)."""
    return [x.block(p) for p in axis_lane(x.mesh, AXIS_DATA)]


def _distinct(tensors) -> List[torch.Tensor]:
    """``tensors`` without repeats (replicas shared by positions of one
    device are one tensor)."""
    seen, out = set(), []
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _mesh_full(src: ShardedTensor, dev: torch.device, dtype: torch.dtype,
               memo: dict) -> torch.Tensor:
    """The whole (padded) matrix on ``dev`` in ``dtype``: the replica
    there, or the row blocks gathered in shard order (once a side, per
    device)."""
    key = str(dev)
    if key not in memo:
        if _factor_constraint(src) is None:
            rep = next((b for b in _lane_blocks(src) if b.device == dev),
                       None)
            full = rep if rep is not None else _lane_blocks(src)[0].to(dev)
        else:
            full = torch.cat([b.to(dev) for b in _lane_blocks(src)])
        memo[key] = full.to(dtype)
    return memo[key]


def _mesh_gram(src: ShardedTensor) -> torch.Tensor:
    """YᵀY of the whole matrix (padded rows are zeros): one gram of the
    replica, or the fixed-order sum of the row blocks' grams."""
    blocks = _lane_blocks(src)
    if _factor_constraint(src) is None:
        return gram(blocks[0])
    return psum([gram(b) for b in blocks], src.mesh)


def _mesh_scatter(dst: ShardedTensor, ch: _Chunk,
                  rows: torch.Tensor) -> None:
    """Write a shard's solved rows (row ``ch.keep[n]`` of ``rows`` onto
    global row ``ch.targets[n]``) into every replica of ``dst``, or into
    the row block that owns each target.  The routes to the blocks are
    the same every sweep: worked out once, then kept on ``ch``."""
    rows = rows.index_select(0, ch.keep)
    if _factor_constraint(dst) is None:
        for rep in _distinct(_lane_blocks(dst)):
            rep.index_copy_(0, ch.targets.to(rep.device),
                            rows.to(rep.device))
        return
    blocks = _lane_blocks(dst)
    if ch.routes is None:
        per = dst.shape[0] // len(blocks)
        ch.routes = []
        for s, blk in enumerate(blocks):
            own = (ch.targets >= s * per) & (ch.targets < (s + 1) * per)
            sel = torch.nonzero(own).squeeze(1)
            if sel.numel():
                ch.routes.append((s, sel, (ch.targets[sel] - s * per)
                                  .to(blk.device)))
    for s, sel, local in ch.routes:
        blk = blocks[s]
        blk.index_copy_(0, local, rows.index_select(0, sel).to(blk.device))


def _mesh_side(chunks: List[_MeshChunk], dst: ShardedTensor,
               src: ShardedTensor, reg: float, alpha: float, *,
               gram_dtype: str, solver: str, implicit: bool) -> None:
    """One side's sweep on a mesh: every block's shards solve their own
    rows against ``src`` on their own devices (K1, K2 on the card) and
    write into ``dst`` in place.  A merged (split) block's per-shard
    segment sums add in shard order before its entities are solved,
    each shard solving its entity block."""
    gdt = _GRAM_DTYPES[gram_dtype]
    yty = _mesh_gram(src) if implicit else None
    full: dict = {}
    for mc in chunks:
        wins: dict = {}
        pieces = []
        for s, ch in enumerate(mc.shards):
            dev = ch.indices.device
            if mc.win is not None:
                key = str(dev)
                if key not in wins:
                    wins[key] = _window_gather(src, mc.win[s],
                                               device=dev).to(gdt)
                bsrc = wins[key]
            else:
                bsrc = _mesh_full(src, dev, gdt, full)
            y = None if yty is None else yty.to(dev)
            if mc.kind == "plain":
                solved = _solve_bucket(ch.indices, ch.values, ch.mask, bsrc,
                                       y, reg, alpha, implicit, solver)
                _mesh_scatter(dst, ch, solved)
                continue
            a, b, deg = _gram_pieces(ch.indices, ch.values, ch.mask, bsrc,
                                     alpha, implicit)
            n, k = ch.n_seg, a.shape[-1]
            with deterministic():
                pieces.append((
                    a.new_zeros((n + 1, k, k)).index_add_(0, ch.seg_ids,
                                                          a)[:n],
                    b.new_zeros((n + 1, k)).index_add_(0, ch.seg_ids, b)[:n],
                    deg.new_zeros(n + 1).index_add_(0, ch.seg_ids, deg)[:n]))
        if mc.kind == "plain":
            continue
        big_a, big_b, degree = (psum([pc[j] for pc in pieces], src.mesh)
                                for j in range(3))
        if implicit:
            big_a += yty.to(big_a.device)
        per = big_a.shape[0] // len(mc.shards)
        for s, ch in enumerate(mc.shards):
            dev = ch.indices.device
            sl = slice(s * per, (s + 1) * per)
            solved = _ridge(big_a[sl].to(dev), big_b[sl].to(dev),
                            reg * degree[sl].to(dev).clamp_min(1.0), solver)
            _mesh_scatter(dst, ch, solved)


def _mesh_train_loop(uf: ShardedTensor, itf: ShardedTensor,
                     user_buckets: List[_MeshChunk],
                     item_buckets: List[_MeshChunk], reg: float,
                     alpha: float, iterations: int, **statics) -> None:
    """Users first, then items, ``iterations`` times, in place."""
    for _ in range(iterations):
        _mesh_side(user_buckets, uf, itf, reg, alpha, **statics)
        _mesh_side(item_buckets, itf, uf, reg, alpha, **statics)


def _mesh_clone(x: ShardedTensor) -> ShardedTensor:
    """A copy with its own blocks (positions that shared a block share
    its copy)."""
    copies: dict = {}
    shards = [None if t is None else copies.setdefault(id(t), t.clone())
              for t in x.shards]
    return ShardedTensor(x.sharding, x.shape, shards)


def _train_prepared_mesh(inputs: ALSInputs, config: ALSConfig,
                         checkpoint_dir, save_every: int) -> ALSModel:
    """:func:`train_als_prepared` on a mesh: the sweeps under the step
    watchdog, a non-finite result raising ``TrainDiverged``."""
    if checkpoint_dir and save_every > 0:
        raise NotImplementedError(
            "sweep checkpoints of a mesh train are not ported yet "
            "(ROADMAP Queue 1 item 10b); train without --checkpoint-dir")
    first = _lane_blocks(inputs.uf0)[0].device
    statics = _resolve_loop_statics(config, first)
    total = int(config.iterations)
    uf, itf = _mesh_clone(inputs.uf0), _mesh_clone(inputs.itf0)
    watchdog = StepWatchdog("als")
    watchdog.arm(total)
    try:
        _mesh_train_loop(uf, itf, inputs.user_buckets, inputs.item_buckets,
                         float(config.reg), float(config.alpha), total,
                         **statics)
        if not all_finite(_distinct(_lane_blocks(uf) + _lane_blocks(itf))):
            raise TrainDiverged("als", total, "non-finite factors", 0)
    finally:
        watchdog.stop()
    # Blocked mode pads factor rows to the mesh axis; the model keeps
    # the true extents.
    return ALSModel(user_factors=uf.to_host()[:inputs.n_users],
                    item_factors=itf.to_host()[:inputs.n_items],
                    rank=config.rank, implicit=config.implicit)


def rmse(model: ALSModel, user_ids, item_ids, ratings, *,
         device=None) -> float:
    """Explicit-feedback fit metric over (user, item, rating) triples,
    computed on ``device`` (default the card)."""
    dev = resolve_device(device)
    pred = predict_scores(_on(model.user_factors, dev),
                          _on(model.item_factors, dev),
                          _on(user_ids, dev).long(), _on(item_ids, dev).long())
    diff = pred - _on(ratings, dev).float()
    return float(torch.sqrt(torch.mean(diff * diff)))


# -- serving --------------------------------------------------------------------

def _on(x: Union[np.ndarray, torch.Tensor], device: torch.device
        ) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def predict_scores(user_factors: torch.Tensor, item_factors: torch.Tensor,
                   users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Pointwise r̂_ui for parallel (user, item) id vectors, float32."""
    return torch.einsum("bk,bk->b", user_factors[users].float(),
                        item_factors[items].float())


def recommend(
    model: ALSModel,
    user_indices,                  # [B] int
    k: int,
    *,
    seen=None,                     # [B, n_items] bool — exclude
    chunk: Optional[int] = None,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items per user on ``device`` (reference: MLlib
    recommendProducts).  Returns ([B, k] float32, [B, k] int32)."""
    idx = _on(user_indices, device).long()
    q = _on(model.user_factors, device)[idx]
    items = _on(model.item_factors, device)
    if chunk:
        return chunked_top_k(q, items, k, chunk=chunk)
    return top_k_scores(q, items, k,
                        exclude=None if seen is None else _on(seen, device))


def fold_in(
    item_factors: np.ndarray,     # [I, K] host item factors (frozen)
    item_ids: np.ndarray,         # [d] int — the user's observed items
    ratings: np.ndarray,          # [d] float — ratings / implicit strengths
    *,
    reg: float,
    alpha: float = 1.0,
    implicit: bool = False,
    yty: Optional[np.ndarray] = None,   # [K, K] — required when implicit
) -> np.ndarray:
    """Serve-time fold-in: one ridge solve for an unseen user against
    the frozen item factors (reference: ``models/als.py`` ``fold_in``).

    The user-side normal equation of the training sweep (ALS-WR
    ``λ·n_u`` ridge; implicit = Hu-Koren-Volinsky with the shared
    ``YᵀY`` the caller passes in), in float64 host numpy: the rank is
    tens and the degree a visitor's recent-event count, so one K×K
    solve is microseconds and the request never waits on the card.
    """
    item_ids = np.asarray(item_ids, np.int64)
    r = np.asarray(ratings, np.float64)
    y = np.asarray(item_factors, np.float64)[item_ids]      # [d, K]
    k = y.shape[1]
    if implicit:
        if yty is None:
            raise ValueError("implicit fold_in needs the cached YᵀY")
        w = alpha * np.abs(r)                               # c - 1
        c = (1.0 + w) * (r > 0)
        a = np.asarray(yty, np.float64) + (y * w[:, None]).T @ y
        b = y.T @ c
    else:
        a = y.T @ y
        b = y.T @ r
    n = max(len(item_ids), 1)
    a = a + reg * n * np.eye(k)
    try:
        u = np.linalg.solve(a, b)
    except np.linalg.LinAlgError:                       # singular corner:
        u = np.linalg.lstsq(a, b, rcond=None)[0]        # degenerate events
    return u.astype(np.float32)
