"""Alternating least squares: the training sweep and the serving functions.

Port of ``predictionio_tpu/models/als.py`` (reference behaviour: Spark
MLlib ``ALS.train`` / ``ALS.trainImplicit`` as the recommendation
template calls them).  One training run:

- ragged ratings → degree-bucketed padded blocks on the host
  (:mod:`predictionio_tpu_torch.ops.ragged`), uploaded once, with index
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
One process and one device: ``mesh`` must be None, and the mesh knobs
``factor_sharding`` / ``gather_window`` are accepted and ignored, as the
reference ignores them without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
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
from predictionio_tpu_torch.resilience.supervision import (
    TrainDiverged,
    all_finite,
)

__all__ = ["ALSConfig", "ALSModel", "ALSInputs", "als_model_from_numpy",
           "prepare_als_inputs", "train_als", "train_als_prepared",
           "predict_scores", "recommend", "rmse"]


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
    # Device-side bucketing is not ported: "auto" and False bucket on
    # the host; True raises.
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


def _valid_rows(ids: np.ndarray, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host half of :func:`_scatter_rows`, computed once at upload:
    the positions whose id is valid (``id >= 0``, the mask) and the ids
    there, as int64 tensors on ``device``."""
    ids = np.asarray(ids)
    keep = np.flatnonzero(ids >= 0)
    return (torch.from_numpy(keep).to(device),
            torch.from_numpy(ids[keep].astype(np.int64)).to(device))


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


def _merged_solve(ch: _Chunk, dst: torch.Tensor, src: torch.Tensor,
                  yty: Optional[torch.Tensor], reg: float, alpha: float,
                  implicit: bool, solver: str) -> None:
    """Split-bucket step: partial rows → segment-summed normal equations
    → one solve per entity.  The sums are ``index_add_``, which on the
    card adds in no fixed order: the bits may differ from run to run."""
    a, b, deg = _gram_pieces(ch.indices, ch.values, ch.mask, src, alpha,
                             implicit)
    n, k = ch.n_seg, a.shape[-1]
    seg = ch.seg_ids
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


def _upload(kind: str, idx, vals, msk, ids, device: torch.device,
            seg=None) -> _Chunk:
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    keep, targets = _valid_rows(ids, device)
    n_seg = len(ids) if seg is not None else 0
    return _Chunk(kind=kind, indices=put(idx, np.int32),
                  values=put(vals, np.float32), mask=put(msk, np.bool_),
                  keep=keep, targets=targets,
                  seg_ids=None if seg is None
                  else put(np.minimum(seg, n_seg), np.int64),
                  n_seg=n_seg)


def _device_buckets(buckets: List[Padded], rank: int, max_block_floats: int,
                    pad_rows: int, device: torch.device) -> List[_Chunk]:
    """Upload padded buckets, splitting any whose gathered [R, L, K]
    block would exceed ``max_block_floats`` into row chunks of
    ``rows_max`` rows; the last chunk is row-padded (row_id = -1, which
    the scatter drops) only up to a multiple of ``pad_rows``, as
    :func:`_chunk_split_bucket` pads, so K1 and K2 do no work on rows
    that exist only to fill a chunk.  Host loop; index blocks go up as
    int32, once."""
    out: List[_Chunk] = []
    for p in buckets:
        if p.split:
            for idx, vals, msk, seg, ent in _chunk_split_bucket(
                    p, rank, max_block_floats, pad_rows):
                out.append(_upload("merged", idx, vals, msk, ent, device,
                                   seg=seg))
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
            out.append(_upload("plain", idx, vals, msk, rid, device))
    return out


@dataclasses.dataclass
class ALSInputs:
    """Uploaded padded buckets + factor init (prep done once), so a
    caller can run :func:`train_als_prepared` more than once without
    re-bucketing or re-uploading."""

    uf0: torch.Tensor
    itf0: torch.Tensor
    user_buckets: List[_Chunk]
    item_buckets: List[_Chunk]
    n_users: int
    n_items: int


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
    """Host bucketing (:func:`~predictionio_tpu_torch.ops.ragged.
    bucket_by_length`) + upload for :func:`train_als_prepared`.
    ``device``: where training runs (default the card; ``"cpu"`` for the
    plain paths)."""
    if mesh is not None:
        raise NotImplementedError("ALS on a device mesh is not ported yet; "
                                  "pass mesh=None (one device)")
    if config.device_prep is True:
        raise NotImplementedError("device-side bucketing is not ported yet; "
                                  "use device_prep='auto' or False (host)")
    dev = resolve_device(device)
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
) -> ALSModel:
    """Train from COO triplets on ``device`` (default the card)."""
    inputs = prepare_als_inputs(user_ids, item_ids, ratings, n_users,
                                n_items, config, mesh, device=device)
    return train_als_prepared(inputs, config)


def train_als_prepared(inputs: ALSInputs, config: ALSConfig) -> ALSModel:
    """The iteration loop over uploaded buckets, from ``inputs``' init
    (which it does not modify).  A non-finite result raises
    :class:`~predictionio_tpu_torch.resilience.supervision.TrainDiverged`
    and is never returned."""
    statics = _resolve_loop_statics(config, inputs.uf0.device)
    uf, itf = _train_loop(inputs.uf0.clone(), inputs.itf0.clone(),
                          inputs.user_buckets, inputs.item_buckets,
                          float(config.reg), float(config.alpha),
                          int(config.iterations), **statics)
    # No checkpoint to roll back to: a non-finite result is a terminal
    # divergence (never silently returned or persisted).
    if not all_finite((uf, itf)):
        raise TrainDiverged("als", int(config.iterations),
                            "non-finite factors", 0)
    return ALSModel(user_factors=uf.cpu().numpy(),
                    item_factors=itf.cpu().numpy(), rank=config.rank,
                    implicit=config.implicit)


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
