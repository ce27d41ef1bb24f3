"""Recommendation template — ALS personal recommendations.

Port of ``predictionio_tpu/templates/recommendation/engine.py``.  The
contract is the reference's:

- events: ``rate`` (user→item, properties.rating) and ``buy`` (user→item,
  implicit, trained as ``buyRating``)
- query JSON: ``{"user": "u1", "num": 4}``
- result JSON: ``{"itemScores": [{"item": "i1", "score": 1.2}, ...]}``
- algorithm params: rank / numIterations / lambda / alpha /
  implicitPrefs / seed — the MLlib ``ALS.train`` knob set

The reference template imports jax at module level, so the port copies
its types instead of importing them.  Training runs the port's ALS
sweep (kernels K1 and K2 on the card), then builds the reference's
train-time retrieval structures on the host: an IVF index under an
explicit ``PIO_IVF=on``, and residual PQ codes under the ``PIO_PQ``
policy on top of it.  Serving goes through the port's retrieval facade
(exact rungs, the chunked one on the fused top-k kernel K3; the IVF and
PQ rungs, ``pq_flat`` on the PQ scan kernel K5).  An unseen user with
``rate``/``buy`` events is folded in at serve time (one host ridge
solve against the frozen item factors) and rides the same retrieval
call as the trained users; the solved factor is shared through the
storage's KV with every other server on the same storage
(``PIO_FOLD_IN_SHARED*``).  ``read_eval`` gives ``pio eval`` its seeded
folds.  A generation trained elsewhere can still be carried in with
:func:`wrapper_from_numpy` and persisted with
:func:`predictionio_tpu_torch.workflow.core_workflow.persist_instance`.
``ALSAlgorithm.warm_start`` is the refresh loop's delta warm start
(host float64 ridge sweeps over the delta-touched rows, as in the
reference).  Not ported yet: the quality and recall scorecards.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
import weakref
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    Preparator,
    RuntimeContext,
    WarmStartFallback,
)
from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.data.event import BiMap
from predictionio_tpu_torch.data.storage.base import epoch_us
from predictionio_tpu_torch.models import als as als_lib
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.retrieval import (
    IVFIndex,
    PQCodebook,
    Retriever,
    _env_int,
    build_train_index,
    build_train_pq,
    cached_retriever,
    iter_hits,
)

__all__ = [
    "engine",
    "Query",
    "ItemScore",
    "PredictedResult",
    "Ratings",
    "DataSourceParams",
    "RecommendationDataSource",
    "RecommendationPreparator",
    "ALSAlgorithmParams",
    "ALSAlgorithm",
    "ALSModelWrapper",
    "wrapper_from_numpy",
]


# -- query / result (JSON contract) -----------------------------------------

@dataclasses.dataclass
class Query:
    user: str
    num: int = 10


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    itemScores: List[ItemScore]  # noqa: N815 — reference JSON field name


# -- training data ----------------------------------------------------------

@dataclasses.dataclass
class Ratings:
    """COO ratings plus the string↔int entity indexes (reference: the
    template's ``TrainingData``), with the fold-in context the trained
    wrapper keeps."""

    user_ids: np.ndarray
    item_ids: np.ndarray
    ratings: np.ndarray
    user_index: BiMap
    item_index: BiMap
    app_name: Optional[str] = None
    event_names: Sequence[str] = ()
    buy_rating: float = 4.0


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str  # noqa: N815 — engine.json key parity
    eventNames: Sequence[str] = ("rate", "buy")  # noqa: N815
    buyRating: float = 4.0  # noqa: N815 — implicit "buy" becomes this rating
    evalK: Optional[int] = None  # noqa: N815 — folds for pio eval
    evalQueryNum: int = 10  # noqa: N815
    seed: int = 3


class RecommendationDataSource(DataSource):
    """Reads rate/buy events into COO ratings (reference: DataSource.scala)."""

    params_class = DataSourceParams

    def _read(self, ctx: RuntimeContext) -> Ratings:
        from predictionio_tpu_torch.data.columnar import (
            encode_ids,
            event_mask,
            numeric_property,
        )

        p: DataSourceParams = self.params
        table = ctx.event_store.find_columnar(
            p.appName,
            entity_type="user",
            target_entity_type="item",
            event_names=list(p.eventNames),
            # training is order-independent, and only these columns
            # feed the COO
            ordered=False,
            columns=["event", "entity_id", "target_entity_id", "properties"],
        )
        user_ids, user_index = encode_ids(table["entity_id"])
        item_ids, item_index = encode_ids(table["target_entity_id"])
        is_rate = event_mask(table, ["rate"])
        raw = numeric_property(table, "rating", default=np.nan)
        ratings = np.where(is_rate, raw, p.buyRating).astype(np.float32)
        # Decided semantic (PARITY.md): a `rate` event with no numeric
        # `rating` property is DROPPED with a warning — never trained as
        # rating 0.0, a strong negative signal in explicit ALS.
        bad = is_rate & ~np.isfinite(ratings)
        if bad.any():
            logging.getLogger(__name__).warning(
                "dropping %d rate event(s) without a numeric 'rating' "
                "property", int(bad.sum()))
            keep = ~bad
            user_ids, item_ids = user_ids[keep], item_ids[keep]
            ratings = ratings[keep]
        return Ratings(
            user_ids=user_ids,
            item_ids=item_ids,
            ratings=ratings,
            user_index=user_index,
            item_index=item_index,
            app_name=p.appName,
            event_names=tuple(p.eventNames),
            buy_rating=p.buyRating,
        )

    def read_training(self, ctx: RuntimeContext) -> Ratings:
        return self._read(ctx)

    def read_eval(self, ctx: RuntimeContext):
        """``evalK`` folds drawn per rating from ``seed``; each fold's
        queries ask ``evalQueryNum`` items of every user with held-out
        positives, those items the actuals (reference:
        DataSource.readEval)."""
        p: DataSourceParams = self.params
        if not p.evalK:
            return []
        data = self._read(ctx)
        n = len(data.user_ids)
        rng = np.random.default_rng(p.seed)
        fold_of = rng.integers(0, p.evalK, n)
        inv_user = data.user_index.inverse
        inv_item = data.item_index.inverse
        folds = []
        for k in range(p.evalK):
            train_sel = fold_of != k
            test_sel = ~train_sel
            td = Ratings(
                user_ids=data.user_ids[train_sel],
                item_ids=data.item_ids[train_sel],
                ratings=data.ratings[train_sel],
                user_index=data.user_index,
                item_index=data.item_index,
            )
            qa: Dict[str, set] = {}
            for u, i, r in zip(data.user_ids[test_sel],
                               data.item_ids[test_sel],
                               data.ratings[test_sel]):
                if r > 0:
                    qa.setdefault(inv_user[u], set()).add(inv_item[i])
            queries = [
                (Query(user=u, num=p.evalQueryNum), sorted(actual))
                for u, actual in sorted(qa.items())
            ]
            folds.append((td, None, queries))
        return folds


class RecommendationPreparator(Preparator):
    """Reference: Preparator.scala — identity over the ratings."""

    def prepare(self, ctx: RuntimeContext, training_data: Ratings) -> Ratings:
        return training_data


# -- algorithm --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 10  # noqa: N815 — MLlib knob names
    lambda_: float = 0.01
    alpha: float = 1.0
    implicitPrefs: bool = False  # noqa: N815
    maxDegree: Optional[int] = None  # noqa: N815 — ragged truncation cap
    seed: Optional[int] = None
    # Mesh knobs of the reference; bound for engine.json parity, used by
    # the multi-chip slice.
    factorSharding: str = "auto"  # noqa: N815
    gatherWindow: Union[bool, str] = "auto"  # noqa: N815


def _fold_in_enabled() -> bool:
    """``PIO_FOLD_IN``: unset or empty is on; ``0``/``off``/``false``/
    ``no`` (any case) turn fold-in off."""
    return env_bool(os.environ.get("PIO_FOLD_IN"), True)


def _fold_metric():
    return get_registry().counter(
        "pio_fold_in_total",
        "Serve-time ALS fold-in attempts by outcome "
        "(cached/shared/solved/no_events/unavailable).", ("result",))


# A user with no usable events is cached too (an unknown-user query
# storm must not read the event store once a request), but only this
# long: their first events should become recommendations within
# seconds, not a generation's lifetime.
_FOLD_NEG_TTL_S = 30.0


# -- the durable shared fold-in cache ----------------------------------------
#
# Several servers on one storage each solving the same visitor is wasted
# work, and a restarted server would re-solve everyone.  So a solved
# factor is also written (best-effort) to the storage's shared KV, keyed
# by (factor fingerprint, user): the fingerprint — a SHA-1 of the
# generation's item-factor bytes — names the exact matrix the solve is
# valid against, so servers of the same generation share entries and a
# different generation misses.  The local LRU stays the read-through
# layer; the KV is read only on an LRU miss.  Negative outcomes are never
# shared: "no events yet" goes stale in seconds.

def _fold_shared_enabled() -> bool:
    """``PIO_FOLD_IN_SHARED``: on unless set off."""
    return env_bool(os.environ.get("PIO_FOLD_IN_SHARED"), True)


def _fold_encode(vec: np.ndarray, watermark_us: Optional[int]) -> bytes:
    """A JSON header line — the length ``n``, the event-time watermark
    ``wm`` of the newest event consumed and the solve time ``ts`` (epoch
    s, the max-age gate's anchor) — then the float32 bytes."""
    v = np.ascontiguousarray(vec, dtype=np.float32)
    head = json.dumps({"n": int(v.shape[0]), "wm": watermark_us,
                       "ts": round(time.time(), 3)},
                      separators=(",", ":")).encode()
    return head + b"\n" + v.tobytes()


def _fold_decode(blob: bytes
                 ) -> Optional[Tuple[np.ndarray, Optional[float]]]:
    """(vector, solve time in epoch s), or None for a malformed entry."""
    try:
        head, raw = blob.split(b"\n", 1)
        meta = json.loads(head)
        vec = np.frombuffer(raw, dtype=np.float32)
        if vec.shape[0] != int(meta["n"]):
            return None
        ts = meta.get("ts")
        return vec.copy(), (float(ts) if ts is not None else None)
    except Exception:
        return None


def _fold_shared_max_age_s() -> float:
    """``PIO_FOLD_IN_SHARED_MAX_AGE_S`` (0, the default, accepts any
    age): a shared entry solved longer ago than this is a miss, so the
    reader re-solves with the events that arrived since.  The anchor is
    the solve time, not the user's newest event: gating on event
    recency would expire every idle user's entry."""
    try:
        return float(os.environ.get("PIO_FOLD_IN_SHARED_MAX_AGE_S",
                                    "0") or 0)
    except ValueError:
        return 0.0


# eq=False: wrapper identity IS the model generation — keeps the object
# hashable for the weak-keyed retriever cache.
@dataclasses.dataclass(eq=False)
class ALSModelWrapper:
    """Trained factors + indexes (reference: template ALSModel).

    Everything pickled is numpy or plain Python; the CUDA copies of the
    corpus, index and codes live in the weak-keyed retriever cache and
    die with the wrapper.  ``ivf``/``pq`` are the generation's optional
    IVF index and PQ codebook, pickled with it so a generation swap moves
    model, index and codes together.

    Serve-time fold-in: an unseen user with recent events gets one ridge
    solve against the frozen item factors (``models.als.fold_in``)
    instead of the cold-start empty answer.  The folded factor lives in
    a bounded per-generation LRU (``PIO_FOLD_IN_CACHE``) and, shared
    with other servers, in the storage's KV; the next train makes the
    user durable.
    """

    model: als_lib.ALSModel
    user_index: BiMap
    item_index: BiMap
    ivf: Optional[IVFIndex] = None
    pq: Optional[PQCodebook] = None
    app_name: Optional[str] = None
    fold_event_names: Sequence[str] = ()
    buy_rating: float = 4.0
    reg: float = 0.01
    alpha: float = 1.0
    n_examples: int = 0

    def __post_init__(self):
        self._init_transients()

    def _init_transients(self) -> None:
        # Per-generation serving state, never pickled: it dies with the
        # wrapper on reload, exactly when the factors it was solved
        # against do.  Cache values are (vector | None, monotonic
        # stamp); None is a negative entry, kept _FOLD_NEG_TTL_S.
        self._device = None
        self._fold_cache: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._fold_lock = threading.Lock()
        self._event_store = None
        self._yty: Optional[np.ndarray] = None
        # The shared KV arrives at post_load; the fingerprint binds its
        # entries to this generation's factors.
        self._shared_kv = None
        self._fold_fp: Optional[str] = None
        self._fold_puts = 0

    def __getstate__(self):
        d = self.__dict__.copy()
        for k in ("_device", "_fold_cache", "_fold_lock", "_event_store",
                  "_yty", "_shared_kv", "_fold_fp", "_fold_puts"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._init_transients()

    def post_load(self, ctx: RuntimeContext) -> None:
        """Serving-time hook: take the device the server runs on, the
        event store fold-in reads and, where the storage has one, the
        shared KV of solved factors (all transient, never pickled)."""
        self._device = ctx.device
        store = getattr(ctx, "event_store", None)
        if store is not None:
            self._event_store = store
        storage = getattr(ctx, "storage", None)
        if storage is not None and _fold_shared_enabled():
            try:
                self._shared_kv = storage.get_kv()
            except Exception:
                self._shared_kv = None

    def retriever(self) -> Retriever:
        """THE serving route to the item corpus — one per loaded
        generation, dying with it."""
        # host_fn holds the wrapper WEAKLY: the retriever is the
        # weak-keyed cache's VALUE, so a strong capture would pin its own
        # key alive and leak every swapped-out generation.
        ref = weakref.ref(self)
        return cached_retriever(self, lambda: Retriever(
            self.model.item_factors,
            n_items=len(self.item_index),
            ivf=self.ivf,
            pq=self.pq,
            name="als",
            host_fn=lambda: ref().host_factors()[1],
            device=self._device))

    def host_user_factors(self) -> np.ndarray:
        """User factors, trimmed to the trained users."""
        return self.model.user_factors[: len(self.user_index)]

    def host_factors(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self.model.user_factors[: len(self.user_index)],
                self.model.item_factors[: len(self.item_index)])

    def fold_in_user(self, user: str) -> Optional[np.ndarray]:
        """Solve an unseen user's factor from their recent events
        (``PIO_FOLD_IN_EVENTS``, newest first) against the frozen item
        factors; None when fold-in is off, no event store is attached,
        the read fails, or the user has no mappable events.  Outcomes
        count in ``pio_fold_in_total{result}``."""
        es = self._event_store
        if es is None or not self.app_name or not _fold_in_enabled():
            return None
        with self._fold_lock:
            hit = self._fold_cache.get(user)
            if hit is not None:
                vec, t = hit
                if vec is not None or \
                        time.monotonic() - t < _FOLD_NEG_TTL_S:
                    self._fold_cache.move_to_end(user)
                    _fold_metric().inc(result="cached")
                    return vec
                del self._fold_cache[user]  # expired negative: re-check
        # Another server may have solved this user against the same
        # factors: one KV read beats an event read and a solve.
        shared_vec = self._fold_shared_get(user)
        if shared_vec is not None:
            self._fold_store(user, shared_vec)
            _fold_metric().inc(result="shared")
            return shared_vec
        try:
            events = es.find_by_entity(
                self.app_name, "user", user,
                event_names=list(self.fold_event_names) or None,
                target_entity_type="item",
                limit=_env_int("PIO_FOLD_IN_EVENTS", 50), latest=True)
        except Exception:
            # A storage blip degrades to the cold-start answer; it never
            # fails the batch this user rides in.
            logging.getLogger(__name__).debug("fold-in event read failed",
                                              exc_info=True)
            _fold_metric().inc(result="unavailable")
            return None
        ids: List[int] = []
        vals: List[float] = []
        watermark_us: Optional[int] = None
        for ev in events:
            idx = self.item_index.get(ev.target_entity_id)
            if idx is None:
                continue  # item unknown to this generation
            if ev.event == "rate":
                r = ev.properties.get("rating")
                if not isinstance(r, (int, float)) or not np.isfinite(r):
                    continue
                vals.append(float(r))
            else:
                vals.append(float(self.buy_rating))
            ids.append(int(idx))
            us = epoch_us(ev.event_time)
            if us is not None and (watermark_us is None or us > watermark_us):
                watermark_us = us
        if not ids:
            self._fold_store(user, None)
            _fold_metric().inc(result="no_events")
            return None
        _, itf = self.host_factors()
        if self.model.implicit and self._yty is None:
            f = itf.astype(np.float64)
            self._yty = f.T @ f
        vec = als_lib.fold_in(
            itf, np.asarray(ids), np.asarray(vals, np.float32),
            reg=float(self.reg), alpha=float(self.alpha),
            implicit=self.model.implicit, yty=self._yty)
        self._fold_store(user, vec)
        self._fold_shared_put(user, vec, watermark_us)
        _fold_metric().inc(result="solved")
        return vec

    def _fold_ns(self) -> str:
        """The KV namespace of this generation's factors."""
        if self._fold_fp is None:
            _, itf = self.host_factors()
            self._fold_fp = hashlib.sha1(
                np.ascontiguousarray(itf, dtype=np.float32).tobytes()
            ).hexdigest()[:16]
        return f"foldin:{self._fold_fp}"

    def _fold_shared_get(self, user: str) -> Optional[np.ndarray]:
        kv = self._shared_kv
        if kv is None or not _fold_shared_enabled():
            return None
        try:
            blob = kv.get(self._fold_ns(), user)
        except Exception:
            # A KV blip never fails the request: the solve still answers.
            logging.getLogger(__name__).debug("shared fold-in get failed",
                                              exc_info=True)
            return None
        decoded = _fold_decode(blob) if blob else None
        if decoded is None:
            return None
        vec, solved_at = decoded
        if vec.shape[0] != self.model.item_factors.shape[-1]:
            return None
        max_age = _fold_shared_max_age_s()
        if max_age > 0 and solved_at is not None \
                and time.time() - solved_at > max_age:
            return None  # a stale solve: miss, and re-solve
        return vec

    def _fold_shared_put(self, user: str, vec: np.ndarray,
                         watermark_us: Optional[int]) -> None:
        """Best-effort write-through; every 256th put prunes the
        namespace to ``PIO_FOLD_IN_SHARED_CAP`` entries."""
        kv = self._shared_kv
        if kv is None or not _fold_shared_enabled():
            return
        try:
            ns = self._fold_ns()
            kv.put(ns, user, _fold_encode(vec, watermark_us))
            self._fold_puts += 1
            if self._fold_puts % 256 == 0:
                kv.prune(ns, _env_int("PIO_FOLD_IN_SHARED_CAP", 100_000))
        except Exception:
            logging.getLogger(__name__).debug("shared fold-in put failed",
                                              exc_info=True)

    def _fold_store(self, user: str, vec: Optional[np.ndarray]) -> None:
        """Bounded-LRU insert; ``vec=None`` is the (TTL'd) negative
        entry for a user with no usable events."""
        with self._fold_lock:
            self._fold_cache[user] = (vec, time.monotonic())
            self._fold_cache.move_to_end(user)
            cap = _env_int("PIO_FOLD_IN_CACHE", 10000)
            while len(self._fold_cache) > max(cap, 1):
                self._fold_cache.popitem(last=False)


def wrapper_from_numpy(user_factors, item_factors, user_ids, item_ids, *,
                       rank: int, implicit: bool = False,
                       ivf: Union[IVFIndex, Mapping[str, Any], None] = None,
                       pq: Union[PQCodebook, Mapping[str, Any], None] = None
                       ) -> ALSModelWrapper:
    """Carry a trained ALS generation into the port: factor arrays plus
    the user and item id strings of their rows, in row order, and
    optionally its IVF index and PQ codebook — each an :class:`IVFIndex`
    / :class:`PQCodebook` or a mapping of the reference's fields (numpy
    arrays and plain values, e.g. ``dataclasses.asdict`` of the
    reference's structure)."""
    model = als_lib.als_model_from_numpy(user_factors, item_factors,
                                         rank=rank, implicit=implicit)
    user_index = BiMap({str(u): i for i, u in enumerate(user_ids)})
    item_index = BiMap({str(t): i for i, t in enumerate(item_ids)})
    if len(user_index) > model.user_factors.shape[0] \
            or len(item_index) > model.item_factors.shape[0]:
        raise ValueError("more ids than factor rows")
    if isinstance(ivf, Mapping):
        ivf = IVFIndex(**ivf)
    if isinstance(pq, Mapping):
        pq = PQCodebook(**pq)
    return ALSModelWrapper(model=model, user_index=user_index,
                           item_index=item_index, ivf=ivf, pq=pq)


def _warm_ridge_sweep(target: np.ndarray, frozen: np.ndarray,
                      row_ids: np.ndarray, col_ids: np.ndarray,
                      vals: np.ndarray, *, reg: float, alpha: float,
                      implicit: bool) -> None:
    """One half-sweep of ALS warm-start continuation: re-solve each
    delta-touched row of ``target`` against the frozen complement — the
    same normal equation as :func:`models.als.fold_in`, but anchored at
    the row's carried factor (``λn·u_prev`` on the right-hand side) so
    one new event updates a trained row instead of wiping it.  Host
    float64, row by row, as the reference does."""
    order = np.argsort(row_ids, kind="stable")
    rs = row_ids[order]
    cs = col_ids[order]
    vs = vals[order]
    starts = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
    f64 = frozen.astype(np.float64)
    k = f64.shape[1]
    yty = f64.T @ f64 if implicit else None
    bounds = list(starts) + [len(rs)]
    eye = np.eye(k)
    for a, b in zip(bounds[:-1], bounds[1:]):
        row = int(rs[a])
        y = f64[cs[a:b]]
        r = vs[a:b]
        if implicit:
            w = alpha * np.abs(r)
            c = (1.0 + w) * (r > 0)
            mat = yty + (y * w[:, None]).T @ y
            rhs = y.T @ c
        else:
            mat = y.T @ y
            rhs = y.T @ r
        lam = reg * (b - a)
        mat = mat + lam * eye
        rhs = rhs + lam * target[row].astype(np.float64)
        try:
            sol = np.linalg.solve(mat, rhs)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(mat, rhs, rcond=None)[0]
        target[row] = sol.astype(np.float32)


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams

    def train(self, ctx: RuntimeContext,
              prepared_data: Ratings) -> ALSModelWrapper:
        """Train on ``ctx.device``, then build the IVF index and PQ codes
        the env policy asks for (reference: ``ALSAlgorithm.train``); the
        quality and recall scorecards are not ported yet."""
        p: ALSAlgorithmParams = self.params
        if len(prepared_data.user_ids) == 0:
            raise ValueError(
                "No rating events found — check appName/eventNames "
                "(reference template raises the same assertion).")
        n_items = len(prepared_data.item_index)
        cfg = als_lib.ALSConfig(
            rank=p.rank,
            iterations=p.numIterations,
            reg=p.lambda_,
            alpha=p.alpha,
            implicit=p.implicitPrefs,
            max_degree=p.maxDegree,
            seed=p.seed if p.seed is not None else ctx.seed,
            factor_sharding=p.factorSharding,
            gather_window=p.gatherWindow,
        )
        model = als_lib.train_als(
            prepared_data.user_ids,
            prepared_data.item_ids,
            prepared_data.ratings,
            n_users=len(prepared_data.user_index),
            n_items=n_items,
            config=cfg,
            device=ctx.device,
        )
        itf_host = model.item_factors[:n_items]
        # Train-time coarse index, pickled with the model.  Raw ALS
        # factors carry popularity-scaled norms (a poor IVF fit: cells
        # partition by direction), so it builds only under an explicit
        # PIO_IVF=on, never auto.
        ivf = build_train_index(itf_host, name="als", seed=cfg.seed,
                                require_explicit=True)
        # Residual PQ codes under the PIO_PQ policy (auto by default):
        # the exact re-rank makes quantization safe for norm-variant
        # factors, so no explicit opt-in is required.
        pq = build_train_pq(itf_host, name="als", ivf=ivf, seed=cfg.seed)
        wrapper = ALSModelWrapper(
            model=model,
            user_index=prepared_data.user_index,
            item_index=prepared_data.item_index,
            ivf=ivf,
            pq=pq,
            app_name=prepared_data.app_name,
            fold_event_names=tuple(prepared_data.event_names or ()),
            buy_rating=float(prepared_data.buy_rating),
            reg=float(p.lambda_),
            alpha=float(p.alpha),
            n_examples=len(prepared_data.ratings),
        )
        # A generation predicts where it trained until a server's
        # post_load moves it (pio eval predicts with it directly).
        wrapper._device = ctx.device
        return wrapper

    def warm_start(self, ctx: RuntimeContext, prepared_delta: Ratings,
                   prev_model: ALSModelWrapper,
                   warm: Any) -> ALSModelWrapper:
        """Delta warm start — the refresh rung of ALS (reference:
        ``ALSAlgorithm.warm_start``).

        The previous generation's factors carry over, delta-new entities
        get fresh normal/√rank rows, and ``numIterations // 5`` (at
        least one) host ridge half-sweeps re-solve ONLY the
        delta-touched rows against the frozen complement, anchored at
        their carried values (:func:`_warm_ridge_sweep`, host float64 as
        in the reference — not K1 and K2).  The random numbers are drawn
        in the reference's order (fresh user rows, fresh item rows, then
        the eval sample), so from the same previous factors the warm
        factors are the reference's bit for bit.  Gates: config
        compatibility, the delta-fraction gate, and an eval-regression
        check (RMSE on a delta sample restricted to pairs the previous
        generation knew).  Any doubt raises :class:`WarmStartFallback` →
        full retrain.  IVF and PQ are rebuilt from the new factors as
        :meth:`train` builds them; the quality and recall scorecards are
        not ported.  The returned wrapper predicts on ``ctx.device``.
        """
        log = logging.getLogger(__name__)
        p: ALSAlgorithmParams = self.params
        prev_n = int(getattr(prev_model, "n_examples", 0))
        delta_n = int(len(prepared_delta.ratings))
        if (prev_model.model.rank != p.rank
                or prev_model.model.implicit != p.implicitPrefs
                or float(getattr(prev_model, "reg", p.lambda_))
                != float(p.lambda_)
                or float(getattr(prev_model, "alpha", p.alpha))
                != float(p.alpha)):
            raise WarmStartFallback("algorithm config changed")
        max_frac = getattr(warm, "max_delta_fraction", 0.5)
        if prev_n <= 0 or delta_n > max_frac * prev_n:
            raise WarmStartFallback(
                f"delta window too large for continuation ({delta_n} "
                f"events vs {prev_n} trained; max fraction {max_frac:g})")
        if delta_n == 0:
            # Nothing new: carry the generation forward.  A FRESH wrapper
            # (replace() re-runs __post_init__) because wrapper identity
            # is the serving generation — caches must not be shared.
            fresh = dataclasses.replace(prev_model)
            fresh._device = ctx.device
            return fresh
        seed_now = p.seed if p.seed is not None else ctx.seed
        k = int(p.rank)
        uf_prev, itf_prev = prev_model.host_factors()
        # Union-extend the id spaces: previous entities keep their rows,
        # delta-new entities append contiguous fresh indices.
        u_map: Dict[str, int] = dict(prev_model.user_index.items())
        i_map: Dict[str, int] = dict(prev_model.item_index.items())
        for key in prepared_delta.user_index.to_numpy_keys():
            u_map.setdefault(str(key), len(u_map))
        for key in prepared_delta.item_index.to_numpy_keys():
            i_map.setdefault(str(key), len(i_map))
        user_index = BiMap(u_map)
        item_index = BiMap(i_map)
        rng = np.random.default_rng(seed_now if seed_now is not None else 0)
        scale = np.float32(np.sqrt(k))

        def _extend(prev: np.ndarray, n_total: int) -> np.ndarray:
            out = np.array(prev, np.float32, copy=True)
            if n_total <= out.shape[0]:
                return out
            fresh_rows = rng.standard_normal(
                (n_total - out.shape[0], k)).astype(np.float32) / scale
            return np.concatenate([out, fresh_rows], axis=0)

        uf = _extend(uf_prev, len(user_index))
        itf = _extend(itf_prev, len(item_index))
        # Remap delta triplets from the delta read's local indices to the
        # union index space.
        u_lut = np.asarray(
            [u_map[str(kk)]
             for kk in prepared_delta.user_index.to_numpy_keys()], np.int64)
        i_lut = np.asarray(
            [i_map[str(kk)]
             for kk in prepared_delta.item_index.to_numpy_keys()], np.int64)
        rows_u = u_lut[np.asarray(prepared_delta.user_ids, np.int64)]
        rows_i = i_lut[np.asarray(prepared_delta.item_ids, np.int64)]
        vals = np.asarray(prepared_delta.ratings, np.float64)
        # Eval sample: pairs the PREVIOUS generation could already score.
        # All-new-entity deltas have no comparable pairs — the fraction
        # gate above already bounds how much unchecked change they carry.
        known = np.flatnonzero(
            (rows_u < len(prev_model.user_index))
            & (rows_i < len(prev_model.item_index)))
        su = si = sv = None
        if known.size:
            sel = rng.choice(known, size=min(known.size, 1024),
                             replace=False)
            su, si = rows_u[sel], rows_i[sel]
            sv = ((vals[sel] > 0).astype(np.float64)
                  if p.implicitPrefs else vals[sel])

        def _sample_rmse() -> float:
            pred = np.einsum("ij,ij->i", uf[su].astype(np.float64),
                             itf[si].astype(np.float64))
            return float(np.sqrt(np.mean((pred - sv) ** 2)))

        rmse_before = _sample_rmse() if known.size else None
        sweeps = max(1, int(p.numIterations) // 5)
        for _ in range(sweeps):
            _warm_ridge_sweep(uf, itf, rows_u, rows_i, vals,
                              reg=float(p.lambda_), alpha=float(p.alpha),
                              implicit=bool(p.implicitPrefs))
            _warm_ridge_sweep(itf, uf, rows_i, rows_u, vals,
                              reg=float(p.lambda_), alpha=float(p.alpha),
                              implicit=bool(p.implicitPrefs))
        tol = getattr(warm, "eval_tolerance", 0.1)
        if known.size:
            rmse_after = _sample_rmse()
            if not np.isfinite(rmse_after) \
                    or rmse_after > rmse_before * (1.0 + tol) + 1e-9:
                raise WarmStartFallback(
                    f"warm-started eval regressed on the delta sample "
                    f"(rmse {rmse_before:.4f} → {rmse_after:.4f}, "
                    f"tolerance {tol:g})")
            log.info("als warm-start: +%d events (%d sweeps), "
                     "delta-sample rmse %.4f → %.4f", delta_n, sweeps,
                     rmse_before, rmse_after)
        else:
            log.info("als warm-start: +%d events (%d sweeps), all-new "
                     "entities — no comparable eval pairs", delta_n, sweeps)
        model = als_lib.ALSModel(user_factors=uf, item_factors=itf,
                                 rank=k, implicit=bool(p.implicitPrefs))
        # Retrieval structures are derived from THIS generation's
        # factors — rebuilt exactly as train() builds them; carrying the
        # parent's would mis-route the rows just moved.
        ivf = build_train_index(itf, name="als", seed=seed_now,
                                require_explicit=True)
        pq = build_train_pq(itf, name="als", ivf=ivf, seed=seed_now)
        wrapper = ALSModelWrapper(
            model=model,
            user_index=user_index,
            item_index=item_index,
            ivf=ivf,
            pq=pq,
            app_name=getattr(prepared_delta, "app_name", None)
            or getattr(prev_model, "app_name", None),
            fold_event_names=tuple(
                getattr(prepared_delta, "event_names", ()) or ())
            or tuple(getattr(prev_model, "fold_event_names", ()) or ()),
            buy_rating=float(getattr(prepared_delta, "buy_rating", 4.0)),
            reg=float(p.lambda_),
            alpha=float(p.alpha),
            n_examples=prev_n + delta_n,
        )
        wrapper._device = ctx.device
        return wrapper

    def predict(self, model: ALSModelWrapper, query: Query) -> PredictedResult:
        # One query = a batch of one: the same facade routing applies.
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: ALSModelWrapper, queries):
        """Vectorized serving path — ONE retrieval-facade call for the
        whole cohort; all routing lives in the retrieval facade, this
        template only maps ids.  Unseen users try fold-in first: a
        folded factor rides the same retrieval call as the trained
        users' rows; users with no usable events get the cold-start
        empty result."""
        known = [(i, q) for i, q in queries if q.user in model.user_index]
        rows: List[np.ndarray] = []
        cold: List[Tuple[int, Query]] = []
        folded: List[Tuple[int, Query]] = []
        for i, q in queries:
            if q.user in model.user_index:
                continue
            vec = model.fold_in_user(q.user)
            if vec is None:
                cold.append((i, q))
            else:
                folded.append((i, q))
                rows.append(vec)
        out = [(i, PredictedResult(itemScores=[])) for i, q in cold]
        answerable = known + folded
        if answerable:
            num = max(q.num for _, q in answerable)
            uf = model.host_user_factors()
            qmat_parts = []
            if known:
                idxs = np.asarray([model.user_index[q.user]
                                   for _, q in known])
                qmat_parts.append(uf[idxs])
            if rows:
                qmat_parts.append(np.stack(rows))
            qmat = np.concatenate(qmat_parts, axis=0) \
                if len(qmat_parts) > 1 else qmat_parts[0]
            scores, ids, _info = model.retriever().topk(qmat, num)
            inv = model.item_index.inverse
            for row, (i, q) in enumerate(answerable):
                out.append((i, PredictedResult(itemScores=[
                    ItemScore(item=inv[ii], score=ss)
                    for ii, ss in iter_hits(scores[row], ids[row], q.num)
                ])))
        return out


def engine() -> Engine:
    """Reference: RecommendationEngine EngineFactory."""
    return Engine(
        datasource_class=RecommendationDataSource,
        preparator_class=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_class=FirstServing,
        query_class=Query,
    )
