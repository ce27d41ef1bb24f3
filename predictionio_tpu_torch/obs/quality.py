"""Model-quality observability.

Port of ``predictionio_tpu/obs/quality.py``.  The waterfall and the SLO
engine give the server eyes for *how fast* it serves; this module gives
it eyes for *what* it serves.  The system continuously
retrains and promotes generations behind a canary gate that checks NaN,
golden queries, and latency/availability SLO burn — but never prediction
quality: a warm-start that quietly collapses score diversity or drifts
the score distribution sails through every existing gate.  Four parts,
one `/quality.json` document:

- **Prediction record stream** — a per-request sampling decision
  (``PIO_QUALITY_SAMPLE``, ONE RNG draw shared with the
  ``PIO_REQUEST_LOG`` wide-event sampler) feeds a per-generation score
  reservoir + a recent-window deque at the scheduler's dispatch
  boundary.  Exported: ``pio_predict_score`` (served score
  distribution), candidate-diversity / top-item-concentration gauges,
  empty-result and fold-in-share readings.
- **Drift detection** — PSI/KL between the served score distribution
  and a training-time baseline :class:`Scorecard` serialized INSIDE the
  model wrapper (riding the IVF index's versioned-with-generation +
  fingerprint pattern): the staged-reload/rollback swap moves scorecard
  and model atomically, and a mismatched/missing scorecard degrades
  LOUDLY to reporting-only — it never blocks serving.  Tripping needs
  the PSI over threshold on BOTH the fast (recent deque) and slow
  (generation reservoir) windows; hysteresis is asymmetric exactly like
  the SLO engine's (trip instantly, clear after a
  ``PIO_QUALITY_RECOVERY_S`` trip-false dwell).
- **Shadow-scored canary divergence** — during the canary window the
  RETAINED previous generation re-scores a sampled slice of live
  queries off-thread (bounded queue, drop-on-full: shadow work may
  never add serving latency), and rank-overlap@k / relative
  score-delta percentiles between old and new become a promotion gate
  the refresh daemon's ``HttpPromoter`` acts on exactly as it does on
  SLO burn.
- **Feedback join** — sampled responses carry an ``X-PIO-Serve-Id``
  whose events-echo (``properties.pioServeId`` on a subsequent
  buy/rate) the event server joins back to the served item set within a
  TTL window → online hit-rate per generation.

Cold-app pass-through is a hard rule: with fewer than
``PIO_QUALITY_MIN_SAMPLES`` sampled predictions (or shadow pairs) the
verdict is ``insufficient`` and the gate NEVER fires — a cold app must
pass through, not be blocked by its own silence.

Env knobs (all read by :meth:`QualityConfig.from_env`):

====================================  ==================================
``PIO_QUALITY``                       master kill switch (default on;
                                      off disables every hook)
``PIO_QUALITY_SAMPLE``                per-request prediction-stream
                                      sampling rate (default 0.1)
``PIO_QUALITY_RESERVOIR``             generation score reservoir = the
                                      slow drift window (4096)
``PIO_QUALITY_FAST_WINDOW``           recent-sample deque = the fast
                                      drift window (512)
``PIO_QUALITY_MIN_SAMPLES``           cold-app pass-through floor (100)
``PIO_QUALITY_PSI_THRESHOLD``         PSI trip point, both windows
                                      (0.25 — the classic "significant
                                      shift" convention)
``PIO_QUALITY_RECOVERY_S``            trip-false dwell before the drift
                                      verdict clears (60)
``PIO_QUALITY_GATE``                  quality verdicts may roll back a
                                      promotion (default on; off =
                                      report-only)
``PIO_SHADOW_SAMPLE``                 shadow-scored slice of live
                                      queries in the canary window
                                      (0.25)
``PIO_SHADOW_MIN_OVERLAP``            mean rank-overlap@k below this =
                                      divergent (0.5)
``PIO_SHADOW_QUEUE``                  bounded shadow queue; overflow
                                      drops, never blocks (256)
``PIO_QUALITY_FEEDBACK_TTL_S``        serve→feedback join window (1800)
``PIO_QUALITY_FEEDBACK_EVENTS``       event names that count as
                                      feedback (csv; "buy,rate")
====================================  ==================================

stdlib-only on import (the event server and CLI ride it numpy-free);
:func:`scorecard_from_matrix` imports numpy lazily at train time.
"""

from __future__ import annotations

import bisect
import dataclasses
import logging
import math
import os
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.obs.metrics import get_registry

logger = logging.getLogger(__name__)

__all__ = [
    "QualityConfig",
    "Scorecard",
    "scorecard_from_scores",
    "scorecard_from_matrix",
    "scorecard_from_mapping",
    "psi",
    "kl_divergence",
    "DriftDetector",
    "ShadowScorer",
    "FeedbackJoiner",
    "QualityMonitor",
    "extract_result_items",
    "resolve_scorecard",
    "merge_quality",
    "feedback_joiner",
    "note_feedback_events",
    "generation_of_serve_id",
    "reset_quality",
    "SERVE_ID_HEADER",
    "SERVE_ID_PROPERTY",
]

SERVE_ID_HEADER = "X-PIO-Serve-Id"
SERVE_ID_PROPERTY = "pioServeId"

# Served-score distribution buckets: affinity/similarity scores from the
# shipped engines live in single digits (normalized tower dot products,
# ALS rating reconstructions); wide tails catch mis-scaled generations.
SCORE_BUCKETS = (-100.0, -10.0, -5.0, -2.0, -1.0, -0.5, -0.2, 0.0,
                 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 100.0)
# Relative score-delta buckets for shadow scoring (|new-old| / |old|).
SHADOW_DELTA_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5)

_EPS = 1e-6


def _env_f(env, key: str, default: float) -> float:
    raw = env.get(key)
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass
class QualityConfig:
    """Quality-layer knobs; :meth:`from_env` is the production
    constructor (same pattern as SchedulerConfig/SLOConfig)."""

    enabled: bool = True
    sample: float = 0.1
    reservoir: int = 4096
    fast_window: int = 512
    min_samples: int = 100
    psi_threshold: float = 0.25
    recovery_s: float = 60.0
    gate: bool = True
    shadow_sample: float = 0.25
    shadow_min_overlap: float = 0.5
    shadow_queue: int = 256
    feedback_ttl_s: float = 1800.0
    feedback_events: Tuple[str, ...] = ("buy", "rate")

    @classmethod
    def from_env(cls, env=None) -> "QualityConfig":
        env = os.environ if env is None else env
        raw_events = env.get("PIO_QUALITY_FEEDBACK_EVENTS", "")
        events = tuple(e.strip() for e in raw_events.split(",")
                       if e.strip()) or ("buy", "rate")
        return cls(
            enabled=env_bool(env.get("PIO_QUALITY"), True),
            sample=min(max(_env_f(env, "PIO_QUALITY_SAMPLE", 0.1), 0.0),
                       1.0),
            reservoir=int(_env_f(env, "PIO_QUALITY_RESERVOIR", 4096)),
            fast_window=int(_env_f(env, "PIO_QUALITY_FAST_WINDOW", 512)),
            min_samples=int(_env_f(env, "PIO_QUALITY_MIN_SAMPLES", 100)),
            psi_threshold=_env_f(env, "PIO_QUALITY_PSI_THRESHOLD", 0.25),
            recovery_s=_env_f(env, "PIO_QUALITY_RECOVERY_S", 60.0),
            gate=env_bool(env.get("PIO_QUALITY_GATE"), True),
            shadow_sample=min(max(
                _env_f(env, "PIO_SHADOW_SAMPLE", 0.25), 0.0), 1.0),
            shadow_min_overlap=_env_f(env, "PIO_SHADOW_MIN_OVERLAP", 0.5),
            shadow_queue=int(_env_f(env, "PIO_SHADOW_QUEUE", 256)),
            feedback_ttl_s=_env_f(env, "PIO_QUALITY_FEEDBACK_TTL_S",
                                  1800.0),
            feedback_events=events,
        )


# ==========================================================================
# Scorecard: the training-time baseline that rides the model wrapper
# ==========================================================================

@dataclasses.dataclass
class Scorecard:
    """Training-time score-distribution baseline.

    Serialized INSIDE the model wrapper (next to the IVF index), so
    the staged-reload/rollback generation swap moves scorecard and model
    as ONE artifact — serving can never diff generation-N scores against
    a generation-M baseline.  ``fingerprint`` is the IVF index's corpus
    fingerprint of the vectors the baseline was scored over; a wrapper
    whose corpus no longer matches degrades the drift detector to
    reporting-only (loud, never blocking).
    """

    edges: Tuple[float, ...]     # interior bin edges (B bins = B-1 edges)
    probs: Tuple[float, ...]     # baseline probability mass per bin
    n: int                       # baseline sample size
    mean: float
    std: float
    fingerprint: Optional[str] = None
    built_at: float = 0.0
    name: str = ""

    def bin_index(self, value: float) -> int:
        return bisect.bisect_right(self.edges, value)

    def summary(self) -> Dict[str, Any]:
        return {"present": True, "bins": len(self.probs), "n": self.n,
                "mean": round(self.mean, 4), "std": round(self.std, 4),
                "builtAt": round(self.built_at, 3), "name": self.name,
                "fingerprint": self.fingerprint}


def scorecard_from_scores(scores: Sequence[float], *, bins: int = 16,
                          fingerprint: Optional[str] = None,
                          name: str = "") -> Optional[Scorecard]:
    """Build a baseline from a flat score sample (quantile bin edges, so
    every baseline bin carries mass and PSI is well-conditioned).
    Returns None when the sample is degenerate (<2 distinct values) —
    callers ship no scorecard rather than a meaningless one."""
    vals = sorted(float(s) for s in scores
                  if s == s and math.isfinite(float(s)))
    if len(vals) < 2 or vals[0] == vals[-1]:
        return None
    edges: List[float] = []
    for i in range(1, max(bins, 2)):
        pos = min(int(len(vals) * i / bins), len(vals) - 1)
        v = vals[pos]
        # Edge at the MIDPOINT to the next distinct value, never on an
        # observed score: serving recomputes the same scores through a
        # different op order (retriever rungs, device matmuls), and a
        # baseline value sitting exactly on its own edge would flip bins
        # on a 1-ulp difference — fake drift on a healthy server.
        nxt = next((w for w in vals[pos:] if w > v), None)
        if nxt is None:
            continue
        e = (v + nxt) / 2.0
        if not edges or e > edges[-1]:
            edges.append(e)
    counts = [0] * (len(edges) + 1)
    for v in vals:
        counts[bisect.bisect_right(edges, v)] += 1
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / n
    return Scorecard(edges=tuple(edges),
                     probs=tuple(c / n for c in counts),
                     n=n, mean=mean, std=math.sqrt(var),
                     fingerprint=fingerprint,
                     built_at=time.time(), name=name)


def scorecard_from_matrix(query_vecs, item_vecs, *, sample: int = 256,
                          seed: int = 0, bins: int = 16,
                          name: str = "") -> Optional[Scorecard]:
    """Train-time helper: the baseline is the RANK-1 (top) score of a
    seeded sample of query rows against the item corpus.

    Rank-1 — not top-K — because it is the one population invariant to
    the client's ``num``: serving results carry however many scores the
    query asked for, and a top-3 request's score set sits structurally
    above a top-10 one's, which would read as drift on a perfectly
    healthy server.  The serving detector feeds the same statistic (the
    max served score per sampled request).  Numpy imported lazily: this
    only runs inside ``pio train``."""
    import numpy as np

    q = np.asarray(query_vecs)
    it = np.asarray(item_vecs)
    if q.ndim != 2 or it.ndim != 2 or not len(q) or not len(it):
        return None
    rng = np.random.default_rng(seed)
    n_sample = min(len(q), max(int(sample), 1))
    idx = rng.choice(len(q), size=n_sample, replace=False)
    qs = q[idx]
    # Running max over item chunks: a single [sample, N] matmul is a
    # ~GB-scale transient at the million-item corpora the retrieval
    # layer targets — chunking keeps the peak at a few MB, identical
    # output.
    chunk = 65536
    top1 = np.full(n_sample, -np.inf, dtype=np.float64)
    for start in range(0, it.shape[0], chunk):
        block = qs @ it[start:start + chunk].T
        np.maximum(top1, block.max(axis=1), out=top1)
    from predictionio_tpu_torch.retrieval.ivf import corpus_fingerprint

    return scorecard_from_scores(
        top1.tolist(), bins=bins,
        fingerprint=corpus_fingerprint(np.ascontiguousarray(it)),
        name=name)


def scorecard_from_mapping(sc: Any) -> Optional[Scorecard]:
    """A :class:`Scorecard` from the reference's fields
    (``dataclasses.asdict`` of its scorecard: how a generation trained by
    the reference is carried into the port); a scorecard or None passes
    through."""
    if sc is None or isinstance(sc, Scorecard):
        return sc
    d = dict(sc)
    d["edges"] = tuple(float(e) for e in d["edges"])
    d["probs"] = tuple(float(p) for p in d["probs"])
    return Scorecard(**d)


def psi(expected: Sequence[float], actual: Sequence[float],
        eps: float = _EPS) -> float:
    """Population stability index over matched bins:
    ``Σ (a−e)·ln(a/e)``, with epsilon smoothing so an empty bin on
    either side stays finite.  Symmetric in direction of shift; ~0.1 =
    moderate, ≥0.25 = significant (the conventional trip point).

    ``eps`` matters: with a tiny fixed epsilon, one EMPTY bin in a
    small sample contributes ``(1/B)·ln(1/(B·eps))`` ≈ 0.7 of pure
    noise.  The drift detector passes a count-based floor (≈ half a
    sample's mass, ``0.5/n``) so small windows read sampling noise, not
    phantom drift."""
    out = 0.0
    for e, a in zip(expected, actual):
        e = max(float(e), eps)
        a = max(float(a), eps)
        out += (a - e) * math.log(a / e)
    return out


def kl_divergence(expected: Sequence[float], actual: Sequence[float],
                  eps: float = _EPS) -> float:
    """KL(actual ‖ expected) over matched bins, epsilon-smoothed (same
    count-based ``eps`` discipline as :func:`psi`)."""
    out = 0.0
    for e, a in zip(expected, actual):
        e = max(float(e), eps)
        a = max(float(a), eps)
        out += a * math.log(a / e)
    return out


# ==========================================================================
# Drift detection
# ==========================================================================

class DriftDetector:
    """PSI/KL of the served score distribution vs the generation's
    scorecard, over a fast (recent deque) and a slow (generation
    reservoir) window, with SLO-style asymmetric hysteresis.

    Scores are binned ONCE on ingest (``add`` stores bin indices and
    maintains both windows' counts incrementally — O(1) per sample,
    O(bins) per tick).  The reservoir is Algorithm-R: an unbiased
    generation-wide sample in bounded memory.  All methods are
    thread-safe; ``clock`` is injectable (tests drive hours of dwell in
    microseconds, zero wall sleeps)."""

    MIN_TICK_INTERVAL_S = 1.0

    def __init__(self, config: QualityConfig,
                 baseline: Optional[Scorecard] = None, *,
                 reporting_reason: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.config = config
        self.baseline = baseline
        self.reporting_reason = (
            reporting_reason if baseline is None or reporting_reason
            else None)
        self._clock = clock
        self._rng = rng or random.Random(0)
        self._lock = threading.Lock()
        n_bins = len(baseline.probs) if baseline else 0
        self._fast: deque = deque()          # bin indices, newest right
        self._fast_counts = [0] * n_bins
        self._res: List[int] = []            # reservoir of bin indices
        self._res_counts = [0] * n_bins
        self._seen = 0                       # total samples offered
        self._tripped = False
        self._tripped_since: Optional[float] = None
        self._clear_since: Optional[float] = None
        self._last_tick: Optional[float] = None
        self._last: Dict[str, Any] = {}

    def add(self, score: float) -> None:
        if self.baseline is None:
            with self._lock:
                self._seen += 1
            return
        b = self.baseline.bin_index(score)
        cfg = self.config
        with self._lock:
            self._seen += 1
            self._fast.append(b)
            self._fast_counts[b] += 1
            if len(self._fast) > max(cfg.fast_window, 1):
                self._fast_counts[self._fast.popleft()] -= 1
            if len(self._res) < max(cfg.reservoir, 1):
                self._res.append(b)
                self._res_counts[b] += 1
            else:
                j = self._rng.randrange(self._seen)
                if j < len(self._res):
                    self._res_counts[self._res[j]] -= 1
                    self._res[j] = b
                    self._res_counts[b] += 1

    @staticmethod
    def _probs(counts: List[int]) -> Tuple[List[float], int]:
        n = sum(counts)
        if n == 0:
            return [0.0] * len(counts), 0
        return [c / n for c in counts], n

    def tick(self, force: bool = False) -> Dict[str, Any]:
        """Recompute drift + the hysteresis verdict (pull-driven, tick
        coalescing like the SLO engine — a 1 Hz /quality.json poll costs
        one real recompute per second)."""
        now = self._clock()
        with self._lock:
            if (not force and self._last_tick is not None
                    and now - self._last_tick < self.MIN_TICK_INTERVAL_S
                    and self._last):
                return dict(self._last)
            self._last_tick = now
            seen = self._seen
            if self.baseline is None:
                state = {"reportingOnly": True,
                         "reason": self.reporting_reason or "no_scorecard",
                         "tripped": False, "samples": seen,
                         "psi": {"fast": None, "slow": None},
                         "kl": {"fast": None, "slow": None},
                         "nFast": 0, "nSlow": 0,
                         "threshold": self.config.psi_threshold,
                         "minSamples": self.config.min_samples}
                self._last = state
                return dict(state)
            base = self.baseline.probs
            fast_p, n_fast = self._probs(self._fast_counts)
            slow_p, n_slow = self._probs(self._res_counts)
            # Count-based smoothing floor (≈ half a sample's mass): a
            # bin a small window happens not to have hit yet must read
            # as sampling noise, not as ~0.7 PSI of phantom drift.
            ef = max(_EPS, 0.5 / n_fast) if n_fast else _EPS
            es = max(_EPS, 0.5 / n_slow) if n_slow else _EPS
            psi_fast = psi(base, fast_p, eps=ef) if n_fast else 0.0
            psi_slow = psi(base, slow_p, eps=es) if n_slow else 0.0
            kl_fast = kl_divergence(base, fast_p, eps=ef) if n_fast \
                else 0.0
            kl_slow = kl_divergence(base, slow_p, eps=es) if n_slow \
                else 0.0
            thr = self.config.psi_threshold
            enough = (n_fast >= self.config.min_samples
                      and n_slow >= self.config.min_samples)
            # Trip needs BOTH windows over threshold (the fast window
            # proves it's still happening, the slow one that the whole
            # generation's serving stream shifted, not one burst).
            trip = enough and psi_fast >= thr and psi_slow >= thr
            if trip:
                if not self._tripped:
                    self._tripped = True
                    self._tripped_since = now
                self._clear_since = None
            elif self._tripped:
                if self._clear_since is None:
                    self._clear_since = now
                elif now - self._clear_since >= self.config.recovery_s:
                    self._tripped = False
                    self._tripped_since = None
                    self._clear_since = None
            state = {
                "reportingOnly": bool(self.reporting_reason),
                "reason": self.reporting_reason,
                "tripped": self._tripped,
                "trippedSinceS": (round(now - self._tripped_since, 1)
                                  if self._tripped_since is not None
                                  else None),
                "recoveringForS": (round(now - self._clear_since, 1)
                                   if self._clear_since is not None
                                   else None),
                "insufficient": not enough,
                "samples": seen,
                "psi": {"fast": round(psi_fast, 4),
                        "slow": round(psi_slow, 4)},
                "kl": {"fast": round(kl_fast, 4),
                       "slow": round(kl_slow, 4)},
                "nFast": n_fast, "nSlow": n_slow,
                "threshold": thr,
                "minSamples": self.config.min_samples,
            }
            self._last = state
            return dict(state)


# ==========================================================================
# Shadow-scored canary divergence
# ==========================================================================

class ShadowScorer:
    """Re-scores a sampled slice of live queries with the RETAINED
    previous generation during the canary window, off-thread.

    The serving hot path only ever enqueues (bounded deque; overflow
    drops and counts — shadow work must never add serving latency or
    block a dispatch).  The worker compares old vs new top-K:
    rank-overlap@k and relative score deltas on shared items.  A session
    is armed per promotion (:meth:`start`) and torn down on rollback /
    previous-generation eviction, dropping the strong reference to the
    old generation's closure so its memory can actually be freed."""

    def __init__(self, config: QualityConfig, registry=None):
        self.config = config
        reg = registry or get_registry()
        self._m_total = reg.counter(
            "pio_quality_shadow_total",
            "Shadow-scored canary pairs by outcome.", ("result",))
        self._m_overlap = reg.gauge(
            "pio_quality_shadow_overlap",
            "Mean rank-overlap@k between the serving generation and the "
            "shadow-scoring previous generation (1.0 = identical top-K).")
        self._m_delta = reg.histogram(
            "pio_quality_shadow_delta",
            "Relative score delta |new-old|/|old| on items both "
            "generations ranked.", (), buckets=SHADOW_DELTA_BUCKETS)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._fn: Optional[Callable[[Any], Any]] = None
        self._generation: Optional[int] = None
        self._prev_generation: Optional[int] = None
        self._overlaps: deque = deque(maxlen=512)
        self._scored = 0
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- session lifecycle --------------------------------------------------

    def start(self, generation: int, prev_generation: Optional[int],
              shadow_fn: Callable[[Any], Any]) -> None:
        """Arm a shadow session: ``shadow_fn(bound_query) -> result
        json`` runs the previous generation's predict stack."""
        with self._lock:
            self._fn = shadow_fn
            self._generation = generation
            self._prev_generation = prev_generation
            self._queue.clear()
            self._overlaps.clear()
            self._scored = 0
        self._ensure_thread()

    def stop(self, reason: str = "") -> None:
        """Disarm (rollback / eviction / shutdown): drops the previous
        generation's closure and the pending queue."""
        with self._lock:
            if self._fn is not None and reason:
                logger.info("shadow scoring stopped (%s)", reason)
            self._fn = None
            self._queue.clear()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._fn = None
            self._queue.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def active(self) -> bool:
        with self._lock:
            return self._fn is not None

    # -- the serving-side enqueue (hot path) --------------------------------

    def submit(self, query: Any, items: List[Tuple[Any, float]],
               generation: int) -> None:
        """Non-blocking: enqueue one (query, served top-K) pair for the
        worker; silently inert when no session is armed, drop-and-count
        when the bounded queue is full."""
        with self._cond:
            if self._fn is None or generation != self._generation:
                return
            if len(self._queue) >= max(self.config.shadow_queue, 1):
                self._m_total.inc(result="dropped")
                return
            self._queue.append((query, items))
            self._cond.notify()

    # -- the worker ---------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._loop, name="pio-shadow-scorer", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(timeout=1.0)
                if self._closed:
                    return
            try:
                self.drain_once()
            except Exception:
                logger.exception("shadow scorer worker error")

    def drain_once(self) -> int:
        """Score one queued pair (also the tests' synchronous entry
        point).  Returns the number of pairs processed (0/1)."""
        with self._lock:
            if not self._queue or self._fn is None:
                return 0
            query, new_items = self._queue.popleft()
            fn = self._fn
        try:
            old_result = fn(query)
        except Exception:
            logger.debug("shadow predict failed", exc_info=True)
            self._m_total.inc(result="error")
            return 1
        old_items = extract_result_items(old_result) or []
        self._observe_pair(new_items, old_items)
        return 1

    def _observe_pair(self, new_items: List[Tuple[Any, float]],
                      old_items: List[Tuple[Any, float]]) -> None:
        k = min(len(new_items), len(old_items))
        if k == 0:
            # Both empty = the generations agree; one-sided empty is
            # total divergence for this query.
            overlap = 1.0 if len(new_items) == len(old_items) else 0.0
        else:
            new_ids = [i for i, _ in new_items[:k]]
            old_map = {i: s for i, s in old_items}
            shared = [i for i in new_ids if i in old_map]
            overlap = len(shared) / k
            new_map = {i: s for i, s in new_items}
            for i in shared:
                denom = abs(old_map[i]) + _EPS
                self._m_delta.observe(abs(new_map[i] - old_map[i]) / denom)
        with self._lock:
            self._overlaps.append(overlap)
            self._scored += 1
            mean = sum(self._overlaps) / len(self._overlaps)
        self._m_total.inc(result="scored")
        self._m_overlap.set(mean)

    # -- verdict ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            overlaps = sorted(self._overlaps)
            scored = self._scored
            active = self._fn is not None
            gen, prev = self._generation, self._prev_generation

        def _pct(p):
            if not overlaps:
                return None
            return round(
                overlaps[min(int(p * len(overlaps)), len(overlaps) - 1)], 4)

        n = len(overlaps)
        mean = round(sum(overlaps) / n, 4) if n else None
        enough = scored >= self.config.min_samples
        divergent = (active and enough and mean is not None
                     and mean < self.config.shadow_min_overlap)
        return {
            "active": active,
            "generation": gen,
            "previousGeneration": prev,
            "scored": scored,
            "insufficient": not enough,
            "overlapMean": mean,
            "overlapP10": _pct(0.10),
            "overlapP50": _pct(0.50),
            "minOverlap": self.config.shadow_min_overlap,
            "divergent": divergent,
        }


# ==========================================================================
# Feedback join (event server side)
# ==========================================================================

def generation_of_serve_id(serve_id: str) -> Optional[int]:
    """Serve ids are ``g<generation>-<nonce>`` so a conversion can be
    attributed to a generation even when the serve record is gone
    (expired TTL or a different serving process)."""
    if not serve_id.startswith("g"):
        return None
    head = serve_id[1:].split("-", 1)[0]
    try:
        return int(head)
    except ValueError:
        return None


class FeedbackJoiner:
    """Joins served recommendations to subsequent feedback events.

    The engine server registers each sampled serve (:meth:`note_serve`:
    serve id → generation + served item set, TTL-bounded); the event
    server hands every landed feedback event that echoes a serve id to
    :meth:`feedback`.  A hit = the event's target item was in the served
    set within the TTL window → online hit-rate per generation.  All
    state is process-local and bounded: a cross-process deployment still
    counts per-generation attributed conversions (``unmatched``) via the
    id prefix, but item-level hit/miss needs the serve record (README
    documents the caveat)."""

    def __init__(self, ttl_s: float = 1800.0, *, max_records: int = 20000,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.ttl_s = float(ttl_s)
        self.max_records = int(max_records)
        self._clock = clock
        self._lock = threading.Lock()
        self._records: "OrderedDict[str, Tuple[int, frozenset, float]]" = \
            OrderedDict()
        # generation -> [hits, misses, attributed-but-untracked]
        self._per_gen: Dict[int, List[int]] = {}
        reg = registry or get_registry()
        self._m_feedback = reg.counter(
            "pio_quality_feedback_total",
            "Feedback events joined to served recommendations by outcome "
            "(hit/miss/expired/unmatched).", ("result",))
        self._m_hit_rate = reg.gauge(
            "pio_quality_online_hit_rate",
            "Online hit-rate of the newest generation with joined "
            "feedback (hits / (hits+misses)).")

    def note_serve(self, serve_id: str, generation: int,
                   items: Sequence[Any]) -> None:
        now = self._clock()
        with self._lock:
            self._records[serve_id] = (int(generation),
                                       frozenset(items), now)
            self._records.move_to_end(serve_id)
            self._evict(now)

    def _evict(self, now: float) -> None:
        # oldest-first: insertion order is time order
        while self._records:
            sid, (_, _, t) = next(iter(self._records.items()))
            if now - t > self.ttl_s or len(self._records) > self.max_records:
                del self._records[sid]
            else:
                break
        while len(self._records) > self.max_records:
            self._records.popitem(last=False)

    def feedback(self, serve_id: str, item: Optional[Any],
                 event_name: str = "") -> str:
        """Join one feedback event; returns the outcome recorded."""
        now = self._clock()
        with self._lock:
            rec = self._records.get(serve_id)
            if rec is None:
                gen = generation_of_serve_id(serve_id)
                result = "unmatched"
                if gen is not None:
                    self._per_gen.setdefault(gen, [0, 0, 0])[2] += 1
            else:
                gen, items, t = rec
                if now - t > self.ttl_s:
                    del self._records[serve_id]
                    result = "expired"
                else:
                    row = self._per_gen.setdefault(gen, [0, 0, 0])
                    if item is not None and item in items:
                        row[0] += 1
                        result = "hit"
                    else:
                        row[1] += 1
                        result = "miss"
            newest = max(self._per_gen) if self._per_gen else None
            rate = None
            if newest is not None:
                h, m, _ = self._per_gen[newest]
                rate = h / (h + m) if (h + m) else None
        self._m_feedback.inc(result=result)
        if rate is not None:
            self._m_hit_rate.set(rate)
        return result

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            gens = {
                str(g): {"hits": row[0], "misses": row[1],
                         "attributedOnly": row[2],
                         "hitRate": (round(row[0] / (row[0] + row[1]), 4)
                                     if row[0] + row[1] else None)}
                for g, row in sorted(self._per_gen.items())}
            tracked = len(self._records)
        return {"ttlS": self.ttl_s, "tracked": tracked,
                "generations": gens}


# Process-global joiner: the engine server notes serves, the event
# server joins feedback — in a single-process deployment (tests, the
# smoke run, `pio deploy` + eventserver threads) they meet here.
_joiner: Optional[FeedbackJoiner] = None
_joiner_lock = threading.Lock()


def feedback_joiner() -> FeedbackJoiner:
    global _joiner
    with _joiner_lock:
        if _joiner is None:
            cfg = QualityConfig.from_env()
            _joiner = FeedbackJoiner(ttl_s=cfg.feedback_ttl_s)
        return _joiner


def note_feedback_events(events) -> None:
    """Event-server ingest hook: join every LANDED event that echoes a
    serve id (``properties.pioServeId``) and whose name is a configured
    feedback event.  One env check when quality is off — the kill
    switch disables this hook like every other."""
    cfg = QualityConfig.from_env()
    if not cfg.enabled:
        return
    j = None
    for ev in events:
        name = getattr(ev, "event", None)
        if cfg.feedback_events and name not in cfg.feedback_events:
            continue
        props = getattr(ev, "properties", None)
        sid = props.get(SERVE_ID_PROPERTY) if props is not None else None
        if not sid:
            continue
        if j is None:
            j = feedback_joiner()
        j.feedback(str(sid), getattr(ev, "target_entity_id", None),
                   str(name))


def reset_quality() -> None:
    """Drop the process-global joiner (test isolation)."""
    global _joiner
    with _joiner_lock:
        _joiner = None


# ==========================================================================
# Result introspection + scorecard resolution
# ==========================================================================

def extract_result_items(result: Any) -> Optional[List[Tuple[Any, float]]]:
    """``[(item, score), ...]`` out of a served result JSON, or None for
    result shapes that carry no score distribution (quality stays inert
    for such engines).  Handles the recommendation-shaped
    ``{"itemScores": [{"item", "score"}]}`` contract every shipped
    retrieval template speaks, plus a bare numeric ``score`` field."""
    if not isinstance(result, dict):
        return None
    rows = result.get("itemScores")
    if isinstance(rows, list):
        out: List[Tuple[Any, float]] = []
        for r in rows:
            if isinstance(r, dict) and isinstance(
                    r.get("score"), (int, float)):
                out.append((r.get("item"), float(r["score"])))
        return out
    s = result.get("score")
    if isinstance(s, (int, float)):
        return [(None, float(s))]
    return None


def resolve_scorecard(models: Sequence[Any]
                      ) -> Tuple[Optional[Scorecard], Optional[str]]:
    """(scorecard, reporting_reason) for a loaded model set.

    Walks the wrappers for a serialized :class:`Scorecard`; when the
    carrying wrapper also exposes its host corpus (``item_vecs``), the
    scorecard's fingerprint is validated against it — the same tripwire
    the IVF index uses — and a mismatch degrades to reporting-only
    with an ERROR (never blocks serving)."""
    for m in models or ():
        sc = getattr(m, "quality", None)
        if not isinstance(sc, Scorecard):
            continue
        vecs = getattr(m, "item_vecs", None)
        if sc.fingerprint and vecs is not None:
            try:
                import numpy as np

                from predictionio_tpu_torch.retrieval.ivf import (
                    corpus_fingerprint,
                )

                if corpus_fingerprint(
                        np.ascontiguousarray(vecs)) != sc.fingerprint:
                    logger.error(
                        "quality scorecard fingerprint mismatch for %r — "
                        "drift detection degrades to reporting-only "
                        "(serving continues)", type(m).__name__)
                    return None, "fingerprint_mismatch"
            except Exception:
                logger.warning("scorecard fingerprint check failed",
                               exc_info=True)
        return sc, None
    return None, "no_scorecard"


# ==========================================================================
# The engine-server facade
# ==========================================================================

class QualityMonitor:
    """The engine server's quality layer: one instance per server.

    ``observe`` is the scheduler-dispatch-boundary hook (one sampled
    append per request); ``on_generation`` re-anchors the drift detector
    on every reload/rollback swap (the scorecard rides the model
    wrapper, so baseline and model swap atomically); ``payload`` is the
    ``/quality.json`` document, including the promotion-gate verdict the
    refresh daemon's ``HttpPromoter`` polls.  With ``PIO_QUALITY=off``
    every method is an inert no-op and no instruments register."""

    def __init__(self, config: Optional[QualityConfig] = None, *,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.config = config or QualityConfig.from_env()
        self.enabled = self.config.enabled
        self._clock = clock
        self._rng = rng or random.Random()
        if not self.enabled:
            return
        reg = registry or get_registry()
        self._registry = reg
        self._lock = threading.Lock()
        self._generation = 0
        self._detector = DriftDetector(self.config, None, clock=clock)
        self.shadow = ShadowScorer(self.config, registry=reg)
        self.joiner = feedback_joiner()
        # diversity window: per-sampled-request served item lists with
        # incremental distinct/top-item counts (O(k) per sample).
        self._div_window: deque = deque()
        self._div_counts: Dict[Any, int] = {}
        self._div_slots = 0
        self._h_score = reg.histogram(
            "pio_predict_score",
            "Served top-K prediction scores (sampled; the serving side "
            "of the drift comparison).", (), buckets=SCORE_BUCKETS)
        self._m_sampled = reg.counter(
            "pio_quality_sampled_total",
            "Requests sampled into the prediction record stream.")
        self._m_empty = reg.counter(
            "pio_quality_empty_total",
            "Sampled requests whose result carried zero items.")
        self._g_drift = reg.gauge(
            "pio_quality_drift",
            "Score-distribution drift vs the training-time scorecard.",
            ("metric", "window"))
        self._g_tripped = reg.gauge(
            "pio_quality_drift_tripped",
            "1 while drift is over threshold on both windows "
            "(hysteresis-latched).")
        self._g_reporting = reg.gauge(
            "pio_quality_reporting_only",
            "1 while the drift detector runs without a trusted scorecard "
            "(missing or fingerprint-mismatched) — reporting, never "
            "gating.")
        self._g_diversity = reg.gauge(
            "pio_quality_candidate_diversity",
            "Distinct items / served item slots over the sampled window "
            "(1.0 = every slot unique; collapse → 1/window).")
        self._g_top_share = reg.gauge(
            "pio_quality_top_item_share",
            "Share of sampled served slots taken by the single most "
            "frequent item.")
        self._g_fold_share = reg.gauge(
            "pio_quality_fold_in_share",
            "Fold-in-served share of predict requests (solved+cached / "
            "requests).")
        self._g_gate = reg.gauge(
            "pio_quality_gate_rollback",
            "1 while the quality gate verdict is ROLLBACK (drift tripped "
            "or shadow divergence, with enough samples).")

    # -- sampling -----------------------------------------------------------

    def draw(self) -> float:
        """THE per-request uniform draw: shared by the prediction
        stream, shadow sampling, and the request-log sampler (one RNG
        draw per request, many thresholds)."""
        return self._rng.random()

    # -- generation lifecycle ----------------------------------------------

    def on_generation(self, generation: int, models: Sequence[Any], *,
                      shadow_fn: Optional[Callable[[Any], Any]] = None,
                      prev_generation: Optional[int] = None) -> None:
        """Re-anchor on a swap (reload or rollback): fresh drift windows
        against the NEW generation's scorecard; arm shadow scoring when
        the swap retained a previous generation to score against."""
        if not self.enabled:
            return
        scorecard, reason = resolve_scorecard(models)
        if scorecard is None:
            logger.warning(
                "quality: generation %d has no usable scorecard (%s) — "
                "drift detection is reporting-only", generation, reason)
        with self._lock:
            self._generation = generation
            self._detector = DriftDetector(
                self.config, scorecard, reporting_reason=reason,
                clock=self._clock)
            self._div_window.clear()
            self._div_counts.clear()
            self._div_slots = 0
        self._g_reporting.set(1 if scorecard is None else 0)
        if shadow_fn is not None:
            self.shadow.start(generation, prev_generation, shadow_fn)
        else:
            self.shadow.stop()

    def end_shadow(self, reason: str) -> None:
        if self.enabled:
            self.shadow.stop(reason)

    # -- the dispatch-boundary hook -----------------------------------------

    def observe(self, query: Any, result: Any, generation: Optional[int],
                u: Optional[float]) -> Optional[str]:
        """Record one served request (called right where the scheduler
        hands the result back).  ``u`` is the request's shared sample
        draw; anything ≥ the sample rate costs two comparisons and
        returns.  Sampled requests append their scores to the drift
        windows, update diversity, register the serve for the feedback
        join, and (inside a canary window) enqueue for shadow scoring.
        Returns the serve id to echo as ``X-PIO-Serve-Id``, or None."""
        if not self.enabled or u is None or u >= self.config.sample:
            return None
        items = extract_result_items(result)
        if items is None:
            return None  # unscored result shape — quality stays inert
        gen = int(generation) if generation is not None \
            else self._generation
        self._m_sampled.inc()
        if not items:
            self._m_empty.inc()
        for _, score in items:
            self._h_score.observe(score)
        if items:
            # Drift feeds the RANK-1 score only: the statistic the
            # scorecard baselines (invariant to the client's num — a
            # top-3 request's score set sits structurally above a
            # top-10 one's and would fake drift on a healthy server).
            self._detector.add(max(s for _, s in items))
        ids = [i for i, _ in items if i is not None]
        if ids:
            with self._lock:
                self._div_window.append(ids)
                for i in ids:
                    self._div_counts[i] = self._div_counts.get(i, 0) + 1
                self._div_slots += len(ids)
                while len(self._div_window) > max(
                        self.config.fast_window, 1):
                    old = self._div_window.popleft()
                    self._div_slots -= len(old)
                    for i in old:
                        n = self._div_counts.get(i, 0) - 1
                        if n <= 0:
                            self._div_counts.pop(i, None)
                        else:
                            self._div_counts[i] = n
        sid = f"g{gen}-{uuid.uuid4().hex[:10]}"
        self.joiner.note_serve(sid, gen, ids)
        # Shadow rate on the SHARED draw: u is already < sample here, so
        # the threshold must be the product sample×shadow_sample — a
        # bare `u < shadow_sample` would shadow-score EVERY sampled
        # request whenever shadow_sample ≥ sample (4× the documented
        # cost at the defaults) and turn the knob dead.
        if u < self.config.sample * self.config.shadow_sample:
            self.shadow.submit(query, items, gen)
        return sid

    # -- verdict / views ----------------------------------------------------

    def _diversity(self) -> Tuple[Optional[float], Optional[float]]:
        with self._lock:
            slots = self._div_slots
            if not slots:
                return None, None
            distinct = len(self._div_counts)
            top = max(self._div_counts.values())
        return distinct / slots, top / slots

    def _fold_in_share(self) -> Optional[float]:
        served = self._registry.get("pio_fold_in_total")
        reqs = self._registry.get("pio_query_requests_total")
        if served is None or reqs is None:
            return None
        total_reqs = reqs.total()
        if not total_reqs:
            return None
        rows = served.series()
        folded = sum(v for k, v in rows.items()
                     if k and k[0] in ("solved", "cached"))
        return folded / total_reqs

    def payload(self) -> Dict[str, Any]:
        """The ``/quality.json`` document (also the promotion gate the
        refresh daemon polls)."""
        if not self.enabled:
            return {"enabled": False}
        drift = self._detector.tick()
        shadow = self.shadow.snapshot()
        diversity, top_share = self._diversity()
        fold_share = self._fold_in_share()
        sc = self._detector.baseline
        reasons = []
        drift_gates = (drift.get("tripped")
                       and not drift.get("reportingOnly"))
        if drift_gates:
            reasons.append("drift")
        if shadow.get("divergent"):
            reasons.append("shadow_divergence")
        rollback = bool(reasons) and self.config.gate
        if drift.get("reportingOnly"):
            verdict = "reporting_only"
        elif drift_gates or shadow.get("divergent"):
            verdict = "degraded"
        elif drift.get("insufficient", True) and (
                not shadow.get("active")
                or shadow.get("insufficient", True)):
            verdict = "insufficient"
        else:
            verdict = "healthy"
        # publish the gauges the fleet/status views scrape
        for metric, vals in (("psi", drift.get("psi") or {}),
                             ("kl", drift.get("kl") or {})):
            for window in ("fast", "slow"):
                v = vals.get(window)
                if v is not None:
                    self._g_drift.set(v, metric=metric, window=window)
        self._g_tripped.set(1 if drift.get("tripped") else 0)
        self._g_gate.set(1 if rollback else 0)
        if diversity is not None:
            self._g_diversity.set(diversity)
        if top_share is not None:
            self._g_top_share.set(top_share)
        if fold_share is not None:
            self._g_fold_share.set(fold_share)
        return {
            "enabled": True,
            "generation": self._generation,
            "verdict": verdict,
            "gate": {"enabled": self.config.gate,
                     "rollback": rollback,
                     "reasons": reasons},
            "drift": drift,
            "shadow": shadow,
            "feedback": self.joiner.snapshot(),
            "sampling": {
                "sample": self.config.sample,
                "shadowSample": self.config.shadow_sample,
                "sampledTotal": int(self._m_sampled.value()),
                "emptyTotal": int(self._m_empty.value()),
                "foldInShare": (round(fold_share, 4)
                                if fold_share is not None else None),
            },
            "diversity": {
                "candidateDiversity": (round(diversity, 4)
                                       if diversity is not None else None),
                "topItemShare": (round(top_share, 4)
                                 if top_share is not None else None),
            },
            "scorecard": (sc.summary() if sc is not None
                          else {"present": False,
                                "reason": self._detector.reporting_reason}),
        }

    def summary(self) -> Dict[str, Any]:
        """Compact ``/stats.json`` embed."""
        if not self.enabled:
            return {"enabled": False}
        doc = self.payload()
        return {"enabled": True,
                "verdict": doc["verdict"],
                "gateRollback": doc["gate"]["rollback"],
                "psiFast": doc["drift"].get("psi", {}).get("fast"),
                "psiSlow": doc["drift"].get("psi", {}).get("slow"),
                "shadowOverlap": doc["shadow"].get("overlapMean"),
                "sampled": doc["sampling"]["sampledTotal"]}

    def close(self) -> None:
        if self.enabled:
            self.shadow.close()


# ==========================================================================
# Fleet merge
# ==========================================================================

# Keys whose numeric values SUM across instances (counts); every other
# number takes the MAX (drift magnitudes, shares — the fleet's verdict
# must reflect the worst instance, and summing a PSI is meaningless).
_SUM_KEYS = frozenset((
    "samples", "scored", "sampledTotal", "emptyTotal", "tracked",
    "hits", "misses", "attributedOnly", "nFast", "nSlow", "n",
    "captured", "dropped",
))
# Recall fields take the MIN: the fleet's recall IS its worst
# instance (a rotten replica hides inside a max or a mean), and the
# baseline pins to the most conservative scorecard in the set.  Flat key
# names on purpose — psi's fast/slow (drift magnitude) correctly takes
# MAX, so recall's windows must not share those key names.
_MIN_KEYS = frozenset(("recallFast", "recallSlow", "baseline"))
_VERDICT_ORDER = ("healthy", "insufficient", "reporting_only", "degraded")


def merge_quality(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet merge of N ``/quality.json`` documents.

    Walks the UNION of keys recursively, so no instance's field is ever
    silently dropped (the tier-1 schema-stability test pins this):
    counts sum, magnitudes take the worst (max), recall readings take
    the worst (MIN — a rotten replica must surface), booleans OR,
    verdicts take the worst of the ordering, strings keep the first
    non-null.
    Disabled instances are skipped; all-disabled merges to
    ``{"enabled": False}``."""
    live = [d for d in docs if isinstance(d, dict) and d.get("enabled")]
    if not live:
        return {"enabled": False, "instances": len(list(docs))}
    merged = _merge_values("", live)
    merged["enabled"] = True
    merged["instances"] = len(live)
    # hit-rate style ratios recompute from the summed parts
    fb = merged.get("feedback")
    if isinstance(fb, dict) and isinstance(fb.get("generations"), dict):
        for row in fb["generations"].values():
            if isinstance(row, dict):
                h, m = row.get("hits", 0) or 0, row.get("misses", 0) or 0
                row["hitRate"] = round(h / (h + m), 4) if h + m else None
    return merged


def _merge_values(key: str, values: List[Any]) -> Any:
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    if all(isinstance(v, dict) for v in vals):
        keys: List[str] = []
        for v in vals:
            for k in v:
                if k not in keys:
                    keys.append(k)
        return {k: _merge_values(k, [v.get(k) for v in vals])
                for k in keys}
    if all(isinstance(v, bool) for v in vals):
        return any(vals)
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in vals):
        if key in _MIN_KEYS:
            return min(vals)
        if key in _SUM_KEYS:
            return sum(vals)
        return max(vals)
    if key == "verdict":
        return max(vals, key=lambda v: _VERDICT_ORDER.index(v)
                   if v in _VERDICT_ORDER else 0)
    if all(isinstance(v, list) for v in vals):
        out: List[Any] = []
        for v in vals:
            for item in v:
                if item not in out:
                    out.append(item)
        return out
    return vals[0]
