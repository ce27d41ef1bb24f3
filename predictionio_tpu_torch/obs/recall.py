"""Online retrieval-recall observability.

Port of ``predictionio_tpu/obs/recall.py``.  Most predict traffic is
answered by APPROXIMATE retrieval rungs (``ivf``, ``ivf_pq``,
``pq_flat``) whose recall was measured exactly once, offline, at bench time.  A skewed delta-refresh,
a truncated corpus sample, or a mis-tuned ``nprobe``/``rerank`` can rot
recall for days while every latency SLO, score-drift gauge, and shadow
overlap reads green — the results come back fast, well-scored, and
WRONG.  This module closes that hole with the same machinery the quality
layer proved for score drift, pointed at the retrieval layer:

- **Shadow exact re-rank sampling.**  The retrieval facade
  (:class:`~predictionio_tpu_torch.retrieval.Retriever`) exposes a
  ``recall_hook``; when armed by :class:`RecallMonitor`, sampled
  approximate-rung requests (the quality layer's shared per-request
  draw — ``Waterfall.sample_u`` under ``PIO_RECALL_SAMPLE``) have their query
  vectors + returned ids captured into a bounded queue (overflow drops
  and counts — the shadow-canary cost model: observability must never
  add serving latency).  An off-thread worker re-scores each capture
  through an EXACT brute-force scan of the SAME generation's staged
  corpus and computes live recall@k.
- **Per-rung recall scorecards.**  Template ``train()`` bakes a
  :class:`RecallScorecard` into the model wrapper next to the
  quality scorecard: the offline recall of the just-built index/codes
  on a seeded query sample, pinned to the corpus fingerprint.  The
  detector trips on REGRESSION VS THE GENERATION'S OWN BASELINE — an
  IVF index is expected to sit at (say) 0.93, so "recall = 0.93" is
  healthy and "recall = 0.70" is rot, without a magic absolute floor.
- **Miss attribution names the knob.**  Every missed true-top-k item
  on ``ivf_pq`` is classified: was its cell PROBED (the PQ shortlist
  saturated — raise ``PIO_PQ_RERANK``) or not (the probe ring is too
  narrow — widen ``PIO_IVF_NPROBE``)?  ``ivf`` misses are all
  cell-misses by construction (the in-cell scan is exact);
  ``pq_flat`` misses are all shortlist-saturation (every code row is
  scanned).  The reference's ``tools/attribute_quality.py`` turns the two
  gauges into the recommendation.
- **Gate-wired.**  :meth:`RecallMonitor.augment_quality` folds a third
  verdict into ``/quality.json``'s promotion gate (after drift and
  shadow divergence) with the same asymmetric hysteresis (trip
  instantly, clear only after a ``PIO_RECALL_RECOVERY_S`` dwell) and
  min-samples cold pass-through — the refresh daemon's canary watch and
  the fleet rollout bake already poll ``gate.rollback``, so a
  recall-rotten candidate rolls back through the existing
  ``/admin/rollback`` path with ZERO new daemon logic.
- **Self-disabling below the approximate envelope.**  Tiny corpora
  (below ``PIO_IVF_MIN_ITEMS`` / ``PIO_PQ_MIN_ITEMS``) build no index
  and serve exact; the facade hook only fires on approximate rungs and
  train ships no recall scorecard, so the monitor reads
  reporting-only/insufficient and the gate never acts — there is
  nothing to monitor and nothing trips.

Knobs (prefix ``PIO_RECALL``; kill switch registers ZERO instruments):

====================================  ==================================
``PIO_RECALL``                        kill switch (default on)
``PIO_RECALL_SAMPLE``                 captured slice of approximate-rung
                                      requests on the shared per-request
                                      draw (0.05)
``PIO_RECALL_K``                      recall@k the monitor scores (10)
``PIO_RECALL_QUEUE``                  bounded capture queue; overflow
                                      drops, never blocks (256)
``PIO_RECALL_MAX_ROWS``               query rows re-scored per captured
                                      batch (4)
``PIO_RECALL_FAST_WINDOW``            fast (~minutes) window size (256)
``PIO_RECALL_RESERVOIR``              slow (~generation) Algorithm-R
                                      reservoir size (2048)
``PIO_RECALL_MIN_SAMPLES``            per-window floor below which the
                                      verdict is pass-through (50)
``PIO_RECALL_TOLERANCE``              allowed recall drop vs the
                                      scorecard baseline (0.05)
``PIO_RECALL_RECOVERY_S``             trip-false dwell before the
                                      verdict clears (60)
``PIO_RECALL_GATE``                   recall regression may roll back a
                                      promotion (default on)
====================================  ==================================

Single-owner contract (the reference's ``tools/lint_metrics.py`` rule 5):
every ``pio_retrieval_recall*`` family registers in THIS module only, so the
fleet-merge schema has one source of truth.  Numpy and the retrieval
search functions are imported lazily (train-time builders and the
off-thread worker only) — the module stays stdlib-cheap on import.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.obs.metrics import get_registry
from predictionio_tpu_torch.obs.waterfall import active_sample_u

logger = logging.getLogger(__name__)

__all__ = [
    "RecallConfig",
    "RecallScorecard",
    "build_recall_scorecard",
    "recall_scorecard_from_mapping",
    "resolve_recall_scorecard",
    "RecallDetector",
    "RecallMonitor",
    "APPROX_RUNGS",
]

# The rungs whose answers are approximate — the only ones worth
# shadow-re-ranking (every other rung IS the exact answer).
APPROX_RUNGS = ("ivf", "ivf_pq", "pq_flat")

# The ks a train-time scorecard bakes baselines for (RecallConfig.k
# defaults to 10, the serving num the shipped templates see most).
SCORECARD_KS = (1, 10)


def _env_f(env, key: str, default: float) -> float:
    raw = env.get(key)
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass
class RecallConfig:
    """Recall-monitor knobs; :meth:`from_env` is the production
    constructor (same pattern as QualityConfig)."""

    enabled: bool = True
    sample: float = 0.05
    k: int = 10
    queue: int = 256
    max_rows: int = 4
    fast_window: int = 256
    reservoir: int = 2048
    min_samples: int = 50
    tolerance: float = 0.05
    recovery_s: float = 60.0
    gate: bool = True

    @classmethod
    def from_env(cls, env=None) -> "RecallConfig":
        env = os.environ if env is None else env
        return cls(
            enabled=env_bool(env.get("PIO_RECALL"), True),
            sample=min(max(_env_f(env, "PIO_RECALL_SAMPLE", 0.05), 0.0),
                       1.0),
            k=max(1, int(_env_f(env, "PIO_RECALL_K", 10))),
            queue=int(_env_f(env, "PIO_RECALL_QUEUE", 256)),
            max_rows=max(1, int(_env_f(env, "PIO_RECALL_MAX_ROWS", 4))),
            fast_window=int(_env_f(env, "PIO_RECALL_FAST_WINDOW", 256)),
            reservoir=int(_env_f(env, "PIO_RECALL_RESERVOIR", 2048)),
            min_samples=int(_env_f(env, "PIO_RECALL_MIN_SAMPLES", 50)),
            tolerance=_env_f(env, "PIO_RECALL_TOLERANCE", 0.05),
            recovery_s=_env_f(env, "PIO_RECALL_RECOVERY_S", 60.0),
            gate=env_bool(env.get("PIO_RECALL_GATE"), True),
        )


# ==========================================================================
# RecallScorecard: the training-time baseline that rides the wrapper
# ==========================================================================

@dataclasses.dataclass
class RecallScorecard:
    """Expected recall of the generation's OWN approximate structures.

    Serialized inside the model wrapper next to the quality
    scorecard, so the staged-reload/rollback swap moves baseline and
    index/codes as ONE artifact — the online monitor can never judge
    generation-N retrieval against generation-M expectations.
    ``fingerprint`` is the corpus fingerprint of the item
    vectors the baseline was measured over; a mismatch degrades the
    detector to reporting-only (loud, never blocking)."""

    recall: Dict[str, Dict[int, float]]  # rung -> {k: expected recall@k}
    n_queries: int                       # seeded query sample size
    nprobe: int = 0                      # serving formula at build time
    rerank: int = 0
    fingerprint: Optional[str] = None
    built_at: float = 0.0
    name: str = ""

    def expected(self, rung: str, k: int) -> Optional[float]:
        """Baseline recall@k for ``rung``: exact k when baked, else the
        largest baked k at or below it (recall@k is monotone enough in k
        for a regression tolerance), else the smallest baked k."""
        table = (self.recall or {}).get(rung)
        if not table:
            return None
        if k in table:
            return table[k]
        ks = sorted(table)
        for kk in reversed(ks):
            if kk <= k:
                return table[kk]
        return table[ks[0]]

    def summary(self) -> Dict[str, Any]:
        return {
            "present": True,
            "nQueries": self.n_queries,
            "nprobe": self.nprobe,
            "rerank": self.rerank,
            "builtAt": round(self.built_at, 3),
            "name": self.name,
            "fingerprint": self.fingerprint,
            "recall": {rung: {str(k): round(v, 4)
                              for k, v in sorted(table.items())}
                       for rung, table in sorted(self.recall.items())},
        }


def _serving_nprobe(index, reach: int) -> int:
    """The facade's ``_finish_plan`` nprobe formula — the baseline must
    measure the index at the width serving will actually probe."""
    return min(index.nlist,
               max(index.default_nprobe(), index.min_nprobe_for(reach)))


def _serving_rerank(k: int, n_items: int) -> int:
    """The facade's ``_rerank_count`` formula (``PIO_PQ_RERANK`` else
    4·k, clamped to [k, n_items])."""
    raw = os.environ.get("PIO_PQ_RERANK", "").strip()
    r = 0
    if raw:
        try:
            r = int(raw)
        except ValueError:
            pass
    if r <= 0:
        r = 4 * k
    return min(n_items, max(r, k))


def _exact_topk_ids(host_vecs, queries, k: int, chunk: int = 65536):
    """[B, k] int32 ids of the exact top-k (unordered — set membership
    is all recall needs), chunked so the score transient stays bounded
    at million-item corpora."""
    import numpy as np

    q = np.ascontiguousarray(queries, dtype=np.float32)
    n = host_vecs.shape[0]
    k = min(k, n)
    best_s = np.full((len(q), 0), -np.inf, dtype=np.float32)
    best_i = np.zeros((len(q), 0), dtype=np.int32)
    for s0 in range(0, n, chunk):
        block = (q @ host_vecs[s0:s0 + chunk].T).astype(np.float32)
        ids = np.broadcast_to(
            np.arange(s0, s0 + block.shape[1], dtype=np.int32),
            block.shape)
        ms = np.concatenate([best_s, block], axis=1)
        mi = np.concatenate([best_i, ids], axis=1)
        if ms.shape[1] > k:
            part = np.argpartition(-ms, k - 1, axis=1)[:, :k]
            best_s = np.take_along_axis(ms, part, axis=1)
            best_i = np.take_along_axis(mi, part, axis=1)
        else:
            best_s, best_i = ms, mi
    return best_i


def _recall_of_ids(approx_ids, exact_ids) -> float:
    """|approx ∩ exact| / |exact| for one row (sentinel ids skipped)."""
    truth = {int(i) for i in exact_ids if i >= 0}
    if not truth:
        return 1.0
    got = {int(i) for i in approx_ids if i >= 0}
    return len(truth & got) / len(truth)


def build_recall_scorecard(query_vecs, item_vecs, *, ivf=None, pq=None,
                           sample: int = 128, seed: int = 0,
                           name: str = "") -> Optional[RecallScorecard]:
    """Train-time baseline: offline recall@k of the just-built
    index/codes on a seeded query sample, through the SAME host search
    paths and nprobe/rerank formulas serving uses.

    Returns None when the generation carries no approximate structure
    (tiny corpus below the IVF/PQ thresholds, or both opted off) —
    serving is exact, there is nothing to regress, and the online
    monitor self-disables into reporting-only.  Numpy and the search
    functions import lazily: this only runs inside ``pio train``."""
    if ivf is None and pq is None:
        return None
    import numpy as np

    from predictionio_tpu_torch.retrieval.ivf import (
        corpus_fingerprint,
        search_ivf_host,
    )
    from predictionio_tpu_torch.retrieval.pq import (
        search_ivf_pq_host,
        search_pq_host,
    )

    q = np.asarray(query_vecs)
    it = np.ascontiguousarray(np.asarray(item_vecs), dtype=np.float32)
    if q.ndim != 2 or it.ndim != 2 or not len(q) or not len(it):
        return None
    rng = np.random.default_rng(seed)
    n_sample = min(len(q), max(int(sample), 1))
    qs = np.ascontiguousarray(
        q[rng.choice(len(q), size=n_sample, replace=False)],
        dtype=np.float32)
    n_items = it.shape[0]
    recall: Dict[str, Dict[int, float]] = {}
    nprobe_used = rerank_used = 0
    for k in SCORECARD_KS:
        kk = min(k, n_items)
        exact = _exact_topk_ids(it, qs, kk)
        if ivf is not None:
            nprobe = _serving_nprobe(ivf, kk)
            nprobe_used = max(nprobe_used, nprobe)
            _, ids, _ = search_ivf_host(ivf, it, qs, kk, nprobe)
            recall.setdefault("ivf", {})[k] = float(np.mean(
                [_recall_of_ids(ids[b], exact[b])
                 for b in range(n_sample)]))
        if pq is not None:
            rerank = _serving_rerank(kk, n_items)
            rerank_used = max(rerank_used, rerank)
            _, ids, _ = search_pq_host(pq, it, qs, kk, rerank)
            recall.setdefault("pq_flat", {})[k] = float(np.mean(
                [_recall_of_ids(ids[b], exact[b])
                 for b in range(n_sample)]))
            if ivf is not None:
                nprobe = _serving_nprobe(ivf, rerank)
                _, ids, _ = search_ivf_pq_host(ivf, pq, it, qs, kk,
                                               nprobe, rerank)
                recall.setdefault("ivf_pq", {})[k] = float(np.mean(
                    [_recall_of_ids(ids[b], exact[b])
                     for b in range(n_sample)]))
    sc = RecallScorecard(recall=recall, n_queries=n_sample,
                         nprobe=nprobe_used, rerank=rerank_used,
                         fingerprint=corpus_fingerprint(it),
                         built_at=time.time(), name=name)
    logger.info("recall scorecard for %r: %s (n=%d)", name,
                {r: {k: round(v, 3) for k, v in t.items()}
                 for r, t in recall.items()}, n_sample)
    return sc


def recall_scorecard_from_mapping(sc: Any) -> Optional[RecallScorecard]:
    """A :class:`RecallScorecard` from the reference's fields
    (``dataclasses.asdict`` of its scorecard); a scorecard or None passes
    through."""
    if sc is None or isinstance(sc, RecallScorecard):
        return sc
    d = dict(sc)
    d["recall"] = {str(rung): {int(k): float(v) for k, v in table.items()}
                   for rung, table in (d.get("recall") or {}).items()}
    return RecallScorecard(**d)


def resolve_recall_scorecard(models: Sequence[Any]
                             ) -> Tuple[Optional[RecallScorecard],
                                        Optional[str]]:
    """(scorecard, reporting_reason) for a loaded model set — the same
    fingerprint tripwire as ``resolve_scorecard``: a wrapper whose
    corpus no longer matches the baseline's fingerprint degrades the
    detector to reporting-only with an ERROR, never a gate."""
    for m in models or ():
        sc = getattr(m, "recall", None)
        if not isinstance(sc, RecallScorecard):
            continue
        vecs = getattr(m, "item_vecs", None)
        if sc.fingerprint and vecs is not None:
            try:
                import numpy as np

                from predictionio_tpu_torch.retrieval.ivf import (
                    corpus_fingerprint,
                )

                if corpus_fingerprint(np.ascontiguousarray(
                        np.asarray(vecs), dtype=np.float32)) \
                        != sc.fingerprint:
                    logger.error(
                        "recall scorecard fingerprint mismatch for %r — "
                        "recall monitoring degrades to reporting-only "
                        "(serving continues)", type(m).__name__)
                    return None, "fingerprint_mismatch"
            except Exception:
                logger.warning("recall fingerprint check failed",
                               exc_info=True)
        return sc, None
    return None, "no_scorecard"


# ==========================================================================
# Detector: per-rung fast/slow recall windows with hysteresis
# ==========================================================================

class RecallDetector:
    """Live recall@k vs the generation's scorecard baseline, per rung,
    over a fast (recent deque, ~minutes at shipped sampling) and a slow
    (generation-wide Algorithm-R reservoir, ~hours) window.

    A rung trips only when BOTH window means sit more than ``tolerance``
    below its baked baseline AND both windows carry ``min_samples`` —
    the fast window proves it's still happening, the slow one that the
    generation's whole serving stream regressed, not one burst; cold
    rungs pass through.  Hysteresis is asymmetric per rung (trip
    instantly, clear after a ``recovery_s`` dwell).  Thread-safe;
    ``clock``/``rng`` injectable — tests drive hours in microseconds."""

    MIN_TICK_INTERVAL_S = 1.0

    def __init__(self, config: RecallConfig,
                 scorecard: Optional[RecallScorecard] = None, *,
                 reporting_reason: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.config = config
        self.scorecard = scorecard
        self.reporting_reason = (
            reporting_reason if scorecard is None or reporting_reason
            else None)
        self._clock = clock
        self._rng = rng or random.Random(0)
        self._lock = threading.Lock()
        self._rungs: Dict[str, Dict[str, Any]] = {}
        self._last_tick: Optional[float] = None
        self._last: Dict[str, Any] = {}

    def _state(self, rung: str) -> Dict[str, Any]:
        st = self._rungs.get(rung)
        if st is None:
            st = {"fast": deque(), "fast_sum": 0.0,
                  "res": [], "res_sum": 0.0, "seen": 0,
                  "tripped": False, "clear_since": None}
            self._rungs[rung] = st
        return st

    def add(self, rung: str, recall: float) -> None:
        cfg = self.config
        r = float(recall)
        with self._lock:
            st = self._state(rung)
            st["seen"] += 1
            st["fast"].append(r)
            st["fast_sum"] += r
            if len(st["fast"]) > max(cfg.fast_window, 1):
                st["fast_sum"] -= st["fast"].popleft()
            if len(st["res"]) < max(cfg.reservoir, 1):
                st["res"].append(r)
                st["res_sum"] += r
            else:
                j = self._rng.randrange(st["seen"])
                if j < len(st["res"]):
                    st["res_sum"] += r - st["res"][j]
                    st["res"][j] = r

    def tick(self, force: bool = False) -> Dict[str, Any]:
        """Recompute per-rung means + the hysteresis verdict
        (pull-driven with tick coalescing, like the drift detector)."""
        cfg = self.config
        now = self._clock()
        with self._lock:
            if (not force and self._last_tick is not None
                    and now - self._last_tick < self.MIN_TICK_INTERVAL_S
                    and self._last):
                return dict(self._last)
            self._last_tick = now
            rungs: Dict[str, Any] = {}
            any_tripped = False
            any_enough = False
            for rung in sorted(self._rungs):
                st = self._rungs[rung]
                n_fast, n_slow = len(st["fast"]), len(st["res"])
                fast = st["fast_sum"] / n_fast if n_fast else None
                slow = st["res_sum"] / n_slow if n_slow else None
                baseline = (self.scorecard.expected(rung, cfg.k)
                            if self.scorecard is not None else None)
                enough = (n_fast >= cfg.min_samples
                          and n_slow >= cfg.min_samples)
                # Trip needs BOTH windows below baseline − tolerance.
                trip = (baseline is not None and enough
                        and baseline - fast > cfg.tolerance
                        and baseline - slow > cfg.tolerance)
                if trip:
                    st["tripped"] = True
                    st["clear_since"] = None
                elif st["tripped"]:
                    if st["clear_since"] is None:
                        st["clear_since"] = now
                    elif now - st["clear_since"] >= cfg.recovery_s:
                        st["tripped"] = False
                        st["clear_since"] = None
                any_tripped = any_tripped or st["tripped"]
                any_enough = any_enough or enough
                rungs[rung] = {
                    "recallFast": (round(fast, 4)
                                   if fast is not None else None),
                    "recallSlow": (round(slow, 4)
                                   if slow is not None else None),
                    "baseline": (round(baseline, 4)
                                 if baseline is not None else None),
                    "nFast": n_fast,
                    "nSlow": n_slow,
                    "tripped": st["tripped"],
                }
            state = {
                "reportingOnly": bool(self.reporting_reason),
                "reason": self.reporting_reason,
                "tripped": any_tripped,
                "insufficient": not any_enough,
                "rungs": rungs,
                "k": cfg.k,
                "tolerance": cfg.tolerance,
                "minSamples": cfg.min_samples,
            }
            self._last = state
            return dict(state)


# ==========================================================================
# The monitor: capture hook + off-thread exact re-rank + gate verdict
# ==========================================================================

class RecallMonitor:
    """The engine server's recall layer: one instance per server.

    ``on_generation`` arms the facade hook on the new generation's
    retriever(s) and re-anchors the detector on the wrapper's baked
    :class:`RecallScorecard`; ``_capture`` is the retrieval-facade hot
    path (two comparisons + one bounded enqueue on sampled
    approximate-rung requests); the worker thread re-scores captures
    exactly; ``augment_quality`` folds the verdict into the
    ``/quality.json`` gate.  With ``PIO_RECALL=off`` every method is an
    inert no-op, the hook is never attached, and no instruments
    register."""

    def __init__(self, config: Optional[RecallConfig] = None, *,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.config = config or RecallConfig.from_env()
        self.enabled = self.config.enabled
        self._clock = clock
        self._rng = rng or random.Random()
        if not self.enabled:
            return
        reg = registry or get_registry()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._generation = 0
        self._detector = RecallDetector(self.config, None, clock=clock)
        # retriever (weak) -> generation it serves; + the retrievers the
        # current generation armed, so a swap can detach the old hooks.
        self._gen_of: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._item_cells: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._armed: List[Any] = []   # weakrefs of hooked retrievers
        # cumulative per-rung miss attribution for the saturation gauges
        self._miss: Dict[str, Dict[str, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._g_recall = reg.gauge(
            "pio_retrieval_recall",
            "Live sampled recall@k of the approximate retrieval rungs "
            "vs an exact re-rank of the same generation's corpus.",
            ("rung", "k", "window"))
        self._g_baseline = reg.gauge(
            "pio_retrieval_recall_baseline",
            "Train-time expected recall@k baked into the generation's "
            "RecallScorecard.", ("rung", "k"))
        self._m_captures = reg.counter(
            "pio_retrieval_recall_captures_total",
            "Sampled retrieval captures by outcome (captured / scored / "
            "dropped / stale / dead / error).", ("result",))
        self._g_scanned = reg.gauge(
            "pio_retrieval_recall_scanned_fraction",
            "Mean fraction of corpus rows the approximate rung actually "
            "scanned for the sampled requests.", ("rung",))
        self._g_shortlist = reg.gauge(
            "pio_retrieval_recall_shortlist_saturation",
            "Share of missed true-top-k items whose cell WAS probed — "
            "the PQ rerank shortlist saturated; raise PIO_PQ_RERANK.",
            ("rung",))
        self._g_cell = reg.gauge(
            "pio_retrieval_recall_cell_miss",
            "Share of missed true-top-k items whose cell was NOT probed "
            "— the probe ring is too narrow; widen PIO_IVF_NPROBE.",
            ("rung",))
        self._g_tripped = reg.gauge(
            "pio_retrieval_recall_tripped",
            "1 while sampled recall sits below the generation's own "
            "baseline on both windows (hysteresis-latched).")
        self._g_reporting = reg.gauge(
            "pio_retrieval_recall_reporting_only",
            "1 while the recall monitor runs without a trusted "
            "scorecard (missing or fingerprint-mismatched) — reporting, "
            "never gating.")

    # -- sampling ------------------------------------------------------------

    def draw(self) -> float:
        """Per-request uniform draw, used only when the quality layer
        (the usual owner of the shared draw) is disabled."""
        return self._rng.random()

    # -- generation lifecycle ------------------------------------------------

    def on_generation(self, generation: int, models: Sequence[Any]
                      ) -> None:
        """Re-anchor on a swap (reload or rollback): detach the old
        generation's facade hooks, arm the new generation's
        retriever(s), and point the detector at the new wrapper's baked
        scorecard.  Idempotent and cheap — called right after
        ``QualityMonitor.on_generation``."""
        if not self.enabled:
            return
        scorecard, reason = resolve_recall_scorecard(models)
        if scorecard is None:
            logger.info(
                "recall: generation %d has no usable recall scorecard "
                "(%s) — recall monitoring is reporting-only",
                generation, reason)
        with self._lock:
            for ref in self._armed:
                r = ref()
                if r is not None:
                    r.recall_hook = None
            self._armed = []
            self._generation = generation
            self._detector = RecallDetector(
                self.config, scorecard, reporting_reason=reason,
                clock=self._clock)
            self._miss = {}
            self._queue.clear()
        # Arm OUTSIDE the monitor lock, and WITHOUT forcing retriever
        # creation: `arm_on_create` fires the callback immediately for
        # an already-cached retriever, else right after the facade
        # lazily builds it on the first query — retriever construction
        # (and its index fingerprint validation) keeps its load-is-lazy
        # contract.
        from predictionio_tpu_torch.retrieval import arm_on_create

        for m in models or ():
            if not callable(getattr(m, "retriever", None)):
                continue
            try:
                arm_on_create(
                    m, lambda r, g=generation: self._arm(r, g))
            except Exception:
                logger.debug("recall: arm_on_create failed",
                             exc_info=True)
        self._g_reporting.set(1 if scorecard is None else 0)

    def _arm(self, retriever, generation: int) -> None:
        """Attach the capture hook to one retriever — possibly later
        than ``on_generation`` (first query builds the retriever).  A
        callback that fires after a further swap is stale and no-ops."""
        if retriever is None or not hasattr(retriever, "recall_hook"):
            return
        with self._lock:
            if self._closed or generation != self._generation:
                return
            retriever.recall_hook = self._capture
            self._gen_of[retriever] = generation
            self._armed.append(weakref.ref(retriever))

    # -- the facade hot-path hook --------------------------------------------

    def _capture(self, retriever, plan, queries, ids, scanned: int
                 ) -> None:
        """Called by ``Retriever.topk`` after an approximate-rung
        answer.  Cost when unsampled: one contextvar read + one compare.
        Sampled: bounded copies of the first ``max_rows`` query/id rows
        into the queue (drop-and-count on overflow — never blocks the
        dispatch)."""
        u = active_sample_u()
        if u is None or u >= self.config.sample:
            return
        rows = min(len(queries), self.config.max_rows)
        rec = {
            "retriever": weakref.ref(retriever),
            "generation": self._gen_of.get(retriever),
            "rung": plan.rung,
            "nprobe": plan.nprobe,
            "rerank": plan.rerank,
            "q": queries[:rows].copy(),
            "ids": ids[:rows].copy(),
            "scanned": int(scanned),
            "batch": len(queries),
        }
        with self._cond:
            if self._closed:
                return
            if len(self._queue) >= max(self.config.queue, 1):
                self._m_captures.inc(result="dropped")
                return
            self._queue.append(rec)
            self._m_captures.inc(result="captured")
            # Wake the worker eagerly only under backpressure (queue
            # half full): a per-capture notify turns every sampled
            # request into a thread wakeup + GIL handoff on the serving
            # hot path — measurable p99 inflation at saturation.  The
            # steady state rides the worker's short poll instead and
            # drains captures in batches.
            if len(self._queue) * 2 >= max(self.config.queue, 1):
                self._cond.notify()
        self._ensure_thread()

    # -- the worker ----------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="pio-recall-monitor", daemon=True)
            self._thread.start()

    #: Worker poll period: captures queue for at most this long before a
    #: batch drain when the backpressure notify hasn't fired.  Recall is
    #: a minutes-scale signal — a quarter second of added measurement
    #: latency buys per-request wakeups off the serving path.
    DRAIN_INTERVAL_S = 0.25

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._queue and not self._closed:
                    self._cond.wait(timeout=self.DRAIN_INTERVAL_S)
                if self._closed:
                    return
            try:
                while self.drain_once():
                    pass
            except Exception:
                logger.exception("recall monitor worker error")

    def drain_once(self) -> int:
        """Exact-re-rank one queued capture (also the tests' synchronous
        entry point).  Returns captures processed (0/1)."""
        with self._lock:
            if not self._queue:
                return 0
            rec = self._queue.popleft()
            current_gen = self._generation
        r = rec["retriever"]()
        if r is None:
            self._m_captures.inc(result="dead")
            return 1
        if rec["generation"] != current_gen:
            self._m_captures.inc(result="stale")
            return 1
        try:
            self._score(r, rec)
        except Exception:
            logger.debug("recall re-score failed", exc_info=True)
            self._m_captures.inc(result="error")
            return 1
        self._m_captures.inc(result="scored")
        return 1

    def _cells_of(self, retriever, index):
        """item -> IVF cell lookup array, built once per retriever
        (weak-keyed — dies with the generation's staged corpus)."""
        cells = self._item_cells.get(retriever)
        if cells is None:
            import numpy as np

            cells = np.full(index.n_items, -1, dtype=np.int32)
            for c in range(index.nlist):
                ln = int(index.list_lengths[c])
                if ln:
                    cells[index.lists[c, :ln]] = c
            self._item_cells[retriever] = cells
        return cells

    def _score(self, retriever, rec: Dict[str, Any]) -> None:
        import numpy as np

        cfg = self.config
        rung = rec["rung"]
        q, ids = rec["q"], rec["ids"]
        k = min(cfg.k, ids.shape[1], retriever.n_items)
        if k <= 0:
            return
        host = retriever.host_vecs()
        exact = _exact_topk_ids(host, q, k)
        shortlist_misses = cell_misses = 0
        truth_total = 0
        probe_sets: Optional[List[set]] = None
        cells = None
        if rung == "ivf_pq":
            index = retriever.ivf_index()
            if index is not None:
                cq = np.ascontiguousarray(q, dtype=np.float32) \
                    @ index.centroids.T
                nprobe = max(1, min(int(rec["nprobe"]) or index.nlist,
                                    index.nlist))
                if nprobe < index.nlist:
                    probed = np.argpartition(
                        -cq, nprobe - 1, axis=1)[:, :nprobe]
                else:
                    probed = np.broadcast_to(
                        np.arange(index.nlist), cq.shape)
                probe_sets = [set(int(c) for c in row) for row in probed]
                cells = self._cells_of(retriever, index)
        for b in range(len(q)):
            truth = [int(i) for i in exact[b] if i >= 0]
            got = {int(i) for i in ids[b, :k] if i >= 0}
            truth_total += len(truth)
            missed = [i for i in truth if i not in got]
            self._detector.add(
                rung, 1.0 if not truth
                else (len(truth) - len(missed)) / len(truth))
            for i in missed:
                if rung == "ivf":
                    # in-cell scan is exact: a miss IS an unprobed cell
                    cell_misses += 1
                elif rung == "pq_flat":
                    # every code row scanned: a miss IS a saturated
                    # (or out-ordered) shortlist
                    shortlist_misses += 1
                elif probe_sets is not None and cells is not None:
                    if int(cells[i]) in probe_sets[b]:
                        shortlist_misses += 1
                    else:
                        cell_misses += 1
                else:
                    shortlist_misses += 1
        frac = rec["scanned"] / max(rec["batch"] * retriever.n_items, 1)
        with self._lock:
            agg = self._miss.setdefault(
                rung, {"truth": 0, "shortlist": 0, "cell": 0,
                       "scanned_sum": 0.0, "captures": 0})
            agg["truth"] += truth_total
            agg["shortlist"] += shortlist_misses
            agg["cell"] += cell_misses
            agg["scanned_sum"] += frac
            agg["captures"] += 1

    # -- verdict / views -----------------------------------------------------

    def payload(self) -> Dict[str, Any]:
        """The ``recall`` block of ``/quality.json`` (gauges published
        as a side effect, same pull-driven pattern as the quality
        payload)."""
        if not self.enabled:
            return {"enabled": False}
        state = self._detector.tick()
        with self._lock:
            miss = {rung: dict(agg) for rung, agg in self._miss.items()}
        rungs: Dict[str, Any] = {}
        for rung, det in (state.get("rungs") or {}).items():
            agg = miss.get(rung, {})
            truth = agg.get("truth", 0)
            caps = agg.get("captures", 0)
            row = dict(det)
            row["shortlistSaturation"] = (
                round(agg.get("shortlist", 0) / truth, 4) if truth
                else None)
            row["cellMiss"] = (
                round(agg.get("cell", 0) / truth, 4) if truth else None)
            row["scannedFraction"] = (
                round(agg.get("scanned_sum", 0.0) / caps, 6) if caps
                else None)
            rungs[rung] = row
        tripped = bool(state.get("tripped"))
        reporting = bool(state.get("reportingOnly"))
        if reporting:
            verdict = "reporting_only"
        elif tripped:
            verdict = "degraded"
        elif state.get("insufficient", True):
            verdict = "insufficient"
        else:
            verdict = "healthy"
        k_label = str(self.config.k)
        for rung, row in rungs.items():
            for window, key in (("fast", "recallFast"),
                                ("slow", "recallSlow")):
                v = row.get(key)
                if v is not None:
                    self._g_recall.set(v, rung=rung, k=k_label,
                                       window=window)
            if row.get("baseline") is not None:
                self._g_baseline.set(row["baseline"], rung=rung,
                                     k=k_label)
            for gauge, key in ((self._g_shortlist,
                                "shortlistSaturation"),
                               (self._g_cell, "cellMiss"),
                               (self._g_scanned, "scannedFraction")):
                if row.get(key) is not None:
                    gauge.set(row[key], rung=rung)
        self._g_tripped.set(1 if tripped else 0)
        self._g_reporting.set(1 if reporting else 0)
        return {
            "enabled": True,
            "generation": self._generation,
            "verdict": verdict,
            "tripped": tripped,
            "reportingOnly": reporting,
            "reason": state.get("reason"),
            "insufficient": bool(state.get("insufficient", True)),
            "sample": self.config.sample,
            "k": self.config.k,
            "tolerance": self.config.tolerance,
            "minSamples": self.config.min_samples,
            "captured": int(self._m_captures.value(result="captured")),
            "scored": int(self._m_captures.value(result="scored")),
            "dropped": int(self._m_captures.value(result="dropped")),
            "rungs": rungs,
            "scorecard": (
                self._detector.scorecard.summary()
                if self._detector.scorecard is not None
                else {"present": False,
                      "reason": self._detector.reporting_reason}),
        }

    def augment_quality(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Fold the recall verdict into a ``/quality.json`` document as
        the gate's third reason.

        With ``PIO_RECALL=off`` the document passes through UNTOUCHED
        (the kill switch can never block a promotion).  With the quality
        layer itself off but recall on, a minimal gate-bearing document
        is synthesized so the refresh daemon's canary watch and the
        fleet rollout bake (both read only ``gate.rollback``) stay
        live."""
        if not self.enabled:
            return doc
        recall = self.payload()
        gates = (recall["tripped"] and not recall["reportingOnly"]
                 and self.config.gate)
        if not isinstance(doc, dict) or not doc.get("enabled"):
            return {
                "enabled": True,
                "qualityLayerEnabled": False,
                "generation": recall["generation"],
                "verdict": recall["verdict"],
                "gate": {"enabled": self.config.gate,
                         "rollback": gates,
                         "reasons": (["recall_regression"] if gates
                                     else [])},
                "recall": recall,
            }
        out = dict(doc)
        out["recall"] = recall
        gate = dict(out.get("gate") or {})
        reasons = list(gate.get("reasons") or ())
        if gates:
            if "recall_regression" not in reasons:
                reasons.append("recall_regression")
            gate["rollback"] = True
            out["verdict"] = "degraded"
        gate["reasons"] = reasons
        out["gate"] = gate
        return out

    def close(self) -> None:
        if not self.enabled:
            return
        with self._cond:
            self._closed = True
            self._queue.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
