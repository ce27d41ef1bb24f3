"""Serving scheduler: continuous micro-batching + admission control.

Port of ``predictionio_tpu/serving/__init__.py``.  The engine server's
``/queries.json`` handler never reaches the model directly — every query
is ADMITTED into a bounded per-model queue (full → 429 +
``Retry-After``), COALESCED by a deadline-aware micro-batcher into one
vectorized ``batch_predict`` dispatch per window (on the card: one launch
of the top-k kernel at B = cohort size), and its window is AUTOTUNED
against a served-latency p99 target.

Layout:

- :mod:`predictionio_tpu_torch.serving.queue` — admission queue, request
  lifecycle, injectable clock.
- :mod:`predictionio_tpu_torch.serving.batcher` — the micro-batcher loop
  (window policy, deadline sheds, generation-atomic dispatch).
- :mod:`predictionio_tpu_torch.serving.autotune` — the p99-targeted AIMD
  window/batch-size controller.
- :mod:`predictionio_tpu_torch.serving.result_cache` — the
  generation-keyed result cache the handler consults around the
  scheduler.
- :class:`ServingScheduler` (here) — the facade the engine server talks
  to: ``register`` a model's dispatch fn, ``submit_and_wait`` per
  request, ``snapshot`` for the status page, ``close`` on shutdown.  The
  generation that answered a request rides its latency waterfall
  (:mod:`predictionio_tpu_torch.obs.waterfall`), stamped by the batcher.

Env knobs (all read at server construction; ``pio deploy`` flags
override):

====================================  =====================================
``PIO_BATCH_ENABLED``                 batcher on/off (default on; off =
                                      inline per-request dispatch, still
                                      admission-controlled)
``PIO_QUEUE_DEPTH``                   per-model admission limit (128)
``PIO_BATCH_WINDOW_MS``               initial gather window (2.0)
``PIO_BATCH_WINDOW_MAX_MS``           autotuner window cap (20.0)
``PIO_BATCH_MAX``                     max queries per dispatch (64)
``PIO_BATCH_AUTOTUNE``                autotuner on/off (default on)
``PIO_BATCH_P99_TARGET_MS``           served-latency p99 target (100)
``PIO_QUEUE_WAIT_MAX_S``              stall backstop for a pending
                                      request with no deadline (30)
====================================  =====================================
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.config import env_bool as _truthy
from predictionio_tpu_torch.obs import current_span, get_registry
from predictionio_tpu_torch.obs.waterfall import current_waterfall
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.serving.autotune import WindowAutotuner
from predictionio_tpu_torch.serving.batcher import MicroBatcher
from predictionio_tpu_torch.serving.queue import (
    Clock,
    ModelQueue,
    MonotonicClock,
    Pending,
    QueueFull,
    SchedulerClosed,
    SchedulerStalled,
)
from predictionio_tpu_torch.serving.result_cache import (
    CacheHit,
    ResultCache,
    ResultCacheConfig,
    canonical_query,
)

__all__ = [
    "SchedulerConfig",
    "ServingScheduler",
    "ResultCache",
    "ResultCacheConfig",
    "CacheHit",
    "canonical_query",
    "MicroBatcher",
    "WindowAutotuner",
    "ModelQueue",
    "Pending",
    "Clock",
    "MonotonicClock",
    "QueueFull",
    "SchedulerClosed",
    "SchedulerStalled",
]


@dataclasses.dataclass
class SchedulerConfig:
    """Scheduler knobs; :meth:`from_env` is the production constructor."""

    enabled: bool = True
    queue_depth: int = 128
    window_ms: float = 2.0
    window_max_ms: float = 20.0
    max_batch: int = 64
    autotune: bool = True
    p99_target_ms: float = 100.0
    stall_s: float = 30.0

    @classmethod
    def from_env(cls, env=None, **overrides) -> "SchedulerConfig":
        """The ``PIO_BATCH_*`` / ``PIO_QUEUE_*`` knobs (an unparseable
        value reads as the default), then ``overrides`` that are not
        None (``pio deploy``'s flags)."""
        env = os.environ if env is None else env

        def _f(key, cast, default):
            raw = env.get(key)
            if raw is None or str(raw).strip() == "":
                return default
            try:
                return cast(raw)
            except (TypeError, ValueError):
                return default

        cfg = cls(
            enabled=_truthy(env.get("PIO_BATCH_ENABLED"), True),
            queue_depth=_f("PIO_QUEUE_DEPTH", int, 128),
            window_ms=_f("PIO_BATCH_WINDOW_MS", float, 2.0),
            window_max_ms=_f("PIO_BATCH_WINDOW_MAX_MS", float, 20.0),
            max_batch=_f("PIO_BATCH_MAX", int, 64),
            autotune=_truthy(env.get("PIO_BATCH_AUTOTUNE"), True),
            p99_target_ms=_f("PIO_BATCH_P99_TARGET_MS", float, 100.0),
            stall_s=_f("PIO_QUEUE_WAIT_MAX_S", float, 30.0),
        )
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg


class _ModelLane:
    """One registered model's queue + batcher + (optional) autotuner."""

    __slots__ = ("queue", "batcher", "autotuner", "inline_inflight",
                 "inline_lock")

    def __init__(self, queue: ModelQueue, batcher: MicroBatcher,
                 autotuner: Optional[WindowAutotuner]):
        self.queue = queue
        self.batcher = batcher
        self.autotuner = autotuner
        # Inline (batching-off) admission: concurrent in-flight count
        # against the same queue_depth limit.
        self.inline_inflight = 0
        self.inline_lock = threading.Lock()


class ServingScheduler:
    """Facade: admission → micro-batch → dispatch, per registered model.

    ``register(name, dispatch_fn)`` wires one model lane;
    ``dispatch_fn(queries) -> (results, generation)`` must snapshot its
    model set atomically (the engine server grabs everything under ONE
    swap-lock acquisition) so a batch can never span generations.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None,
                 clock: Optional[Clock] = None, registry=None):
        self.config = config or SchedulerConfig.from_env()
        self.clock = clock or MonotonicClock()
        self._registry = registry or get_registry()
        self._lanes: Dict[str, _ModelLane] = {}
        self._closed = False
        self._m_depth = self._registry.gauge(
            "pio_queue_depth", "Queued (admitted, undispatched) requests.",
            ("model",))
        self._m_rejected = self._registry.counter(
            "pio_queue_rejected_total",
            "Requests rejected at admission (HTTP 429).", ("model",))

    # -- wiring -------------------------------------------------------------

    def register(
        self,
        model: str,
        dispatch_fn: Callable[[List[Any]], Tuple[List[Any], int]],
    ) -> MicroBatcher:
        if model in self._lanes:
            raise ValueError(f"model {model!r} already registered")
        cfg = self.config
        queue = ModelQueue(
            model, cfg.queue_depth,
            on_depth=lambda n, _m=model: self._m_depth.set(n, model=_m))
        autotuner = None
        if cfg.autotune and cfg.enabled:
            autotuner = WindowAutotuner(
                model, cfg.p99_target_ms,
                window_max_s=cfg.window_max_ms / 1e3,
                max_size_cap=cfg.max_batch,
                registry=self._registry)
        batcher = MicroBatcher(
            model, queue, dispatch_fn,
            window_s=cfg.window_ms / 1e3,
            max_size=cfg.max_batch if cfg.enabled else 1,
            clock=self.clock, autotuner=autotuner,
            registry=self._registry)
        lane = _ModelLane(queue, batcher, autotuner)
        self._lanes[model] = lane
        if cfg.enabled:
            batcher.start()
        return batcher

    # -- the per-request path ----------------------------------------------

    def models(self) -> List[str]:
        """The registered model lanes, sorted."""
        return sorted(self._lanes)

    def submit_and_wait(self, model: str, query: Any) -> Any:
        """Admit one query and block until its batch answers (or sheds).
        The generation the dispatch served it from is stamped on the
        request's waterfall (``current_waterfall().attr("generation")``).

        Raises :class:`QueueFull` (→429), :class:`DeadlineExceeded`
        (→504), :class:`SchedulerStalled`/:class:`SchedulerClosed`
        (→503), or whatever the dispatch itself raised for this member
        (bind errors → 400 upstream).
        """
        if self._closed:
            raise SchedulerClosed("serving scheduler is shut down")
        try:
            lane = self._lanes[model]
        except KeyError:
            raise ValueError(f"unknown model {model!r}") from None
        now = self.clock.now()
        rem = _deadline.remaining_ms()
        deadline_s = now + rem / 1e3 if rem is not None else None
        # The request's stage collector rides the Pending hand-off so the
        # batcher thread can stamp queue_wait/batch_wait/dispatch/
        # retrieval (and the generation) onto it.
        pending = Pending(query, now, deadline_s, span=current_span(),
                          waterfall=current_waterfall())
        if not self.config.enabled:
            return self._submit_inline(model, lane, pending)
        try:
            lane.queue.put(pending)
        except QueueFull:
            self._m_rejected.inc(model=model)
            raise
        budget_s = None
        if deadline_s is not None:
            budget_s = max(deadline_s - self.clock.now(), 0.0)
        stall_s = self.config.stall_s
        timeout = stall_s if budget_s is None else min(budget_s, stall_s)
        if not pending.wait_done(timeout):
            pending.abandon()  # best effort; a claimed entry's result is
            # discarded — its deadline has passed either way.
            if budget_s is not None and budget_s <= stall_s:
                raise DeadlineExceeded(
                    "deadline expired awaiting batch dispatch "
                    f"({timeout * 1e3:.0f}ms budget)")
            raise SchedulerStalled(
                f"no dispatch within {stall_s:.0f}s — batcher wedged?")
        if pending.waterfall is not None:
            # resume: dispatch done → this thread actually running again
            # (event wake-up + GIL/thread contention).  Computed as the
            # admission→result wall minus the batcher-attributed stages,
            # ON THE SAME CLOCK the batcher stamped with — without it the
            # stage sum undershoots the server-attested wall under
            # concurrency.
            done = pending.waterfall.snapshot()
            resid = (self.clock.now() - now) * 1e3 - sum(
                done.get(s, 0.0)
                for s in ("queue_wait", "batch_wait", "dispatch"))
            if resid > 0:
                pending.waterfall.stamp("resume", resid)
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _submit_inline(self, model: str, lane: _ModelLane,
                       pending: Pending) -> Any:
        """Batching disabled: dispatch on the caller thread through the
        SAME batcher machinery (metrics, deadline shed), with the
        queue-depth limit enforced as an in-flight cap."""
        with lane.inline_lock:
            if lane.inline_inflight >= lane.queue.depth:
                self._m_rejected.inc(model=model)
                raise QueueFull(
                    f"model {model!r} at inline concurrency limit "
                    f"({lane.inline_inflight}/{lane.queue.depth})")
            lane.inline_inflight += 1
        try:
            lane.batcher.dispatch([pending])
        finally:
            with lane.inline_lock:
                lane.inline_inflight -= 1
        if pending.error is not None:
            raise pending.error
        return pending.result

    # -- introspection / lifecycle ------------------------------------------

    def saturated(self) -> bool:
        """Any model lane's autotuner reporting persistent-floor
        saturation (offered load > capacity) — the serving half of the
        SLO engine's /ready degradation signal."""
        return any(lane.autotuner is not None and lane.autotuner.saturated()
                   for lane in self._lanes.values())

    def snapshot(self) -> Dict[str, Any]:
        """Status-page view (``GET /`` / ``/stats.json``): per-model
        knobs, flow counters, shed reasons."""
        out: Dict[str, Any] = {}
        for name, lane in sorted(self._lanes.items()):
            b = lane.batcher
            dispatches = b._m_dispatches.value(model=name)
            requests = b._m_requests.value(model=name)
            shed = {k[1]: int(v) for k, v in b._m_shed.series().items()
                    if k[0] == name and v}
            out[name] = {
                "batching": self.config.enabled,
                "queueDepth": len(lane.queue),
                "queueLimit": lane.queue.depth,
                "windowMs": round(b.window_s * 1e3, 3),
                "maxBatch": b.max_size,
                "dispatches": int(dispatches),
                "requests": int(requests),
                "meanBatch": (round(requests / dispatches, 2)
                              if dispatches else None),
                "rejected": int(self._m_rejected.value(model=name)),
                "shed": shed,
                "p99TargetMs": (lane.autotuner.target_p99_ms
                                if lane.autotuner else None),
                "servedP99Ms": (round(lane.autotuner.last_p99_ms, 2)
                                if lane.autotuner
                                and lane.autotuner.last_p99_ms is not None
                                else None),
                "saturated": (lane.autotuner.saturated()
                              if lane.autotuner else False),
            }
        return out

    def close(self) -> None:
        self._closed = True
        for lane in self._lanes.values():
            lane.batcher.close()
