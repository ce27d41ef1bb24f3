"""Serving SLO engine: multi-window burn rates wired to ``/ready``.

Port of ``predictionio_tpu/obs/slo.py``, closing the rung "a saturation signal
from the autotuner ... wired to /ready so an LB can rotate a drowning
instance out instead of queueing into 429s".

Two objectives over the engine server's existing instruments:

- **availability** — fraction of ``/queries.json`` requests that
  succeeded (``pio_query_requests_total`` vs ``pio_query_errors_total``;
  the error counter deliberately includes 429/503/504 — under overload
  those ARE the user-visible failures an LB should react to).
- **latency** — fraction of requests answering within the target
  (``pio_query_latency_ms`` mass at/below ``latency_target_ms``, which
  defaults from ``PIO_BATCH_P99_TARGET_MS`` so the SLO and the batch
  autotuner chase the same number).

Burn rate = (bad fraction over a window) / (error budget).  Burn 1.0
spends the budget exactly at period end; the classic multi-window rule
trips only when BOTH a fast (~5m) and a slow (~1h) window burn hot — the
fast window proves it's still happening, the slow one that it's
sustained, so a single latency spike never flips readiness.

The degradation signal COMBINES burn with the serving autotuner's
persistent-floor saturation detector (``WindowAutotuner.saturated()``:
the controller pinned its window at the floor and keeps saying "floor" —
offered load exceeds capacity):

- sustained burn over both windows  → degraded (whatever the cause);
- saturation alone, SLO still met   → stay ready (the batcher is coping);
- saturation + fast window burning  → degraded immediately, without
  waiting for the slow window (the saturation detector supplies the
  "it's sustained" evidence the slow window otherwise provides).

Hysteresis is asymmetric: trip immediately, clear only after the trip
condition has been false for ``recovery_s`` on the SAME clock — a
drowning instance that sheds its queue the moment the LB rotates it out
must not flap straight back in.  ``PIO_READY_SLO=off`` is the operator
escape hatch: burn gauges keep exporting, ``/ready`` stops acting on
them.

Everything rides an injectable monotonic clock (tests drive hours of
burn in microseconds), and ticks are pulled lazily by ``/ready`` /
``/stats.json`` polls — no extra timer thread.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

import time

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.obs.metrics import get_registry

__all__ = ["SLOConfig", "SLOEngine"]


def _env_f(env, key: str, default: float) -> float:
    raw = env.get(key)
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass
class SLOConfig:
    """Objectives + burn policy; :meth:`from_env` is the production
    constructor (knobs documented in README's table)."""

    availability_objective: float = 0.999
    latency_objective: float = 0.99
    latency_target_ms: float = 100.0
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    burn_threshold: float = 14.4      # Google SRE fast-burn page point
    saturation_burn_min: float = 1.0  # fast burn needed WITH saturation
    min_requests: int = 10            # fast-window floor against flapping
    recovery_s: float = 60.0          # trip-condition-false dwell to clear
    ready_slo: bool = True            # PIO_READY_SLO escape hatch

    @classmethod
    def from_env(cls, env=None) -> "SLOConfig":
        env = os.environ if env is None else env
        return cls(
            availability_objective=min(max(_env_f(
                env, "PIO_SLO_AVAILABILITY", 0.999), 0.0), 0.999999),
            latency_objective=min(max(_env_f(
                env, "PIO_SLO_LATENCY_OBJECTIVE", 0.99), 0.0), 0.999999),
            latency_target_ms=_env_f(
                env, "PIO_SLO_LATENCY_TARGET_MS",
                _env_f(env, "PIO_BATCH_P99_TARGET_MS", 100.0)),
            fast_window_s=_env_f(env, "PIO_SLO_FAST_WINDOW_S", 300.0),
            slow_window_s=_env_f(env, "PIO_SLO_SLOW_WINDOW_S", 3600.0),
            burn_threshold=_env_f(env, "PIO_SLO_BURN_THRESHOLD", 14.4),
            min_requests=int(_env_f(env, "PIO_SLO_MIN_REQUESTS", 10)),
            recovery_s=_env_f(env, "PIO_SLO_RECOVERY_S", 60.0),
            ready_slo=env_bool(env.get("PIO_READY_SLO"), True),
        )


class _Snapshot:
    __slots__ = ("t", "total", "errors", "lat_total", "lat_good")

    def __init__(self, t, total, errors, lat_total, lat_good):
        self.t = t
        self.total = total
        self.errors = errors
        self.lat_total = lat_total
        self.lat_good = lat_good


class SLOEngine:
    """Windowed burn rates over the process registry + the readiness
    verdict.  ``saturation_fn`` is the autotuner's persistent-floor
    detector (None = never saturated)."""

    # Pull-driven tick coalescing: an LB polling /ready at 1 Hz must not
    # grow the snapshot ring once per poll.
    MIN_TICK_INTERVAL_S = 1.0

    def __init__(self, config: Optional[SLOConfig] = None, *,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 saturation_fn: Optional[Callable[[], bool]] = None):
        self.config = config or SLOConfig.from_env()
        self.registry = registry or get_registry()
        self.clock = clock
        self.saturation_fn = saturation_fn
        self._lock = threading.Lock()
        self._snaps: Deque[_Snapshot] = deque()
        self._last_tick: Optional[float] = None
        self._degraded = False
        self._degraded_since: Optional[float] = None
        self._clear_since: Optional[float] = None  # trip-false dwell start
        self._last: Dict[str, Any] = {}
        reg = self.registry
        self._g_burn = reg.gauge(
            "pio_slo_burn_rate",
            "Error-budget burn rate by objective and window "
            "(1.0 = budget spent exactly at period end).",
            ("slo", "window"))
        self._g_objective = reg.gauge(
            "pio_slo_objective", "Configured SLO objective.", ("slo",))
        self._g_target = reg.gauge(
            "pio_slo_latency_target_ms",
            "Latency SLO threshold (defaults from PIO_BATCH_P99_TARGET_MS).")
        self._g_degraded = reg.gauge(
            "pio_slo_degraded",
            "1 while the SLO/saturation signal holds /ready at 503.")
        self._g_saturated = reg.gauge(
            "pio_slo_saturated",
            "1 while the serving autotuner reports persistent-floor "
            "saturation (offered load > capacity).")
        self._g_objective.set(self.config.availability_objective,
                              slo="availability")
        self._g_objective.set(self.config.latency_objective, slo="latency")
        self._g_target.set(self.config.latency_target_ms)

    # -- sampling -----------------------------------------------------------

    def _sample(self, now: float) -> _Snapshot:
        reg = self.registry
        total = errors = lat_total = lat_good = 0.0
        c = reg.get("pio_query_requests_total")
        if c is not None:
            total = c.total()
        c = reg.get("pio_query_errors_total")
        if c is not None:
            errors = c.total()
        h = reg.get("pio_query_latency_ms")
        if h is not None:
            lat_total = float(h.count())
            lat_good = h.count_le(self.config.latency_target_ms)
        return _Snapshot(now, total, errors, lat_total, lat_good)

    def _window_burn(self, now: float,
                     window_s: float) -> Tuple[float, float, float]:
        """(availability_burn, latency_burn, requests) over the trailing
        window.  Caller holds the lock; the newest snapshot is current."""
        newest = self._snaps[-1]
        oldest = self._snaps[0]
        for s in self._snaps:
            if s.t >= now - window_s:
                break
            oldest = s
        d_total = max(newest.total - oldest.total, 0.0)
        d_err = max(newest.errors - oldest.errors, 0.0)
        d_lat = max(newest.lat_total - oldest.lat_total, 0.0)
        d_good = max(newest.lat_good - oldest.lat_good, 0.0)
        avail_bad = (d_err / d_total) if d_total else 0.0
        lat_bad = (max(d_lat - d_good, 0.0) / d_lat) if d_lat else 0.0
        avail_burn = avail_bad / max(
            1.0 - self.config.availability_objective, 1e-9)
        lat_burn = lat_bad / max(
            1.0 - self.config.latency_objective, 1e-9)
        return avail_burn, lat_burn, d_total

    # -- the engine ---------------------------------------------------------

    def tick(self, force: bool = False) -> Dict[str, Any]:
        """Sample, recompute burn/degradation, publish gauges.  Pulled by
        ``/ready`` and the stats views; coalesced to one real tick per
        :data:`MIN_TICK_INTERVAL_S` unless ``force``."""
        now = self.clock()
        with self._lock:
            if (not force and self._last_tick is not None
                    and now - self._last_tick < self.MIN_TICK_INTERVAL_S
                    and self._last):
                return dict(self._last)
            self._last_tick = now
            self._snaps.append(self._sample(now))
            horizon = now - self.config.slow_window_s - 60.0
            while len(self._snaps) > 2 and self._snaps[1].t <= horizon:
                self._snaps.popleft()
            fast_a, fast_l, fast_n = self._window_burn(
                now, self.config.fast_window_s)
            slow_a, slow_l, _ = self._window_burn(
                now, self.config.slow_window_s)
            fast = max(fast_a, fast_l)
            slow = max(slow_a, slow_l)
            saturated = bool(self.saturation_fn()) \
                if self.saturation_fn else False
            thr = self.config.burn_threshold
            enough = fast_n >= self.config.min_requests
            sustained_burn = enough and fast >= thr and slow >= thr
            saturated_burn = (saturated and enough
                              and fast >= self.config.saturation_burn_min)
            trip = sustained_burn or saturated_burn
            if trip:
                if not self._degraded:
                    self._degraded = True
                    self._degraded_since = now
                self._clear_since = None
            elif self._degraded:
                # Hysteresis: the trip condition must stay false for
                # recovery_s before readiness returns.
                if self._clear_since is None:
                    self._clear_since = now
                elif now - self._clear_since >= self.config.recovery_s:
                    self._degraded = False
                    self._degraded_since = None
                    self._clear_since = None
            reasons = []
            if sustained_burn:
                reasons.append("sustained_burn")
            if saturated_burn:
                reasons.append("saturation_with_burn")
            state = {
                "readySlo": self.config.ready_slo,
                "degraded": self._degraded,
                "degradedSinceS": (round(now - self._degraded_since, 1)
                                   if self._degraded_since is not None
                                   else None),
                "recoveringForS": (round(now - self._clear_since, 1)
                                   if self._clear_since is not None
                                   else None),
                "tripReasons": reasons,
                "saturated": saturated,
                "burn": {
                    "fast": {"availability": round(fast_a, 3),
                             "latency": round(fast_l, 3),
                             "requests": int(fast_n)},
                    "slow": {"availability": round(slow_a, 3),
                             "latency": round(slow_l, 3)},
                },
                "threshold": thr,
                "objectives": {
                    "availability": self.config.availability_objective,
                    "latency": self.config.latency_objective,
                    "latencyTargetMs": self.config.latency_target_ms,
                },
            }
            self._last = state
        self._g_burn.set(fast_a, slo="availability", window="fast")
        self._g_burn.set(fast_l, slo="latency", window="fast")
        self._g_burn.set(slow_a, slo="availability", window="slow")
        self._g_burn.set(slow_l, slo="latency", window="slow")
        self._g_degraded.set(1 if state["degraded"] else 0)
        self._g_saturated.set(1 if saturated else 0)
        return dict(state)

    def ready(self) -> Tuple[bool, Dict[str, Any]]:
        """The /ready verdict: (serving_ok, slo_state).  With
        ``PIO_READY_SLO=off`` the state still reports ``degraded`` but
        the verdict is always True."""
        state = self.tick()
        if not self.config.ready_slo:
            return True, state
        return not state["degraded"], state

    def snapshot(self) -> Dict[str, Any]:
        """Status-page / fleet view (same doc the last tick produced)."""
        return self.tick()
