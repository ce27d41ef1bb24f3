"""Online learning: the event→model refresh loop.

Port of ``predictionio_tpu/refresh/__init__.py``:

- **Delta warm start** — ``run_train(warm_from=...)`` restores the last
  COMPLETED generation's carried state and continues training on only
  the delta window of events, anchored by the **data watermark** every
  train run records on its EngineInstance
  (``workflow.core_workflow.data_watermark``): the next refresh reads
  ``[previous watermark, new watermark)``, so windows never gap or
  overlap.  An algorithm that cannot continue raises
  :class:`~predictionio_tpu_torch.controller.WarmStartFallback` and the
  run retrains fully — a cycle always lands a generation.  ALS
  continues with host ridge sweeps over the delta-touched rows
  (``templates/recommendation``).
- **Refresh daemon** (:mod:`predictionio_tpu_torch.refresh.daemon`) —
  ``pio train --follow`` retrains on a cadence and promotes ONLY
  through the engine server's staged-reload gate (``POST /reload``),
  rolling back over ``POST /admin/rollback`` when the canary window
  trips.

Instruments (the reference's names):

====================================  ==================================
``pio_refresh_runs_total{result}``    refresh cycles by outcome
                                      (warm / full / full_fallback /
                                      failed)
``pio_refresh_promotions_total        staged-reload promotions by
{result}``                            outcome (promoted / rolled_back /
                                      rejected / error)
``pio_refresh_staleness_s``           event→servable staleness: ingest
                                      high-watermark minus the served
                                      generation's data watermark
``pio_refresh_train_s{mode}``         wall seconds of the last refresh
                                      train by mode
``pio_refresh_triggers_total          trigger-mode firings by reason
{reason}``
====================================  ==================================

Env knobs (all read by :meth:`RefreshConfig.from_env`; the same names
and defaults as the reference):

====================================  ==================================
``PIO_REFRESH_INTERVAL_S``            follow-mode cadence (default 300)
``PIO_REFRESH_MAX_DELTA_FRACTION``    delta/corpus ratio above which a
                                      warm start falls back to a full
                                      retrain (default 0.5)
``PIO_REFRESH_EVAL_TOLERANCE``        allowed relative regression of the
                                      warm-started model on the delta
                                      sample before falling back (0.1)
``PIO_REFRESH_PROMOTE_URL``           engine-server base URL promotions
                                      go through (unset = train only)
``PIO_REFRESH_CANARY_WINDOW_S``       post-promotion watch window
                                      (default 60; 0 = no watch)
``PIO_REFRESH_CANARY_POLL_S``         poll cadence in the window (2)
``PIO_REFRESH_TRIGGER_STALENESS_S``   trigger mode: fire at this
                                      staleness (unset = off)
``PIO_REFRESH_TRIGGER_DELTA_COUNT``   trigger mode: fire after this many
                                      events past the served watermark
``PIO_REFRESH_TRIGGER_POLL_S``        trigger poll cadence (5)
====================================  ==================================
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os
from typing import Any, List, Optional

from predictionio_tpu_torch.controller import WarmStartFallback
from predictionio_tpu_torch.data.storage.base import EngineInstance, epoch_us
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.workflow.core_workflow import (
    DATA_WATERMARK_KEY,
    data_watermark,
)

__all__ = [
    "RefreshConfig",
    "WarmStartContext",
    "WarmStartFallback",
    "RefreshMetrics",
    "staleness_s",
    "data_watermark",
    "DATA_WATERMARK_KEY",
]


def _env_f(key: str, default: float) -> float:
    raw = os.environ.get(key)
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


def _env_opt_f(key: str) -> Optional[float]:
    raw = os.environ.get(key)
    if raw is None or str(raw).strip() == "":
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


@dataclasses.dataclass
class RefreshConfig:
    """Refresh-loop knobs; :meth:`from_env` is the production
    constructor (CLI flags override, same pattern as SchedulerConfig).

    Trigger mode: with either ``trigger_staleness_s`` or
    ``trigger_delta_count`` set, the daemon fires a cycle when the
    event→servable staleness or the count of events ingested past the
    served watermark crosses its threshold — the freshness gauges become
    actuators — polling every ``trigger_poll_s``, with the fixed
    ``interval_s`` cadence kept as a backstop ceiling between cycles."""

    interval_s: float = 300.0
    max_delta_fraction: float = 0.5
    eval_tolerance: float = 0.1
    promote_url: Optional[str] = None
    canary_window_s: float = 60.0
    canary_poll_s: float = 2.0
    trigger_staleness_s: Optional[float] = None
    trigger_delta_count: Optional[int] = None
    trigger_poll_s: float = 5.0

    @classmethod
    def from_env(cls, **overrides) -> "RefreshConfig":
        delta_n = _env_opt_f("PIO_REFRESH_TRIGGER_DELTA_COUNT")
        cfg = cls(
            interval_s=_env_f("PIO_REFRESH_INTERVAL_S", 300.0),
            max_delta_fraction=_env_f("PIO_REFRESH_MAX_DELTA_FRACTION", 0.5),
            eval_tolerance=_env_f("PIO_REFRESH_EVAL_TOLERANCE", 0.1),
            promote_url=(os.environ.get("PIO_REFRESH_PROMOTE_URL") or None),
            canary_window_s=_env_f("PIO_REFRESH_CANARY_WINDOW_S", 60.0),
            canary_poll_s=_env_f("PIO_REFRESH_CANARY_POLL_S", 2.0),
            trigger_staleness_s=_env_opt_f(
                "PIO_REFRESH_TRIGGER_STALENESS_S"),
            trigger_delta_count=(int(delta_n) if delta_n is not None
                                 else None),
            trigger_poll_s=_env_f("PIO_REFRESH_TRIGGER_POLL_S", 5.0),
        )
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg


@dataclasses.dataclass
class WarmStartContext:
    """Everything a warm (delta) train run needs about its parent
    generation.  ``models`` aligns with the engine's algorithm list —
    ``Algorithm.warm_start`` receives its own previous model."""

    instance: EngineInstance
    models: List[Any]
    start_time: _dt.datetime            # parent's data watermark
    max_delta_fraction: float = 0.5
    eval_tolerance: float = 0.1


def staleness_s(latest_event_time: Optional[_dt.datetime],
                serving_watermark: Optional[_dt.datetime]) -> Optional[float]:
    """Event→servable staleness: how far the ingest high-watermark runs
    ahead of the serving generation's data watermark.  None when either
    side is unknown (no events yet / an instance without one); floored at
    0 — a watermark past the newest event means everything ingested is
    already servable."""
    if latest_event_time is None or serving_watermark is None:
        return None
    return max(
        0.0,
        (epoch_us(latest_event_time) - epoch_us(serving_watermark)) / 1e6)


class RefreshMetrics:
    """The refresh loop's instruments over the shared registry."""

    def __init__(self, registry=None):
        reg = registry or get_registry()
        self.runs = reg.counter(
            "pio_refresh_runs_total",
            "Refresh train cycles by outcome (warm/full/full_fallback/"
            "failed).", ("result",))
        self.promotions = reg.counter(
            "pio_refresh_promotions_total",
            "Refresh promotions through the staged-reload gate by outcome.",
            ("result",))
        self.staleness = reg.gauge(
            "pio_refresh_staleness_s",
            "Event→servable staleness: ingest high-watermark minus the "
            "promoted generation's data watermark, seconds.")
        self.train_s = reg.gauge(
            "pio_refresh_train_s",
            "Wall seconds of the last refresh train run by mode.",
            ("mode",))
        self.triggers = reg.counter(
            "pio_refresh_triggers_total",
            "Trigger-mode refresh firings by reason (staleness / "
            "delta_count / interval).", ("reason",))
