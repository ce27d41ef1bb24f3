"""p99-targeted batch-window autotuner.

Port of ``predictionio_tpu/serving/autotune.py``.

The batch window is a latency/throughput dial with no single right
setting: too short and concurrent requests stop coalescing (throughput
collapses to one dispatch per request), too long and every request pays
the window as queueing delay.  The right setting moves with load, model
cost, and hardware — so it is tuned FROM THE SERVED LATENCY HISTOGRAM,
not configured.

Control law (AIMD, the same shape TCP uses for the same reason —
stability under feedback delay):

- observed p99 over the target → multiplicative back-off: halve the
  window; if the window is already at its floor, halve ``max_size``
  instead (a huge batch can blow the budget all by itself).
- observed p99 comfortably under the target (< ``grow_fraction`` of it)
  → additive growth: restore ``max_size`` first (doubling toward its
  configured cap — batching is nearly free when latency is healthy),
  then widen the window by ``window_step_s`` toward its cap.
- in the hysteresis band between: leave the knobs alone.

Retune runs every ``interval`` dispatches over a sliding sample ring, so
the estimate reflects the current load, not the process's whole life.
All decisions are visible: ``pio_batch_autotune_total{model,action}``
counts them and the batcher republishes its knob gauges on every change.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional

from predictionio_tpu_torch.obs import get_registry

__all__ = ["WindowAutotuner"]


def _quantile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class WindowAutotuner:
    """Adapts a :class:`~predictionio_tpu_torch.serving.batcher.MicroBatcher`'s
    ``window_s``/``max_size`` to hold served p99 at ``target_p99_ms``.

    ``observe`` is fed each member request's full served latency
    (admission → result, the number the client experiences); retuning
    happens on the batcher thread in ``after_dispatch`` so there is no
    extra timer thread to manage.
    """

    def __init__(
        self,
        model: str,
        target_p99_ms: float,
        *,
        window_min_s: float = 0.0,
        window_max_s: float = 0.020,
        window_step_s: float = 0.0005,
        max_size_cap: int = 64,
        interval: int = 32,
        sample_size: int = 512,
        grow_fraction: float = 0.6,
        saturation_streak: int = 3,
        registry=None,
    ):
        self.model = model
        self.target_p99_ms = float(target_p99_ms)
        self.window_min_s = float(window_min_s)
        self.window_max_s = float(window_max_s)
        self.window_step_s = float(window_step_s)
        self.max_size_cap = int(max_size_cap)
        self.interval = max(int(interval), 1)
        self.grow_fraction = float(grow_fraction)
        self._lock = threading.Lock()
        self._samples: Deque[float] = deque(maxlen=sample_size)
        self._since_retune = 0
        self.last_p99_ms: Optional[float] = None
        # Persistent-floor saturation detector: the "floor" action means
        # p99 is over target with the window already at its minimum AND
        # the dispatch itself fast — i.e. the backlog, not the batching,
        # is the latency.  A streak of them is the controller saying
        # "offered load > capacity" (ServingScheduler.saturated).
        self.saturation_streak = max(int(saturation_streak), 1)
        self._floor_streak = 0
        reg = registry or get_registry()
        self._m_actions = reg.counter(
            "pio_batch_autotune_total",
            "Autotuner decisions by action.", ("model", "action"))
        self._m_p99 = reg.gauge(
            "pio_batch_served_p99_ms",
            "Autotuner's sliding-window served-latency p99 estimate.",
            ("model",))
        self._m_saturated = reg.gauge(
            "pio_batch_saturated",
            "1 while the autotuner's persistent-floor detector reports "
            "offered load > capacity for this model lane.", ("model",))
        self._m_saturated.set(0, model=model)

    def observe(self, served_latency_ms: float) -> None:
        with self._lock:
            self._samples.append(float(served_latency_ms))

    def after_dispatch(self, batcher) -> None:
        with self._lock:
            self._since_retune += 1
            if self._since_retune < self.interval:
                return
            self._since_retune = 0
            samples = sorted(self._samples)
        if len(samples) < self.interval:
            return
        self.retune(batcher, _quantile(samples, 0.99))

    def saturated(self) -> bool:
        """Persistent-floor verdict: ≥ ``saturation_streak`` consecutive
        retunes ended in the ``floor`` action (nothing left to shrink,
        p99 still over target).  Any other action clears the streak —
        capacity returned or a knob still had room."""
        return self._floor_streak >= self.saturation_streak

    def _track_floor(self, action: str) -> None:
        self._floor_streak = (self._floor_streak + 1
                              if action == "floor" else 0)
        self._m_saturated.set(1 if self.saturated() else 0,
                              model=self.model)

    def retune(self, batcher, p99_ms: float) -> None:
        """One control step against an explicit p99 reading (tests call
        this directly; production arrives via :meth:`after_dispatch`)."""
        self.last_p99_ms = p99_ms
        self._m_p99.set(p99_ms, model=self.model)
        if p99_ms > self.target_p99_ms:
            if batcher.window_s > self.window_min_s:
                # Snap to the floor once halving drops below a tenth of
                # a millisecond — pure multiplicative decay would only
                # converge asymptotically, leaving the shrink_batch /
                # floor branches unreachable forever.
                new_w = batcher.window_s * 0.5
                if new_w < max(self.window_min_s, 1e-4):
                    new_w = self.window_min_s
                batcher.set_knobs(window_s=new_w)
                action = "shrink_window"
            elif (batcher.max_size > 1
                    and batcher._est_dispatch_s * 1e3
                    > 0.25 * self.target_p99_ms):
                # Shrink the batch only when the DISPATCH ITSELF is a
                # real slice of the budget.  Over-target with a fast
                # dispatch means backlog (offered load > capacity) —
                # shrinking the batch there cuts throughput and makes
                # the backlog, and the p99, strictly worse.
                batcher.set_knobs(max_size=max(batcher.max_size // 2, 1))
                action = "shrink_batch"
            else:
                action = "floor"
        elif p99_ms < self.grow_fraction * self.target_p99_ms:
            if batcher.max_size < self.max_size_cap:
                batcher.set_knobs(max_size=min(
                    batcher.max_size * 2, self.max_size_cap))
                action = "grow_batch"
            elif batcher.window_s < self.window_max_s:
                batcher.set_knobs(window_s=min(
                    batcher.window_s + self.window_step_s,
                    self.window_max_s))
                action = "grow_window"
            else:
                action = "ceiling"
        else:
            action = "hold"
        self._m_actions.inc(model=self.model, action=action)
        self._track_floor(action)
