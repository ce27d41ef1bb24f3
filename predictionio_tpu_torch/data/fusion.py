"""K-step fusion plan + the HBM-guided fusion/batch autotuner.

Port of ``predictionio_tpu/data/fusion.py``.  A fused window issues K
optimizer steps back to back with no host sync inside (the reference
runs them as one ``lax.scan`` program), over a K-batch superbatch staged
by :class:`~predictionio_tpu_torch.data.prefetch.DevicePrefetcher`; the
per-step dispatch/sync cadence is paid once per K steps.  This module
configures it and — in ``auto`` mode — tunes it:

- :func:`fuse_steps_config` reads ``PIO_FUSE_STEPS`` (``pio train
  --fuse-steps``): an integer pins the fusion depth (default 1, the
  per-step dispatch); ``auto`` starts at 1 and hands control to the
  autotuner.
- :class:`FusionPlan` is the mutable (fuse_steps, batch_scale) pair the
  prefetcher's prep thread snapshots per assembled window — the
  autotuner retargets it between windows without stopping the stream.
- :class:`FusionAutotuner` grows fusion depth (and, with
  ``PIO_BATCH_AUTOSCALE=on`` / ``pio train --batch-autoscale``, the
  effective batch size — K consecutive prepped batches concatenated into
  one wider step, an opt-in that trades reproducible semantics for
  throughput) every ``round_windows`` dispatches until the HBM headroom
  guardrail (``PIO_HBM_WARN_FRACTION`` of the card's memory, via
  :class:`~predictionio_tpu_torch.obs.runtime.DeviceMemorySampler`)
  pushes back, then backs off ONE notch and pins.  On the CPU, which
  reports no limit, the guardrail cannot push back, so growth stops at
  ``PIO_FUSE_STEPS_MAX`` (default 32).

Each decision also lands in the trace ring as the reference's
``train.fusion_autotune`` event (``action`` backoff_pin, grow_fuse,
grow_batch or cap_pin).
"""


from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Tuple

from predictionio_tpu_torch.obs.runtime import publish_event

logger = logging.getLogger(__name__)

__all__ = [
    "FusionPlan",
    "FusionAutotuner",
    "fuse_steps_config",
    "fuse_steps_max",
    "batch_autoscale_enabled",
    "slot_steps",
    "crossed_save_point",
]

DEFAULT_MAX_FUSE_STEPS = 32
DEFAULT_MAX_BATCH_SCALE = 8
DEFAULT_ROUND_WINDOWS = 4


def fuse_steps_config(
        value: Optional[object] = None, default: int = 1) -> Tuple[int, bool]:
    """Resolve the fusion depth: ``(fuse_steps, auto)``.

    ``value`` overrides the environment (the models' ``train()`` keyword,
    tests); otherwise ``PIO_FUSE_STEPS`` is read.  ``"auto"`` yields
    ``(1, True)`` — start unfused, let the autotuner grow.
    """
    if value is None:
        value = os.environ.get("PIO_FUSE_STEPS", "")
    text = str(value).strip().lower()
    if text == "auto":
        return 1, True
    try:
        k = int(text) if text else int(default)
    except ValueError:
        k = int(default)
    return max(k, 1), False


def fuse_steps_max(default: int = DEFAULT_MAX_FUSE_STEPS) -> int:
    """``PIO_FUSE_STEPS_MAX``: autotune growth ceiling (min 1)."""
    try:
        k = int(os.environ.get("PIO_FUSE_STEPS_MAX", str(default)))
    except ValueError:
        k = default
    return max(k, 1)


def batch_autoscale_enabled() -> bool:
    """``PIO_BATCH_AUTOSCALE``: let the autotuner also widen the
    effective batch (concatenate consecutive prepped batches) once
    fusion depth is capped.  Opt-in: fewer, wider optimizer steps are a
    semantics change, not a scheduling change."""
    return os.environ.get("PIO_BATCH_AUTOSCALE", "").strip().lower() in (
        "1", "on", "true", "yes")


def slot_steps(batch) -> list:
    """Global step number of each scan slot of a prefetched batch — the
    divergence guard's loss-vector → step mapping.  With batch scale M,
    slot j's step is the LAST raw batch it consumed."""
    k = max(int(getattr(batch, "k", 1)), 1)
    steps = max(int(getattr(batch, "steps", 1)), 1)
    m = steps // k
    first = batch.step - steps + 1
    return [first + (j + 1) * m - 1 for j in range(k)]


def crossed_save_point(step: int, steps: int, save_every: int) -> bool:
    """True when the window ending at ``step`` (covering ``steps`` raw
    steps) crossed a checkpoint-cadence point.  Reduces to
    ``step % save_every == 0`` for unfused steps; for fused windows the
    save lands on the window boundary just past the cadence point — a
    rollback target is therefore always a fusion boundary."""
    if save_every <= 0:
        return False
    return (step // save_every) > ((step - max(int(steps), 1)) // save_every)


class FusionPlan:
    """Thread-safe (fuse_steps, batch_scale) target.

    The prefetcher's prep thread snapshots the plan once per window
    (never mid-window — a window is assembled under one snapshot), the
    autotuner retargets it between windows."""

    def __init__(self, fuse_steps: int = 1, batch_scale: int = 1):
        self._lock = threading.Lock()
        self._k = max(int(fuse_steps), 1)
        self._m = max(int(batch_scale), 1)

    def get(self) -> Tuple[int, int]:
        with self._lock:
            return self._k, self._m

    def set(self, fuse_steps: Optional[int] = None,
            batch_scale: Optional[int] = None) -> None:
        with self._lock:
            if fuse_steps is not None:
                self._k = max(int(fuse_steps), 1)
            if batch_scale is not None:
                self._m = max(int(batch_scale), 1)

    @property
    def window_batches(self) -> int:
        """Raw prepped batches one window consumes (k * m)."""
        k, m = self.get()
        return k * m


class FusionAutotuner:
    """Grow fusion depth / batch scale until HBM headroom pushes back.

    Policy (one decision every ``round_windows`` dispatched windows):

    - headroom exceeded (train-run peak ``bytes_in_use`` above
      ``PIO_HBM_WARN_FRACTION`` of ``bytes_limit``) → back off ONE notch
      on whatever grew last and **pin** — the guardrail spoke, the
      previous setting is the ceiling;
    - otherwise grow: double ``fuse_steps`` up to ``max_fuse_steps``,
      then (only with batch autoscale enabled) double ``batch_scale`` up
      to ``max_batch_scale``, then pin at the cap.

    ``sampler`` is injectable (tests drive scripted headroom verdicts
    with no devices); the default resolves the process
    :class:`DeviceMemorySampler` lazily.
    """

    def __init__(self, model: str, plan: FusionPlan, *,
                 sampler=None,
                 round_windows: int = DEFAULT_ROUND_WINDOWS,
                 max_fuse_steps: Optional[int] = None,
                 batch_scale: Optional[bool] = None,
                 max_batch_scale: int = DEFAULT_MAX_BATCH_SCALE,
                 registry=None):
        self.model = model
        self.plan = plan
        self._sampler = sampler
        self.round_windows = max(int(round_windows), 1)
        self.max_fuse_steps = (fuse_steps_max() if max_fuse_steps is None
                               else max(int(max_fuse_steps), 1))
        self.batch_scale_enabled = (batch_autoscale_enabled()
                                    if batch_scale is None else bool(batch_scale))
        self.max_batch_scale = max(int(max_batch_scale), 1)
        self.pinned = False
        self._windows = 0
        self._registry = registry
        self._publish_gauges()

    # -- wiring --------------------------------------------------------------

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from predictionio_tpu_torch.obs.metrics import get_registry

        return get_registry()

    def _publish_gauges(self) -> None:
        k, m = self.plan.get()
        reg = self._reg()
        reg.gauge(
            "pio_train_fuse_steps",
            "Fused optimizer steps per dispatch (window depth).",
            ("model",)).set(k, model=self.model)
        reg.gauge(
            "pio_train_batch_scale",
            "Autoscaled batch multiplier (prepped batches concatenated "
            "per optimizer step).", ("model",)).set(m, model=self.model)

    def _headroom_exceeded(self) -> bool:
        sampler = self._sampler
        if sampler is None:
            from predictionio_tpu_torch.obs.runtime import get_memory_sampler

            sampler = self._sampler = get_memory_sampler()
        try:
            return bool(sampler.headroom_exceeded())
        except Exception:
            logger.debug("fusion autotune headroom probe failed",
                         exc_info=True)
            return False

    # -- the policy ----------------------------------------------------------

    def on_window(self) -> None:
        """One dispatched window observed; decide at round boundaries.

        The cadence counts DISPATCHES, deliberately unweighted by each
        window's step count: a K=1 tail flush still gave the sampler one
        settle-and-sample interval, which is what a round is for."""
        self._windows += 1
        if self.pinned or self._windows % self.round_windows:
            return
        self._decide()

    def _decide(self) -> None:
        k, m = self.plan.get()
        if self._headroom_exceeded():
            # Back off ONE notch on whatever grew last, and pin: the
            # guardrail names the ceiling, re-probing it each round
            # would thrash the allocator at its limit.
            if m > 1:
                m = max(m // 2, 1)
            elif k > 1:
                k = max(k // 2, 1)
            self.pinned = True
            logger.warning(
                "%s: HBM headroom guardrail pushed back — pinning fused "
                "training at fuse_steps=%d batch_scale=%d", self.model, k, m)
            publish_event("train.fusion_autotune", model=self.model,
                          fuseSteps=k, batchScale=m, action="backoff_pin")
        elif k < self.max_fuse_steps:
            k = min(k * 2, self.max_fuse_steps)
            logger.info("%s: fusion autotune grows to fuse_steps=%d",
                        self.model, k)
            publish_event("train.fusion_autotune", model=self.model,
                          fuseSteps=k, batchScale=m, action="grow_fuse")
        elif self.batch_scale_enabled and m < self.max_batch_scale:
            m = min(m * 2, self.max_batch_scale)
            logger.info("%s: fusion autotune grows to batch_scale=%d",
                        self.model, m)
            publish_event("train.fusion_autotune", model=self.model,
                          fuseSteps=k, batchScale=m, action="grow_batch")
        else:
            self.pinned = True
            logger.info(
                "%s: fusion autotune pinned at the growth cap "
                "(fuse_steps=%d batch_scale=%d) with HBM headroom to "
                "spare — a larger PIO_FUSE_STEPS_MAX (or batch size) "
                "may still help", self.model, k, m)
            publish_event("train.fusion_autotune", model=self.model,
                          fuseSteps=k, batchScale=m, action="cap_pin")
        self.plan.set(k, m)
        self._publish_gauges()
