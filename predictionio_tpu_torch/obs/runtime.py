"""Runtime introspection: trace-ring events, device-memory telemetry and
the per-step pipeline timeline ring.

Port of three pieces of ``predictionio_tpu/obs/runtime.py``:

- :func:`publish_event` — a zero-duration annotation in the trace ring
  (:mod:`predictionio_tpu_torch.obs.trace`): a child of the innermost
  open span, or a single-span trace of its own outside any trace.  The
  breaker, spill, supervision, fusion, feeder, reload and refresh events
  ride it under the reference's names.
- :class:`DeviceMemorySampler` polls the CUDA caching allocator
  (``torch.cuda.memory_stats``) and the card's totals
  (``torch.cuda.mem_get_info``) into ``pio_device_mem_bytes{device,kind}``
  gauges, with per-train-run peak tracking
  (``pio_device_mem_peak_bytes{device}``) and the HBM headroom guardrail
  (:meth:`~DeviceMemorySampler.headroom_exceeded`) that the fusion
  autotuner reads.  The kinds keep the reference's names where they mean
  the same: ``bytes_in_use`` (allocated tensors), ``peak_bytes_in_use``
  (the allocator's lifetime peak), ``bytes_limit`` (the card's total
  memory); the allocator's ``bytes_reserved`` and the card's
  ``bytes_free`` are the port's own.  A process that never touched CUDA
  samples no device, so sampling never initialises the card.  The
  reference falls back to a walk of ``jax.live_arrays()`` for backends
  whose allocator reports nothing (CPU); PyTorch keeps no registry of
  live tensors, so the port samples no CPU device: there the guardrail
  can never push back, as in the reference.
- :class:`StepTimeline` is the process-wide ring of per-step pipeline
  phase decompositions (host_wait / h2d / dispatch / device_wait /
  device_step, fed by :class:`~predictionio_tpu_torch.obs.pipeline.
  PipelineProbe`), exportable as Chrome-trace JSON.  Pure Python.

- :func:`start_runtime_introspection` — the servers' per-process
  bring-up: the sampler's instruments registered (so ``/metrics`` names
  them before the first sample), its thread started, one sample taken.

Left out on purpose: the XLA compile tracker (eager PyTorch compiles
nothing), so ``/metrics`` has no ``pio_xla_compile_*`` series.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from predictionio_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from predictionio_tpu_torch.obs.trace import (
    Span,
    TraceRecorder,
    current_span,
    current_trace_id,
    get_recorder,
    new_trace_id,
)

logger = logging.getLogger(__name__)

__all__ = [
    "publish_event",
    "DeviceMemorySampler",
    "get_memory_sampler",
    "StepTimeline",
    "get_timeline",
    "set_timeline",
    "reset_runtime",
    "start_runtime_introspection",
]


# -- trace-ring events -------------------------------------------------------

def publish_event(name: str, *, recorder: Optional[TraceRecorder] = None,
                  **attrs) -> None:
    """Publish a zero-duration annotation into the trace ring.

    Inside an active trace the event attaches as a child span of the
    innermost open span, so a request or a train that hit a breaker
    transition, a spill or a divergence carries the evidence in its own
    span tree.  Outside any trace it records as a standalone single-span
    trace, so the ring still shows runtime incidents with their wall
    time.
    """
    ev = Span(name, attrs)
    ev.duration_ms = 0.0
    parent = current_span()
    if parent is not None:
        parent.children.append(ev)
        return
    (recorder or get_recorder()).record(
        current_trace_id() or new_trace_id(), ev)


# -- device-memory telemetry -------------------------------------------------

def _default_devices() -> Sequence[Any]:
    """The process's CUDA devices, ONLY when CUDA is already initialised
    here (a process that never touched the card must not pay, or cause,
    a CUDA context for telemetry)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return ()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def cuda_memory_stats(device: Any) -> Dict[str, float]:
    """The sampler's kinds for one CUDA device: the caching allocator's
    current and lifetime-peak allocated bytes, its reserved bytes, and
    the card's free and total memory."""
    import torch

    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": float(stats.get("reserved_bytes.all.current", 0)),
        "bytes_free": float(free),
        "bytes_limit": float(total),
    }


class DeviceMemorySampler:
    """Background device-memory poller over the shared registry.

    Exports every kind of :func:`cuda_memory_stats` as
    ``pio_device_mem_bytes{device,kind}`` and tracks the peak
    ``bytes_in_use`` per device since the last :meth:`reset_peak`.
    ``devices_fn`` (devices with a ``memory_stats()`` method, or CUDA
    ``torch.device`` objects) and ``clock`` are injectable so tests
    sample fakes with no wall sleeps; the poll thread is started only via
    :meth:`start` and ticks every ``interval_s`` (env
    ``PIO_MEM_SAMPLE_INTERVAL_S``, default 10; <= 0 disables the thread,
    :meth:`sample_once` stays callable).
    """

    def __init__(self, interval_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 devices_fn: Callable[[], Sequence[Any]] = _default_devices,
                 clock: Callable[[], float] = time.monotonic):
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get("PIO_MEM_SAMPLE_INTERVAL_S", "10"))
            except ValueError:
                interval_s = 10.0
        self.interval_s = float(interval_s)
        self._registry = registry
        self._devices_fn = devices_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._peaks: Dict[str, float] = {}
        self._peak_since: float = clock()
        # HBM headroom guardrail: one warning per device per peak window.
        self._hbm_warned: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reg(self) -> MetricsRegistry:
        return self._registry or get_registry()

    @staticmethod
    def _warn_fraction() -> float:
        """``PIO_HBM_WARN_FRACTION`` (default 0.9): warn when a train
        run's peak ``bytes_in_use`` exceeds this fraction of the device
        ``bytes_limit``.  <= 0 disables the check."""
        try:
            return float(os.environ.get("PIO_HBM_WARN_FRACTION", "0.9"))
        except ValueError:
            return 0.9

    def _headroom_counter(self):
        return self._reg().counter(
            "pio_hbm_headroom_warn_total",
            "Times a train-run memory peak crossed the HBM headroom "
            "warning fraction (PIO_HBM_WARN_FRACTION of bytes_limit).",
            ("device",))

    def _gauges(self):
        reg = self._reg()
        return (reg.gauge(
            "pio_device_mem_bytes",
            "Device memory by device and kind (CUDA allocator and card "
            "totals).",
            ("device", "kind")),
            reg.gauge(
            "pio_device_mem_peak_bytes",
            "Peak bytes_in_use per device since the last peak reset.",
            ("device",)))

    def touch(self) -> None:
        self._gauges()
        self._headroom_counter()

    @staticmethod
    def _label(device: Any) -> str:
        kind = getattr(device, "type", None) \
            or getattr(device, "platform", "dev")
        index = getattr(device, "index", None)
        if index is None:
            index = getattr(device, "id", 0)
        return f"{kind}:{index or 0}"

    @staticmethod
    def _stats(device: Any) -> Optional[Dict[str, Any]]:
        if callable(getattr(device, "memory_stats", None)):
            return device.memory_stats()
        if getattr(device, "type", None) == "cuda":
            return cuda_memory_stats(device)
        return None

    def sample_once(self) -> Dict[str, Dict[str, float]]:
        """Poll every device once; returns {device: {kind: value}}."""
        gauge, peak_gauge = self._gauges()
        out: Dict[str, Dict[str, float]] = {}
        try:
            devices = list(self._devices_fn())
        except Exception:
            logger.debug("device enumeration failed", exc_info=True)
            return out
        for d in devices:
            label = self._label(d)
            try:
                stats = self._stats(d)
            except Exception:
                stats = None
            row: Dict[str, float] = {}
            for k, v in (stats or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    gauge.set(float(v), device=label, kind=str(k))
                    row[str(k)] = float(v)
            if row:
                out[label] = row
        frac = self._warn_fraction()
        warn: List[tuple] = []
        with self._lock:
            for label, row in out.items():
                in_use = row.get("bytes_in_use")
                if in_use is None:
                    continue
                # The window is the max of OUR samples, not the
                # allocator's lifetime peak (which reset_peak cannot
                # clear); the lifetime peak stays visible as its kind.
                peak = max(self._peaks.get(label, 0.0), in_use)
                self._peaks[label] = peak
                peak_gauge.set(peak, device=label)
                limit = row.get("bytes_limit")
                if (frac > 0 and limit and peak > frac * limit
                        and label not in self._hbm_warned):
                    self._hbm_warned.add(label)
                    warn.append((label, peak, limit))
        for label, peak, limit in warn:
            self._headroom_counter().inc(device=label)
            logger.warning(
                "HBM headroom: device %s train-run peak %.0f MiB is "
                "%.1f%% of its %.0f MiB limit (warn fraction %.2f, "
                "PIO_HBM_WARN_FRACTION) — reduce PIO_PREFETCH_DEPTH, "
                "the batch size, or the model footprint before the "
                "allocator OOMs",
                label, peak / 2**20, 100.0 * peak / limit,
                limit / 2**20, frac)
        return out

    def peaks(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._peaks)

    def headroom_exceeded(self, fraction: Optional[float] = None) -> bool:
        """Train-run PEAK ``bytes_in_use`` (since ``reset_peak``, folded
        with one fresh sample) against the guardrail: True when any
        device's peak crosses ``fraction`` (default
        ``PIO_HBM_WARN_FRACTION``) of its ``bytes_limit``.  The fusion
        autotuner decides at round boundaries, in the trough between
        windows, so the peak the sampler saw — not the instantaneous
        sample — is what it must compare.  Devices reporting no limit
        can never push back and return False."""
        frac = self._warn_fraction() if fraction is None else float(fraction)
        if frac <= 0:
            return False
        rows = self.sample_once()  # also folds this sample into _peaks
        with self._lock:
            peaks = dict(self._peaks)
        for label, row in rows.items():
            in_use = row.get("bytes_in_use")
            limit = row.get("bytes_limit")
            peak = max(in_use or 0.0, peaks.get(label, 0.0))
            if peak and limit and peak > frac * limit:
                return True
        return False

    def reset_peak(self) -> None:
        """Start a fresh peak window."""
        with self._lock:
            self._peaks.clear()
            self._hbm_warned.clear()
            self._peak_since = self._clock()

    # -- background thread --------------------------------------------------

    def start(self) -> bool:
        """Start the poll thread (idempotent); False when disabled."""
        if self.interval_s <= 0:
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pio-mem-sampler", daemon=True)
            self._thread.start()
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                logger.exception("device-memory sample failed")

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None


_memory_sampler = DeviceMemorySampler()


def get_memory_sampler() -> DeviceMemorySampler:
    """THE process device-memory sampler."""
    return _memory_sampler


# -- step timeline ring ------------------------------------------------------

class StepTimeline:
    """Ring of per-step pipeline phase decompositions, per model.

    Each record is one training dispatch's wall decomposition as
    measured by ``PipelineProbe`` (host_wait → h2d → dispatch →
    device_wait on the host lane; device_step on the device lane).
    Exportable as Chrome-trace JSON.  Ring size: ``PIO_TIMELINE_RING``
    (records, default 2048).
    """

    PHASES = ("host_wait", "h2d", "h2d_overlap", "dispatch",
              "device_wait", "device_step")
    # Host-lane phases whose sum approximates the iteration's wall time.
    # h2d_overlap is NOT here: prefetched staging runs under device
    # compute and costs the step loop nothing.
    WALL_PHASES = ("host_wait", "h2d", "dispatch", "device_wait")

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("PIO_TIMELINE_RING", "2048"))
            except ValueError:
                capacity = 2048
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))
        self._seq = 0

    def record(self, model: str, *, host_wait_ms: float = 0.0,
               h2d_ms: float = 0.0, h2d_overlap_ms: float = 0.0,
               dispatch_ms: float = 0.0,
               device_wait_ms: float = 0.0,
               device_step_ms: float = 0.0, examples: int = 0,
               start_s: Optional[float] = None,
               dispatch_s: Optional[float] = None,
               staged_s: Optional[float] = None,
               step: Optional[int] = None,
               fused_steps: int = 1) -> None:
        if start_s is None:
            start_s = time.time()
        rec = {
            "model": model,
            "startS": round(float(start_s), 6),
            "hostWaitMs": round(float(host_wait_ms), 4),
            "h2dMs": round(float(h2d_ms), 4),
            "h2dOverlapMs": round(float(h2d_overlap_ms), 4),
            "dispatchMs": round(float(dispatch_ms), 4),
            "deviceWaitMs": round(float(device_wait_ms), 4),
            "deviceStepMs": round(float(device_step_ms), 4),
            "examples": int(examples),
            # Optimizer steps this ONE record (= one dispatch) covers.
            "fusedSteps": max(int(fused_steps), 1),
        }
        if dispatch_s is not None:
            rec["dispatchS"] = round(float(dispatch_s), 6)
        if staged_s is not None:
            rec["stagedS"] = round(float(staged_s), 6)
        with self._lock:
            self._seq += 1
            rec["step"] = int(step if step is not None else self._seq)
            self._ring.append(rec)

    def recent(self, n: int = 256,
               model: Optional[str] = None) -> List[Dict[str, Any]]:
        """Last ``n`` records, most recent first (optionally one model)."""
        with self._lock:
            items = list(self._ring)
        if model is not None:
            items = [r for r in items if r["model"] == model]
        return items[::-1][:max(n, 0)]

    def models(self) -> List[str]:
        with self._lock:
            return sorted({r["model"] for r in self._ring})

    def summary(self, model: Optional[str] = None) -> Dict[str, Any]:
        """Aggregate phase totals and shares: ``phase_share`` is each
        host-lane phase's share of the summed host-lane wall."""
        with self._lock:
            items = [r for r in self._ring
                     if model is None or r["model"] == model]
        totals = {p: 0.0 for p in self.PHASES}
        examples = 0
        steps = 0
        for r in items:
            totals["host_wait"] += r["hostWaitMs"]
            totals["h2d"] += r["h2dMs"]
            totals["h2d_overlap"] += r.get("h2dOverlapMs", 0.0)
            totals["dispatch"] += r.get("dispatchMs", 0.0)
            totals["device_wait"] += r["deviceWaitMs"]
            totals["device_step"] += r["deviceStepMs"]
            examples += r["examples"]
            steps += max(int(r.get("fusedSteps", 1)), 1)
        wall = sum(totals[p] for p in self.WALL_PHASES)
        shares = {p: (totals[p] / wall if wall > 0 else 0.0)
                  for p in self.WALL_PHASES}
        return {
            "model": model,
            "steps": steps,
            "dispatches": len(items),
            "fuse_steps": round(steps / len(items), 2) if items else 0.0,
            "examples": examples,
            "phase_ms": {p: round(v, 3) for p, v in totals.items()},
            "phase_share": {p: round(v, 4) for p, v in shares.items()},
        }

    def to_chrome_trace(self, n: int = 2048,
                        model: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace-format export: host-lane phases laid out from each
        step's start, the device step from its dispatch stamp, the
        prefetched staging on a third lane ending when the batch left
        the prep thread."""
        records = self.recent(n, model=model)[::-1]  # chronological
        pids = {m: i + 1 for i, m in
                enumerate(sorted({r["model"] for r in records}))}
        has_prefetch = {r["model"] for r in records
                        if r.get("h2dOverlapMs", 0) > 0}
        events: List[Dict[str, Any]] = []
        for m, pid in pids.items():
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": m}})
            lanes = [(0, "host"), (1, "device")]
            if m in has_prefetch:
                lanes.append((2, "prefetch"))
            for tid, lane in lanes:
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "args": {"name": lane}})
        for r in records:
            pid = pids[r["model"]]
            ts = r["startS"] * 1e6
            for key, name in (("hostWaitMs", "host_wait"),
                              ("h2dMs", "h2d"),
                              ("dispatchMs", "dispatch"),
                              ("deviceWaitMs", "device_wait")):
                dur = r.get(key, 0.0) * 1e3
                if dur <= 0:
                    continue
                events.append({"name": name, "ph": "X", "pid": pid,
                               "tid": 0, "ts": round(ts, 3),
                               "dur": round(dur, 3),
                               "args": {"step": r["step"]}})
                ts += dur
            if r["deviceStepMs"] > 0:
                dev_ts = r.get("dispatchS", r["startS"]) * 1e6
                events.append({"name": "device_step", "ph": "X", "pid": pid,
                               "tid": 1, "ts": round(dev_ts, 3),
                               "dur": round(r["deviceStepMs"] * 1e3, 3),
                               "args": {"step": r["step"],
                                        "examples": r["examples"]}})
            overlap = r.get("h2dOverlapMs", 0.0)
            if overlap > 0:
                dur = overlap * 1e3
                end = r.get("stagedS")
                if end is None:
                    end = r["startS"] + r["hostWaitMs"] / 1e3
                events.append({"name": "h2d_overlap", "ph": "X", "pid": pid,
                               "tid": 2, "ts": round(end * 1e6 - dur, 3),
                               "dur": round(dur, 3),
                               "args": {"step": r["step"]}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0


_timeline = StepTimeline()
_timeline_lock = threading.Lock()


def get_timeline() -> StepTimeline:
    """THE process step-timeline ring (the probe writes it)."""
    return _timeline


def set_timeline(timeline: StepTimeline) -> StepTimeline:
    """Swap the process timeline (tests); returns the previous one."""
    global _timeline
    with _timeline_lock:
        prev, _timeline = _timeline, timeline
    return prev


def reset_runtime() -> None:
    """Test isolation: empty timeline + fresh peak window."""
    get_timeline().clear()
    get_memory_sampler().reset_peak()


# -- process wiring ----------------------------------------------------------

def start_runtime_introspection(*, sample: bool = True) -> None:
    """Idempotent per-process bring-up, called by the servers: register
    the memory instruments (so ``/metrics`` exposes the names before the
    first sample) and start the memory-sampler thread.  The reference
    also registers its XLA compile tracker here; the port has none."""
    sampler = get_memory_sampler()
    sampler.touch()
    sampler.start()
    if sample:
        try:
            sampler.sample_once()
        except Exception:
            logger.debug("initial device-memory sample failed",
                         exc_info=True)
