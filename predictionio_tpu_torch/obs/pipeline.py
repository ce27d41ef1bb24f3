"""Training-pipeline probe: host-wait vs H2D vs device-step attribution.

Port of ``predictionio_tpu/obs/pipeline.py``.  Every training
iteration's wall time is decomposed into named, separately-plotted
components (the reference's ``pio_train_*`` series):

- ``host_wait``  — time blocked fetching the next batch (feeder / numpy)
- ``h2d``        — time converting + transferring the batch to device
- ``dispatch``   — time inside the step call itself.  Eager PyTorch
  queues the step's kernels on the card's stream and returns; on the
  CPU the execution itself lands here
- ``device_wait``— time the HOST then stalls on the previous dispatched
  step (the device-bound residual)
- ``device_step``— dispatch→ready duration of each step

The device measurements use a one-step lag so the probe never reduces
host/device overlap: after batch N+1 is staged, the loop must wait for
step N's output anyway, so blocking there and timing the block
attributes exactly the stall the pipeline already pays.  The wait is a
``torch.cuda.Event`` recorded on the stream of the dispatched outputs
right after the dispatch (the reference blocks with
``jax.block_until_ready``); outputs with no CUDA tensor (the CPU)
complete at dispatch, so their sync is a no-op wait.

With the prefetched input pipeline (``data/prefetch.py``) batch staging
runs on a background thread, so :meth:`PipelineProbe.iter_prefetched`
times only the queue wait as ``host_wait`` and attributes the staging
cost to the overlap window (``pio_train_h2d_overlap_ms`` + the
timeline's ``h2dOverlapMs``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Iterator, Optional

from predictionio_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from predictionio_tpu_torch.obs.runtime import StepTimeline, get_timeline

__all__ = ["PipelineProbe"]


class _Timed:
    """Context manager recording elapsed ms into a histogram (+gauge) and
    the probe's current-iteration scratch (for the timeline record)."""

    __slots__ = ("_hist", "_gauge", "_labels", "_t0", "_cur", "_key")

    def __init__(self, hist, gauge, labels, cur=None, key=None):
        self._hist = hist
        self._gauge = gauge
        self._labels = labels
        self._cur = cur
        self._key = key
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        self._hist.observe(ms, **self._labels)
        self._gauge.set(ms, **self._labels)
        if self._cur is not None:
            self._cur[self._key] = ms
        return False


def _sync_target(outputs: Any) -> Any:
    """Normalize dispatched outputs to nested lists of their leaves.

    The model states are plain dataclasses, so passed raw they are
    opaque leaves and the sync would find no tensor in them, zeroing
    out the device_wait attribution.  Walking dataclass fields (and
    containers, dicts included, and a sharded array's blocks) down to
    the real tensors makes the sync wait on what the dispatch actually
    produced."""
    if dataclasses.is_dataclass(outputs) and not isinstance(outputs, type):
        return [_sync_target(getattr(outputs, f.name))
                for f in dataclasses.fields(outputs)]
    if isinstance(outputs, dict):
        return [_sync_target(x) for x in outputs.values()]
    if isinstance(outputs, (list, tuple)):
        return [_sync_target(x) for x in outputs]
    if hasattr(outputs, "shards") and hasattr(outputs, "sharding"):
        return [t for t in outputs.shards if t is not None]
    return outputs


def _cuda_devices(target: Any, found: set) -> set:
    """The CUDA devices of every tensor in a :func:`_sync_target` tree."""
    if isinstance(target, list):
        for x in target:
            _cuda_devices(x, found)
    elif getattr(getattr(target, "device", None), "type", None) == "cuda":
        found.add(target.device)
    return found


class _DispatchMark:
    """What :meth:`PipelineProbe.sync` waits on: one CUDA event recorded
    on the current stream of each device the dispatched outputs live on,
    right after the dispatch.  Outputs with no CUDA tensor record
    nothing and their wait returns at once."""

    __slots__ = ("events",)

    def __init__(self, outputs: Any):
        self.events = []
        devices = _cuda_devices(_sync_target(outputs), set())
        if devices:
            import torch

            for dev in devices:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self.events.append(ev)

    def wait(self) -> None:
        for ev in self.events:
            ev.synchronize()


class PipelineProbe:
    """Per-model training-loop instrumentation over the shared registry.

    Inline integration shape (bench harnesses, custom loops)::

        probe = PipelineProbe("dlrm")
        for batch in probe.iter_host(epochs()):      # host_wait
            with probe.h2d():                        # h2d
                args = stage(batch)
            probe.sync()                             # device_wait (step N-1)
            state, loss = train_step(state, *args)
            probe.dispatched(state, examples=len(batch))
        probe.finish()                               # drain the last step

    Prefetched shape (two_tower.train via DevicePrefetcher)::

        for batch in probe.iter_prefetched(pf):      # host_wait = queue wait
            probe.sync()                             # device_wait (step N-1)
            state, loss = train_step(state, *batch.args)
            probe.dispatched(state, examples=batch.examples)
        probe.finish()
    """

    def __init__(self, model: str,
                 registry: Optional[MetricsRegistry] = None,
                 timeline: Optional[StepTimeline] = None):
        reg = registry or get_registry()
        self.model = model
        self._timeline = timeline if timeline is not None else get_timeline()
        self._labels = {"model": model}
        self._host_wait = reg.histogram(
            "pio_train_host_wait_ms",
            "Time blocked fetching the next training batch (host side).",
            ("model",))
        self._h2d = reg.histogram(
            "pio_train_h2d_ms",
            "Time staging a batch for the device (convert + transfer).",
            ("model",))
        self._h2d_overlap = reg.histogram(
            "pio_train_h2d_overlap_ms",
            "Background staging time overlapped under device compute "
            "(prefetched pipeline; not part of the step-loop wall).",
            ("model",))
        self._dispatch = reg.histogram(
            "pio_train_dispatch_ms",
            "Time inside the step call (cache lookup + enqueue; on "
            "synchronous-dispatch backends the execution itself).",
            ("model",))
        self._device_wait = reg.histogram(
            "pio_train_device_wait_ms",
            "Host stall waiting on the previously dispatched device step.",
            ("model",))
        self._device_step = reg.histogram(
            "pio_train_device_step_ms",
            "Device-step duration: dispatch to outputs ready.",
            ("model",))
        self._last = {
            "host_wait": reg.gauge(
                "pio_train_last_host_wait_ms",
                "host_wait of the most recent iteration.", ("model",)),
            "h2d": reg.gauge(
                "pio_train_last_h2d_ms",
                "h2d of the most recent iteration.", ("model",)),
            "device_wait": reg.gauge(
                "pio_train_last_device_wait_ms",
                "device_wait of the most recent iteration.", ("model",)),
        }
        self._steps = reg.counter(
            "pio_train_steps_total", "Optimizer steps run.", ("model",))
        self._examples = reg.counter(
            "pio_train_examples_total",
            "Training examples consumed (pre-padding).", ("model",))
        self._pending: Optional[Any] = None
        self._pending_t0 = 0.0
        # Reference point for the dispatch interval: end of the last
        # sync (or of the batch fetch when nothing was in flight) up to
        # dispatched() — the step call's own wall.
        self._dispatch_ref: Optional[float] = None
        # Current-iteration scratch + the dispatched-step snapshot: the
        # loop overwrites _cur with step N's host_wait/h2d while step N-1
        # is still in flight, so dispatched() freezes _cur into
        # _pending_meta and sync() emits the completed step's timeline
        # record from the frozen copy.
        self._cur: dict = {}
        self._pending_meta: Optional[dict] = None
        self._step_no = 0

    # -- host side ---------------------------------------------------------

    def _iter_timed(self, it: Iterable, on_batch=None) -> Iterator:
        """Shared skeleton: each ``next()`` is timed as host_wait; the
        optional ``on_batch`` hook layers extra bookkeeping onto the
        fresh ``_cur`` scratch before the batch is yielded."""
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            ms = (time.perf_counter() - t0) * 1e3
            self._host_wait.observe(ms, **self._labels)
            self._last["host_wait"].set(ms, **self._labels)
            self._cur = {"host_wait": ms, "start_s": time.time() - ms / 1e3}
            self._dispatch_ref = time.perf_counter()
            if on_batch is not None:
                on_batch(batch)
            yield batch

    def iter_host(self, it: Iterable) -> Iterator:
        """Wrap a batch iterator; each ``next()`` is timed as host_wait."""
        return self._iter_timed(it)

    def h2d(self) -> _Timed:
        return _Timed(self._h2d, self._last["h2d"], self._labels,
                      self._cur, "h2d")

    def iter_prefetched(self, prefetcher: Iterable) -> Iterator:
        """Wrap a :class:`~predictionio_tpu_torch.data.prefetch.DevicePrefetcher`
        stream: the queue wait is ``host_wait`` (the only serialized host
        cost left) and each batch's background staging time lands in the
        overlap window (``h2d_overlap``), NOT in the step-loop wall."""
        def on_batch(batch):
            overlap_ms = float(getattr(batch, "h2d_ms", 0.0))
            self._h2d_overlap.observe(overlap_ms, **self._labels)
            self._cur["h2d_overlap"] = overlap_ms
            self._cur["staged_s"] = getattr(batch, "staged_s", None)

        return self._iter_timed(prefetcher, on_batch)

    # -- device side (one-step lag) ----------------------------------------

    def sync(self) -> None:
        """Block on the previous step's outputs; the block time is the
        device-attributable stall, the dispatch→ready time is the step."""
        if self._pending is None:
            return
        t0 = time.perf_counter()
        self._pending.wait()
        t1 = time.perf_counter()
        self._dispatch_ref = t1
        self._device_wait.observe((t1 - t0) * 1e3, **self._labels)
        self._last["device_wait"].set((t1 - t0) * 1e3, **self._labels)
        self._device_step.observe((t1 - self._pending_t0) * 1e3,
                                  **self._labels)
        meta = self._pending_meta or {}
        self._timeline.record(
            self.model,
            step=meta.get("step"),
            start_s=meta.get("start_s"),
            host_wait_ms=meta.get("host_wait", 0.0),
            h2d_ms=meta.get("h2d", 0.0),
            h2d_overlap_ms=meta.get("h2d_overlap", 0.0),
            staged_s=meta.get("staged_s"),
            dispatch_s=meta.get("dispatch_s"),
            dispatch_ms=meta.get("dispatch", 0.0),
            device_wait_ms=(t1 - t0) * 1e3,
            device_step_ms=(t1 - self._pending_t0) * 1e3,
            examples=meta.get("examples", 0),
            fused_steps=meta.get("steps", 1))
        self._pending = None
        self._pending_meta = None

    def dispatched(self, outputs: Any, examples: int = 0,
                   steps: int = 1) -> None:
        """Register a freshly dispatched step's outputs for the next sync.

        ``steps`` is the optimizer-step count this ONE dispatch covers (a
        K-fused window passes K): the steps counter advances by it, and
        the timeline record carries it so the per-dispatch wall is
        attributable to K steps downstream."""
        self._pending = _DispatchMark(outputs)
        self._pending_t0 = time.perf_counter()
        if self._dispatch_ref is not None:
            # The step call's own wall: everything between the last
            # probe point (sync, or batch fetch) and here.
            ms = (self._pending_t0 - self._dispatch_ref) * 1e3
            self._dispatch.observe(ms, **self._labels)
            self._cur["dispatch"] = ms
            self._dispatch_ref = None
        steps = max(int(steps), 1)
        self._steps.inc(steps, **self._labels)
        if examples:
            self._examples.inc(examples, **self._labels)
        self._step_no += steps
        meta = dict(self._cur)
        meta.setdefault("start_s", time.time())
        # True dispatch wall time: the Chrome-trace export starts the
        # device lane here instead of approximating from the step start,
        # so h2d/compute overlap renders exactly.
        meta["dispatch_s"] = time.time()
        meta["step"] = self._step_no
        meta["examples"] = examples
        meta["steps"] = steps
        self._pending_meta = meta
        self._cur = {}

    def finish(self) -> None:
        """Drain the last in-flight step (end of the training loop)."""
        self.sync()
