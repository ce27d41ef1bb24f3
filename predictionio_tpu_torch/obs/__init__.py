"""Observability of the port: the metrics registry, request tracing
(:mod:`.trace`: spans, the trace ring behind ``GET /traces.json``,
``PIO_TRACE_FILE``), the workflow's phase timer, the training-pipeline
probe (:mod:`.pipeline`), the trace-ring events, the device-memory
sampler and the step timeline (:mod:`.runtime`), and the on-demand
``torch.profiler`` capture (:mod:`.profiler`).  The latency waterfall,
the SLOs and the quality monitors arrive with later slices."""

import contextlib as _contextlib

from predictionio_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from predictionio_tpu_torch.obs.runtime import (
    get_memory_sampler,
    get_timeline,
    publish_event,
)
from predictionio_tpu_torch.obs.trace import (
    Span,
    TraceRecorder,
    attach_event,
    current_span,
    current_trace_id,
    get_recorder,
    new_trace_id,
    sanitize_trace_id,
    set_recorder,
    slow_request_ms,
    span,
    trace,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "phase", "publish_event",
           "get_memory_sampler", "get_timeline",
           "Span", "TraceRecorder", "attach_event", "current_span",
           "current_trace_id", "get_recorder", "new_trace_id",
           "sanitize_trace_id", "set_recorder", "slow_request_ms", "span",
           "trace"]


@_contextlib.contextmanager
def phase(name: str, **attrs):
    """Span + per-phase duration histogram in one context manager: the
    workflow's named phases show up in the trace tree AND as
    ``pio_train_phase_ms{phase}`` series (the reference's).  A phase
    that raises is recorded too."""
    hist = get_registry().histogram(
        "pio_train_phase_ms", "Workflow phase duration by phase name.",
        ("phase",))
    with span(name, **attrs) as s:
        try:
            yield s
        finally:
            s.finish()
            hist.observe(s.duration_ms or 0.0, phase=name)

