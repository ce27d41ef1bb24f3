"""Observability of the port: the metrics registry, request tracing
(:mod:`.trace`: spans, the trace ring behind ``GET /traces.json``,
``PIO_TRACE_FILE``), the workflow's phase timer, the training-pipeline
probe (:mod:`.pipeline`), the trace-ring events, the device-memory
sampler and the step timeline (:mod:`.runtime`), the on-demand
``torch.profiler`` capture (:mod:`.profiler`), the per-request serving
latency waterfall (:mod:`.waterfall`: ``pio_serve_stage_ms{stage}`` with
exemplars, the ``PIO_REQUEST_LOG`` wide event), the SLO engine behind
``/ready`` (:mod:`.slo`), and the model-quality and retrieval-recall
monitors behind ``/quality.json`` (:mod:`.quality`, :mod:`.recall`)."""

import contextlib as _contextlib

from predictionio_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from predictionio_tpu_torch.obs.quality import (
    QualityConfig,
    QualityMonitor,
    Scorecard,
    reset_quality,
)
from predictionio_tpu_torch.obs.recall import (
    RecallConfig,
    RecallMonitor,
    RecallScorecard,
)
from predictionio_tpu_torch.obs.runtime import (
    get_memory_sampler,
    get_timeline,
    publish_event,
    reset_runtime,
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
from predictionio_tpu_torch.obs.slo import SLOConfig, SLOEngine
from predictionio_tpu_torch.obs.waterfall import Waterfall

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "phase", "publish_event",
           "get_memory_sampler", "get_timeline",
           "Span", "TraceRecorder", "attach_event", "current_span",
           "current_trace_id", "get_recorder", "new_trace_id",
           "sanitize_trace_id", "set_recorder", "slow_request_ms", "span",
           "trace", "Waterfall", "SLOConfig", "SLOEngine", "QualityConfig",
           "QualityMonitor", "Scorecard", "RecallConfig", "RecallMonitor",
           "RecallScorecard", "reset_observability"]


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



def reset_observability() -> None:
    """Fresh registry + empty trace ring and timeline, no armed waterfall
    and no feedback joiner (test isolation).  A caller that drives the
    engine's handler directly (no transport) arms the request waterfall
    and nothing finalizes it; the joiner is process-global and its
    counters lived in the registry just reset."""
    get_registry().reset()
    get_recorder().clear()
    reset_runtime()
    from predictionio_tpu_torch.obs import waterfall as _waterfall
    _waterfall.deactivate()
    reset_quality()
