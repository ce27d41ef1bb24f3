"""Observability of the port: the metrics registry and the workflow's
phase timer.  Traces, the latency waterfall and the quality monitors
arrive with later slices."""

import contextlib as _contextlib
import time as _time

from predictionio_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "phase"]


@_contextlib.contextmanager
def phase(name: str):
    """Wall time of one workflow phase into ``pio_train_phase_ms{phase}``
    (the reference's series; its span half arrives with traces).  A
    phase that raises is recorded too."""
    hist = get_registry().histogram(
        "pio_train_phase_ms", "Workflow phase duration by phase name.",
        ("phase",))
    t0 = _time.perf_counter()
    try:
        yield
    finally:
        hist.observe((_time.perf_counter() - t0) * 1e3, phase=name)
