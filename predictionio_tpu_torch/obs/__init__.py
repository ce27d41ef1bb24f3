"""Observability of the port: the metrics registry.  Traces, the latency
waterfall and the quality monitors arrive with later slices."""

from predictionio_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry"]
