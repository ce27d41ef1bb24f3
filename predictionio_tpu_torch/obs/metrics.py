"""Process-wide metrics registry: Counter / Gauge / Histogram + renderer.

Port of ``predictionio_tpu/obs/metrics.py``, kept line for line: the
family names, label names and the Prometheus text format are what the
fleet merge and the attribution tools read, so the port's ``/metrics``
must render exactly like the reference's.

Design constraints:

- stdlib only (obs must be importable before torch/numpy — the servers
  cannot afford a heavyweight dependency on their status path);
- thread-safe: instruments are hit from every request-handler thread and
  from the training loop concurrently (one lock per instrument, held only
  for the dict update — no I/O under lock);
- label support with Prometheus text-exposition escaping;
- instruments are get-or-create by name so independently constructed
  servers in one process share series instead of colliding.

Naming convention (enforced only by review, documented in README):
``pio_<server|subsystem>_<what>_<unit>`` — e.g. ``pio_event_requests_total``,
``pio_train_host_wait_ms``.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "DEFAULT_LATENCY_BUCKETS_MS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Request/step latency buckets in milliseconds: sub-ms serving fast paths
# up through multi-minute training phases.
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000, 60000, 300000,
)


def _fmt_value(v: float) -> str:
    """Prometheus sample-value formatting: integral floats render bare
    (``1`` not ``1.0``) so counters read naturally; everything else uses
    repr (full precision round-trip)."""
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _label_pairs(labelnames: Sequence[str], labelvalues: Tuple[str, ...],
                 extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape_label_value(v)}"'
             for n, v in zip(labelnames, labelvalues)]
    pairs.extend(f'{n}="{_escape_label_value(v)}"' for n, v in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_exemplar(ex: Optional[Tuple[str, float]]) -> str:
    """OpenMetrics exemplar suffix for a bucket line (empty when none).

    Only rendered on the opt-in ``?exemplars=1`` view — classic 0.0.4
    allows nothing but an optional timestamp after the value, so a
    strict Prometheus scraper would reject an exposition carrying these.
    Our own parsers (fleet aggregation, pio status, bench) strip the
    suffix explicitly either way."""
    if not ex:
        return ""
    trace_id, v = ex
    return (f' # {{trace_id="{_escape_label_value(trace_id)}"}}'
            f' {_fmt_value(v)}')


class _Metric:
    """Shared base: name/help/labelnames validation + per-series storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def render(self) -> List[str]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter; ``inc`` with the instrument's exact label set."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._series: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]  # an unlabelled counter exists from t=0
        return [f"{self.name}{_label_pairs(self.labelnames, k)} "
                f"{_fmt_value(v)}" for k, v in items]


class Gauge(_Metric):
    """Set/inc/dec instantaneous value."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._series: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        return [f"{self.name}{_label_pairs(self.labelnames, k)} "
                f"{_fmt_value(v)}" for k, v in items]


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        # bucket index -> (trace_id, value) of the LAST observation that
        # landed there with an exemplar attached (OpenMetrics-style).
        self.exemplars: Dict[int, Tuple[str, float]] = {}


class Histogram(_Metric):
    """Bucketed distribution with Prometheus cumulative-``le`` rendering
    and a quantile estimator for the JSON stats views."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        if bs and bs[-1] == math.inf:
            bs = bs[:-1]  # +Inf is implicit
        self.buckets = tuple(bs)
        self._series: Dict[Tuple[str, ...], _HistSeries] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        """Record one observation.  ``exemplar`` is an optional trace id
        stored per (series, bucket) and rendered OpenMetrics-style after
        the bucket line, linking the bucket to its ``/traces.json`` entry
        (ISSUE 9 waterfall: "why is THIS bucket populated?" answers with
        a concrete request to open)."""
        key = self._key(labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets) + 1)
            i = len(self.buckets)  # +Inf slot
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            if exemplar:
                s.exemplars[i] = (str(exemplar), v)

    def exemplars(self, **labels) -> Dict[float, Tuple[str, float]]:
        """{bucket_le: (trace_id, value)} for one series (+Inf = inf)."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return {}
            bounds = self.buckets + (math.inf,)
            return {bounds[i]: ex for i, ex in s.exemplars.items()}

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            return s.count if s else 0

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            return s.sum if s else 0.0

    def count_le(self, value: float, **labels) -> float:
        """Estimated observations ≤ ``value`` (linear interpolation inside
        the containing bucket) — the latency-SLO "good events" reading.
        Conservative at bucket edges exactly like :meth:`quantile`."""
        key = self._key(labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None or s.count == 0:
                return 0.0
            counts = list(s.counts)
        cum = 0.0
        lo = 0.0
        for j, b in enumerate(self.buckets):
            if v <= b:
                if counts[j] and b > lo:
                    frac = (v - lo) / (b - lo)
                    cum += counts[j] * min(max(frac, 0.0), 1.0)
                return cum
            cum += counts[j]
            lo = b
        # Past the top finite bound: +Inf-bucket observations have no
        # upper bound, so they count as NOT ≤ value (under-counts goods —
        # the safe direction for an SLO).
        return cum

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (the /stats.json view).

        Linear interpolation inside the bucket holding the q-th sample;
        values landing in the +Inf bucket report the top finite bound
        (an under-estimate, flagged by the bucket counts themselves).
        """
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None or s.count == 0:
                return 0.0
            counts = list(s.counts)
            total = s.count
        target = q * total
        cum = 0.0
        lo = 0.0
        for j, b in enumerate(self.buckets):
            prev_cum = cum
            cum += counts[j]
            if cum >= target and counts[j] > 0:
                frac = (target - prev_cum) / counts[j]
                return lo + (b - lo) * min(max(frac, 0.0), 1.0)
            lo = b
        return self.buckets[-1]

    def merged_quantile(self, q: float) -> float:
        """Quantile over ALL series of this histogram merged — the
        aggregate view used when labels only partition one logical
        stream (e.g. per-route request latency)."""
        with self._lock:
            merged = [0] * (len(self.buckets) + 1)
            total = 0
            for s in self._series.values():
                total += s.count
                for j, c in enumerate(s.counts):
                    merged[j] += c
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        lo = 0.0
        for j, b in enumerate(self.buckets):
            prev_cum = cum
            cum += merged[j]
            if cum >= target and merged[j] > 0:
                frac = (target - prev_cum) / merged[j]
                return lo + (b - lo) * min(max(frac, 0.0), 1.0)
            lo = b
        return self.buckets[-1]

    def render(self, exemplars: bool = False) -> List[str]:
        with self._lock:
            items = [(k, list(s.counts), s.sum, s.count,
                      dict(s.exemplars) if exemplars else {})
                     for k, s in sorted(self._series.items())]
        lines: List[str] = []
        for key, counts, ssum, scount, exs in items:
            cum = 0
            for j, (b, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_label_pairs(self.labelnames, key, (('le', _fmt_value(b)),))}"
                    f" {cum}{_fmt_exemplar(exs.get(j))}")
            lines.append(
                f"{self.name}_bucket"
                f"{_label_pairs(self.labelnames, key, (('le', '+Inf'),))}"
                f" {scount}{_fmt_exemplar(exs.get(len(self.buckets)))}")
            lines.append(f"{self.name}_sum"
                         f"{_label_pairs(self.labelnames, key)} "
                         f"{_fmt_value(ssum)}")
            lines.append(f"{self.name}_count"
                         f"{_label_pairs(self.labelnames, key)} {scount}")
        return lines


class MetricsRegistry:
    """Get-or-create instrument registry + the ONE text renderer.

    ``counter``/``gauge``/``histogram`` return the existing instrument when
    the name is already registered (validating kind and labelnames match),
    so a second server instance in the same process shares series rather
    than shadowing them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} labelnames mismatch: "
                        f"{m.labelnames} vs {tuple(labelnames)}")
                want_buckets = kw.get("buckets")
                if want_buckets is not None:
                    norm = tuple(sorted(float(b) for b in want_buckets
                                        if b != math.inf))
                    if norm != m.buckets:
                        raise ValueError(
                            f"histogram {name!r} buckets mismatch: "
                            f"{m.buckets} vs {norm}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format 0.0.4 for the whole process.

        ``exemplars=True`` appends OpenMetrics-style exemplar suffixes
        to histogram bucket lines.  That syntax is NOT part of classic
        0.0.4 — a strict Prometheus scraper rejects the whole exposition
        over it — so the default render stays clean and the servers only
        opt in for ``/metrics?exemplars=1`` (our own tools: the trace
        resolver behind the waterfall buckets)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render(exemplars=exemplars)
                         if isinstance(m, Histogram) else m.render())
        return "\n".join(lines) + "\n"

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Drop every instrument (test isolation; never in production)."""
        with self._lock:
            self._metrics.clear()


_registry = MetricsRegistry()
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """THE process-wide registry (servers, workflow, feeder, plugins)."""
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process registry (tests); returns the previous one."""
    global _registry
    with _registry_lock:
        prev, _registry = _registry, registry
    return prev
