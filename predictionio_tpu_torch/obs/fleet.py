"""Fleet-merged telemetry.

Port of ``predictionio_tpu/obs/fleet.py``.  ``/metrics``, the SLO state
and the step timeline of N engine or event servers, merged so that a
fleet behind a load balancer reads as one:

- :func:`parse_exposition` — Prometheus text-format parser (tolerates
  the OpenMetrics exemplar suffix the port's histograms emit on
  ``/metrics?exemplars=1``);
- :func:`merge_samples` — TYPE-correct merge: **counters sum**,
  **histogram buckets add** (per-``le`` addition is associative and
  sum-preserving by construction; every instance renders one bucket
  schema), **gauges never merge** — each instance's reading survives
  under an added ``instance`` label (summing two
  ``pio_model_generation`` values is meaningless);
- :class:`CounterResetTracker` — an instance restart resets its
  cumulative series to 0; the tracker detects the drop and carries the
  pre-restart total as an offset so fleet sums never go backwards;
- :class:`FleetAggregator` — scrapes a configured instance list, merges,
  and serves the ``/fleet.json`` payload (dashboard) / the ``pio status
  --fleet`` summary.  A dead instance degrades to a **marked-stale
  entry** that keeps contributing its last-known counters (sums must not
  dip just because one scrape failed), never an exception.

Configuration: ``PIO_FLEET_INSTANCES`` — comma-separated base URLs
(``http://host:port``), or the dashboard's ``--fleet`` flag.  Host-only
Python: the port's metric names are the reference's, so the merge rules
are the same.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "parse_exposition",
    "merge_samples",
    "merge_histogram_buckets",
    "CounterResetTracker",
    "FleetAggregator",
    "fleet_instances_from_env",
    "histogram_quantile",
]

# Cumulative-series suffixes a histogram family renders; they reset on
# restart exactly like counters, so the reset tracker covers them too.
_CUMULATIVE_SUFFIXES = ("_bucket", "_sum", "_count")

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>[^\s#]+)')
# OpenMetrics exemplar suffix on a bucket line (` # {trace_id="..."} v`):
# stripped BEFORE sample matching — the greedy label regex would
# otherwise swallow it, taking the exemplar VALUE as the sample value
# and leaking trace_id in as a label.
_EXEMPLAR_SUFFIX_RE = re.compile(r'\s#\s\{.*\}\s+\S+(\s+\S+)?$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


# Single-pass unescape (the sequential .replace() order corrupts values
# holding an escaped backslash before an 'n': '\\\\n' must be
# backslash+'n', never backslash+newline).
_ESCAPE_RE = re.compile(r"\\(.)")
_ESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(v: str) -> str:
    return _ESCAPE_RE.sub(
        lambda m: _ESCAPES.get(m.group(1), "\\" + m.group(1)), v)


def parse_exposition(text: str) -> Tuple[Dict[str, str], List[Tuple]]:
    """(types, samples) from Prometheus text exposition.

    ``types`` maps family name → kind; ``samples`` is a list of
    ``(name, labels_dict, value)``.  Exemplar suffixes (`` # {...}``)
    after the value are ignored; unparseable lines are skipped — a
    hostile/foreign exposition must not 500 the aggregator.
    """
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(_EXEMPLAR_SUFFIX_RE.sub("", line))
        if not m:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        raw = m.group("value")
        try:
            value = float(raw)
        except ValueError:
            continue
        samples.append((m.group("name"), labels, value))
    return types, samples


def _family(name: str, types: Dict[str, str]) -> Tuple[str, str]:
    """(family_name, kind) for a sample name, resolving the histogram
    child series (``*_bucket``/``*_sum``/``*_count``) to their family."""
    kind = types.get(name)
    if kind is not None:
        return name, kind
    for suffix in _CUMULATIVE_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base, "histogram"
    return name, "untyped"


def _series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def merge_histogram_buckets(parts: Iterable[Dict[str, float]]
                            ) -> Dict[str, float]:
    """Add per-``le`` cumulative bucket counts.  Plain addition over a
    shared ``le`` schema: associative, commutative, and sum-preserving
    (the fleet-merge correctness tests pin all three)."""
    out: Dict[str, float] = {}
    for p in parts:
        for le, c in p.items():
            out[le] = out.get(le, 0.0) + c
    return out


class CounterResetTracker:
    """Carries cumulative series across instance restarts.

    ``update(instance, series_key, raw)`` returns the restart-corrected
    effective value: when a scrape shows the raw value DROPPED, the
    instance restarted and its pre-restart total becomes an offset.
    State is per aggregator instance — two dashboards each converge on
    correct sums independently."""

    def __init__(self):
        self._state: Dict[Tuple[str, str], Tuple[float, float]] = {}

    def update(self, instance: str, series_key: str, raw: float) -> float:
        key = (instance, series_key)
        last_raw, offset = self._state.get(key, (0.0, 0.0))
        if raw < last_raw:
            offset += last_raw  # reset detected: bank the old total
        self._state[key] = (raw, offset)
        return raw + offset


def merge_samples(per_instance: Dict[str, Tuple[Dict[str, str], List[Tuple]]],
                  reset_tracker: Optional[CounterResetTracker] = None
                  ) -> Dict[str, Any]:
    """TYPE-correct merge of several instances' parsed expositions.

    ``per_instance``: instance → (types, samples).  Returns::

        {"counters":   {series_key: summed_value},
         "gauges":     {series_key_with_instance_label: value},
         "histograms": {family: {series_key(no le): {"buckets": {le: n},
                                                     "sum": s,
                                                     "count": n}}},
         "types":      {family: kind}}
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Dict[str, Any]]] = {}
    all_types: Dict[str, str] = {}
    for instance, (types, samples) in sorted(per_instance.items()):
        all_types.update(types)
        for name, labels, value in samples:
            family, kind = _family(name, types)
            if kind == "counter":
                key = _series_key(name, labels)
                eff = (reset_tracker.update(instance, key, value)
                       if reset_tracker else value)
                counters[key] = counters.get(key, 0.0) + eff
            elif kind == "histogram":
                # Copy before dropping ``le`` — the parsed samples are
                # cached per instance and merged again on every payload.
                le = labels.get("le")
                labels = {k: v for k, v in labels.items() if k != "le"}
                key = _series_key(family, labels)
                raw_key = _series_key(name, {**labels, "le": le or ""})
                eff = (reset_tracker.update(instance, raw_key, value)
                       if reset_tracker else value)
                series = hists.setdefault(family, {}).setdefault(
                    key, {"buckets": {}, "sum": 0.0, "count": 0.0})
                if name.endswith("_bucket") and le is not None:
                    series["buckets"][le] = \
                        series["buckets"].get(le, 0.0) + eff
                elif name.endswith("_sum"):
                    series["sum"] += eff
                elif name.endswith("_count"):
                    series["count"] += eff
            elif kind == "gauge":
                # Never merged: the per-instance reading IS the datum.
                gauges[_series_key(
                    name, {**labels, "instance": instance})] = value
    return {"counters": counters, "gauges": gauges, "histograms": hists,
            "types": all_types}


def histogram_quantile(buckets: Dict[str, float], q: float) -> float:
    """Bucket-interpolated quantile over merged cumulative buckets (the
    same estimator as ``Histogram.quantile``, on the merged view)."""
    pairs = sorted(
        ((float("inf") if le == "+Inf" else float(le)), c)
        for le, c in buckets.items())
    if not pairs or pairs[-1][1] <= 0:
        return 0.0
    total = pairs[-1][1]
    target = q * total
    lo, prev_cum = 0.0, 0.0
    for le, cum in pairs:
        if cum >= target and cum > prev_cum:
            if le == float("inf"):
                return lo
            frac = (target - prev_cum) / (cum - prev_cum)
            return lo + (le - lo) * min(max(frac, 0.0), 1.0)
        lo, prev_cum = (le if le != float("inf") else lo), cum
    return lo


def fleet_instances_from_env(env=None) -> List[str]:
    import os

    raw = (env or os.environ).get("PIO_FLEET_INSTANCES", "")
    return [u.strip().rstrip("/") for u in raw.split(",") if u.strip()]


class _InstanceState:
    __slots__ = ("url", "types", "samples", "stats", "timeline",
                 "quality", "last_ok_at", "error")

    def __init__(self, url: str):
        self.url = url
        self.types: Dict[str, str] = {}
        self.samples: List[Tuple] = []
        self.stats: Optional[Dict[str, Any]] = None
        self.timeline: Optional[Dict[str, Any]] = None
        self.quality: Optional[Dict[str, Any]] = None
        self.last_ok_at: Optional[float] = None
        self.error: Optional[str] = None


class FleetAggregator:
    """Scrape + merge telemetry from a list of instance base URLs.

    One aggregator instance lives on the dashboard server (and one per
    ``pio status --fleet`` invocation); it keeps the counter-reset state
    and each instance's last-known-good scrape so a dead instance shows
    up stale instead of silently vanishing from the sums."""

    def __init__(self, instances: Iterable[str], *,
                 timeout_s: float = 5.0,
                 fetch=None,
                 clock=time.monotonic):
        self.instances = [u.rstrip("/") for u in instances]
        self.timeout_s = timeout_s
        self._fetch = fetch or self._http_fetch
        self._clock = clock
        self._resets = CounterResetTracker()
        self._state: Dict[str, _InstanceState] = {
            u: _InstanceState(u) for u in self.instances}
        self._lock = threading.Lock()
        self._scrape_pool: Optional[ThreadPoolExecutor] = None

    def _http_fetch(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8", errors="replace")

    def scrape_once(self) -> None:
        """One scrape pass over every instance (errors recorded, never
        raised).  Instances are fetched CONCURRENTLY — a dead instance
        costs one timeout for the whole pass, not one per instance, so a
        /fleet.json poll never serially stacks timeouts on its handler
        thread."""
        def _scrape(url: str) -> None:
            st = self._state[url]
            try:
                text = self._fetch(f"{url}/metrics")
                types, samples = parse_exposition(text)
                stats = None
                try:
                    stats = json.loads(self._fetch(f"{url}/stats.json"))
                except Exception:  # noqa: BLE001 - stats are optional
                    pass
                timeline = None
                try:
                    timeline = json.loads(self._fetch(
                        f"{url}/timeline.json?format=summary"))
                except Exception:  # noqa: BLE001 - timeline is optional
                    pass
                quality = None
                try:
                    quality = json.loads(self._fetch(
                        f"{url}/quality.json"))
                except Exception:  # noqa: BLE001 - quality is optional
                    pass
                with self._lock:
                    st.types, st.samples = types, samples
                    st.stats, st.timeline = stats, timeline
                    st.quality = quality if isinstance(quality, dict) \
                        else None
                    st.last_ok_at = self._clock()
                    st.error = None
            except Exception as e:  # noqa: BLE001 - degrade to stale
                with self._lock:
                    st.error = f"{type(e).__name__}: {e}"
                logger.warning("fleet scrape of %s failed: %s", url, e)

        if len(self.instances) <= 1:
            for url in self.instances:
                _scrape(url)
            return
        list(self._pool().map(_scrape, self.instances))

    def _pool(self) -> ThreadPoolExecutor:
        """Persistent scrape pool, created on first multi-instance pass —
        a dashboard polling /fleet.json at 1 Hz must not spawn and join
        N threads per request."""
        with self._lock:
            if self._scrape_pool is None:
                self._scrape_pool = ThreadPoolExecutor(
                    max_workers=min(len(self.instances), 16),
                    thread_name_prefix="pio-fleet-scrape")
            return self._scrape_pool

    def payload(self) -> Dict[str, Any]:
        """The ``/fleet.json`` document from the current state."""
        now = self._clock()
        with self._lock:
            states = {u: (st.types, list(st.samples))
                      for u, st in self._state.items() if st.samples}
            quality_docs = [st.quality for u in self.instances
                            for st in (self._state[u],)
                            if st.quality is not None]
            rows = []
            for u in self.instances:
                st = self._state[u]
                stale = st.error is not None or st.last_ok_at is None
                row: Dict[str, Any] = {
                    "instance": u,
                    "stale": stale,
                    "ageS": (round(now - st.last_ok_at, 1)
                             if st.last_ok_at is not None else None),
                }
                if st.error:
                    row["error"] = st.error
                if st.stats:
                    if "slo" in st.stats:
                        row["slo"] = st.stats["slo"]
                    if "batcher" in st.stats:
                        row["batcher"] = st.stats["batcher"]
                if st.timeline:
                    row["timeline"] = st.timeline.get("models")
                if st.quality is not None:
                    row["quality"] = st.quality
                rows.append(row)
            # Merge INSIDE the lock: the reset tracker mutates on every
            # merge, so a concurrent /fleet.json working from an older
            # snapshot after a fresh scrape advanced the tracker would
            # read its lower raw values as instance restarts and bank
            # phantom offsets — permanently inflating the fleet sums.
            merged = merge_samples(states, self._resets)
        quantiles = {
            fam: {key: {"p50": round(histogram_quantile(s["buckets"], .5), 3),
                        "p99": round(histogram_quantile(s["buckets"], .99), 3),
                        "count": s["count"]}
                  for key, s in series.items()}
            for fam, series in merged["histograms"].items()}
        # Quality merge: union-of-keys recursion — an instance's field
        # is never silently dropped.  The recall block rides the same
        # merge: counts sum, recallFast/recallSlow/baseline take the
        # WORST instance (min).
        from predictionio_tpu_torch.obs.quality import merge_quality

        return {
            "scrapedAt": round(time.time(), 3),
            "instances": rows,
            "merged": {
                "counters": {k: v for k, v in
                             sorted(merged["counters"].items())},
                "gauges": {k: v for k, v in
                           sorted(merged["gauges"].items())},
                "histogramQuantiles": quantiles,
                "histograms": merged["histograms"],
                "quality": merge_quality(quality_docs),
            },
        }

    def scrape(self) -> Dict[str, Any]:
        """scrape_once + payload — the dashboard's GET /fleet.json."""
        self.scrape_once()
        return self.payload()

    def close(self) -> None:
        """Release the persistent scrape pool.  Long-lived owners (the
        dashboard) never need this; short-lived ones (a rollout
        controller, `pio status --fleet`) should not leak a thread pool
        per invocation."""
        with self._lock:
            pool, self._scrape_pool = self._scrape_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
