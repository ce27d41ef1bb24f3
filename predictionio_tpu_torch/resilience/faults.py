"""Env-driven fault-injection harness.

Port of ``predictionio_tpu/resilience/faults.py``: the same grammar, the
same points and the same seeded firing order, so one plan drives an
outage drill through either package.  This module is the one
switchboard:

    PIO_FAULTS="storage.create:error:0.3,storage.find:delay:200ms"

Grammar (comma-separated rules)::

    <point>:error[:<probability>][:<max-count>]
    <point>:delay:<duration>[:<probability>][:<max-count>]

``<point>`` is an instrumented fault-point name or a ``prefix.*`` glob;
``<duration>`` takes an ``ms``/``s`` suffix (bare numbers are ms).
Probability defaults to 1.0; ``max-count`` bounds how many times the
rule fires (e.g. kill exactly one RPC reply).  ``PIO_FAULTS_SEED`` makes
probabilistic rules reproducible.

Instrumented points:

- ``storage.create`` / ``storage.find`` / ``storage.get`` /
  ``storage.delete`` / ``storage.init`` — the storage base layer (every
  ``Storage.get_events()`` repository call routes through these, and
  so do the engine-instance and model-blob reads of a reload).
- ``spillq.*`` and ``kv.*`` — the shared spill queue and the shared KV.
- ``rpc.send`` / ``rpc.recv`` — the JSON-RPC framing in the remote
  storage client (``rpc.recv`` fires AFTER the request hit the wire:
  the server may have committed, which is exactly the lost-reply case
  idempotency tokens exist for); ``rpc.dispatch`` server-side
  (:mod:`predictionio_tpu_torch.data.storage.remote`).
- ``http.event``, ``ingest.admit`` and ``ingest.batch`` — the event
  server; ``http.engine`` — the engine server.

Injected errors raise :class:`FaultInjected` (a ``ConnectionError``), so
they travel the same except-paths a real dead backend would.  Tests can
bypass the env with :func:`install`.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from predictionio_tpu_torch.obs import get_registry

__all__ = [
    "FaultInjected",
    "FaultRule",
    "FaultPlan",
    "parse_plan",
    "install",
    "clear",
    "active",
    "fault_point",
    "wrap_events",
    "wrap_instances",
    "wrap_models",
    "wrap_spill_queues",
    "wrap_kv",
]


class FaultInjected(ConnectionError):
    """An injected fault — walks the real connection-failure paths."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


class FaultRule:
    def __init__(self, match: str, kind: str, probability: float = 1.0,
                 delay_ms: float = 0.0, max_count: Optional[int] = None):
        if kind not in ("error", "delay"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self.match = match
        self.kind = kind
        self.probability = float(probability)
        self.delay_ms = float(delay_ms)
        self.max_count = max_count
        self._fired = 0
        self._lock = threading.Lock()

    def matches(self, point: str) -> bool:
        if self.match.endswith("*"):
            return point.startswith(self.match[:-1])
        return point == self.match

    def try_fire(self, rng: random.Random) -> bool:
        """Atomically claim one firing (respects probability + max_count)."""
        with self._lock:
            if self.max_count is not None and self._fired >= self.max_count:
                return False
            if self.probability < 1.0 and rng.random() >= self.probability:
                return False
            self._fired += 1
            return True


class FaultPlan:
    def __init__(self, rules: List[FaultRule],
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.rules = list(rules)
        self.rng = rng or random.Random(
            int(os.environ["PIO_FAULTS_SEED"])
            if os.environ.get("PIO_FAULTS_SEED") else None)
        self.sleep = sleep

    def apply(self, point: str) -> None:
        for rule in self.rules:
            if not rule.matches(point) or not rule.try_fire(self.rng):
                continue
            get_registry().counter(
                "pio_faults_injected_total",
                "Faults injected by the PIO_FAULTS harness.",
                ("point", "kind")).inc(point=point, kind=rule.kind)
            if rule.kind == "delay":
                self.sleep(rule.delay_ms / 1e3)
            else:
                raise FaultInjected(point)


def _parse_duration_ms(text: str) -> float:
    t = text.strip().lower()
    if t.endswith("ms"):
        return float(t[:-2])
    if t.endswith("s"):
        return float(t[:-1]) * 1e3
    return float(t)


def parse_plan(spec: str) -> FaultPlan:
    rules: List[FaultRule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"bad PIO_FAULTS rule {part!r} "
                             "(want point:kind[:args])")
        point, kind, args = fields[0], fields[1], fields[2:]
        if kind == "delay":
            if not args:
                raise ValueError(f"delay rule {part!r} needs a duration")
            delay = _parse_duration_ms(args[0])
            p = float(args[1]) if len(args) > 1 else 1.0
            mc = int(args[2]) if len(args) > 2 else None
            rules.append(FaultRule(point, "delay", p, delay, mc))
        elif kind == "error":
            p = float(args[0]) if args else 1.0
            mc = int(args[1]) if len(args) > 1 else None
            rules.append(FaultRule(point, "error", p, max_count=mc))
        else:
            raise ValueError(f"unknown fault kind in {part!r}")
    return FaultPlan(rules)


# -- process-wide plan state ------------------------------------------------

_installed: Optional[FaultPlan] = None
# (spec, plan) cache so PIO_FAULTS is re-parsed only when it changes.
_env_cache: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)
_state_lock = threading.Lock()


def install(plan) -> FaultPlan:
    """Programmatic plan (tests, drills); overrides PIO_FAULTS until
    :func:`clear`.  Accepts a :class:`FaultPlan` or a spec string."""
    global _installed
    if isinstance(plan, str):
        plan = parse_plan(plan)
    with _state_lock:
        _installed = plan
    return plan


def clear() -> None:
    global _installed, _env_cache
    with _state_lock:
        _installed = None
        _env_cache = (None, None)


def _current_plan() -> Optional[FaultPlan]:
    if _installed is not None:
        return _installed
    spec = os.environ.get("PIO_FAULTS")
    if not spec:
        return None
    global _env_cache
    with _state_lock:
        if _env_cache[0] != spec:
            _env_cache = (spec, parse_plan(spec))
        return _env_cache[1]


def active() -> bool:
    """Whether a fault plan is installed or set by ``PIO_FAULTS``."""
    return _current_plan() is not None


def fault_point(name: str) -> None:
    """Instrument a code path: no-op unless a matching rule is active."""
    plan = _current_plan()
    if plan is not None:
        plan.apply(name)


# -- storage base-layer hook ------------------------------------------------

# Repository methods share fault points by intent, not by exact name —
# ``storage.create`` covers every write path a "storage.create:error"
# rule should break, whichever insert variant the server picked.
_EVENTS_POINTS = {
    "insert": "storage.create",
    "insert_batch": "storage.create",
    "create_batch": "storage.create",
    "insert_columnar": "storage.create",
    "find": "storage.find",
    "find_columnar": "storage.find",
    "aggregate_properties": "storage.find",
    "get": "storage.get",
    "delete": "storage.delete",
    "remove": "storage.delete",
    "init": "storage.init",
}


class _FaultyRepo:
    """Transparent proxy running a fault point before each repo call."""

    def __init__(self, inner: Any, points: dict):
        self._inner = inner
        self._points = points

    def __getattr__(self, attr: str) -> Any:
        val = getattr(self._inner, attr)
        if not callable(val):
            return val
        point = self._points.get(attr, f"storage.{attr}")

        def wrapped(*args, **kwargs):
            fault_point(point)
            return val(*args, **kwargs)

        wrapped.__name__ = attr
        return wrapped


def wrap_events(events: Any) -> Any:
    """Wrap an Events repository with fault points when a plan is active
    (the storage registry calls this on every ``get_events()``, so a plan
    installed mid-process takes effect without rebuilding storage)."""
    if _current_plan() is None:
        return events
    return _FaultyRepo(events, _EVENTS_POINTS)


# Model-lifecycle repositories: the engine server's staged reload reads
# engine instances and model blobs, so a "storage.find:error" rule can
# break a reload and fail-closed serving is testable.
_INSTANCES_POINTS = {
    "get": "storage.find",
    "get_all": "storage.find",
    "get_latest_completed": "storage.find",
    "get_completed": "storage.find",
    "insert": "storage.create",
    "update": "storage.create",
    "delete": "storage.delete",
}

_MODELS_POINTS = {
    "get": "storage.find",
    "insert": "storage.create",
    "delete": "storage.delete",
}


def wrap_instances(instances: Any) -> Any:
    """Fault seam over an EngineInstances repository (reload reads)."""
    if _current_plan() is None:
        return instances
    return _FaultyRepo(instances, _INSTANCES_POINTS)


def wrap_models(models: Any) -> Any:
    """Fault seam over a Models (blob store) repository (reload reads)."""
    if _current_plan() is None:
        return models
    return _FaultyRepo(models, _MODELS_POINTS)


# Shared spill queue: every queue op is individually breakable so a
# drill can stage a lease steal ("spillq.lease:error"
# on one instance), an expired-lease race, or a storage error mid-ack
# ("spillq.ack:error:1.0:1" — the records stay leased, expire, and
# another drainer replays them; idempotency tokens keep that
# exactly-once).
_SPILLQ_POINTS = {
    "enqueue": "spillq.enqueue",
    "lease": "spillq.lease",
    "ack": "spillq.ack",
    "nack": "spillq.nack",
    "dead_letter": "spillq.dead_letter",
    "requeue_dead": "spillq.requeue_dead",
    "stats": "spillq.stats",
    "peek": "spillq.stats",
}

_KV_POINTS = {
    "get": "kv.get",
    "count": "kv.get",
    "put": "kv.put",
    "prune": "kv.put",
    "delete": "kv.delete",
}


def wrap_spill_queues(queues: Any) -> Any:
    """Fault seam over a SpillQueues repository (the shared backplane)."""
    if _current_plan() is None:
        return queues
    return _FaultyRepo(queues, _SPILLQ_POINTS)


def wrap_kv(kv: Any) -> Any:
    """Fault seam over a KV repository (the durable fold-in cache)."""
    if _current_plan() is None:
        return kv
    return _FaultyRepo(kv, _KV_POINTS)
