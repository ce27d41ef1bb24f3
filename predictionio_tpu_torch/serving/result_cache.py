"""Serve-side result cache keyed by (generation fingerprint, canonical query).

Port of ``predictionio_tpu/serving/result_cache.py``.  The dominant
production request shape is a repeat: Zipf-skewed user traffic means the
same hot user asks the same query seconds apart, and without this module
every repeat pays the full scheduler dispatch — admission, micro-batch
wait, the retrieval rung on the card, serialize.  The cache turns that
repeat into a dictionary read, and sidesteps invalidation the way the
shared fold-in cache does: the **generation fingerprint is part of the
key**.  Every reload swaps to a different engine-instance id, so every
entry filled under the old generation misses *by construction*.

Layout
------
- :func:`canonical_query` — ONE serialization for the query half of the
  key: sorted keys, fields equal to the query dataclass defaults stripped
  (so an explicit ``num=10`` and an omitted ``num`` share an entry),
  integral floats normalized (``10.0`` == ``10``), compact separators.
  Queries that carry per-request state (``blackList`` etc.) serialize it
  verbatim and therefore key *distinctly*.
- :class:`ResultCache` — per-instance LRU bounded by entries AND bytes,
  an optional fleet tier on the storage's shared ``KV``
  (write-through on positive fill, read-through on local miss; a KV
  error degrades to LRU-only with a cooldown so a dead KV costs one
  timeout per cooldown window, not one per request), and short-TTL
  negative caching so an unknown-entity query storm doesn't punch
  through to the fold-in path on every request.

Mid-flight swap safety: the handler fills under the generation the
batcher *stamped on the request's waterfall at dispatch*, never under
"whatever is current at hand-back".  :meth:`ResultCache.fill` resolves it
through a bounded generation→fingerprint map maintained by
:meth:`on_generation`; a generation the map does not know — ``None``
included — drops the fill (counted, never mis-keyed).

The key holds only the instance id and the query, so an answer that
depends on mutable state besides the model would outlive that state.
An algorithm whose ``predict`` reads such state (ecommerce's live
unavailable list and seen items) declares ``reads_live_state = True``;
the engine server reads the attribute at deploy and at every swap and
then neither looks up nor fills the cache for that generation, while
the other templates keep it.  That was chosen over putting the live
state's version into the key: the state is event-store rows with no
version to read, and reading them on every request to build a key would
cost what the cache saves.  The reference has no such bypass and serves
the cached answer (F7).

Knobs (prefix ``PIO_RESULT_CACHE``; the kill switch registers ZERO
instruments):

======================================  =====================================
``PIO_RESULT_CACHE``                    master switch (default on)
``PIO_RESULT_CACHE_SIZE``               max entries per instance (10000)
``PIO_RESULT_CACHE_BYTES``              max serialized bytes (64 MiB)
``PIO_RESULT_CACHE_NEG_TTL_S``          empty-result TTL seconds (5.0)
``PIO_RESULT_CACHE_SHARED``             fleet tier over the shared KV (off)
======================================  =====================================

All ``pio_result_cache_*`` instruments register in THIS module and
nowhere else (the reference's ``tools/lint_cache.py`` rule, which the
port's tests hold its ``server/`` and ``serving/`` to).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = [
    "CacheHit",
    "RESULT_CACHE_METRICS",
    "ResultCache",
    "ResultCacheConfig",
    "canonical_query",
    "query_defaults",
]

logger = logging.getLogger(__name__)

#: every instrument this module owns (kill-switch tests assert ZERO of these
#: exist when ``PIO_RESULT_CACHE=off``).
RESULT_CACHE_METRICS = (
    "pio_result_cache_hits_total",
    "pio_result_cache_misses_total",
    "pio_result_cache_fills_total",
    "pio_result_cache_evictions_total",
    "pio_result_cache_entries",
    "pio_result_cache_bytes",
    "pio_result_cache_hit_rate",
    "pio_result_cache_hit_age_s",
    "pio_result_cache_shared_errors_total",
)

#: age-at-hit buckets (seconds).  The interesting question is "how stale is
#: the fast path" — sub-second through the half-hour an LRU-resident entry
#: can plausibly live between promotions.
HIT_AGE_BUCKETS_S = (0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0)

#: generations remembered for fill attribution.  Requests outlive at most a
#: handful of swaps (deadline-bounded), so a short tail is plenty; anything
#: older is dropped rather than risked against a recycled id.
_GEN_MAP_KEEP = 8

#: after a shared-KV error, stay local-only this long (seconds) so a dead
#: backplane costs one failed round-trip per window, not one per request.
_SHARED_COOLDOWN_S = 30.0

#: write-throughs between shared-tier prunes (mirrors the fold-in cache's
#: every-256th-put cadence).
_SHARED_PRUNE_EVERY = 256


# --------------------------------------------------------------------------
# canonical query serialization
# --------------------------------------------------------------------------

_defaults_cache: Dict[type, Dict[str, Any]] = {}
_defaults_lock = threading.Lock()


def query_defaults(query_class: type) -> Dict[str, Any]:
    """Field-name → default for a query dataclass (memoized per class).

    ``default_factory`` fields are materialized ONCE; factories on query
    dataclasses produce empty containers, which compare by value, so a
    single materialization is safe to reuse for equality checks.
    """
    with _defaults_lock:
        d = _defaults_cache.get(query_class)
        if d is not None:
            return d
    out: Dict[str, Any] = {}
    if dataclasses.is_dataclass(query_class):
        for f in dataclasses.fields(query_class):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
    with _defaults_lock:
        _defaults_cache[query_class] = out
    return out


def _canon_value(v: Any) -> Any:
    """Normalize one value: integral floats become ints (``10.0`` and ``10``
    are the same query), containers recurse.  Anything json.dumps can't
    handle surfaces as TypeError at serialization time — the caller treats
    that query as uncacheable."""
    if isinstance(v, float) and v.is_integer():
        return int(v)
    if isinstance(v, dict):
        return {k: _canon_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon_value(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(_canon_value(x) for x in v)
    return v


def canonical_query(query: Any,
                    defaults: Optional[Dict[str, Any]] = None) -> str:
    """THE canonical serialization of a query for cache keying.

    Accepts the bound query dataclass (the normal server path) or a plain
    dict (tests, tools).  Fields whose value equals the query class default
    are stripped, so ``{"user": "u1"}`` and ``{"user": "u1", "num": 10}``
    share an entry when 10 is the default; key order never matters (sorted
    keys); integral floats normalize (JSON clients that send ``num: 10.0``).

    Raises TypeError for values JSON can't represent — callers bypass the
    cache for such queries rather than guessing at a key.
    """
    if dataclasses.is_dataclass(query) and not isinstance(query, type):
        if defaults is None:
            defaults = query_defaults(type(query))
        doc = {f.name: getattr(query, f.name)
               for f in dataclasses.fields(query)}
    elif isinstance(query, dict):
        doc = dict(query)
        defaults = defaults or {}
    else:
        raise TypeError(f"uncacheable query type {type(query).__name__}")
    canon = {}
    for k, v in doc.items():
        cv = _canon_value(v)
        if k in defaults and cv == _canon_value(defaults[k]):
            continue
        canon[k] = cv
    return json.dumps(canon, sort_keys=True, separators=(",", ":"))


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResultCacheConfig:
    enabled: bool = True
    max_entries: int = 10000
    max_bytes: int = 64 * 1024 * 1024
    neg_ttl_s: float = 5.0
    shared: bool = False

    @classmethod
    def from_env(cls, env=None) -> "ResultCacheConfig":
        import os

        env = os.environ if env is None else env

        def _i(key: str, default: int) -> int:
            raw = env.get(key)
            if raw is None or not str(raw).strip():
                return default
            try:
                return max(0, int(str(raw).strip()))
            except ValueError:
                logger.warning("bad %s=%r; using %s", key, raw, default)
                return default

        def _f(key: str, default: float) -> float:
            raw = env.get(key)
            if raw is None or not str(raw).strip():
                return default
            try:
                return max(0.0, float(str(raw).strip()))
            except ValueError:
                logger.warning("bad %s=%r; using %s", key, raw, default)
                return default

        return cls(
            enabled=env_bool(env.get("PIO_RESULT_CACHE"), True),
            max_entries=_i("PIO_RESULT_CACHE_SIZE", 10000),
            max_bytes=_i("PIO_RESULT_CACHE_BYTES", 64 * 1024 * 1024),
            neg_ttl_s=_f("PIO_RESULT_CACHE_NEG_TTL_S", 5.0),
            shared=env_bool(env.get("PIO_RESULT_CACHE_SHARED"), False),
        )


# --------------------------------------------------------------------------
# cache proper
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CacheHit:
    """What :meth:`ResultCache.lookup` hands the request handler.

    ``result_json`` is the cached serialization itself: the hit path hands
    ``result_bytes`` straight to the transport, so a hit never pays a
    parse + re-dump of a document that is already exactly the response
    body.  ``result`` deserializes FRESH per access — a caller that does
    want the document may change it without corrupting the cached entry.
    ``generation`` is the generation the entry was *filled* under: the hit
    path stamps it on the waterfall so attribution and the quality
    layer's serve id describe the answer actually served.
    """

    result_json: str
    generation: int
    fingerprint: str
    age_s: float
    tier: str            # "local" | "shared"
    negative: bool

    @property
    def result(self) -> Any:
        return json.loads(self.result_json)

    @property
    def result_bytes(self) -> bytes:
        return self.result_json.encode("utf-8")


class _Entry:
    __slots__ = ("value_json", "generation", "filled_at", "filled_wall",
                 "negative", "nbytes")

    def __init__(self, value_json: str, generation: int, filled_at: float,
                 filled_wall: float, negative: bool):
        self.value_json = value_json
        self.generation = generation
        self.filled_at = filled_at
        self.filled_wall = filled_wall
        self.negative = negative
        self.nbytes = len(value_json)


class ResultCache:
    """Per-instance LRU + optional shared fleet tier, generation-keyed.

    Thread-safe; the LRU lock is held only for dict work, never across KV
    I/O.  A KV blip never fails a request: the shared tier degrades to
    LRU-only and retries after a cooldown.
    """

    def __init__(self, config: Optional[ResultCacheConfig] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 kv: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        self.config = config or ResultCacheConfig.from_env()
        self._registry = registry or get_registry()
        self._kv = kv
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str], _Entry]" = OrderedDict()
        self._bytes = 0
        self._enabled = self.config.enabled
        self._generation: Optional[int] = None
        self._fingerprint: Optional[str] = None
        self._gen_fp: "OrderedDict[int, str]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._puts = 0
        self._shared_down_until = 0.0
        self._metrics_ready = False
        if self._enabled:
            self._ensure_metrics()

    # -- instruments (single-owner family; zero with the kill switch) ------

    def _ensure_metrics(self) -> None:
        if self._metrics_ready:
            return
        r = self._registry
        self._m_hits = r.counter(
            "pio_result_cache_hits_total",
            "result-cache hits by tier", ("tier",))
        self._m_misses = r.counter(
            "pio_result_cache_misses_total", "result-cache misses")
        self._m_fills = r.counter(
            "pio_result_cache_fills_total",
            "result-cache fills by kind", ("kind",))
        self._m_evict = r.counter(
            "pio_result_cache_evictions_total", "entries evicted (LRU)")
        self._m_entries = r.gauge(
            "pio_result_cache_entries", "resident entries")
        self._m_bytes = r.gauge(
            "pio_result_cache_bytes", "resident serialized bytes")
        self._m_rate = r.gauge(
            "pio_result_cache_hit_rate", "hits / lookups since start")
        self._m_age = r.histogram(
            "pio_result_cache_hit_age_s", "entry age at hit (seconds)",
            buckets=HIT_AGE_BUCKETS_S)
        self._m_shared_err = r.counter(
            "pio_result_cache_shared_errors_total",
            "shared-tier KV errors (degraded to local)")
        self._metrics_ready = True

    # -- lifecycle ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, flag: bool) -> None:
        """Runtime toggle (bench A/B).  Enabling late registers the
        instrument family on first use."""
        self._enabled = bool(flag)
        if self._enabled:
            self._ensure_metrics()

    def on_generation(self, generation: int, fingerprint: str) -> None:
        """Swap the active (generation, fingerprint) pair.

        Called under the server's swap lock at reload/rollback.  Old
        entries stay resident keyed by their own fingerprint — a rollback
        that restores a previous instance id revalidates them for free;
        otherwise LRU churn retires them.
        """
        with self._lock:
            self._generation = int(generation)
            self._fingerprint = str(fingerprint)
            self._gen_fp[self._generation] = self._fingerprint
            while len(self._gen_fp) > _GEN_MAP_KEEP:
                self._gen_fp.popitem(last=False)

    def clear(self) -> None:
        """Drop every resident entry (counters keep their history)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
        if self._metrics_ready:
            self._m_entries.set(0)
            self._m_bytes.set(0)

    # -- read path ---------------------------------------------------------

    def lookup(self, canon: str) -> Optional[CacheHit]:
        """Local LRU first, then (on miss) the shared tier.  Negative
        entries past their TTL are retired inline and count as misses."""
        if not self._enabled:
            return None
        now = self._clock()
        fp = self._fingerprint
        if fp is None:
            return None
        key = (fp, canon)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if e.negative and now - e.filled_at > self.config.neg_ttl_s:
                    self._entries.pop(key, None)
                    self._bytes -= e.nbytes + len(canon)
                    e = None
                else:
                    self._entries.move_to_end(key)
        if e is not None:
            self._hits += 1
            age = max(0.0, now - e.filled_at)
            self._m_hits.inc(tier="local")
            self._m_age.observe(age)
            self._note_rate()
            return CacheHit(result_json=e.value_json,
                            generation=e.generation, fingerprint=fp,
                            age_s=age, tier="local", negative=e.negative)
        hit = self._shared_get(fp, canon, now)
        if hit is not None:
            self._hits += 1
            self._m_hits.inc(tier="shared")
            self._m_age.observe(hit.age_s)
            self._note_rate()
            return hit
        self._misses += 1
        self._m_misses.inc()
        self._note_rate()
        return None

    # -- write path --------------------------------------------------------

    def fill(self, canon: str, result: Any, generation: Optional[int],
             ) -> str:
        """Insert a scheduler hand-back under the generation the batcher
        STAMPED at dispatch — never "current".  Returns the fill kind:
        ``positive`` | ``negative`` | ``dropped`` | ``disabled``.

        A generation the map no longer knows (ancient in-flight request
        racing many swaps) is dropped: mis-keying generation A's answer
        under B's fingerprint is the one corruption this design must never
        allow.
        """
        if not self._enabled:
            return "disabled"
        if generation is None:
            self._m_fills.inc(kind="dropped")
            return "dropped"
        with self._lock:
            fp = self._gen_fp.get(int(generation))
        if fp is None:
            self._m_fills.inc(kind="dropped")
            return "dropped"
        try:
            value_json = json.dumps(result, separators=(",", ":"))
        except (TypeError, ValueError):
            self._m_fills.inc(kind="dropped")
            return "dropped"
        negative = self._is_negative(result)
        now = self._clock()
        wall = self._wall()
        e = _Entry(value_json, int(generation), now, wall, negative)
        key = (fp, canon)
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes + len(canon)
            self._entries[key] = e
            self._bytes += e.nbytes + len(canon)
            while self._entries and (
                    len(self._entries) > self.config.max_entries
                    or self._bytes > self.config.max_bytes):
                k, v = self._entries.popitem(last=False)
                self._bytes -= v.nbytes + len(k[1])
                evicted += 1
            n, b = len(self._entries), self._bytes
        if evicted:
            self._m_evict.inc(evicted)
        self._m_entries.set(n)
        self._m_bytes.set(max(0, b))
        kind = "negative" if negative else "positive"
        self._m_fills.inc(kind=kind)
        if not negative:
            # negatives are NEVER shared: one instance's fold-in gap is not
            # fleet truth, and a 5 s local TTL does not survive a KV hop.
            self._shared_put(fp, canon, value_json, int(generation), wall)
        return kind

    # -- shared tier (the storage's KV; blips degrade to LRU-only) ---------

    @staticmethod
    def _ns(fingerprint: str) -> str:
        return f"resultcache:{fingerprint}"

    @staticmethod
    def _shared_key(canon: str) -> str:
        return hashlib.sha1(canon.encode("utf-8")).hexdigest()

    def _shared_ok(self, now: float) -> bool:
        return (self.config.shared and self._kv is not None
                and now >= self._shared_down_until)

    def _shared_trip(self, now: float, what: str) -> None:
        self._m_shared_err.inc()
        self._shared_down_until = now + _SHARED_COOLDOWN_S
        logger.warning("result-cache shared tier %s failed; local-only for "
                       "%.0fs", what, _SHARED_COOLDOWN_S, exc_info=True)

    def _shared_get(self, fp: str, canon: str, now: float,
                    ) -> Optional[CacheHit]:
        if not self._shared_ok(now):
            return None
        try:
            raw = self._kv.get(self._ns(fp), self._shared_key(canon))
        except Exception:
            self._shared_trip(now, "get")
            return None
        if raw is None:
            return None
        try:
            doc = json.loads(raw.decode("utf-8"))
            value_json = json.dumps(doc["r"], separators=(",", ":"))
            gen = int(doc["g"])
            age = max(0.0, self._wall() - float(doc["t"]))
        except Exception:
            return None  # foreign bytes in the namespace: treat as miss
        # adopt into the local LRU so the next hit skips the KV round-trip;
        # filled_at is back-dated so age-at-hit stays honest.
        e = _Entry(value_json, gen, now - age, float(doc["t"]), False)
        key = (fp, canon)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes + len(canon)
            self._entries[key] = e
            self._bytes += e.nbytes + len(canon)
            n, b = len(self._entries), self._bytes
        self._m_entries.set(n)
        self._m_bytes.set(max(0, b))
        return CacheHit(result_json=value_json, generation=gen,
                        fingerprint=fp, age_s=age, tier="shared",
                        negative=False)

    def _shared_put(self, fp: str, canon: str, value_json: str,
                    generation: int, wall: float) -> None:
        now = self._clock()
        if not self._shared_ok(now):
            return
        payload = json.dumps(
            {"r": json.loads(value_json), "g": generation, "t": wall},
            separators=(",", ":")).encode("utf-8")
        try:
            self._kv.put(self._ns(fp), self._shared_key(canon), payload)
            self._puts += 1
            if self._puts % _SHARED_PRUNE_EVERY == 0:
                self._kv.prune(self._ns(fp), keep=self.config.max_entries)
        except Exception:
            self._shared_trip(now, "put")

    # -- views -------------------------------------------------------------

    def _note_rate(self) -> None:
        total = self._hits + self._misses
        if total:
            self._m_rate.set(self._hits / total)

    def _is_negative(self, result: Any) -> bool:
        from predictionio_tpu_torch.obs.quality import extract_result_items

        return extract_result_items(result) == []

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            n, b = len(self._entries), self._bytes
            gen, fp = self._generation, self._fingerprint
        total = self._hits + self._misses
        return {
            "enabled": self._enabled,
            "entries": n,
            "bytes": max(0, b),
            "maxEntries": self.config.max_entries,
            "maxBytes": self.config.max_bytes,
            "hits": self._hits,
            "misses": self._misses,
            "hitRate": (self._hits / total) if total else None,
            "negTtlS": self.config.neg_ttl_s,
            "shared": bool(self.config.shared and self._kv is not None),
            "generation": gen,
            "fingerprint": fp,
        }
