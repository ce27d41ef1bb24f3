"""Engine Server — the deploy target of the port.

Port of the core of ``predictionio_tpu/server/engine_server.py``
(reference: core/.../workflow/CreateServer.scala): resolve the latest
COMPLETED engine instance, load its models onto the serving device,
answer ``POST /queries.json`` through ``Algorithm.batch_predict`` →
``Serving.serve``, a status page at ``GET /``, readiness at ``GET /ready``
(200 ``ready``; 503 ``degraded`` while the SLO engine trips, or
``unavailable`` with no model), counters at ``GET /stats.json``, the
process metrics at ``GET /metrics`` (``?exemplars=1`` adds the waterfall
buckets' trace ids), the model-quality document and promotion gate at
``GET /quality.json``, the trace ring at ``GET /traces.json`` and the
step timeline at ``GET /timeline.json``.

Every ``/queries.json`` goes bind → the result cache
(:mod:`predictionio_tpu_torch.serving.result_cache`) → the serving
scheduler (:class:`~predictionio_tpu_torch.serving.ServingScheduler`:
admission queue, micro-batcher, p99 autotuner) → the batched dispatch
:meth:`EngineServer._dispatch_batch`, so concurrent requests share one
``batch_predict`` call — on the card, one launch of the top-k kernel at
B = cohort size.  The answer fills the cache under the generation the
dispatch returned.  An engine whose algorithm reads live state at
predict time (``reads_live_state``, ecommerce's unavailable list and
seen items) keeps no cached answers: the server reads the attribute at
deploy and at every swap and neither looks up nor fills for it.
``query_batch`` (``pio batchpredict``, the native
frontend) calls the dispatch directly with its own cohort.  Server
plugins load from ``PIO_ENGINESERVER_PLUGINS`` (:mod:`.plugins`),
started last.

A new generation reaches the live server only through the STAGED
reload (``POST /reload``, optionally pinned to one
``{"engineInstanceId"}``): the storage reads run under the ``modeldata``
circuit breaker (``PIO_BREAKER_THRESHOLD`` / ``PIO_BREAKER_RECOVERY_S``),
the candidate is built off to the side, validated (every array finite,
then each ``PIO_CANARY_QUERIES`` golden query must predict), and swapped
in whole under the lock; the previous generation is kept for
``POST /admin/rollback`` (``PIO_RETAIN_PREVIOUS``, dropped after
``PIO_RETAIN_PREVIOUS_TTL_S``).  A failed reload keeps the last-good
generation serving and drops every reference to the candidate, so its
staged tensors leave the card.

Observability (:mod:`predictionio_tpu_torch.obs`): every
``/queries.json`` arms a latency waterfall (``ingress``, ``bind``,
``cache``, the batcher's stages, ``resume``; the transport adds
``shed_check`` and ``serialize`` and publishes ``pio_serve_stage_ms``
and the ``PIO_REQUEST_LOG`` wide event).  The SLO engine
(``PIO_SLO_*``, ``PIO_READY_SLO``) reads the serving counters and the
autotuner's saturation.  The quality monitor (``PIO_QUALITY*``,
``PIO_SHADOW_*``) samples served scores against the generation's
training scorecard, shadow-scores a slice of live queries on the
retained previous generation after a reload, and echoes
``X-PIO-Serve-Id`` for the event server's feedback join; the recall
monitor (``PIO_RECALL*``) re-ranks a sample of approximate-rung answers
exactly, off the serving thread.  ``/quality.json``'s ``gate.rollback``
is what the refresh daemon polls in its canary window.  The 200 body is
encoded in the handler (a cache hit and the miss that filled it answer
the same bytes), so that encoding lands in ``shed_check`` and
``serialize`` is the socket write alone.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from predictionio_tpu_torch.version import __version__
from predictionio_tpu_torch.config import env_bool
from predictionio_tpu_torch.controller import (
    Engine,
    EngineVariant,
    RuntimeContext,
)
from predictionio_tpu_torch.controller.params import bind_params
from predictionio_tpu_torch.data.storage import Storage, StorageUnavailable
from predictionio_tpu_torch.obs import (
    get_registry,
    publish_event,
    span,
    start_runtime_introspection,
)
from predictionio_tpu_torch.obs import waterfall as _waterfall
from predictionio_tpu_torch.obs.quality import SERVE_ID_HEADER, QualityMonitor
from predictionio_tpu_torch.obs.recall import RecallMonitor
from predictionio_tpu_torch.obs.slo import SLOConfig, SLOEngine
from predictionio_tpu_torch.resilience import deadline as _deadline
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.resilience.faults import fault_point
from predictionio_tpu_torch.resilience.policy import (
    CircuitBreaker,
    CircuitOpenError,
)
from predictionio_tpu_torch.resilience.supervision import (
    ModelValidationError,
    validate_model_finite,
)
from predictionio_tpu_torch.server.http import (
    BaseHandler,
    ThreadingHTTPServer,
    param_bool,
    timeline_payload,
    traces_payload,
)
from predictionio_tpu_torch.server.plugins import PluginManager
from predictionio_tpu_torch.serving import (
    QueueFull,
    ResultCache,
    ResultCacheConfig,
    SchedulerClosed,
    SchedulerConfig,
    SchedulerStalled,
    ServingScheduler,
    canonical_query,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    WorkflowError,
    data_watermark,
    instance_engine_params,
    load_models,
)

logger = logging.getLogger(__name__)

__all__ = ["EngineServer", "QueryError"]

_DC_FIELDS: Dict[type, Tuple[str, ...]] = {}
_JSON_CTYPE = "application/json; charset=UTF-8"


def _dc_to_json(obj: Any) -> Any:
    """Shallow-recursive dataclass→dict for predicted results (cached
    field walk — ``dataclasses.asdict`` deep-copies every leaf)."""
    fields = _DC_FIELDS.get(type(obj))
    if fields is None:
        fields = tuple(f.name for f in dataclasses.fields(obj))
        _DC_FIELDS[type(obj)] = fields
    return {name: _val_to_json(getattr(obj, name)) for name in fields}


def _val_to_json(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _dc_to_json(v)
    if isinstance(v, (list, tuple)):
        return [_val_to_json(x) for x in v]
    if isinstance(v, dict):
        return {k: _val_to_json(x) for k, x in v.items()}
    return v


def _reads_live_state(algorithms) -> bool:
    """Whether any algorithm's predict reads live state (F7): read once
    a swap, never a request."""
    return any(getattr(a, "reads_live_state", False) for a in algorithms)


class QueryError(ValueError):
    pass


class _QueryMetrics:
    """Serving instruments over the shared registry."""

    def __init__(self, registry=None):
        self.registry = registry or get_registry()
        self.requests = self.registry.counter(
            "pio_query_requests_total", "Predict requests served.")
        self.errors = self.registry.counter(
            "pio_query_errors_total", "Predict requests that failed.")
        self.latency = self.registry.histogram(
            "pio_query_latency_ms", "Predict request latency.")
        self.shed = self.registry.counter(
            "pio_deadline_shed_total",
            "Requests shed with 504 because their deadline expired.",
            ("server",))

    def record(self, ms: float, ok: bool) -> None:
        self.requests.inc()
        if not ok:
            self.errors.inc()
        self.latency.observe(ms)

    def snapshot(self) -> Dict[str, Any]:
        return {"requestCount": int(self.requests.value()),
                "errorCount": int(self.errors.value()),
                "latencyMs": {"p50": self.latency.quantile(0.5),
                              "p95": self.latency.quantile(0.95),
                              "p99": self.latency.quantile(0.99)}}


class _Generation:
    """One immutable loaded-model generation (instance + built serving
    stack).  The server swaps whole generations under the lock and keeps
    the previous one for ``POST /admin/rollback``."""

    __slots__ = ("instance", "models", "algorithms", "serving", "loaded_at",
                 "number")

    def __init__(self, instance, models, algorithms, serving, loaded_at,
                 number):
        self.instance = instance
        self.models = models
        self.algorithms = algorithms
        self.serving = serving
        self.loaded_at = loaded_at
        self.number = number


class EngineServer:
    """Loads a trained engine instance and serves queries over HTTP.

    ``device`` is where models stage their tensors: the CUDA card by
    default, the CPU only when ``"cpu"`` is passed (the constructor
    raises when CUDA is absent otherwise).  ``storage`` is the
    :class:`~predictionio_tpu_torch.data.storage.Storage` the instance
    was persisted to.  ``instance_id`` pins the engine instance served
    (``pio deploy --engine-instance-id``); by default the latest
    COMPLETED instance of the variant.  ``plugins`` is a
    :class:`~predictionio_tpu_torch.server.plugins.PluginManager`; by
    default the specs of ``PIO_ENGINESERVER_PLUGINS``.
    ``scheduler_config`` sets the serving scheduler (default
    :meth:`SchedulerConfig.from_env`); the result cache reads
    ``PIO_RESULT_CACHE*`` (:meth:`ResultCacheConfig.from_env`).
    ``breaker`` guards the reload's storage reads (default: the
    ``modeldata`` breaker from ``PIO_BREAKER_THRESHOLD`` and
    ``PIO_BREAKER_RECOVERY_S``).
    """

    def __init__(
        self,
        engine: Engine,
        variant: EngineVariant,
        storage: Storage,
        host: str = "0.0.0.0",
        port: int = 8000,
        *,
        device=None,
        instance_id: Optional[str] = None,
        plugins: Optional[PluginManager] = None,
        scheduler_config: Optional[SchedulerConfig] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.engine = engine
        self.variant = variant
        self.storage = storage
        self.requested_instance_id = instance_id
        self.ctx = RuntimeContext.create(storage=storage, device=device)
        self.host = host
        self.port = port
        self.stats = _QueryMetrics()
        # Runtime introspection: registers pio_device_mem_* so /metrics
        # exposes them from t=0, and starts the memory-sampler thread.
        start_runtime_introspection()
        self._swap_lock = threading.Lock()
        self._reload_lock = threading.Lock()  # serializes staged reloads
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._instance = None
        self._algorithms: List[Any] = []
        self._models: List[Any] = []
        self._serving = None
        self._loaded_at: Optional[_dt.datetime] = None
        self._generation = 0
        self._previous: Optional[_Generation] = None
        # True while the serving generation's algorithms read live state
        # at predict time: the result cache neither looks up nor fills.
        self._live_state = False
        self._last_reload: Dict[str, Any] = {}
        self.retry_after_s = int(os.environ.get("PIO_RETRY_AFTER_S", "5"))
        # The breaker around reload()'s storage reads: a dead model store
        # sheds fast with Retry-After instead of hanging every /reload.
        self._breaker = breaker or CircuitBreaker(
            "modeldata",
            failure_threshold=int(os.environ.get(
                "PIO_BREAKER_THRESHOLD", "5")),
            recovery_time_s=float(os.environ.get(
                "PIO_BREAKER_RECOVERY_S", "10")),
            failure_types=(StorageUnavailable, ConnectionError))
        # The retained previous generation doubles model memory while it
        # lives: off = never retain; a TTL > 0 drops it after the canary
        # window.
        self._retain_previous = env_bool(
            os.environ.get("PIO_RETAIN_PREVIOUS"), True)
        try:
            self._retain_ttl_s = float(
                os.environ.get("PIO_RETAIN_PREVIOUS_TTL_S", "0") or 0)
        except ValueError:
            self._retain_ttl_s = 0.0
        self._evict_timer: Optional[threading.Timer] = None
        reg = self.stats.registry
        self._reload_total = reg.counter(
            "pio_model_reload_total",
            "Staged model reloads by outcome.", ("result",))
        self._gen_gauge = reg.gauge(
            "pio_model_generation",
            "Monotonic generation of the model currently serving "
            "(bumped by every successful reload or rollback).")
        self._prev_retained = reg.gauge(
            "pio_model_previous_retained",
            "1 while a rollback generation is held in memory.")
        self._prev_evicted = reg.counter(
            "pio_model_previous_evicted_total",
            "Rollback generations dropped by the PIO_RETAIN_PREVIOUS_TTL_S "
            "eviction timer.")
        # Every /queries.json rides the admission queue + micro-batcher;
        # handlers never reach the model directly.
        self.scheduler = ServingScheduler(
            config=scheduler_config or SchedulerConfig.from_env())
        self.scheduler.register("default", self._dispatch_batch)
        # SLO engine: multi-window burn rates over the serving instruments
        # + the autotuner's persistent-floor saturation detector, combined
        # into the /ready degradation verdict (PIO_READY_SLO=off disables
        # the flip, never the gauges).
        self.slo = SLOEngine(SLOConfig.from_env(), registry=reg,
                             saturation_fn=self.scheduler.saturated)
        # Model-quality layer: sampled prediction stream + drift detection
        # + shadow-scored canary + feedback join, all behind the
        # PIO_QUALITY kill switch (off = inert no-op hooks).
        self.quality = QualityMonitor(registry=reg)
        # Retrieval-recall layer: sampled exact re-rank of approximate-
        # rung answers vs each generation's own baked recall scorecard,
        # folded into /quality.json's gate as a third verdict.
        self.recall = RecallMonitor(registry=reg)
        # The result cache: the first stop on the query path, keyed by
        # (instance id, canonical query) so a reload misses by
        # construction.  Its optional fleet tier rides the storage's
        # shared KV; a missing or broken KV degrades to the per-instance
        # LRU and never fails construction.
        cache_cfg = ResultCacheConfig.from_env()
        cache_kv = None
        if cache_cfg.shared:
            try:
                cache_kv = self.storage.get_kv()
            except Exception:
                logger.warning("result cache: shared tier unavailable; "
                               "running local-only", exc_info=True)
        self.result_cache = ResultCache(cache_cfg, registry=reg, kv=cache_kv)
        self.reload()
        # Server plugin seam (reference: EngineServerPlugin).  Started
        # LAST — after reload() — so plugins see a fully constructed
        # server with a loaded instance.
        self.plugins = plugins if plugins is not None else \
            PluginManager.from_env("PIO_ENGINESERVER_PLUGINS")
        self.plugins.start(self)

    # -- model lifecycle ----------------------------------------------------

    def _load_candidate(self, target_instance_id: Optional[str] = None):
        """Storage-read phase of the staged reload (runs under the
        breaker): resolve the target instance and load its models.
        ``target_instance_id`` pins the candidate (a rollout names one
        instance on every ``POST /reload``)."""
        instances = self.storage.get_engine_instances()
        requested = target_instance_id or self.requested_instance_id
        if requested:
            instance = instances.get(requested)
            if instance is None or instance.status != "COMPLETED":
                raise WorkflowError(
                    f"Engine instance {requested!r} not found "
                    "or not COMPLETED.")
        else:
            instance = instances.get_latest_completed(
                self.variant.engine_factory, __version__,
                self.variant.variant_id)
            if instance is None:
                raise WorkflowError(
                    f"No COMPLETED engine instance for engine id "
                    f"{self.variant.engine_factory!r} variant "
                    f"{self.variant.variant_id!r} — run `pio train` "
                    "first.")
        models = load_models(self.engine, instance, self.ctx)
        return instance, models

    @staticmethod
    def _canary_queries() -> List[Any]:
        """Golden queries from ``PIO_CANARY_QUERIES``: inline JSON array,
        or a path to a JSON-array / NDJSON file.  Empty/unset disables
        the canary stage."""
        raw = os.environ.get("PIO_CANARY_QUERIES", "").strip()
        if not raw:
            return []
        if raw.startswith("["):
            return json.loads(raw)
        with open(raw, encoding="utf-8") as f:
            text = f.read().strip()
        if text.startswith("["):
            return json.loads(text)
        return [json.loads(line) for line in text.splitlines() if line.strip()]

    def _validate_candidate(self, instance, models, algorithms,
                            serving) -> None:
        """Validation stage: finite params over every array the models
        carry, then each ``PIO_CANARY_QUERIES`` entry must predict
        without raising."""
        for i, model in enumerate(models):
            validate_model_finite(model, name=f"models[{i}]")
        for qi, query_json in enumerate(self._canary_queries()):
            try:
                self._predict_with(algorithms, models, serving, query_json)
            except Exception as e:
                raise ModelValidationError(
                    f"candidate instance {instance.id} failed canary "
                    f"query #{qi} ({query_json!r}): "
                    f"{type(e).__name__}: {e}") from e

    def _record_reload(self, result: str, error: Optional[str] = None,
                       **extra) -> None:
        self._reload_total.inc(result=result)
        self._last_reload = {
            "result": result,
            "at": _dt.datetime.now(_dt.timezone.utc).isoformat(),
            **({"error": error} if error else {}),
        }
        publish_event("model.reload", result=result,
                      **({"error": error[:200]} if error else {}), **extra)

    def reload(self, target_instance_id: Optional[str] = None) -> str:
        """Staged reload of the latest COMPLETED instance — or, with
        ``target_instance_id``, of exactly that instance.

        read (breaker-guarded) → build → validate → swap; any failure
        keeps the last-good generation serving and raises, holding no
        reference to the candidate.  The previous generation is retained
        for :meth:`rollback`."""
        with self._reload_lock:
            try:
                instance, models = self._breaker.call(
                    self._load_candidate, target_instance_id)
                engine_params = instance_engine_params(self.engine, instance)
                algorithms = self.engine.make_algorithms(engine_params)
                serving = self.engine.make_serving(engine_params)
                self._validate_candidate(instance, models, algorithms,
                                         serving)
            except Exception as e:
                # The candidate (and what a canary staged on the card)
                # dies with the exception's frames, so the log record
                # gets the text only: a handler that keeps its records
                # would keep the frames.
                self._record_reload("failed", error=str(e))
                logger.error("model reload failed (%s); %s", str(e),
                             "serving continues on the last-good model"
                             if self._instance is not None else
                             "no model is loaded yet")
                raise
            now = _dt.datetime.now(_dt.timezone.utc)
            with self._swap_lock:
                # PIO_RETAIN_PREVIOUS=off: never hold a second generation.
                self._previous = _Generation(
                    self._instance, self._models, self._algorithms,
                    self._serving, self._loaded_at, self._generation) \
                    if self._instance is not None and self._retain_previous \
                    else None
                self._instance = instance
                self._models = models
                self._algorithms = algorithms
                self._serving = serving
                self._loaded_at = now
                self._generation += 1
                self._live_state = _reads_live_state(algorithms)
                gen = self._generation
                prev = self._previous
                retained = prev is not None
            self._gen_gauge.set(gen)
            self._prev_retained.set(1 if retained else 0)
            # Quality re-anchor: the new generation's scorecard becomes
            # the drift baseline, and — while a previous generation is
            # retained for rollback — its predict stack shadow-scores a
            # sampled slice of live queries so the canary window can judge
            # old-vs-new divergence.  The closure is dropped on rollback
            # and eviction so the retained generation's tensors can leave
            # the card.
            shadow_fn = None
            if retained and self.quality.enabled:
                def shadow_fn(q, _gen=prev):
                    return self._shadow_predict(_gen, q)
            self.quality.on_generation(
                gen, models, shadow_fn=shadow_fn,
                prev_generation=prev.number if retained else None)
            # Recall re-anchor: arm the NEW generation's retriever hook
            # and judge it against its own baked recall scorecard.
            self.recall.on_generation(gen, models)
            # The new instance id becomes the cache key's fingerprint:
            # every entry of the previous generation misses from here.
            self.result_cache.on_generation(gen, instance.id)
            self._arm_eviction(gen)
            self._record_reload("ok", instance=instance.id, generation=gen)
            logger.info("Engine server loaded instance %s (generation %d)",
                        instance.id, gen)
            return instance.id

    def rollback(self) -> str:
        """Instant swap back to the retained previous generation
        (``POST /admin/rollback``).  The generations exchange places, so
        a second rollback returns; raises when none is retained."""
        with self._reload_lock:
            with self._swap_lock:
                prev = self._previous
                if prev is None:
                    raise WorkflowError(
                        "No previous model generation retained — nothing "
                        "to roll back to.")
                self._previous = _Generation(
                    self._instance, self._models, self._algorithms,
                    self._serving, self._loaded_at, self._generation)
                self._instance = prev.instance
                self._models = prev.models
                self._algorithms = prev.algorithms
                self._serving = prev.serving
                self._loaded_at = prev.loaded_at
                self._generation += 1
                self._live_state = _reads_live_state(prev.algorithms)
                gen = self._generation
                instance_id = prev.instance.id
                restored_models = prev.models
            self._gen_gauge.set(gen)
            self._prev_retained.set(1)
            # Quality: the rollback ends any shadow session (the "new"
            # generation it was judging is out) and re-anchors drift on
            # the RESTORED generation's own scorecard.
            self.quality.on_generation(gen, restored_models)
            self.recall.on_generation(gen, restored_models)
            # Restoring the previous instance id revalidates its surviving
            # cache entries for free — the fingerprint IS the key.
            self.result_cache.on_generation(gen, instance_id)
            # The rolled-from generation now sits in the previous slot;
            # it ages out on the same TTL as any other retained one.
            self._arm_eviction(gen)
            self._record_reload("rollback", instance=instance_id,
                                generation=gen)
            logger.warning("Engine server rolled back to instance %s "
                           "(generation %d)", instance_id, gen)
            return instance_id

    def _arm_eviction(self, generation: int) -> None:
        """(Re)start the retained-previous TTL timer for ``generation``.
        A timer armed for an older generation evicts nothing: the newer
        swap armed its own."""
        timer, self._evict_timer = self._evict_timer, None
        if timer is not None:
            timer.cancel()
        if self._retain_ttl_s <= 0:
            return
        with self._swap_lock:
            if self._previous is None:
                return
        timer = threading.Timer(self._retain_ttl_s, self._evict_previous,
                                args=(generation,))
        timer.daemon = True
        timer.start()
        self._evict_timer = timer

    def _evict_previous(self, expected_generation: int) -> bool:
        """Drop the retained rollback generation, and with it the last
        reference to its models (their tensors leave the card) — called
        by the TTL timer or directly.  False when a newer swap already
        owns the previous slot."""
        with self._swap_lock:
            if (self._generation != expected_generation
                    or self._previous is None):
                return False
            dropped = self._previous.number
            self._previous = None
        self._prev_retained.set(0)
        self._prev_evicted.inc()
        # The shadow session holds the evicted generation's predict
        # closure — drop it with the generation, or the eviction frees
        # nothing.
        self.quality.end_shadow("previous generation evicted")
        publish_event("model.previous_evicted",
                      generation=expected_generation,
                      evicted_generation=dropped)
        logger.info("Evicted retained previous model generation %d after "
                    "%.0fs TTL (rollback no longer available)",
                    dropped, self._retain_ttl_s)
        return True

    # -- query path ---------------------------------------------------------

    def _bind_query(self, obj: Any):
        if self.engine.query_class is None:
            return obj
        if dataclasses.is_dataclass(self.engine.query_class):
            try:
                return bind_params(self.engine.query_class, obj, _path="query")
            except TypeError as e:
                raise QueryError(str(e)) from e
        return self.engine.query_class(**obj)

    @staticmethod
    def _result_to_json(result: Any) -> Any:
        if dataclasses.is_dataclass(result) and not isinstance(result, type):
            return _dc_to_json(result)
        return result

    def _predict_with(self, algorithms, models, serving,
                      query_json: Any) -> Any:
        """bind → supplement → per-algorithm predict → serve against an
        EXPLICIT model set: the live generation (:meth:`query`) and the
        reload canary both ride this path."""
        with span("predict.bind"):
            q = self._bind_query(query_json)
        with span("predict.supplement"):
            q = serving.supplement(q)
        predictions = []
        for a, m in zip(algorithms, models):
            with span("predict.algorithm", algo=type(a).__name__):
                predictions.append(a.predict(m, q))
        with span("predict.serve"):
            return self._result_to_json(serving.serve(q, predictions))

    def _shadow_predict(self, gen: _Generation, q: Any) -> Any:
        """Score one BOUND query against a retained (non-serving)
        generation's full predict stack — the shadow-scoring canary's
        reference answer.  Runs on the shadow worker thread, never a
        handler thread."""
        q2 = gen.serving.supplement(q)
        preds = [a.predict(m, q2)
                 for a, m in zip(gen.algorithms, gen.models)]
        return self._result_to_json(gen.serving.serve(q2, preds))

    def query(self, query_json: Any) -> Any:
        """One predict round trip against the live generation."""
        with self._swap_lock:
            algorithms, models, serving = (
                self._algorithms, self._models, self._serving)
        return self._predict_with(algorithms, models, serving, query_json)

    def _dispatch_batch(self, bound_queries: List[Any]
                        ) -> Tuple[List[Any], int]:
        """THE batched dispatch: one ``batch_predict`` call per
        algorithm for the whole cohort, against ONE generation snapshot
        taken under a single swap-lock acquisition — a reload landing
        mid-batch flips the next batch, never splits this one.  Takes
        bound queries; returns the JSON results and the generation."""
        with self._swap_lock:
            algorithms, models, serving, generation = (
                self._algorithms, self._models, self._serving,
                self._generation)
        queries = [serving.supplement(q) for q in bound_queries]
        indexed = list(enumerate(queries))
        per_algo = [dict(a.batch_predict(m, indexed))
                    for a, m in zip(algorithms, models)]
        return [
            self._result_to_json(
                serving.serve(q, [pa[i] for pa in per_algo]))
            for i, q in indexed
        ], generation

    def query_batch(self, query_jsons: List[Any]) -> List[Any]:
        """Batched predict (``pio batchpredict``): the dispatch path
        without the generation tag."""
        return self._dispatch_batch(
            [self._bind_query(qj) for qj in query_jsons])[0]

    # -- HTTP ---------------------------------------------------------------

    def handle(self, method: str, path: str, body: bytes,
               params: Optional[Dict[str, List[str]]] = None) -> Tuple:
        params = params or {}
        try:
            fault_point("http.engine")
            if path == "/" and method == "GET":
                with self._swap_lock:
                    inst = self._instance
                    loaded = self._loaded_at
                    gen = self._generation
                    prev = self._previous
                wm = data_watermark(inst) if inst else None
                return 200, {
                    "status": "alive",
                    "engineFactory": self.variant.engine_factory,
                    "variant": self.variant.variant_id,
                    "engineInstanceId": inst.id if inst else None,
                    "modelLoadedAt": loaded.isoformat() if loaded else None,
                    "modelGeneration": gen,
                    # The served generation's data high-watermark: events
                    # before this instant are in the model.
                    "dataWatermark": wm.isoformat() if wm else None,
                    "refreshMode": (inst.env or {}).get("refreshMode")
                    if inst else None,
                    "lastReload": self._last_reload or None,
                    "rollbackAvailable": prev is not None,
                    "retainPreviousTtlS": self._retain_ttl_s or None,
                    "breaker": self._breaker.state,
                    "device": str(self.ctx.device),
                    "batcher": self.scheduler.snapshot(),
                    "resultCache": self.result_cache.snapshot(),
                    "slo": self.slo.snapshot(),
                    "version": __version__,
                }
            if path == "/ready" and method == "GET":
                # Readiness (vs "/" liveness): a model is loaded AND the
                # SLO/saturation signal is healthy — 503 rotates the
                # instance out of the LB pool (PIO_READY_SLO=off is the
                # operator escape hatch; hysteresis in the engine).
                with self._swap_lock:
                    inst = self._instance
                    serving = self._serving
                loaded = inst is not None and serving is not None
                slo_ok, slo_state = self.slo.ready()
                ok = loaded and slo_ok
                status = "ready" if ok else (
                    "degraded" if loaded else "unavailable")
                return (200 if ok else 503), {
                    "status": status,
                    "engineInstanceId": inst.id if inst else None,
                    "slo": slo_state,
                }
            if path == "/metrics" and method == "GET":
                # ?exemplars=1 appends the OpenMetrics trace-id suffixes
                # to the waterfall buckets — opt-in, classic scrapers
                # choke on them.
                return 200, self.stats.registry.render(
                    exemplars=param_bool(params, "exemplars"))
            if path == "/stats.json" and method == "GET":
                with self._swap_lock:
                    inst = self._instance
                wm = data_watermark(inst) if inst else None
                return 200, {**self.stats.snapshot(),
                             "batcher": self.scheduler.snapshot(),
                             "resultCache": self.result_cache.snapshot(),
                             "slo": self.slo.snapshot(),
                             "quality": self.quality.summary(),
                             "dataWatermark": wm.isoformat() if wm
                             else None}
            if path == "/quality.json" and method == "GET":
                # Drift vs the training scorecard, shadow-canary
                # divergence, online hit rate, and the promotion-gate
                # verdict the refresh daemon polls in its canary window;
                # the recall layer folds its verdict into the same gate.
                return 200, self.recall.augment_quality(
                    self.quality.payload())
            if path == "/traces.json" and method == "GET":
                # ?request_id= resolves one trace; ?min_ms=/?limit= bound
                # the view (the shared helper).
                return 200, traces_payload(params)
            if path == "/timeline.json" and method == "GET":
                # Step-timeline ring: ?model=/?n=/?format=chrome.
                return 200, timeline_payload(params)
            if path == "/reload" and method == "POST":
                return self._answer_reload(body)
            if path == "/admin/rollback" and method == "POST":
                try:
                    instance_id = self.rollback()
                except WorkflowError as e:
                    return 409, {"message": str(e)}
                return 200, {"status": "rolled_back",
                             "engineInstanceId": instance_id,
                             "generation": self._generation}
            if path == "/queries.json" and method == "POST":
                return self._answer_query(body)
            if path == "/stop" and method == "POST":
                # The handler stops the server once this answer is written
                # (Handler.do_POST).
                return 200, {"status": "stopping"}
            return 404, {"message": "Not Found"}
        except DeadlineExceeded as e:
            self.stats.shed.inc(server="engine")
            return 504, {"message": str(e)}
        except (ConnectionError, StorageUnavailable, CircuitOpenError) as e:
            # Injected faults, dead backends and the reload breaker
            # shedding are availability failures: 503 + Retry-After.  The
            # last-good model keeps serving throughout.
            return 503, {"message": f"Temporarily unavailable: {e}"}
        except Exception:
            logger.exception("engine server internal error")
            return 500, {"message": "Internal server error."}

    def _answer_reload(self, body: bytes) -> Tuple:
        """``POST /reload`` with an optional ``{"engineInstanceId"}``
        pin: 200 with the new generation; 409 when the candidate fails
        validation, or when a named candidate cannot be loaded; 400 for a
        body that is not JSON."""
        target = None
        if body:
            try:
                target = (json.loads(body.decode("utf-8"))
                          or {}).get("engineInstanceId")
            except (ValueError, AttributeError):
                return 400, {"message": "reload body must be JSON"}
        try:
            instance_id = self.reload(target)
        except ModelValidationError as e:
            # The last-good model keeps serving: a bad train is the
            # client's fault, not an availability failure.
            return 409, {"message": str(e), "status": "rejected"}
        except WorkflowError as e:
            if target:
                # A named candidate this server cannot load (unknown or
                # not COMPLETED) is rejected like a validation failure.
                return 409, {"message": str(e), "status": "rejected"}
            raise
        return 200, {"status": "reloaded",
                     "engineInstanceId": instance_id,
                     "generation": self._generation}

    def _answer_query(self, body: bytes) -> Tuple:
        """``POST /queries.json``: bind → result cache → scheduler →
        cache fill under the dispatch's generation → the respond gate.
        A 200 body is the compact JSON the cache keeps, so a hit and the
        miss that filled it answer the same bytes.  Arms the request's
        latency waterfall; the transport finalizes it after the write."""
        t0 = time.perf_counter()
        _waterfall.activate()
        try:
            # Shed BEFORE admission: a request whose budget is spent must
            # not occupy a queue slot.
            _deadline.check("predict")
            tb = time.perf_counter()
            # ingress: transport receipt → here (socket body read, trace
            # setup, routing, the deadline check) — real wall the
            # attestation contains, so the waterfall bills it.
            t0t = _waterfall.transport_start()
            if t0t is not None and tb > t0t:
                _waterfall.record_stage("ingress", (tb - t0t) * 1e3)
            # Bind BEFORE admission: a malformed query 400s on this thread
            # and never occupies a queue slot or fails its cohort.
            q = self._bind_query(json.loads(body.decode("utf-8")))
            _waterfall.record_stage("bind", (time.perf_counter() - tb) * 1e3)
            wf = _waterfall.current_waterfall()
            # ONE uniform draw per request: the prediction record stream,
            # shadow sampling, recall capture and the
            # PIO_REQUEST_LOG_SAMPLE wide-event sampler all compare this
            # same u against their own rates.
            u = self.quality.draw() if self.quality.enabled \
                else (self.recall.draw() if self.recall.enabled else None)
            if wf is not None and u is not None:
                wf.sample_u = u
            canon = None
            if self.result_cache.enabled and not self._live_state:
                tc = time.perf_counter()
                try:
                    canon = canonical_query(q)
                except TypeError:
                    canon = None  # uncacheable query shape
                hit = (self.result_cache.lookup(canon)
                       if canon is not None else None)
                # The lookup is stamped on misses too: it is real wall
                # the attestation contains.
                _waterfall.record_stage(
                    "cache", (time.perf_counter() - tc) * 1e3,
                    cacheHit=hit is not None)
                if hit is not None:
                    # A hit bypasses admission and batching but carries
                    # the FILL generation, so attribution and the serve
                    # id describe the answer actually served.
                    if wf is not None:
                        wf.note(generation=hit.generation,
                                cacheTier=hit.tier,
                                cacheAgeS=round(hit.age_s, 3))
                        wf.mark("handler_done")
                    # Same never-late-200 gate as the dispatch path.
                    _deadline.check("respond")
                    # Parse the document only when this request is
                    # quality-sampled: an unsampled hit serves the cached
                    # bytes untouched.
                    if (u is not None and self.quality.enabled
                            and u < self.quality.config.sample):
                        sid = self.quality.observe(
                            q, hit.result, hit.generation, u)
                        if sid is not None and wf is not None:
                            wf.note(serveId=sid)
                    self.stats.record((time.perf_counter() - t0) * 1e3, True)
                    return 200, hit.result_bytes, _JSON_CTYPE
            # The ONLY route to the model: admission queue → micro-batcher
            # → one vectorized dispatch for the cohort.
            try:
                result = self.scheduler.submit_and_wait("default", q)
            finally:
                # shed_check opens here: the transport stamps it from this
                # mark, so the segment between the scheduler hand-back and
                # the respond write is accounted.
                if wf is not None:
                    wf.mark("handler_done")
            generation = wf.attr("generation") if wf is not None else None
            # Fill under the generation the batcher STAMPED at dispatch —
            # never "current" — so a mid-flight reload cannot cache
            # generation A's answer under B's key.  Before the respond
            # gate: a late result still warms the cache for the retry.
            if canon is not None:
                self.result_cache.fill(canon, result, generation)
            # A result that arrived past its own deadline is never served
            # as a slow 200.
            _deadline.check("respond")
            # Quality record stream at the scheduler hand-back: one
            # sampled append, attributed to the dispatch's generation.
            sid = self.quality.observe(q, result, generation, u)
            if sid is not None and wf is not None:
                # Rides the waterfall into the wide event AND to the
                # transport hook that echoes it as X-PIO-Serve-Id.
                wf.note(serveId=sid)
            self.stats.record((time.perf_counter() - t0) * 1e3, True)
            return (200, json.dumps(result, separators=(",", ":")).encode(),
                    _JSON_CTYPE)
        except QueueFull as e:
            # Admission rejected: 429 + Retry-After (the transport adds
            # the hint) — the requests already admitted keep their
            # latency.
            self.stats.record((time.perf_counter() - t0) * 1e3, False)
            return 429, {"message": str(e)}
        except DeadlineExceeded as e:
            self.stats.shed.inc(server="engine")
            self.stats.record((time.perf_counter() - t0) * 1e3, False)
            return 504, {"message": str(e)}
        except (SchedulerStalled, SchedulerClosed) as e:
            self.stats.record((time.perf_counter() - t0) * 1e3, False)
            return 503, {"message": f"Temporarily unavailable: {e}"}
        except (QueryError, ValueError) as e:
            self.stats.record((time.perf_counter() - t0) * 1e3, False)
            return 400, {"message": str(e)}
        except Exception:
            self.stats.record((time.perf_counter() - t0) * 1e3, False)
            logger.exception("query failed")
            return 500, {"message": "Internal server error."}

    def _make_handler(server_self):
        class Handler(BaseHandler):
            server_log_name = "engine-server"
            trace_server_name = "engine"
            # Predicts are read-only: a 200 computed past its budget is
            # safely rewritten to 504 at the transport (never-late-200).
            shed_late_responses = True

            def pio_handle(self, method, path, params, body):
                return server_self.handle(method, path, body, params)

            def pio_shed(self):
                server_self.stats.shed.inc(server="engine")

            def pio_retry_after_s(self):
                # A breaker-open reload shed carries the breaker's own
                # recovery hint; other degraded answers the env default.
                open_in = server_self._breaker.retry_after_s()
                return max(1, int(open_in)) if open_in > 0 \
                    else server_self.retry_after_s

            def pio_on_complete(self, method, path, status, ms, body,
                                params):
                extra = dict(server_self.plugins.on_request(
                    f"{method} {path}", status, ms) or {}) \
                    if server_self.plugins else {}
                # Serve-id echo: the quality layer noted the sampled serve
                # on the request's waterfall; the client echoes it on its
                # feedback event (properties.pioServeId).
                wf = _waterfall.current_waterfall()
                sid = wf.attr("serveId") if wf is not None else None
                if sid:
                    extra[SERVE_ID_HEADER] = str(sid)
                return extra or None

            def do_GET(self):  # noqa: N802
                self.dispatch("GET")

            def do_POST(self):  # noqa: N802
                self.dispatch("POST")
                if urlparse(self.path).path == "/stop":
                    # Only now: `pio deploy` exits as soon as the serve
                    # loop ends, and a stop begun inside the handler could
                    # end it before the answer reached the client.
                    threading.Thread(target=server_self.stop,
                                     daemon=True).start()

        return Handler

    def start(self, block: bool = False) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        logger.info("Engine Server listening on %s:%d", self.host, self.port)
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)
        timer, self._evict_timer = self._evict_timer, None
        if timer is not None:
            timer.cancel()
        self.scheduler.close()
        self.quality.close()
        self.recall.close()
        self.plugins.stop()
