"""Engine Server — the deploy target of the port.

Port of the core of ``predictionio_tpu/server/engine_server.py``
(reference: core/.../workflow/CreateServer.scala): resolve the latest
COMPLETED engine instance, load its models onto the serving device,
answer ``POST /queries.json`` through ``Algorithm.batch_predict`` →
``Serving.serve``, a status page at ``GET /`` and the process metrics at
``GET /metrics``.

Every query path is the batched dispatch :meth:`EngineServer.
_dispatch_batch` — the function the serving scheduler will drive: a
``/queries.json`` request is a cohort of one, ``query_batch`` (the
``pio batchpredict`` path) a cohort of many.  The scheduler and
micro-batcher, the result cache, staged-reload validation and rollback,
the quality/recall/SLO monitors and plugins arrive with later slices.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.controller import (
    Engine,
    EngineVariant,
    RuntimeContext,
)
from predictionio_tpu_torch.controller.params import bind_params
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.server.http import BaseHandler, ThreadingHTTPServer
from predictionio_tpu_torch.workflow.core_workflow import (
    WorkflowError,
    instance_engine_params,
    load_models,
)

logger = logging.getLogger(__name__)

__all__ = ["EngineServer", "QueryError"]

_DC_FIELDS: Dict[type, Tuple[str, ...]] = {}


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

    def record(self, ms: float, ok: bool) -> None:
        self.requests.inc()
        if not ok:
            self.errors.inc()
        self.latency.observe(ms)


class EngineServer:
    """Loads a trained engine instance and serves queries over HTTP.

    ``device`` is where models stage their tensors: the CUDA card by
    default, the CPU only when ``"cpu"`` is passed (the constructor
    raises when CUDA is absent otherwise).  ``storage`` is the
    :class:`~predictionio_tpu_torch.data.storage.Storage` the instance
    was persisted to.
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
    ):
        self.engine = engine
        self.variant = variant
        self.storage = storage
        self.ctx = RuntimeContext.create(storage=storage, device=device)
        self.host = host
        self.port = port
        self.stats = _QueryMetrics()
        self._swap_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._instance = None
        self._algorithms: List[Any] = []
        self._models: List[Any] = []
        self._serving = None
        self._loaded_at: Optional[_dt.datetime] = None
        self._generation = 0
        self.reload()

    # -- model lifecycle ----------------------------------------------------

    def reload(self) -> str:
        """Load the latest COMPLETED instance of the variant and swap it
        in whole; returns its id."""
        with self._reload_lock:
            instance = self.storage.get_engine_instances() \
                .get_latest_completed(self.variant.engine_factory,
                                      __version__, self.variant.variant_id)
            if instance is None:
                raise WorkflowError(
                    f"No COMPLETED engine instance for engine "
                    f"{self.variant.engine_factory!r} variant "
                    f"{self.variant.variant_id!r}.")
            models = load_models(self.engine, instance, self.ctx)
            engine_params = instance_engine_params(self.engine, instance)
            algorithms = self.engine.make_algorithms(engine_params)
            serving = self.engine.make_serving(engine_params)
            with self._swap_lock:
                self._instance = instance
                self._models = models
                self._algorithms = algorithms
                self._serving = serving
                self._loaded_at = _dt.datetime.now(_dt.timezone.utc)
                self._generation += 1
                gen = self._generation
            logger.info("Engine server loaded instance %s (generation %d)",
                        instance.id, gen)
            return instance.id

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

    def query(self, query_json: Any) -> Any:
        """One predict round trip: bind → supplement → per-algorithm
        predict → serve."""
        with self._swap_lock:
            algorithms, models, serving = (
                self._algorithms, self._models, self._serving)
        q = serving.supplement(self._bind_query(query_json))
        predictions = [a.predict(m, q) for a, m in zip(algorithms, models)]
        return self._result_to_json(serving.serve(q, predictions))

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

    def handle(self, method: str, path: str, body: bytes
               ) -> Tuple[int, Any]:
        try:
            if path == "/" and method == "GET":
                with self._swap_lock:
                    inst = self._instance
                    loaded = self._loaded_at
                    gen = self._generation
                return 200, {
                    "status": "alive",
                    "engineFactory": self.variant.engine_factory,
                    "variant": self.variant.variant_id,
                    "engineInstanceId": inst.id if inst else None,
                    "modelLoadedAt": loaded.isoformat() if loaded else None,
                    "modelGeneration": gen,
                    "device": str(self.ctx.device),
                    "version": __version__,
                }
            if path == "/metrics" and method == "GET":
                return 200, self.stats.registry.render()
            if path == "/queries.json" and method == "POST":
                t0 = time.perf_counter()
                try:
                    q = self._bind_query(json.loads(body.decode("utf-8")))
                    result = self._dispatch_batch([q])[0][0]
                except (QueryError, ValueError) as e:
                    self.stats.record((time.perf_counter() - t0) * 1e3, False)
                    return 400, {"message": str(e)}
                except Exception:
                    self.stats.record((time.perf_counter() - t0) * 1e3, False)
                    logger.exception("query failed")
                    return 500, {"message": "Internal server error."}
                self.stats.record((time.perf_counter() - t0) * 1e3, True)
                return 200, result
            if path == "/stop" and method == "POST":
                threading.Thread(target=self.stop, daemon=True).start()
                return 200, {"status": "stopping"}
            return 404, {"message": "Not Found"}
        except Exception:
            logger.exception("engine server internal error")
            return 500, {"message": "Internal server error."}

    def _make_handler(server_self):
        class Handler(BaseHandler):
            server_log_name = "engine-server"

            def pio_handle(self, method, path, body):
                return server_self.handle(method, path, body)

            def do_GET(self):  # noqa: N802
                self.dispatch("GET")

            def do_POST(self):  # noqa: N802
                self.dispatch("POST")

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
