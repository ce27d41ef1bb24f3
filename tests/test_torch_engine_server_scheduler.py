"""The port's engine server with the serving scheduler and the result
cache, against the reference's, over HTTP on the CPU.

A tiny ALS model is trained by the JAX package (events → ``run_train``)
and carried into the port with ``wrapper_from_numpy``; each package's
``EngineServer`` serves it on port 0.  Checks:

- concurrent clients over HTTP: the same ids from both servers, scores
  within 1e-5;
- a repeated query is a result-cache hit once in each package;
- the same statuses under the same gated dispatch (the dispatch held on
  a ``threading.Event``): 429 at a full queue, 503 when the batcher
  stalls or the scheduler is closed, 504 when the deadline runs out in
  the queue, ``Retry-After`` on 429 and 503; the never-late-200 rewrite
  with its ``X-PIO-Deadline-Remaining-Ms`` attestation;
- the same keys in ``GET /`` and ``GET /stats.json``'s ``batcher`` and
  ``resultCache`` snapshots;
- the port's ``server/`` held to the reference's ``tools/lint_dispatch.py``
  rule 4 (no handler reaches the model but through the scheduler) and
  ``tools/lint_cache.py`` (one lookup/fill seam around
  ``submit_and_wait``, no serve-path memoization, the cache's metric
  family registered in one module);
- F7: with the cache on, both packages serve ecommerce's cached answer
  after a newer unavailable list, and the fresh one with
  ``PIO_RESULT_CACHE=0``.
"""

import ast
import http.client
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.obs import get_registry as jax_registry
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxEngineServer,
)
from predictionio_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu.workflow.core_workflow import run_train
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.obs import get_registry as port_registry
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.serving import SchedulerConfig
from predictionio_tpu_torch.templates.recommendation import (
    engine,
    wrapper_from_numpy,
)
from predictionio_tpu_torch.workflow.core_workflow import persist_instance

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS, RANK = 40, 30, 6
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": "schedparity"}},
    "algorithms": [{"name": "als",
                    "params": {"rank": RANK, "numIterations": 4,
                               "lambda_": 0.05, "seed": 2}}],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}
_ENV = ("PIO_RESULT_CACHE", "PIO_RETRIEVAL_RUNG", "PIO_BATCH_ENABLED",
        "PIO_QUEUE_DEPTH", "PIO_BATCH_MAX", "PIO_BATCH_WINDOW_MS",
        "PIO_QUEUE_WAIT_MAX_S", "PIO_RETRY_AFTER_S")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference's trained generation, its engine and variant, and
    the port's storage holding it carried in."""
    home = tmp_path_factory.mktemp("pio_home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith("PIO_STORAGE_") or k in _ENV:
                mp.delenv(k, raising=False)
        reset_storage()
        reset_observability()
        ctx = JaxContext.create(storage=jax_storage())
        app_id = ctx.storage.get_apps().insert(
            JaxApp(id=None, name="schedparity"))
        ctx.storage.get_events().init(app_id)
        rng = np.random.default_rng(4)
        ctx.storage.get_events().insert_batch([
            JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     properties=JaxDataMap(
                         {"rating": float(1 + 4 * rng.random())}))
            for u in range(N_USERS) for i in range(N_ITEMS)
            if (i + u) % 3 == 0 and rng.random() < 0.8], app_id)
        jeng = jax_engine()
        jvariant = JaxVariant.from_dict(VARIANT)
        run_train(jeng, jvariant, ctx)
        probe = JaxEngineServer(jeng, jvariant, ctx.storage)
        jw = probe._models[0]
        probe.stop()
        wrapper = wrapper_from_numpy(
            np.asarray(jax.device_get(jw.model.user_factors))[
                :len(jw.user_index)],
            np.asarray(jax.device_get(jw.model.item_factors))[
                :len(jw.item_index)],
            jw.user_index.to_numpy_keys(), jw.item_index.to_numpy_keys(),
            rank=RANK, implicit=jw.model.implicit)
        storage = Storage(memory_config(home / "port"))
        eng = engine()
        variant = EngineVariant.from_dict(PORT_VARIANT)
        persist_instance(eng, variant, [wrapper], storage)
        try:
            yield SimpleNamespace(jeng=jeng, jvariant=jvariant,
                                  jstorage=ctx.storage, eng=eng,
                                  variant=variant, storage=storage)
        finally:
            reset_storage()
            reset_observability()


@pytest.fixture()
def serve(trained, monkeypatch):
    """``serve(**scheduler_config)`` → (reference server, port server),
    both started on port 0; stopped at the end."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    made = []

    def make(**cfg):
        ref = JaxEngineServer(trained.jeng, trained.jvariant,
                              trained.jstorage, host="127.0.0.1", port=0,
                              scheduler_config=JaxSchedulerConfig(**cfg))
        port = EngineServer(trained.eng, trained.variant, trained.storage,
                            host="127.0.0.1", port=0, device="cpu",
                            scheduler_config=SchedulerConfig(**cfg))
        for srv in (ref, port):
            srv.start()
            made.append(srv)
        return ref, port

    yield make
    for srv in made:
        srv.stop()


def call(srv, method, path, body=None, headers=None):
    """(status, headers, parsed body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data, headers=headers or {})
        r = conn.getresponse()
        raw = r.read()
        return r.status, dict(r.getheaders()), json.loads(raw or b"null")
    finally:
        conn.close()


def _same_answer(got, want):
    gi = [h["item"] for h in got["itemScores"]]
    wi = [h["item"] for h in want["itemScores"]]
    assert sorted(gi) == sorted(wi), (gi, wi)
    np.testing.assert_allclose([h["score"] for h in got["itemScores"]],
                               [h["score"] for h in want["itemScores"]],
                               rtol=RTOL, atol=ATOL)


# -- answers over HTTP ------------------------------------------------------------

@pytest.mark.parametrize("clients", [1, 16])
def test_concurrent_clients_get_the_reference_answers(serve, clients):
    ref, port = serve()
    queries = [{"user": f"u{u}", "num": 1 + u % 7} for u in range(N_USERS)] \
        + [{"user": "ghost", "num": 4}]

    def ask(srv):
        with ThreadPoolExecutor(clients) as pool:
            return list(pool.map(
                lambda q: call(srv, "POST", "/queries.json", q), queries))

    before = port.scheduler.snapshot()["default"]["requests"]
    got, want = ask(port), ask(ref)
    for (gs, _, g), (ws, _, w) in zip(got, want):
        assert gs == ws == 200
        _same_answer(g, w)
    snap = port.scheduler.snapshot()["default"]
    assert snap["requests"] - before == len(queries)


def test_a_repeated_query_hits_once_in_each_package(serve):
    ref, port = serve()
    q = {"user": "u3", "num": 5}
    for srv, registry in ((ref, jax_registry()), (port, port_registry())):
        hits = registry.get("pio_result_cache_hits_total")
        before = hits.total() if hits is not None else 0.0
        first = call(srv, "POST", "/queries.json", q)
        second = call(srv, "POST", "/queries.json", q)
        assert first[0] == second[0] == 200 and first[2] == second[2]
        assert registry.get("pio_result_cache_hits_total").total() \
            == before + 1
        snap = srv.result_cache.snapshot()
        assert snap["hits"] == 1 and snap["generation"] == srv._generation
    _same_answer(call(port, "POST", "/queries.json", q)[2],
                 call(ref, "POST", "/queries.json", q)[2])


def test_status_and_stats_snapshots_have_the_same_keys(serve):
    ref, port = serve()
    for srv in (ref, port):
        assert call(srv, "POST", "/queries.json", {"user": "u1"})[0] == 200
    shapes = []
    for srv in (ref, port):
        _, _, root = call(srv, "GET", "/")
        _, _, stats = call(srv, "GET", "/stats.json")
        shapes.append({
            "root_batcher": sorted(root["batcher"]["default"]),
            "root_cache": sorted(root["resultCache"]),
            "stats_batcher": sorted(stats["batcher"]["default"]),
            "stats_cache": sorted(stats["resultCache"]),
            "stats": sorted(k for k in ("requestCount", "errorCount",
                                        "latencyMs") if k in stats)})
    assert shapes[0] == shapes[1]
    assert shapes[1]["stats"] == ["errorCount", "latencyMs", "requestCount"]


# -- statuses under one gated dispatch --------------------------------------------

class Gate:
    """Holds every dispatch of a server's batcher until released."""

    def __init__(self, srv):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.batcher = srv.scheduler._lanes["default"].batcher
        self.queue = srv.scheduler._lanes["default"].queue
        inner = self.batcher.dispatch_fn

        def held(queries):
            self.entered.set()
            assert self.release.wait(30)
            return inner(queries)

        self.batcher.dispatch_fn = held

    def wait_queued(self, n):
        deadline = time.monotonic() + 30
        while len(self.queue) < n and time.monotonic() < deadline:
            time.sleep(0.002)
        assert len(self.queue) >= n


def _scenario(srv, kind):
    """One scripted overload against ``srv``; returns [(status,
    Retry-After)] in request order."""
    gate = Gate(srv)
    out = {}
    pool = ThreadPoolExecutor(4)
    first = pool.submit(call, srv, "POST", "/queries.json", {"user": "u0"})
    assert gate.entered.wait(30)
    if kind == "queue_full":
        second = pool.submit(call, srv, "POST", "/queries.json",
                             {"user": "u1"})
        gate.wait_queued(1)
        out["third"] = call(srv, "POST", "/queries.json", {"user": "u2"})
        gate.release.set()
        out["second"] = second.result(30)
    elif kind == "stalled":
        out["second"] = call(srv, "POST", "/queries.json", {"user": "u1"})
        gate.release.set()
    elif kind == "deadline":
        out["second"] = call(srv, "POST", "/queries.json", {"user": "u1"},
                             headers={"X-PIO-Deadline-Ms": "150"})
        gate.release.set()
    elif kind == "closed":
        gate.release.set()
        first.result(30)
        srv.scheduler.close()
        out["second"] = call(srv, "POST", "/queries.json", {"user": "u5"})
    out["first"] = first.result(30)
    pool.shutdown()
    return {k: (v[0], v[1].get("Retry-After")) for k, v in sorted(out.items())}


@pytest.mark.parametrize("kind,cfg,want", [
    ("queue_full", {"queue_depth": 1, "window_ms": 0.0, "autotune": False},
     {"first": (200, None), "second": (200, None), "third": (429, "5")}),
    ("stalled", {"stall_s": 0.3, "window_ms": 0.0, "autotune": False},
     {"first": (503, "5"), "second": (503, "5")}),
    ("deadline", {"window_ms": 0.0, "autotune": False},
     {"first": (200, None), "second": (504, None)}),
    ("closed", {"window_ms": 0.0, "autotune": False},
     {"first": (200, None), "second": (503, "5")}),
])
def test_same_statuses_under_the_same_gated_dispatch(serve, kind, cfg,
                                                      want):
    ref, port = serve(**cfg)
    assert _scenario(port, kind) == _scenario(ref, kind) == want


def test_inline_admission_limit_answers_429_in_both(serve):
    ref, port = serve(enabled=False, queue_depth=0)
    got = [call(srv, "POST", "/queries.json", {"user": "u0"})
           for srv in (ref, port)]
    assert [(s, h.get("Retry-After")) for s, h, _ in got] == \
        [(429, "5")] * 2
    assert port_registry().get("pio_queue_rejected_total").value(
        model="default") >= 1


def test_late_2xx_rewritten_to_504_with_attestation(serve):
    ref, port = serve()
    for srv in (ref, port):
        real = srv.handle

        def slow_handle(method, path, body, params=None):
            time.sleep(0.05)      # blows the 20 ms budget below
            return 200, {"ok": 1}

        srv.handle = slow_handle
        status, headers, _ = call(srv, "POST", "/queries.json", {},
                                  headers={"X-PIO-Deadline-Ms": "20"})
        assert status == 504
        assert float(headers["X-PIO-Deadline-Remaining-Ms"]) <= 0
        srv.handle = real
        status, headers, _ = call(srv, "POST", "/queries.json",
                                  {"user": "u0", "num": 2})
        assert status == 200 and "X-PIO-Deadline-Remaining-Ms" not in headers
    assert port_registry().get("pio_deadline_shed_total").value(
        server="engine") >= 1


def test_bad_queries_answer_400_and_take_no_queue_slot(serve):
    ref, port = serve(queue_depth=1, window_ms=0.0, autotune=False)
    for srv in (ref, port):
        for body in ({"user": 3.5}, {"num": "x"}):
            assert call(srv, "POST", "/queries.json", body)[0] == 400
    assert port.stats.errors.value() >= 2


# -- the reference's lints, on the port's server/ and serving/ ------------------

def _port_sources(*dirs):
    for d in dirs:
        for path in sorted((ROOT / "predictionio_tpu_torch" / d).glob("*.py")):
            yield path


def test_port_server_passes_the_dispatch_lint():
    from tools.lint_dispatch import check_source

    for path in _port_sources("server"):
        assert check_source(path.read_text(), str(path)) == []


def test_port_serve_path_passes_the_cache_lint():
    from tools.lint_cache import check_source

    for path in _port_sources("server", "serving"):
        # the lint keys its rules on the reference's package path
        alias = str(path).replace("predictionio_tpu_torch/",
                                  "predictionio_tpu/")
        assert check_source(path.read_text(), alias, {}) == []


def test_the_lints_catch_a_handler_that_bypasses_the_scheduler():
    """The same lints flag the port's engine server with its handler
    reaching ``query`` directly, or with the cache fill removed."""
    from tools.lint_cache import check_source as cache_lint
    from tools.lint_dispatch import check_source as dispatch_lint

    path = ROOT / "predictionio_tpu_torch" / "server" / "engine_server.py"
    src = path.read_text()
    bypass = src.replace('return self._answer_query(body)',
                         'return 200, self.query(json.loads(body))')
    assert bypass != src and dispatch_lint(bypass, str(path))
    unfilled = src.replace("self.result_cache.fill(canon, result, "
                           "generation)", "pass")
    assert unfilled != src and cache_lint(
        unfilled, str(path).replace("predictionio_tpu_torch/",
                                    "predictionio_tpu/"), {})


def test_no_port_handler_calls_the_dispatch_itself():
    """No request-handler function of the port's ``server/`` calls
    ``_dispatch_batch``, ``query`` or ``query_batch``: the scheduler
    drives the dispatch."""
    handlers = {"handle", "pio_handle", "_answer_query"}
    for path in _port_sources("server"):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef) or not (
                    fn.name in handlers or fn.name.startswith("do_")):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute):
                    assert node.func.attr not in (
                        "_dispatch_batch", "query", "query_batch"), \
                        f"{path.name}:{node.lineno} {fn.name}"


# -- F7: the cache against ecommerce's live state -------------------------------

@pytest.fixture(scope="module")
def ecommerce_pair(tmp_path_factory):
    """The ecommerce template trained by the reference on its shipped
    engine.json, and the same model carried into the port, each package
    over its own in-memory store holding the same events."""
    from predictionio_tpu.templates.ecommerce import engine as jax_ec
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import App
    from predictionio_tpu_torch.templates.ecommerce import engine as ec
    from tests.test_torch_ecommerce import (
        PORT_SHIPPED,
        SHIPPED,
        _carried,
        _insert,
        _specs,
    )

    home = tmp_path_factory.mktemp("pio_home_ec")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_IVF", "PIO_PQ")) \
                    or k in _ENV:
                mp.delenv(k, raising=False)
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        reset_storage()
        reset_observability()
        jctx = JaxContext.create(storage=jax_storage())
        _insert(jctx.storage, JaxApp, JaxEvent, JaxDataMap, _specs())
        jeng = jax_ec()
        run_train(jeng, JaxVariant.from_dict(SHIPPED), jctx)
        probe = JaxEngineServer(jeng, JaxVariant.from_dict(SHIPPED),
                                jctx.storage)
        jmodel = probe._models[0]
        probe.stop()
        storage = Storage(memory_config(home / "port"))
        _insert(storage, App, Event, DataMap, _specs())
        eng = ec()
        persist_instance(eng, EngineVariant.from_dict(PORT_SHIPPED),
                         [_carried(jmodel)], storage)
        try:
            yield SimpleNamespace(
                jeng=jeng, jvariant=JaxVariant.from_dict(SHIPPED),
                jstorage=jctx.storage, eng=eng,
                variant=EngineVariant.from_dict(PORT_SHIPPED),
                storage=storage, insert=_insert,
                port_cls=(App, Event, DataMap),
                ref_cls=(JaxApp, JaxEvent, JaxDataMap))
        finally:
            reset_storage()
            reset_observability()


@pytest.mark.parametrize("cache", ["on", "0"])
def test_f7_cached_answer_outlives_a_newer_unavailable_list(
        ecommerce_pair, monkeypatch, cache):
    """F7: the reference's result cache keys (instance id, query), so
    after a newer unavailable list it serves the cached answer, which
    still holds the newly unavailable items.  The port's ecommerce
    algorithm declares ``reads_live_state``, so its server keeps no
    cached answers for it and serves the fresh list with the cache on.
    With ``PIO_RESULT_CACHE=0`` both serve the fresh answer."""
    from tests.test_torch_ecommerce import N_ITEMS

    p = ecommerce_pair
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    if cache == "0":
        monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    ref = JaxEngineServer(p.jeng, p.jvariant, p.jstorage,
                          host="127.0.0.1", port=0)
    port = EngineServer(p.eng, p.variant, p.storage, host="127.0.0.1",
                        port=0, device="cpu")
    user = "u3" if cache == "on" else "u4"      # fresh lists per case
    q = {"user": user, "num": N_ITEMS}
    try:
        for srv in (ref, port):
            srv.start()
        first = [call(srv, "POST", "/queries.json", q)[2]
                 for srv in (ref, port)]
        _same_answer(first[1], first[0])
        newer = [h["item"] for h in first[0]["itemScores"][:3]]
        offset = 5000 if cache == "on" else 6000
        spec = [("$set", "constraint", "unavailableItems", None,
                 {"items": newer})]
        p.insert(p.jstorage, *p.ref_cls, spec, offset=offset)
        p.insert(p.storage, *p.port_cls, spec, offset=offset)
        again = [call(srv, "POST", "/queries.json", q)[2]
                 for srv in (ref, port)]
        served = [{h["item"] for h in a["itemScores"]} for a in again]
        assert not set(newer) & served[1]          # the port: fresh
        if cache == "on":
            assert again[0] == first[0]            # the reference: stale
            assert set(newer) <= served[0]
            snap = port.handle("GET", "/", b"")[1]["resultCache"]
            assert snap["enabled"] and snap["entries"] == 0
        else:
            _same_answer(again[1], again[0])
            assert not set(newer) & served[0]
    finally:
        for srv in (ref, port):
            srv.stop()
