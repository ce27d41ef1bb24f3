"""The port's staged reload, rollback and validation against the
reference's, on the CPU.

Each package trains three generations of a tiny ALS engine on the same
events in its own in-memory store and serves the first one; one scripted
HTTP session then runs against each server:

- a pinned reload, a second (latest) reload, two rollbacks;
- a candidate with a NaN factor (409), a failing canary query (409), a
  passing one (200), an unknown target (409), a body that is not JSON
  (400);
- a total outage of the model store through ``PIO_FAULTS``: 503 until
  the ``modeldata`` breaker opens, while ``/queries.json`` keeps
  answering from the last-good generation.

Statuses, ``Retry-After``, bodies (instance ids relabelled, stamps
masked), the staged fields of ``GET /`` and the ``pio_model_*``
counters must be equal.  Then, on the port: the failed candidate and
the evicted previous generation leave no reference behind (``weakref``),
``PIO_RETAIN_PREVIOUS=off`` keeps one generation, a cohort dispatched on
generation N that finishes after the swap fills the result cache under
N's fingerprint, the supervision and fault-seam helpers match the
reference's, and the package keeps the reference's
``tools/lint_refresh.py`` rules.
"""

import ast
import gc
import http.client
import json
import os
import threading
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.resilience.faults as ref_faults
import predictionio_tpu.resilience.policy as ref_policy
import predictionio_tpu.resilience.supervision as ref_sup
import predictionio_tpu.server.engine_server as ref_es
import predictionio_tpu.workflow.core_workflow as ref_wf
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.resilience.faults as port_faults
import predictionio_tpu_torch.resilience.policy as port_policy
import predictionio_tpu_torch.resilience.supervision as port_sup
import predictionio_tpu_torch.server.engine_server as port_es
import predictionio_tpu_torch.workflow.core_workflow as port_wf
from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import StorageUnavailable as JaxUnavailable
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.data.storage import StorageUnavailable
from predictionio_tpu_torch.templates.recommendation import (
    engine,
    wrapper_from_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
APP = "reloadparity"
N_USERS, N_ITEMS = 12, 8
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": APP}},
    "algorithms": [{"name": "als",
                    "params": {"rank": 4, "numIterations": 2,
                               "lambda_": 0.05, "seed": 3}}],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}
_ENV = ("PIO_FAULTS", "PIO_CANARY_QUERIES", "PIO_RETAIN_PREVIOUS",
        "PIO_RETAIN_PREVIOUS_TTL_S", "PIO_BREAKER_THRESHOLD",
        "PIO_BREAKER_RECOVERY_S", "PIO_RESULT_CACHE", "PIO_RETRY_AFTER_S",
        "PIO_ENGINESERVER_PLUGINS", "PIO_RETRIEVAL_RUNG")


def _ratings(seed=0):
    rng = np.random.default_rng(seed)
    return [(f"u{u}", f"i{i}", float(3 + 2 * rng.random()))
            for u in range(N_USERS) for i in range(N_ITEMS)
            if i % 2 == u % 2]


def _more_ratings(generation):
    """The events that land before each generation's train, so that the
    three generations differ."""
    return [(f"u{u}", f"i{(u + generation) % N_ITEMS}", 1.0 + generation)
            for u in range(generation, N_USERS, 3)]


def _ref_stack(home):
    """The reference's store (MEMORY metadata and events, as the port's)
    with three trained generations."""
    reset_storage()
    ref_obs.reset_observability()
    ctx = JaxContext.create(storage=jax_storage())
    app_id = ctx.storage.get_apps().insert(JaxApp(id=None, name=APP))
    ctx.storage.get_events().init(app_id)
    ctx.storage.get_events().insert_batch([
        JaxEvent(event="rate", entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=i,
                 properties=JaxDataMap({"rating": r}))
        for u, i, r in _ratings()], app_id)
    eng, variant = jax_engine(), JaxVariant.from_dict(VARIANT)
    ids = []
    for g in range(3):
        ctx.storage.get_events().insert_batch([
            JaxEvent(event="rate", entity_type="user", entity_id=u,
                     target_entity_type="item", target_entity_id=i,
                     properties=JaxDataMap({"rating": r}))
            for u, i, r in _more_ratings(g)], app_id)
        ids.append(ref_wf.run_train(eng, variant, ctx))
    return SimpleNamespace(
        name="reference", es=ref_es, wf=ref_wf, policy=ref_policy,
        faults=ref_faults, registry=ref_obs.get_registry, eng=eng,
        variant=variant, storage=ctx.storage, ids=ids,
        unavailable=JaxUnavailable,
        server=lambda **kw: ref_es.EngineServer(
            eng, variant, ctx.storage, host="127.0.0.1", port=0, **kw))


def _port_stack(home):
    port_obs.get_registry().reset()
    storage = Storage(memory_config(home))
    app_id = storage.get_apps().insert(App(id=None, name=APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=u,
              target_entity_type="item", target_entity_id=i,
              properties=DataMap({"rating": r}))
        for u, i, r in _ratings()], app_id)
    eng, variant = engine(), EngineVariant.from_dict(PORT_VARIANT)
    ctx = port_wf.RuntimeContext.create(storage=storage, device="cpu")
    ids = []
    for g in range(3):
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=DataMap({"rating": r}))
            for u, i, r in _more_ratings(g)], app_id)
        ids.append(port_wf.run_train(eng, variant, ctx))
    return SimpleNamespace(
        name="port", es=port_es, wf=port_wf, policy=port_policy,
        faults=port_faults, registry=port_obs.get_registry, eng=eng,
        variant=variant, storage=storage, ids=ids,
        unavailable=StorageUnavailable,
        server=lambda **kw: port_es.EngineServer(
            eng, variant, storage, host="127.0.0.1", port=0, device="cpu",
            **kw))


@pytest.fixture()
def stacks(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_") or k in _ENV:
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    out = [_ref_stack(tmp_path / "home"), _port_stack(tmp_path / "port")]
    yield out
    reset_storage()


def call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"}
                     if body is not None else {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, resp.getheader("Retry-After"), json.loads(data)
    finally:
        conn.close()


def mask(obj, labels):
    """Instance ids → their labels, stamps → "<t>"."""
    if isinstance(obj, dict):
        return {k: ("<t>" if k in ("at", "modelLoadedAt", "dataWatermark")
                    and v is not None else mask(v, labels))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask(v, labels) for v in obj]
    if isinstance(obj, str):
        for iid, label in labels.items():
            obj = obj.replace(iid, label)
        return obj
    return obj


STATUS_FIELDS = ("engineInstanceId", "modelGeneration", "refreshMode",
                 "lastReload", "rollbackAvailable", "retainPreviousTtlS",
                 "breaker", "dataWatermark")
COUNTERS = (("pio_model_reload_total", {"result": "ok"}),
            ("pio_model_reload_total", {"result": "failed"}),
            ("pio_model_reload_total", {"result": "rollback"}),
            ("pio_model_generation", {}),
            ("pio_model_previous_retained", {}),
            ("pio_model_previous_evicted_total", {}))


def _poisoning_loader(pkg, poison):
    real = pkg.es.load_models

    def load(engine_, instance, ctx=None):
        models = real(engine_, instance, ctx)
        if poison["on"]:
            uf = np.asarray(models[0].model.user_factors).copy()
            uf[0, 0] = np.nan
            models[0].model.user_factors = uf
        return models
    return load


def frozen_clock():
    """The breakers' clock in a scripted session: the time never moves,
    so ``Retry-After`` and the shed message read the whole recovery time
    however long a step takes on a loaded host."""
    return 1000.0


def run_session(pkg, monkeypatch, pause_after_open=0.0):
    """One scripted session; returns [(step, status, Retry-After, masked
    body)], the staged GET / fields after each step, and the counters.
    ``pause_after_open`` sleeps that long on the wall clock after the
    outage step that opens the breaker (a slow host, on purpose)."""
    a, b, c = pkg.ids
    labels = {a: "<A>", b: "<B>", c: "<C>"}
    poison = {"on": False}
    monkeypatch.setattr(pkg.es, "load_models", _poisoning_loader(pkg, poison))
    breaker = pkg.policy.CircuitBreaker(
        "modeldata", failure_threshold=2, recovery_time_s=60.0,
        failure_types=(pkg.unavailable, ConnectionError),
        clock=frozen_clock)
    srv = pkg.server(breaker=breaker)          # serves the latest: C
    srv.start()
    port = srv.port
    out, status = [], []
    query = json.dumps({"user": "u1", "num": 3}).encode()

    def step(name, method, path, body=None):
        st, ra, payload = call(port, method, path, body)
        out.append((name, st, ra, mask(payload, labels)))
        _, _, root = call(port, "GET", "/")
        status.append((name, mask({k: root.get(k) for k in STATUS_FIELDS},
                                  labels)))
        return st, payload

    try:
        step("pinned reload", "POST", "/reload",
             json.dumps({"engineInstanceId": b}).encode())
        step("latest reload", "POST", "/reload")
        step("rollback", "POST", "/admin/rollback")
        step("rollback again", "POST", "/admin/rollback")
        poison["on"] = True
        step("nan candidate", "POST", "/reload",
             json.dumps({"engineInstanceId": a}).encode())
        poison["on"] = False
        monkeypatch.setenv("PIO_CANARY_QUERIES", json.dumps([{"nope": 1}]))
        step("failing canary", "POST", "/reload",
             json.dumps({"engineInstanceId": a}).encode())
        monkeypatch.setenv("PIO_CANARY_QUERIES",
                           json.dumps([{"user": "u1", "num": 2}]))
        step("passing canary", "POST", "/reload",
             json.dumps({"engineInstanceId": a}).encode())
        monkeypatch.delenv("PIO_CANARY_QUERIES")
        step("unknown target", "POST", "/reload",
             json.dumps({"engineInstanceId": "nope"}).encode())
        step("not json", "POST", "/reload", b"{not json")
        step("query", "POST", "/queries.json", query)
        monkeypatch.setenv("PIO_FAULTS", "storage.find:error:1.0")
        for n in range(3):
            step(f"outage reload {n}", "POST", "/reload")
            st, body = step(f"outage query {n}", "POST", "/queries.json",
                            query)
            assert st == 200 and len(body["itemScores"]) == 3
            if n == 1:
                time.sleep(pause_after_open)
        monkeypatch.delenv("PIO_FAULTS")
        reg = pkg.registry()
        counters = {f"{n}{lab}": (reg.get(n).value(**lab)
                                  if reg.get(n) is not None else None)
                    for n, lab in COUNTERS}
    finally:
        srv.stop()
    return out, status, counters


def test_scripted_session_answers_as_the_reference(stacks, monkeypatch):
    ref, port = (run_session(pkg, monkeypatch) for pkg in stacks)
    for (r_step, p_step) in zip(ref[0], port[0]):
        if r_step[0].startswith(("query", "outage query")):
            # the answers come from different trains: compare the shape
            assert (r_step[1], r_step[2]) == (p_step[1], p_step[2])
            continue
        assert r_step == p_step
    assert ref[1] == port[1]
    assert ref[2] == port[2]
    steps = {name: (st, body) for name, st, _, body in port[0]}
    assert steps["nan candidate"][0] == 409
    assert "non-finite" in steps["nan candidate"][1]["message"]
    assert steps["failing canary"][0] == 409
    assert steps["not json"][0] == 400
    assert [steps[f"outage reload {n}"][0] for n in range(3)] == [503] * 3
    assert port[1][-1][1]["breaker"] == "open"
    # the last-good generation (A, passed its canary) served the outage
    assert port[1][-1][1]["engineInstanceId"] == "<A>"


def test_outage_retry_after_does_not_depend_on_the_session_speed(
        stacks, monkeypatch):
    """A port session that spends longer than a second between the
    breaker opening and the next outage step sheds with the same
    ``Retry-After`` and message as the reference's: the breakers read
    the session's clock, not the wall clock (on the wall clock the port
    read 58 s / "~58.8s" against 59 s / "~59.9s")."""
    ref = run_session(stacks[0], monkeypatch)
    port = run_session(stacks[1], monkeypatch, pause_after_open=1.2)
    shed = [(r, p) for r, p in zip(ref[0], port[0])
            if r[0] == "outage reload 2"]
    assert len(shed) == 1
    r_step, p_step = shed[0]
    assert r_step == p_step
    assert p_step[1:3] == (503, "60")
    assert "retry in ~60.0s" in p_step[3]["message"]


@pytest.mark.parametrize("pkg_index", [0, 1], ids=["reference", "port"])
def test_a_folded_user_is_solved_against_the_restored_factors(
        stacks, pkg_index, monkeypatch):
    """A user unseen by every generation is folded in against each
    generation's own item factors: after reload and rollback the
    restored generation answers as it did, solved against its factors
    (the cache is off, so the answer is recomputed)."""
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    pkg = stacks[pkg_index]
    app = pkg.storage.get_apps().get_by_name(APP)
    event, datamap = (JaxEvent, JaxDataMap) if pkg.name == "reference" \
        else (Event, DataMap)
    pkg.storage.get_events().insert_batch([
        event(event="rate", entity_type="user", entity_id="fresh",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties=datamap({"rating": r}))
        for i, r in ((0, 5.0), (3, 1.0), (5, 4.0))], app.id)
    srv = pkg.server()
    q = {"user": "fresh", "num": 4}
    try:
        first = srv.query_batch([q])[0]
        srv.reload(pkg.ids[0])
        other = srv.query_batch([q])[0]
        srv.rollback()
        back = srv.query_batch([q])[0]
    finally:
        srv.stop()
    assert len(first["itemScores"]) == 4
    assert other != first
    assert back == first
    folds = pkg.registry().get("pio_fold_in_total")
    assert (folds.value(result="solved"), folds.value(result="cached")) \
        == (2, 1)


@pytest.mark.parametrize("pkg_index", [0, 1], ids=["reference", "port"])
def test_rollback_with_nothing_retained_is_409(stacks, pkg_index):
    pkg = stacks[pkg_index]
    srv = pkg.server()
    try:
        st, body = srv.handle("POST", "/admin/rollback", b"")[:2]
        assert st == 409 and "roll back" in body["message"]
        st, body = srv.handle("GET", "/", b"")[:2]
        assert body["rollbackAvailable"] is False
        assert body["lastReload"]["result"] == "ok"
        assert body["modelGeneration"] == 1
    finally:
        srv.stop()


# -- the port alone: memory, generations, the cache ---------------------------

def _port_server(tmp_path, n_gens=3):
    """A port server over ``n_gens`` random generations (persisted, the
    first one served); returns (server, storage, ids)."""
    port_obs.get_registry().reset()
    storage = Storage(memory_config(tmp_path / "mem"))
    eng, variant = engine(), EngineVariant.from_dict(PORT_VARIANT)
    rng = np.random.default_rng(7)
    ids = []
    for g in range(n_gens):
        w = wrapper_from_numpy(
            rng.standard_normal((N_USERS, 4)).astype(np.float32),
            rng.standard_normal((N_ITEMS, 4)).astype(np.float32),
            [f"u{j}" for j in range(N_USERS)],
            [f"i{j}" for j in range(N_ITEMS)], rank=4)
        ids.append(port_wf.persist_instance(eng, variant, [w], storage))
    srv = port_es.EngineServer(eng, variant, storage, host="127.0.0.1",
                               port=0, device="cpu", instance_id=ids[0])
    return srv, storage, ids


@pytest.fixture()
def port_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_") or k in _ENV:
            monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_a_failed_candidate_leaves_no_reference(tmp_path, port_env):
    srv, _, ids = _port_server(tmp_path)
    seen = []
    real = port_es.load_models

    def poisoned(engine_, instance, ctx=None):
        models = real(engine_, instance, ctx)
        models[0].model.user_factors[0, 0] = np.nan
        # the candidate stages its corpus, as a canary's predict would
        models[0].retriever()
        seen.append(weakref.ref(models[0]))
        return models

    port_env.setattr(port_es, "load_models", poisoned)
    try:
        try:
            srv.reload(ids[1])
        except port_sup.ModelValidationError as e:
            assert "non-finite" in str(e)
        else:
            raise AssertionError("the NaN candidate was swapped in")
        st, body = srv.handle("POST", "/reload", json.dumps(
            {"engineInstanceId": ids[2]}).encode())[:2]
        assert st == 409 and body["status"] == "rejected"
        gc.collect()
        assert [r() for r in seen] == [None, None]
        assert srv._instance.id == ids[0] and srv._generation == 1
    finally:
        srv.stop()


@pytest.mark.parametrize("how", ["timer", "direct"])
def test_eviction_frees_the_previous_generation(tmp_path, port_env, how):
    if how == "timer":
        port_env.setenv("PIO_RETAIN_PREVIOUS_TTL_S", "0.05")
    srv, _, ids = _port_server(tmp_path)
    try:
        old = weakref.ref(srv._models[0])
        srv.query({"user": "u1", "num": 2})      # stages its corpus
        srv.reload(ids[1])
        assert srv._previous is not None and old() is not None
        if how == "timer":
            srv._evict_timer.join(5.0)
        else:
            assert srv._evict_previous(srv._generation)
        gc.collect()
        assert old() is None
        reg = port_obs.get_registry()
        assert reg.get("pio_model_previous_evicted_total").value() == 1
        assert reg.get("pio_model_previous_retained").value() == 0
        st, body = srv.handle("POST", "/admin/rollback", b"")[:2]
        assert st == 409
    finally:
        srv.stop()


def test_a_stale_eviction_timer_evicts_nothing(tmp_path, port_env):
    srv, _, ids = _port_server(tmp_path)
    try:
        srv.reload(ids[1])
        armed_for = srv._generation
        srv.reload(ids[2])
        assert not srv._evict_previous(armed_for)
        assert srv._previous is not None
    finally:
        srv.stop()


def test_retain_previous_off_keeps_one_generation(tmp_path, port_env):
    port_env.setenv("PIO_RETAIN_PREVIOUS", "off")
    srv, _, ids = _port_server(tmp_path)
    try:
        refs = [weakref.ref(srv._models[0])]
        for iid in ids[1:]:
            srv.reload(iid)
            refs.append(weakref.ref(srv._models[0]))
            gc.collect()
            assert [r() is not None for r in refs].count(True) == 1
        assert srv._previous is None
        st, body = srv.handle("GET", "/", b"")[:2]
        assert body["rollbackAvailable"] is False
    finally:
        srv.stop()


def test_a_cohort_across_a_swap_fills_under_its_own_generation(
        tmp_path, port_env):
    """A cohort dispatched on generation N that finishes after the swap
    to N+1 fills the cache under N's fingerprint: N+1 misses and answers
    its own; a rollback to N hits N's answer."""
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm)

    srv, _, ids = _port_server(tmp_path)
    srv.start()
    entered, release = threading.Event(), threading.Event()
    real = ALSAlgorithm.batch_predict

    def gated(self, model, queries):
        entered.set()
        release.wait(30)
        return real(self, model, queries)

    q = json.dumps({"user": "u3", "num": 4}).encode()
    got = {}
    try:
        want_n = srv.query({"user": "u3", "num": 4})
        port_env.setattr(ALSAlgorithm, "batch_predict", gated)
        t = threading.Thread(target=lambda: got.setdefault(
            "n", call(srv.port, "POST", "/queries.json", q)))
        t.start()
        assert entered.wait(30)
        srv.reload(ids[1])                       # the swap, mid-cohort
        release.set()
        t.join(30)
        st, _, body = got["n"]
        assert st == 200 and body == want_n      # generation N's answer
        port_env.setattr(ALSAlgorithm, "batch_predict", real)
        want_n1 = srv.query({"user": "u3", "num": 4})
        assert want_n1 != want_n
        hits = port_obs.get_registry().get("pio_result_cache_hits_total")
        before = hits.value(tier="local")
        st, _, body = call(srv.port, "POST", "/queries.json", q)
        assert (st, body) == (200, want_n1)      # a miss, computed on N+1
        assert hits.value(tier="local") == before
        srv.rollback()
        st, _, body = call(srv.port, "POST", "/queries.json", q)
        assert (st, body) == (200, want_n)       # N's fill, kept under N
        assert hits.value(tier="local") == before + 1
    finally:
        release.set()
        srv.stop()


def test_reload_pins_and_reports_the_watermark(tmp_path, port_env):
    srv, storage, ids = _port_server(tmp_path)
    try:
        st, body = srv.handle("GET", "/stats.json", b"")[:2]
        assert st == 200 and body["dataWatermark"] is None  # carried in
        st, body = srv.handle("POST", "/reload", json.dumps(
            {"engineInstanceId": ids[2]}).encode())[:2]
        assert (st, body["engineInstanceId"], body["generation"]) == \
            (200, ids[2], 2)
    finally:
        srv.stop()


# -- supervision and the fault seams ------------------------------------------

def _model_tree(nan_at=None):
    rng = np.random.default_rng(1)
    tree = SimpleNamespace(
        model=SimpleNamespace(user_factors=rng.random((3, 2), np.float32),
                              item_factors=rng.random((4, 2), np.float32),
                              rank=2),
        codes=np.arange(6, dtype=np.uint8).reshape(2, 3),
        table={"a": np.ones(2), "b": [np.zeros(3), 1.5, "x"]},
        _transient=np.array([np.nan]),
        scale=np.float32(2.0))
    if nan_at == "items":
        tree.model.item_factors[1, 1] = np.inf
    elif nan_at == "list":
        tree.table["b"][0][2] = np.nan
    elif nan_at == "scalar":
        tree.scale = np.float32(np.nan)
    return tree


def test_iter_model_arrays_walks_as_the_reference():
    tree = _model_tree()
    want = [(p, a.shape) for p, a in ref_sup.iter_model_arrays(tree)]
    got = [(p, a.shape) for p, a in port_sup.iter_model_arrays(tree)]
    assert got == want
    assert "model._transient" not in dict(got)


@pytest.mark.parametrize("nan_at", [None, "items", "list", "scalar"])
def test_validate_model_finite_as_the_reference(nan_at):
    def verdict(sup):
        try:
            sup.validate_model_finite(_model_tree(nan_at), name="models[0]")
        except sup.ModelValidationError as e:
            return str(e)
        return None

    assert verdict(port_sup) == verdict(ref_sup)
    assert (verdict(port_sup) is None) == (nan_at is None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_validate_model_finite_reduces_tensors(dtype):
    """The walk recognises tensors (the reference's np.dtype() of a
    torch.dtype raises) and skips integer ones."""
    ok = SimpleNamespace(f=torch.ones(3, 2, dtype=dtype),
                         codes=torch.arange(4, dtype=torch.int32))
    port_sup.validate_model_finite(ok)
    bad = SimpleNamespace(f=torch.ones(3, 2, dtype=dtype))
    bad.f[2, 1] = float("nan")
    with pytest.raises(port_sup.ModelValidationError,
                       match=r"model\.f \(shape \(3, 2\)\)"):
        port_sup.validate_model_finite(bad)


def test_preemption_flag_and_exit_code_as_the_reference():
    assert port_sup.PREEMPTED_EXIT_CODE == ref_sup.PREEMPTED_EXIT_CODE
    port_sup.clear_preemption()
    assert not port_sup.preemption_requested()
    port_sup.request_preemption()
    assert port_sup.preemption_requested()
    port_sup.clear_preemption()
    assert not port_sup.preemption_requested()
    e = port_sup.TrainPreempted("als", 3, False)
    assert str(e) == str(ref_sup.TrainPreempted("als", 3, False))


def test_reload_fault_seams_carry_the_reference_points():
    assert port_faults._INSTANCES_POINTS == ref_faults._INSTANCES_POINTS
    assert port_faults._MODELS_POINTS == ref_faults._MODELS_POINTS


@pytest.mark.parametrize("repo", ["instances", "models"])
def test_fault_seams_break_the_reload_reads(tmp_path, port_env, repo):
    storage = Storage(memory_config(tmp_path))
    get = {"instances": storage.get_engine_instances,
           "models": storage.get_models}[repo]
    assert get().get("x") is None
    port_faults.install("storage.find:error:1.0")
    try:
        with pytest.raises(port_faults.FaultInjected):
            get().get("x")
    finally:
        port_faults.clear()


# -- the reference's tools/lint_refresh.py rules, on the port -----------------

def _lint_rules():
    """The rule tables, read (not imported) from the reference's lint."""
    tree = ast.parse((ROOT / "tools" / "lint_refresh.py").read_text())
    rules = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                rules[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                continue
    return rules


def _lint_violations(root):
    rules = _lint_rules()
    gen_attrs = rules["_GEN_ATTRS"]
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = (path.parent.name, path.name)
        tree = ast.parse(path.read_text(encoding="utf-8"))
        write_ok = rel in rules["_MODEL_WRITE_OK"] or rel[0] == "storage"
        in_refresh = path.parent.name == "refresh"
        bound = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Call)
                 and isinstance(n.value.func, ast.Attribute)
                 and n.value.func.attr == "get_models"
                 for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and not write_ok \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "insert":
                v = node.func.value
                if (isinstance(v, ast.Call)
                        and isinstance(v.func, ast.Attribute)
                        and v.func.attr == "get_models") or (
                        isinstance(v, ast.Name) and v.id in bound):
                    out.append(f"{path}:{node.lineno}: model-store write")
            if isinstance(node, (ast.Assign, ast.AugAssign)) \
                    and rel not in rules["_GEN_WRITE_OK"]:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and t.attr in gen_attrs \
                            and not (isinstance(t.value, ast.Name)
                                     and t.value.id == "self"):
                        out.append(f"{path}:{node.lineno}: assigns "
                                   f".{t.attr}")
            if in_refresh:
                name = node.attr if isinstance(node, ast.Attribute) else (
                    node.id if isinstance(node, ast.Name) else None)
                if name in rules["_REFRESH_FORBIDDEN"]:
                    out.append(f"{path}:{node.lineno}: refresh/ uses "
                               f"{name}")
    return out


def _promote_in_loops(root):
    loops = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
             ast.DictComp, ast.GeneratorExp)
    out = []

    def walk(node, in_loop, path):
        for child in ast.iter_child_nodes(node):
            if in_loop and isinstance(child, ast.Call) \
                    and isinstance(child.func, ast.Attribute) \
                    and child.func.attr == "promote":
                out.append(f"{path}:{child.lineno}")
            nested = isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda))
            walk(child, False if nested else
                 (in_loop or isinstance(child, loops)), path)

    for path in sorted(root.rglob("*.py")):
        if _lint_rules()["_PROMOTE_LOOP_OK_PKG"] not in path.parts:
            walk(ast.parse(path.read_text(encoding="utf-8")), False, path)
    return out


def test_port_keeps_the_reference_refresh_lint_rules():
    root = ROOT / "predictionio_tpu_torch"
    assert (root / "refresh" / "daemon.py").exists()
    assert _lint_violations(root) == []
    assert _promote_in_loops(root) == []


def test_lint_rules_flag_planted_violations(tmp_path):
    pkg = tmp_path / "refresh"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "def f(srv, storage, m, p, urls):\n"
        "    srv._generation = 3\n"
        "    repo = storage.get_models()\n"
        "    repo.insert(m)\n"
        "    for u in urls:\n"
        "        p.promote(u)\n")
    found = _lint_violations(tmp_path)
    assert any("assigns ._generation" in v for v in found)
    assert any("model-store write" in v for v in found)
    assert any("refresh/ uses get_models" in v for v in found)
    assert len(_promote_in_loops(tmp_path)) == 1
