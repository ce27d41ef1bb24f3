"""The similar-product template: the port vs the JAX package.

The same events (co-views with a clique structure, item ``$set``
categories, an ``$unset`` and a ``$delete``) go into both packages'
in-memory stores, and each trains from its shipped ``engine.json``
(rank 10, 20 iterations, λ 0.01, α 10), the port's differing only in
``engineFactory``.  Checks:

- the datasource reads the same views, indexes and categories;
- ``run_train`` gives the same normalised item factors and raw user
  factors within the ALS sweep's tolerance (atol 1e-4 + rtol 1e-3,
  ``tests/test_torch_als_train.py``; the float32 gap of 20 sweeps at
  λ 0.01 is about 1e-5), and the served answers agree within it;
- the reference's trained model, carried in through
  ``model_from_numpy``, answers every query as the reference does: ids
  equal except within a tie at the k-th score, scores within rtol 1e-5
  and atol 1e-6 — on the host rung and on the masked device and chunked
  rungs, every filter and the query items' exclusion included;
- item fold-in of an unknown item (on memory and on one sqlite
  ``pio.db`` with tied view times), its counter, cache, negative TTL
  and kill switch, and a pickle round trip.
"""

import dataclasses
import datetime as dt
import json
import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.templates.similarproduct import engine as jax_engine
from predictionio_tpu.templates.similarproduct.engine import (
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.templates.similarproduct.engine import (
    Query as JaxQuery,
)
from predictionio_tpu.templates.similarproduct.engine import (
    SimilarProductDataSource as JaxDataSource,
)
from predictionio_tpu.workflow.core_workflow import (
    load_models as jax_load_models,
)
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant, RuntimeContext
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.templates.similarproduct import (
    DataSourceParams,
    Query,
    SimilarProductDataSource,
    SimilarProductModel,
    engine,
    model_from_numpy,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    load_models,
    run_train,
)

ROOT = Path(__file__).resolve().parents[1]
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6     # float32 scores, another order
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4     # the ALS sweep's tolerance
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CPU = torch.device("cpu")
N_USERS, N_ITEMS = 48, 30
CATEGORIES = ["c0", "c1", "c2", "c3"]

SHIPPED = json.loads((ROOT / "examples" / "similarproduct" /
                      "engine.json").read_text())
PORT_SHIPPED = json.loads((ROOT / "predictionio_tpu_torch" / "templates" /
                           "similarproduct" / "engine.json").read_text())
APP = SHIPPED["datasource"]["params"]["appName"]


def _specs():
    """(event, entity type, entity id, target, properties) in event-time
    order: views where users mostly view their own parity's items, then
    the item categories with an $unset and a $delete."""
    rng = np.random.default_rng(7)
    specs = []
    for u in range(N_USERS):
        pool = [i for i in range(N_ITEMS) if i % 2 == u % 2]
        for i in rng.choice(pool, size=12, replace=True):
            specs.append(("view", "user", f"u{u}", f"i{i}", {}))
        specs.append(("view", "user", f"u{u}",
                      f"i{int(rng.integers(N_ITEMS))}", {}))
    for i in range(N_ITEMS):
        cats = sorted({CATEGORIES[i % 4], CATEGORIES[(i * 7) % 3]})
        specs.append(("$set", "item", f"i{i}", None, {"categories": cats}))
    specs.append(("$unset", "item", "i3", None, {"categories": None}))
    specs.append(("$delete", "item", "i5", None, {}))
    specs.append(("buy", "user", "u1", "i2", {}))         # not a view
    return specs


def _insert(storage, app_cls, event_cls, datamap_cls, specs, app=APP,
            offset=0):
    apps = storage.get_apps()
    found = apps.get_by_name(app)
    app_id = found.id if found else apps.insert(app_cls(id=None, name=app))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([
        event_cls(event=e, entity_type=et, entity_id=eid,
                  target_entity_type="item" if t else None,
                  target_entity_id=t, properties=datamap_cls(p),
                  event_time=T0 + dt.timedelta(seconds=n + offset))
        for n, (e, et, eid, t, p) in enumerate(specs)], app_id)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained from their shipped engine.json on the same
    events: (reference model, reference ctx, port storage, port
    instance id)."""
    home = tmp_path_factory.mktemp("pio_home")
    specs = _specs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_FOLD_IN", "PIO_IVF",
                             "PIO_PQ")) or k == "PIO_RETRIEVAL_RUNG":
                mp.delenv(k, raising=False)
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        reset_storage()
        reset_observability()
        jctx = JaxContext.create(storage=jax_storage())
        _insert(jctx.storage, JaxApp, JaxEvent, JaxDataMap, specs)
        jeng = jax_engine()
        jiid = jax_run_train(jeng, JaxVariant.from_dict(SHIPPED), jctx)
        [jmodel] = jax_load_models(
            jeng, jctx.storage.get_engine_instances().get(jiid), jctx)
        storage = Storage(memory_config(home / "port"))
        _insert(storage, App, Event, DataMap, specs)
        ctx = RuntimeContext.create(storage=storage, device="cpu")
        iid = run_train(engine(), EngineVariant.from_dict(PORT_SHIPPED),
                        ctx)
        try:
            yield jmodel, jctx, storage, iid
        finally:
            reset_storage()
            reset_observability()


def _jax_algo():
    return jax_engine().make_algorithms(
        jax_engine().bind_engine_params(SHIPPED))[0]


def _queries(n=40, seed=3, item_pool=None):
    """Seeded queries of 1-3 items, a third with categories, some with a
    whiteList or a blackList."""
    rng = np.random.default_rng(seed)
    pool = item_pool or [f"i{i}" for i in range(N_ITEMS)]
    out = []
    for k in range(n):
        q = {"items": list(rng.choice(pool, size=int(rng.integers(1, 4)),
                                      replace=False)),
             "num": int(rng.choice([1, 3, 5, 10, N_ITEMS]))}
        if k % 3 == 0:
            q["categories"] = list(rng.choice(CATEGORIES, size=2,
                                              replace=False))
        if k % 5 == 1:
            q["whiteList"] = list(rng.choice(pool, size=8, replace=False))
        if k % 4 == 2:
            q["blackList"] = list(rng.choice(pool, size=3, replace=False))
        out.append(q)
    return out + [{"items": ["ghost"], "num": 4},
                  {"items": ["i0", "ghost"], "num": 4, "whiteList": []}]


def _agree(got, want, rtol, atol):
    """Ids equal except within a tie at the k-th score; scores close."""
    gi = [h.item for h in got.itemScores]
    wi = [h.item for h in want.itemScores]
    gs = np.array([h.score for h in got.itemScores])
    ws = np.array([h.score for h in want.itemScores])
    assert len(gi) == len(wi), (gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(ws).max(initial=0.0)
    for j, (a, b) in enumerate(zip(gi, wi)):
        if a != b:
            tied = [k for k, w in enumerate(wi) if w == a]
            assert tied and abs(ws[tied[0]] - ws[j]) <= 2 * tol \
                or abs(ws[j] - ws[-1]) <= 2 * tol, (gi, wi, ws)


def _carried(jmodel) -> SimilarProductModel:
    inv_i, inv_u = jmodel.item_index.inverse, jmodel.user_index.inverse
    return model_from_numpy(
        jmodel.item_factors, [inv_i[i] for i in range(len(inv_i))],
        item_categories=jmodel.item_categories,
        user_factors=jmodel.user_factors,
        user_ids=[inv_u[u] for u in range(len(inv_u))],
        app_name=jmodel.app_name, fold_event_names=jmodel.fold_event_names,
        reg=jmodel.reg, alpha=jmodel.alpha)


def _port_algo():
    return engine().make_algorithms(
        engine().bind_engine_params(PORT_SHIPPED))[0]


def test_shipped_engine_json_differs_only_in_the_factory():
    assert {**PORT_SHIPPED, "engineFactory": SHIPPED["engineFactory"]} \
        == SHIPPED
    assert PORT_SHIPPED["engineFactory"] == \
        "predictionio_tpu_torch.templates.similarproduct:engine"


def test_datasource_reads_what_the_reference_reads(trained):
    _, jctx, storage, _ = trained
    want = JaxDataSource(JaxDataSourceParams(appName=APP)).read_training(jctx)
    got = SimilarProductDataSource(DataSourceParams(appName=APP)) \
        .read_training(RuntimeContext.create(storage=storage, device="cpu"))
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    assert dict(got.user_index.items()) == dict(want.user_index.items())
    assert dict(got.item_index.items()) == dict(want.item_index.items())
    assert got.item_categories == want.item_categories
    assert "i3" not in got.item_categories and "i5" not in \
        got.item_categories and got.item_categories["i4"] == {"c0", "c1"}
    assert (got.app_name, tuple(got.event_names)) == (APP, ("view",))


def test_run_train_matches_the_reference(trained):
    jmodel, _, storage, iid = trained
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage, device=CPU))
    assert isinstance(model, SimilarProductModel)
    assert dict(model.item_index.items()) == \
        dict(jmodel.item_index.items())
    np.testing.assert_allclose(model.item_factors, jmodel.item_factors,
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose(
        np.linalg.norm(model.item_factors, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(model.user_factors, jmodel.user_factors,
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert (model.app_name, tuple(model.fold_event_names), model.reg,
            model.alpha) == (jmodel.app_name,
                             tuple(jmodel.fold_event_names), jmodel.reg,
                             jmodel.alpha)
    algo, jalgo = _port_algo(), _jax_algo()
    for q in _queries():
        _agree(algo.predict(model, Query(**q)),
               jalgo.predict(jmodel, JaxQuery(**q)), TRAIN_RTOL, TRAIN_ATOL)


@pytest.mark.parametrize("rung", ["auto", "device", "chunked"])
def test_carried_model_answers_as_the_reference(trained, monkeypatch, rung):
    """The host rung (auto at this size), and the masked scans the card
    runs, on the CPU."""
    jmodel = trained[0]
    model = _carried(jmodel)
    model._device = CPU
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
    algo, jalgo = _port_algo(), _jax_algo()
    for q in _queries():
        got = algo.predict(model, Query(**q))
        want = jalgo.predict(jmodel, JaxQuery(**q))
        _agree(got, want, SERVE_RTOL, SERVE_ATOL)
        assert not set(q["items"]) & {h.item for h in got.itemScores}
        if q.get("categories"):
            want_cats = set(q["categories"])
            assert all(model.item_categories.get(h.item, set()) & want_cats
                       for h in got.itemScores)
        if q.get("whiteList") is not None:
            assert {h.item for h in got.itemScores} <= set(q["whiteList"])
        assert not set(q.get("blackList") or ()) & \
            {h.item for h in got.itemScores}
    info = model.retriever().topk(model.item_factors[:1], 3,
                                  exclude=np.zeros((1, N_ITEMS), bool))[2]
    assert info["rung"] == ("host" if rung == "auto" else rung)


def _fold_ctx(storage):
    return RuntimeContext(storage=storage, event_store=EventStore(storage),
                          device=CPU)


def _counts():
    fam = get_registry().get("pio_fold_in_items_total")
    return {r: (fam.value(result=r) if fam else 0)
            for r in ("solved", "cached", "no_events")}


def _fold_specs(item, users):
    return [("view", "user", f"u{u}", item, {}) for u in users]


def test_fold_in_of_an_unknown_item_matches_the_reference(trained,
                                                          monkeypatch):
    """Views of a new item land after training; both packages fold it in
    from the same events and answer alike; the counter counts a solve,
    then a cached repeat; an item with no views is a negative entry for
    30 s; the kill switch turns it off."""
    jmodel, jctx, storage, _ = trained
    for k in list(os.environ):
        if k.startswith("PIO_FOLD_IN"):
            monkeypatch.delenv(k)
    specs = _fold_specs("i_new", [0, 2, 4, 6, 8, 10, 12, 1])
    _insert(jctx.storage, JaxApp, JaxEvent, JaxDataMap, specs, offset=5000)
    _insert(storage, App, Event, DataMap, specs, offset=5000)
    model = _carried(jmodel)
    model.post_load(_fold_ctx(storage))
    algo, jalgo = _port_algo(), _jax_algo()
    before = _counts()
    for q in ({"items": ["i_new"], "num": 6},
              {"items": ["i_new", "i1"], "num": 6, "categories": ["c1"]},
              {"items": ["i_new"], "num": 6, "blackList": ["i0"]}):
        got = algo.predict(model, Query(**q))
        _agree(got, jalgo.predict(jmodel, JaxQuery(**q)), SERVE_RTOL,
               SERVE_ATOL)
        assert got.itemScores
    after = _counts()
    assert after["solved"] - before["solved"] == 1
    assert after["cached"] - before["cached"] == 2
    # an unknown item with no views: a negative entry, re-read after 30 s
    assert algo.predict(model, Query(items=["i_cold"])).itemScores == []
    assert algo.predict(model, Query(items=["i_cold"])).itemScores == []
    cold = _counts()
    assert cold["no_events"] - after["no_events"] == 1
    assert cold["cached"] - after["cached"] == 1
    _insert(storage, App, Event, DataMap,
            _fold_specs("i_cold", [3, 5]), offset=6000)
    clock = time.monotonic
    monkeypatch.setattr(time, "monotonic", lambda: clock() + 31.0)
    assert algo.predict(model, Query(items=["i_cold"])).itemScores
    assert _counts()["solved"] - cold["solved"] == 1
    monkeypatch.undo()
    monkeypatch.setenv("PIO_FOLD_IN", "0")
    fresh = _carried(jmodel)
    fresh.post_load(_fold_ctx(storage))
    assert algo.predict(fresh, Query(items=["i_new"])).itemScores == []
    assert fresh.fold_in_item("i_new") is None


def test_fold_in_cache_is_bounded(trained, monkeypatch):
    jmodel, _, storage, _ = trained
    monkeypatch.setenv("PIO_FOLD_IN_CACHE", "2")
    model = _carried(jmodel)
    model.post_load(_fold_ctx(storage))
    for item in ("x1", "x2", "x3"):
        assert model.fold_in_item(item) is None
    assert list(model._fold_cache) == ["x2", "x3"]


def test_pickle_round_trip_drops_the_serving_state(trained):
    jmodel, _, storage, _ = trained
    model = _carried(jmodel)
    model.post_load(_fold_ctx(storage))
    model.fold_in_item("i_missing")
    back = pickle.loads(pickle.dumps(model))
    assert back._event_store is None and back._device is None
    assert len(back._fold_cache) == 0 and back._uty is None
    assert not any(isinstance(v, torch.Tensor)
                   for v in vars(back).values())
    back._device = CPU
    model._device = CPU
    algo = _port_algo()
    for q in _queries(8):
        assert algo.predict(back, Query(**q)) == algo.predict(model,
                                                              Query(**q))


def test_fold_in_on_sqlite_reads_tied_views_as_the_reference(
        trained, tmp_path, monkeypatch):
    """On one pio.db, 70 views of a new item at one time: fold-in reads
    the newest 50 (PIO_FOLD_IN_EVENTS) in both packages, the same rows,
    so the same answer."""
    from predictionio_tpu.config import load_config as jax_load_config
    from predictionio_tpu.data.storage import Storage as JaxStorage
    from predictionio_tpu.data.store import EventStore as JaxEventStore
    from predictionio_tpu_torch.config import load_config

    jmodel = trained[0]
    for k in list(os.environ):
        if k.startswith("PIO_FOLD_IN"):
            monkeypatch.delenv(k)
    env = {"PIO_HOME": str(tmp_path)}
    ref = JaxStorage(jax_load_config(env))
    users = [u for u in range(N_USERS) if u % 3] + ["stranger"] * 40
    _insert(ref, JaxApp, JaxEvent, JaxDataMap,
            [("view", "user", f"u{u}", "i_tie", {}) for u in users[:70]])
    # one time for every view: rewrite the stamps in place
    ref.get_events()._conn.execute(
        "UPDATE pio_event_events SET eventtime=(SELECT MIN(eventtime) FROM "
        "pio_event_events), creationtime=(SELECT MIN(creationtime) FROM "
        "pio_event_events)")
    ref.get_events()._conn.commit()
    port = Storage(load_config(env))
    model = _carried(jmodel)
    model.post_load(_fold_ctx(port))
    want_model = dataclasses.replace(jmodel)
    want_model.post_load(JaxContext(storage=ref,
                                    event_store=JaxEventStore(ref)))
    got = model.fold_in_item("i_tie")
    want = want_model.fold_in_item("i_tie")
    np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    q = {"items": ["i_tie"], "num": 5}
    _agree(_port_algo().predict(model, Query(**q)),
           _jax_algo().predict(want_model, JaxQuery(**q)), SERVE_RTOL,
           SERVE_ATOL)
