"""The e-commerce template: the port vs the JAX package.

The same events (views, buys by a few users, item ``$set`` categories
and two ``$set``s of ``constraint/unavailableItems``) go into both
packages' in-memory stores, and each trains from its shipped
``engine.json`` (rank 10, 20 iterations, α 10, ``unseenOnly``), the
port's differing only in ``engineFactory``.  Checks:

- the datasource reads the same weights (``buyWeight``), indexes,
  categories and weighted view counts;
- ``run_train`` gives the same factors within the ALS sweep's tolerance
  (atol 1e-4 + rtol 1e-3, ``tests/test_torch_als_train.py``) and the
  served answers agree within it;
- the reference's trained model, carried in through
  ``model_from_numpy``, answers as the reference does (ids equal except
  within a tie at the k-th score, scores within rtol 1e-5 / atol 1e-6)
  on the host rung and the masked device and chunked rungs: every
  filter, the seen and unavailable rules, and the popularity fallback
  of an unknown user (equal exactly);
- on one sqlite ``pio.db`` both packages read the live rules alike when
  a limit cuts rows tied in time (512 seen events, ``limit=1`` on the
  unavailable list): the tie order of the one-entity read; a newer
  unavailable list written later is excluded without a reload;
- a pickle round trip.
"""

import datetime as dt
import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.config import load_config as jax_load_config
from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.data.store import EventStore as JaxEventStore
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.templates.ecommerce import engine as jax_engine
from predictionio_tpu.templates.ecommerce.engine import (
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.templates.ecommerce.engine import (
    ECommerceDataSource as JaxDataSource,
)
from predictionio_tpu.templates.ecommerce.engine import Query as JaxQuery
from predictionio_tpu.workflow.core_workflow import (
    load_models as jax_load_models,
)
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu_torch.config import load_config, memory_config
from predictionio_tpu_torch.controller import EngineVariant, RuntimeContext
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.templates.ecommerce import (
    DataSourceParams,
    ECommerceDataSource,
    ECommModel,
    Query,
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
N_USERS, N_ITEMS = 50, 32
CATEGORIES = ["c0", "c1", "c2", "c3"]

SHIPPED = json.loads((ROOT / "examples" / "ecommerce" /
                      "engine.json").read_text())
PORT_SHIPPED = json.loads((ROOT / "predictionio_tpu_torch" / "templates" /
                           "ecommerce" / "engine.json").read_text())
APP = SHIPPED["datasource"]["params"]["appName"]


def _specs():
    """(event, entity type, entity id, target, properties), one second
    apart: Zipf views, buys by every 20th user, categories, and two
    unavailable lists at distinct times."""
    rng = np.random.default_rng(5)
    specs = []
    for n in range(900):
        u = int(rng.integers(N_USERS))
        i = int(rng.zipf(1.2) % N_ITEMS)
        event = "buy" if u % 20 == 0 and rng.random() < 0.5 else "view"
        specs.append((event, "user", f"u{u}", f"i{i}", {}))
    for i in range(N_ITEMS):
        cats = sorted({CATEGORIES[i % 4], CATEGORIES[(i * 5) % 3]})
        specs.append(("$set", "item", f"i{i}", None, {"categories": cats}))
    specs.append(("$set", "constraint", "unavailableItems", None,
                  {"items": ["i1", "i9"]}))
    specs.append(("view", "user", "u_late", "i2", {}))
    specs.append(("$set", "constraint", "unavailableItems", None,
                  {"items": ["i0", "i7"]}))
    return specs


def _insert(storage, app_cls, event_cls, datamap_cls, specs, app=APP,
            offset=0, same_time=False):
    apps = storage.get_apps()
    found = apps.get_by_name(app)
    app_id = found.id if found else apps.insert(app_cls(id=None, name=app))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([
        event_cls(event=e, entity_type=et, entity_id=eid,
                  target_entity_type="item" if t else None,
                  target_entity_id=t, properties=datamap_cls(p),
                  event_time=T0 + dt.timedelta(
                      seconds=offset + (0 if same_time else n)),
                  creation_time=T0 + dt.timedelta(
                      seconds=offset + (0 if same_time else n)))
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
            if k.startswith(("PIO_STORAGE_", "PIO_IVF", "PIO_PQ")) \
                    or k == "PIO_RETRIEVAL_RUNG":
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


def _algos(jctx, port_model=None, storage=None):
    """(port algorithm, reference algorithm) from the shipped params; the
    reference's reads its live rules through ``jctx``, the port's through
    the store its model was loaded with."""
    jalgo = jax_engine().make_algorithms(
        jax_engine().bind_engine_params(SHIPPED))[0]
    jalgo._ctx = jctx
    algo = engine().make_algorithms(
        engine().bind_engine_params(PORT_SHIPPED))[0]
    if port_model is not None:
        port_model.post_load(RuntimeContext(
            storage=storage, event_store=EventStore(storage), device=CPU))
    return algo, jalgo


def _queries(n=40, seed=9):
    rng = np.random.default_rng(seed)
    pool = [f"i{i}" for i in range(N_ITEMS)]
    out = []
    for k in range(n):
        q = {"user": f"u{int(rng.integers(N_USERS))}",
             "num": int(rng.choice([1, 4, 10, N_ITEMS]))}
        if k % 3 == 0:
            q["categories"] = list(rng.choice(CATEGORIES, size=2,
                                              replace=False))
        if k % 5 == 1:
            q["whiteList"] = list(rng.choice(pool, size=10, replace=False))
        if k % 4 == 2:
            q["blackList"] = list(rng.choice(pool, size=3, replace=False))
        out.append(q)
    return out + [{"user": "ghost", "num": 5},
                  {"user": "u_late", "num": 6, "categories": ["c1"]},
                  {"user": "ghost2", "num": N_ITEMS, "blackList": ["i3"]}]


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


def _pairs(result):
    return [(h.item, h.score) for h in result.itemScores]


def _carried(jmodel) -> ECommModel:
    inv_i, inv_u = jmodel.item_index.inverse, jmodel.user_index.inverse
    return model_from_numpy(
        jmodel.user_factors, jmodel.item_factors,
        [inv_u[u] for u in range(len(inv_u))],
        [inv_i[i] for i in range(len(inv_i))],
        item_categories=jmodel.item_categories,
        view_counts=jmodel.view_counts)


def test_shipped_engine_json_differs_only_in_the_factory():
    assert {**PORT_SHIPPED, "engineFactory": SHIPPED["engineFactory"]} \
        == SHIPPED
    assert PORT_SHIPPED["engineFactory"] == \
        "predictionio_tpu_torch.templates.ecommerce:engine"


def test_datasource_reads_what_the_reference_reads(trained):
    _, jctx, storage, _ = trained
    want = JaxDataSource(JaxDataSourceParams(appName=APP)).read_training(jctx)
    got = ECommerceDataSource(DataSourceParams(appName=APP)).read_training(
        RuntimeContext.create(storage=storage, device="cpu"))
    for name in ("user_ids", "item_ids", "weights", "view_counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.weights.dtype == got.view_counts.dtype == np.float32
    assert set(np.unique(got.weights)) == {1.0, 5.0}
    assert dict(got.user_index.items()) == dict(want.user_index.items())
    assert dict(got.item_index.items()) == dict(want.item_index.items())
    assert got.item_categories == want.item_categories


def test_run_train_matches_the_reference(trained):
    jmodel, jctx, storage, iid = trained
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage,
                                         event_store=EventStore(storage),
                                         device=CPU))
    assert isinstance(model, ECommModel)
    assert dict(model.user_index.items()) == \
        dict(jmodel.user_index.items())
    for name in ("user_factors", "item_factors"):
        np.testing.assert_allclose(getattr(model, name),
                                   getattr(jmodel, name),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_array_equal(model.view_counts, jmodel.view_counts)
    algo, jalgo = _algos(jctx)
    for q in _queries():
        _agree(algo.predict(model, Query(**q)),
               jalgo.predict(jmodel, JaxQuery(**q)), TRAIN_RTOL, TRAIN_ATOL)


@pytest.mark.parametrize("rung", ["auto", "device", "chunked"])
def test_carried_model_answers_as_the_reference(trained, monkeypatch, rung):
    jmodel, jctx, storage, _ = trained
    model = _carried(jmodel)
    algo, jalgo = _algos(jctx, model, storage)
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
    unavailable = {"i0", "i7"}     # the latest list, not the first
    for q in _queries():
        got = algo.predict(model, Query(**q))
        want = jalgo.predict(jmodel, JaxQuery(**q))
        items = [h.item for h in got.itemScores]
        if q["user"].startswith("ghost"):
            # popularity: equal exactly
            assert _pairs(got) == _pairs(want) and items
        else:
            _agree(got, want, SERVE_RTOL, SERVE_ATOL)
        assert not unavailable & set(items)
        seen = {e.target_entity_id for e in storage.get_events().find(
            1, entity_type="user", entity_id=q["user"])}
        assert not seen & set(items)
        assert not set(q.get("blackList") or ()) & set(items)
        if q.get("whiteList") is not None:
            assert set(items) <= set(q["whiteList"])


def test_pickle_round_trip_drops_the_serving_state(trained):
    jmodel, jctx, storage, _ = trained
    model = _carried(jmodel)
    algo, _ = _algos(jctx, model, storage)
    back = pickle.loads(pickle.dumps(model))
    assert back._event_store is None and back._device is None
    back.post_load(RuntimeContext(storage=storage,
                                  event_store=EventStore(storage),
                                  device=CPU))
    for q in _queries(10):
        assert algo.predict(back, Query(**q)) == \
            algo.predict(model, Query(**q))


def test_live_rules_on_sqlite_cut_ties_as_the_reference(trained, tmp_path):
    """One pio.db, written by the reference, read by both.  User u0 has
    520 events at one time: 8 views of trained items, then 512 of items
    the model does not know, so the newest 512 (the reference's) exclude
    none of the 8.  The unavailable list has three $sets, the last two
    tied: the newest row wins.  A fourth list, written after the first
    answers, is excluded without a reload."""
    jmodel = trained[0]
    env = {"PIO_HOME": str(tmp_path)}
    ref = JaxStorage(jax_load_config(env))
    known = [f"i{i}" for i in range(8)]
    _insert(ref, JaxApp, JaxEvent, JaxDataMap,
            [("view", "user", "u0", t, {})
             for t in known + [f"x{k}" for k in range(512)]],
            same_time=True)
    _insert(ref, JaxApp, JaxEvent, JaxDataMap,
            [("$set", "constraint", "unavailableItems", None,
              {"items": ["i10"]})], offset=10)
    _insert(ref, JaxApp, JaxEvent, JaxDataMap,
            [("$set", "constraint", "unavailableItems", None,
              {"items": [f"i{i}"]}) for i in (11, 12)],
            offset=20, same_time=True)
    port = Storage(load_config(env))
    jctx = JaxContext(storage=ref, event_store=JaxEventStore(ref))
    model = _carried(jmodel)
    algo, jalgo = _algos(jctx, model, port)

    def answers(q):
        got = algo.predict(model, Query(**q))
        want = jalgo.predict(jmodel, JaxQuery(**q))
        _agree(got, want, SERVE_RTOL, SERVE_ATOL)
        return [h.item for h in got.itemScores]

    q = {"user": "u0", "num": N_ITEMS}
    items = answers(q)
    assert set(known) <= set(items)          # the tie cut them off
    assert "i12" not in items and {"i10", "i11"} <= set(items)
    assert answers({"user": "ghost", "num": N_ITEMS}) == [
        h.item for h in jalgo.predict(
            jmodel, JaxQuery(user="ghost", num=N_ITEMS)).itemScores]
    _insert(port, App, Event, DataMap,
            [("$set", "constraint", "unavailableItems", None,
              {"items": ["i3", "i4"]})], offset=30)
    items = answers(q)
    assert not {"i3", "i4"} & set(items) and "i12" in items
