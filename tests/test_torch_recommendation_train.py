"""The recommendation template's training loop: the port vs the JAX package.

The same events go into both packages' in-memory event stores.  Checks:

- the datasource reads the same (user, item, rating) triples and BiMaps
  (a `rate` without a numeric rating is dropped, `buy` becomes
  ``buyRating``, other events and target types are filtered out);
- ``run_train`` → ``load_models`` → ``EngineServer.query_batch`` on the
  CPU gives the reference's items, with scores within the serving
  tolerance of ``tests/test_torch_recommendation.py`` (rtol 1e-5,
  atol 1e-6) — both trains start from the reference's init, and the
  ridge (λ = 1) keeps the float32 gap of five sweeps under that
  tolerance (at λ = 0.1 it reaches 2.5e-5; ``tests/test_torch_als_train.py``
  holds the sweep itself to atol 1e-4 + rtol 1e-3 there);
- the workflow's watermark, window and FAILED status, and the train-time
  IVF/PQ build policy (builds and skips as the reference's does).
"""

import datetime as dt
import os

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
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxEngineServer,
)
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu.templates.recommendation.engine import (
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.templates.recommendation.engine import (
    RecommendationDataSource as JaxDataSource,
)
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu_torch.controller import EngineVariant, RuntimeContext
from predictionio_tpu_torch.data.event import BiMap, DataMap, Event
from predictionio_tpu_torch.data.storage import App, get_storage
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModelWrapper,
    DataSourceParams,
    Ratings,
    RecommendationDataSource,
    engine,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    DATA_WATERMARK_KEY,
    load_models,
    run_train,
)

RTOL = 1e-5   # float32 scores, summed in another order
ATOL = 1e-6
APP = "torchtrain"
N_USERS, N_ITEMS, RANK = 40, 30, 8
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CPU = torch.device("cpu")

VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": APP}},
    "algorithms": [
        {"name": "als",
         "params": {"rank": RANK, "numIterations": 5, "lambda_": 1.0,
                    "seed": 3}}
    ],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}


def _event_specs():
    """(event, user, target type, item, properties) in event-time order:
    seeded rates and buys plus the cases the datasource must handle."""
    rng = np.random.default_rng(11)
    specs = []
    for n in range(700):
        u = int(rng.integers(0, N_USERS))
        i = int(rng.zipf(1.25) % N_ITEMS)
        if rng.random() < 0.15:
            specs.append(("buy", f"u{u}", "item", f"i{i}", {}))
        else:
            specs.append(("rate", f"u{u}", "item", f"i{i}",
                          {"rating": float(rng.integers(1, 11) * 0.5)}))
    specs += [
        ("rate", "u1", "item", "i2", {}),                    # dropped
        ("rate", "u2", "item", "i3", {"rating": True}),      # dropped
        ("rate", "u3", "item", "i4", {"rating": "4.5"}),     # kept: 4.5
        ("rate", "u4", "item", "i5", {"rating": None}),      # dropped
        ("rate", "u5", "item", "i6", {"rating": 2, "ctx": {"rating": 9}}),
        ("view", "u6", "item", "i7", {"rating": 5.0}),       # not read
        ("rate", "u7", "shop", "s1", {"rating": 5.0}),       # not read
        ("buy", "u_new", "item", "i_new", {}),               # new entities
    ]
    return specs


def _insert_port_events(storage, specs, until_offset=0):
    app_id = storage.get_apps().insert(App(id=None, name=APP))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([
        Event(event=e, entity_type="user", entity_id=u,
              target_entity_type=tt, target_entity_id=t,
              properties=DataMap(p),
              event_time=T0 + dt.timedelta(seconds=n + until_offset))
        for n, (e, u, tt, t, p) in enumerate(specs)], app_id)
    return app_id


def _insert_jax_events(storage, specs):
    app_id = storage.get_apps().insert(JaxApp(id=None, name=APP))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([
        JaxEvent(event=e, entity_type="user", entity_id=u,
                 target_entity_type=tt, target_entity_id=t,
                 properties=JaxDataMap(p),
                 event_time=T0 + dt.timedelta(seconds=n))
        for n, (e, u, tt, t, p) in enumerate(specs)], app_id)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained on the same events from the same init:
    (JAX server, port storage, port instance id)."""
    home = tmp_path_factory.mktemp("pio_home")
    specs = _event_specs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_IVF", "PIO_PQ")) \
                    or k == "PIO_RETRIEVAL_RUNG":
                mp.delenv(k, raising=False)
        # the reference's in-memory backends, like the port's: both scans
        # then return the events in insertion (= event-time) order
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")

        def init(n_users, n_items, k, seed):
            uf, itf = jax_als._init_factors(n_users, n_items, k, seed)
            return np.array(uf), np.array(itf)

        mp.setattr(port_als, "_init_factors", init)
        reset_storage()
        reset_observability()
        jctx = JaxContext.create(storage=jax_storage())
        _insert_jax_events(jctx.storage, specs)
        jeng = jax_engine()
        jax_run_train(jeng, JaxVariant.from_dict(VARIANT), jctx)
        jsrv = JaxEngineServer(jeng, JaxVariant.from_dict(VARIANT),
                               jctx.storage, host="127.0.0.1", port=0)
        storage = get_storage(home / "port")
        _insert_port_events(storage, specs)
        ctx = RuntimeContext.create(storage=storage, device="cpu")
        iid = run_train(engine(), EngineVariant.from_dict(PORT_VARIANT), ctx)
        try:
            yield jsrv, jctx, storage, iid
        finally:
            jsrv.stop()
            reset_storage()
            reset_observability()


def test_datasource_reads_what_the_reference_reads(trained, caplog):
    _, jctx, storage, _ = trained
    want = JaxDataSource(JaxDataSourceParams(appName=APP)).read_training(jctx)
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    with caplog.at_level("WARNING"):
        got = RecommendationDataSource(
            DataSourceParams(appName=APP)).read_training(ctx)
    assert "dropping 3 rate event(s)" in caplog.text
    assert isinstance(got, Ratings)
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    np.testing.assert_array_equal(got.ratings, want.ratings)
    assert got.ratings.dtype == want.ratings.dtype == np.float32
    assert dict(got.user_index.items()) == dict(want.user_index.items())
    assert dict(got.item_index.items()) == dict(want.item_index.items())
    inv_u, inv_i = got.user_index.inverse, got.item_index.inverse
    triples = {(inv_u[u], inv_i[i], float(r))
               for u, i, r in zip(got.user_ids, got.item_ids, got.ratings)}
    assert ("u3", "i4", 4.5) in triples and ("u5", "i6", 2.0) in triples
    assert ("u_new", "i_new", 4.0) in triples           # buyRating
    assert not any(u in ("u6", "u7") and t in ("i7", "s1")
                   for u, t, _ in triples)
    assert (got.app_name, tuple(got.event_names), got.buy_rating) == \
        (APP, ("rate", "buy"), 4.0)


def _queries():
    nums = (1, 3, 10, N_ITEMS)
    qs = [{"user": f"u{u}", "num": nums[u % 4]} for u in range(N_USERS)]
    return qs + [{"user": "u_new", "num": 5}, {"user": "ghost", "num": 5}]


def test_run_train_load_and_serve_match_the_reference(trained):
    jsrv, _, storage, iid = trained
    instance = storage.get_engine_instances().get(iid)
    assert instance.status == "COMPLETED"
    assert DATA_WATERMARK_KEY in instance.env
    [wrapper] = load_models(engine(), instance,
                            RuntimeContext(storage=storage, device=CPU))
    assert isinstance(wrapper, ALSModelWrapper)
    assert wrapper.model.user_factors.shape == (len(wrapper.user_index),
                                                RANK)
    jw = jsrv._models[0]
    assert (wrapper.n_examples, wrapper.reg, wrapper.alpha,
            wrapper.app_name, tuple(wrapper.fold_event_names)) == \
        (jw.n_examples, jw.reg, jw.alpha, jw.app_name,
         tuple(jw.fold_event_names))
    psrv = EngineServer(engine(), EngineVariant.from_dict(PORT_VARIANT),
                        storage, host="127.0.0.1", port=0, device="cpu")
    want = jsrv.query_batch(_queries())
    got = psrv.query_batch(_queries())
    err = 0.0
    for g, w in zip(got, want):
        gi = [h["item"] for h in g["itemScores"]]
        wi = [h["item"] for h in w["itemScores"]]
        assert sorted(gi) == sorted(wi)
        gs = [h["score"] for h in g["itemScores"]]
        ws = [h["score"] for h in w["itemScores"]]
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
        err = max([err] + [abs(a - b) for a, b in zip(gs, ws)])
    print(f"served scores: max |port - JAX| {err:.3g}")
    assert got[-1] == {"itemScores": []}          # cold-start user
    phases = get_registry().get("pio_train_phase_ms")
    for name in ("train.datasource", "train.prepare", "train.algorithm",
                 "train.persist"):
        assert phases.count(phase=name) >= 1, name


def test_window_excludes_events_past_the_watermark(tmp_path):
    storage = get_storage(tmp_path)
    specs = [("rate", "a", "item", "x", {"rating": 3.0}),
             ("rate", "b", "item", "y", {"rating": 4.0})]
    app_id = _insert_port_events(storage, specs)
    future = dt.datetime.now(dt.timezone.utc) + dt.timedelta(days=1)
    storage.get_events().insert(
        Event(event="rate", entity_type="user", entity_id="late",
              target_entity_type="item", target_entity_id="z",
              properties=DataMap({"rating": 5.0}), event_time=future),
        app_id)
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    variant = {**PORT_VARIANT, "algorithms": [
        {"name": "als", "params": {"rank": 2, "numIterations": 1}}]}
    iid = run_train(engine(), EngineVariant.from_dict(variant), ctx)
    [w] = load_models(engine(), storage.get_engine_instances().get(iid),
                      RuntimeContext(storage=storage, device=CPU))
    assert sorted(w.user_index.keys()) == ["a", "b"]


def test_failed_train_is_recorded(tmp_path):
    storage = get_storage(tmp_path)
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    with pytest.raises(Exception, match="does not exist"):
        run_train(engine(), EngineVariant.from_dict(PORT_VARIANT), ctx)
    [instance] = storage.get_engine_instances().get_all()
    assert instance.status == "FAILED" and instance.end_time is not None


def test_ivf_pq_policy_refuses_instead_of_skipping(monkeypatch):
    """The train-time policy builds and skips as the reference's does:
    IVF only under an explicit ``PIO_IVF=on`` at or above
    ``PIO_IVF_MIN_ITEMS``; PQ under ``PIO_PQ`` (auto by default) at or
    above ``PIO_PQ_MIN_ITEMS``, on top of the index when there is one.
    Nothing is refused any more; only an empty train raises."""
    from predictionio_tpu_torch.retrieval import IVFIndex, PQCodebook

    rng = np.random.default_rng(0)
    n_users, n_items = 30, 300
    users = np.repeat(np.arange(n_users), 20)
    items = rng.integers(0, n_items, len(users))
    items[:n_items] = np.arange(n_items)       # every item rated once
    users[:n_items] = np.arange(n_items) % n_users
    ratings = Ratings(
        user_ids=users, item_ids=items,
        ratings=rng.integers(1, 6, len(users)).astype(np.float32),
        user_index=BiMap.string_int([f"u{u}" for u in range(n_users)]),
        item_index=BiMap.string_int([f"i{i}" for i in range(n_items)]))
    ctx = RuntimeContext(device=CPU)
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=4, numIterations=1))
    for k in ("PIO_IVF", "PIO_IVF_MIN_ITEMS", "PIO_IVF_NLIST", "PIO_PQ",
              "PIO_PQ_M", "PIO_PQ_MIN_ITEMS"):
        monkeypatch.delenv(k, raising=False)
    w = algo.train(ctx, ratings)                # defaults: below both mins
    assert w.model.item_factors.shape == (n_items, 4)
    assert w.ivf is None and w.pq is None
    monkeypatch.setenv("PIO_IVF_MIN_ITEMS", "100")
    monkeypatch.setenv("PIO_PQ_MIN_ITEMS", "100")
    w = algo.train(ctx, ratings)                # auto: PQ yes, IVF no
    assert w.ivf is None and isinstance(w.pq, PQCodebook)
    assert w.pq.n_items == n_items and w.pq.m == 1     # ~D/4 of rank 4
    monkeypatch.setenv("PIO_IVF", "on")
    w = algo.train(ctx, ratings)
    assert isinstance(w.ivf, IVFIndex) and isinstance(w.pq, PQCodebook)
    assert w.ivf.nlist == 17                   # ~sqrt(300)
    assert w.ivf.fingerprint == w.pq.fingerprint
    monkeypatch.setenv("PIO_PQ", "off")
    w = algo.train(ctx, ratings)
    assert isinstance(w.ivf, IVFIndex) and w.pq is None
    monkeypatch.setenv("PIO_IVF_MIN_ITEMS", "301")   # the threshold rules
    assert algo.train(ctx, ratings).ivf is None
    with pytest.raises(ValueError, match="No rating events"):
        algo.train(ctx, Ratings(
            user_ids=np.array([], np.int64), item_ids=np.array([], np.int64),
            ratings=np.array([], np.float32),
            user_index=BiMap.string_int([]), item_index=BiMap.string_int([])))
