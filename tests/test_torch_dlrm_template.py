"""The DLRM template: the port against the JAX package.

Both packages read the same impression events (a planted click model:
each user and item carries a hidden preference, plus four dense
features) and train from their shipped ``engine.json``, the port's
differing only in ``engineFactory``; the algorithm is cut to embed 8,
bottom [16, 8], top [16], batch 32, 2 epochs, seed 3, vocabularies 64.
Checks:

- ``bool_property`` equals the reference's on odd bags (``true``, ``1``,
  ``1.0``, ``1.5``, ``10``, a nested key, a missing key, ``null``,
  spacing, a key with regex characters), as JSON text and read through
  both stores (one sqlite ``pio.db``, and each package's MEMORY store);
- the datasource's ``CTRData`` equals the reference's exactly on the
  same events, from both stores, including a scalar ``dense``, quoted
  numbers, booleans, a nested key, a long list (truncated) and a short
  one (zero-padded);
- ``run_train`` + ``predict`` gives the reference's answers: the same
  items, probabilities within 2^-6 and the order equal except within
  that size (the 2-epoch train tolerance of ``tests/test_torch_dlrm.py``);
- the reference's trained model, carried in with ``state_from_host``,
  answers as the reference does through the port's ``EngineServer``
  (probabilities within 1e-5, float32 sums in another order);
- the model pickles as host numpy and ``post_load`` puts it on the
  server's device;
- every ``WarmStartFallback`` reason equals the reference's, and a warm
  start continues the carried state on the delta as the reference's
  does (within 2^-6);
- the quickstart loop through both CLIs on ONE ``pio.db`` (the
  reference's ``app new`` and ``import``, then each package's ``train``
  and ``batchpredict``), then the port's ``pio deploy`` in a subprocess
  answering as in process.
"""

import dataclasses
import datetime as dt
import json
import os
import pickle
import re
import select
import subprocess
import sys
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.controller import WarmStartFallback as JaxFallback
from predictionio_tpu.data.columnar import bool_property as jax_bool
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage as jax_reset
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxServer,
)
from predictionio_tpu.templates.dlrm import engine as jax_engine
from predictionio_tpu.templates.dlrm.engine import (
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.templates.dlrm.engine import (
    DLRMDataSource as JaxDataSource,
)
from predictionio_tpu.workflow.core_workflow import (
    load_models as jax_load_models,
)
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu_torch.cli.main import main as port_main
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import (
    EngineVariant,
    RuntimeContext,
    WarmStartFallback,
)
from predictionio_tpu_torch.data.columnar import bool_property
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage, get_storage
from predictionio_tpu_torch.data.storage import reset_storage
from predictionio_tpu_torch.models import dlrm as dlrm_lib
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.dlrm import (
    DataSourceParams,
    DLRMDataSource,
    DLRMModelWrapper,
    Query,
    engine,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    load_models,
    persist_instance,
    run_train,
)

ROOT = Path(__file__).resolve().parents[1]
SERVE_ATOL = 1e-5                       # float32 sums, another order
TRAIN_ATOL = 2.0 ** -6                  # tests/test_torch_dlrm.py's bound
SUBPROCESS_TIMEOUT_S = 180
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CPU = torch.device("cpu")
N_USERS, N_ITEMS, N_EVENTS, VOCAB = 30, 20, 640, 64
ALGO = {"embedDim": 8, "bottomMlp": [16, 8], "topMlp": [16], "epochs": 2,
        "batchSize": 32, "seed": 3, "userVocab": VOCAB, "itemVocab": VOCAB}

SHIPPED = json.loads((ROOT / "examples" / "dlrm" /
                      "engine.json").read_text())
PORT_SHIPPED = json.loads((ROOT / "predictionio_tpu_torch" / "templates" /
                           "dlrm" / "engine.json").read_text())
APP = SHIPPED["datasource"]["params"]["appName"]

# Odd property bags, each with what both packages must read from it:
# (properties, a clicked label expected)
ODD = [
    ({"clicked": True, "dense": [0.5, -1.0, 2.0, 0.25]}, True),
    ({"clicked": 1, "dense": [1, 2]}, True),                 # short: padded
    ({"clicked": 1.0, "dense": [1, 2, 3, 4, 5, 6]}, True),   # long: cut
    ({"clicked": 1.5, "dense": 3.5}, False),                 # scalar dense
    ({"clicked": 10, "dense": ["0.25", "2"]}, False),        # quoted numbers
    ({"clicked": False, "dense": [True, 1]}, False),         # booleans
    ({"ctx": {"clicked": True, "dense": [7, 8]}}, True),     # nested keys
    ({"other": 1}, False),                                    # missing
    ({"clicked": None, "dense": None}, False),               # null
    ({"clicked": "true", "dense": []}, False),               # a string
    ({}, False),
]
TEXT_BAGS = ['{"clicked": true}', '{"clicked":true}', '{"clicked" : 1}',
             '{"clicked": 1.0}', '{"clicked": 1.00}', '{"clicked": 1.}',
             '{"clicked": 1.5}', '{"clicked": 10}', '{"clicked": 01}',
             '{"clicked": false}', '{"clicked": 0}', '{"clicked": null}',
             '{"clicked": "true"}', '{"ctx": {"clicked": true}}',
             '{"other": 1}', '{}', '{"clicked":\ttrue,"x":2}',
             '{"clicked": true\n}', '{"clicked": 1}\n', '"clicked": 1',
             '{"xclicked": true}', '{"clicked": truex}', '',
             '{"a.b": true}', '{"aXb": true}', None]


def _spec(shipped, **algo):
    spec = json.loads(json.dumps(shipped))
    spec["datasource"]["params"].update(userVocab=VOCAB, itemVocab=VOCAB)
    spec["algorithms"][0]["params"].update({**ALGO, **algo})
    return spec


def _rows(seed=7, n=N_EVENTS, users=N_USERS, items=N_ITEMS):
    """(event, user, item, properties) in event-time order: a click is
    drawn from a logistic model of hidden user and item preferences
    and the first dense feature; every twentieth event is a ``view``
    (not read), and the odd bags come first."""
    rng = np.random.default_rng(seed)
    ub, ib = rng.standard_normal(users), rng.standard_normal(items)
    out = [("impression", f"u{k % users}", f"i{k % items}", props)
           for k, (props, _) in enumerate(ODD)]
    for k in range(n - len(ODD)):
        u, i = int(rng.integers(users)), int(rng.integers(items))
        dense = [round(float(x), 3) for x in rng.standard_normal(4)]
        p = 1.0 / (1.0 + np.exp(-(ub[u] + ib[i] + dense[0])))
        props = {"clicked": bool(rng.random() < p), "dense": dense}
        out.append(("view" if k % 20 == 19 else "impression", f"u{u}",
                    f"i{i}", props))
    return out


def _insert(storage, app_cls, event_cls, datamap_cls, rows, offset=0):
    apps = storage.get_apps()
    found = apps.get_by_name(APP)
    app_id = found.id if found else apps.insert(app_cls(id=None, name=APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        event_cls(event=e, entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=datamap_cls(props),
                  event_time=T0 + dt.timedelta(seconds=n + offset))
        for n, (e, u, i, props) in enumerate(rows)], app_id)


def _clean_env(monkeypatch, home):
    monkeypatch.setenv("PIO_HOME", str(home))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_FUSE", "PIO_PREFETCH",
                         "PIO_BATCH_AUTOSCALE", "PIO_STEP_TIMEOUT")) \
                or k in ("PIO_CONFIG_FILE", "PIO_RESULT_CACHE"):
            monkeypatch.delenv(k, raising=False)
    reset_storage()
    jax_reset()


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """The same events in (a) one sqlite ``pio.db`` written by the
    reference and read by both packages and (b) each package's MEMORY
    store: ``{"sqlite": (jax ctx, port ctx), "memory": (...)}``."""
    rows = _rows()
    _clean_env(monkeypatch, tmp_path / "home")
    jsql = jax_storage()
    _insert(jsql, JaxApp, JaxEvent, JaxDataMap, rows)
    out = {"sqlite": (JaxContext.create(storage=jsql),
                      RuntimeContext.create(storage=get_storage(),
                                            device="cpu"))}
    jax_reset()
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    jmem = jax_storage()
    _insert(jmem, JaxApp, JaxEvent, JaxDataMap, rows)
    pmem = Storage(memory_config(tmp_path / "port"))
    _insert(pmem, App, Event, DataMap, rows)
    out["memory"] = (JaxContext.create(storage=jmem),
                     RuntimeContext.create(storage=pmem, device="cpu"))
    try:
        yield out
    finally:
        reset_storage()
        jax_reset()


# -- bool_property and the datasource ----------------------------------------

@pytest.mark.parametrize("key", ["clicked", "a.b"])
def test_bool_property_on_json_text_equals_the_reference(key):
    want = jax_bool(pa.array(TEXT_BAGS, pa.string()), key)
    got = bool_property(TEXT_BAGS, key)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bool_property({"properties": TEXT_BAGS}, key), want)
    assert bool_property([], key).shape == (0,)


@pytest.mark.parametrize("backend", ["sqlite", "memory"])
def test_bool_property_through_both_stores(stores, backend):
    jctx, ctx = stores[backend]
    for ordered in (False, True):
        kw = dict(entity_type="user", target_entity_type="item",
                  event_names=["impression"], ordered=ordered)
        want = jax_bool(jctx.event_store.find_columnar(
            APP, columns=["entity_id", "properties_json"], **kw), "clicked")
        got = bool_property(ctx.event_store.find_columnar(
            APP, columns=["entity_id", "properties"], **kw), "clicked")
        np.testing.assert_array_equal(got, want)
    # in event-time order the odd bags come first
    np.testing.assert_array_equal(got[:len(ODD)],
                                  [label for _, label in ODD])


@pytest.mark.parametrize("backend", ["sqlite", "memory"])
def test_datasource_reads_what_the_reference_reads(stores, backend):
    jctx, ctx = stores[backend]
    want = JaxDataSource(JaxDataSourceParams(
        appName=APP, userVocab=VOCAB, itemVocab=VOCAB)).read_training(jctx)
    got = DLRMDataSource(DataSourceParams(
        appName=APP, userVocab=VOCAB, itemVocab=VOCAB)).read_training(ctx)
    assert got.n_dense == want.n_dense == 4
    for name in ("dense", "cat", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    assert len(got.labels) == N_EVENTS - (N_EVENTS - len(ODD)) // 20
    # the odd dense lists, read as the reference reads them
    rows = {tuple(r) for r in got.dense.tolist()}
    for odd in ([1, 2, 0, 0], [1, 2, 3, 4], [0.25, 2, 0, 0], [1, 1, 0, 0],
                [7, 8, 0, 0], [0, 0, 0, 0]):
        assert tuple(odd) in rows, odd


def test_an_app_without_impressions_raises(tmp_path):
    storage = Storage(memory_config(tmp_path))
    App_id = storage.get_apps().insert(App(id=None, name=APP))
    storage.get_events().init(App_id)
    with pytest.raises(ValueError, match="No impression events"):
        DLRMDataSource(DataSourceParams(appName=APP)).read_training(
            RuntimeContext.create(storage=storage, device="cpu"))


# -- train and serve ---------------------------------------------------------

def test_shipped_engine_json_differs_only_in_the_factory():
    assert {**PORT_SHIPPED, "engineFactory": SHIPPED["engineFactory"]} \
        == SHIPPED
    assert PORT_SHIPPED["engineFactory"] == \
        "predictionio_tpu_torch.templates.dlrm:engine"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained from their shipped engine.json on the same
    events in MEMORY stores: (reference model, reference ctx, port
    storage, port instance id)."""
    home = tmp_path_factory.mktemp("pio_home")
    rows = _rows()
    with pytest.MonkeyPatch.context() as mp:
        _clean_env(mp, home)
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        reset_observability()
        jctx = JaxContext.create(storage=jax_storage())
        _insert(jctx.storage, JaxApp, JaxEvent, JaxDataMap, rows)
        jeng = jax_engine()
        jiid = jax_run_train(jeng, JaxVariant.from_dict(_spec(SHIPPED)),
                             jctx)
        [jmodel] = jax_load_models(
            jeng, jctx.storage.get_engine_instances().get(jiid), jctx)
        storage = Storage(memory_config(home / "port"))
        _insert(storage, App, Event, DataMap, rows)
        ctx = RuntimeContext.create(storage=storage, device="cpu")
        iid = run_train(engine(), EngineVariant.from_dict(
            _spec(PORT_SHIPPED)), ctx)
        try:
            yield jmodel, jctx, storage, iid
        finally:
            jax_reset()
            reset_observability()


def _agree(got, want, atol):
    """The same items; scores within ``atol``; the order equal except
    between items whose scores lie within 2·atol."""
    gi = [h["item"] for h in got["itemScores"]]
    wi = [h["item"] for h in want["itemScores"]]
    assert sorted(gi) == sorted(wi)
    ws = {h["item"]: h["score"] for h in want["itemScores"]}
    gs = {h["item"]: h["score"] for h in got["itemScores"]}
    for item in wi:
        assert abs(gs[item] - ws[item]) <= atol, (item, gs[item], ws[item])
    for j, (a, b) in enumerate(zip(gi, wi)):
        if a != b:
            assert abs(ws[a] - ws[b]) <= 2 * atol, (gi, wi)


def _queries():
    rng = np.random.default_rng(5)
    qs = []
    for k in range(24):
        items = [f"i{i}" for i in rng.choice(N_ITEMS, 8, replace=False)]
        q = {"user": f"u{k % N_USERS}", "items": items}
        if k % 3 == 0:
            q["dense"] = [round(float(x), 3) for x in rng.standard_normal(
                2 + k % 5)]
        qs.append(q)
    return qs + [{"user": "ghost", "items": ["i1", "new-item", "i2"]},
                 {"user": "u1", "items": []}]


def _algos(**params):
    p = engine().make_algorithms(engine().bind_engine_params(
        _spec(PORT_SHIPPED, **params)))[0]
    j = jax_engine().make_algorithms(jax_engine().bind_engine_params(
        _spec(SHIPPED, **params)))[0]
    return p, j


def _pq(q):
    return Query(**q)


def _jq(q):
    from predictionio_tpu.templates.dlrm import Query as JaxQuery

    return JaxQuery(**q)


def _port_model(storage, iid):
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage, device=CPU))
    return model


def test_run_train_matches_the_reference(trained):
    jmodel, _, storage, iid = trained
    model = _port_model(storage, iid)
    assert isinstance(model, DLRMModelWrapper)
    assert model.n_examples == jmodel.n_examples
    assert model.state.step == int(jmodel.state.step) == 2 * -(
        -model.n_examples // 32)
    assert dataclasses.asdict(model.cfg) == {
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in dataclasses.asdict(jmodel.cfg).items()}
    p, j = _algos()
    for q in _queries():
        got = dataclasses.asdict(p.predict(model, _pq(q)))
        want = dataclasses.asdict(j.predict(jmodel, _jq(q)))
        _agree(got, want, TRAIN_ATOL)


def test_model_pickles_as_host_numpy_and_loads_on_the_device(trained):
    _, _, storage, iid = trained
    model = _port_model(storage, iid)
    snap = model.__getstate__()["state"]
    assert all(isinstance(x, np.ndarray) for x in
               dlrm_lib._leaves(snap["params"])
               + dlrm_lib._leaves(snap["opt_state"][0].sum_of_squares))
    back = pickle.loads(pickle.dumps(model))
    assert back.state.params["embed"].device == CPU
    for a, b in zip(dlrm_lib._leaves(model.state.params),
                    dlrm_lib._leaves(back.state.params)):
        assert torch.equal(a, b)
    back.post_load(RuntimeContext(storage=storage, device=CPU))
    assert back.state.params["embed"].device == CPU
    assert back.n_examples == model.n_examples


def _carried(jmodel) -> DLRMModelWrapper:
    tree = jax.tree.map(np.asarray, (jmodel.state.params,
                                     jmodel.state.opt_state,
                                     jmodel.state.step))
    cfg = dlrm_lib.DLRMConfig(**{
        f.name: getattr(jmodel.cfg, f.name)
        for f in dataclasses.fields(dlrm_lib.DLRMConfig)})
    return DLRMModelWrapper(state=dlrm_lib.state_from_host(tree, "cpu"),
                            cfg=cfg, user_vocab=jmodel.user_vocab,
                            item_vocab=jmodel.item_vocab,
                            n_dense=jmodel.n_dense,
                            n_examples=jmodel.n_examples)


def test_carried_model_answers_through_the_port_server(trained, tmp_path,
                                                       monkeypatch):
    jmodel, jctx, _, _ = trained
    storage = Storage(memory_config(tmp_path / "port"))
    persist_instance(engine(), EngineVariant.from_dict(_spec(PORT_SHIPPED)),
                     [_carried(jmodel)], storage)
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    port_srv = EngineServer(engine(), EngineVariant.from_dict(
        _spec(PORT_SHIPPED)), storage, device="cpu")
    jax_srv = JaxServer(jax_engine(), JaxVariant.from_dict(_spec(SHIPPED)),
                        jctx.storage)
    got = port_srv.query_batch(_queries())
    for q, g in zip(_queries(), got):
        w = jax_srv.query(q)
        assert g == port_srv.query(q)
        _agree(g, w, SERVE_ATOL)
    assert got[-1] == {"itemScores": []}


# -- warm start --------------------------------------------------------------

def _reason(fn):
    with pytest.raises((WarmStartFallback, JaxFallback)) as e:
        fn()
    return e.value.reason


@pytest.fixture(scope="module")
def deltas(tmp_path_factory):
    """The same delta window (known and new users and items) read by
    both packages' datasources."""
    rows = _rows(seed=9, n=96, users=N_USERS + 4, items=N_ITEMS + 2)
    storage = Storage(memory_config(tmp_path_factory.mktemp("delta")))
    _insert(storage, App, Event, DataMap, rows)
    params = dict(appName=APP, userVocab=VOCAB, itemVocab=VOCAB)
    port_delta = DLRMDataSource(DataSourceParams(**params)).read_training(
        RuntimeContext.create(storage=storage, device="cpu"))
    jax_reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        mp.setenv("PIO_HOME", str(tmp_path_factory.mktemp("jdelta")))
        jdctx = JaxContext.create(storage=jax_storage())
        _insert(jdctx.storage, JaxApp, JaxEvent, JaxDataMap, rows)
        jax_delta = JaxDataSource(JaxDataSourceParams(**params)) \
            .read_training(jdctx)
        jax_reset()
    return port_delta, jax_delta


def test_warm_start_fallback_reasons_equal_the_references(trained, deltas):
    jmodel, jctx, storage, iid = trained
    model = _port_model(storage, iid)
    pdelta, jdelta = deltas
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    warm = SimpleNamespace(max_delta_fraction=0.5, eval_tolerance=0.1)
    cases = []
    for key, value in (("embedDim", 4), ("bottomMlp", [16, 4]),
                       ("topMlp", [8]), ("learningRate", 0.01),
                       ("batchSize", 64), ("seed", 4),
                       ("userVocab", 128)):
        extra = {"embedDim": 4} if key == "bottomMlp" else {}
        p, j = _algos(**{key: value, **extra})
        cases.append((lambda p=p: p.warm_start(ctx, pdelta, model, warm),
                      lambda j=j: j.warm_start(jctx, jdelta, jmodel, warm)))
    p, j = _algos()
    small = SimpleNamespace(max_delta_fraction=0.05, eval_tolerance=0.1)
    cases.append((lambda: p.warm_start(ctx, pdelta, model, small),
                  lambda: j.warm_start(jctx, jdelta, jmodel, small)))
    old = dataclasses.replace(model, n_examples=0)
    jold = dataclasses.replace(jmodel, n_examples=0)
    cases.append((lambda: p.warm_start(ctx, pdelta, old, warm),
                  lambda: j.warm_start(jctx, jdelta, jold, warm)))
    for port_fn, jax_fn in cases:
        assert _reason(port_fn) == _reason(jax_fn)
    strict = SimpleNamespace(max_delta_fraction=0.5, eval_tolerance=-1.0)
    pr = _reason(lambda: p.warm_start(ctx, pdelta, model, strict))
    jr = _reason(lambda: j.warm_start(jctx, jdelta, jmodel, strict))
    head = "warm-started eval regressed on the delta sample ("
    assert pr.startswith(head) and jr.startswith(head)
    assert pr.endswith("tolerance -1)") and jr.endswith("tolerance -1)")


def test_warm_start_continues_as_the_reference(trained, deltas):
    jmodel, jctx, storage, iid = trained
    model = _carried(jmodel)
    before = [x.clone() for x in dlrm_lib._leaves(model.state.params)]
    pdelta, jdelta = deltas
    warm = SimpleNamespace(max_delta_fraction=0.5, eval_tolerance=0.1)
    p, j = _algos()
    got = p.warm_start(RuntimeContext.create(storage=storage, device="cpu"),
                       pdelta, model, warm)
    want = j.warm_start(jctx, jdelta, jmodel, warm)
    assert all(torch.equal(a, b) for a, b in
               zip(before, dlrm_lib._leaves(model.state.params)))
    n = len(pdelta.labels)
    assert got.n_examples == want.n_examples == model.n_examples + n
    assert got.state.step == int(want.state.step) == \
        model.state.step + 2 * -(-n // 32)
    for g, w in zip(dlrm_lib._leaves(got.state.params),
                    [want.state.params["embed"]] + [
                        layer[k] for mlp in ("bottom", "top")
                        for layer in want.state.params[mlp]
                        for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TRAIN_ATOL)
    for q in _queries():
        _agree(dataclasses.asdict(p.predict(got, _pq(q))),
               dataclasses.asdict(j.predict(want, _jq(q))), TRAIN_ATOL)


# -- the CLI loop ------------------------------------------------------------

def _write_events(path, rows):
    with open(path, "w") as f:
        for k, (e, u, i, props) in enumerate(rows):
            f.write(json.dumps({
                "event": e, "entityType": "user", "entityId": u,
                "targetEntityType": "item", "targetEntityId": i,
                "properties": props,
                "eventTime": f"2026-01-01T{k // 3600:02d}:"
                             f"{k // 60 % 60:02d}:{k % 60:02d}Z"}) + "\n")
    return path


def test_quickstart_through_both_clis_then_a_port_deploy(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    from predictionio_tpu.cli.main import main as jax_main

    home = tmp_path / "home"
    home.mkdir()
    _clean_env(monkeypatch, home)
    src = _write_events(tmp_path / "ev.jsonl", _rows())
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(json.dumps(q) + "\n" for q in _queries()))
    try:
        assert jax_main(["app", "new", APP]) == 0
        assert jax_main(["import", "--appid", "1", "--input",
                         str(src)]) == 0
        preds = {}
        for name, cli, shipped, extra in (
                ("jax", jax_main, SHIPPED, []),
                ("port", port_main, PORT_SHIPPED, ["--device", "cpu"])):
            ej = tmp_path / f"{name}.json"
            ej.write_text(json.dumps(_spec(shipped)))
            out = tmp_path / f"{name}.jsonl"
            assert cli(["train", "--engine-json", str(ej), *extra]) == 0
            assert cli(["batchpredict", "--engine-json", str(ej),
                        "--input", str(queries), "--output", str(out),
                        *extra]) == 0
            preds[name] = [json.loads(ln) for ln in
                           out.read_text().splitlines()]
        capsys.readouterr()
        assert len(preds["port"]) == len(preds["jax"]) == len(_queries())
        for got, want in zip(preds["port"], preds["jax"]):
            assert got["query"] == want["query"]
            _agree(got["prediction"], want["prediction"], TRAIN_ATOL)
        local = EngineServer(engine(), EngineVariant.from_file(
            tmp_path / "port.json"), get_storage(), device="cpu")
        want = {json.dumps(q): local.query(q) for q in _queries()[:6]}
        local.stop()
    finally:
        reset_storage()
        jax_reset()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--engine-json", str(tmp_path / "port.json"), "--device", "cpu",
         "--ip", "127.0.0.1", "--port", "0"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [],
                                    SUBPROCESS_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        m = re.search(r"listening on 127\.0\.0\.1:(\d+) \(instance (\w+); "
                      r"device cpu;", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None
                   else "")
        base = f"http://127.0.0.1:{m.group(1)}"
        for key, answer in want.items():
            req = urllib.request.Request(base + "/queries.json",
                                         data=key.encode(), method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert json.loads(r.read()) == answer
        req = urllib.request.Request(base + "/stop", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"status": "stopping"}
        assert proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
