"""The two-tower template: the port against the JAX package.

Both packages read the same events (interactions with a clique
structure: users mostly interact with items of their own parity) and
train from their shipped ``engine.json``, the port's differing only in
``engineFactory``; the algorithm is cut to embed 8, hidden [16], out 8,
batch 16, 2 epochs, seed 3.  Checks:

- the datasource reads the same interactions and indexes;
- the quickstart loop through both CLIs on ONE ``pio.db`` (the
  reference's ``app new`` and ``import``, then each package's ``train``
  and ``batchpredict``, the port's with ``--device cpu``): ids equal
  except within a tie, scores within 2^-6 absolute — a score is the dot
  product of two unit vectors whose components each sit within one
  bfloat16 ulp (2^-8) of the reference's (``tests/test_torch_two_tower.py``),
  so a score is within 2·2^-8·√8 < 2^-6; the largest gap measured is
  below 1e-3;
- the reference's trained model carried in through ``model_from_numpy``
  answers as the reference does through both packages' engine servers:
  ids equal except within a tie, scores within 1e-5;
- every ``WarmStartFallback`` reason equals the reference's, and a warm
  start of the port's own generation continues on the delta (grown
  indexes, the regression gate passed);
- ``pio train --fuse-steps 0``, ``--fuse-steps x`` and
  ``--prefetch-depth`` exit and print as the reference's CLI does.
"""

import dataclasses
import datetime as dt
import json
import os
import pickle
import signal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.controller import WarmStartFallback as JaxFallback
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage as jax_reset
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxServer,
)
from predictionio_tpu.templates.twotower import engine as jax_engine
from predictionio_tpu.templates.twotower.engine import (
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.templates.twotower.engine import (
    TwoTowerDataSource as JaxDataSource,
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
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.data.storage import reset_storage
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.twotower import (
    DataSourceParams,
    TwoTowerDataSource,
    TwoTowerModelWrapper,
    engine,
    model_from_numpy,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    load_models,
    persist_instance,
    run_train,
)

ROOT = Path(__file__).resolve().parents[1]
_PIPELINE_FLAGS = ("PIO_FUSE_STEPS", "PIO_PREFETCH_DEPTH",
                   "PIO_BATCH_AUTOSCALE")
_FLAGS_AT_IMPORT = {k: os.environ.get(k) for k in _PIPELINE_FLAGS}
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-5     # float32 scores, another order
TRAIN_ATOL = 2.0 ** -6                  # two bfloat16-rounded unit vectors
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CPU = torch.device("cpu")
N_USERS, N_ITEMS, N_EVENTS = 50, 40, 600
ALGO = {"embedDim": 8, "hiddenDims": [16], "outDim": 8, "epochs": 2,
        "batchSize": 16, "seed": 3}

SHIPPED = json.loads((ROOT / "examples" / "twotower" /
                      "engine.json").read_text())
PORT_SHIPPED = json.loads((ROOT / "predictionio_tpu_torch" / "templates" /
                           "twotower" / "engine.json").read_text())
APP = SHIPPED["datasource"]["params"]["appName"]


def _spec(shipped, **algo):
    spec = json.loads(json.dumps(shipped))
    spec["algorithms"][0]["params"].update({**ALGO, **algo})
    return spec


def _rows(seed=7, n=N_EVENTS, users=N_USERS, items=N_ITEMS, prefix=""):
    """(event, user, item) in event-time order: users mostly interact
    with items of their own parity; a few events are buys and views."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u = int(rng.integers(users))
        pool = [i for i in range(items) if i % 2 == u % 2]
        i = int(rng.choice(pool)) if rng.random() < 0.9 \
            else int(rng.integers(items))
        name = ("buy", "view", "rate")[k % 7 % 3]
        out.append((name, f"{prefix}u{u}", f"i{i}"))
    return out


def _insert(storage, app_cls, event_cls, datamap_cls, rows, offset=0,
            start=T0):
    apps = storage.get_apps()
    found = apps.get_by_name(APP)
    app_id = found.id if found else apps.insert(app_cls(id=None, name=APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        event_cls(event=e, entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=datamap_cls({"rating": 4.0} if e == "rate"
                                         else {}),
                  event_time=start + dt.timedelta(seconds=n + offset))
        for n, (e, u, i) in enumerate(rows)], app_id)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained from their shipped engine.json on the same
    events in memory stores: (reference model, reference ctx, port
    storage, port instance id)."""
    home = tmp_path_factory.mktemp("pio_home")
    rows = _rows()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_IVF", "PIO_PQ",
                             "PIO_FUSE", "PIO_PREFETCH")) \
                    or k == "PIO_RETRIEVAL_RUNG":
                mp.delenv(k, raising=False)
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        jax_reset()
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


def _agree(got, want, rtol, atol):
    """Ids equal except within a tie at the k-th score; scores close."""
    gi = [h["item"] for h in got["itemScores"]]
    wi = [h["item"] for h in want["itemScores"]]
    gs = np.array([h["score"] for h in got["itemScores"]])
    ws = np.array([h["score"] for h in want["itemScores"]])
    assert len(gi) == len(wi), (gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(ws).max(initial=0.0)
    for j, (a, b) in enumerate(zip(gi, wi)):
        if a != b:
            tied = [k for k, w in enumerate(wi) if w == a]
            assert tied and abs(ws[tied[0]] - ws[j]) <= 2 * tol \
                or abs(ws[j] - ws[-1]) <= 2 * tol, (gi, wi, ws)


def _queries():
    return [{"user": f"u{u}", "num": n}
            for u, n in zip(range(N_USERS), [1, 3, 5, 10, N_ITEMS] * 10)] \
        + [{"user": "ghost", "num": 4}]


def test_shipped_engine_json_differs_only_in_the_factory():
    assert {**PORT_SHIPPED, "engineFactory": SHIPPED["engineFactory"]} \
        == SHIPPED
    assert PORT_SHIPPED["engineFactory"] == \
        "predictionio_tpu_torch.templates.twotower:engine"


def test_datasource_reads_what_the_reference_reads(trained):
    _, jctx, storage, _ = trained
    want = JaxDataSource(JaxDataSourceParams(appName=APP)).read_training(jctx)
    got = TwoTowerDataSource(DataSourceParams(appName=APP)).read_training(
        RuntimeContext.create(storage=storage, device="cpu"))
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    assert dict(got.user_index.items()) == dict(want.user_index.items())
    assert dict(got.item_index.items()) == dict(want.item_index.items())


def test_run_train_matches_the_reference(trained):
    jmodel, _, storage, iid = trained
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage, device=CPU))
    assert isinstance(model, TwoTowerModelWrapper)
    assert dict(model.user_index.items()) == dict(jmodel.user_index.items())
    np.testing.assert_allclose(model.user_vecs, jmodel.user_vecs, rtol=0,
                               atol=2.0 ** -8)
    np.testing.assert_allclose(model.item_vecs, jmodel.item_vecs, rtol=0,
                               atol=2.0 ** -8)
    assert model.n_examples == jmodel.n_examples == N_EVENTS
    assert model.train_cfg == dataclasses.replace(
        model.train_cfg, **{f.name: getattr(jmodel.train_cfg, f.name)
                            for f in dataclasses.fields(jmodel.train_cfg)})
    assert int(model.train_state["step"]) == int(jmodel.train_state["step"])
    # Both packages bake the quality scorecard at train (the rank-1 score
    # distribution of a seeded user sample), from vectors equal within
    # the tolerance above; the corpus is below every IVF/PQ threshold, so
    # neither bakes a recall scorecard.
    sc, jsc = model.quality, jmodel.quality
    assert sc is not None and jsc is not None
    assert (sc.n, len(sc.probs), sc.name) == (jsc.n, len(jsc.probs), jsc.name)
    np.testing.assert_allclose(sc.edges, jsc.edges, rtol=0, atol=2.0 ** -6)
    np.testing.assert_allclose([sc.mean, sc.std], [jsc.mean, jsc.std],
                               rtol=0, atol=2.0 ** -6)
    assert model.recall is None and jmodel.recall is None
    algo = engine().make_algorithms(
        engine().bind_engine_params(_spec(PORT_SHIPPED)))[0]
    jalgo = jax_engine().make_algorithms(
        jax_engine().bind_engine_params(_spec(SHIPPED)))[0]
    for q in _queries():
        got = dataclasses.asdict(algo.predict(model, _q(q)))
        want = dataclasses.asdict(jalgo.predict(jmodel, _jq(q)))
        _agree(got, want, 0.0, TRAIN_ATOL)


def _q(q):
    from predictionio_tpu_torch.templates.twotower import Query

    return Query(**q)


def _jq(q):
    from predictionio_tpu.templates.twotower import Query

    return Query(**q)


def test_model_pickles_and_keeps_no_device(trained):
    _, _, storage, iid = trained
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage, device=CPU))
    model.retriever()
    back = pickle.loads(pickle.dumps(model))
    assert back._device is None
    np.testing.assert_array_equal(back.item_vecs, model.item_vecs)
    assert back.train_state["opt_state"][0].count == \
        model.train_state["opt_state"][0].count


# -- the reference's model through both servers ------------------------------------

def _carried(jmodel) -> TwoTowerModelWrapper:
    return model_from_numpy(jmodel.user_vecs, jmodel.item_vecs,
                            jmodel.user_index, jmodel.item_index,
                            train_state=jmodel.train_state,
                            train_cfg=jmodel.train_cfg,
                            n_examples=jmodel.n_examples)


def test_carried_model_answers_through_both_servers(trained, tmp_path,
                                                    monkeypatch):
    jmodel, jctx, _, _ = trained
    carried = _carried(jmodel)
    assert carried.train_cfg.hidden_dims == (16,)
    assert isinstance(carried.train_state["opt_state"][0].count,
                      np.ndarray)
    storage = Storage(memory_config(tmp_path / "port"))
    persist_instance(engine(), EngineVariant.from_dict(_spec(PORT_SHIPPED)),
                     [carried], storage)
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    port_srv = EngineServer(engine(), EngineVariant.from_dict(
        _spec(PORT_SHIPPED)), storage, device="cpu")
    # the reference serves its own trained instance (run_train's)
    jax_srv = JaxServer(jax_engine(), JaxVariant.from_dict(_spec(SHIPPED)),
                        jctx.storage)
    for q in _queries():
        _agree(port_srv.query(q), jax_srv.query(q), SERVE_RTOL, SERVE_ATOL)
    for rung in ("device", "chunked"):
        monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
        port_srv = EngineServer(engine(), EngineVariant.from_dict(
            _spec(PORT_SHIPPED)), storage, device="cpu")
        got = port_srv.query_batch(_queries())
        for q, g in zip(_queries(), got):
            _agree(g, jax_srv.query(q), SERVE_RTOL, SERVE_ATOL)


# -- warm start --------------------------------------------------------------------------

def _algos(**params):
    p = engine().make_algorithms(engine().bind_engine_params(
        _spec(PORT_SHIPPED, **params)))[0]
    j = jax_engine().make_algorithms(jax_engine().bind_engine_params(
        _spec(SHIPPED, **params)))[0]
    return p, j


def _reason(fn):
    with pytest.raises((WarmStartFallback, JaxFallback)) as e:
        fn()
    return e.value.reason


@pytest.fixture(scope="module")
def deltas(trained, tmp_path_factory):
    """The same delta window (new users and items among known ones) read
    by both packages' datasources."""
    _, jctx, _, _ = trained
    rows = _rows(seed=9, n=60, users=N_USERS + 4, items=N_ITEMS + 2,
                 prefix="")
    storage = Storage(memory_config(tmp_path_factory.mktemp("delta")))
    _insert(storage, App, Event, DataMap, rows)
    port_delta = TwoTowerDataSource(DataSourceParams(appName=APP)) \
        .read_training(RuntimeContext.create(storage=storage, device="cpu"))
    jax_reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        mp.setenv("PIO_HOME", str(tmp_path_factory.mktemp("jdelta")))
        jdctx = JaxContext.create(storage=jax_storage())
        _insert(jdctx.storage, JaxApp, JaxEvent, JaxDataMap, rows)
        jax_delta = JaxDataSource(JaxDataSourceParams(appName=APP)) \
            .read_training(jdctx)
        jax_reset()
    return port_delta, jax_delta


def test_warm_start_fallback_reasons_equal_the_references(trained, deltas):
    jmodel, jctx, storage, iid = trained
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage, device=CPU))
    pdelta, jdelta = deltas
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    warm = SimpleNamespace(max_delta_fraction=0.5, eval_tolerance=0.1)
    cases = []
    # no carried state
    p, j = _algos()
    cases.append((lambda: p.warm_start(ctx, pdelta, dataclasses.replace(
        model, train_state=None), warm),
        lambda: j.warm_start(jctx, jdelta, dataclasses.replace(
            jmodel, train_state=None), warm)))
    # each config field that forbids continuation
    for key, value in (("embedDim", 16), ("hiddenDims", [32]),
                       ("outDim", 4), ("learningRate", 0.01),
                       ("temperature", 0.1), ("batchSize", 32),
                       ("seed", 4)):
        p, j = _algos(**{key: value})
        cases.append((lambda p=p: p.warm_start(ctx, pdelta, model, warm),
                      lambda j=j: j.warm_start(jctx, jdelta, jmodel, warm)))
    # a delta too large for the previous corpus
    p, j = _algos()
    small = SimpleNamespace(max_delta_fraction=0.05, eval_tolerance=0.1)
    cases.append((lambda: p.warm_start(ctx, pdelta, model, small),
                  lambda: j.warm_start(jctx, jdelta, jmodel, small)))
    for port_fn, jax_fn in cases:
        assert _reason(port_fn) == _reason(jax_fn)
    # a continuation that regresses (no tolerance at all): the reason
    # names the gate; the losses themselves are the two trains'
    strict = SimpleNamespace(max_delta_fraction=0.5, eval_tolerance=-1.0)
    pr = _reason(lambda: p.warm_start(ctx, pdelta, model, strict))
    jr = _reason(lambda: j.warm_start(jctx, jdelta, jmodel, strict))
    head = "warm-started eval regressed on the delta sample ("
    assert pr.startswith(head) and jr.startswith(head)
    assert pr.endswith("tolerance -1)") and jr.endswith("tolerance -1)")


def test_warm_start_continues_on_the_delta(trained, deltas):
    jmodel, jctx, storage, iid = trained
    [model] = load_models(engine(), storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=storage, device=CPU))
    pdelta, jdelta = deltas
    warm = SimpleNamespace(max_delta_fraction=0.5, eval_tolerance=0.1)
    p, j = _algos()
    got = p.warm_start(RuntimeContext.create(storage=storage, device="cpu"),
                       pdelta, model, warm)
    want = j.warm_start(jctx, jdelta, jmodel, warm)
    assert dict(got.user_index.items()) == dict(want.user_index.items())
    assert dict(got.item_index.items()) == dict(want.item_index.items())
    assert len(got.user_index) > len(model.user_index)
    assert got.n_examples == want.n_examples == N_EVENTS + 60
    assert int(got.train_state["step"]) == int(want.train_state["step"])
    np.testing.assert_allclose(got.item_vecs, want.item_vecs, rtol=0,
                               atol=TRAIN_ATOL)
    # rows of entities the delta does not name keep their ids
    for k, v in model.user_index.items():
        assert got.user_index[k] == v


# -- the quickstart loop through both CLIs on one pio.db --------------------------------

def _write_events(path, rows):
    with open(path, "w") as f:
        for k, (e, u, i) in enumerate(rows):
            ev = {"event": e, "entityType": "user", "entityId": u,
                  "targetEntityType": "item", "targetEntityId": i,
                  "eventTime": f"2026-01-01T00:{k // 60:02d}:{k % 60:02d}Z"}
            if e == "rate":
                ev["properties"] = {"rating": 4.0}
            f.write(json.dumps(ev) + "\n")
    return path


def _clean_env(monkeypatch, home):
    monkeypatch.setenv("PIO_HOME", str(home))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_IVF", "PIO_PQ", "PIO_FUSE",
                         "PIO_PREFETCH", "PIO_BATCH_AUTOSCALE")) \
                or k in ("PIO_CONFIG_FILE", "PIO_RETRIEVAL_RUNG"):
            monkeypatch.delenv(k, raising=False)
    reset_storage()
    jax_reset()


@pytest.fixture()
def one_home(tmp_path, monkeypatch):
    from predictionio_tpu.cli.main import main as jax_main

    home = tmp_path / "home"
    home.mkdir()
    _clean_env(monkeypatch, home)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        yield home, jax_main
    finally:
        signal.signal(signal.SIGTERM, previous)
        reset_storage()
        jax_reset()


def test_quickstart_through_both_clis_on_one_pio_db(one_home, tmp_path,
                                                    capsys):
    home, jax_main = one_home
    src = _write_events(tmp_path / "ev.jsonl", _rows(n=480))
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(json.dumps(q) + "\n" for q in _queries()))
    assert jax_main(["app", "new", APP]) == 0
    assert jax_main(["import", "--appid", "1", "--input", str(src)]) == 0
    preds = {}
    for name, cli, shipped, extra in (
            ("jax", jax_main, SHIPPED, []),
            ("port", port_main, PORT_SHIPPED, ["--device", "cpu"])):
        ej = tmp_path / f"{name}.json"
        ej.write_text(json.dumps(_spec(shipped)))
        out = tmp_path / f"{name}.jsonl"
        assert cli(["train", "--engine-json", str(ej), *extra]) == 0
        assert cli(["batchpredict", "--engine-json", str(ej), "--input",
                    str(queries), "--output", str(out), *extra]) == 0
        preds[name] = [json.loads(ln) for ln in
                       out.read_text().splitlines()]
    capsys.readouterr()
    assert (home / "storage" / "pio.db").exists()
    assert len(preds["port"]) == len(preds["jax"]) == len(_queries())
    for got, want in zip(preds["port"], preds["jax"]):
        assert got["query"] == want["query"]
        _agree(got["prediction"], want["prediction"], 0.0, TRAIN_ATOL)
    assert preds["port"][-1]["prediction"] == {"itemScores": []}


@pytest.mark.parametrize("argv,env", [
    (["--fuse-steps", "0"], None),
    (["--fuse-steps", "x"], None),
    (["--fuse-steps", "auto"], ("PIO_FUSE_STEPS", "auto")),
    (["--prefetch-depth", "3"], ("PIO_PREFETCH_DEPTH", "3")),
    (["--batch-autoscale"], ("PIO_BATCH_AUTOSCALE", "on")),
])
def test_train_pipeline_flags_exit_and_print_as_the_reference(
        one_home, tmp_path, capsys, monkeypatch, argv, env):
    """With an engine.json that is not there, both CLIs stop at the same
    point: a bad --fuse-steps before it, a good flag after setting its
    variable.  The verb sets that variable in this process, so each one
    is put under monkeypatch first: teardown then restores the value
    from before the test (a ``delenv`` of an unset name records nothing,
    and would leave the verb's value to later tests in the process)."""
    home, jax_main = one_home
    for k in _PIPELINE_FLAGS:
        monkeypatch.setenv(k, "")
    results = []
    for cli in (jax_main, port_main):
        for k in _PIPELINE_FLAGS:
            os.environ.pop(k, None)
        with pytest.raises(SystemExit) as e:
            cli(["train", "--engine-json", str(tmp_path / "none.json"),
                 *argv])
        cap = capsys.readouterr()
        results.append((e.value.code, cap.out, cap.err,
                        os.environ.get(env[0]) if env else None))
    assert results[0] == results[1]
    code, _, err, value = results[1]
    assert code == 1 and err.startswith("[error] ")
    if env:
        assert value == env[1] and "not found" in err
    else:
        assert "--fuse-steps" in err


def test_the_pipeline_flags_test_leaves_no_variable_behind():
    """Runs after the cases above (the file's order): the variables the
    verb set are back to what they were when this module was imported,
    so a later test in the process (the reference's resume test, say)
    trains unfused at the batch size it asked for."""
    assert {k: os.environ.get(k) for k in _PIPELINE_FLAGS} == \
        _FLAGS_AT_IMPORT
