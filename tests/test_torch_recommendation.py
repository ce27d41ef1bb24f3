"""ALS recommendation serving: the PyTorch port end to end vs the JAX one.

A tiny model is trained with the JAX template (events → ``run_train``),
carried into the port with ``wrapper_from_numpy``, persisted with the
port's ``persist_instance`` and served by the port's ``EngineServer`` on
the CPU.  The same queries through both servers' ``query_batch`` must
return the same items with scores within float32 tolerance, on every
exact rung.
"""

import json
import os
import pickle
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap, Event
from predictionio_tpu.data.storage import App, get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxEngineServer,
)
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu.workflow.core_workflow import run_train
from predictionio_tpu_torch.controller import (
    EngineVariant,
    RuntimeContext,
    load_engine_factory,
)
from predictionio_tpu_torch.data.storage import App as PortApp
from predictionio_tpu_torch.data.storage import get_storage
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSModelWrapper,
    Query,
    engine,
    wrapper_from_numpy,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    load_models,
    persist_instance,
)

RTOL = 1e-5   # float32 scores, summed in another order
ATOL = 1e-6
N_USERS, N_ITEMS, RANK = 50, 40, 8

VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": "torchparity"}},
    "algorithms": [
        {"name": "als",
         "params": {"rank": RANK, "numIterations": 6, "lambda_": 0.05,
                    "seed": 3}}
    ],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}
ENGINE_JSON = os.path.join(os.path.dirname(__file__), "..",
                           "predictionio_tpu_torch", "templates",
                           "recommendation", "engine.json")


def _seed_events(storage):
    app_id = storage.get_apps().insert(App(id=None, name="torchparity"))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(0)
    batch = []
    for u in range(N_USERS):
        for i in range(N_ITEMS):
            if i % 3 == u % 3 and rng.random() < 0.8:
                batch.append(Event(
                    event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": float(1 + 4 * rng.random())})))
    events.insert_batch(batch, app_id)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX EngineServer, port EngineServer, port Storage, carried
    wrapper) over one trained generation."""
    home = tmp_path_factory.mktemp("pio_home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith("PIO_STORAGE_") or k == "PIO_RETRIEVAL_RUNG":
                mp.delenv(k, raising=False)
        reset_storage()
        reset_observability()
        ctx = JaxContext.create(storage=jax_storage())
        _seed_events(ctx.storage)
        jeng = jax_engine()
        run_train(jeng, JaxVariant.from_dict(VARIANT), ctx)
        jsrv = JaxEngineServer(jeng, JaxVariant.from_dict(VARIANT),
                               ctx.storage, host="127.0.0.1", port=0)
        jw = jsrv._models[0]
        uf = np.asarray(jax.device_get(jw.model.user_factors))
        itf = np.asarray(jax.device_get(jw.model.item_factors))
        wrapper = wrapper_from_numpy(
            uf[:len(jw.user_index)], itf[:len(jw.item_index)],
            jw.user_index.to_numpy_keys(), jw.item_index.to_numpy_keys(),
            rank=RANK, implicit=jw.model.implicit)
        storage = get_storage(home / "port")
        eng = engine()
        variant = EngineVariant.from_dict(PORT_VARIANT)
        persist_instance(eng, variant, [wrapper], storage)
        psrv = EngineServer(eng, variant, storage, host="127.0.0.1", port=0,
                            device="cpu")
        try:
            yield jsrv, psrv, storage, wrapper
        finally:
            psrv.stop()
            jsrv.stop()
            reset_storage()
            reset_observability()


def _queries():
    nums = (1, 3, 10, 40)
    qs = [{"user": f"u{u}", "num": nums[u % 4]} for u in range(N_USERS)]
    return qs + [{"user": "ghost", "num": 5}]


def _assert_same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gi = [h["item"] for h in g["itemScores"]]
        wi = [h["item"] for h in w["itemScores"]]
        assert sorted(gi) == sorted(wi)
        np.testing.assert_allclose(
            [h["score"] for h in g["itemScores"]],
            [h["score"] for h in w["itemScores"]], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rung", ["auto", "host", "device", "chunked"])
def test_query_batch_matches_jax_server(servers, monkeypatch, rung):
    jsrv, psrv, _, _ = servers
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
    want = jsrv.query_batch(_queries())
    got = psrv.query_batch(_queries())
    _assert_same_answers(got, want)
    err = max((abs(g["score"] - w["score"])
               for a, b in zip(got, want)
               for g, w in zip(a["itemScores"], b["itemScores"])),
              default=0.0)
    print(f"rung {rung}: max |score - JAX score| {err:.3g}")
    assert got[-1] == {"itemScores": []}          # cold-start user
    assert len(got[0]["itemScores"]) == 1
    assert len(got[3]["itemScores"]) == N_ITEMS   # num = the whole catalog


def test_http_round_trip(servers, monkeypatch):
    jsrv, psrv, _, _ = servers
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", "chunked")
    psrv.start()
    base = f"http://127.0.0.1:{psrv.port}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    try:
        q = {"user": "u7", "num": 4}
        status, answer = post("/queries.json", json.dumps(q).encode())
        assert status == 200
        _assert_same_answers([answer], jsrv.query_batch([q]))
        assert psrv.query(q) == answer
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            info = json.loads(r.read())
        assert info["status"] == "alive" and info["device"] == "cpu"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            metrics = r.read().decode()
        assert 'pio_retrieval_requests_total{rung="chunked",corpus="als"}' \
            in metrics
        assert "pio_query_requests_total" in metrics
        for bad in (b"{not json", json.dumps({"user": "u1", "x": 1}).encode()):
            with pytest.raises(urllib.error.HTTPError) as e:
                post("/queries.json", bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404
    finally:
        psrv.stop()


def _leaves(obj, seen=None):
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        yield from _leaves(vars(obj), seen)
    elif hasattr(obj, "__slots__"):
        for name in obj.__slots__:
            yield from _leaves(getattr(obj, name, None), seen)
    else:
        yield obj


def test_wrapper_pickles_numpy_only(servers):
    _, _, _, wrapper = servers
    wrapper.post_load(RuntimeContext(device=torch.device("cpu")))
    wrapper.retriever().device_vecs()   # a staged tensor must not ride along
    blob = pickle.dumps(wrapper)
    back = pickle.loads(blob)
    leaves = list(_leaves(back))
    assert not any(isinstance(x, torch.Tensor) for x in leaves)
    arrays = [x for x in leaves if isinstance(x, np.ndarray)]
    assert {a.dtype for a in arrays} == {np.dtype(np.float32)}
    np.testing.assert_array_equal(back.model.item_factors,
                                  wrapper.model.item_factors)
    back.post_load(RuntimeContext(device=torch.device("cpu")))
    algo = ALSAlgorithm()
    q = [(0, Query(user="u2", num=5))]
    assert algo.batch_predict(back, q) == algo.batch_predict(wrapper, q)


def test_load_models_runs_post_load_on_the_server_device(servers):
    _, psrv, storage, _ = servers
    inst = psrv._instance
    ctx = RuntimeContext(storage=storage, device=torch.device("cpu"))
    [w] = load_models(engine(), inst, ctx)
    assert isinstance(w, ALSModelWrapper)
    assert w.retriever().device == torch.device("cpu")


def test_model_functions_match_jax(servers):
    _, _, _, wrapper = servers
    m = wrapper.model
    jm = jax_als.ALSModel(user_factors=jax.numpy.asarray(m.user_factors),
                          item_factors=jax.numpy.asarray(m.item_factors),
                          rank=m.rank, implicit=m.implicit)
    users = np.array([0, 3, 7, 49])
    items = np.array([1, 5, 39, 0])
    want = np.asarray(jax_als.predict_scores(
        jm.user_factors, jm.item_factors, jax.numpy.asarray(users),
        jax.numpy.asarray(items)))
    got = port_als.predict_scores(torch.from_numpy(m.user_factors),
                                  torch.from_numpy(m.item_factors),
                                  torch.from_numpy(users),
                                  torch.from_numpy(items))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for chunk in (None, 16):
        ws, wi = jax_als.recommend(jm, jax.numpy.asarray(users), 5,
                                   chunk=chunk)
        gs, gi = port_als.recommend(m, users, 5, chunk=chunk,
                                    device=torch.device("cpu"))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL,
                                   atol=ATOL)
        assert (np.sort(gi.numpy(), 1) == np.sort(np.asarray(wi), 1)).all()


def test_engine_json_binds_and_training_waits(tmp_path):
    variant = EngineVariant.from_file(ENGINE_JSON)
    assert variant.engine_factory == \
        "predictionio_tpu_torch.templates.recommendation:engine"
    eng = load_engine_factory(variant.engine_factory)()
    params = eng.bind_engine_params(variant.raw)
    assert params.algorithms_params[0][0] == "als"
    assert eng.query_class is Query
    # training now runs; it waits for events: an app with none is refused
    storage = get_storage(tmp_path)
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    with pytest.raises(Exception, match="does not exist"):
        eng.datasource_class(params.datasource_params).read_training(ctx)
    storage.get_apps().insert(PortApp(id=None, name="MyApp1"))
    storage.get_events().init(storage.get_apps().get_by_name("MyApp1").id)
    ratings = eng.datasource_class(params.datasource_params).read_training(
        ctx)
    assert len(ratings.user_ids) == 0
    with pytest.raises(ValueError, match="No rating events"):
        ALSAlgorithm().train(ctx, ratings)


def test_unported_structures_refused_at_load():
    """A generation that carries an IVF index and PQ codes loads and
    serves them now; at serving time they are refused (dropped, serving
    exact) only when their fingerprint does not match the served item
    factors."""
    from predictionio_tpu_torch.retrieval import build_ivf, build_pq

    rng = np.random.default_rng(2)
    uf = rng.standard_normal((3, 4)).astype(np.float32)
    itf = rng.standard_normal((400, 4)).astype(np.float32)
    ivf = build_ivf(itf, nlist=5, force=True)
    pq = build_pq(itf, m=2, ivf=ivf)
    items = [f"i{j}" for j in range(400)]
    w = wrapper_from_numpy(uf, itf, ["a", "b", "c"], items, rank=4,
                           ivf=ivf, pq=pq)
    back = ALSModelWrapper.__new__(ALSModelWrapper)
    back.__setstate__(pickle.loads(pickle.dumps(w.__getstate__())))
    np.testing.assert_array_equal(back.pq.codes, pq.codes)
    back.post_load(RuntimeContext(device=torch.device("cpu")))
    assert back.retriever().plan(1, 10).rung == "ivf_pq"
    answer = ALSAlgorithm().batch_predict(back, [(0, Query(user="a",
                                                           num=5))])
    assert len(answer[0][1].itemScores) == 5
    stale = wrapper_from_numpy(uf, itf * 2.0, ["a", "b", "c"], items,
                               rank=4, ivf=ivf, pq=pq)
    stale.post_load(RuntimeContext(device=torch.device("cpu")))
    r = stale.retriever()
    assert r.ivf_index() is None and r.pq_codebook() is None
    assert r.plan(1, 10).rung == "host"


def test_server_needs_cuda_unless_cpu_is_asked(servers, monkeypatch):
    _, psrv, storage, _ = servers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineServer(psrv.engine, psrv.variant, storage, port=0)
