"""The recommendation template with IVF and PQ: the port vs the JAX package.

With ``PIO_IVF=on`` and small ``PIO_IVF_MIN_ITEMS`` / ``PIO_PQ_MIN_ITEMS``,
the port's ``run_train`` builds an IVF index and PQ codes over its
trained item factors.  Checks, on the CPU:

- ``run_train`` → ``load_models`` → ``EngineServer`` serves a generation
  that carries both structures;
- the structures equal the reference's train-time builds
  (``build_train_index`` with ``require_explicit``, ``build_train_pq``)
  over the port's trained item factors;
- the served answers equal a JAX ``Retriever`` over those factors and
  structures under each quantized routing (ids equal, scores within
  rtol = atol = 1e-5: float32 sums in another order);
- the generation pickles and unpickles with its codes;
- a generation carried in with ``wrapper_from_numpy(ivf=..., pq=...)``
  from the reference's structures serves what the reference serves.
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.retrieval import Retriever as JaxRetriever
from predictionio_tpu.retrieval import build_train_index as jax_build_index
from predictionio_tpu.retrieval import build_train_pq as jax_build_pq
from predictionio_tpu_torch.controller import EngineVariant, RuntimeContext
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, get_storage
from predictionio_tpu_torch.ops import topk as ttopk
from predictionio_tpu_torch.retrieval import IVFIndex, PQCodebook
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    Query,
    engine,
    wrapper_from_numpy,
)
from predictionio_tpu_torch.workflow.core_workflow import (
    load_models,
    run_train,
)

RTOL = 1e-5
ATOL = 1e-5
APP = "torchivfpq"
N_USERS, N_ITEMS, RANK = 60, 400, 8
CPU = torch.device("cpu")
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu_torch.templates.recommendation:engine",
    "datasource": {"params": {"appName": APP}},
    "algorithms": [
        {"name": "als",
         "params": {"rank": RANK, "numIterations": 3, "lambda_": 0.1,
                    "seed": 5}}
    ],
}
_ENV = ("PIO_IVF", "PIO_IVF_MIN_ITEMS", "PIO_IVF_NLIST", "PIO_IVF_NPROBE",
        "PIO_PQ", "PIO_PQ_M", "PIO_PQ_MIN_ITEMS", "PIO_PQ_RERANK",
        "PIO_RETRIEVAL_RUNG", "PIO_SERVE_HOST_MACS", "PIO_CORPUS_DTYPE")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port trained with IVF and PQ on: (storage, server, wrapper).
    The policy's environment is set for the train only."""
    home = tmp_path_factory.mktemp("pio_home")
    with pytest.MonkeyPatch.context() as mp:
        for name in _ENV:
            mp.delenv(name, raising=False)
        mp.setenv("PIO_IVF", "on")
        mp.setenv("PIO_IVF_MIN_ITEMS", "100")
        mp.setenv("PIO_PQ_MIN_ITEMS", "100")
        storage = get_storage(home)
        app_id = storage.get_apps().insert(App(id=None, name=APP))
        events = storage.get_events()
        events.init(app_id)
        rng = np.random.default_rng(9)
        batch = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                       target_entity_type="item", target_entity_id=f"i{i}",
                       properties=DataMap({"rating": float(r)}))
                 for u, i, r in zip(rng.integers(0, N_USERS, 4000),
                                    rng.zipf(1.3, 4000) % N_ITEMS,
                                    rng.integers(1, 11, 4000) * 0.5)]
        batch += [Event(event="buy", entity_type="user",
                        entity_id=f"u{i % N_USERS}",
                        target_entity_type="item", target_entity_id=f"i{i}")
                  for i in range(N_ITEMS)]          # every item trained
        events.insert_batch(batch, app_id)
        variant = EngineVariant.from_dict(VARIANT)
        ctx = RuntimeContext.create(storage=storage, device="cpu")
        iid = run_train(engine(), variant, ctx)
        [wrapper] = load_models(engine(),
                                storage.get_engine_instances().get(iid),
                                RuntimeContext(storage=storage, device=CPU))
    server = EngineServer(engine(), variant, storage, host="127.0.0.1",
                          port=0, device="cpu")
    try:
        yield storage, server, wrapper
    finally:
        server.stop()


def _reference_structures(itf):
    with pytest.MonkeyPatch.context() as mp:
        for name in _ENV:
            mp.delenv(name, raising=False)
        mp.setenv("PIO_IVF", "on")
        mp.setenv("PIO_IVF_MIN_ITEMS", "100")
        mp.setenv("PIO_PQ_MIN_ITEMS", "100")
        ivf = jax_build_index(itf, name="als", seed=5, require_explicit=True)
        pq = jax_build_pq(itf, name="als", ivf=ivf, seed=5)
    return ivf, pq


def _same_fields(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _answers_agree(answers, users, wrapper, jax_r, num):
    uf, _ = wrapper.host_factors()
    q = uf[[wrapper.user_index[u] for u in users]]
    rs, ri, info = jax_r.topk(q, num)
    for row, ans in enumerate(answers):
        hits = ans["itemScores"]
        s = np.array([[h["score"] for h in hits]], np.float32)
        i = np.array([[wrapper.item_index[h["item"]] for h in hits]])
        why = ttopk.topk_mismatch(s, i, rs[row:row + 1, :num],
                                  ri[row:row + 1, :num], rtol=RTOL,
                                  atol=ATOL)
        assert why is None, (users[row], why)
    return info


def test_generation_carries_the_reference_structures(served):
    _, _, wrapper = served
    assert isinstance(wrapper.ivf, IVFIndex)
    assert isinstance(wrapper.pq, PQCodebook)
    _, itf = wrapper.host_factors()
    jivf, jpq = _reference_structures(itf)
    assert jivf is not None and jpq is not None
    _same_fields(wrapper.ivf, jivf)
    _same_fields(wrapper.pq, jpq)


@pytest.mark.parametrize("rung,host_macs", [("auto", None), ("auto", "0"),
                                            ("pq_flat", "0"), ("ivf", "0"),
                                            ("ivf_pq", None)])
def test_served_answers_match_a_jax_retriever(served, monkeypatch, rung,
                                              host_macs):
    _, server, wrapper = served
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
    if host_macs is not None:
        monkeypatch.setenv("PIO_SERVE_HOST_MACS", host_macs)
    _, itf = wrapper.host_factors()
    jivf, jpq = _reference_structures(itf)
    jax_r = JaxRetriever(jnp.asarray(itf), ivf=jivf, pq=jpq, name="als-ref")
    users = [f"u{u}" for u in range(0, N_USERS, 3)]
    answers = server.query_batch([{"user": u, "num": 10} for u in users])
    info = _answers_agree(answers, users, wrapper, jax_r, 10)
    want = {"auto": "ivf_pq"}.get(rung, rung)
    assert info["rung"] == want
    assert wrapper.retriever().plan(len(users), 10).rung == want
    one = server.query_batch([{"user": "u1", "num": 4}])
    _answers_agree(one, ["u1"], wrapper, jax_r, 4)


def test_generation_pickles_with_its_codes(served):
    _, _, wrapper = served
    back = pickle.loads(pickle.dumps(wrapper))
    _same_fields(back.ivf, wrapper.ivf)
    _same_fields(back.pq, wrapper.pq)
    assert back.pq.codes.dtype == np.uint8
    back.post_load(RuntimeContext(device=CPU))
    q = [(0, Query(user="u7", num=6))]
    algo = ALSAlgorithm()
    assert algo.batch_predict(back, q) == algo.batch_predict(wrapper, q)


def test_wrapper_from_numpy_carries_reference_structures(served,
                                                         monkeypatch):
    _, _, wrapper = served
    uf, itf = wrapper.host_factors()
    jivf, jpq = _reference_structures(itf)
    users = list(wrapper.user_index.keys())
    items = list(wrapper.item_index.keys())
    order_u = [wrapper.user_index[u] for u in users]
    order_i = [wrapper.item_index[i] for i in items]
    assert order_u == sorted(order_u) and order_i == sorted(order_i)
    carried = wrapper_from_numpy(uf, itf, users, items, rank=RANK,
                                 ivf=dataclasses.asdict(jivf),
                                 pq=dataclasses.asdict(jpq))
    assert isinstance(carried.ivf, IVFIndex)
    assert isinstance(carried.pq, PQCodebook)
    carried.post_load(RuntimeContext(device=CPU))
    monkeypatch.setenv("PIO_SERVE_HOST_MACS", "0")
    jax_r = JaxRetriever(jnp.asarray(itf), ivf=jivf, pq=jpq, name="als-ref")
    asked = users[:9]
    got = ALSAlgorithm().batch_predict(
        carried, [(n, Query(user=u, num=10)) for n, u in enumerate(asked)])
    answers = [{"itemScores": [{"item": h.item, "score": h.score}
                               for h in r.itemScores]} for _, r in got]
    assert _answers_agree(answers, asked, carried, jax_r, 10)["rung"] \
        == "ivf_pq"
