"""The classification template and its models: the port vs the JAX package.

- naive Bayes (multinomial with Laplace ``alpha``, gaussian): the port's
  log-probabilities within atol 1e-5 of the reference's on the same
  seeded inputs;
- logistic regression: after ``steps`` full-batch Adam steps from zero
  the port's weights and bias within atol 1e-4 (float32 gradients summed
  in another order, through Adam's normalisation; the measured gap is
  under 1e-5), and the labels equal wherever the two highest
  probabilities differ by more than that;
- the Markov chain, the cases of ``tests/test_markov_chain.py`` in both
  packages;
- the template: the same ``$set`` events in both packages' in-memory
  stores (a later label, an ``$unset`` that ``required`` must skip),
  trained from the shipped ``engine.json`` (``naive``, λ 1; the port's
  differs only in ``engineFactory``) and from an ``lr`` variant
  (``maxIter`` 200): the same labels; ``read_eval``'s folds identical;
  ``run_evaluation``'s accuracy equal; the reference's trained models
  carried in through ``model_from_numpy`` give the same labels; a pickle
  round trip.
"""

import dataclasses
import datetime as dt
import json
import os
import pickle
from pathlib import Path

import jax.numpy as jnp
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
from predictionio_tpu.models import linear as jax_lr
from predictionio_tpu.models import markov_chain as jax_mc
from predictionio_tpu.models import naive_bayes as jax_nb
from predictionio_tpu.obs import reset_observability
from predictionio_tpu.templates import classification as jax_cls
from predictionio_tpu.workflow.core_workflow import (
    load_models as jax_load_models,
)
from predictionio_tpu.workflow.core_workflow import (
    run_evaluation as jax_run_evaluation,
)
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant, RuntimeContext
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.models import linear as lr
from predictionio_tpu_torch.models import markov_chain as mc
from predictionio_tpu_torch.models import naive_bayes as nb
from predictionio_tpu_torch.templates import classification as cls
from predictionio_tpu_torch.workflow.core_workflow import (
    load_models,
    run_evaluation,
    run_train,
)

ROOT = Path(__file__).resolve().parents[1]
NB_ATOL = 1e-5
LR_ATOL = 1e-4
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CPU = torch.device("cpu")

SHIPPED = json.loads((ROOT / "examples" / "classification" /
                      "engine.json").read_text())
PORT_SHIPPED = json.loads((ROOT / "predictionio_tpu_torch" / "templates" /
                           "classification" / "engine.json").read_text())
APP = SHIPPED["datasource"]["params"]["appName"]
LR_ALGO = [{"name": "lr", "params": {"maxIter": 200}}]


def _xy(n=400, d=3, c=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.poisson(1.0 + 3.0 * np.eye(c, d)[y]).astype(np.float32)
    return x, y.astype(np.int64)


# -- models ------------------------------------------------------------------

@pytest.mark.parametrize("kind,alpha", [("multinomial", 1.0),
                                        ("multinomial", 0.25),
                                        ("gaussian", None)])
def test_naive_bayes_matches_the_reference(kind, alpha):
    x, y = _xy()
    if kind == "gaussian":
        want_m = jax_nb.train_gaussian(x, y, 4)
        got_m = nb.train_gaussian(x, y, 4, device="cpu")
    else:
        want_m = jax_nb.train_multinomial(x, y, 4, alpha=alpha)
        got_m = nb.train_multinomial(x, y, 4, alpha=alpha, device="cpu")
    xq, _ = _xy(n=64, seed=1)
    want = np.asarray(jax_nb.predict_log_proba(want_m, jnp.asarray(xq)))
    got = nb.predict_log_proba(got_m, torch.from_numpy(xq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NB_ATOL)
    np.testing.assert_allclose(got_m.class_log_prior.numpy(),
                               np.asarray(want_m.class_log_prior),
                               rtol=0, atol=NB_ATOL)


@pytest.mark.parametrize("steps,reg", [(10, 0.0), (200, 0.0), (200, 0.01)])
def test_logistic_regression_matches_the_reference(steps, reg):
    x, y = _xy(n=600)
    want_m = jax_lr.train(x, y, jax_lr.LogisticRegressionConfig(
        n_classes=4, reg=reg, steps=steps, learning_rate=0.1))
    got_m = lr.train(x, y, lr.LogisticRegressionConfig(
        n_classes=4, reg=reg, steps=steps, learning_rate=0.1), device="cpu")
    for name in ("weights", "bias", "mean", "scale"):
        np.testing.assert_allclose(getattr(got_m, name).numpy(),
                                   np.asarray(getattr(want_m, name)),
                                   rtol=0, atol=LR_ATOL)
    want = np.asarray(jax_lr.predict_proba(want_m, jnp.asarray(x)))
    got = lr.predict_proba(got_m, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_ATOL)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > LR_ATOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(1)[clear],
                                  want.argmax(1)[clear])


def test_logistic_regression_refuses_a_mesh():
    """A mesh that spans processes in another layout than the gang's
    (the processes splitting ``data`` in order) is refused; one
    process's mesh trains (tests/test_torch_mesh_cli.py), and so does a
    gang's (tests/test_torch_gang_models.py)."""
    from predictionio_tpu_torch.parallel.mesh import Mesh

    two = Mesh(np.array([CPU, CPU], dtype=object), ("data",),
               np.array([1, 0]))
    x, y = _xy(n=10)
    with pytest.raises(ValueError, match="first axis"):
        lr.train(x, y, lr.LogisticRegressionConfig(n_classes=4),
                 mesh=two, device="cpu")


MARKOV_CASES = {
    # 0→1 twice, 0→2 once, 1→0 always; state 2 unseen
    "transition": (([0, 0, 0, 1, 1], [1, 1, 2, 0, 0], 3, 0.0),
                   [[0, 2 / 3, 1 / 3], [1, 0, 0], [0, 0, 0]]),
    "smoothing": (([0], [1], 2, 1.0), [[1 / 3, 2 / 3], [0.5, 0.5]]),
    "random": ((list(np.random.default_rng(2).integers(0, 6, 300)),
                list(np.random.default_rng(3).integers(0, 6, 300)), 6, 0.5),
               None),
}


@pytest.mark.parametrize("case", sorted(MARKOV_CASES))
def test_markov_chain_transitions(case):
    (prev, nxt, s, smoothing), expected = MARKOV_CASES[case]
    got = mc.train_markov_chain(np.array(prev), np.array(nxt), s,
                                smoothing=smoothing, device="cpu")
    want = jax_mc.train_markov_chain(np.array(prev), np.array(nxt), s,
                                     smoothing=smoothing)
    np.testing.assert_allclose(got.transition.numpy(),
                               np.asarray(want.transition), rtol=1e-6,
                               atol=1e-9)
    if expected is not None:
        np.testing.assert_allclose(got.transition.numpy(), expected,
                                   rtol=1e-6, atol=1e-9)
    assert got.n_states == s


@pytest.mark.parametrize("k", [1, 2, 3])
def test_markov_chain_predict_next(k):
    """Top-k next states, tied states lowest id first in both."""
    prev = np.array([0] * 10 + [1] * 4)
    nxt = np.array([2] * 7 + [1] * 3 + [0, 0, 2, 2])
    got_p, got_i = mc.predict_next(
        mc.train_markov_chain(prev, nxt, 3, device="cpu"), [0, 1, 2], k)
    want_p, want_i = jax_mc.predict_next(
        jax_mc.train_markov_chain(prev, nxt, 3), jnp.asarray([0, 1, 2]), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6)
    assert list(got_i[0].numpy()) == [2, 1, 0][:k]
    np.testing.assert_allclose(got_p[0].numpy(), [0.7, 0.3, 0.0][:k],
                               rtol=1e-6)


# -- the template ------------------------------------------------------------

def _specs(n=150, seed=4):
    """$set of attr0..attr2 counts and a 4-class plan per user, then a
    later plan for u0 and an $unset of u1's plan."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        label = i % 4
        attrs = rng.poisson(1.0 + 4.0 * np.eye(4, 3)[label])
        specs.append(("$set", f"u{i}", {
            "attr0": float(attrs[0]), "attr1": float(attrs[1]),
            "attr2": float(attrs[2]), "plan": float(label)}))
    specs.append(("$set", "u0", {"plan": 3.0}))
    specs.append(("$unset", "u1", {"plan": None}))
    specs.append(("$set", "u_partial", {"attr0": 1.0, "plan": 1.0}))
    return specs


def _insert(storage, app_cls, event_cls, datamap_cls, specs):
    app_id = storage.get_apps().insert(app_cls(id=None, name=APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        event_cls(event=e, entity_type="user", entity_id=eid,
                  properties=datamap_cls(p),
                  event_time=T0 + dt.timedelta(seconds=n))
        for n, (e, eid, p) in enumerate(specs)], app_id)


def _variant(spec, algorithms=None):
    return {**spec, "algorithms": algorithms or spec["algorithms"]}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(reference ctx, port ctx) over the same events."""
    home = tmp_path_factory.mktemp("pio_home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_EVAL_")):
                mp.delenv(k, raising=False)
        mp.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
        mp.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
        reset_storage()
        reset_observability()
        jctx = JaxContext.create(storage=jax_storage())
        _insert(jctx.storage, JaxApp, JaxEvent, JaxDataMap, _specs())
        storage = Storage(memory_config(home / "port"))
        _insert(storage, App, Event, DataMap, _specs())
        try:
            yield jctx, RuntimeContext.create(storage=storage, device="cpu")
        finally:
            reset_storage()
            reset_observability()


def _queries(n=48, seed=6):
    rng = np.random.default_rng(seed)
    return [{f"attr{j}": float(v) for j, v in
             enumerate(rng.integers(0, 7, 3))} for _ in range(n)]


def test_shipped_engine_json_differs_only_in_the_factory():
    assert {**PORT_SHIPPED, "engineFactory": SHIPPED["engineFactory"]} \
        == SHIPPED
    assert PORT_SHIPPED["engineFactory"] == \
        "predictionio_tpu_torch.templates.classification:engine"


def test_datasource_and_folds_match_the_reference(stores):
    jctx, ctx = stores
    p = dict(appName=APP, evalK=3)
    want = jax_cls.ClassificationDataSource(
        jax_cls.DataSourceParams(**p)).read_training(jctx)
    got = cls.ClassificationDataSource(
        cls.DataSourceParams(**p)).read_training(ctx)
    for name in ("x", "y", "classes"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert len(got.y) == 149              # u1's plan is unset
    assert got.attrs == want.attrs
    want_f = jax_cls.ClassificationDataSource(
        jax_cls.DataSourceParams(**p)).read_eval(jctx)
    got_f = cls.ClassificationDataSource(
        cls.DataSourceParams(**p)).read_eval(ctx)
    assert len(got_f) == len(want_f) == 3
    for (gtd, _, gqa), (wtd, _, wqa) in zip(got_f, want_f):
        np.testing.assert_array_equal(gtd.x, wtd.x)
        np.testing.assert_array_equal(gtd.y, wtd.y)
        assert [(dataclasses.asdict(q), a) for q, a in gqa] == \
            [(dataclasses.asdict(q), a) for q, a in wqa]


def _labels(algo, model, queries, query_cls):
    single = [algo.predict(model, query_cls(**q)).label for q in queries]
    batch = [r.label for _, r in algo.batch_predict(
        model, [(i, query_cls(**q)) for i, q in enumerate(queries)])]
    assert single == batch
    return single


@pytest.mark.parametrize("algo", ["naive", "lr"])
def test_trained_and_carried_models_match_the_reference(stores, algo):
    jctx, ctx = stores
    algorithms = None if algo == "naive" else LR_ALGO
    jvariant = _variant(SHIPPED, algorithms)
    variant = _variant(PORT_SHIPPED, algorithms)
    jeng, eng = jax_cls.engine(), cls.engine()
    jiid = jax_run_train(jeng, JaxVariant.from_dict(jvariant), jctx)
    iid = run_train(eng, EngineVariant.from_dict(variant), ctx)
    [jmodel] = jax_load_models(
        jeng, jctx.storage.get_engine_instances().get(jiid), jctx)
    [model] = load_models(eng, ctx.storage.get_engine_instances().get(iid),
                          RuntimeContext(storage=ctx.storage, device=CPU))
    jalgo = jeng.make_algorithms(jeng.bind_engine_params(jvariant))[0]
    palgo = eng.make_algorithms(eng.bind_engine_params(variant))[0]
    queries = _queries()
    want = _labels(jalgo, jmodel, queries, jax_cls.Query)
    assert _labels(palgo, model, queries, cls.Query) == want
    assert len(set(want)) > 1
    fields = {f.name: np.asarray(getattr(jmodel.model, f.name))
              for f in dataclasses.fields(jmodel.model)
              if getattr(jmodel.model, f.name) is not None}
    carried = cls.model_from_numpy(fields, jmodel.classes, jmodel.attrs,
                                   device="cpu")
    assert type(carried) is type(model)
    assert _labels(palgo, carried, queries, cls.Query) == want
    back = pickle.loads(pickle.dumps(model))
    assert _labels(palgo, back, queries, cls.Query) == want


def test_eval_accuracy_matches_the_reference(stores):
    jctx, ctx = stores
    _, want = jax_run_evaluation(
        jax_cls.evaluation(),
        jax_cls.default_params_generator(app_name=APP, eval_k=3), jctx)
    _, got = run_evaluation(
        cls.evaluation(), cls.default_params_generator(app_name=APP,
                                                        eval_k=3), ctx)
    assert got.best_index == want.best_index
    assert got.best_score == want.best_score
    assert [s for _, s, _ in got.candidate_scores] == \
        [s for _, s, _ in want.candidate_scores]
