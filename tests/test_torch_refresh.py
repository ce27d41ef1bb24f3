"""The port's refresh loop against the reference's, on the CPU: ALS delta
warm start, ``run_train(warm_from=...)``, the refresh daemon and
``pio train --follow``.

- ``_warm_ridge_sweep`` and ``ALSAlgorithm.warm_start``, given the same
  previous factors and the same delta, give the reference's warm factors
  and union ``BiMap``s exactly (``np.array_equal``: the same float64 host
  solves in the same order, the same seeded draws); every gate declines
  with the reference's reason (config change, oversized delta, eval
  regression, unsized carry); an empty delta carries forward as a fresh
  wrapper.
- ``run_train`` through both packages on MEMORY storage: the
  reference's generation 1 carried into the port with
  ``wrapper_from_numpy``, the same delta events in both stores — the env
  keys, the warm factors (identical), the served answers (ids equal
  except within ties, scores atol 1e-4 + rtol 1e-3), windows that chain
  with no gap and no overlap, ``full_fallback`` in the same instance, an
  all-declining engine that declines before its read, ``PREEMPTED``.
- ``RefreshDaemon`` in both packages with a fake clock, sleep, promoter
  and opener: a cycle, a failed cycle, follow pacing, trigger firing,
  staleness from the served (not the trained) watermark after a
  rollback, the canary-rollback branch — equal summaries, counters and
  request sequences.
- ``pio train --follow --device cpu`` runs a cycle in a process of its
  own and exits 0 on SIGTERM; with several ``--promote-url`` servers the
  cycle rolls out across them through ``FleetPromoter`` (the reference's
  choice of promoter is checked beside it).
"""

import dataclasses
import datetime as dt
import importlib
import io
import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from urllib.error import HTTPError

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.refresh as ref_refresh
import predictionio_tpu.refresh.daemon as ref_daemon
import predictionio_tpu.workflow.core_workflow as ref_wf
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.refresh as port_refresh
import predictionio_tpu_torch.refresh.daemon as port_daemon
import predictionio_tpu_torch.workflow.core_workflow as port_wf
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import WarmStartFallback as JaxFallback
from predictionio_tpu.data.event import BiMap as JaxBiMap
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.resilience.supervision import (
    TrainPreempted as JaxPreempted,
)
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxEngineServer,
)
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineVariant,
    RuntimeContext,
    WarmStartFallback,
)
from predictionio_tpu_torch.data.event import BiMap, DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.resilience.supervision import TrainPreempted
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.recommendation import (
    engine,
    wrapper_from_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
REF_TPL = importlib.import_module(
    "predictionio_tpu.templates.recommendation.engine")
PORT_TPL = importlib.import_module(
    "predictionio_tpu_torch.templates.recommendation.engine")
UTC = dt.timezone.utc
APP = "refreshparity"
N_USERS, N_ITEMS, RANK = 16, 10, 4
RTOL, ATOL = 1e-3, 1e-4
PARAMS = {"rank": RANK, "numIterations": 10, "lambda_": 0.05, "seed": 3}
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": APP}},
    "algorithms": [{"name": "als", "params": PARAMS}],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}
_ENV = ("PIO_FAULTS", "PIO_RESULT_CACHE", "PIO_RETRIEVAL_RUNG", "PIO_IVF",
        "PIO_PQ", "PIO_CANARY_QUERIES", "PIO_RETAIN_PREVIOUS")


# -- the ridge sweep and warm_start, given the same inputs ---------------------

def _factors(seed, n, k=RANK):
    return (np.random.default_rng(seed).standard_normal((n, k))
            .astype(np.float32) / np.float32(np.sqrt(k)))


def _delta(seed, n, new_users=0, new_items=0):
    """(users, items, ratings) of a delta, ids as strings."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS + new_users, n)
    i = rng.integers(0, N_ITEMS + new_items, n)
    r = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    return [f"u{x}" for x in u], [f"i{x}" for x in i], r


def _ratings(tpl, bimap, delta):
    us, its, r = delta
    ui, ii = bimap.string_int(us), bimap.string_int(its)
    return tpl.Ratings(user_ids=np.array([ui[x] for x in us], np.int64),
                       item_ids=np.array([ii[x] for x in its], np.int64),
                       ratings=r, user_index=ui, item_index=ii,
                       app_name=APP, event_names=("rate", "buy"))


def _prev(uf, itf, n_examples=400, implicit=False):
    """The same previous generation in both packages."""
    users = [f"u{j}" for j in range(uf.shape[0])]
    items = [f"i{j}" for j in range(itf.shape[0])]
    ref = REF_TPL.ALSModelWrapper(
        model=jax_als.ALSModel(user_factors=jnp.asarray(uf),
                               item_factors=jnp.asarray(itf), rank=RANK,
                               implicit=implicit),
        user_index=JaxBiMap({u: j for j, u in enumerate(users)}),
        item_index=JaxBiMap({t: j for j, t in enumerate(items)}),
        app_name=APP, n_examples=n_examples, reg=0.05, alpha=1.0)
    port = wrapper_from_numpy(uf, itf, users, items, rank=RANK,
                              implicit=implicit)
    port.app_name, port.n_examples, port.reg = APP, n_examples, 0.05
    return ref, port


def _warm(pkg, prev, delta, implicit=False, params=None, **warm_kw):
    """warm_start in one package → (factors, user map, item map,
    n_examples) or the fallback's reason."""
    tpl, bimap, ctx, ctx_cls = (
        (REF_TPL, JaxBiMap, JaxContext(storage=None), ref_refresh)
        if pkg == "ref" else
        (PORT_TPL, BiMap, RuntimeContext(storage=None), port_refresh))
    p = {**PARAMS, "implicitPrefs": implicit, **(params or {})}
    algo = tpl.ALSAlgorithm(tpl.ALSAlgorithmParams(**p))
    warm = ctx_cls.WarmStartContext(instance=None, models=[prev],
                                    start_time=None, **warm_kw)
    try:
        w = algo.warm_start(ctx, _ratings(tpl, bimap, delta), prev, warm)
    except (JaxFallback, WarmStartFallback) as e:
        return e.reason
    uf, itf = (np.asarray(x) for x in w.host_factors())
    return (uf, itf, list(w.user_index.items()), list(w.item_index.items()),
            w.n_examples, w)


@pytest.mark.parametrize("implicit", [False, True])
def test_warm_ridge_sweep_is_the_reference(implicit):
    rng = np.random.default_rng(5)
    target, frozen = _factors(1, 12, 6), _factors(2, 9, 6)
    rows = rng.integers(0, 12, 80)
    cols = rng.integers(0, 9, 80)
    vals = rng.integers(-2, 11, 80) * 0.5
    got, want = target.copy(), target.copy()
    kw = dict(reg=0.05, alpha=2.0, implicit=implicit)
    PORT_TPL._warm_ridge_sweep(got, frozen, rows, cols, vals, **kw)
    REF_TPL._warm_ridge_sweep(want, frozen, rows, cols, vals, **kw)
    np.testing.assert_array_equal(got, want)
    untouched = np.setdiff1d(np.arange(12), rows)
    np.testing.assert_array_equal(got[untouched], target[untouched])


@pytest.mark.parametrize("case", [
    dict(n=60),
    dict(n=60, new_users=5, new_items=3),
    dict(n=40, new_users=4, implicit=True),
    dict(n=25, new_users=8, new_items=6, seed=9),
], ids=["known", "new-entities", "implicit", "sparse"])
def test_warm_start_gives_the_reference_factors(case):
    implicit = case.get("implicit", False)
    uf, itf = _factors(1, N_USERS), _factors(2, N_ITEMS)
    ref_prev, port_prev = _prev(uf, itf, implicit=implicit)
    delta = _delta(case.get("seed", 4), case["n"], case.get("new_users", 0),
                   case.get("new_items", 0))
    want = _warm("ref", ref_prev, delta, implicit)
    got = _warm("port", port_prev, delta, implicit)
    assert not isinstance(want, str), want
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:5] == want[2:5]
    assert got[4] == 400 + case["n"]
    # the carried rows keep their ids; new ones append
    assert got[2][:N_USERS] == list(port_prev.user_index.items())
    assert got[5].app_name == APP and got[5].reg == 0.05


@pytest.mark.parametrize("gate", ["rank", "lambda", "implicit", "oversized",
                                  "eval-regression", "unsized-carry"])
def test_every_gate_declines_with_the_reference_reason(gate):
    uf, itf = _factors(1, N_USERS), _factors(2, N_ITEMS)
    n_prev = 0 if gate == "unsized-carry" else 400
    ref_prev, port_prev = _prev(uf, itf, n_examples=n_prev)
    delta = _delta(4, 60)
    params = {"rank": {"rank": RANK + 2}, "lambda": {"lambda_": 0.5},
              "implicit": {"implicitPrefs": True}}.get(gate)
    warm_kw = {"oversized": {"max_delta_fraction": 0.1},
               "eval-regression": {"eval_tolerance": -1.0}}.get(gate, {})
    implicit = gate == "implicit"
    want = _warm("ref", ref_prev, delta, params=params, **warm_kw) \
        if not implicit else _warm("ref", ref_prev, delta, True)
    got = _warm("port", port_prev, delta, params=params, **warm_kw) \
        if not implicit else _warm("port", port_prev, delta, True)
    assert isinstance(want, str) and got == want
    fragment = {"rank": "config changed", "lambda": "config changed",
                "implicit": "config changed", "oversized": "too large",
                "eval-regression": "regressed",
                "unsized-carry": "vs 0 trained"}[gate]
    assert fragment in got


def test_an_empty_delta_carries_forward_as_a_fresh_wrapper():
    uf, itf = _factors(1, N_USERS), _factors(2, N_ITEMS)
    _, port_prev = _prev(uf, itf)
    got = _warm("port", port_prev, ([], [], np.zeros(0, np.float32)))
    w = got[5]
    assert w is not port_prev
    np.testing.assert_array_equal(got[0], uf)
    np.testing.assert_array_equal(got[1], itf)
    assert got[4] == 400
    # a fresh generation: no serving state is shared with the previous
    assert w._fold_cache is not port_prev._fold_cache


# -- run_train through both packages ------------------------------------------

def _rate(pkg_event, datamap, u, i, r, when):
    return pkg_event(event="rate", entity_type="user", entity_id=u,
                     target_entity_type="item", target_entity_id=i,
                     properties=datamap({"rating": float(r)}),
                     event_time=when)


def _gen1_events():
    rng = np.random.default_rng(0)
    t0 = dt.datetime.now(UTC) - dt.timedelta(days=1)
    return [(f"u{u}", f"i{i}", 3 + 2 * rng.random(),
             t0 + dt.timedelta(seconds=n))
            for n, (u, i) in enumerate(
                (u, i) for u in range(N_USERS) for i in range(N_ITEMS)
                if (i + u) % 3 == 0)]


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    """The reference's generation 1 trained on its MEMORY store, and the
    port's store holding the same events with that generation carried in
    (same factors, same watermark)."""
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_REFRESH_")) or k in _ENV:
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    reset_storage()
    ref_obs.reset_observability()
    port_obs.get_registry().reset()
    events = _gen1_events()
    jctx = JaxContext.create(storage=jax_storage())
    japp = jctx.storage.get_apps().insert(JaxApp(id=None, name=APP))
    jctx.storage.get_events().init(japp)
    jctx.storage.get_events().insert_batch(
        [_rate(JaxEvent, JaxDataMap, *e) for e in events], japp)
    jeng, jvariant = jax_engine(), JaxVariant.from_dict(VARIANT)
    jid = ref_wf.run_train(jeng, jvariant, jctx)
    jinst = jctx.storage.get_engine_instances().get(jid)
    [jw] = ref_wf.load_models(jeng, jinst, jctx)

    storage = Storage(memory_config(tmp_path / "port"))
    papp = storage.get_apps().insert(App(id=None, name=APP))
    storage.get_events().init(papp)
    storage.get_events().insert_batch(
        [_rate(Event, DataMap, *e) for e in events], papp)
    uf, itf = (np.asarray(jax.device_get(x)) for x in jw.host_factors())
    pw = wrapper_from_numpy(uf, itf, list(jw.user_index.keys()),
                            list(jw.item_index.keys()), rank=RANK)
    pw.app_name, pw.fold_event_names = jw.app_name, tuple(
        jw.fold_event_names)
    pw.buy_rating, pw.reg, pw.alpha = jw.buy_rating, jw.reg, jw.alpha
    pw.n_examples = jw.n_examples
    eng, variant = engine(), EngineVariant.from_dict(PORT_VARIANT)
    pid = port_wf.persist_instance(eng, variant, [pw], storage)
    pinst = storage.get_engine_instances().get(pid)
    pinst.env = {port_wf.DATA_WATERMARK_KEY:
                 jinst.env[ref_wf.DATA_WATERMARK_KEY]}
    storage.get_engine_instances().update(pinst)
    pctx = RuntimeContext.create(storage=storage, device="cpu")
    yield SimpleNamespace(
        ref=SimpleNamespace(ctx=jctx, app=japp, eng=jeng, variant=jvariant,
                            inst=jinst, wf=ref_wf, refresh=ref_refresh,
                            event=JaxEvent, datamap=JaxDataMap),
        port=SimpleNamespace(ctx=pctx, app=papp, eng=eng, variant=variant,
                             inst=pinst, wf=port_wf, refresh=port_refresh,
                             event=Event, datamap=DataMap))
    reset_storage()


def _insert_delta(side, rows, after):
    """Delta events stamped microseconds after ``after`` (a watermark):
    inside the next run's window."""
    side.ctx.storage.get_events().insert_batch([
        _rate(side.event, side.datamap, u, i, r,
              after + dt.timedelta(microseconds=n + 1))
        for n, (u, i, r) in enumerate(rows)], side.app)


DELTA = [("u0", "i1", 5.0), ("u0", "i4", 4.5), ("u3", "i2", 1.0),
         ("u7", "i7", 5.0), ("u_new", "i0", 4.0), ("u_new", "i_new", 5.0),
         ("u5", "i_new", 3.5)]


def _warm_run(side, inst, **kw):
    warm = side.refresh.WarmStartContext(
        instance=inst, models=side.wf.load_models(side.eng, inst, side.ctx),
        start_time=side.wf.data_watermark(inst), **kw)
    iid = side.wf.run_train(side.eng, side.variant, side.ctx, warm_from=warm)
    return side.ctx.storage.get_engine_instances().get(iid)


def test_warm_run_train_matches_the_reference(pair):
    wm1 = pair.ref.wf.data_watermark(pair.ref.inst)
    out = {}
    for name in ("ref", "port"):
        side = getattr(pair, name)
        _insert_delta(side, DELTA, wm1)
        inst2 = _warm_run(side, side.inst)
        assert inst2.status == "COMPLETED"
        assert inst2.env["refreshMode"] == "warm"
        assert inst2.env["warmStartFrom"] == side.inst.id
        assert side.wf.data_watermark(inst2) > wm1
        [w2] = side.wf.load_models(side.eng, inst2, side.ctx)
        out[name] = (w2, sorted(inst2.env))
    (jw, jkeys), (pw, pkeys) = out["ref"], out["port"]
    assert pkeys == jkeys
    juf, jitf = (np.asarray(jax.device_get(x)) for x in jw.host_factors())
    puf, pitf = pw.host_factors()
    np.testing.assert_array_equal(puf, juf)
    np.testing.assert_array_equal(pitf, jitf)
    assert list(pw.user_index.items()) == list(jw.user_index.items())
    assert list(pw.item_index.items()) == list(jw.item_index.items())
    assert pw.n_examples == jw.n_examples == len(_gen1_events()) + len(DELTA)
    # the served answers of the warm generation
    jsrv = JaxEngineServer(pair.ref.eng, pair.ref.variant,
                           pair.ref.ctx.storage, host="127.0.0.1", port=0)
    psrv = EngineServer(pair.port.eng, pair.port.variant,
                        pair.port.ctx.storage, host="127.0.0.1", port=0,
                        device="cpu")
    try:
        queries = [{"user": u, "num": 5} for u in
                   ("u0", "u3", "u5", "u7", "u_new", "u11")]
        for q, g, w in zip(queries, psrv.query_batch(queries),
                           jsrv.query_batch(queries)):
            gi = [h["item"] for h in g["itemScores"]]
            wi = [h["item"] for h in w["itemScores"]]
            gs = np.array([h["score"] for h in g["itemScores"]])
            ws = np.array([h["score"] for h in w["itemScores"]])
            np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
            if gi != wi:   # only a tie may reorder
                for a, b, s in zip(gi, wi, ws):
                    assert a == b or np.sum(np.isclose(ws, s, rtol=RTOL,
                                                       atol=ATOL)) > 1, q
    finally:
        jsrv.stop()
        psrv.stop()


def test_warm_windows_chain_without_gap_or_overlap(pair):
    side = pair.port
    wm1 = side.wf.data_watermark(side.inst)
    _insert_delta(side, DELTA, wm1)
    inst2 = _warm_run(side, side.inst)
    wm2 = side.wf.data_watermark(inst2)
    delta2 = [("u1", "i5", 2.0), ("u2", "i8", 4.0), ("u9", "i3", 3.0)]
    _insert_delta(side, delta2, wm2)
    inst3 = _warm_run(side, inst2)
    assert inst3.env["refreshMode"] == "warm"
    [w2] = side.wf.load_models(side.eng, inst2, side.ctx)
    [w3] = side.wf.load_models(side.eng, inst3, side.ctx)
    # the third run read exactly the second delta: no event of the first
    # (overlap) and none missed (gap)
    assert w3.n_examples == w2.n_examples + len(delta2)
    uf2, _ = w2.host_factors()
    uf3, _ = w3.host_factors()
    moved = [r for r in range(uf2.shape[0])
             if not np.array_equal(uf2[r], uf3[r])]
    assert sorted(moved) == sorted(w2.user_index[u] for u, _, _ in delta2)


@pytest.mark.parametrize("why", ["oversized", "rank"])
def test_fallback_retrains_in_the_same_instance(pair, why):
    wm1 = pair.ref.wf.data_watermark(pair.ref.inst)
    modes = {}
    for name in ("ref", "port"):
        side = getattr(pair, name)
        _insert_delta(side, DELTA, wm1)
        before = len(side.ctx.storage.get_engine_instances().get_all())
        kw = {"max_delta_fraction": 0.0} if why == "oversized" else {}
        if why == "rank":
            raw = json.loads(json.dumps(side.variant.raw))
            raw["algorithms"][0]["params"]["rank"] = RANK + 2
            side.variant = type(side.variant).from_dict(raw)
        inst2 = _warm_run(side, side.inst, **kw)
        after = side.ctx.storage.get_engine_instances().get_all()
        assert len(after) == before + 1
        [w2] = side.wf.load_models(side.eng, inst2, side.ctx)
        modes[name] = (inst2.status, inst2.env["refreshMode"],
                       w2.n_examples, w2.model.rank)
    assert modes["port"] == modes["ref"]
    assert modes["port"][:2] == ("COMPLETED", "full_fallback")
    assert modes["port"][2] == len(_gen1_events()) + len(DELTA)


class _CountingSource(DataSource):
    reads = 0

    def read_training(self, ctx):
        type(self).reads += 1
        return "td"


class _PlainAlgo(Algorithm):
    def train(self, ctx, pd):
        return {"trained": pd}

    def predict(self, model, query):
        return None


class _PreemptedAlgo(_PlainAlgo):
    def train(self, ctx, pd):
        raise TrainPreempted("toy", 4, False)


def test_a_declining_engine_declines_before_its_read(tmp_path):
    """No algorithm overrides warm_start: the warm attempt declines with
    the reference's reason before the datasource reads, then the full
    retrain reads once."""
    storage = Storage(memory_config(tmp_path))
    eng = Engine(datasource_class=_CountingSource,
                 algorithm_classes={"a": _PlainAlgo})
    variant = EngineVariant.from_dict({"engineFactory": "toy",
                                       "algorithms": [{"name": "a"}]})
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    params = eng.bind_engine_params(variant.raw)
    warm = port_refresh.WarmStartContext(
        instance=None, models=[{"trained": "old"}],
        start_time=dt.datetime.now(UTC))
    _CountingSource.reads = 0
    with pytest.raises(WarmStartFallback) as e:
        eng.train(ctx, params, warm=warm)
    assert e.value.reason == ("no configured algorithm supports warm-start "
                              "continuation")
    assert _CountingSource.reads == 0
    two = dataclasses.replace(warm, models=[1, 2])
    with pytest.raises(WarmStartFallback, match=r"algorithm set changed "
                       r"\(2 previous model\(s\) vs 1 configured\)"):
        eng.train(ctx, params, warm=two)
    iid = port_wf.run_train(eng, variant, ctx, warm_from=warm)
    inst = storage.get_engine_instances().get(iid)
    assert inst.env["refreshMode"] == "full_fallback"
    assert _CountingSource.reads == 1


def test_the_reference_declines_an_all_default_engine_the_same_way():
    from predictionio_tpu.controller import Engine as JaxEngine
    from predictionio_tpu.controller.base import Algorithm as JaxAlgorithm
    from predictionio_tpu.controller.base import DataSource as JaxSource

    reads = []

    class Source(JaxSource):
        def read_training(self, ctx):
            reads.append(1)

    class Algo(JaxAlgorithm):
        def train(self, ctx, pd):
            return None

        def predict(self, model, query):
            return None

    eng = JaxEngine(datasource_class=Source, algorithm_classes={"a": Algo})
    params = eng.bind_engine_params({"algorithms": [{"name": "a"}]})
    warm = SimpleNamespace(models=[None])
    with pytest.raises(JaxFallback) as e:
        eng.train(None, params, warm=warm)
    port_eng = Engine(datasource_class=_CountingSource,
                      algorithm_classes={"a": _PlainAlgo})
    with pytest.raises(WarmStartFallback) as p:
        port_eng.train(None, port_eng.bind_engine_params(
            {"algorithms": [{"name": "a"}]}), warm=warm)
    assert p.value.reason == e.value.reason and reads == []


def test_a_preempted_train_lands_as_preempted(tmp_path):
    storage = Storage(memory_config(tmp_path))
    eng = Engine(datasource_class=_CountingSource,
                 algorithm_classes={"a": _PreemptedAlgo})
    variant = EngineVariant.from_dict({"engineFactory": "toy",
                                       "algorithms": [{"name": "a"}]})
    ctx = RuntimeContext.create(storage=storage, device="cpu")
    with pytest.raises(TrainPreempted):
        port_wf.run_train(eng, variant, ctx)
    [inst] = storage.get_engine_instances().get_all()
    assert inst.status == "PREEMPTED"
    assert str(TrainPreempted("toy", 4, False)) == \
        str(JaxPreempted("toy", 4, False))


# -- config, staleness, metrics ------------------------------------------------

@pytest.mark.parametrize("env", [
    {},
    {"PIO_REFRESH_INTERVAL_S": "12.5", "PIO_REFRESH_MAX_DELTA_FRACTION":
     "0.2", "PIO_REFRESH_EVAL_TOLERANCE": "0.3"},
    {"PIO_REFRESH_PROMOTE_URL": "http://x:1", "PIO_REFRESH_CANARY_WINDOW_S":
     "0", "PIO_REFRESH_CANARY_POLL_S": "0.5"},
    {"PIO_REFRESH_TRIGGER_STALENESS_S": "30",
     "PIO_REFRESH_TRIGGER_DELTA_COUNT": "500",
     "PIO_REFRESH_TRIGGER_POLL_S": "1"},
    {"PIO_REFRESH_INTERVAL_S": "junk", "PIO_REFRESH_TRIGGER_DELTA_COUNT":
     "", "PIO_REFRESH_PROMOTE_URL": ""},
], ids=["defaults", "gates", "promotion", "trigger", "malformed"])
def test_refresh_config_from_env_as_the_reference(env, monkeypatch):
    for k in list(os.environ):
        if k.startswith("PIO_REFRESH_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    over = dict(interval_s=7.0, canary_window_s=None)
    assert dataclasses.asdict(port_refresh.RefreshConfig.from_env(**over)) \
        == dataclasses.asdict(ref_refresh.RefreshConfig.from_env(**over))


@pytest.mark.parametrize("latest,served,want", [
    (None, 0, None), (0, None, None), (0, 5, 0.0), (5, 0, 5.0),
    (0.25, 0, 0.25)])
def test_staleness_as_the_reference(latest, served, want):
    t = dt.datetime(2026, 3, 1, tzinfo=UTC)

    def at(s):
        return None if s is None else t + dt.timedelta(seconds=s)

    assert port_refresh.staleness_s(at(latest), at(served)) == want == \
        ref_refresh.staleness_s(at(latest), at(served))


def test_refresh_metrics_register_the_reference_names():
    names = {}
    for pkg, obs in ((ref_refresh, ref_obs), (port_refresh, port_obs)):
        reg = obs.metrics.MetricsRegistry()
        m = pkg.RefreshMetrics(reg)
        names[pkg.__name__] = sorted(
            (getattr(m, a).name, tuple(getattr(m, a).labelnames))
            for a in vars(m))
    assert len(set(map(tuple, names.values()))) == 1


# -- the daemon ---------------------------------------------------------------

class _FakePromoter:
    canary_window_s = 1.0

    def __init__(self, wf, storage, verdict="promoted", served=None):
        self.promoted, self.watched = [], 0
        self.verdict, self.wf, self.storage = verdict, wf, storage
        self.served = served

    def promote(self, instance_id):
        self.promoted.append(instance_id)
        return {"engineInstanceId": instance_id}

    def canary_watch(self):
        self.watched += 1
        return self.verdict

    def served_watermark(self):
        if self.served is not None:
            return self.served
        if not self.promoted:
            return None
        inst = self.storage.get_engine_instances().get(self.promoted[-1])
        return self.wf.data_watermark(inst) if inst else None


def _daemon(pkg, side, **kw):
    mod = ref_daemon if pkg == "ref" else port_daemon
    cfg = (ref_refresh if pkg == "ref" else port_refresh).RefreshConfig(
        interval_s=kw.pop("interval_s", 60.0), **kw.pop("cfg", {}))
    return mod.RefreshDaemon(side.eng, side.variant, side.ctx, config=cfg,
                             clock=lambda: 100.0, **kw)


def _counters(reg):
    out = {}
    for name in ("pio_refresh_runs_total", "pio_refresh_promotions_total",
                 "pio_refresh_triggers_total"):
        m = reg.get(name)
        out[name] = {} if m is None else dict(m.series())
    g = reg.get("pio_refresh_staleness_s")
    out["staleness"] = None if g is None else g.value()
    return out


def test_daemon_cycles_as_the_reference(pair):
    """Cycle 1 continues the carried generation (warm), cycle 2 after a
    delta (warm), cycle 3 with nothing new (warm, an empty delta)."""
    wm1 = pair.ref.wf.data_watermark(pair.ref.inst)
    runs = {}
    for name in ("ref", "port"):
        side = getattr(pair, name)
        promoter = _FakePromoter(side.wf, side.ctx.storage)
        d = _daemon(name, side, promoter=promoter)
        _insert_delta(side, DELTA, wm1)
        outs = [d.run_once()]
        inst = side.ctx.storage.get_engine_instances().get(
            outs[0]["instance"])
        _insert_delta(side, [("u2", "i5", 1.5)], side.wf.data_watermark(inst))
        outs.append(d.run_once())
        outs.append(d.run_once())
        ids = [o.pop("instance") for o in outs]
        assert promoter.promoted == ids and promoter.watched == 3
        runs[name] = (outs, _counters(
            (ref_obs if name == "ref" else port_obs).get_registry()))
    assert runs["port"] == runs["ref"]
    outs, counters = runs["port"]
    assert [o["result"] for o in outs] == ["warm"] * 3
    assert all(o["trainS"] == 0.0 and o["promotion"] == "promoted"
               for o in outs)
    assert counters["staleness"] == 0.0


def test_a_cycle_traces_as_the_reference(pair):
    """One cycle whose warm start falls back (a delta too large for the
    warm gate), in each package: the ``refresh.cycle`` trees — the
    nested ``workflow.train`` with its DASE phases, the
    ``refresh.warm_fallback`` event — and the cycle's summary event are
    equal once durations and ids are masked."""
    from tests.test_torch_traces import mask

    wm1 = pair.ref.wf.data_watermark(pair.ref.inst)
    got = {}
    for name, obs in (("ref", ref_obs), ("port", port_obs)):
        side = getattr(pair, name)
        obs.get_recorder().clear()
        d = _daemon(name, side, promoter=_FakePromoter(side.wf,
                                                       side.ctx.storage),
                    cfg={"max_delta_fraction": 0.01})
        _insert_delta(side, DELTA, wm1)
        d.run_once()
        # The engine factories differ by the package name only.
        got[name] = json.loads(json.dumps(
            [mask(t) for t in obs.get_recorder().recent(16)[::-1]]
        ).replace("predictionio_tpu_torch.", "predictionio_tpu."))
    assert got["port"] == got["ref"]
    # The cycle's trace, then its summary as an event of its own.
    cycle, summary = got["port"]
    assert cycle["name"] == summary["name"] == "refresh.cycle"
    assert summary["attrs"]["result"] == "full_fallback"
    [train] = cycle["spans"]
    assert [s["name"] for s in train["spans"]] == [
        "train.datasource", "train.prepare", "train.algorithm.warm",
        "refresh.warm_fallback", "train.datasource", "train.prepare",
        "train.algorithm", "train.persist"]


def test_failed_cycle_as_the_reference(tmp_path, monkeypatch):
    out = {}
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    reset_storage()
    ref_obs.reset_observability()
    port_obs.get_registry().reset()
    jctx = JaxContext.create(storage=jax_storage())
    jctx.storage.get_events().init(
        jctx.storage.get_apps().insert(JaxApp(id=None, name=APP)))
    storage = Storage(memory_config(tmp_path / "port"))
    storage.get_events().init(
        storage.get_apps().insert(App(id=None, name=APP)))
    sides = {
        "ref": SimpleNamespace(eng=jax_engine(), ctx=jctx, wf=ref_wf,
                               variant=JaxVariant.from_dict(VARIANT)),
        "port": SimpleNamespace(eng=engine(), wf=port_wf,
                                ctx=RuntimeContext.create(storage=storage,
                                                          device="cpu"),
                                variant=EngineVariant.from_dict(
                                    PORT_VARIANT))}
    for name, side in sides.items():
        promoter = _FakePromoter(side.wf, side.ctx.storage)
        d = _daemon(name, side, promoter=promoter)
        out[name] = (d.run_once(), promoter.promoted, _counters(
            (ref_obs if name == "ref" else port_obs).get_registry()))
    reset_storage()
    assert out["port"] == out["ref"]
    assert out["port"][0]["result"] == "failed"
    assert "No rating events" in out["port"][0]["error"]


def test_follow_paces_and_stops_as_the_reference(pair):
    paced = {}
    for name in ("ref", "port"):
        side = getattr(pair, name)
        d = _daemon(name, side, interval_s=30.0)
        waits = []

        def fake_sleep(s, d=d, waits=waits):
            waits.append(s)
            if len(waits) >= 2:
                d.stop()

        paced[name] = (d.follow(sleep=fake_sleep), waits)
    assert paced["port"] == paced["ref"] == (2, [30.0, 30.0])


def test_follow_reports_each_cycle_and_honours_preemption(pair):
    from predictionio_tpu_torch.resilience.supervision import (
        clear_preemption, request_preemption)

    side = pair.port
    d = _daemon("port", side)
    seen = []

    def on_cycle(out):
        seen.append(out["result"])
        request_preemption()   # SIGTERM during the cycle

    try:
        assert d.follow(sleep=lambda s: None, on_cycle=on_cycle) == 1
    finally:
        clear_preemption()
    assert seen == ["warm"]


def test_trigger_fires_as_the_reference(pair):
    fired = {}
    for name in ("ref", "port"):
        (ref_obs if name == "ref" else port_obs).get_recorder().clear()
        side = getattr(pair, name)
        promoter = _FakePromoter(side.wf, side.ctx.storage)
        d = _daemon(name, side, promoter=promoter,
                    cfg={"trigger_delta_count": 2, "trigger_poll_s": 1.0})
        d.run_once()
        polls = []

        def fake_sleep(s, side=side, d=d, polls=polls):
            polls.append(s)
            if len(polls) == 2:   # events land while the daemon polls
                _insert_delta(side, [("u1", "i1", 2.0), ("u2", "i2", 3.0)],
                              d._served_wm)
            assert len(polls) < 10

        reason = d._await_trigger(fake_sleep)
        obs = ref_obs if name == "ref" else port_obs
        events = [(t["name"], t.get("attrs")) for t in
                  obs.get_recorder().recent(64)
                  if t["name"] == "refresh.trigger"]
        fired[name] = (reason, polls, _counters(obs.get_registry())
                       ["pio_refresh_triggers_total"], events)
    assert fired["port"] == fired["ref"]
    assert fired["port"][0] == "delta_count"
    assert fired["port"][3] == [("refresh.trigger",
                                 {"reason": "delta_count"})]


def test_staleness_reads_the_served_watermark_after_a_rollback(pair):
    """The promotion rolled back, so the server still serves an older
    watermark: the gauge reads ingest minus THAT, not minus the trained
    generation's."""
    served = dt.datetime.now(UTC) - dt.timedelta(hours=1)
    stale = {}
    for name in ("ref", "port"):
        side = getattr(pair, name)
        promoter = _FakePromoter(side.wf, side.ctx.storage,
                                 verdict="rolled_back", served=served)
        d = _daemon(name, side, promoter=promoter)
        _insert_delta(side, [("u4", "i4", 4.0)],
                      served + dt.timedelta(seconds=5))
        out = d.run_once()
        out.pop("instance")
        stale[name] = (out, _counters(
            (ref_obs if name == "ref" else port_obs).get_registry()))
    assert stale["port"] == stale["ref"]
    # the latest event: the carried generation's data is a day old, the
    # delta event 5 s (and a microsecond) after the served watermark
    assert stale["port"][1]["staleness"] == pytest.approx(5.000001)
    assert stale["port"][0]["promotion"] == "rolled_back"


class _FakeServer:
    """An opener standing in for an engine server: records each request,
    answers /reload and /admin/rollback, reports a degraded SLO from the
    ``trip_at``-th /stats.json poll, and has no /quality.json."""

    def __init__(self, trip_at=None):
        self.log, self.trip_at, self.polls = [], trip_at, 0

    def __call__(self, req, timeout=30.0):
        path = req.full_url.split("http://srv", 1)[1]
        self.log.append((req.get_method(), path))
        if path == "/quality.json":
            raise HTTPError(req.full_url, 404, "Not Found", {},
                            io.BytesIO(b'{"message": "Not Found"}'))
        if path == "/stats.json":
            self.polls += 1
            body = {"slo": {"degraded": self.trip_at is not None
                            and self.polls >= self.trip_at}}
        elif path == "/reload":
            body = {"status": "reloaded", "engineInstanceId": "i2",
                    "generation": 2}
        else:
            body = {"status": "rolled_back"}
        data = json.dumps(body).encode()
        return _Resp(data)


class _Resp:
    status = 200

    def __init__(self, data):
        self._data = data

    def read(self):
        return self._data

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("trip_at", [None, 3], ids=["quiet", "degraded"])
def test_canary_watch_as_the_reference(trip_at):
    runs = {}
    for name, mod in (("ref", ref_daemon), ("port", port_daemon)):
        now = [0.0]
        srv = _FakeServer(trip_at)

        def sleep(s, now=now):
            now[0] += s

        p = mod.HttpPromoter("http://srv", canary_window_s=10.0,
                             canary_poll_s=2.0, clock=lambda now=now: now[0],
                             sleep=sleep, opener=srv)
        body = p.promote("i2")
        verdict = p.canary_watch()
        runs[name] = (body, verdict, srv.log, now[0])
    assert runs["port"] == runs["ref"]
    body, verdict, log, _ = runs["port"]
    if trip_at is None:
        assert verdict == "promoted"
        assert log.count(("GET", "/stats.json")) == 5
    else:
        assert verdict == "rolled_back"
        assert log[-1] == ("POST", "/admin/rollback")


def test_a_rejected_promotion_as_the_reference():
    def opener(req, timeout=30.0):
        raise HTTPError(req.full_url, 409, "Conflict", {}, io.BytesIO(
            b'{"message": "candidate model has non-finite values"}'))

    msgs = []
    for mod in (ref_daemon, port_daemon):
        p = mod.HttpPromoter("http://srv", opener=opener)
        with pytest.raises(mod.PromotionRejected) as e:
            p.promote("x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_several_promote_urls_are_refused_not_cut_to_one(pair):
    """Several URLs are never cut to the first: they build the fleet's
    wave promoter over all of them, as the reference's daemon does; one
    URL builds an HttpPromoter."""
    from predictionio_tpu.fleet import FleetPromoter as RefFleetPromoter
    from predictionio_tpu_torch.fleet import FleetPromoter

    side = pair.port
    d = _daemon("port", side, cfg={"promote_url": "http://a:1, http://b:2"})
    r = _daemon("ref", pair.ref, cfg={"promote_url": "http://a:1, http://b:2"})
    assert isinstance(d.promoter, FleetPromoter)
    assert isinstance(r.promoter, RefFleetPromoter)
    assert d.promoter.instances == r.promoter.instances == \
        ["http://a:1", "http://b:2"]
    assert d.promoter.canary_window_s == r.promoter.canary_window_s
    d = _daemon("port", side, cfg={"promote_url": "http://a:1"})
    assert isinstance(d.promoter, port_daemon.HttpPromoter)
    assert d.promoter.base_url == "http://a:1"


# -- pio train --follow ------------------------------------------------------

def test_pio_train_follow_runs_a_cycle_and_stops_on_sigterm(tmp_path):
    home = tmp_path / "home"
    from predictionio_tpu_torch.config import load_config

    storage = Storage(load_config(env={"PIO_HOME": str(home)}))
    app_id = storage.get_apps().insert(App(id=None, name=APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(
        [_rate(Event, DataMap, *e) for e in _gen1_events()], app_id)
    storage.close()
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(PORT_VARIANT))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(PIO_HOME=str(home), PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "train",
         "--engine-json", str(engine_json), "--device", "cpu", "--follow",
         "--refresh-interval", "600", "--canary-window", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        head = proc.stdout.readline()
        assert head.startswith("Refresh daemon: retraining every 600s"), (
            head, proc.stderr.read() if proc.poll() is not None else "")
        line = proc.stdout.readline()
        assert line.startswith("Refresh cycle: "), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        cycle = json.loads(line[len("Refresh cycle: "):])
        assert cycle["result"] == "full" and cycle["promotion"] == "skipped"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        assert "stopped after 1 cycle(s)" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    storage = Storage(load_config(env={"PIO_HOME": str(home)}))
    try:
        [inst] = storage.get_engine_instances().get_all()
        assert inst.status == "COMPLETED"
        assert inst.env["refreshMode"] == "full"
    finally:
        storage.close()


def test_pio_train_follow_promotes_a_fleet_through_fleet_promoter(
        tmp_path):
    """`pio train --follow --promote-url A,B` in a process of its own:
    the cycle rolls the new generation across both servers in waves
    (FleetPromoter → RolloutController), its verdict is the rollout's,
    and both servers then serve it."""
    from predictionio_tpu_torch.config import load_config

    home = tmp_path / "home"
    storage = Storage(load_config(env={"PIO_HOME": str(home)}))
    app_id = storage.get_apps().insert(App(id=None, name=APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(
        [_rate(Event, DataMap, *e) for e in _gen1_events()], app_id)
    eng, variant = engine(), EngineVariant.from_dict(PORT_VARIANT)
    first = port_wf.run_train(eng, variant, RuntimeContext.create(
        storage=storage, device="cpu"))
    servers = [EngineServer(eng, variant, storage, host="127.0.0.1", port=0,
                            device="cpu") for _ in range(2)]
    for srv in servers:
        srv.start()
    urls = [f"http://127.0.0.1:{srv.port}" for srv in servers]
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(PORT_VARIANT))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(PIO_HOME=str(home), PYTHONPATH=str(ROOT),
               PIO_ROLLOUT_WAVES="1,100%", PIO_ROLLOUT_BAKE_S="0.2",
               PIO_ROLLOUT_POLL_S="0.1",
               PIO_ROLLOUT_STATE=str(tmp_path / "rollout.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "train",
         "--engine-json", str(engine_json), "--device", "cpu", "--follow",
         "--refresh-interval", "600", "--promote-url", ",".join(urls)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        head = proc.stdout.readline()
        assert head.startswith("Refresh daemon: retraining every 600s") \
            and ",".join(urls) in head, (
                head, proc.stderr.read() if proc.poll() is not None else "")
        line = proc.stdout.readline()
        assert line.startswith("Refresh cycle: "), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        cycle = json.loads(line[len("Refresh cycle: "):])
        assert cycle["promotion"] == "promoted"
        assert cycle["instance"] != first
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        for srv in servers:
            assert srv._instance.id == cycle["instance"]
        journal = json.loads((tmp_path / "rollout.json").read_text())
        assert (journal["status"], journal["target"], journal["waveCounts"],
                journal["promoted"]) == ("promoted", cycle["instance"],
                                         [1, 2], urls)
        assert journal["preRollout"] == {u: first for u in urls}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
        for srv in servers:
            srv.stop()
        storage.close()
