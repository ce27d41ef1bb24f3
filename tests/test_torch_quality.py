"""The port's model-quality layer against the reference's, on the CPU.

``predictionio_tpu_torch.obs.quality`` is held against
``predictionio_tpu.obs.quality`` on the same numpy inputs:

- ``scorecard_from_scores`` / ``scorecard_from_matrix``, ``psi`` and
  ``kl_divergence``: within 1e-12;
- ``DriftDetector``, ``ShadowScorer`` and ``FeedbackJoiner``: one script
  under one fake clock gives the same verdict series (and the same
  counters);
- ``QualityMonitor``: the same observe stream, draws included, gives the
  same ``/quality.json`` document once serve ids are masked, including
  the drift gate; ``merge_quality`` and ``QualityConfig.from_env`` agree;
- a generation the reference trained keeps its scorecard when carried
  into the port (``wrapper_from_numpy`` / ``model_from_numpy`` with
  ``dataclasses.asdict``) and through a pickle round trip;
- both engine servers over HTTP, each with its own event server in the
  same process: every sampled 200 carries ``X-PIO-Serve-Id``, echoed
  ``buy`` events join back to the served items, and ``/quality.json`` is
  equal once ids and stamps are masked, its online hit rate the planted
  share exactly.
"""

import dataclasses
import functools
import json
import os
import pickle
import random
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.quality as ref_q
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.quality as port_q
from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import AccessKey as JaxAccessKey
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxEngineServer,
)
from predictionio_tpu.server.event_server import (
    EventServer as JaxEventServer,
)
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu.workflow.core_workflow import run_train
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import AccessKey, App, Storage
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.templates.recommendation import (
    engine,
    wrapper_from_numpy,
)
from predictionio_tpu_torch.templates.twotower import model_from_numpy
from predictionio_tpu_torch.workflow.core_workflow import persist_instance

TOL = 1e-12
REF = SimpleNamespace(name="ref", q=ref_q, obs=ref_obs)
PORT = SimpleNamespace(name="port", q=port_q, obs=port_obs)
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_observability():
    for p in PKGS:
        p.obs.reset_observability()
    yield
    for p in PKGS:
        p.obs.reset_observability()


def _fields(sc):
    d = dataclasses.asdict(sc)
    d.pop("built_at")
    return d


def _close(a, b):
    """Equal structure; floats within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=0, abs=TOL)
    else:
        assert a == b


# -- scorecards and the divergences -------------------------------------------

@pytest.mark.parametrize("seed,n,bins", [(0, 500, 16), (1, 37, 8),
                                         (2, 4000, 16), (3, 3, 4)])
def test_scorecard_from_scores_within_tolerance(seed, n, bins):
    rng = np.random.default_rng(seed)
    scores = list(rng.normal(1.0, 2.0, n)) + [float("nan"), float("inf")]
    scores += list(np.round(rng.normal(0, 1, n // 3), 1))   # ties
    want = ref_q.scorecard_from_scores(scores, bins=bins, name="s")
    got = port_q.scorecard_from_scores(scores, bins=bins, name="s")
    _close(_fields(got), _fields(want))


def test_degenerate_samples_build_no_scorecard():
    for scores in ([], [1.0], [2.0, 2.0, 2.0], [float("nan")] * 3):
        assert port_q.scorecard_from_scores(scores) is None
        assert ref_q.scorecard_from_scores(scores) is None


@pytest.mark.parametrize("seed,shape", [(0, (40, 300, 8)),
                                        (1, (500, 70_000, 4)),
                                        (2, (3, 5, 16))])
def test_scorecard_from_matrix_within_tolerance(seed, shape):
    rng = np.random.default_rng(seed)
    nq, ni, d = shape
    q = rng.normal(size=(nq, d)).astype(np.float32)
    it = rng.normal(size=(ni, d)).astype(np.float32)
    want = ref_q.scorecard_from_matrix(q, it, seed=seed, name="m")
    got = port_q.scorecard_from_matrix(q, it, seed=seed, name="m")
    _close(_fields(got), _fields(want))
    assert got.fingerprint == want.fingerprint


@pytest.mark.parametrize("seed", range(6))
def test_psi_and_kl_within_tolerance(seed):
    rng = np.random.default_rng(seed)
    e = rng.dirichlet(np.ones(16))
    a = rng.dirichlet(np.ones(16) * 0.3)
    if seed % 2:
        a[rng.integers(0, 16, 3)] = 0.0              # empty bins
    for eps in (1e-6, 0.5 / 37, 1e-3):
        for fn in ("psi", "kl_divergence"):
            want = getattr(ref_q, fn)(e, a, eps=eps)
            got = getattr(port_q, fn)(e, a, eps=eps)
            assert abs(got - want) <= TOL


@functools.lru_cache(maxsize=None)
def _baseline(seed=0):
    rng = np.random.default_rng(seed)
    return ref_q.scorecard_from_scores(rng.normal(0, 1, 2000).tolist(),
                                       name="base")


def _pair(pkg, sc):
    """The reference's scorecard, in ``pkg``'s own class."""
    return sc if pkg is REF else port_q.scorecard_from_mapping(
        dataclasses.asdict(sc))


# -- detectors under one fake clock -------------------------------------------

def _drift_series(pkg, cfg_kw, stream, with_baseline=True):
    t = [0.0]
    cfg = pkg.q.QualityConfig(**cfg_kw)
    det = pkg.q.DriftDetector(
        cfg, _pair(pkg, _baseline()) if with_baseline else None,
        clock=lambda: t[0])
    out = []
    for kind, arg in stream:
        if kind == "add":
            for v in arg:
                det.add(float(v))
        elif kind == "adv":
            t[0] += arg
        elif kind == "tick":
            out.append(det.tick(force=True))
        else:
            out.append(det.tick())
    return out


def _drift_stream(name):
    rng = np.random.default_rng(7)
    clean = lambda n: rng.normal(0, 1, n)          # noqa: E731
    shifted = lambda n: rng.normal(3, 1, n)        # noqa: E731
    if name == "clean":
        return [("add", clean(400)), ("tick", None)] * 3
    if name == "shift_then_recover":
        return ([("add", shifted(800)), ("adv", 1), ("tick", None)]
                + [("add", clean(600)), ("adv", 20), ("tick", None)] * 6
                + [("lazy", None)])
    if name == "fast_burst":
        return [("add", clean(3000)), ("tick", None),
                ("add", shifted(150)), ("adv", 1), ("tick", None)]
    return [("add", clean(30)), ("tick", None)]


@pytest.mark.parametrize("name", ["clean", "shift_then_recover",
                                  "fast_burst", "cold"])
def test_drift_detector_series_equals_the_reference(name):
    kw = dict(min_samples=50, fast_window=128, reservoir=512,
              recovery_s=60.0)
    stream = _drift_stream(name)
    want = _drift_series(REF, kw, stream)
    got = _drift_series(PORT, kw, stream)
    assert got == want
    if name == "shift_then_recover":
        flags = [s["tripped"] for s in want]
        assert flags[0] and not flags[-1]


def test_drift_without_a_scorecard_is_reporting_only():
    stream = [("add", [0.1, 0.2]), ("tick", None)]
    want = _drift_series(REF, {}, stream, with_baseline=False)
    assert _drift_series(PORT, {}, stream, with_baseline=False) == want
    assert want[0]["reportingOnly"] and want[0]["reason"] == "no_scorecard"


def _shadow_series(pkg):
    reg = pkg.obs.get_registry()
    answers = {
        "same": {"itemScores": [{"item": "a", "score": 1.0},
                                {"item": "b", "score": 0.5}]},
        "half": {"itemScores": [{"item": "a", "score": 1.2},
                                {"item": "z", "score": 0.9}]},
        "none": {"itemScores": []},
    }

    def fn(q):
        if q == "boom":
            raise RuntimeError("old generation failed")
        return answers[q]

    s = pkg.q.ShadowScorer(pkg.q.QualityConfig(min_samples=4,
                                               shadow_queue=3),
                           registry=reg)
    s._fn, s._generation, s._prev_generation = fn, 2, 1
    served = [("a", 1.0), ("b", 0.5)]
    out = []
    for q in ("same", "half", "none", "boom", "same", "half", "same"):
        s.submit(q, served, generation=2)
        out.append((s.drain_once(), s.snapshot()))
    s.submit("same", served, generation=9)       # another generation
    out.append(s.drain_once())
    for q in ("same",) * 5:                      # bounded queue: drops
        s.submit(q, served, generation=2)
    s.stop("rollback")
    out.append((s.active(), s.drain_once(), s.snapshot()))
    h = reg.get("pio_quality_shadow_delta")
    out.append((reg.get("pio_quality_shadow_total").series(),
                h.count(), round(h.sum(), 12)))
    return out


def test_shadow_scorer_series_equals_the_reference():
    want = _shadow_series(REF)
    assert _shadow_series(PORT) == want
    assert want[5][1]["scored"] == 5 and want[5][1]["divergent"] is False


def _joiner_series(pkg):
    t = [0.0]
    j = pkg.q.FeedbackJoiner(ttl_s=100.0, max_records=3,
                             clock=lambda: t[0],
                             registry=pkg.obs.get_registry())
    out = []
    j.note_serve("g3-a", 3, ["i1", "i2"])
    j.note_serve("g4-b", 4, ["i5"])
    for sid, item, dt in (("g3-a", "i1", 1), ("g3-a", "i9", 1),
                          ("g4-b", "i5", 1), ("g7-zz", "i1", 1),
                          ("nope", "i1", 1), ("g4-b", None, 1),
                          ("g3-a", "i2", 150)):
        t[0] += dt
        out.append((j.feedback(sid, item, "buy"), j.snapshot()))
    for i in range(5):                           # capacity eviction
        j.note_serve(f"g5-{i}", 5, ["x"])
    out.append(j.snapshot())
    out.append([pkg.q.generation_of_serve_id(s)
                for s in ("g12-x", "gx-1", "h1-x", "g-", "g7")])
    out.append(pkg.obs.get_registry().get(
        "pio_quality_feedback_total").series())
    return out


def test_feedback_joiner_series_equals_the_reference():
    want = _joiner_series(REF)
    assert _joiner_series(PORT) == want
    assert [o for o, _ in want[:7]] == ["hit", "miss", "hit", "unmatched",
                                        "unmatched", "miss", "expired"]


@pytest.mark.parametrize("quality", ["on", "off"])
def test_ingest_hook_joins_echoed_serves_as_the_reference(monkeypatch,
                                                          quality):
    monkeypatch.setenv("PIO_QUALITY", quality)
    monkeypatch.setenv("PIO_QUALITY_FEEDBACK_EVENTS", "buy")
    snaps = []
    for pkg, ev, dm in ((REF, JaxEvent, JaxDataMap),
                        (PORT, Event, DataMap)):
        pkg.q.reset_quality()
        pkg.q.feedback_joiner().note_serve("g2-s", 2, ["i1", "i2"])
        pkg.q.note_feedback_events([
            ev(event=name, entity_type="user", entity_id="u1",
               target_entity_type="item", target_entity_id=item,
               properties=dm(props))
            for name, item, props in (
                ("buy", "i1", {"pioServeId": "g2-s"}),
                ("buy", "i7", {"pioServeId": "g2-s"}),
                ("rate", "i2", {"pioServeId": "g2-s", "rating": 4}),
                ("buy", "i2", {}))])
        snaps.append(pkg.q.feedback_joiner().snapshot())
    assert snaps[1] == snaps[0]
    hits = snaps[0]["generations"].get("2", {}).get("hits", 0)
    assert hits == (1 if quality == "on" else 0)


# -- the monitor ---------------------------------------------------------------

def _monitor_doc(pkg, gate):
    sc = _pair(pkg, _baseline())
    wrapper = type("W", (), {"quality": sc})()
    m = pkg.q.QualityMonitor(
        pkg.q.QualityConfig(sample=0.5, min_samples=40, fast_window=64,
                            reservoir=256, gate=gate),
        registry=pkg.obs.get_registry(), clock=lambda: 0.0,
        rng=random.Random(11))
    m.on_generation(3, [wrapper])
    rng = np.random.default_rng(3)
    sids, draws = [], []
    for i in range(300):
        u = m.draw()
        draws.append(u)
        mean = 0.0 if i < 150 else 4.0
        items = [{"item": f"i{int(rng.integers(0, 9))}",
                  "score": float(v)} for v in rng.normal(mean, 1, 3)]
        res = {"itemScores": items} if i % 50 else {"itemScores": []}
        sid = m.observe({"user": "u"}, res, 3, u)
        sids.append(sid is not None and sid.startswith("g3-"))
        if i in (100, 299):
            m._detector.tick(force=True)
    doc = m.payload()
    summary = m.summary()
    m.close()
    return draws, sids, doc, summary


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "report"])
def test_monitor_document_equals_the_reference(gate):
    want = _monitor_doc(REF, gate)
    got = _monitor_doc(PORT, gate)
    assert got == want
    doc = want[2]
    assert doc["verdict"] == "degraded"
    assert doc["gate"]["rollback"] is gate


def test_monitor_kill_switch_registers_nothing(monkeypatch):
    monkeypatch.setenv("PIO_QUALITY", "off")
    m = port_q.QualityMonitor()
    assert not m.enabled and m.payload() == {"enabled": False}
    assert m.observe({}, {"itemScores": [{"item": "a", "score": 1.0}]},
                     1, u=0.0) is None
    reg = port_obs.get_registry()
    assert all(reg.get(n) is None for n in (
        "pio_quality_sampled_total", "pio_predict_score",
        "pio_quality_drift", "pio_quality_shadow_total"))


@pytest.mark.parametrize("env", [
    {}, {"PIO_QUALITY": "off", "PIO_QUALITY_SAMPLE": "1.5",
         "PIO_QUALITY_FEEDBACK_EVENTS": " buy , view ,",
         "PIO_SHADOW_SAMPLE": "-1", "PIO_QUALITY_GATE": "0"},
    {"PIO_QUALITY_RESERVOIR": "x", "PIO_QUALITY_MIN_SAMPLES": "7",
     "PIO_SHADOW_MIN_OVERLAP": "0.9", "PIO_QUALITY_FEEDBACK_EVENTS": ""},
])
def test_quality_config_from_env_as_the_reference(env):
    assert dataclasses.asdict(port_q.QualityConfig.from_env(env)) == \
        dataclasses.asdict(ref_q.QualityConfig.from_env(env))


def test_merge_quality_as_the_reference():
    docs = [_monitor_doc(REF, True)[2], _monitor_doc(REF, False)[2],
            {"enabled": False}, {"enabled": True, "verdict": "healthy",
                                 "feedback": {"generations": {
                                     "3": {"hits": 2, "misses": 1}}},
                                 "recall": {"recallFast": 0.8}}]
    for subset in (docs, docs[2:3], docs[1:]):
        assert port_q.merge_quality(subset) == ref_q.merge_quality(subset)


def test_resolve_scorecard_fingerprint_tripwire_as_the_reference():
    rng = np.random.default_rng(1)
    it = rng.normal(size=(50, 4)).astype(np.float32)
    sc = ref_q.scorecard_from_matrix(rng.normal(size=(9, 4)), it)
    out = []
    for pkg in PKGS:
        good = type("W", (), {"quality": _pair(pkg, sc), "item_vecs": it})()
        bad = type("W", (), {"quality": _pair(pkg, sc),
                             "item_vecs": it + 1.0})()
        out.append([(r[0] is not None, r[1]) for r in (
            pkg.q.resolve_scorecard([good]), pkg.q.resolve_scorecard([bad]),
            pkg.q.resolve_scorecard([object()]))])
    assert out[1] == out[0] == [(True, None), (False, "fingerprint_mismatch"),
                                (False, "no_scorecard")]


# -- a carried generation keeps its scorecards --------------------------------

def test_carried_two_tower_generation_keeps_its_scorecards():
    import predictionio_tpu.obs.recall as ref_r
    from predictionio_tpu.retrieval import build_ivf, build_pq

    rng = np.random.default_rng(2)
    uv = rng.normal(size=(20, 8)).astype(np.float32)
    iv = rng.normal(size=(600, 8)).astype(np.float32)
    iv /= np.linalg.norm(iv, axis=1, keepdims=True)
    ivf = build_ivf(iv, nlist=8, seed=0, force=True)
    pq = build_pq(iv, m=4, ivf=ivf, seed=0)
    sc = ref_q.scorecard_from_matrix(uv, iv, name="twotower")
    rsc = ref_r.build_recall_scorecard(uv, iv, ivf=ivf, pq=pq,
                                       name="twotower")
    w = model_from_numpy(uv, iv, [f"u{i}" for i in range(20)],
                         [f"i{i}" for i in range(600)],
                         ivf=dataclasses.asdict(ivf),
                         pq=dataclasses.asdict(pq),
                         quality=dataclasses.asdict(sc),
                         recall=dataclasses.asdict(rsc))
    w2 = pickle.loads(pickle.dumps(w))
    assert dataclasses.asdict(w2.quality) == dataclasses.asdict(sc)
    assert dataclasses.asdict(w2.recall) == dataclasses.asdict(rsc)
    # the fingerprint tripwire holds against the carried corpus
    assert port_q.resolve_scorecard([w2]) == (w2.quality, None)
    from predictionio_tpu_torch.obs.recall import resolve_recall_scorecard
    assert resolve_recall_scorecard([w2]) == (w2.recall, None)


# -- both servers over HTTP, with their event servers -------------------------

APP = "qualityparity"
KEY = "qualitykey"
N_USERS, N_ITEMS = 12, 10
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": APP}},
    "algorithms": [{"name": "als",
                    "params": {"rank": 4, "numIterations": 3,
                               "lambda_": 0.05, "seed": 3}}],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny ALS generation trained by the reference (its scorecard
    baked), the same generation carried into the port's storage, and an
    app with an access key in each storage for the event servers."""
    home = tmp_path_factory.mktemp("pio_home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_QUALITY", "PIO_SHADOW",
                             "PIO_RECALL", "PIO_RESULT_CACHE")):
                mp.delenv(k, raising=False)
        reset_storage()
        ctx = JaxContext.create(storage=jax_storage())
        app_id = ctx.storage.get_apps().insert(JaxApp(id=None, name=APP))
        ctx.storage.get_events().init(app_id)
        ctx.storage.get_access_keys().insert(
            JaxAccessKey(key=KEY, app_id=app_id))
        rng = np.random.default_rng(8)
        ctx.storage.get_events().insert_batch([
            JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     properties=JaxDataMap(
                         {"rating": float(1 + 4 * rng.random())}))
            for u in range(N_USERS) for i in range(N_ITEMS)
            if rng.random() < 0.6], app_id)
        jeng = jax_engine()
        jvariant = JaxVariant.from_dict(VARIANT)
        run_train(jeng, jvariant, ctx)
        probe = JaxEngineServer(jeng, jvariant, ctx.storage)
        jw = probe._models[0]
        probe.stop()
        assert jw.quality is not None and jw.recall is None
        wrapper = wrapper_from_numpy(
            np.asarray(jax.device_get(jw.model.user_factors))[
                :len(jw.user_index)],
            np.asarray(jax.device_get(jw.model.item_factors))[
                :len(jw.item_index)],
            jw.user_index.to_numpy_keys(), jw.item_index.to_numpy_keys(),
            rank=4, implicit=jw.model.implicit,
            quality=dataclasses.asdict(jw.quality), recall=None)
        storage = Storage(memory_config(home / "port"))
        pid = storage.get_apps().insert(App(id=None, name=APP))
        storage.get_events().init(pid)
        storage.get_access_keys().insert(AccessKey(key=KEY, app_id=pid))
        eng = engine()
        variant = EngineVariant.from_dict(PORT_VARIANT)
        persist_instance(eng, variant, [wrapper], storage)
        try:
            yield SimpleNamespace(jeng=jeng, jvariant=jvariant,
                                  jstorage=ctx.storage, jwrapper=jw,
                                  eng=eng, variant=variant, storage=storage)
        finally:
            reset_storage()


def test_carried_als_generation_keeps_its_scorecard(trained):
    srv = EngineServer(trained.eng, trained.variant, trained.storage,
                       device="cpu")
    try:
        [w] = srv._models
        assert _fields(w.quality) == _fields(trained.jwrapper.quality)
        assert w.quality.built_at == trained.jwrapper.quality.built_at
        assert w.recall is None
        doc = srv.handle("GET", "/quality.json", b"")[1]
        assert doc["scorecard"]["present"] is True
        assert doc["scorecard"]["fingerprint"] == \
            trained.jwrapper.quality.fingerprint
    finally:
        srv.stop()


def _http(port, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _mask(doc):
    """/quality.json without the clock-dependent fields."""
    doc = json.loads(json.dumps(doc))
    for key in ("trippedSinceS", "recoveringForS"):
        doc["drift"].pop(key, None)
    return doc


def _feedback_session(srv, es, planted):
    served, sids = [], []
    for u in range(N_USERS):
        st, head, body = _http(srv.port, "POST", "/queries.json",
                               {"user": f"u{u}", "num": 3})
        assert st == 200
        sids.append(head.get("X-PIO-Serve-Id"))
        served.append(body["itemScores"][0]["item"])
    for k, (sid, item) in enumerate(zip(sids, served)):
        target = item if k < planted else "never-served"
        st, _, _ = _http(es.port, "POST", f"/events.json?accessKey={KEY}",
                         {"event": "buy", "entityType": "user",
                          "entityId": f"u{k}", "targetEntityType": "item",
                          "targetEntityId": target,
                          "properties": {"pioServeId": sid}})
        assert st == 201
    _, _, doc = _http(srv.port, "GET", "/quality.json")
    _, _, stats = _http(srv.port, "GET", "/stats.json")
    return sids, _mask(doc), stats["quality"]


def test_quality_json_and_feedback_join_equal_the_reference(trained,
                                                            monkeypatch):
    monkeypatch.setenv("PIO_QUALITY_SAMPLE", "1")
    monkeypatch.setenv("PIO_QUALITY_MIN_SAMPLES", "5")
    monkeypatch.setenv("PIO_SEGMENTS", "off")
    planted = 7
    out = {}
    stacks = (
        ("ref", REF, lambda: JaxEngineServer(
            trained.jeng, trained.jvariant, trained.jstorage,
            host="127.0.0.1", port=0),
         lambda: JaxEventServer(storage=trained.jstorage,
                                host="127.0.0.1", port=0)),
        ("port", PORT, lambda: EngineServer(
            trained.eng, trained.variant, trained.storage,
            host="127.0.0.1", port=0, device="cpu"),
         lambda: EventServer(storage=trained.storage, host="127.0.0.1",
                             port=0)))
    for name, pkg, make_srv, make_es in stacks:
        pkg.obs.reset_observability()
        srv, es = make_srv(), make_es()
        srv.start()
        es.start()
        try:
            out[name] = _feedback_session(srv, es, planted)
        finally:
            es.stop()
            srv.stop()
    for name in out:
        sids = out[name][0]
        assert all(s and s.startswith("g1-") for s in sids), sids
    assert out["port"][1:] == out["ref"][1:]
    fb = out["ref"][1]["feedback"]["generations"]["1"]
    assert (fb["hits"], fb["misses"]) == (planted, N_USERS - planted)
    assert fb["hitRate"] == round(planted / N_USERS, 4)
    assert out["ref"][1]["sampling"]["sampledTotal"] == N_USERS
