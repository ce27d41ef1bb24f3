"""The port's latency waterfall and SLO engine against the reference's.

``predictionio_tpu_torch.obs.waterfall`` / ``.slo`` and their hooks in
the serving scheduler, the transport and the engine server are held
against ``predictionio_tpu``'s on the CPU, on the same inputs:

- ``SLOEngine``: scripted request streams under one fake clock give equal
  tick snapshots and ``ready()`` verdicts (sustained burn, a lone spike,
  hysteresis and its reset, the latency target, the request floor,
  saturation, the ``PIO_READY_SLO`` hatch, tick coalescing), the same
  gauges and the same ``SLOConfig.from_env``;
- ``Waterfall``: the same stage tables, sink routing, finalize document
  (wide-event keys, stage sums, exemplars) and request-log sampling;
- the batcher's stamps under a fake clock: the same stages and
  attributes on a queue-expired 504, a failed cohort with its per-member
  retries, and a dispatch whose library code records into the sink;
- both engine servers over HTTP: ``/ready`` and ``/stats.json``'s
  ``slo`` equal once ids are masked (the SLO engine on a fake clock,
  the registry driven directly, as the reference's own test does), and
  the wide events of ``PIO_REQUEST_LOG`` carry the same keys and stages
  on the dispatch path and on a cache hit; the port's exemplar resolves
  through ``/traces.json?request_id=`` to one ``http.request`` tree.

No assertion rests on a wall-clock ratio: the stage-sum reconciliation
is checked on the card, where the reference's bound applies.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.slo as ref_slo
import predictionio_tpu.obs.waterfall as ref_wf
import predictionio_tpu.serving as ref_serving
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.slo as port_slo
import predictionio_tpu_torch.obs.waterfall as port_wf
import predictionio_tpu_torch.serving as port_serving
from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.server.engine_server import (
    EngineServer as JaxEngineServer,
)
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu.workflow.core_workflow import run_train
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.templates.recommendation import (
    engine,
    wrapper_from_numpy,
)
from predictionio_tpu_torch.workflow.core_workflow import persist_instance

REF = SimpleNamespace(name="ref", wf=ref_wf, slo=ref_slo, obs=ref_obs,
                      s=ref_serving)
PORT = SimpleNamespace(name="port", wf=port_wf, slo=port_slo, obs=port_obs,
                       s=port_serving)
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_observability():
    for p in PKGS:
        p.obs.reset_observability()
    yield
    for p in PKGS:
        p.obs.reset_observability()


class Tick:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _instruments(pkg):
    reg = pkg.obs.get_registry()
    return (reg.counter("pio_query_requests_total",
                        "Predict requests served."),
            reg.counter("pio_query_errors_total",
                        "Predict requests that failed."),
            reg.histogram("pio_query_latency_ms",
                          "Predict request latency."))


# -- SLOEngine: scripted streams ----------------------------------------------

# Each step: ("t", n_good, n_bad[, latency_ms]) adds traffic, ("adv", s)
# moves the clock, ("tick",) / ("tick_lazy",) sample (forced / coalesced),
# ("ready",) reads the verdict, ("sat", bool) sets the saturation signal.
def _rep(n, *steps):
    return [s for _ in range(n) for s in steps]


SCENARIOS = {
    "healthy": ({}, _rep(10, ("t", 50, 0), ("adv", 60), ("tick",))
                + [("ready",)]),
    "lone_spike": ({}, _rep(60, ("t", 100, 0), ("adv", 60), ("tick",))
                   + [("t", 0, 50), ("adv", 30), ("tick",), ("ready",)]),
    "sustained_then_recovers": (
        {}, _rep(70, ("t", 80, 20), ("adv", 60), ("tick",)) + [("ready",)]
        + _rep(90, ("t", 100, 0), ("adv", 60), ("tick",), ("ready",))),
    "flap_resets_the_dwell": (
        dict(fast_window_s=60.0, slow_window_s=120.0, recovery_s=300.0),
        _rep(5, ("t", 50, 50), ("adv", 30), ("tick",))
        + _rep(4, ("t", 100, 0), ("adv", 60), ("tick",), ("ready",))
        + _rep(3, ("t", 50, 50), ("adv", 30), ("tick",))
        + _rep(12, ("t", 100, 0), ("adv", 60), ("tick",), ("ready",))),
    "latency_target": (
        dict(latency_target_ms=50.0),
        _rep(70, ("t", 100, 0, 400.0), ("adv", 60), ("tick",))
        + [("ready",)]),
    "request_floor": (
        {}, _rep(5, ("t", 0, 1), ("adv", 60), ("tick",)) + [("ready",)]),
    "saturation_with_burn": (
        {}, _rep(60, ("t", 100, 0), ("adv", 60), ("tick",))
        + [("sat", True), ("t", 90, 10), ("adv", 30), ("tick",),
           ("ready",), ("sat", False), ("adv", 400), ("tick",),
           ("adv", 61), ("tick",), ("ready",)]),
    "saturation_alone": (
        {}, [("sat", True)] + _rep(5, ("t", 100, 0), ("adv", 60),
                                   ("tick",), ("ready",))),
    "ready_slo_off": (
        dict(ready_slo=False),
        _rep(70, ("t", 50, 50), ("adv", 60), ("tick",)) + [("ready",)]),
    "tick_coalescing": (
        {}, [("t", 10, 0), ("tick",), ("adv", 0.2), ("t", 0, 10),
             ("tick_lazy",), ("adv", 1.0), ("tick_lazy",), ("ready",)]),
}


def _run_slo(pkg, cfg, steps):
    req, err, lat = _instruments(pkg)
    clock, sat = Tick(), {"v": False}
    defaults = dict(fast_window_s=300.0, slow_window_s=3600.0,
                    burn_threshold=14.4, min_requests=10,
                    recovery_s=60.0, latency_target_ms=100.0)
    defaults.update(cfg)
    engine_ = pkg.slo.SLOEngine(pkg.slo.SLOConfig(**defaults), clock=clock,
                                saturation_fn=lambda: sat["v"])
    log = []
    for step in steps:
        if step[0] == "t":
            n_good, n_bad = step[1], step[2]
            req.inc(n_good + n_bad)
            err.inc(n_bad)
            for _ in range(n_good):
                lat.observe(step[3] if len(step) > 3 else 5.0)
        elif step[0] == "adv":
            clock.t += step[1]
        elif step[0] == "sat":
            sat["v"] = step[1]
        elif step[0] == "tick":
            log.append(("tick", engine_.tick(force=True)))
        elif step[0] == "tick_lazy":
            log.append(("tick_lazy", engine_.tick()))
        elif step[0] == "ready":
            log.append(("ready", engine_.ready()))
    reg = pkg.obs.get_registry()
    gauges = {name: reg.get(name).series() for name in (
        "pio_slo_burn_rate", "pio_slo_objective",
        "pio_slo_latency_target_ms", "pio_slo_degraded",
        "pio_slo_saturated")}
    return log, gauges, len(engine_._snaps)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_engine_scripted_stream_equals_the_reference(name):
    cfg, steps = SCENARIOS[name]
    ref, port = (_run_slo(p, cfg, steps) for p in PKGS)
    assert port == ref
    verdicts = [v for kind, v in ref[0] if kind == "ready"]
    assert verdicts
    if name == "sustained_then_recovers":
        flips = [ok for ok, _ in verdicts]
        assert flips[0] is False and flips[-1] is True
        assert "sustained_burn" in verdicts[0][1]["tripReasons"]
    if name == "ready_slo_off":
        assert verdicts[-1][0] is True and verdicts[-1][1]["degraded"]
    if name == "saturation_with_burn":
        assert verdicts[0][0] is False
        assert "saturation_with_burn" in verdicts[0][1]["tripReasons"]


@pytest.mark.parametrize("env", [
    {},
    {"PIO_SLO_AVAILABILITY": "0.99", "PIO_SLO_LATENCY_OBJECTIVE": "0.9",
     "PIO_SLO_FAST_WINDOW_S": "2", "PIO_SLO_SLOW_WINDOW_S": "4",
     "PIO_SLO_BURN_THRESHOLD": "1.5", "PIO_SLO_MIN_REQUESTS": "3",
     "PIO_SLO_RECOVERY_S": "0.5", "PIO_READY_SLO": "off"},
    {"PIO_BATCH_P99_TARGET_MS": "40"},
    {"PIO_BATCH_P99_TARGET_MS": "40", "PIO_SLO_LATENCY_TARGET_MS": "0.001"},
    {"PIO_SLO_AVAILABILITY": "x", "PIO_SLO_LATENCY_OBJECTIVE": "2"},
], ids=["defaults", "all_knobs", "p99_target", "target_over_p99", "bad"])
def test_slo_config_from_env_as_the_reference(env):
    assert dataclasses.asdict(port_slo.SLOConfig.from_env(env)) == \
        dataclasses.asdict(ref_slo.SLOConfig.from_env(env))


# -- Waterfall ----------------------------------------------------------------

def test_stage_tables_as_the_reference():
    for name in ("SERVE_STAGES", "WALL_STAGES", "ATTESTED_STAGES"):
        assert getattr(port_wf, name) == getattr(ref_wf, name)
    assert port_wf.__all__ == ref_wf.__all__


def _routing(pkg):
    wf_mod = pkg.wf
    wf_mod.record_stage("bind", 1.0)          # no collector: a no-op
    out = {}
    with wf_mod.begin_request() as wf:
        wf_mod.record_stage("bind", 1.0)
        sink = wf_mod.Waterfall()
        sink.sample_u = 0.25
        with wf_mod.dispatch_sink(sink):
            wf_mod.record_stage("retrieval", 2.0, rung="host")
            out["u_in_sink"] = wf_mod.active_sample_u()
        wf_mod.record_stage("serialize", 3.0)
        out["u_outside"] = wf_mod.active_sample_u()
        wf.stamp("dispatch", 5.0)
        wf.stamp("dispatch", 2.0, batchSize=4)
        stages, attrs = sink.export()
        wf.merge(stages, **attrs)
        wf.note(serveId="g1-x")
        wf.mark("handler_done")
        out["mark"] = wf.take_mark("handler_done") is not None
        out["mark_again"] = wf.take_mark("handler_done")
    out["after"] = wf_mod.current_waterfall()
    out["snapshot"] = wf.snapshot()
    out["attrs"] = dict(wf.attrs)
    return out


def test_stage_routing_as_the_reference():
    ref, port = _routing(REF), _routing(PORT)
    assert port == ref
    assert ref["snapshot"] == {"bind": 1.0, "serialize": 3.0,
                               "dispatch": 7.0, "retrieval": 2.0}


def _finalize(pkg, tmp_path, sample_rate, sample_u):
    log = tmp_path / f"{pkg.name}-{sample_rate}-{sample_u}.jsonl"
    os.environ["PIO_REQUEST_LOG"] = str(log)
    if sample_rate is None:
        os.environ.pop("PIO_REQUEST_LOG_SAMPLE", None)
    else:
        os.environ["PIO_REQUEST_LOG_SAMPLE"] = str(sample_rate)
    wf = pkg.wf.Waterfall()
    wf.sample_u = sample_u
    for s, ms in (("ingress", 0.2), ("queue_wait", 1.0),
                  ("batch_wait", 2.0), ("bind", 0.5), ("cache", 0.05),
                  ("dispatch", 10.0), ("resume", 0.3), ("retrieval", 6.0),
                  ("serialize", 1.0), ("shed_check", 0.1)):
        wf.stamp(s, ms)
    wf.note(generation=3, rung="host")
    doc = wf.finalize(trace_id="t1", status=200, total_ms=15.5,
                      attested_ms=14.0)
    late = (wf.stamp("dispatch", 99.0),
            wf.finalize(trace_id="t1", status=200, total_ms=1.0))
    rows = ([json.loads(line) for line in log.read_text().splitlines()]
            if log.exists() else [])
    hist = pkg.obs.get_registry().get("pio_serve_stage_ms")
    ex = {s: hist.exemplars(stage=s) for s in pkg.wf.SERVE_STAGES}
    doc.pop("ts")
    for r in rows:
        r.pop("ts")
    return doc, late, rows, ex, hist.render(exemplars=True)


@pytest.mark.parametrize("rate,u", [(None, None), ("0.5", 0.2),
                                    ("0.5", 0.7), ("0", 0.0)],
                         ids=["every", "sampled_in", "sampled_out", "off"])
def test_finalize_and_request_log_as_the_reference(tmp_path, monkeypatch,
                                                   rate, u):
    monkeypatch.delenv("PIO_REQUEST_LOG", raising=False)
    monkeypatch.delenv("PIO_REQUEST_LOG_SAMPLE", raising=False)
    ref = _finalize(REF, tmp_path, rate, u)
    port = _finalize(PORT, tmp_path, rate, u)
    assert port == ref
    doc = ref[0]
    assert doc["stageSumMs"] == pytest.approx(15.15)
    assert doc["attestedSumMs"] == pytest.approx(14.15)
    assert len(ref[2]) == (1 if rate is None or u == 0.2 else 0)


class FakeClock:
    def __init__(self, t=1.0, step=0.0):
        self.t, self.step = t, step

    def now(self):
        self.t += self.step
        return self.t

    def wait(self, cond, timeout):
        if timeout is not None:
            self.t += timeout
        return False


def _batcher_stamps(pkg, case):
    s, wf_mod = pkg.s, pkg.wf
    if case == "expired":
        b = s.MicroBatcher("m", s.ModelQueue("m", 4),
                           lambda qs: ([0] * len(qs), 1),
                           clock=FakeClock())
        members = [s.Pending("dead", 0.0, deadline_s=0.5,
                             waterfall=wf_mod.Waterfall())]
        members[0].gathered_s = 0.2
    elif case == "failed_cohort":
        calls = iter(range(10))

        def flaky(qs):
            n = next(calls)
            wf_mod.record_stage("retrieval", 1.5, rung="host")
            if n == 0 or qs == ["bad"]:
                raise RuntimeError("dead backend")
            return [q.upper() for q in qs], 7

        b = s.MicroBatcher("m", s.ModelQueue("m", 4), flaky,
                           clock=FakeClock(step=0.010))
        members = [s.Pending(q, 0.5, waterfall=wf_mod.Waterfall())
                   for q in ("a", "bad", "c")]
    else:
        def ok(qs):
            wf_mod.record_stage("retrieval", 2.5, rung="chunked",
                                retrievalCandidates=len(qs) * 100)
            return [q.upper() for q in qs], 4

        b = s.MicroBatcher("m", s.ModelQueue("m", 8), ok,
                           clock=FakeClock(step=0.002))
        members = [s.Pending(q, 0.9, waterfall=wf_mod.Waterfall())
                   for q in ("x", "y")]
        members[1].waterfall.sample_u = 0.125
        for m in members:
            b.queue.put(m)
        members = b.gather()
    b.dispatch(members)
    return [(m.result, type(m.error).__name__,
             {k: round(v, 9) for k, v in m.waterfall.snapshot().items()},
             m.waterfall.export()[1]) for m in members]


@pytest.mark.parametrize("case", ["expired", "failed_cohort", "cohort"])
def test_batcher_stamps_as_the_reference(case):
    ref, port = _batcher_stamps(REF, case), _batcher_stamps(PORT, case)
    assert port == ref
    if case == "expired":
        assert ref[0][2] == {"queue_wait": 200.0, "batch_wait": 800.0}
    if case == "cohort":
        assert all(r[3]["generation"] == 4 and "retrieval" in r[2]
                   for r in ref)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_submit_and_wait_stamps_resume_and_the_generation(pkg):
    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        enabled=True, autotune=False, window_ms=0.0))
    sched.register("m", lambda qs: ([q * 2 for q in qs], 9))
    try:
        with pkg.wf.begin_request() as wf:
            assert sched.submit_and_wait("m", 21) == 42
        assert wf.attr("generation") == 9
        assert {"queue_wait", "batch_wait", "dispatch"} <= set(
            wf.snapshot())
    finally:
        sched.close()


# -- both servers over HTTP ---------------------------------------------------

APP = "wfparity"
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
_ENV = ("PIO_RESULT_CACHE", "PIO_REQUEST_LOG", "PIO_REQUEST_LOG_SAMPLE",
        "PIO_QUALITY", "PIO_QUALITY_SAMPLE", "PIO_RECALL", "PIO_READY_SLO")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny ALS generation trained by the reference, and the port's
    storage holding it carried in (scorecards included)."""
    home = tmp_path_factory.mktemp("pio_home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_HOME", str(home))
        for k in list(os.environ):
            if k.startswith(("PIO_STORAGE_", "PIO_SLO_")) or k in _ENV:
                mp.delenv(k, raising=False)
        reset_storage()
        ctx = JaxContext.create(storage=jax_storage())
        app_id = ctx.storage.get_apps().insert(JaxApp(id=None, name=APP))
        ctx.storage.get_events().init(app_id)
        rng = np.random.default_rng(5)
        ctx.storage.get_events().insert_batch([
            JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     properties=JaxDataMap(
                         {"rating": float(1 + 4 * rng.random())}))
            for u in range(12) for i in range(10)
            if rng.random() < 0.6], app_id)
        jeng = jax_engine()
        jvariant = JaxVariant.from_dict(VARIANT)
        run_train(jeng, jvariant, ctx)
        probe = JaxEngineServer(jeng, jvariant, ctx.storage)
        jw = probe._models[0]
        probe.stop()
        wrapper = wrapper_from_numpy(
            np.asarray(jax.device_get(jw.model.user_factors))[
                :len(jw.user_index)],
            np.asarray(jax.device_get(jw.model.item_factors))[
                :len(jw.item_index)],
            jw.user_index.to_numpy_keys(), jw.item_index.to_numpy_keys(),
            rank=4, implicit=jw.model.implicit,
            quality=dataclasses.asdict(jw.quality))
        storage = Storage(memory_config(home / "port"))
        eng = engine()
        variant = EngineVariant.from_dict(PORT_VARIANT)
        persist_instance(eng, variant, [wrapper], storage)
        try:
            yield SimpleNamespace(jeng=jeng, jvariant=jvariant,
                                  jstorage=ctx.storage, eng=eng,
                                  variant=variant, storage=storage)
        finally:
            reset_storage()


def _servers(trained):
    ref = JaxEngineServer(trained.jeng, trained.jvariant, trained.jstorage,
                          host="127.0.0.1", port=0)
    port = EngineServer(trained.eng, trained.variant, trained.storage,
                        host="127.0.0.1", port=0, device="cpu")
    return {"ref": ref, "port": port}


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_query(port, user):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps({"user": user, "num": 3}).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, dict(r.headers), json.loads(r.read())


def _ready_session(srv, pkg, clock, sat):
    """The reference's /ready flip script (its test_slo_fleet) over HTTP:
    healthy, then saturation with a fast burn, then the dwell."""
    req, err, lat = _instruments(pkg)
    out = []

    def poll():
        for path in ("/ready", "/stats.json", "/"):
            s, _, body = _get(srv.port, path)
            doc = json.loads(body)
            out.append((path, s, doc["slo"], doc.get("status")))

    req.inc(100)
    for _ in range(100):
        lat.observe(5.0)
    clock.t += 30
    poll()
    sat["v"] = True
    req.inc(100)
    err.inc(50)
    for _ in range(50):
        lat.observe(5.0)
    clock.t += 30
    poll()
    sat["v"] = False
    clock.t += 300
    req.inc(200)
    for _ in range(200):
        lat.observe(5.0)
    clock.t += 30
    poll()
    clock.t += 61
    poll()
    return out


@pytest.mark.parametrize("ready_slo", [True, False], ids=["on", "off"])
def test_ready_and_stats_slo_over_http_equal_the_reference(trained,
                                                           ready_slo):
    servers = _servers(trained)
    sessions = {}
    try:
        for name, srv in servers.items():
            pkg = REF if name == "ref" else PORT
            pkg.obs.reset_observability()
            clock, sat = Tick(), {"v": False}
            srv.slo = pkg.slo.SLOEngine(
                pkg.slo.SLOConfig(fast_window_s=300.0, slow_window_s=3600.0,
                                  min_requests=10, recovery_s=60.0,
                                  ready_slo=ready_slo),
                clock=clock, saturation_fn=lambda s=sat: s["v"])
            srv.start()
            sessions[name] = _ready_session(srv, pkg, clock, sat)
    finally:
        for srv in servers.values():
            srv.stop()
    assert sessions["port"] == sessions["ref"]
    ready = [(s, st) for path, s, _, st in sessions["ref"]
             if path == "/ready"]
    if ready_slo:
        assert ready == [(200, "ready"), (503, "degraded"),
                         (503, "degraded"), (200, "ready")]
    else:
        assert {s for s, _ in ready} == {200}


def _wide_events(srv, log, users):
    os.environ["PIO_REQUEST_LOG"] = str(log)
    try:
        heads = [_post_query(srv.port, u)[1] for u in users]
        deadline = time.monotonic() + 10
        rows = []
        while time.monotonic() < deadline:
            if log.exists():
                rows = [json.loads(x) for x in log.read_text().splitlines()
                        if x.endswith("}")]
            if len(rows) >= len(users):
                break
            time.sleep(0.01)
    finally:
        os.environ.pop("PIO_REQUEST_LOG", None)
    return heads, rows


def _shape(row):
    """A wide event without its timings and ids."""
    return (sorted(row), sorted(row["stages"]), row["status"],
            row.get("generation"), row.get("rung"), row.get("cacheHit"),
            row.get("batchSize"))


@pytest.mark.parametrize("cache", ["0", "1"], ids=["dispatch", "cache_hit"])
def test_wide_events_carry_the_references_keys(trained, tmp_path,
                                               monkeypatch, cache):
    monkeypatch.setenv("PIO_RESULT_CACHE", cache)
    monkeypatch.setenv("PIO_QUALITY", "off")
    monkeypatch.setenv("PIO_RECALL", "off")
    users = ["u1", "u2", "u1"]
    servers = _servers(trained)
    shapes = {}
    try:
        for name, srv in servers.items():
            srv.start()
            heads, rows = _wide_events(srv, tmp_path / f"{name}.jsonl",
                                       users)
            by_id = {r["traceId"]: r for r in rows}
            shapes[name] = [_shape(by_id[h["X-Request-ID"]]) for h in heads]
            for h in heads:
                row = by_id[h["X-Request-ID"]]
                assert row["serverMs"] == pytest.approx(
                    float(h["X-PIO-Server-Ms"]), abs=0.06)
                assert all(v >= 0 for v in row["stages"].values())
    finally:
        for srv in servers.values():
            srv.stop()
    assert shapes["port"] == shapes["ref"]
    stages = shapes["ref"][-1][1]
    if cache == "1":
        assert "cache" in stages and "dispatch" not in stages
    else:
        assert {"ingress", "bind", "queue_wait", "batch_wait", "dispatch",
                "retrieval", "serialize", "shed_check"} <= set(stages)


def test_exemplar_resolves_to_one_request_tree(trained, monkeypatch):
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    srv = _servers(trained)["port"]
    srv.start()
    try:
        threads = [threading.Thread(target=_post_query,
                                    args=(srv.port, f"u{i % 12}"))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _, _, plain = _get(srv.port, "/metrics")
        assert b'pio_serve_stage_ms_bucket{stage="dispatch"' in plain
        assert b'trace_id="' not in plain
        _, _, text = _get(srv.port, "/metrics?exemplars=1")
        lines = [x for x in text.decode().splitlines()
                 if x.startswith('pio_serve_stage_ms_bucket{stage="dispatch"')
                 and 'trace_id="' in x]
        assert lines
        tid = lines[0].split('trace_id="', 1)[1].split('"', 1)[0]
        _, _, body = _get(srv.port, f"/traces.json?request_id={tid}")
        traces = json.loads(body)["traces"]
        assert len(traces) == 1 and traces[0]["traceId"] == tid
        assert traces[0]["name"] == "http.request"
        assert '"waterfall"' in json.dumps(traces[0])
    finally:
        srv.stop()
