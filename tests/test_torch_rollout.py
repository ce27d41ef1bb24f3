"""The port's wave rollout against the reference's, on the CPU.

``parse_waves``, ``RolloutConfig.from_env`` and ``rollout_state_path``
must give equal results over a grid.  Then the six scenarios of the
reference's ``tests/test_fleet.py::TestRolloutE2E`` run twice: on three
(or two) of the reference's engine servers under ``JAX_PLATFORMS=cpu``
and on as many of the port's with ``device="cpu"``, each package
training the same two generations of a tiny ALS engine on the same
events in its own in-memory store.  The controller's clock and sleep are
one fake clock (a poll advances it by ``poll_s``), so both packages bake
through the same number of polls.  The journals and summaries must be
equal once ``rolloutId``, the time stamps, the base URLs (relabelled by
position) and the engine instance ids (relabelled by generation) are
masked; the reference test's own assertions hold on the port's run.
"""

import json
import os
import threading
from types import SimpleNamespace
from urllib.request import urlopen

import numpy as np
import pytest

import predictionio_tpu.fleet.rollout as ref_rollout
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.fleet as ref_fleet
import predictionio_tpu.refresh as ref_refresh
import predictionio_tpu.refresh.daemon as ref_daemon
import predictionio_tpu.server.engine_server as ref_es
import predictionio_tpu.workflow.core_workflow as ref_wf
import predictionio_tpu_torch.fleet.rollout as port_rollout
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.fleet as port_fleet
import predictionio_tpu_torch.refresh as port_refresh
import predictionio_tpu_torch.refresh.daemon as port_daemon
import predictionio_tpu_torch.server.engine_server as port_es
import predictionio_tpu_torch.workflow.core_workflow as port_wf
from predictionio_tpu.controller import EngineVariant as JaxVariant
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.templates.recommendation import engine as jax_engine
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.controller import EngineVariant
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.templates.recommendation import engine

APP = "rolloutparity"
N_USERS, N_ITEMS = 12, 8
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine",
    "datasource": {"params": {"appName": APP}},
    "algorithms": [{"name": "als",
                    "params": {"rank": 4, "numIterations": 2,
                               "lambda_": 0.05, "seed": 3}}],
}
PORT_VARIANT = {**VARIANT, "engineFactory":
                "predictionio_tpu_torch.templates.recommendation:engine"}
_ENV = ("PIO_ROLLOUT_WAVES", "PIO_ROLLOUT_BAKE_S", "PIO_ROLLOUT_POLL_S",
        "PIO_ROLLOUT_STATE", "PIO_ROLLOUT_RELOAD_TIMEOUT_S",
        "PIO_SLO_BURN_THRESHOLD", "PIO_RESULT_CACHE", "PIO_CANARY_QUERIES",
        "PIO_RETAIN_PREVIOUS", "PIO_FLEET_INSTANCES", "PIO_FAULTS",
        "PIO_REFRESH_PROMOTE_URL", "PIO_RETRIEVAL_RUNG")
# The journal's own stamps and id, masked before the comparison.
_STAMPS = ("startedAt", "updatedAt", "finishedAt")


def _ratings():
    rng = np.random.default_rng(0)
    return [(f"u{u}", f"i{i}", float(3 + 2 * rng.random()))
            for u in range(N_USERS) for i in range(N_ITEMS)
            if i % 2 == u % 2]


def _more_ratings(generation):
    """The events that land before a generation's train, so that the
    generations differ."""
    return [(f"u{u}", f"i{(u + generation) % N_ITEMS}", 1.0 + generation)
            for u in range(generation, N_USERS, 3)]


def _ref_stack():
    reset_storage()
    ref_obs.reset_observability()
    ctx = JaxContext.create(storage=jax_storage())
    app_id = ctx.storage.get_apps().insert(JaxApp(id=None, name=APP))
    ctx.storage.get_events().init(app_id)

    def add(rows):
        ctx.storage.get_events().insert_batch([
            JaxEvent(event="rate", entity_type="user", entity_id=u,
                     target_entity_type="item", target_entity_id=i,
                     properties=JaxDataMap({"rating": r}))
            for u, i, r in rows], app_id)

    add(_ratings())
    eng, variant = jax_engine(), JaxVariant.from_dict(VARIANT)
    return SimpleNamespace(
        name="reference", rollout=ref_rollout, fleet=ref_fleet,
        refresh=ref_refresh, daemon=ref_daemon, wf=ref_wf, eng=eng,
        variant=variant, ctx=ctx, add=add,
        server=lambda: ref_es.EngineServer(
            eng, variant, ctx.storage, host="127.0.0.1", port=0))


def _port_stack(home):
    port_obs.reset_observability()
    storage = Storage(memory_config(home))
    app_id = storage.get_apps().insert(App(id=None, name=APP))
    storage.get_events().init(app_id)

    def add(rows):
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=DataMap({"rating": r}))
            for u, i, r in rows], app_id)

    add(_ratings())
    eng, variant = engine(), EngineVariant.from_dict(PORT_VARIANT)
    ctx = port_wf.RuntimeContext.create(storage=storage, device="cpu")
    return SimpleNamespace(
        name="port", rollout=port_rollout, fleet=port_fleet,
        refresh=port_refresh, daemon=port_daemon, wf=port_wf, eng=eng,
        variant=variant, ctx=ctx, add=add,
        server=lambda: port_es.EngineServer(
            eng, variant, storage, host="127.0.0.1", port=0, device="cpu"))


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_") or k in _ENV:
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    yield tmp_path
    reset_storage()


class FakeClock:
    """The controller's clock and sleep: a sleep advances the clock."""

    def __init__(self):
        self.t = 1000.0
        self.sleeps = 0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps += 1
        self.t += s


def _cfg(pkg, path, **kw):
    kw.setdefault("waves", "1,100%")
    kw.setdefault("bake_s", 0.06)
    kw.setdefault("poll_s", 0.02)
    kw.setdefault("state_path", str(path))
    return pkg.rollout.RolloutConfig(**kw)


def mask(obj, labels):
    """rolloutId and stamps → placeholders; URLs and instance ids → their
    labels, in keys and in strings."""
    if isinstance(obj, dict):
        return {mask(k, labels): ("<t>" if k in _STAMPS and v is not None
                                  else "<id>" if k == "rolloutId"
                                  else mask(v, labels))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask(v, labels) for v in obj]
    if isinstance(obj, str):
        for raw, label in sorted(labels.items(), key=lambda kv: -len(kv[0])):
            obj = obj.replace(raw, label)
        return obj
    return obj


def _fleet(pkg, n):
    servers = [pkg.server() for _ in range(n)]
    for s in servers:
        s.start()
    return servers, [f"http://127.0.0.1:{s.port}" for s in servers]


def _served(pkg, urls):
    ctl = pkg.rollout.RolloutController(urls, _cfg(pkg, "/dev/null"))
    return [ctl.served_instance(u) for u in urls]


# -- the six scenarios, each run on one package ------------------------------
# Each returns (documents to compare, labels) after asserting the
# reference test's own checks.

def scenario_whole_fleet(pkg, tmp, clock):
    i1 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 3)
    i2 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    try:
        ctl = pkg.rollout.RolloutController(
            urls, _cfg(pkg, tmp / "rollout.json"), clock=clock,
            sleep=clock.sleep)
        state = ctl.run()
        assert state["status"] == "promoted" and state["target"] == i2
        assert state["waveCounts"] == [1, 3]
        assert _served(pkg, urls) == [i2] * 3
        saved = json.loads((tmp / "rollout.json").read_text())
        assert saved["status"] == "promoted"
        assert saved["preRollout"][urls[0]] == i1
        return [state, saved], urls, [i1, i2]
    finally:
        for s in servers:
            s.stop()


def scenario_halt_on_canary_burn(pkg, tmp, clock):
    i1 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 3)
    i2 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    promoted_urls = []

    def fetch(url):
        base = url.rsplit("/", 1)[0]
        with urlopen(url, timeout=10) as r:
            text = r.read().decode()
        if url.endswith("/stats.json") and base in promoted_urls:
            doc = json.loads(text)
            doc.setdefault("slo", {})["degraded"] = True
            return json.dumps(doc)
        return text

    class Ctl(pkg.rollout.RolloutController):
        def _promote_instance(self, url, target):
            out = super()._promote_instance(url, target)
            if out[0] == "ok":
                promoted_urls.append(url)
            return out

    try:
        ctl = Ctl(urls, _cfg(pkg, tmp / "rollout.json"),
                  aggregator=pkg.fleet.FleetAggregator(urls, fetch=fetch),
                  clock=clock, sleep=clock.sleep)
        state = ctl.run(i2)
        assert state["status"] == "rolled_back"
        assert state["promoted"] == state["rolledBack"] == [urls[0]]
        assert "slo burn" in state["haltReason"]
        assert _served(pkg, urls) == [i1] * 3
        assert state["postRollback"] == {u: i1 for u in urls}
        return [state], urls, [i1, i2]
    finally:
        for s in servers:
            s.stop()


def scenario_dead_instance_and_409(pkg, tmp, clock):
    i1 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 2)
    i2 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    dead = "http://127.0.0.1:9"        # the discard port: never connects
    try:
        ctl = pkg.rollout.RolloutController(
            urls + [dead], _cfg(pkg, tmp / "rollout.json", waves="100%",
                                reload_timeout_s=5.0),
            clock=clock, sleep=clock.sleep)
        state = ctl.run(i2)
        assert state["status"] == "promoted"
        assert sorted(state["promoted"]) == sorted(urls)
        assert "unreachable" in state["skipped"][dead]
        state2 = ctl.run("no-such-instance")
        assert state2["status"] == "failed"
        assert all("rejected" in v for u, v in state2["skipped"].items()
                   if u != dead)
        assert _served(pkg, urls) == [i2] * 2
        return [state, state2], urls, [i1, i2]
    finally:
        for s in servers:
            s.stop()


class Preempted(RuntimeError):
    pass


def _dies_after_wave1(pkg):
    class DiesAfterWave1(pkg.rollout.RolloutController):
        def _bake(self, state):
            raise Preempted()      # killed mid-bake, the journal on disk
    return DiesAfterWave1


def scenario_resume(pkg, tmp, clock):
    i1 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 3)
    i2 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    try:
        with pytest.raises(Preempted):
            _dies_after_wave1(pkg)(
                urls, _cfg(pkg, tmp / "rollout.json"), clock=clock,
                sleep=clock.sleep).run(i2)
        saved = json.loads((tmp / "rollout.json").read_text())
        assert saved["status"] == "in_progress"
        assert saved["promoted"] == [urls[0]]
        reload_counts = {}

        class Counting(pkg.rollout.RolloutController):
            def _promote_instance(self, url, target):
                reload_counts[url] = reload_counts.get(url, 0) + 1
                return super()._promote_instance(url, target)

        state = Counting(urls, _cfg(pkg, tmp / "rollout.json"),
                         clock=clock, sleep=clock.sleep).resume()
        assert state["status"] == "promoted"
        assert urls[0] not in reload_counts            # not re-promoted
        assert _served(pkg, urls) == [i2] * 3
        return [saved, state, reload_counts], urls, [i1, i2]
    finally:
        for s in servers:
            s.stop()


def scenario_unwind(pkg, tmp, clock):
    i1 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 3)
    i2 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    try:
        with pytest.raises(Preempted):
            _dies_after_wave1(pkg)(
                urls, _cfg(pkg, tmp / "rollout.json"), clock=clock,
                sleep=clock.sleep).run(i2)
        state = pkg.rollout.RolloutController(
            urls, _cfg(pkg, tmp / "rollout.json"), clock=clock,
            sleep=clock.sleep).resume(unwind=True)
        assert state["status"] == "rolled_back"
        assert _served(pkg, urls) == [i1] * 3
        return [state], urls, [i1, i2]
    finally:
        for s in servers:
            s.stop()


def scenario_fleet_promoter(pkg, tmp, clock):
    i1 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 2)
    pkg.add(_more_ratings(1))
    try:
        d = pkg.daemon.RefreshDaemon(
            pkg.eng, pkg.variant, pkg.ctx,
            config=pkg.refresh.RefreshConfig(interval_s=0.01,
                                             promote_url=",".join(urls)))
        assert isinstance(d.promoter, pkg.rollout.FleetPromoter)
        cfg = _cfg(pkg, tmp / "rollout.json")
        d.promoter.config = cfg
        d.promoter.canary_window_s = 0.2
        d.promoter._factory = lambda: pkg.rollout.RolloutController(
            urls, cfg, clock=clock, sleep=clock.sleep)
        out = d.run_once()
        assert out["promotion"] == "promoted"
        i2 = out["instance"]
        assert _served(pkg, urls) == [i2] * 2
        # the staleness anchor: the oldest served watermark
        wm = d.promoter.served_watermark()
        assert wm is not None
        out = {k: v for k, v in out.items() if k != "trainS"}
        saved = json.loads((tmp / "rollout.json").read_text())
        return [out, saved], urls, [i1, i2]
    finally:
        for s in servers:
            s.stop()


SCENARIOS = {
    "wave_promotes_whole_fleet": scenario_whole_fleet,
    "halt_on_canary_burn_rolls_back": scenario_halt_on_canary_burn,
    "dead_instance_and_409_skip": scenario_dead_instance_and_409,
    "preempted_controller_resumes": scenario_resume,
    "preempted_controller_unwinds": scenario_unwind,
    "fleet_promoter_drives_the_daemon": scenario_fleet_promoter,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rollout_scenario_matches_the_reference(env, name):
    """Journals and summaries equal once masked; the polls the fake clock
    counted equal too (the same bake in both)."""
    runs = {}
    for label, make in (("reference", _ref_stack),
                        ("port", lambda: _port_stack(env / "port"))):
        pkg = make()
        tmp = env / label
        tmp.mkdir()
        clock = FakeClock()
        docs, urls, ids = SCENARIOS[name](pkg, tmp, clock)
        labels = {u: f"<U{n}>" for n, u in enumerate(urls)}
        labels.update({iid: f"<G{n + 1}>" for n, iid in enumerate(ids)})
        runs[label] = (mask(docs, labels), clock.sleeps)
    assert runs["port"] == runs["reference"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 13])
def test_parse_waves_equals_the_reference(n):
    specs = ("1,25%,100%", "2,50%", "1", "3,1,2,100%", "99", "", " , ",
             "1,1,1", "100%", "33%,66%", "0", "150%", "abc", "-1", "0%",
             "2.5", "1,x")
    for spec in specs:
        got = want = None
        try:
            want = ref_rollout.parse_waves(spec, n)
        except ValueError as e:
            want = ("ValueError", str(e))
        try:
            got = port_rollout.parse_waves(spec, n)
        except ValueError as e:
            got = ("ValueError", str(e))
        assert got == want, spec


def test_rollout_config_and_state_path_equal_the_reference(env,
                                                          monkeypatch):
    import dataclasses

    assert dataclasses.asdict(port_rollout.RolloutConfig()) == \
        dataclasses.asdict(ref_rollout.RolloutConfig())
    assert port_rollout.rollout_state_path() == \
        ref_rollout.rollout_state_path()
    assert str(port_rollout.rollout_state_path()).endswith(
        "rollout/state.json")
    for k, v in (("PIO_ROLLOUT_WAVES", "2,50%"), ("PIO_ROLLOUT_BAKE_S", "3"),
                 ("PIO_ROLLOUT_POLL_S", "bad"), ("PIO_SLO_BURN_THRESHOLD",
                                                 "6"),
                 ("PIO_ROLLOUT_RELOAD_TIMEOUT_S", "9"),
                 ("PIO_ROLLOUT_STATE", str(env / "s.json"))):
        monkeypatch.setenv(k, v)
    for overrides in ({}, {"bake_s": 0.5, "waves": None}):
        assert dataclasses.asdict(
            port_rollout.RolloutConfig.from_env(**overrides)) == \
            dataclasses.asdict(ref_rollout.RolloutConfig.from_env(
                **overrides))
    assert port_rollout.rollout_state_path() == env / "s.json" == \
        ref_rollout.rollout_state_path()
    assert port_rollout.rollout_state_path("x.json") == \
        ref_rollout.rollout_state_path("x.json")


def test_rollout_publishes_the_reference_events(env):
    """rollout.start / promoted / finished reach the port's trace ring
    with the reference's names and attributes."""
    pkg = _port_stack(env / "port")
    pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 2)
    i2 = pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    clock = FakeClock()
    try:
        state = port_rollout.RolloutController(
            urls, _cfg(pkg, env / "r.json"), clock=clock,
            sleep=clock.sleep).run(i2)
    finally:
        for s in servers:
            s.stop()
    assert state["status"] == "promoted"
    names = [t["name"] for t in port_obs.get_recorder().recent(256)
             if t["name"].startswith("rollout.")]
    assert sorted(set(names)) == ["rollout.finished", "rollout.promoted",
                                  "rollout.start"]
    assert names.count("rollout.promoted") == 2
    reg = port_obs.get_registry()
    assert reg.get("pio_rollout_total").value(result="promoted") == 1
    assert reg.get("pio_rollout_waves_total").value(result="ok") == 2
    assert reg.get("pio_rollout_wave").value() == -1


def test_concurrent_gate_scrapes_do_not_block(env):
    """The fleet gate scrapes every instance concurrently: a dead
    instance costs one timeout a pass, never one a row, and never trips
    the gate (it reads stale)."""
    pkg = _port_stack(env / "port")
    pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    servers, urls = _fleet(pkg, 2)
    seen = []
    lock = threading.Lock()

    def fetch(url):
        with lock:
            seen.append(url)
        if url.startswith("http://127.0.0.1:9/"):
            raise OSError("connection refused")
        with urlopen(url, timeout=10) as r:
            return r.read().decode()

    try:
        ctl = port_rollout.RolloutController(
            urls + ["http://127.0.0.1:9"], _cfg(pkg, env / "r.json"),
            aggregator=port_fleet.FleetAggregator(
                urls + ["http://127.0.0.1:9"], fetch=fetch))
        assert ctl.fleet_tripped() == (False, None)
    finally:
        for s in servers:
            s.stop()
    assert sum(u.endswith("/metrics") for u in seen) == 3
