"""The trace ring: the port's span trees, ``/traces.json`` and trace-ring
events against the JAX package's, on the CPU.

- One scripted session through both engine servers (the reference's
  trained generation carried into the port): queries on the batched and
  the inline path under client ``X-Request-ID`` s, a reload and a
  rollback.  The span trees in ``/traces.json`` are equal in names,
  nesting and attributes once durations, start times, batch ids and
  waits are masked; the reference's ``waterfall`` event (a later slice)
  is left out (the ring's order across requests is a race, so the trees
  are compared as sorted lists).  ``?request_id=``, ``?limit=`` and
  ``?min_ms=`` filter alike, and the port's native frontend answers
  ``/traces.json`` with the same filters.
- Both event servers answer ``/traces.json`` behind the access key, with
  the same trees for an ingest.
- The events the port now publishes (breaker, divergence, watchdog,
  fusion autotune, spill journal, feeder epoch, model eviction) are
  equal as published in both packages.
- ``run_train``'s ``workflow.train`` tree with its DASE phases and
  ``train.persist``; ``PIO_TRACE_FILE`` lines as the reference writes
  them.
- The profiler's state machine with fakes (the reference's admin cases
  without the HTTP layer) and ``run_train`` with ``profile_dir``.
"""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu_torch.obs as port_obs
from tests.test_torch_engine_server_scheduler import (  # noqa: F401
    call,
    serve,
    trained,
)
from tests.test_torch_event_server import both  # noqa: F401

ROOTS = ("predictionio_tpu", "predictionio_tpu_torch")
# Attributes whose values are wall-clock or random.
MASKED_ATTRS = {"batch_id", "queue_wait_ms", "dispatch_ms", "dir", "token",
                "trainS", "instance", "lastStep", "error"}


def mask(tree):
    """A recorded trace without what differs by run: durations, start
    times and the masked attributes; the reference's waterfall event (a
    later slice of the port) is dropped."""
    out = {"name": tree["name"]}
    attrs = {k: ("<m>" if k in MASKED_ATTRS else v)
             for k, v in tree.get("attrs", {}).items()}
    if attrs:
        out["attrs"] = attrs
    kids = [mask(c) for c in tree.get("spans", ())
            if c["name"] != "waterfall"]
    if kids:
        out["spans"] = kids
    return out


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture()
def rings():
    """A fresh trace ring in each package for the test; the previous
    ones are restored after."""
    made = []
    for root in ROOTS:
        trace = _mod(root, "obs.trace")
        rec = trace.TraceRecorder(64)
        made.append((trace, trace.set_recorder(rec)))
    yield [trace.get_recorder() for trace, _ in made]
    for trace, prev in made:
        trace.set_recorder(prev)


# -- the engine server --------------------------------------------------------

def _session(srv, prefix):
    """The scripted session; returns the /traces.json views."""
    for n, user in enumerate(("u1", "u2", "u3")):
        st, hdr, _ = call(srv, "POST", "/queries.json",
                          {"user": user, "num": 3},
                          headers={"X-Request-ID": f"{prefix}-q{n}"})
        assert st == 200 and hdr["X-Request-ID"] == f"{prefix}-q{n}"
    assert call(srv, "POST", "/reload",
                headers={"X-Request-ID": f"{prefix}-reload"})[0] == 200
    assert call(srv, "POST", "/admin/rollback",
                headers={"X-Request-ID": f"{prefix}-rb"})[0] == 200
    views = {}
    for name, qs in (("one", f"?request_id={prefix}-q1"),
                     ("limit", "?limit=2"), ("slow", "?min_ms=1e9"),
                     ("all", "?limit=200")):
        st, _, body = call(srv, "GET", "/traces.json" + qs)
        assert st == 200
        views[name] = body["traces"]
    return views


@pytest.mark.parametrize("enabled", [True, False], ids=["batched", "inline"])
def test_engine_server_span_trees_equal_the_reference(serve, rings,
                                                      enabled):
    ref, port = serve(enabled=enabled)
    got = {}
    for name, srv in (("ref", ref), ("port", port)):
        views = _session(srv, "r")
        assert [t["traceId"] for t in views["one"]] == ["r-q1"]
        assert views["slow"] == []
        assert len(views["limit"]) == 2
        # A handler records its trace after writing the answer, so the
        # ring's order across requests is a race: compare as sorted.
        got[name] = {k: sorted((mask(t) for t in views[k]),
                               key=lambda t: json.dumps(t, sort_keys=True))
                     for k in ("one", "all")}
    assert got["port"] == got["ref"]
    [q1] = got["port"]["one"]
    names = [s["name"] for s in q1["spans"]]
    assert names == ["http.read", "http.handle", "http.respond"]
    handle = q1["spans"][1]
    if enabled:
        # The batcher's own root trace carries the retrieval; the request
        # carries the batcher.dispatch event.
        assert handle["spans"][0]["name"] == "batcher.dispatch"
        roots = [t for t in got["port"]["all"]
                 if t["name"] == "batcher.dispatch"]
        assert roots and roots[0]["spans"][0]["name"] == "retrieval"
    else:
        # On the caller's thread the dispatch trace nests as a span, and
        # the member's event follows it.
        dispatch, event = handle["spans"]
        assert dispatch["name"] == event["name"] == "batcher.dispatch"
        assert "spans" not in event
        assert dispatch["spans"][0]["name"] == "retrieval"
        assert dispatch["spans"][0]["attrs"]["rung"]
    reload = [t for t in got["port"]["all"]
              if t["attrs"].get("path") == "/reload"]
    assert any(s["name"] == "model.reload"
               for s in reload[0]["spans"][1]["spans"])


def test_the_native_fallback_serves_traces_with_their_filters(serve, rings):
    """``pio deploy --native`` hands ``/traces.json`` (query string
    included) to ``EngineServer.handle``: the filters apply there too."""
    from urllib.parse import parse_qs, urlparse

    _, port = serve()
    call(port, "POST", "/queries.json", {"user": "u1", "num": 3},
         headers={"X-Request-ID": "nat-1"})
    parsed = urlparse("/traces.json?request_id=nat-1")
    st, body = port.handle("GET", parsed.path, b"", parse_qs(parsed.query))
    assert st == 200 and [t["traceId"] for t in body["traces"]] == ["nat-1"]


@pytest.mark.parametrize("qs", ["", "?format=summary", "?format=chrome"])
def test_timeline_json_answers_as_the_reference(serve, qs):
    """``GET /timeline.json`` over an empty step timeline: the same
    views in both packages."""
    ref, port = serve()
    for obs in (ref_obs, port_obs):
        obs.get_timeline().clear()   # other files' trains fill it
    got = [call(srv, "GET", "/timeline.json" + qs)[::2] for srv in
           (ref, port)]
    assert got[1] == got[0] and got[0][0] == 200


def test_event_servers_serve_traces_behind_the_access_key(rings, both):
    from tests.test_torch_event_server import KEY_ALL
    from tests.test_torch_event_server import call as es_call

    got = []
    for st in both:
        port = st.srv.port
        assert es_call(port, "GET", "/traces.json")[0] == 401
        code, _, _ = es_call(
            port, "POST", f"/events.json?accessKey={KEY_ALL}",
            {"event": "view", "entityType": "user", "entityId": "u1",
             "targetEntityType": "item", "targetEntityId": "i1"},
            headers={"X-Request-ID": "ing-1"})
        assert code == 201
        code, _, body = es_call(
            port, "GET", f"/traces.json?accessKey={KEY_ALL}&request_id=ing-1")
        assert code == 200
        got.append([mask(t) for t in body["traces"]])
    assert got[1] == got[0] and got[0][0]["attrs"]["server"] == "event"


# -- trace-ring events --------------------------------------------------------

def _breaker(root):
    pol = _mod(root, "resilience.policy")
    now = [0.0]
    b = pol.CircuitBreaker("store", failure_threshold=2, recovery_time_s=5,
                           clock=lambda: now[0],
                           failure_types=(ConnectionError,))

    def fail():
        raise ConnectionError("down")

    for _ in range(2):
        with pytest.raises(ConnectionError):
            b.call(fail)
    now[0] = 10.0
    b.call(lambda: 1)


def _diverged(root):
    sup = _mod(root, "resilience.supervision")
    g = sup.DivergenceGuard("als", max_rollbacks=1)
    with pytest.raises(sup.RollbackRequested):
        g.diverged(3, "non-finite factors")
    with pytest.raises(sup.TrainDiverged):
        g.diverged(5, "non-finite factors")


def _watchdog(root):
    sup = _mod(root, "resilience.supervision")
    now = [0.0]
    wd = sup.StepWatchdog("two_tower", timeout_s=2.0, kill_grace_s=3.0,
                          clock=lambda: now[0], abort_fn=lambda: None,
                          kill_fn=lambda: None, poll_interval_s=0)
    wd.arm(7)
    now[0] = 2.5
    assert wd.poll()
    now[0] = 6.0
    assert wd.poll()


def _fusion(root):
    fu = _mod(root, "data.fusion")
    verdicts = iter([False, False, True])
    tuner = fu.FusionAutotuner(
        "dlrm", fu.FusionPlan(1, 1),
        sampler=SimpleNamespace(headroom_exceeded=lambda: next(verdicts)),
        round_windows=1, max_fuse_steps=8, batch_scale=False)
    for _ in range(3):
        tuner.on_window()


def _spill(root, tmp):
    sp = _mod(root, "resilience.spill")
    j = sp.SpillJournal(tmp / root / "spill")
    ev = {"event": "view", "entityType": "user", "entityId": "u1"}
    j.append([ev, ev], 1, None, token="t1")
    j.append([ev], 1, None, token="t2")
    first, second = j.peek(2)
    j.mark_replayed([first])
    j.dead_letter(second, "bad record")
    j.requeue_dead()
    j.close()


@pytest.mark.parametrize("producer", [_breaker, _diverged, _watchdog,
                                      _fusion, _spill])
def test_events_are_published_as_the_reference_publishes_them(
        rings, tmp_path, producer, monkeypatch):
    for k in ("PIO_FUSE_STEPS_MAX", "PIO_BATCH_AUTOSCALE"):
        monkeypatch.delenv(k, raising=False)
    got = []
    for root, ring in zip(ROOTS, rings):
        if producer is _spill:
            producer(root, tmp_path)
        else:
            producer(root)
        got.append([mask(t) for t in ring.recent(64)[::-1]])
    assert got[1] == got[0] and got[0]
    for t in got[1]:
        assert "spans" not in t         # standalone single-span traces


def test_feeder_epoch_event_as_the_reference(rings, tmp_path):
    from predictionio_tpu.native import feeder as ref_feeder
    from predictionio_tpu_torch.native import feeder as port_feeder

    rng = np.random.default_rng(0)
    users = rng.integers(0, 50, 300).astype(np.uint32)
    items = rng.integers(0, 40, 300).astype(np.uint32)
    vals = rng.random(300).astype(np.float32)
    got = []
    for mod, ring in zip((ref_feeder, port_feeder), rings):
        path = tmp_path / f"{mod.__name__}.bin"
        mod.write_cache(path, users, items, vals)
        with mod.EventFeeder(path, 128, seed=1) as f:
            for _ in f.epoch():
                pass
        got.append([mask(t) for t in ring.recent(64)[::-1]])
    assert got[1] == got[0]
    assert got[0][0]["name"] == "feeder.epoch"


def test_a_previous_generation_eviction_is_published(serve, rings):
    ref, port = serve()
    got = []
    for srv, ring in zip((ref, port), rings):
        assert call(srv, "POST", "/reload")[0] == 200
        assert srv._evict_previous(srv._generation)
        got.append([mask(t) for t in ring.recent(5)
                    if t["name"] == "model.previous_evicted"])
    assert got[1] == got[0] and len(got[0]) == 1


def test_publish_event_attaches_inside_a_trace():
    rec = port_obs.TraceRecorder(8)
    with port_obs.trace("outer", recorder=rec) as root:
        port_obs.publish_event("inner.event", n=1)
    assert [c.name for c in root.children] == ["inner.event"]
    [doc] = rec.recent()
    assert doc["spans"][0]["attrs"] == {"n": 1}


# -- the workflow's train trace and the JSONL export --------------------------

def test_run_train_trace_and_trace_file_equal_the_reference(tmp_path,
                                                            monkeypatch,
                                                            rings):
    """The same events through both packages' ``run_train`` (MEMORY
    storage, rank 4): the ``workflow.train`` trees are equal after
    masking, and each package's ``PIO_TRACE_FILE`` holds that tree as
    its one line."""
    from tests.test_torch_engine_server_scheduler import VARIANT, \
        PORT_VARIANT

    got = []
    for root, ring, variant in zip(ROOTS, rings, (VARIANT, PORT_VARIANT)):
        cfg = _mod(root, "config")
        st = _mod(root, "data.storage")
        ev = _mod(root, "data.event")
        ctl = _mod(root, "controller")
        wf = _mod(root, "workflow.core_workflow")
        tpl = _mod(root, "templates.recommendation")
        trace_file = tmp_path / f"{root}.jsonl"
        monkeypatch.setenv("PIO_TRACE_FILE", str(trace_file))
        storage = st.Storage(cfg.load_config(env={
            "PIO_HOME": str(tmp_path / root),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEMORY"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}}))
        app_id = storage.get_apps().insert(st.App(id=None,
                                                  name="schedparity"))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch([
            ev.Event(event="rate", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     properties=ev.DataMap({"rating": 1.0 + (u + i) % 5}))
            for u in range(12) for i in range(9) if (u * i) % 4 != 1],
            app_id)
        kw = {"device": "cpu"} if root.endswith("torch") else {}
        ctx = ctl.RuntimeContext.create(storage=storage, **kw)
        wf.run_train(tpl.engine(), ctl.EngineVariant.from_dict(variant), ctx)
        [tree] = [t for t in ring.recent(64) if t["name"] == "workflow.train"]
        [line] = trace_file.read_text().splitlines()
        assert json.loads(line) == tree
        tree["attrs"].pop("engine_factory")
        got.append(mask(tree))
    assert got[1] == got[0]
    assert [s["name"] for s in got[1]["spans"]] == [
        "train.datasource", "train.prepare", "train.algorithm",
        "train.persist"]


def test_slow_traces_log_a_warning(caplog):
    rec = port_obs.TraceRecorder(4)
    with caplog.at_level("WARNING", logger="predictionio_tpu_torch.obs.trace"):
        with port_obs.trace("http.request", trace_id="slow-1", slow_ms=1e-9,
                            recorder=rec):
            pass
    assert "slow http.request" in caplog.text and "slow-1" in caplog.text


def test_hostile_request_ids_are_sanitized_as_the_reference():
    for raw in ("ok-1", "a b\nc", "x" * 300, "\n\n", "", None):
        assert port_obs.sanitize_trace_id(raw) == \
            ref_obs.sanitize_trace_id(raw)


# -- the profiler ------------------------------------------------------------

class _NoopTimer:
    def __init__(self, *a, **k):
        self.daemon = False

    def start(self):
        pass

    def cancel(self):
        pass


@pytest.fixture()
def fake_profiler():
    from predictionio_tpu_torch.obs import profiler as prof

    calls = {"started": [], "stopped": 0, "fail": None}

    def start_fn(path):
        if calls["fail"] is not None:
            raise calls["fail"]
        calls["started"].append(path)

    def stop_fn():
        calls["stopped"] += 1

    session = prof.ProfilerSession(start_fn=start_fn, stop_fn=stop_fn,
                                   timer_factory=_NoopTimer)
    prev = prof.set_profiler(session)
    yield calls
    prof.set_profiler(prev)


def test_profile_unavailable_arms_nothing(fake_profiler):
    from predictionio_tpu_torch.obs.profiler import (
        ProfilerUnavailable,
        get_profiler,
    )

    fake_profiler["fail"] = ProfilerUnavailable("no profiler here")
    with pytest.raises(ProfilerUnavailable):
        get_profiler().start(50)
    assert fake_profiler["started"] == []
    assert get_profiler().status()["active"] is False


def test_profile_capture_roundtrip_and_busy(fake_profiler, tmp_path):
    from predictionio_tpu_torch.obs.profiler import (
        MAX_CAPTURE_MS,
        ProfilerBusy,
        get_profiler,
    )

    out = str(tmp_path / "prof")
    info = get_profiler().start(10 ** 9, out)
    assert info == {"path": out, "durationMs": MAX_CAPTURE_MS}
    assert fake_profiler["started"] == [out]
    assert get_profiler().status()["active"] is True
    with pytest.raises(ProfilerBusy):
        get_profiler().start(1000)
    assert len(fake_profiler["started"]) == 1
    assert get_profiler().stop() == out
    assert fake_profiler["stopped"] == 1
    assert get_profiler().status() == {"active": False, "lastPath": out}
    assert get_profiler().stop() is None


@pytest.mark.parametrize("bad", ["abc", "-5", "0"])
def test_profile_rejects_bad_duration(fake_profiler, bad):
    from predictionio_tpu_torch.obs.profiler import get_profiler

    with pytest.raises(ValueError):
        get_profiler().start(bad)
    assert fake_profiler["started"] == []


@pytest.mark.parametrize("how", ["env", "workflow_param"])
def test_run_train_is_captured_between_start_and_stop(fake_profiler,
                                                      tmp_path, monkeypatch,
                                                      how):
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import (
        EngineVariant,
        RuntimeContext,
    )
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.obs.profiler import get_profiler
    from predictionio_tpu_torch.templates.recommendation import engine
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from tests.test_torch_engine_server_scheduler import PORT_VARIANT

    out = str(tmp_path / "trace")
    monkeypatch.delenv("PIO_PROFILE_DIR", raising=False)
    kw = {}
    if how == "env":
        monkeypatch.setenv("PIO_PROFILE_DIR", out)
    else:
        kw["profile_dir"] = out
    storage = Storage(memory_config(tmp_path / "home"))
    app_id = storage.get_apps().insert(App(id=None, name="schedparity"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{u % 5}",
              properties=DataMap({"rating": 3.0})) for u in range(10)],
        app_id)
    seen = []
    import predictionio_tpu_torch.models.als as als

    real = als.train_als

    def spy(*a, **k):
        seen.append((list(fake_profiler["started"]),
                     fake_profiler["stopped"]))
        return real(*a, **k)

    monkeypatch.setattr(als, "train_als", spy)
    ctx = RuntimeContext.create(storage=storage, device="cpu", **kw)
    run_train(engine(), EngineVariant.from_dict(PORT_VARIANT), ctx)
    assert seen == [([out], 0)]           # inside the capture
    assert fake_profiler["stopped"] == 1
    assert get_profiler().status() == {"active": False, "lastPath": out}


def test_the_default_backend_writes_a_chrome_trace(tmp_path):
    """The real ``torch.profiler`` on the CPU: the capture directory gets
    ``trace.json`` with the captured operators."""
    import torch

    from predictionio_tpu_torch.obs.profiler import (
        TRACE_FILE,
        ProfilerSession,
    )

    session = ProfilerSession(timer_factory=_NoopTimer)
    out = tmp_path / "cpu_trace"
    session.capture_call(str(out), lambda: torch.ones(64, 64) @ torch.ones(
        64, 64))
    doc = json.loads((out / TRACE_FILE).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in (n or "") for n in names)
