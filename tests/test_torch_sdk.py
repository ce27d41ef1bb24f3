"""The port's SDK against the reference's, crossed with both servers.

Each client (``predictionio_tpu.sdk`` and ``predictionio_tpu_torch.sdk``)
runs one script against each event server (the reference's and the
port's), each server over its own sqlite home: single events, a batch
with a client token and its retry, per-item errors, get, find, delete,
the convenience wrappers, the error surface (401, a 503 retried through
``RetryPolicy`` after ``Retry-After``, a refused connection, a spent
deadline).  All four runs must give the same results once the random
event ids are masked.  ``EngineClient`` of both packages then queries
the port's engine server and gets the same answers.
"""

import json
import os
import socket
from types import SimpleNamespace

import numpy as np
import pytest

import predictionio_tpu.config as ref_config
import predictionio_tpu.data.storage as ref_storage
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.resilience.faults as ref_faults
import predictionio_tpu.sdk as ref_sdk
import predictionio_tpu.server.event_server as ref_es
import predictionio_tpu_torch.config as port_config
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.resilience.faults as port_faults
import predictionio_tpu_torch.sdk as port_sdk
import predictionio_tpu_torch.server.event_server as port_es

SERVERS = {
    "ref": SimpleNamespace(config=ref_config, storage=ref_storage, es=ref_es,
                           faults=ref_faults,
                           reset_metrics=ref_obs.reset_observability),
    "port": SimpleNamespace(config=port_config, storage=port_storage,
                            es=port_es, faults=port_faults,
                            reset_metrics=lambda:
                            port_obs.get_registry().reset()),
}
CLIENTS = {"ref": ref_sdk, "port": port_sdk}


@pytest.fixture()
def servers(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "env_home"))
    monkeypatch.delenv("PIO_SEGMENTS", raising=False)
    monkeypatch.setenv("PIO_RETRY_AFTER_S", "0")
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_FAULTS", "PIO_SPILL",
                         "PIO_INGEST", "PIO_EVENTSERVER_PLUGINS")):
            monkeypatch.delenv(k, raising=False)
    out = {}
    for name, pkg in SERVERS.items():
        pkg.reset_metrics()
        home = tmp_path / name
        storage = pkg.storage.Storage(pkg.config.load_config(
            env={"PIO_HOME": str(home)}))
        out[name] = SimpleNamespace(pkg=pkg, storage=storage, home=home,
                                    srv=None)
    yield out
    for st in out.values():
        if st.srv is not None:
            st.srv.stop()
        st.pkg.faults.clear()
        st.storage.close()


def fresh_app(st, name):
    """A new app with its key; (app_id, key)."""
    s = st.pkg.storage
    app_id = st.storage.get_apps().insert(s.App(id=None, name=name))
    st.storage.get_events().init(app_id)
    key = f"key-{name}"
    st.storage.get_access_keys().insert(s.AccessKey(key=key, app_id=app_id))
    return app_id, key


def _result(r):
    """An EventResult as (value, event_id, token, status, stored) with
    random ids masked and the app's token prefix cut from derived ones."""
    rid = r.event_id
    if rid is not None:
        rid = rid.split("-", 1)[1] if rid.startswith("bt") and "." in rid \
            else "<id>"
    return (rid if r.event_id is not None and str(r) == r.event_id
            else str(r) and "<value>", rid, r.token and "<token>", r.status,
            r.stored)


def _err(e):
    return ("error", type(e).__name__, e.status, e.retriable,
            e.retry_after_s)


def script(sdk, st, url, app_name):
    """One client script against one server; returns what it saw.
    Batch tokens name the app: a token-derived id is the row's primary
    key in the whole store, in both packages."""
    _, key = fresh_app(st, app_name)
    t1, t2 = f"{app_name}-1", f"{app_name}-2"
    c = sdk.EventClient(key, url, timeout=30)
    seen = []
    r = c.create_event("rate", "user", "u1", "item", "i1",
                       {"rating": 4.5}, event_time="2026-04-01T00:00:00Z")
    seen.append(("single", _result(r)))
    batch = [{"event": "view", "entityType": "user", "entityId": f"u{i}",
              "targetEntityType": "item", "targetEntityId": f"i{i % 3}",
              "eventTime": f"2026-04-01T00:0{i}:00Z"} for i in range(5)]
    batch.insert(2, {"event": "$nope", "entityType": "user",
                     "entityId": "x"})
    res = c.create_events(batch, batch_token=t1)
    seen.append(("batch", [_result(x) for x in res]))
    seen.append(("retry", [_result(x) for x in
                           c.create_events(batch, batch_token=t1)]))
    got = c.get_event(f"bt{t1}.0")
    seen.append(("get", {**got, "eventId": got["eventId"].replace(t1, "T"),
                         "creationTime": "<stamp>"}))
    seen.append(("find", [e["eventId"].replace(t1, "T") for e in
                          c.find_events(entityType="user", limit=-1,
                                        reversed=True)
                          if e["eventId"].startswith("bt")]))
    seen.append(("find by target", len(c.find_events(
        targetEntityType="item", targetEntityId="i1", limit=-1))))
    c.delete_event(f"bt{t1}.1")
    try:
        c.get_event(f"bt{t1}.1")
    except sdk.PredictionIOError as e:
        seen.append(("deleted", _err(e)))
    seen.append(("wrappers", [_result(x) for x in (
        c.set_user("u1", {"age": 3}, event_time="2026-04-02T00:00:00Z"),
        c.set_item("i1", {"cat": ["a"]}, event_time="2026-04-02T00:00:00Z"),
        c.record_user_action_on_item("buy", "u2", "i2",
                                     event_time="2026-04-02T00:00:00Z"))]))
    try:
        sdk.EventClient("wrong", url).create_event("view", "user", "u")
    except sdk.PredictionIOError as e:
        seen.append(("401", _err(e)))
    # one injected outage answered 503 + Retry-After: 0, then retried
    st.pkg.faults.install("http.event:error:1.0:1")
    retrying = sdk.EventClient(key, url, retries=2, timeout=30)
    slept = []
    retrying.retry._sleep = slept.append
    seen.append(("retried", [_result(x) for x in retrying.create_events(
        batch[:2], batch_token=t2)], slept))
    st.pkg.faults.clear()
    try:
        sdk.EventClient(key, url, deadline_ms=0).find_events()
    except sdk.PredictionIOError as e:
        seen.append(("deadline", _err(e)))
    return seen


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_clients_crossed_with_servers_give_the_same_results(servers):
    from test_torch_segments import own_segment_root

    for st in servers.values():
        with own_segment_root(st.home / "segments"):
            st.srv = st.pkg.es.EventServer(storage=st.storage,
                                           host="127.0.0.1", port=0)
        st.srv.start()
    runs = {}
    for sname, st in servers.items():
        url = f"http://127.0.0.1:{st.srv.port}"
        for cname, sdk in CLIENTS.items():
            runs[(cname, sname)] = script(sdk, st, url, f"{cname}app")
    first = runs[("ref", "ref")]
    for combo, seen in runs.items():
        assert seen == first, combo
    assert dict((k, v) for k, v, *_ in first)["find"] == [
        "btT.5", "btT.4", "btT.3", "btT.1", "btT.0"]
    assert [r[1] for r in dict((k, v) for k, v, *_ in first)["batch"]] == [
        "1.0", "1.1", None, "1.3", "1.4", "1.5"]
    # connection errors are one surface, retriable
    dead = f"http://127.0.0.1:{_free_port()}"
    for sdk in CLIENTS.values():
        with pytest.raises(sdk.PredictionIOError) as e:
            sdk.EventClient("k", dead, timeout=5).create_event("v", "u", "1")
        assert e.value.status is None and e.value.retriable


def test_event_result_is_the_old_string():
    for sdk in CLIENTS.values():
        stored = sdk.EventResult("abc", event_id="abc", status=201)
        spilled = sdk.EventResult("tok", token="tok", status=202)
        assert stored == "abc" and stored.stored and not spilled.stored
        assert isinstance(spilled, str) and spilled.token == "tok"


def test_engine_clients_query_the_port_engine_server(tmp_path):
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import (
        EngineVariant,
        RuntimeContext,
    )
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.server.plugins import PluginManager
    from predictionio_tpu_torch.templates.recommendation import engine
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    storage = port_storage.Storage(memory_config(tmp_path))
    app_id = storage.get_apps().insert(port_storage.App(id=None, name="eng"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(1)
    storage.get_events().insert_batch(
        [Event(event="rate", entity_type="user", entity_id=f"u{u}",
               target_entity_type="item", target_entity_id=f"i{i}",
               properties={"rating": float(rng.integers(1, 6))})
         for u in range(8) for i in range(6) if (u + i) % 3], app_id)
    variant = EngineVariant.from_dict({
        "id": "default",
        "engineFactory":
            "predictionio_tpu_torch.templates.recommendation:engine",
        "datasource": {"params": {"appName": "eng"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 3, "numIterations": 2, "lambda": 0.01, "seed": 3}}]})
    run_train(engine(), variant,
              RuntimeContext.create(storage=storage, device="cpu"))
    srv = EngineServer(engine(), variant, storage, host="127.0.0.1", port=0,
                       device="cpu", plugins=PluginManager())
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        answers = []
        for sdk in CLIENTS.values():
            c = sdk.EngineClient(url, timeout=30)
            got = [c.send_query({"user": f"u{u}", "num": 3})
                   for u in range(8)]
            status = c.status()
            with pytest.raises(sdk.PredictionIOError) as e:
                c.send_query({"user": "u1", "num": "three"})
            answers.append((got, status["engineInstanceId"],
                            e.value.status))
        assert answers[1] == answers[0]
        assert answers[0][2] == 400
        assert all(len(a["itemScores"]) == 3 for a in answers[0][0])
    finally:
        srv.stop()
        storage.close()


def test_sdk_find_events_payload_is_the_server_json(servers):
    """``find_events`` returns the server's JSON unchanged, stamps and
    all (the wire format both packages share)."""
    st = servers["port"]
    st.srv = st.pkg.es.EventServer(storage=st.storage, host="127.0.0.1",
                                   port=0)
    st.srv.start()
    _, key = fresh_app(st, "wire")
    c = port_sdk.EventClient(key, f"http://127.0.0.1:{st.srv.port}")
    c.create_events([{"event": "view", "entityType": "user",
                      "entityId": "w", "properties": {"x": [1, 2.5, None]},
                      "eventTime": "2026-04-03T01:02:03.456+05:30"}],
                    batch_token="w")
    (got,) = c.find_events()
    assert got["eventTime"] == "2026-04-02T19:32:03.456+00:00"
    assert got["properties"] == {"x": [1, 2.5, None]}
    assert json.loads(json.dumps(got)) == got
