"""The port's event server against the reference's, over HTTP.

One script of requests goes to
``predictionio_tpu.server.event_server.EventServer`` and to the port's,
each on port 0 over its own fresh sqlite ``PIO_HOME`` holding the same
app, access keys and channel.  Every status code and JSON body must be
equal once the random event ids (single posts, batches without a token)
and the ingest-stamped ``creationTime`` are masked; ids derived from a
client batch token are compared unmasked.  Then the stored rows: ``find``
over both stores gives the same rows in the same order, and each
``pio.db`` reads identically through the other package's storage.

Also here: ``pio eventserver`` as a subprocess (bound port printed,
drained with exit 0 on SIGTERM) and the plugin seam of both servers,
the port's engine server included.  The script does not send
``/traces.json`` (its span trees are compared in
``tests/test_torch_traces.py``).  Each server tees into a segment root
of its own, and ``/ready`` is compared whole, segment fields included.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import urllib.parse
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import predictionio_tpu.config as ref_config
import predictionio_tpu.data.json_support as ref_json
import predictionio_tpu.data.storage as ref_storage
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.server.event_server as ref_es
import predictionio_tpu_torch.config as port_config
import predictionio_tpu_torch.data.json_support as port_json
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.server.event_server as port_es

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 120

REF = SimpleNamespace(name="ref", config=ref_config, storage=ref_storage,
                      es=ref_es, json=ref_json,
                      reset_metrics=ref_obs.reset_observability,
                      registry=ref_obs.get_registry)
PORT = SimpleNamespace(name="port", config=port_config, storage=port_storage,
                       es=port_es, json=port_json,
                       reset_metrics=lambda: port_obs.get_registry().reset(),
                       registry=port_obs.get_registry)

KEY_ALL, KEY_VIEW = "K-all", "K-view"
# The event server's own series, as both packages name them.
SERIES_PREFIXES = ("pio_event", "pio_breaker", "pio_spill", "pio_deadline",
                   "pio_ingest", "pio_plugin", "pio_segment")


def open_store(pkg, home):
    """One app ``sess`` (id 1) with a channel ``side`` and two keys:
    ``K-all`` and ``K-view`` (allowlist: view)."""
    cfg = pkg.config.load_config(env={"PIO_HOME": str(home)})
    storage = pkg.storage.Storage(cfg)
    s = pkg.storage
    app_id = storage.get_apps().insert(s.App(id=None, name="sess"))
    storage.get_events().init(app_id)
    ch = storage.get_channels().insert(
        s.Channel(id=None, name="side", app_id=app_id))
    storage.get_events().init(app_id, ch)
    storage.get_access_keys().insert(s.AccessKey(key=KEY_ALL, app_id=app_id))
    storage.get_access_keys().insert(
        s.AccessKey(key=KEY_VIEW, app_id=app_id, events=("view",)))
    return storage, app_id, ch


@pytest.fixture()
def both(tmp_path, monkeypatch):
    """The reference's and the port's event servers, each over its own
    sqlite home and segment root, with fresh metrics registries."""
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "env_home"))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_SPILL", "PIO_FAULTS",
                         "PIO_MAX_BATCH", "PIO_INGEST", "PIO_BREAKER",
                         "PIO_RETRY_AFTER", "PIO_EVENTSERVER_PLUGINS",
                         "PIO_ENGINESERVER_PLUGINS", "PIO_AUTH")):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("PIO_SEGMENTS", raising=False)
    stacks = []
    for pkg in (REF, PORT):
        pkg.reset_metrics()
        home = tmp_path / pkg.name
        monkeypatch.setenv("PIO_SEGMENT_DIR", str(home / "segments"))
        storage, app_id, ch = open_store(pkg, home)
        srv = pkg.es.EventServer(storage=storage, host="127.0.0.1", port=0)
        srv.start()
        stacks.append(SimpleNamespace(pkg=pkg, home=home, storage=storage,
                                      app_id=app_id, channel=ch, srv=srv))
    yield stacks
    for st in stacks:
        st.srv.stop()
        st.storage.close()


def call(port, method, path, body=None, headers=None):
    """(status, Retry-After, payload) of one request; ``headers`` exactly
    as given (no Content-Type unless named)."""
    if isinstance(body, (list, dict)):
        body = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        payload = json.loads(data) if "json" in ctype else data.decode()
        return resp.status, resp.getheader("Retry-After"), payload
    finally:
        conn.close()


def _token_id(eid) -> bool:
    """Ids derived from a client batch token: ``bt<token>.<position>``."""
    return isinstance(eid, str) and eid.startswith("bt") and "." in eid


def mask(obj):
    """Random event ids → ``<id>``, ingest stamps → ``<stamp>``."""
    if isinstance(obj, list):
        return [mask(x) for x in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "eventId" and not _token_id(v):
                v = "<id>"
            elif k in ("creationTime", "startTime", "token"):
                v = "<stamp>"
            elif k == "latencyMs":
                v = "<latency>"
            else:
                v = mask(v)
            out[k] = v
        return out
    return obj


def q(path, **params):
    return f"{path}?{urllib.parse.urlencode(params, doseq=True)}"


def seeded_events(n=40, seed=0):
    """Events of a small shop from a seed: three stamps (so reads tie),
    properties of every JSON type, some with a target entity."""
    rng = np.random.default_rng(seed)
    stamps = ["2026-03-01T10:00:00Z", "2026-03-01T10:00:00.250+00:00",
              "2026-03-02T08:30:00+02:00"]
    out = []
    for k in range(n):
        name = ["view", "buy", "rate", "$set"][int(rng.integers(4))]
        ev = {"event": name, "entityType": "user",
              "entityId": f"u{int(rng.integers(6))}",
              "eventTime": stamps[int(rng.integers(3))]}
        if name == "$set":
            ev["entityType"], ev["entityId"] = "item", f"i{k % 7}"
            ev["properties"] = {"categories": ["c1", f"c{k % 3}"],
                                "price": round(float(rng.random()) * 90, 2),
                                "meta": {"új": True, "n": k}}
        else:
            ev["targetEntityType"] = "item"
            ev["targetEntityId"] = f"i{int(rng.integers(7))}"
            if name == "rate":
                ev["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        out.append(ev)
    return out


def scripted_requests():
    """The script: (method, path, body, headers) in order."""
    evs = seeded_events()
    k = {"accessKey": KEY_ALL}
    one = {"event": "view", "entityType": "user", "entityId": "u9",
           "targetEntityType": "item", "targetEntityId": "i1",
           "eventTime": "2026-03-01T09:00:00Z"}
    basic = "Basic " + __import__("base64").b64encode(
        f"{KEY_ALL}:".encode()).decode()
    bad_items = [{"entityType": "user", "entityId": "noevent"},
                 {"event": "view", "entityType": "user", "entityId": "u1",
                  "eventTime": "not a time"},
                 {"event": "$bogus", "entityType": "user", "entityId": "u2"}]
    batch_a = evs[:12] + bad_items + evs[12:20]
    ndjson = ("\n".join(json.dumps(e) for e in evs[20:26])
              + "\n{not json\n\n" + json.dumps(evs[26]) + "\n").encode()
    sniffed = "\n".join(json.dumps(e) for e in evs[27:32]).encode()
    form = urllib.parse.urlencode({
        "type": "subscribe", "fired_at": "2026-03-03 12:00:00",
        "data[email]": "a@b.example", "data[merges][FNAME]": "Ann"}).encode()
    seg_one = {"type": "track", "userId": "s1", "event": "signup",
               "timestamp": "2026-03-03T13:00:00Z",
               "properties": {"plan": "pro"}}
    seg_burst = {"batch": [
        {"type": "identify", "userId": "s2", "traits": {"age": 30},
         "timestamp": "2026-03-03T13:01:00Z"},
        {"type": "track", "userId": "s3"},          # no event: per-item 400
        {"type": "page", "anonymousId": "a1", "name": "home",
         "timestamp": "2026-03-03T13:02:00Z"}]}
    R = []

    def add(method, path, body=None, headers=None):
        R.append((method, path, body, headers))

    add("GET", "/")
    add("GET", "/ready")
    add("GET", "/nope")
    # single posts: ok, malformed, invalid, auth, allowlist, channel
    add("POST", q("/events.json", **k), one)
    add("POST", q("/events.json", **k), b"{broken", {})
    add("POST", q("/events.json", **k), {"event": "$bogus",
                                         "entityType": "u", "entityId": "x"})
    add("POST", q("/events.json", **k), {"event": "view",
                                         "entityType": "u", "entityId": "x",
                                         "eventTime": "yesterday"})
    add("POST", q("/events.json", accessKey="wrong"), one)
    add("POST", "/events.json", one)
    add("POST", "/events.json", one, {"Authorization": basic})
    add("POST", q("/events.json", accessKey=KEY_VIEW),
        {**one, "event": "buy"})
    add("POST", q("/events.json", accessKey=KEY_VIEW), one)
    add("POST", q("/events.json", channel="side", **k), one)
    add("POST", q("/events.json", channel="nope", **k), one)
    # a spent deadline sheds before auth; a garbage one is ignored
    add("POST", q("/events.json", **k), one, {"X-PIO-Deadline-Ms": "0"})
    add("POST", q("/events.json", **k), one, {"X-PIO-Deadline-Ms": "soon"})
    # batches: per-item status, NDJSON typed and sniffed, token-less
    add("POST", q("/batch/events.json", batchToken="tokA", **k), batch_a)
    add("POST", q("/batch/events.json", batchToken="tokB", **k), ndjson,
        {"Content-Type": "application/x-ndjson"})
    add("POST", q("/batch/events.json", batchToken="tokC", **k), sniffed, {})
    add("POST", q("/batch/events.json", **k), evs[32:36])
    add("POST", q("/batch/events.json", accessKey=KEY_VIEW,
                  batchToken="tokE"), evs[:8])
    add("POST", q("/batch/events.json", channel="side", batchToken="tokF",
                  **k), evs[36:40])
    # the reference's cap of 50, a bad token, not-an-array bodies
    add("POST", q("/batch/events.json", batchToken="tokG", **k),
        [dict(one, entityId=f"c{i}") for i in range(51)])
    add("POST", q("/batch/events.json", batchToken="bad token!", **k),
        evs[:2])
    add("POST", q("/batch/events.json", batchToken="x" * 121, **k), evs[:2])
    add("POST", q("/batch/events.json", **k), {"event": "view"})
    add("POST", q("/batch/events.json", **k), b"[1,", {})
    add("POST", q("/batch/events.json", batchToken="tokA", **k), batch_a)
    # reads: every filter, limit and reversed (ties included)
    for params in ({}, {"limit": "-1"}, {"limit": "5", "reversed": "true"},
                   {"startTime": "2026-03-01T10:00:00.100Z",
                    "untilTime": "2026-03-02T07:00:00Z", "limit": "-1"},
                   {"entityType": "user", "entityId": "u1", "limit": "3",
                    "reversed": "true"},
                   {"entityType": "user", "entityId": "u1", "limit": "-1"},
                   {"event": ["view", "buy"], "limit": "-1"},
                   {"targetEntityType": "item", "targetEntityId": "i3",
                    "limit": "-1", "reversed": "true"},
                   {"entityType": "item", "limit": "4"},
                   {"channel": "side", "limit": "-1"},
                   {"limit": "-2"}, {"limit": "abc"}):
        add("GET", q("/events.json", **k, **params))
    add("GET", q("/events.json", accessKey="wrong"))
    # by id
    add("GET", q("/events/bttokA.0.json", **k))
    add("GET", q("/events/bttokF.1.json", channel="side", **k))
    add("GET", q("/events/nope.json", **k))
    add("DELETE", q("/events/bttokA.1.json", **k))
    add("DELETE", q("/events/bttokA.1.json", **k))
    add("GET", q("/events/bttokA.1.json", **k))
    # webhooks: both connectors, a burst, an unknown connector
    add("POST", q("/webhooks/segmentio.json", **k), seg_one)
    add("POST", q("/webhooks/segmentio.json", **k), seg_burst)
    add("POST", q("/webhooks/segmentio.json", **k), {"userId": "s4"})
    add("POST", q("/webhooks/mailchimp", **k), form,
        {"Content-Type": "application/x-www-form-urlencoded"})
    add("POST", q("/webhooks/mailchimp", **k), b"type=nope", {})
    add("POST", q("/webhooks/nosuch.json", **k), {})
    add("GET", "/stats.json")
    return R


def run_script(stacks, requests):
    for method, path, body, headers in requests:
        got = [call(st.srv.port, method, path, body, headers)
               for st in stacks]
        (rs, rra, rp), (ps, pra, pp) = got
        where = f"{method} {path[:90]}"
        assert ps == rs, (where, rs, rp, ps, pp)
        assert pra == rra, where
        assert mask(pp) == mask(rp), (where, rp, pp)


def test_scripted_requests_answer_as_the_reference(both, monkeypatch):
    ref, port = both
    run_script(both, scripted_requests())
    # the cap follows PIO_MAX_BATCH_SIZE, read per request
    batch = [{"event": "view", "entityType": "user", "entityId": f"m{i}",
              "eventTime": "2026-03-04T00:00:00Z"} for i in range(55)]
    monkeypatch.setenv("PIO_MAX_BATCH_SIZE", "60")
    run_script(both, [("POST", q("/batch/events.json", accessKey=KEY_ALL,
                                  batchToken="tokM"), batch, None)])
    monkeypatch.setenv("PIO_MAX_BATCH_SIZE", "3")
    run_script(both, [("POST", q("/batch/events.json", accessKey=KEY_ALL,
                                  batchToken="tokN"), batch[:4], None)])
    # the metrics: the same series, the same high-watermark
    names = []
    for st in both:
        _, _, text = call(st.srv.port, "GET", "/metrics")
        names.append(sorted({m.group(1) for m in re.finditer(
            r"^# TYPE (\S+) ", text, re.M)
            if m.group(1).startswith(SERIES_PREFIXES)}))
    assert names[1] == names[0]
    assert "pio_event_requests_total" in names[0]
    assert port.pkg.registry().get("pio_events_latest_ts").value(app="1") \
        == ref.pkg.registry().get("pio_events_latest_ts").value(app="1")
    # ... and the rows they stored, in the same order
    for ch in (None, ref.channel):
        rows = [[mask(st.pkg.json.event_to_json(e)) for e in
                 st.storage.get_events().find(st.app_id, ch)]
                for st in both]
        assert rows[1] == rows[0]
        assert len(rows[0]) > (20 if ch is None else 3)


def _rows(storage, app_id, channel):
    return [ref_json.event_to_json(e) for e in
            storage.get_events().find(app_id, channel)]


def test_each_pio_db_reads_identically_in_the_other_package(both):
    run_script(both, scripted_requests()[:24])
    for writer, reader in ((both[0], PORT), (both[1], REF)):
        other = reader.storage.Storage(reader.config.load_config(
            env={"PIO_HOME": str(writer.home)}))
        try:
            for ch in (None, writer.channel):
                own = _rows(writer.storage, writer.app_id, ch)
                assert own and _rows(other, writer.app_id, ch) == own
                for limit, rev in ((5, True), (3, False)):
                    for uid in ("u1", "u2"):
                        kw = dict(entity_type="user", entity_id=uid,
                                  limit=limit, reversed=rev)
                        assert [e.event_id for e in other.get_events().find(
                            writer.app_id, ch, **kw)] == \
                            [e.event_id for e in writer.storage.get_events()
                             .find(writer.app_id, ch, **kw)]
        finally:
            other.close()


def test_request_id_is_echoed_or_generated(both):
    for st in both:
        ids = []
        for sent in ("abc<>/ def:1.2", None, "<<>>"):
            conn = http.client.HTTPConnection("127.0.0.1", st.srv.port,
                                              timeout=30)
            conn.request("GET", "/", headers={"X-Request-ID": sent}
                         if sent else {})
            r = conn.getresponse()
            r.read()
            ids.append(r.getheader("X-Request-ID"))
            assert float(r.getheader("X-PIO-Server-Ms")) >= 0
            conn.close()
        assert ids[0] == "abcdef:1.2"
        assert all(re.fullmatch(r"[0-9a-f]{32}", i) for i in ids[1:])


def test_ready_matches_the_reference(both):
    bodies = [call(st.srv.port, "GET", "/ready")[2] for st in both]
    assert bodies[1] == bodies[0]
    assert bodies[1]["status"] == "ready" and not bodies[1]["diskDegraded"]
    assert (bodies[1]["segmentDirs"], bodies[1]["segmentCount"]) == (0, 0)
    # a batch teed and sealed, in the default channel and in ``side``
    batch = [{"event": "view", "entityType": "user", "entityId": f"r{i}",
              "eventTime": "2026-03-04T00:00:00Z"} for i in range(3)]
    for st in both:
        for channel in ({}, {"channel": "side"}):
            status, _, _ = call(st.srv.port, "POST", q(
                "/batch/events.json", accessKey=KEY_ALL, **channel), batch)
            assert status == 200
        st.srv.segments.seal_all()
    bodies = [call(st.srv.port, "GET", "/ready")[2] for st in both]
    assert bodies[1] == bodies[0]
    assert (bodies[1]["segmentDirs"], bodies[1]["segmentCount"]) == (2, 2)


# -- plugins -----------------------------------------------------------------


class _FailingPlugin:
    name = "failing"

    def start(self, server):
        raise RuntimeError("plugin start failed")

    def on_request(self, route, status, ms):
        raise RuntimeError("plugin on_request failed")

    def stop(self):
        raise RuntimeError("plugin stop failed")


def make_failing_plugin():
    return _FailingPlugin()


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_plugins_count_and_inject_headers(tmp_path, monkeypatch, pkg):
    """The reference's plugin test (tests/test_servers.py), on each
    package, with a failing plugin loaded beside the counting one."""
    import tests.plugin_fixture as pf

    monkeypatch.setenv("PIO_SEGMENT_DIR", str(tmp_path / "segments"))
    monkeypatch.setenv(
        "PIO_EVENTSERVER_PLUGINS",
        f"tests.plugin_fixture:make_plugin,{__name__}:make_failing_plugin,"
        "no.such.module:factory")
    pkg.reset_metrics()
    storage, _, _ = open_store(pkg, tmp_path / "home")
    srv = pkg.es.EventServer(storage=storage, host="127.0.0.1", port=0)
    plugin = pf.LAST
    assert plugin is not None and plugin.started_with is srv
    assert len(srv.plugins.plugins) == 2
    srv.start()
    try:
        ev = {"event": "rate", "entityType": "user", "entityId": "u1"}
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", f"/events.json?accessKey={KEY_ALL}",
                     json.dumps(ev), {"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        assert r.status == 201 and r.getheader("X-Plugin-Count") == "1"
        conn.request("GET", "/")
        r = conn.getresponse()
        r.read()
        assert r.getheader("X-Plugin-Count") == "2"
        conn.close()
        assert [x[0] for x in plugin.requests] == ["POST /events.json",
                                                   "GET /"]
        assert all(isinstance(x[2], float) for x in plugin.requests)
    finally:
        srv.stop()
        storage.close()
    assert plugin.started_with is None


def tiny_engine_server(tmp_path):
    """A rank-2 recommendation engine trained on the CPU over a MEMORY
    store, served by the port's EngineServer on port 0 (not started)."""
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import (
        EngineVariant,
        RuntimeContext,
    )
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import engine
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    storage = port_storage.Storage(memory_config(tmp_path))
    app_id = storage.get_apps().insert(port_storage.App(id=None,
                                                        name="plug"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(0)
    storage.get_events().insert_batch(
        [Event(event="rate", entity_type="user", entity_id=f"u{u}",
               target_entity_type="item", target_entity_id=f"i{i}",
               properties={"rating": float(rng.integers(1, 6))})
         for u in range(6) for i in range(5)], app_id)
    variant = EngineVariant.from_dict({
        "id": "default",
        "engineFactory":
            "predictionio_tpu_torch.templates.recommendation:engine",
        "datasource": {"params": {"appName": "plug"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 2, "numIterations": 1, "lambda": 0.01, "seed": 1}}]})
    run_train(engine(), variant,
              RuntimeContext.create(storage=storage, device="cpu"))
    return EngineServer(engine(), variant, storage, host="127.0.0.1",
                        port=0, device="cpu")


def test_port_engine_server_loads_plugins(tmp_path, monkeypatch):
    """``PIO_ENGINESERVER_PLUGINS`` in the port's engine server, started
    after the model loaded, fed every request, stopped with the server."""
    import urllib.request

    import tests.plugin_fixture as pf

    monkeypatch.setenv("PIO_ENGINESERVER_PLUGINS",
                       f"tests.plugin_fixture:make_plugin,"
                       f"{__name__}:make_failing_plugin")
    srv = tiny_engine_server(tmp_path)
    plugin = pf.LAST
    assert plugin.started_with is srv and srv._instance is not None
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/queries.json",
            data=json.dumps({"user": "u1", "num": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            assert r.headers["X-Plugin-Count"] == "1"
            assert len(json.loads(r.read())["itemScores"]) == 2
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/",
                                    timeout=30) as r:
            assert r.headers["X-Plugin-Count"] == "2"
    finally:
        srv.stop()
    assert [x[:2] for x in plugin.requests] == [
        ("POST /queries.json", 200), ("GET /", 200)]
    assert plugin.started_with is None


def test_engine_server_stops_only_after_answering_stop(tmp_path,
                                                      monkeypatch):
    """``POST /stop`` begins the stop only once its answer is written:
    `pio deploy` exits as soon as the serve loop ends, and a stop begun
    inside the handler could end the process with the answer unsent."""
    import threading

    from predictionio_tpu_torch.server import http as port_http

    monkeypatch.delenv("PIO_ENGINESERVER_PLUGINS", raising=False)
    srv = tiny_engine_server(tmp_path)
    answered = threading.Event()
    respond = port_http.BaseHandler.respond

    def respond_and_mark(self, *a, **kw):
        respond(self, *a, **kw)
        if self.path == "/stop":
            answered.set()

    monkeypatch.setattr(port_http.BaseHandler, "respond", respond_and_mark)
    seen = []
    stop = srv.stop
    stopped = threading.Event()

    def stop_and_note():
        seen.append(answered.is_set())
        stop()
        stopped.set()

    srv.stop = stop_and_note
    srv.start()
    status, _, body = call(srv.port, "POST", "/stop", b"", {})
    assert (status, body) == (200, {"status": "stopping"})
    assert stopped.wait(30) and seen == [True]
    assert srv._httpd is None


# -- pio eventserver ---------------------------------------------------------


def test_cli_eventserver_serves_and_drains_on_sigterm(tmp_path):
    """``python -m predictionio_tpu_torch.cli eventserver --port 0`` in a
    process of its own: prints the bound port, takes a batch, answers
    ``/ready``, and exits 0 after SIGTERM with the spill journal flushed."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(PIO_HOME=str(tmp_path / "home"), PYTHONPATH=str(ROOT))
    storage, app_id, _ = open_store(PORT, tmp_path / "home")
    storage.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "eventserver",
         "--ip", "127.0.0.1", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() else "")
        port = int(m.group(1))
        assert call(port, "GET", "/ready")[2]["status"] == "ready"
        status, _, out = call(
            port, "POST", q("/batch/events.json", accessKey=KEY_ALL,
                            batchToken="cli"), seeded_events(5))
        assert status == 200 and [r["eventId"] for r in out] == \
            [f"btcli.{i}" for i in range(5)]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    st = port_storage.Storage(port_config.load_config(
        env={"PIO_HOME": str(tmp_path / "home")}))
    try:
        assert len(list(st.get_events().find(app_id))) == 5
    finally:
        st.close()


def test_concurrent_batches_land_once_and_balance_the_counters(tmp_path,
                                                              monkeypatch):
    """16 client threads (more than this machine's cores) post batches at
    once with a short switch interval, half of them twice under the same
    token: every row lands once, the in-flight budget returns to 0, the
    status counter counts every request and the high-watermark is the
    newest stamp."""
    import sys
    import threading

    monkeypatch.setenv("PIO_SEGMENT_DIR", str(tmp_path / "segments"))
    monkeypatch.setenv("PIO_INGEST_QUEUE_BUDGET", "100000")
    PORT.reset_metrics()
    storage, app_id, _ = open_store(PORT, tmp_path / "home")
    srv = port_es.EventServer(storage=storage, host="127.0.0.1", port=0)
    srv.start()
    errors = []

    def client(t):
        try:
            for b in range(6):
                batch = [{"event": "view", "entityType": "user",
                          "entityId": f"t{t}-{b}-{i}",
                          "eventTime": f"2026-05-01T00:{t:02d}:{b:02d}Z"}
                         for i in range(10)]
                for _ in range(1 + b % 2):
                    st, _, out = call(srv.port, "POST", q(
                        "/batch/events.json", accessKey=KEY_ALL,
                        batchToken=f"t{t}b{b}"), batch)
                    assert st == 200 and {o["status"] for o in out} == {201}
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    try:
        assert errors == []
        assert srv._inflight == 0
        rows = list(storage.get_events().find(app_id))
        assert len(rows) == len({r.event_id for r in rows}) == 16 * 6 * 10
        reg = port_obs.get_registry()
        assert reg.get("pio_event_requests_total").value(status="200") \
            == 16 * 9
        assert reg.get("pio_events_latest_ts").value(app=str(app_id)) == \
            pytest.approx(port_json.parse_iso8601(
                "2026-05-01T00:15:05Z").timestamp())
        # every landed request teed once (a replay again): the stored ids
        from predictionio_tpu_torch.data import columnar
        payloads = [p for seg in sorted((tmp_path / "segments").rglob(
            "*.seg")) for p in columnar.recover_segment_tail(
                seg, truncate=False)["payloads"]]
        teed = columnar._payloads_to_columns(payloads)["event_id"]
        assert len(teed) == 16 * 9 * 10
        assert set(teed) == {r.event_id for r in rows}
    finally:
        storage.close()
