"""The port's native serving frontend against the reference's.

``predictionio_tpu_torch.native`` builds its own copy of
``serving_frontend.cc`` with g++ into ``build/torch_native/`` and binds
it with ctypes; ``predictionio_tpu.native`` builds the reference's into
``native/``.  Each package loads its own library, so both frontends run
in one process.  The cases of the reference's ``tests/test_native.py``
for the frontend, the plugin seam, the adaptive linger, the round-2
worker pool and shutdown, the event-ingest path and the deploy fallback
run on BOTH packages (``pkg``), and so do the cases of the feeder
(``native/feeder.cc``, the port's own copy): an epoch is a shuffled
permutation of the cache with values following their rows, extra
columns and categorical caches round-trip, epochs differ and repeat per
seed; both packages' feeder libraries yield byte-equal batches from one
cache and seed.
Also: both frontends answer the same bodies byte for byte, the port's
frontend serves its engine server's ``query_batch`` and, behind the
fallback, its status routes; and the port's build — sources only under
``predictionio_tpu_torch/``, six processes building into one empty
directory at once each load the library, a failed build raises with the
compiler's message.
"""

import concurrent.futures
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import predictionio_tpu.config as ref_config
import predictionio_tpu.data.storage as ref_storage
import predictionio_tpu.native.feeder as ref_feeder
import predictionio_tpu.native.frontend as ref_frontend
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.server.event_server as ref_es
import predictionio_tpu_torch.config as port_config
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.native.build as port_build
import predictionio_tpu_torch.native.feeder as port_feeder
import predictionio_tpu_torch.native.frontend as port_frontend
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.server.event_server as port_es

ROOT = Path(__file__).resolve().parents[1]
REF = SimpleNamespace(name="ref", frontend=ref_frontend, es=ref_es,
                      config=ref_config, storage=ref_storage,
                      reset=ref_obs.reset_observability)
PORT = SimpleNamespace(name="port", frontend=port_frontend, es=port_es,
                       config=port_config, storage=port_storage,
                       reset=lambda: port_obs.get_registry().reset())
PKGS = (REF, PORT)


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request, monkeypatch):
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_EVENTSERVER_PLUGINS",
                         "PIO_SPILL", "PIO_FAULTS")):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("PIO_SEGMENTS", raising=False)
    request.param.reset()
    return request.param


def _frontend(pkg, handler, **kw):
    return pkg.frontend.NativeFrontend(handler, host="127.0.0.1", port=0,
                                       **kw)


def _post(port, path, payload, timeout=10):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


# -- the frontend ---------------------------------------------------------------

def _frontend_requests(port) -> int:
    """The frontend's own request counter (answered in C++)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        for line in r.read().decode().splitlines():
            if line.startswith("pio_frontend_requests_total "):
                return int(line.split()[1])
    raise AssertionError("no pio_frontend_requests_total")


def test_batched_serving(pkg):
    """One batcher thread, its first callback held until all 16 requests
    have reached the frontend (its own counter says so, not a timer):
    the rest leave in batches of up to ``max_batch``."""
    gate = threading.Event()
    sizes = []

    def handler(batch):
        sizes.append(len(batch))
        if len(sizes) == 1:
            assert gate.wait(30)
        return [{"echo": q, "n": len(batch)} for q in batch]

    fe = _frontend(pkg, handler, max_batch=8, max_wait_us=20000,
                   n_batchers=1)
    port = fe.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(_post, port, "/queries.json",
                              {"user": f"u{i}"}) for i in range(16)]
            polls, deadline = 0, time.monotonic() + 30
            while time.monotonic() < deadline:
                polls += 1
                if _frontend_requests(port) - polls >= 16:
                    break
                time.sleep(0.005)
            gate.set()
            results = [f.result(30)[1] for f in futs]
        assert sorted(r["echo"]["user"] for r in results) == \
            sorted(f"u{i}" for i in range(16))
        assert sum(sizes) == 16 and max(sizes) == 8
        assert max(r["n"] for r in results) == 8
    finally:
        fe.stop()


def test_status_metrics_and_errors(pkg):
    fe = _frontend(pkg, lambda b: [{"ok": True} for _ in b])
    port = fe.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"status": "alive",
                                            "frontend": "native"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json", data=b"{not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert "pio_frontend_requests_total" in r.read().decode()
    finally:
        fe.stop()


def _raw_exchange(port, requests):
    """Each request's raw HTTP response bytes, one connection each."""
    out = []
    for method, path, body in requests:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                      f"Connection: close\r\nContent-Length: {len(body)}"
                      f"\r\n\r\n".encode() + body)
            buf = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        out.append(buf)
    return out


def test_both_frontends_answer_the_same_bytes():
    """One handler behind both packages' frontends: every response —
    queries, a malformed body, a handler error, a fallback route — is the
    same bytes on the wire."""

    def handler(batch):
        if any(q.get("boom") for q in batch if isinstance(q, dict)):
            raise RuntimeError("handler failed")
        return [{"echo": q, "score": 0.5} for q in batch]

    def fallback(method, path, body):
        return 404 if path.startswith("/nope") else 200, {
            "method": method, "path": path, "len": len(body)}

    requests = [("POST", "/queries.json", b'{"user": "u1", "num": 3}'),
                ("POST", "/queries.json", b"{bad json"),
                ("POST", "/queries.json", b'{"boom": true}'),
                ("POST", "/queries.json", b""),
                ("GET", "/stats.json?x=1", b""),
                ("POST", "/nope", b"abc"),
                ("GET", "/", b"")]
    answers = []
    for p in PKGS:
        fe = _frontend(p, handler, fallback=fallback, max_batch=1,
                       max_wait_us=0)
        port = fe.start()
        try:
            answers.append(_raw_exchange(port, requests))
        finally:
            fe.stop()
    assert answers[0] == answers[1]
    assert answers[1][0].startswith(b"HTTP/1.1 200 OK")
    assert answers[1][1].startswith(b"HTTP/1.1 400")
    assert answers[1][2].startswith(b"HTTP/1.1 500")


# -- the plugin seam ------------------------------------------------------------

def _event_server(pkg, tmp_path, **kw):
    cfg = pkg.config.load_config(env={"PIO_HOME": str(tmp_path / pkg.name)})
    storage = pkg.storage.Storage(cfg)
    app_id = storage.get_apps().insert(pkg.storage.App(id=None,
                                                       name="nativeapp"))
    storage.get_events().init(app_id)
    key = storage.get_access_keys().insert(
        pkg.storage.AccessKey.generate(app_id))
    from test_torch_segments import own_segment_root

    with own_segment_root(tmp_path / pkg.name / "segments"):
        srv = pkg.es.EventServer(storage, **kw)
    return srv, storage, app_id, key


def test_plugin_header_through_native_frontend(pkg, tmp_path, monkeypatch):
    import tests.plugin_fixture as pf

    monkeypatch.setenv("PIO_EVENTSERVER_PLUGINS",
                       "tests.plugin_fixture:make_plugin")
    srv, storage, app_id, key = _event_server(pkg, tmp_path)
    plugin = pf.LAST
    fe = _frontend(pkg, None, max_batch=16, max_wait_us=2000,
                   fallback_batch=srv.native_fallback_batch,
                   plugin_hook=srv.plugins.header_block)
    port = fe.start()
    try:
        ev = {"event": "rate", "entityType": "user", "entityId": "u1"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/events.json?accessKey={key}",
            data=json.dumps(ev).encode(),
            headers={"Content-Type": "application/json"})
        for n in (1, 2):
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 201
                assert r.headers["X-Plugin-Count"] == str(n)
        assert [x[0] for x in plugin.requests] == ["POST /events.json"] * 2
        assert all(x[1] == 201 for x in plugin.requests)
    finally:
        fe.stop()
        srv.stop()
        storage.close()


def test_header_block_equal_across_packages():
    class TwoHeaders:
        name = "two"

        def start(self, server):
            pass

        def on_request(self, route, status, ms):
            return {"X-A": f"{route}:{status}", "X-Bad\r\nInjected": "v\n"}

        def stop(self):
            pass

    from predictionio_tpu.server.plugins import PluginManager as RefPM
    from predictionio_tpu_torch.server.plugins import PluginManager as PortPM

    for args in (("POST /events.json", 201, 1.5), ("GET /", 200, 0.1)):
        assert PortPM([TwoHeaders()]).header_block(*args) == \
            RefPM([TwoHeaders()]).header_block(*args)
    assert PortPM([]).header_block("GET /", 200, 0.1) == ""


# -- adaptive linger, worker pool, shutdown ---------------------------------------

def test_unloaded_request_skips_batch_linger(pkg):
    wait_us = 50_000
    fe = _frontend(pkg, lambda b: [{"ok": True} for _ in b], max_batch=64,
                   max_wait_us=wait_us)
    port = fe.start()
    try:
        s = socket.create_connection(("127.0.0.1", port))
        payload = b'{"q": 1}'
        req = (b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
               b"Content-Type: application/json\r\nContent-Length: " +
               str(len(payload)).encode() + b"\r\n\r\n" + payload)
        lats = []
        for _ in range(30):
            t0 = time.perf_counter()
            s.sendall(req)
            buf = b""
            while b"ok" not in buf:
                buf += s.recv(65536)
            lats.append(time.perf_counter() - t0)
        s.close()
        assert sorted(lats)[15] < wait_us / 1e6 / 2
    finally:
        fe.stop()


def test_keep_alive_reuses_connection(pkg):
    fe = _frontend(pkg, lambda b: [{"ok": True} for _ in b], max_batch=8,
                   max_wait_us=100)
    port = fe.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        for i in range(50):
            conn.request("POST", "/queries.json", body=json.dumps({"i": i}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read()) == {"ok": True}
            assert resp.getheader("Connection") == "keep-alive"
        conn.close()
    finally:
        fe.stop()


def test_thread_count_flat_under_load(pkg):
    fe = _frontend(pkg, lambda b: [{"ok": True} for _ in b], max_batch=16,
                   max_wait_us=100)
    port = fe.start()

    def hammer(n):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for i in range(n):
            conn.request("POST", "/queries.json", body=json.dumps({"i": i}))
            r = conn.getresponse()
            assert r.status == 200
            r.read()
        conn.close()

    try:
        hammer(20)
        before = len(os.listdir("/proc/self/task"))
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            list(ex.map(hammer, [100] * 8))
        after = len(os.listdir("/proc/self/task"))
        assert after - before <= 8, (before, after)
    finally:
        fe.stop()


def test_stop_with_queued_requests_does_not_hang(pkg):
    release = threading.Event()

    def slow_handler(batch):
        release.wait(timeout=15)
        return [{"ok": True} for _ in batch]

    fe = _frontend(pkg, slow_handler, max_batch=1, max_wait_us=0)
    port = fe.start()
    statuses = []

    def post():
        try:
            statuses.append(_post(port, "/queries.json", {}, timeout=20)[0])
        except urllib.error.HTTPError as e:
            statuses.append(e.code)
        except Exception:
            statuses.append(-1)

    threads = [threading.Thread(target=post) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    release.set()
    stopper = threading.Thread(target=fe.stop)
    stopper.start()
    stopper.join(timeout=10)
    assert not stopper.is_alive()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(statuses) == 6 and all(s in (200, 503, -1) for s in statuses)


def test_stop_with_idle_keepalive_connection(pkg):
    fe = _frontend(pkg, lambda b: [{"ok": True} for _ in b], max_batch=4,
                   max_wait_us=100)
    port = fe.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/queries.json", body=json.dumps({}))
    conn.getresponse().read()
    stopper = threading.Thread(target=fe.stop)
    t0 = time.perf_counter()
    stopper.start()
    stopper.join(timeout=5)
    alive = stopper.is_alive()
    conn.close()
    assert not alive and time.perf_counter() - t0 < 5


# -- the event-ingest path (pio eventserver --native) -----------------------------

def test_full_event_api_through_frontend(pkg, tmp_path):
    srv, storage, app_id, key = _event_server(pkg, tmp_path)
    fe = _frontend(pkg, None, max_batch=16, max_wait_us=5000,
                   fallback_batch=srv.native_fallback_batch)
    port = fe.start()

    def post(path, payload, expect):
        try:
            status, body = _post(port, path, payload)
        except urllib.error.HTTPError as e:
            status, body = e.code, json.load(e)
        assert status == expect, (status, expect, body)
        return body

    try:
        ev = {"event": "rate", "entityType": "user", "entityId": "u1",
              "targetEntityType": "item", "targetEntityId": "i1",
              "properties": {"rating": 4}}
        assert "eventId" in post(f"/events.json?accessKey={key}", ev, 201)
        post("/events.json?accessKey=WRONG", ev, 401)
        post(f"/events.json?accessKey={key}", {"entityId": "x"}, 400)
        out = post(f"/batch/events.json?accessKey={key}", [ev, ev], 200)
        assert [o["status"] for o in out] == [201, 201]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/events.json?accessKey={key}"
                "&entityId=u1&limit=-1", timeout=10) as r:
            assert len(json.loads(r.read())) == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats.json?accessKey={key}",
                timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["statusCounts"].get("201", 0) >= 1
        assert stats["eventCounts"].get("rate", 0) >= 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            assert "pio_event_requests_total" in r.read().decode()
    finally:
        fe.stop()
        srv.stop()
        storage.close()


def test_per_item_error_isolation(pkg, tmp_path):
    srv, storage, app_id, key = _event_server(pkg, tmp_path)
    try:
        good = json.dumps({"event": "view", "entityType": "user",
                           "entityId": "u1", "targetEntityType": "item",
                           "targetEntityId": "i1"}).encode()
        bad_utf8, bad_json = b'\xff\xfe{"event": "view"}', b"{nope"
        outs = srv.native_fallback_batch(
            "POST", f"/events.json?accessKey={key}",
            [good, bad_utf8, good, bad_json, good])
        assert [o[0] for o in outs] == [201, 400, 201, 400, 201]
        assert srv.native_fallback_batch(
            "POST", f"/events.json?accessKey={key}", [bad_utf8])[0][0] == 400
        assert [o[0] for o in srv.native_fallback_batch(
            "POST", "/events.json?accessKey=WRONG", [good, good])] == \
            [401, 401]
        assert [o[0] for o in srv.native_fallback_batch(
            "POST", f"/events.json?accessKey={key}&channel=nope",
            [good, good])] == [400, 400]
        assert len(list(storage.get_events().find(app_id, None,
                                                  limit=None))) == 3
    finally:
        srv.stop()
        storage.close()


def test_fallback_batches_answer_as_the_reference(tmp_path):
    """The same fallback runs through both packages' event servers give
    the same statuses and bodies, event ids masked."""
    runs = []
    for p in PKGS:
        p.reset()
        srv, storage, app_id, key = _event_server(p, tmp_path)
        good = json.dumps({"event": "view", "entityType": "user",
                           "entityId": "u1", "targetEntityType": "item",
                           "targetEntityId": "i1"}).encode()
        try:
            out = []
            for method, path, bodies in (
                    ("POST", f"/events.json?accessKey={key}",
                     [good, b"{x", good]),
                    ("POST", "/events.json?accessKey=WRONG", [good]),
                    ("POST", f"/batch/events.json?accessKey={key}"
                     "&batchToken=t1", [b"[" + good + b"," + good + b"]"]),
                    ("GET", "/", [b""]), ("GET", "/nope", [b""])):
                for res in srv.native_fallback_batch(method, path, bodies):
                    status, payload = res[0], res[1]
                    if isinstance(payload, dict) and "eventId" in payload:
                        payload = {**payload, "eventId": "*"}
                    out.append((status, payload))
            runs.append(out)
        finally:
            srv.stop()
            storage.close()
    assert runs[0] == runs[1]


def test_concurrent_singles_group_commit(pkg, tmp_path):
    srv, storage, app_id, key = _event_server(pkg, tmp_path)
    calls = []
    orig = srv._ingest_group

    def spy(params, bodies):
        calls.append(len(bodies))
        return orig(params, bodies)

    srv._ingest_group = spy
    fe = _frontend(pkg, None, max_batch=32, max_wait_us=20000,
                   fallback_batch=srv.native_fallback_batch)
    port = fe.start()
    try:
        def post(i):
            ev = {"event": "view", "entityType": "user",
                  "entityId": f"u{i}", "targetEntityType": "item",
                  "targetEntityId": f"i{i % 5}"}
            return _post(port, f"/events.json?accessKey={key}", ev)[1][
                "eventId"]

        with concurrent.futures.ThreadPoolExecutor(24) as ex:
            ids = list(ex.map(post, range(24)))
        assert len(set(ids)) == 24
        stored = list(storage.get_events().find(app_id, None, limit=None))
        assert sorted(e.entity_id for e in stored) == \
            sorted(f"u{i}" for i in range(24))
        assert calls and max(calls) > 1
    finally:
        fe.stop()
        srv.stop()
        storage.close()


# -- the deploy path: the port's engine server behind its frontend --------------

@pytest.fixture()
def port_engine(tmp_path, monkeypatch):
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import (
        engine, wrapper_from_numpy)
    from predictionio_tpu_torch.workflow.core_workflow import (
        persist_instance)

    monkeypatch.delenv("PIO_RETRIEVAL_RUNG", raising=False)
    rng = np.random.default_rng(1)
    storage = port_storage.Storage(memory_config(tmp_path))
    eng = engine()
    variant = EngineVariant.from_dict({
        "engineFactory":
            "predictionio_tpu_torch.templates.recommendation:engine",
        "datasource": {"params": {"appName": "x"}},
        "algorithms": [{"name": "als", "params": {"rank": 4}}]})
    w = wrapper_from_numpy(rng.standard_normal((10, 4), np.float32),
                           rng.standard_normal((8, 4), np.float32),
                           [f"u{i}" for i in range(10)],
                           [f"i{i}" for i in range(8)], rank=4)
    persist_instance(eng, variant, [w], storage)
    srv = EngineServer(eng, variant, storage, device="cpu")
    yield srv
    srv.stop()


def test_serves_the_engine_servers_query_batch(port_engine):
    fe = port_frontend.NativeFrontend(port_engine.query_batch,
                                      host="127.0.0.1", port=0,
                                      max_batch=8, max_wait_us=10000)
    port = fe.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda u: _post(port, "/queries.json",
                                              {"user": u, "num": 3})[1],
                              [f"u{i}" for i in range(8)] + ["ghost"]))
        want = port_engine.query_batch(
            [{"user": u, "num": 3} for u in [f"u{i}" for i in range(8)]
             + ["ghost"]])
        # another batch shape sums in another order: float32 rounding
        assert len(got) == len(want) and len(got[0]["itemScores"]) == 3
        for g, w in zip(got, want):
            assert [h["item"] for h in g["itemScores"]] == \
                [h["item"] for h in w["itemScores"]]
            np.testing.assert_allclose(
                [h["score"] for h in g["itemScores"]],
                [h["score"] for h in w["itemScores"]], rtol=1e-5, atol=1e-6)
    finally:
        fe.stop()


def test_status_routes_behind_native_frontend(port_engine):
    def fallback(method, path_with_qs, body):
        return port_engine.handle(method, path_with_qs.split("?", 1)[0],
                                  body)

    fe = port_frontend.NativeFrontend(port_engine.query_batch,
                                      host="127.0.0.1", port=0,
                                      max_batch=8, max_wait_us=5000,
                                      fallback=fallback)
    port = fe.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"status": "alive",
                                            "frontend": "native"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats.json",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert "batcher" in stats and "resultCache" in stats
        status, res = _post(port, "/queries.json", {"user": "u1", "num": 2})
        assert status == 200 and len(res["itemScores"]) == 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/nothing", {})
        assert ei.value.code == 404
    finally:
        fe.stop()


# -- the port's build ---------------------------------------------------------------

def test_the_build_reads_only_the_ports_sources(tmp_path):
    pkg_dir = ROOT / "predictionio_tpu_torch"
    assert port_build.SOURCE_DIR == pkg_dir / "native"
    assert port_build.BUILD_DIR == ROOT / "build" / "torch_native"
    src = port_build.source_path("serving_frontend")
    assert src.parent == pkg_dir / "native"
    out = tmp_path / "lib.so"
    cmd = port_build.compile_command("serving_frontend", out)
    inputs = [a for a in cmd[1:] if not a.startswith("-") and a != str(out)]
    assert inputs == [str(src)]
    assert b'#include "' not in src.read_bytes()     # no local headers
    assert port_build.source_path("feeder").parent == pkg_dir / "native"
    with pytest.raises(RuntimeError, match="missing"):
        port_build.source_path("dlrm_feeder")   # no such source
    assert "build/torch_native/" in (ROOT / ".gitignore").read_text()


_BUILD_PROBE = """
import sys
from pathlib import Path
from predictionio_tpu_torch.native import build
lib = build.load_library("serving_frontend", Path(sys.argv[1]))
print(lib.pio_frontend_port())
"""


def test_six_processes_build_into_one_empty_directory(tmp_path):
    """Six processes start the build at once into an empty directory: one
    compiles under the file lock, the others wait and load the finished
    library; no process sees a half-written file."""
    out_dir = tmp_path / "native_build"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE,
                               str(out_dir)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [o[1] for o in outs]
    assert [o[0].strip() for o in outs] == ["-1"] * 6   # loaded, not started
    built = sorted(p.name for p in out_dir.iterdir())
    lib = port_build.library_path("serving_frontend", out_dir).name
    assert built == [lib, lib + ".lock"]                # no temporaries left


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                          monkeypatch):
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    (src_dir / "serving_frontend.cc").write_text(
        "int main( { return 0; }\n")
    monkeypatch.setattr(port_build, "SOURCE_DIR", src_dir)
    with pytest.raises(RuntimeError) as ei:
        port_build.load_library("serving_frontend", tmp_path / "out")
    assert "g++ failed for serving_frontend.cc" in str(ei.value)
    assert "error" in str(ei.value)
    assert [p.name for p in (tmp_path / "out").iterdir()
            if not p.name.endswith(".lock")] == []
    with pytest.raises(RuntimeError, match="g.. failed"):
        port_frontend.NativeFrontend.__init__.__globals__[
            "load_library"]("serving_frontend", tmp_path / "out")


def test_an_edited_source_builds_a_new_library(tmp_path, monkeypatch):
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    src = src_dir / "serving_frontend.cc"
    src.write_bytes(port_build.source_path("serving_frontend").read_bytes())
    monkeypatch.setattr(port_build, "SOURCE_DIR", src_dir)
    first = port_build.library_path("serving_frontend", tmp_path)
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert port_build.library_path("serving_frontend", tmp_path) != first


# -- the event-log feeder -------------------------------------------------------------

FEEDERS = (SimpleNamespace(name="ref", feeder=ref_feeder),
           SimpleNamespace(name="port", feeder=port_feeder))


@pytest.fixture(params=FEEDERS, ids=lambda p: p.name)
def fd(request):
    return request.param.feeder


def test_feeder_roundtrip_epoch(fd, tmp_path):
    users = np.arange(100, dtype=np.uint32)
    items = (np.arange(100, dtype=np.uint32) * 7) % 31
    vals = np.linspace(0, 1, 100).astype(np.float32)
    path = fd.write_cache(tmp_path / "events.piof", users, items, vals)
    with fd.EventFeeder(path, batch_size=32, seed=1) as f:
        assert len(f) == 100
        got = list(f.epoch())
    assert [len(b[0]) for b in got] == [32, 32, 32, 4]
    all_u = np.concatenate([b[0] for b in got])
    order = np.argsort(all_u)
    np.testing.assert_array_equal(all_u[order], users)
    np.testing.assert_array_equal(np.concatenate([b[1] for b in got])[order],
                                  items)
    np.testing.assert_allclose(np.concatenate([b[2] for b in got])[order],
                               vals)


def test_feeder_extras_and_cats_roundtrip(fd, tmp_path):
    rng = np.random.default_rng(0)
    n = 77
    users = np.arange(n, dtype=np.uint32)
    extras = rng.random((n, 3)).astype(np.float32)
    path = fd.write_cache(tmp_path / "x.piof", users, (users * 3) % 13,
                          rng.random(n).astype(np.float32), extras=extras)
    with fd.EventFeeder(path, batch_size=19, seed=2) as f:
        assert f.n_extra == 3
        got = list(f.epoch())
    all_u = np.concatenate([b[0] for b in got])
    order = np.argsort(all_u)
    np.testing.assert_allclose(np.concatenate([b[3] for b in got])[order],
                               extras)
    cats = np.stack([users, users % 5, users % 7], axis=1)
    path = fd.write_cache(tmp_path / "c.piof", cats=cats)
    with fd.EventFeeder(path, batch_size=32, seed=3) as f:
        assert f.n_cat == 3
        rows = np.concatenate([b[0] for b in f.epoch_cats()])
    np.testing.assert_array_equal(rows[np.argsort(rows[:, 0])], cats)


def test_feeder_epochs_differ_and_repeat_per_seed(fd, tmp_path):
    users = np.arange(64, dtype=np.uint32)
    path = fd.write_cache(tmp_path / "e.piof", users, users)
    with fd.EventFeeder(path, batch_size=64, seed=5) as f:
        e1 = f.next_batch()[0]
        assert f.next_batch() is None
        e2 = f.next_batch()[0]
    assert not np.array_equal(e1, e2)
    with fd.EventFeeder(path, batch_size=64, seed=5) as f:
        np.testing.assert_array_equal(e1, f.next_batch()[0])
    with fd.EventFeeder(path, batch_size=4, shuffle=False) as f:
        np.testing.assert_array_equal(f.next_batch()[0], [0, 1, 2, 3])


def test_feeder_rejects_what_the_reader_cannot_read(fd, tmp_path):
    with pytest.raises(ValueError):
        fd.write_cache(tmp_path / "bad.piof")
    (tmp_path / "junk.piof").write_bytes(b"not a cache at all")
    with pytest.raises(RuntimeError, match="cannot open"):
        fd.EventFeeder(tmp_path / "junk.piof", 4)


@pytest.mark.parametrize("case", ["pairs", "extras", "cats", "ragged"])
def test_both_feeder_libraries_yield_byte_equal_batches(tmp_path, case):
    """One cache, one seed: the reference's library and the port's give
    the same batches, byte for byte, in the same order, over 3 epochs."""
    rng = np.random.default_rng(11)
    n = 1000 if case != "ragged" else 997
    users = rng.integers(0, 50, n).astype(np.uint32)
    items = rng.integers(0, 40, n).astype(np.uint32)
    vals = rng.random(n).astype(np.float32)
    kw = {}
    if case == "extras":
        kw["extras"] = rng.random((n, 2)).astype(np.float32)
    if case == "cats":
        path = port_feeder.write_cache(
            tmp_path / "c.piof", cats=np.stack([users, items, users % 3], 1))
        ref_path = ref_feeder.write_cache(
            tmp_path / "rc.piof",
            cats=np.stack([users, items, users % 3], 1))
    else:
        path = port_feeder.write_cache(tmp_path / "p.piof", users, items,
                                       vals, **kw)
        ref_path = ref_feeder.write_cache(tmp_path / "r.piof", users, items,
                                          vals, **kw)
    assert path.read_bytes() == ref_path.read_bytes()   # one format
    with ref_feeder.EventFeeder(path, 64, seed=17) as a, \
            port_feeder.EventFeeder(path, 64, seed=17) as b:
        for _ in range(3):
            if case == "cats":
                want, got = list(a.epoch_cats()), list(b.epoch_cats())
            else:
                want, got = list(a.epoch()), list(b.epoch())
            assert len(got) == len(want) == -(-n // 64)
            for g, w in zip(got, want):
                assert len(g) == len(w)
                for x, y in zip(g, w):
                    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
