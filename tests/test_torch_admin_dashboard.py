"""The port's admin server and dashboard against the reference's, on the
CPU, and the port's profiler capture across threads.

One scripted HTTP session runs against each package's ``AdminServer``
(each on its own in-memory store) and one against each package's
``DashboardServer``: every route's status and body must be equal once
access keys, capture paths, instance ids and time stamps are masked.
``/metrics`` and ``/traces.json`` carry timings, so those compare by
status, content type and the names of what they list.  The profile
routes run on injected start/stop callables (200, 409 while a capture
runs, 501 when the platform cannot capture, 404 for an artifact before
any capture), and the artifact's tar member names must be equal.

Then, on the port alone: a capture armed on one thread, with work on a
second and the stop on a third, calls ``torch.profiler`` from one
thread only (its own); a real ``torch.profiler`` capture through ``POST
/admin/profile`` downloads as a tar.gz holding ``trace.json``, through
``GET /admin/profile/artifact`` and through ``pio profile --url``; the
app routes create, list and delete an app as ``pio app list`` sees it.
"""

import datetime as dt
import io
import json
import os
import re
import tarfile
import threading
import time
import urllib.error
import urllib.request

import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.profiler as ref_prof
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.profiler as port_prof
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.data.storage import reset_storage
from predictionio_tpu.data.storage.base import (
    EngineInstance as JaxEngineInstance,
    EvaluationInstance as JaxEvaluationInstance,
)
from predictionio_tpu.server.admin import AdminServer as RefAdmin
from predictionio_tpu.server.dashboard import DashboardServer as RefDash
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EvaluationInstance,
)
from predictionio_tpu_torch.server.admin import AdminServer
from predictionio_tpu_torch.server.dashboard import DashboardServer


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_FLEET", "PIO_PROFILE")):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    reset_storage()
    ref_obs.reset_observability()
    port_obs.reset_observability()
    yield tmp_path
    reset_storage()


def call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class NeverTimer:
    """A capture timer that never fires: the test stops the capture."""

    def __init__(self, interval, fn):
        self.daemon = False

    def start(self):
        pass

    def cancel(self):
        pass


class FakeBackend:
    """Injected start/stop: a start writes the capture's files (so the
    artifact has members); ``fail`` makes the platform unable to
    capture."""

    def __init__(self, fail=None):
        self.fail = fail
        self.calls = []

    def start(self, path):
        if self.fail is not None:
            raise self.fail
        os.makedirs(os.path.join(path, "plugins"), exist_ok=True)
        with open(os.path.join(path, "plugins", "trace.json"), "w") as f:
            f.write('{"traceEvents": []}')
        self.calls.append(("start", path))

    def stop(self):
        self.calls.append(("stop",))


def _session(prof, fail=None):
    backend = FakeBackend(fail)
    return prof.ProfilerSession(
        start_fn=backend.start, stop_fn=backend.stop,
        clock=lambda: 50.0, timer_factory=NeverTimer), backend


def _admin_session(admin_cls, prof, storage, out_dir):
    """The scripted session; returns [(step, status, masked body or tar
    member names, Content-Disposition)]."""
    srv = admin_cls(storage=storage, host="127.0.0.1", port=0)
    srv.start()
    session, _ = _session(prof)
    prev = prof.set_profiler(session)
    keys, steps = {}, []
    base = os.path.basename(out_dir)

    def masked(raw):
        text = raw.decode()
        for k, label in keys.items():
            text = text.replace(k, label)
        return json.loads(text.replace(out_dir, "<out>"))

    def step(name, method, path, body=None):
        st, head, raw = call(srv.port, method, path, body)
        if head.get("Content-Type") == "application/gzip":
            with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
                got = sorted(m.name.replace(base, "<base>")
                             for m in tar.getmembers())
        else:
            got = masked(raw)
        disp = (head.get("Content-Disposition") or "").replace(base,
                                                                "<base>")
        steps.append((name, st, got, disp))
        return st, got

    try:
        step("alive", "GET", "/")
        step("no apps", "GET", "/v1/cmd/app")
        st, raw = None, call(srv.port, "POST", "/v1/cmd/app",
                             json.dumps({"name": "adm1",
                                         "description": "d"}).encode())
        created = json.loads(raw[2])
        keys[created["accessKey"]] = "<key1>"
        steps.append(("create", raw[0], masked(raw[2]), ""))
        step("create again", "POST", "/v1/cmd/app",
             json.dumps({"name": "adm1"}).encode())
        step("create without name", "POST", "/v1/cmd/app", b"{}")
        step("create bad json", "POST", "/v1/cmd/app", b"{nope")
        st2 = call(srv.port, "POST", "/v1/cmd/app",
                   json.dumps({"name": "adm2"}).encode())
        keys[json.loads(st2[2])["accessKey"]] = "<key2>"
        step("list", "GET", "/v1/cmd/app")
        step("wipe data", "DELETE", "/v1/cmd/app/adm1/data")
        step("delete missing", "DELETE", "/v1/cmd/app/nope")
        step("unknown route", "GET", "/v1/nope")
        step("timeline", "GET", "/timeline.json")
        step("timeline chrome", "GET", "/timeline.json?format=chrome")
        step("profile idle", "GET", "/admin/profile")
        step("artifact before any", "GET", "/admin/profile/artifact")
        step("bad duration", "POST", "/admin/profile?duration_ms=abc")
        step("negative duration", "POST", "/admin/profile?duration_ms=-5")
        step("arm", "POST",
             f"/admin/profile?duration_ms=1500&out={out_dir}")
        step("arm while busy", "POST", "/admin/profile?duration_ms=100")
        step("profile busy", "GET", "/admin/profile")
        step("artifact while busy", "GET", "/admin/profile/artifact")
        step("profile put", "DELETE", "/admin/profile")
        session.stop()
        step("profile done", "GET", "/admin/profile")
        step("artifact", "GET", "/admin/profile/artifact")
        unavailable, _ = _session(prof, fail=prof.ProfilerUnavailable(
            "no profiler on this platform"))
        prof.set_profiler(unavailable)
        step("unavailable", "POST", "/admin/profile?duration_ms=100")
        step("delete", "DELETE", "/v1/cmd/app/adm1")
        step("list after", "GET", "/v1/cmd/app")
    finally:
        prof.set_profiler(prev)
        srv.stop()
    return steps


def test_admin_routes_equal_the_reference(env):
    ref = _admin_session(RefAdmin, ref_prof, jax_storage(),
                         str(env / "ref_capture"))
    port = _admin_session(AdminServer, port_prof,
                          Storage(memory_config(env / "port")),
                          str(env / "port_capture"))
    assert [s[:2] for s in port] == [s[:2] for s in ref]
    assert port == ref
    statuses = {name: st for name, st, _, _ in port}
    assert (statuses["arm"], statuses["arm while busy"],
            statuses["unavailable"], statuses["artifact before any"],
            statuses["artifact while busy"], statuses["artifact"]) == \
        (200, 409, 501, 404, 409, 200)
    members = dict((s[0], s[2]) for s in port)["artifact"]
    assert members == ["<base>", "<base>/plugins",
                       "<base>/plugins/trace.json"]


def _instances(storage, engine_cls, eval_cls):
    t0 = dt.datetime(2026, 1, 2, 3, 4, 5, tzinfo=dt.timezone.utc)
    ids = [storage.get_engine_instances().insert(engine_cls(
        id=None, status=status, start_time=t0 + dt.timedelta(minutes=n),
        end_time=t0 + dt.timedelta(minutes=n, seconds=30),
        engine_id="e", engine_version="0.1.0", engine_variant="default",
        engine_factory="x.y:engine<b>"))
        for n, status in enumerate(("COMPLETED", "FAILED"))]
    ids.append(storage.get_evaluation_instances().insert(eval_cls(
        id=None, status="EVALCOMPLETED", start_time=t0, end_time=t0,
        evaluation_class="a.b:Ev", engine_params_generator_class="a.b:G",
        evaluator_results="score 0.5 & <more>",
        evaluator_results_json='{"score": 0.5}')))
    return ids


def _dashboard_session(dash_cls, storage, ids, fleet):
    srv = dash_cls(storage=storage, host="127.0.0.1", port=0, fleet=fleet)
    srv.start()
    out = []
    try:
        for method, path in (
                ("GET", "/"), ("GET", "/engine_instances.json"),
                ("GET", "/evaluation_instances.json"),
                ("GET", "/fleet.json"), ("GET", "/quality.json"),
                ("GET", "/timeline.json"), ("GET", "/timeline.json?n=3"),
                ("GET", "/nope"), ("POST", "/"), ("GET", "/traces.json"),
                ("GET", "/metrics"), ("GET", "/metrics?exemplars=1")):
            st, head, raw = call(srv.port, method, path,
                                 b"{}" if method == "POST" else None)
            text = raw.decode()
            for n, iid in enumerate(ids):
                text = text.replace(iid, f"<I{n}>")
            if path.startswith("/metrics"):
                # timings: the names of the series, not their values
                body = sorted({ln.split(" ")[0] for ln in text.splitlines()
                               if ln.startswith("pio_dashboard")})
            elif path == "/traces.json":
                body = [t["name"] for t in json.loads(text)["traces"]]
            elif path in ("/fleet.json", "/quality.json") and fleet:
                doc = json.loads(text)
                doc.pop("scrapedAt", None)
                body = doc
            else:
                body = text
            out.append((method, path, st, head.get("Content-Type"), body))
    finally:
        srv.stop()
    return out


@pytest.mark.parametrize("fleet", [None, ["http://127.0.0.1:9"]],
                         ids=["no_fleet", "dead_fleet"])
def test_dashboard_routes_equal_the_reference(env, fleet):
    rs = jax_storage()
    ps = Storage(memory_config(env / "port"))
    ref = _dashboard_session(RefDash, rs, _instances(
        rs, JaxEngineInstance, JaxEvaluationInstance), fleet)
    ref_obs.reset_observability()
    port = _dashboard_session(DashboardServer, ps, _instances(
        ps, EngineInstance, EvaluationInstance), fleet)
    assert port == ref
    got = {(m, p): (st, body) for m, p, st, _, body in port}
    assert "x.y:engine&lt;b&gt;" in got[("GET", "/")][1]
    if fleet is None:
        assert "PIO_FLEET_INSTANCES" in got[("GET", "/fleet.json")][1]
    else:
        [row] = got[("GET", "/fleet.json")][1]["instances"]
        assert row["stale"] is True and "error" in row


# -- the capture thread -------------------------------------------------------

class RecordingProfile:
    """A stand-in ``torch.profiler.profile``: records the thread of each
    call."""

    calls = []

    def start(self):
        self.calls.append(("start", threading.current_thread().name))

    def stop(self):
        self.calls.append(("stop", threading.current_thread().name))

    def export_chrome_trace(self, path):
        self.calls.append(("export", threading.current_thread().name))
        with open(path, "w") as f:
            f.write('{"traceEvents": []}')


def test_capture_is_held_by_one_thread_across_arm_work_and_stop(tmp_path):
    """Armed on thread A, work launched on thread B, stopped on thread
    C: every call into the profiler runs on the capture's own thread
    (a stop on another thread than the start crashes torch.profiler)."""
    RecordingProfile.calls = []
    backend = port_prof._TorchCapture(profile_factory=RecordingProfile)
    session = port_prof.ProfilerSession(
        start_fn=backend.start, stop_fn=backend.stop,
        timer_factory=NeverTimer)
    out = str(tmp_path / "cap")
    names = {}

    def run(name, fn):
        def body():
            names[name] = threading.current_thread().name
            fn()
        t = threading.Thread(target=body, name=f"test-{name}")
        t.start()
        t.join()

    import torch

    run("arm", lambda: session.start(1000, out))
    run("work", lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert session.status()["active"] is True
    run("stop", session.stop)
    assert [c[0] for c in RecordingProfile.calls] == \
        ["start", "stop", "export"]
    assert {c[1] for c in RecordingProfile.calls} == {"pio-profiler"}
    assert not set(names.values()) & {"pio-profiler"}
    assert os.path.exists(os.path.join(out, port_prof.TRACE_FILE))
    assert session.status() == {"active": False, "lastPath": out}
    # A capture of one call starts and stops on the calling thread, so
    # the call's own operators are recorded.
    RecordingProfile.calls = []
    run("call", lambda: session.capture_call(str(tmp_path / "call"),
                                             lambda: None))
    assert RecordingProfile.calls == [("start", "test-call"),
                                      ("stop", "test-call"),
                                      ("export", "test-call")]


def test_a_failed_start_arms_nothing_and_leaves_no_thread(tmp_path):
    class Broken(RecordingProfile):
        def start(self):
            raise RuntimeError("no CUPTI here")

    before = threading.active_count()
    backend = port_prof._TorchCapture(profile_factory=Broken)
    session = port_prof.ProfilerSession(
        start_fn=backend.start, stop_fn=backend.stop,
        timer_factory=NeverTimer)
    with pytest.raises(port_prof.ProfilerUnavailable, match="no CUPTI"):
        session.start(100, str(tmp_path / "cap"))
    assert session.status() == {"active": False, "lastPath": None}
    assert threading.active_count() == before


def _wait_idle(port):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st, _, raw = call(port, "GET", "/admin/profile")
        if not json.loads(raw)["active"]:
            return
        time.sleep(0.05)
    raise AssertionError("the capture never finished")


def test_real_capture_through_the_admin_route_and_pio_profile(env, capsys):
    """torch.profiler on the CPU: POST /admin/profile arms it from a
    handler thread, its timer stops it, the artifact holds trace.json;
    `pio profile --url --out` downloads the same way, and the local
    `pio profile` captures this process."""
    from predictionio_tpu_torch.cli.main import main as pio

    prev = port_prof.set_profiler(port_prof.ProfilerSession())
    srv = AdminServer(storage=Storage(memory_config(env / "port")),
                      host="127.0.0.1", port=0)
    srv.start()
    try:
        out = str(env / "cap1")
        st, _, raw = call(srv.port, "POST",
                          f"/admin/profile?duration_ms=200&out={out}")
        assert st == 200 and json.loads(raw)["path"] == out
        assert call(srv.port, "POST", "/admin/profile?duration_ms=200"
                    )[0] == 409
        _wait_idle(srv.port)
        st, head, raw = call(srv.port, "GET", "/admin/profile/artifact")
        assert st == 200 and head["Content-Disposition"] == \
            'attachment; filename="cap1.tar.gz"'
        with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
            assert sorted(m.name for m in tar.getmembers()) == \
                ["cap1", "cap1/trace.json"]
            doc = json.load(tar.extractfile("cap1/trace.json"))
        assert "traceEvents" in doc
        dest = env / "downloads"
        dest.mkdir()
        assert pio(["profile", "--url", f"http://127.0.0.1:{srv.port}",
                    "--duration-ms", "150", "--out", str(dest)]) == 0
        said = capsys.readouterr().out
        m = re.search(r"Profile archive downloaded: (\S+) \(", said)
        assert m and os.path.basename(m.group(1)).startswith("pio_profile_")
        with tarfile.open(m.group(1), mode="r:gz") as tar:
            assert any(n.endswith("/trace.json") for n in tar.getnames())
        local = str(env / "local")
        assert pio(["profile", "--duration-ms", "50", "--out", local]) == 0
        assert f"Profile captured: {local}" in capsys.readouterr().out
        assert os.path.exists(os.path.join(local, port_prof.TRACE_FILE))
    finally:
        srv.stop()
        port_prof.set_profiler(prev)


def test_app_routes_as_pio_app_list_sees_them(env, monkeypatch, capsys):
    """Apps made and deleted over the admin routes, on the default
    sqlite store, read back through `pio app list` in the same home."""
    from predictionio_tpu_torch.cli.main import main as pio
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.data.storage import (
        reset_storage as port_reset,
    )

    for k in ("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE",
              "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"):
        monkeypatch.delenv(k, raising=False)
    port_reset()
    srv = AdminServer(storage=get_storage(), host="127.0.0.1", port=0)
    srv.start()
    try:
        st, _, raw = call(srv.port, "POST", "/v1/cmd/app",
                          json.dumps({"name": "viaadmin"}).encode())
        assert st == 201
        key = json.loads(raw)["accessKey"]
        assert pio(["app", "list"]) == 0
        said = capsys.readouterr().out
        assert re.search(rf"viaadmin\s+1\s+{re.escape(key)}", said)
        st, _, raw = call(srv.port, "GET", "/v1/cmd/app")
        assert json.loads(raw) == [{"name": "viaadmin", "id": 1,
                                    "accessKeys": [key]}]
        assert call(srv.port, "DELETE", "/v1/cmd/app/viaadmin")[0] == 200
        assert pio(["app", "list"]) == 0
        said = capsys.readouterr().out
        assert "viaadmin" not in said and "Finished listing 0 app(s)." in said
    finally:
        srv.stop()
        port_reset()
