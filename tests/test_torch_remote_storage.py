"""The port's storage server and ``pioserver`` client against the
reference's, on the CPU.

The wire protocol is the reference's (``data/storage/remote.py``): a
port client talks to a reference server and a reference client to a
port server.  One scripted session — app and event inserts, a streamed
``find`` of 25,001 events over 13 cursor pages, filtered and reversed
reads, deletes and a model blob — gives the same rows in all four
(client, server) pairings, and leaves the same rows in the hosted
sqlite file.  Then, in both packages: a wrong secret closes the
connection, a write whose reply was lost after commit lands one row on
its resend, and an unreachable server raises ``StorageUnavailable`` —
nothing falls back to a local store.
"""

import datetime as dt
import json
import os
import re
import select
import socket
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import predictionio_tpu.data.event as ref_event
import predictionio_tpu.data.storage.base as ref_base
import predictionio_tpu.data.storage.remote as ref_remote
import predictionio_tpu.data.storage.sqlite as ref_sqlite
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.resilience.faults as ref_faults
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_base
import predictionio_tpu_torch.data.storage.remote as port_remote
import predictionio_tpu_torch.data.storage.sqlite as port_sqlite
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.resilience.faults as port_faults

PKGS = {
    "reference": SimpleNamespace(
        remote=ref_remote, base=ref_base, event=ref_event,
        sqlite=ref_sqlite, faults=ref_faults,
        registry=ref_obs.get_registry),
    "port": SimpleNamespace(
        remote=port_remote, base=port_base, event=port_event,
        sqlite=port_sqlite, faults=port_faults,
        registry=port_obs.get_registry),
}
ROOT = Path(__file__).resolve().parents[1]
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
N_EVENTS = 25_000
SECRET = "s3cret"


def _hosted(pkg, path):
    """The repository getters of ``pkg``'s sqlite file at ``path``, as a
    ``pio storageserver`` hosts them."""
    c = pkg.sqlite.SQLiteClient(str(path))
    return c, SimpleNamespace(
        get_events=c.events, get_apps=c.apps,
        get_access_keys=c.access_keys, get_channels=c.channels,
        get_engine_instances=c.engine_instances,
        get_evaluation_instances=c.evaluation_instances,
        get_models=c.models, get_spill_queues=c.spill_queues,
        get_kv=c.kv)


class _Wire:
    """A ``server_pkg`` StorageServer over its own sqlite file, and a
    ``client_pkg`` RemoteClient to it."""

    def __init__(self, client_pkg, server_pkg, path, secret=None,
                 client_secret=None):
        self.sql, storage = _hosted(PKGS[server_pkg], path)
        self.server = PKGS[server_pkg].remote.StorageServer(
            storage, secret=secret)
        self.server.start()
        self.client = PKGS[client_pkg].remote.RemoteClient(
            "127.0.0.1", self.server.port, secret=client_secret)

    def close(self):
        self.client.close()
        self.server.stop()
        self.sql.close()


def _row(ev):
    """An event as comparable values: the store's ids and stamps aside."""
    return (ev.event, ev.entity_type, ev.entity_id, ev.target_entity_type,
            ev.target_entity_id, json.dumps(ev.properties.to_dict(),
                                            sort_keys=True),
            ev.event_time.isoformat())


def _session(pkg, client):
    """The scripted session through ``client`` (of package ``pkg``)."""
    base, event = pkg.base, pkg.event
    apps, events, models = client.apps(), client.events(), client.models()
    out = {}
    app_id = apps.insert(base.App(id=None, name="wire", description="d"))
    out["app"] = (app_id, apps.get_by_name("wire").name,
                  apps.insert(base.App(id=None, name="wire")))
    assert events.init(app_id) is True
    ids = events.insert_batch([
        event.Event(event="rate", entity_type="user",
                    entity_id=f"u{i % 500}", target_entity_type="item",
                    target_entity_id=f"i{i % 97}",
                    properties=event.DataMap({"rating": i % 5 + 0.5}),
                    event_time=T0 + dt.timedelta(seconds=i))
        for i in range(N_EVENTS)], app_id)
    one = events.insert(event.Event(
        event="buy", entity_type="user", entity_id="u7",
        target_entity_type="item", target_entity_id="i3",
        properties=event.DataMap({"price": 9.5, "tags": ["a", "b"]}),
        event_time=T0 + dt.timedelta(days=1)), app_id)
    out["ids"] = (len(ids), len(set(ids)), isinstance(one, str))
    out["scan"] = [_row(e) for e in events.find(app_id)]
    out["get"] = _row(events.get(one, app_id))
    out["deleted"] = [events.delete(ids[k], app_id)
                      for k in (0, 7, N_EVENTS - 1)] + \
        [events.delete("nope", app_id)]
    out["entity"] = [_row(e) for e in events.find(
        app_id, entity_type="user", entity_id="u7")]
    out["reversed"] = [_row(e) for e in events.find(
        app_id, event_names=["rate"], limit=5, reversed=True)]
    out["latest"] = events.latest_event_time(app_id).isoformat()
    blob = bytes(range(256)) * 64
    models.insert(base.Model(id="m1", models=blob))
    out["model"] = models.get("m1").models == blob
    out["model_gone"] = (models.delete("m1"), models.get("m1"))
    with pytest.raises(pkg.base.StorageError):
        list(events.find(app_id + 1))       # never initialised
    return out


def _stored(pkg_name, path):
    """The events the hosted sqlite file holds, read by its own package."""
    c = PKGS[pkg_name].sqlite.SQLiteClient(str(path))
    try:
        app = c.apps().get_by_name("wire")
        return [_row(e) for e in c.events().find(app.id)]
    finally:
        c.close()


def _run(client_pkg, server_pkg, tmp_path):
    path = tmp_path / f"{client_pkg}-{server_pkg}.db"
    wire = _Wire(client_pkg, server_pkg, path)
    try:
        out = _session(PKGS[client_pkg], wire.client)
    finally:
        wire.close()
    return out, _stored(server_pkg, path)


@pytest.fixture(scope="module")
def reference_session(tmp_path_factory):
    return _run("reference", "reference", tmp_path_factory.mktemp("ref"))


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "reference"), ("reference", "port"), ("port", "port")],
    ids=["port-client-reference-server", "reference-client-port-server",
         "port-both"])
def test_one_session_gives_equal_rows_across_the_wire(
        reference_session, tmp_path, client_pkg, server_pkg):
    want, want_stored = reference_session
    got, got_stored = _run(client_pkg, server_pkg, tmp_path)
    assert len(got["scan"]) == N_EVENTS + 1
    assert got["deleted"] == [True, True, True, False]
    for key in want:
        assert got[key] == want[key], key
    assert got_stored == want_stored
    assert len(got_stored) == N_EVENTS + 1 - 3


def test_a_scan_streams_in_cursor_pages(tmp_path, monkeypatch):
    """``find`` reads the 25,001 events as ``find_open`` plus 12
    ``find_next`` pages of 2,000 on one connection."""
    wire = _Wire("port", "port", tmp_path / "pages.db")
    calls = []
    real = port_remote.StorageServer._cursor_page

    def page(cursors, cid, n):
        calls.append(n)
        return real(cursors, cid, n)

    monkeypatch.setattr(port_remote.StorageServer, "_cursor_page",
                        staticmethod(page))
    try:
        _session(PKGS["port"], wire.client)
    finally:
        wire.close()
    # the full scan, the one-entity read (1 page), the reversed read
    # (1 page), the uninitialised app (raises at find_open: no page)
    assert calls[:13] == [2000] * 13
    assert len(calls) == 15


def _raw(port, frame):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    payload = json.dumps(frame).encode()
    s.sendall(struct.pack(">I", len(payload)) + payload)
    head = s.recv(4)
    (n,) = struct.unpack(">I", head)
    reply = json.loads(s.recv(n))
    closed = s.recv(1) == b""
    s.close()
    return reply, closed


@pytest.mark.parametrize("server_pkg", ["reference", "port"])
def test_a_wrong_secret_closes_the_connection(tmp_path, server_pkg):
    wire = _Wire(server_pkg, server_pkg, tmp_path / "auth.db",
                 secret=SECRET, client_secret=SECRET)
    try:
        assert wire.client.apps().get_all() == []
        port = wire.server.port
        assert _raw(port, {"auth": "wrong"}) == (
            {"err": "auth required", "storage_error": False}, True)
        assert _raw(port, {"m": "apps.get_all", "a": [], "k": {}}) == (
            {"err": "auth required", "storage_error": False}, True)
        for client_pkg in PKGS:
            bad = PKGS[client_pkg].remote.RemoteClient(
                "127.0.0.1", port, secret="wrong", retries=0)
            with pytest.raises(PKGS[client_pkg].remote.RemoteBackendError,
                               match="rejected auth: auth required"):
                bad.apps().get_all()
            bad.close()
    finally:
        wire.close()


def _lost_reply(pkg_name, server_pkg, tmp_path):
    """One insert whose first reply is lost after the server committed;
    returns (rows stored, the id answered = the id stored, RPC
    retries counted)."""
    pkg = PKGS[pkg_name]
    pkg.registry().reset()
    wire = _Wire(pkg_name, server_pkg, tmp_path / f"{pkg_name}.db")
    try:
        app_id = wire.client.apps().insert(pkg.base.App(id=None,
                                                        name="wire"))
        events = wire.client.events()
        events.init(app_id)
        pkg.faults.install("rpc.recv:error:1.0:1")
        try:
            eid = events.insert(pkg.event.Event(
                event="view", entity_type="user", entity_id="u1",
                event_time=T0), app_id)
        finally:
            pkg.faults.clear()
        rows = list(events.find(app_id))
        retries = pkg.registry().get("pio_rpc_retries_total").value()
    finally:
        wire.close()
    return len(rows), [r.event_id for r in rows] == [eid], retries


@pytest.mark.parametrize("server_pkg", ["reference", "port"])
def test_a_resent_write_lands_one_row(tmp_path, server_pkg):
    got = {pkg: _lost_reply(pkg, server_pkg, tmp_path) for pkg in PKGS}
    assert got["port"] == got["reference"] == (1, True, 1)


def test_an_unreachable_server_raises_storage_unavailable(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    client = port_remote.RemoteClient("127.0.0.1", dead, timeout=2,
                                      retries=1)
    with pytest.raises(port_base.StorageUnavailable,
                       match="unreachable during apps.get_all"):
        client.apps().get_all()
    with pytest.raises(port_base.StorageUnavailable,
                       match="unreachable during events.find_open"):
        list(client.events().find(1))
    client.close()


def _storageserver(home, *argv):
    """``pio storageserver`` of the port in a subprocess over ``home``;
    returns (process, port) once it printed its client lines."""
    env = {**os.environ, "PIO_HOME": str(home), "PYTHONPATH": str(ROOT)}
    env = {k: v for k, v in env.items() if not k.startswith("PIO_STORAGE_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "storageserver",
         "--ip", "127.0.0.1", "--port", "0", *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    line = proc.stdout.readline() if ready else ""
    m = re.match(r"Storage server listening on 127\.0\.0\.1:(\d+) ", line)
    if not m:
        proc.kill()
        raise AssertionError((line, proc.communicate()[1]))
    assert proc.stdout.readline().startswith(
        "Clients: PIO_STORAGE_SOURCES_REMOTE_TYPE=pioserver ")
    return proc, int(m.group(1))


def test_pioserver_sources_reach_the_server_and_nothing_else(
        tmp_path, monkeypatch):
    """Every repository on ``type=pioserver`` behind a ``pio
    storageserver`` process: rows land in its store; with the process
    killed every read raises ``StorageUnavailable`` and no local store
    appears under the client's ``PIO_HOME``."""
    from predictionio_tpu_torch.data.storage import (
        Storage,
        StorageUnavailable,
    )

    home, hosted = tmp_path / "client_home", tmp_path / "hosted_home"
    home.mkdir()
    hosted.mkdir()
    proc, port = _storageserver(hosted, "--secret", SECRET)
    monkeypatch.setenv("PIO_HOME", str(home))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_TYPE", "pioserver")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_HOSTS", "127.0.0.1")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_PORTS", str(port))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_SECRET", SECRET)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_RETRIES", "1")
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                           "REMOTE")
    st = Storage()
    try:
        assert st.verify() == {"METADATA": "pioserver",
                               "EVENTDATA": "pioserver",
                               "MODELDATA": "pioserver"}
        aid = st.get_apps().insert(port_base.App(id=None, name="remote"))
        st.get_events().init(aid)
        st.get_events().insert(port_event.Event(
            event="view", entity_type="user", entity_id="u1",
            event_time=T0), aid)
        st.get_models().insert(port_base.Model(id="m", models=b"blob"))
        st.get_kv().put("ns", "k", b"v")
        assert st.get_models().get("m").models == b"blob"
        db = str(hosted / "storage" / "pio.db")
        meta = port_sqlite.SQLiteClient(db, namespace="pio_meta")
        evdata = port_sqlite.SQLiteClient(db, namespace="pio_event")
        try:
            assert meta.apps().get(aid).name == "remote"
            assert [e.entity_id for e in evdata.events().find(aid)] == \
                ["u1"]
            assert evdata.kv().get("ns", "k") == b"v"
        finally:
            meta.close()
            evdata.close()
        assert any((hosted / "storage" / "models").iterdir())
        proc.kill()
        proc.wait(timeout=30)
        for read in (lambda: st.get_apps().get_all(),
                     lambda: list(st.get_events().find(aid)),
                     lambda: st.get_models().get("m"),
                     lambda: st.get_engine_instances().get_all()):
            with pytest.raises(StorageUnavailable):
                read()
    finally:
        st.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert not (home / "storage").exists()


@pytest.mark.parametrize("workflow", ["train", "eval"])
def test_a_workflow_over_pioserver_completes_its_instance(tmp_path,
                                                          workflow):
    """``run_train`` and ``run_evaluation`` with every repository on
    ``pioserver`` finish their rows (COMPLETED / EVALCOMPLETED) and keep
    the models under the row's id.  The insert's answer is the id: over
    the wire the caller's object is not filled in, and on that object
    the final update used to write to no row (the reference's train
    still leaves its row TRAINING there)."""
    from predictionio_tpu_torch.config import load_config
    from predictionio_tpu_torch.controller import (
        EngineVariant,
        RuntimeContext,
    )
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.templates.recommendation import engine
    from predictionio_tpu_torch.templates.recommendation import (
        evaluation as port_eval,
    )
    from predictionio_tpu_torch.workflow.core_workflow import (
        run_evaluation,
        run_train,
    )
    from test_torch_recommendation_eval import APP, _fill, _specs

    hosted = Storage(load_config(env={"PIO_HOME": str(tmp_path / "h")}))
    server = port_remote.StorageServer(hosted)
    server.start()
    env = {"PIO_HOME": str(tmp_path / "c"),
           "PIO_STORAGE_SOURCES_REMOTE_TYPE": "pioserver",
           "PIO_STORAGE_SOURCES_REMOTE_PORTS": str(server.port)}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "REMOTE"
    client = Storage(load_config(env=env))
    try:
        _fill(client, port_base.App, port_event.Event, port_event.DataMap,
              _specs())
        ctx = RuntimeContext.create(storage=client, device="cpu")
        if workflow == "train":
            iid = run_train(engine(), EngineVariant.from_dict({
                "id": "default",
                "engineFactory":
                    "predictionio_tpu_torch.templates.recommendation:engine",
                "datasource": {"params": {"appName": APP}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 4, "numIterations": 2, "lambda_": 0.05,
                    "seed": 3}}]}), ctx)
            assert hosted.get_engine_instances().get(iid).status == \
                "COMPLETED"
            assert hosted.get_models().get(iid) is not None
        else:
            iid, _ = run_evaluation(
                port_eval.RecommendationEvaluation(k=5),
                port_eval.default_params_generator(app_name=APP, eval_k=2,
                                                   ranks=(4,)), ctx)
            assert hosted.get_evaluation_instances().get(iid).status == \
                "EVALCOMPLETED"
    finally:
        client.close()
        server.stop()
        hosted.close()
    assert not (tmp_path / "c" / "storage").exists()
