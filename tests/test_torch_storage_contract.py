"""The port's storage contract — one spec, its ``memory``, ``sqlite``,
``pioserver`` and ``parquetlog`` backends — and the ``PIO_STORAGE_*``
registry.

Cases of the reference's ``tests/test_storage_contract.py``, each one
parametrised test over the four backends (``pioserver``: the remote
client's adapters against a :class:`StorageServer` hosting sqlite, so
every case also runs over the wire; ``parquetlog``: events in Parquet
part files beside sqlite's metadata, the default config's pairing),
with the port's columnar contract (numpy columns; a property bag as a
DataMap on memory, as its JSON text on the others).  Last, the ``pio.db`` file itself: written by the
reference's ``SQLiteClient`` and read by the port's, and the other way
round.
"""

import datetime as dt
import json
import os
from collections.abc import Mapping

import numpy as np
import pytest

from predictionio_tpu_torch.config import load_config, memory_config
from predictionio_tpu_torch.data.columnar import numeric_property
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (
    Storage,
    StorageError,
    get_storage,
    reset_storage,
)
from predictionio_tpu_torch.data.storage.base import (
    EVENT_COLUMNS,
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

UTC = dt.timezone.utc
APP = 7
BACKENDS = ["memory", "sqlite", "pioserver", "parquetlog"]


def ts(s):
    return dt.datetime.fromisoformat(s).replace(tzinfo=UTC)


def _mk(event, eid, t, etype="user", target=None, props=None):
    return Event(
        event=event,
        entity_type=etype,
        entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target,
        properties=DataMap(props or {}),
        event_time=ts(t),
    )


def _bag(p):
    """A property bag of a columnar scan as a plain dict."""
    return dict(p) if isinstance(p, Mapping) else json.loads(p)


class _Repos:
    """The repositories of one backend, each made once."""

    def __init__(self, kind, tmp_path):
        self.server = None
        if kind == "pioserver":
            from types import SimpleNamespace

            from predictionio_tpu_torch.data.storage.remote import (
                RemoteClient, StorageServer)
            from predictionio_tpu_torch.data.storage.sqlite import (
                SQLiteClient)

            self.hosted = SQLiteClient(str(tmp_path / "pio.db"))
            h = self.hosted
            self.server = StorageServer(SimpleNamespace(
                get_events=h.events, get_apps=h.apps,
                get_access_keys=h.access_keys, get_channels=h.channels,
                get_engine_instances=h.engine_instances,
                get_evaluation_instances=h.evaluation_instances,
                get_models=h.models, get_spill_queues=h.spill_queues,
                get_kv=h.kv))
            self.server.start()
            self.client = RemoteClient("127.0.0.1", self.server.port)
            self.events = self.client.events()
            self.apps = self.client.apps()
            self.keys = self.client.access_keys()
            self.channels = self.client.channels()
            self.instances = self.client.engine_instances()
            self.evals = self.client.evaluation_instances()
            self.models = self.client.models()
            self.kv = self.client.kv()
        elif kind == "memory":
            from predictionio_tpu_torch.data.storage import memory as m

            self.client = None
            self.events = m.MemoryEvents()
            self.apps = m.MemoryApps()
            self.keys = m.MemoryAccessKeys()
            self.channels = m.MemoryChannels()
            self.instances = m.MemoryEngineInstances()
            self.evals = m.MemoryEvaluationInstances()
            self.models = m.MemoryModels()
            self.kv = m.MemoryKV()
        else:
            from predictionio_tpu_torch.data.storage.sqlite import (
                SQLiteClient)

            self.client = SQLiteClient(str(tmp_path / "pio.db"))
            self.events = self.client.events()
            if kind == "parquetlog":
                from predictionio_tpu_torch.data.storage.parquet_events \
                    import ParquetEvents

                self.events = ParquetEvents(str(tmp_path / "events"))
            self.apps = self.client.apps()
            self.keys = self.client.access_keys()
            self.channels = self.client.channels()
            self.instances = self.client.engine_instances()
            self.evals = self.client.evaluation_instances()
            self.models = self.client.models()
            self.kv = self.client.kv()


@pytest.fixture(params=BACKENDS)
def repos(request, tmp_path):
    r = _Repos(request.param, tmp_path)
    yield r
    if r.client is not None:
        r.client.close()
    if r.server is not None:
        r.server.stop()
        r.hosted.close()


@pytest.fixture()
def clean_env(tmp_path, monkeypatch):
    home = tmp_path / "pio_home"
    home.mkdir()
    monkeypatch.setenv("PIO_HOME", str(home))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_") or k == "PIO_CONFIG_FILE":
            monkeypatch.delenv(k, raising=False)
    reset_storage()
    yield home
    reset_storage()


# -- events ------------------------------------------------------------------

def _case_requires_init(ev):
    with pytest.raises(StorageError):
        list(ev.find(APP))


def _case_insert_get_delete(ev):
    ev.init(APP)
    eid = ev.insert(_mk("rate", "u1", "2026-01-01T00:00:00", target="i1",
                        props={"rating": 4.5}), APP)
    got = ev.get(eid, APP)
    assert got is not None
    assert got.event == "rate" and got.entity_id == "u1"
    assert got.target_entity_id == "i1"
    assert got.properties.get_double("rating") == 4.5
    assert got.event_time == ts("2026-01-01T00:00:00")
    assert ev.delete(eid, APP) is True
    assert ev.get(eid, APP) is None
    assert ev.delete(eid, APP) is False


def _case_find_filters_and_order(ev):
    ev.init(APP)
    ev.insert_batch([
        _mk("view", "u1", "2026-01-01T00:00:00", target="i1"),
        _mk("buy", "u1", "2026-01-02T00:00:00", target="i2"),
        _mk("view", "u2", "2026-01-03T00:00:00", target="i1"),
        _mk("view", "u1", "2026-01-04T00:00:00", target="i3"),
    ], APP)
    all_ev = list(ev.find(APP))
    assert [e.event_time for e in all_ev] == \
        sorted(e.event_time for e in all_ev)
    assert len(all_ev) == 4
    assert len(list(ev.find(APP, entity_type="user", entity_id="u1"))) == 3
    assert len(list(ev.find(APP, event_names=["view"]))) == 3
    window = list(ev.find(APP, start_time=ts("2026-01-02T00:00:00"),
                          until_time=ts("2026-01-04T00:00:00")))
    assert [e.event for e in window] == ["buy", "view"]
    tgt = list(ev.find(APP, target_entity_type="item", target_entity_id="i1"))
    assert len(tgt) == 2
    newest = list(ev.find(APP, limit=2, reversed=True))
    assert [e.event_time for e in newest] == [ts("2026-01-04T00:00:00"),
                                              ts("2026-01-03T00:00:00")]


def _case_time_window_bounds(ev):
    """start_time inclusive, until_time exclusive — on the row scan and
    the columnar scan — and a naive bound means UTC."""
    ev.init(APP)
    ev.insert_batch([
        _mk("a", "u1", "2026-01-01T00:00:00"),
        _mk("b", "u1", "2026-01-02T00:00:00"),   # exactly at W
        _mk("c", "u1", "2026-01-03T00:00:00"),
    ], APP)
    w = ts("2026-01-02T00:00:00")
    assert [e.event for e in ev.find(APP, until_time=w)] == ["a"]
    assert [e.event for e in ev.find(APP, start_time=w)] == ["b", "c"]
    assert len(ev.find_columnar(APP, start_time=w)["event"]) == 2
    assert len(ev.find_columnar(APP, until_time=w)["event"]) == 1
    naive = dt.datetime(2026, 1, 2)
    assert [e.event for e in ev.find(APP, start_time=naive)] == ["b", "c"]
    assert [e.event for e in ev.find(APP, until_time=naive)] == ["a"]


def _case_equal_event_times_order_by_creation(ev):
    ev.init(APP)
    t = ts("2026-01-01T00:00:00")
    for name, created in (("first", "2026-01-01T10:00:00"),
                          ("second", "2026-01-01T11:00:00")):
        ev.insert(Event(event=name, entity_type="user", entity_id="u1",
                        event_time=t, creation_time=ts(created)), APP)
    assert [e.event for e in ev.find(APP)] == ["first", "second"]
    assert [e.event for e in ev.find(APP, reversed=True)] == \
        ["second", "first"]


def _case_latest_event_time(ev):
    ev.init(APP)
    assert ev.latest_event_time(APP) is None
    ev.insert_batch([
        _mk("a", "u1", "2026-01-02T00:00:00"),
        _mk("b", "u1", "2026-01-05T00:00:00"),
        _mk("c", "u1", "2026-01-03T00:00:00"),
    ], APP)
    assert ev.latest_event_time(APP) == ts("2026-01-05T00:00:00")
    ev.init(APP, channel_id=2)
    assert ev.latest_event_time(APP, 2) is None
    ev.insert(_mk("d", "u1", "2026-02-01T00:00:00"), APP, channel_id=2)
    assert ev.latest_event_time(APP, 2) == ts("2026-02-01T00:00:00")
    assert ev.latest_event_time(APP) == ts("2026-01-05T00:00:00")


def _case_channel_isolation(ev):
    ev.init(APP)
    ev.init(APP, channel_id=2)
    ev.insert(_mk("view", "u1", "2026-01-01T00:00:00"), APP)
    ev.insert(_mk("buy", "u1", "2026-01-02T00:00:00"), APP, channel_id=2)
    assert [e.event for e in ev.find(APP)] == ["view"]
    assert [e.event for e in ev.find(APP, channel_id=2)] == ["buy"]


def _case_remove(ev):
    ev.init(APP)
    ev.insert(_mk("view", "u1", "2026-01-01T00:00:00"), APP)
    assert ev.remove(APP) is True
    with pytest.raises(StorageError):
        list(ev.find(APP))


def _case_find_columnar(ev):
    ev.init(APP)
    ev.insert_batch([
        _mk("rate", "u1", "2026-01-01T00:00:00", target="i1",
            props={"r": 1.0}),
        _mk("rate", "u2", "2026-01-02T00:00:00", target="i2",
            props={"r": 2.0}),
    ], APP)
    table = ev.find_columnar(APP, event_names=["rate"])
    assert list(table) == list(EVENT_COLUMNS)
    assert table["entity_id"].dtype == object
    assert table["event_time_us"].dtype == np.int64
    assert table["entity_id"].tolist() == ["u1", "u2"]
    assert [_bag(p)["r"] for p in table["properties"]] == [1.0, 2.0]
    assert table["event_time_us"].tolist() == [
        int(ts(t).timestamp() * 1e6)
        for t in ("2026-01-01T00:00:00", "2026-01-02T00:00:00")]
    empty = ev.find_columnar(APP, event_names=["nothing"])
    assert [len(c) for c in empty.values()] == [0] * len(EVENT_COLUMNS)


def _case_find_columnar_unordered_and_projected(ev):
    ev.init(APP)
    ev.insert_batch([
        _mk("rate", "u2", "2026-01-02T00:00:00", target="i2",
            props={"r": 2.0}),
        _mk("rate", "u1", "2026-01-01T00:00:00", target="i1",
            props={"r": 1.0}),
        _mk("view", "u3", "2026-01-03T00:00:00", target="i1"),
    ], APP)
    t = ev.find_columnar(APP, event_names=["rate"],
                         columns=["entity_id", "properties"])
    assert list(t) == ["entity_id", "properties"]
    assert sorted(t["entity_id"].tolist()) == ["u1", "u2"]
    t2 = ev.find_columnar(APP, event_names=["rate"], ordered=False,
                          columns=["entity_id"])
    assert sorted(t2["entity_id"].tolist()) == ["u1", "u2"]
    t3 = ev.find_columnar(APP, event_names=["rate"])
    assert t3["entity_id"].tolist() == ["u1", "u2"]
    with pytest.raises(StorageError):
        ev.find_columnar(APP, columns=["bogus"])


def _case_insert_columnar(ev):
    ev.init(APP)
    n = ev.insert_columnar({
        "event": ["rate", "rate", "buy"],
        "entity_type": ["user"] * 3,
        "entity_id": ["u1", "u2", "u1"],
        "target_entity_type": ["item"] * 3,
        "target_entity_id": ["i1", "i2", "i3"],
        "properties": ['{"rating": 4.5}', {"rating": 3.0}, None],
        "event_time_us": [1_700_000_000_000_000 + i for i in range(3)],
    }, APP)
    assert n == 3
    got = list(ev.find(APP))
    assert sorted(e.event for e in got) == ["buy", "rate", "rate"]
    rate1 = next(e for e in got if e.entity_id == "u1" and e.event == "rate")
    assert rate1.properties.get_double("rating") == 4.5
    ids = {e.event_id for e in got}
    assert len(ids) == 3 and None not in ids
    assert ev.get(next(iter(ids)), APP) is not None
    ev.insert(_mk("rate", "u9", "2026-01-05T00:00:00", target="i9",
                  props={"rating": 1.0}), APP)
    t = ev.find_columnar(APP, event_names=["rate"], ordered=False,
                         columns=["entity_id", "properties"])
    assert sorted(t["entity_id"].tolist()) == ["u1", "u2", "u9"]
    assert sorted(numeric_property(t, "rating").tolist()) == [1.0, 3.0, 4.5]


def _case_insert_columnar_validates(ev):
    ev.init(APP)
    with pytest.raises(StorageError):
        ev.insert_columnar({"event": ["x"]}, APP)
    with pytest.raises(StorageError):
        ev.insert_columnar({"event": ["x"], "entity_type": ["u"],
                            "entity_id": ["1"], "bogus": ["y"]}, APP)
    with pytest.raises(StorageError):
        ev.insert_columnar({"event": ["x", None], "entity_type": ["u", "u"],
                            "entity_id": ["1", "2"]}, APP)
    n = ev.insert_columnar({"event": ["x", "y"], "entity_type": ["u", "u"],
                            "entity_id": ["1", "2"],
                            "event_time_us": [1_700_000_000_000_000, None]},
                           APP)
    assert n == 2
    assert all(e.event_time is not None for e in ev.find(APP))


EVENT_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
               if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_events_contract(repos, case):
    EVENT_CASES[case](repos.events)


# -- metadata ------------------------------------------------------------------

def _meta_apps(r):
    apps = r.apps
    aid = apps.insert(App(id=None, name="myapp", description="d"))
    assert aid is not None
    assert apps.get(aid).name == "myapp"
    assert apps.get_by_name("myapp").id == aid
    assert apps.insert(App(id=None, name="myapp")) is None
    assert apps.update(App(id=aid, name="renamed", description=None))
    assert apps.get(aid).name == "renamed"
    assert [a.id for a in apps.get_all()] == [aid]
    assert apps.delete(aid) is True
    assert apps.get(aid) is None


def _meta_access_keys(r):
    keys = r.keys
    k = keys.insert(AccessKey(key="", app_id=3, events=("view",)))
    assert k
    got = keys.get(k)
    assert got.app_id == 3 and tuple(got.events) == ("view",)
    assert keys.get_by_app_id(3)[0].key == k
    assert keys.insert(AccessKey(key=k, app_id=4)) is None
    assert keys.update(AccessKey(key=k, app_id=3, events=("buy",)))
    assert tuple(keys.get(k).events) == ("buy",)
    assert [x.key for x in keys.get_all()] == [k]
    assert keys.delete(k) is True
    assert keys.get(k) is None


def _meta_channels(r):
    ch = r.channels
    cid = ch.insert(Channel(id=None, name="live", app_id=3))
    assert cid is not None
    assert ch.get(cid).name == "live"
    assert ch.insert(Channel(id=None, name="x" * 17, app_id=3)) is None
    assert ch.insert(Channel(id=None, name="bad name", app_id=3)) is None
    assert ch.insert(Channel(id=None, name="live", app_id=3)) is None
    assert [c.id for c in ch.get_by_app_id(3)] == [cid]
    assert ch.delete(cid) is True


def _meta_engine_instances(r):
    insts = r.instances

    def mk(status, t):
        return EngineInstance(
            id=None, status=status, start_time=ts(t), end_time=None,
            engine_id="e1", engine_version="v1", engine_variant="default",
            engine_factory="my.Factory",
            algorithms_params='[{"name":"als","params":{"rank":8}}]')

    i1 = insts.insert(mk("TRAINING", "2026-01-01T00:00:00"))
    i2 = insts.insert(mk("COMPLETED", "2026-01-02T00:00:00"))
    i3 = insts.insert(mk("COMPLETED", "2026-01-03T00:00:00"))
    assert insts.get_latest_completed("e1", "v1", "default").id == i3
    assert [i.id for i in insts.get_completed("e1", "v1", "default")] == \
        [i3, i2]
    inst = insts.get(i1)
    inst.status = "FAILED"
    inst.end_time = ts("2026-01-01T01:00:00")
    assert insts.update(inst)
    assert insts.get(i1).status == "FAILED"
    assert insts.get(i1).end_time == ts("2026-01-01T01:00:00")
    assert json.loads(insts.get(i2).algorithms_params)[0]["params"][
        "rank"] == 8
    assert insts.delete(i1)
    assert sorted(i.id for i in insts.get_all()) == sorted([i2, i3])


def _meta_evaluation_instances(r):
    evals = r.evals
    iid = evals.insert(EvaluationInstance(
        id=None, status="EVALRUNNING", start_time=ts("2026-01-01T00:00:00"),
        end_time=None, evaluation_class="m:evaluation",
        engine_params_generator_class="m:gen"))
    assert evals.get_completed() == []
    inst = evals.get(iid)
    inst.status = "EVALCOMPLETED"
    inst.evaluator_results_json = '{"bestScore": 0.5}'
    assert evals.update(inst)
    [done] = evals.get_completed()
    assert done.id == iid and json.loads(
        done.evaluator_results_json)["bestScore"] == 0.5
    assert [i.id for i in evals.get_all()] == [iid]
    assert evals.delete(iid) and evals.get(iid) is None


def _meta_models(r):
    models = r.models
    models.insert(Model(id="m1", models=b"\x00\x01binary"))
    assert models.get("m1").models == b"\x00\x01binary"
    models.insert(Model(id="m1", models=b"v2"))
    assert models.get("m1").models == b"v2"
    assert models.delete("m1") is True
    assert models.get("m1") is None


def _meta_kv(r):
    kv = r.kv
    assert kv.get("ns", "a") is None
    for i, key in enumerate("abc"):
        kv.put("ns", key, bytes([i]))
    kv.put("other", "a", b"x")
    assert kv.get("ns", "b") == b"\x01" and kv.count("ns") == 3
    assert kv.prune("ns", 2) == 1
    assert kv.count("ns") == 2 and kv.get("other", "a") == b"x"
    assert kv.delete("ns", "c") is True and kv.delete("ns", "c") is False


META_CASES = {name[len("_meta_"):]: fn for name, fn in globals().items()
              if name.startswith("_meta_")}


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_metadata_contract(repos, case):
    if case == "kv":
        import time

        # prune keeps the most recently written: space the writes out
        orig = repos.kv.put

        def put(ns, key, value):
            orig(ns, key, value)
            time.sleep(0.002)

        repos.kv.put = put
    META_CASES[case](repos)


# -- localfs, config and the registry --------------------------------------------

def test_localfs_models(tmp_path):
    from predictionio_tpu_torch.data.storage.localfs_models import (
        LocalFSModels)

    m = LocalFSModels(str(tmp_path / "models"))
    m.insert(Model(id="engine/inst1", models=b"blob"))
    assert m.get("engine/inst1").models == b"blob"
    assert m.delete("engine/inst1") is True
    assert m.get("engine/inst1") is None


def test_config_matches_the_reference(clean_env, monkeypatch, tmp_path):
    """The port's config resolves what the reference's does: defaults,
    a TOML file and env, with env > TOML > defaults."""
    from predictionio_tpu.config import load_config as jax_load_config

    (clean_env / "pio-env.toml").write_text(
        '[storage.repositories.eventdata]\nsource = "memory"\n'
        '[storage.sources.MEMORY]\ntype = "memory"\n'
        '[env]\nPIO_STORAGE_SOURCES_LOCALFS_PATH = "/from/toml"\n')
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LOCALFS_PATH", "/from/env")
    got, want = load_config(), jax_load_config()
    assert got.home == want.home == clean_env
    assert got.repositories["EVENTDATA"].source == "MEMORY"
    assert got.source_for("MODELDATA").path == "/from/env"
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        assert got.repositories[repo] .__dict__ == \
            want.repositories[repo].__dict__
    assert {k: (v.type, v.properties) for k, v in got.sources.items()} == \
        {k: (v.type, v.properties) for k, v in want.sources.items()}


def test_storage_registry_defaults(clean_env):
    s = get_storage()
    assert s is get_storage()
    assert s.verify() == {
        "METADATA": "sqlite", "EVENTDATA": "sqlite", "MODELDATA": "localfs"}
    assert (clean_env / "storage" / "pio.db").exists()
    aid = s.get_apps().insert(App(id=None, name="regapp"))
    ev = s.get_events()
    ev.init(aid)
    ev.insert(_mk("view", "u1", "2026-01-01T00:00:00"), aid)
    assert len(list(ev.find(aid))) == 1
    s.get_models().insert(Model(id="i1", models=b"blob"))
    assert list((clean_env / "storage" / "models").iterdir())
    # a second Storage on the same config (another process, in effect)
    # sees the same rows
    other = Storage()
    assert other.get_apps().get_by_name("regapp").id == aid
    assert len(list(other.get_events().find(aid))) == 1
    assert other.get_models().get("i1").models == b"blob"
    other.close()


def test_memory_config_is_one_process(tmp_path):
    s = Storage(memory_config(tmp_path))
    assert s.verify() == {
        "METADATA": "memory", "EVENTDATA": "memory", "MODELDATA": "memory"}
    aid = s.get_apps().insert(App(id=None, name="m"))
    assert Storage(memory_config(tmp_path)).get_apps().get(aid) is None
    assert not (tmp_path / "storage").exists()
    s.get_kv().put("ns", "k", b"v")
    assert s.get_kv().get("ns", "k") == b"v"


@pytest.mark.parametrize("source_type", ["parquetlog", "pioserver",
                                         "nosuch"])
def test_storage_registry_unknown_type(clean_env, monkeypatch, source_type):
    """The default ``PARQUET`` source gives the port's ``ParquetEvents``
    and a ``parquetlog`` source without ``PATH`` raises the reference's
    message, as a ``pioserver`` one without ``PORTS`` does; an
    unregistered type names the registered ones."""
    if source_type == "parquetlog":
        from predictionio_tpu_torch.data.storage.parquet_events import (
            ParquetEvents)

        # the default config names it, as the reference's does
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE",
                           "PARQUET")
        events = Storage().get_events()
        assert isinstance(events, ParquetEvents)
        assert events.root == clean_env / "storage" / "events"
        monkeypatch.setenv("PIO_STORAGE_SOURCES_PARQUET_PATH", "")
        reset_storage()
        s, getter = Storage(), "get_events"
        message = "parquetlog source PARQUET needs a PATH property."
    else:
        monkeypatch.setenv("PIO_STORAGE_SOURCES_BOGUS_TYPE", source_type)
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE",
                           "BOGUS")
        s, getter = Storage(), "get_apps"
        message = (
            "pioserver source BOGUS needs a PORTS property." if source_type
            == "pioserver" else
            f"Unknown storage source type '{source_type}' (registered: "
            "['localfs', 'memory', 'parquetlog', 'pioserver', 'sqlite'])")
    with pytest.raises(StorageError) as err:
        getattr(s, getter)()
    assert str(err.value) == message


# -- one pio.db, both packages ---------------------------------------------------

def _fill(client_events, apps, keys, channels, event_cls, datamap_cls):
    aid = apps.insert(App(id=None, name="shared", description="x"))
    keys.insert(AccessKey(key="k1", app_id=aid, events=("rate",)))
    cid = channels.insert(Channel(id=None, name="live", app_id=aid))
    client_events.init(aid)
    client_events.init(aid, cid)
    t0 = ts("2026-01-01T00:00:00")
    client_events.insert_batch([
        event_cls(event="rate" if n % 3 else "buy", entity_type="user",
                  entity_id=f"u{n % 4}", target_entity_type="item",
                  target_entity_id=f"i{n % 5}",
                  properties=datamap_cls({"rating": n * 0.5} if n % 3
                                         else {}),
                  event_time=t0 + dt.timedelta(minutes=n),
                  creation_time=t0 + dt.timedelta(hours=1, minutes=n))
        for n in range(12)], aid)
    client_events.insert(event_cls(
        event="view", entity_type="user", entity_id="c1",
        event_time=t0, creation_time=t0), aid, cid)
    return aid, cid


def _rows(events, aid, cid):
    def row(e):
        return (e.event_id, e.event, e.entity_type, e.entity_id,
                e.target_entity_type, e.target_entity_id,
                dict(e.properties), e.event_time, e.pr_id, e.creation_time)

    return ([row(e) for e in events.find(aid)],
            [row(e) for e in events.find(aid, cid)])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pio_db_reads_in_the_other_package(tmp_path, writer):
    """A pio.db the reference's SQLiteClient writes reads in the port's
    with the same apps, keys, channels and events (and the other way
    round); both create the same tables."""
    from predictionio_tpu.data.event import DataMap as JaxDataMap
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu.data.storage.base import (
        AccessKey as JaxAccessKey, App as JaxApp, Channel as JaxChannel)
    from predictionio_tpu.data.storage.sqlite import (
        SQLiteClient as JaxClient)
    from predictionio_tpu_torch.data.storage.sqlite import SQLiteClient

    path = str(tmp_path / "pio.db")
    if writer == "reference":
        w = JaxClient(path, namespace="pio_meta")
        aid, cid = _fill(w.events(), _JaxRepo(w.apps(), JaxApp),
                         _JaxRepo(w.access_keys(), JaxAccessKey),
                         _JaxRepo(w.channels(), JaxChannel),
                         JaxEvent, JaxDataMap)
        r = SQLiteClient(path, namespace="pio_meta")
    else:
        w = SQLiteClient(path, namespace="pio_meta")
        aid, cid = _fill(w.events(), w.apps(), w.access_keys(),
                         w.channels(), Event, DataMap)
        r = JaxClient(path, namespace="pio_meta")
    try:
        assert [(a.id, a.name, a.description) for a in r.apps().get_all()] \
            == [(aid, "shared", "x")]
        [key] = r.access_keys().get_by_app_id(aid)
        assert (key.key, tuple(key.events)) == ("k1", ("rate",))
        assert [(c.id, c.name) for c in r.channels().get_by_app_id(aid)] \
            == [(cid, "live")]
        got = _rows(r.events(), aid, cid)
        want = _rows(w.events(), aid, cid)
        assert got == want and len(got[0]) == 12 and len(got[1]) == 1
        cols = r.events().find_columnar(aid, ordered=False)
        entity = cols["entity_id"]
        entity = entity.to_pylist() if hasattr(entity, "to_pylist") \
            else entity.tolist()
        assert sorted(entity) == sorted(e[3] for e in got[0])
    finally:
        r.close()
        w.close()
    schemas = []
    for client, name in ((JaxClient, "ref.db"), (SQLiteClient, "port.db")):
        c = client(str(tmp_path / name), namespace="pio_meta")
        schemas.append({row[0]: row[1] for row in c._conn.execute(
            "SELECT name, sql FROM sqlite_master")})
        c.close()
    assert schemas[0] == schemas[1]
    assert "pio_meta_events_entity" in schemas[0]


class _JaxRepo:
    """Hands the reference's repositories records of its own types."""

    def __init__(self, repo, record):
        self.repo, self.record = repo, record

    def insert(self, obj):
        return self.repo.insert(self.record(**obj.__dict__))


@pytest.mark.parametrize("scan", ["find", "find_columnar"])
def test_sqlite_reads_one_entity_through_its_index(tmp_path, scan):
    """A read of one entity's events (serve-time fold-in) takes the
    entity index, not a walk of the app's events down the time index,
    and answers what the unpinned query answers."""
    from predictionio_tpu_torch.data.storage.sqlite import SQLiteClient

    client = SQLiteClient(str(tmp_path / "pio.db"), namespace="ev")
    ev = client.events()
    ev.init(APP)
    ev.insert_batch([_mk("rate", f"u{k % 7}", "2026-01-01T00:00:00",
                         target=f"i{k}") for k in range(40)], APP)
    args = (APP, None, None, None, "user", "u3", ["rate"], "item", None)
    sql, params = ev._find_sql(*args, 50, True)
    plan_sql = sql if scan == "find" else \
        f"SELECT entityid FROM {ev._source('user', 'u3')} WHERE " \
        + ev._where(*args)[0]
    plan = " ".join(str(r) for r in client._conn.execute(
        "EXPLAIN QUERY PLAN " + plan_sql, params))
    assert "USING INDEX ev_events_entity (appid=? AND channelid=? AND " \
        "entitytype=? AND entityid=?)" in plan
    got = [e.target_entity_id for e in ev.find(
        APP, entity_type="user", entity_id="u3", event_names=["rate"],
        target_entity_type="item", limit=50, reversed=True)]
    unpinned = [row[7] for row in client._conn.execute(
        sql.replace(" INDEXED BY ev_events_entity", ""), params)]
    assert got == unpinned and len(got) == 6
    cols = ev.find_columnar(APP, entity_type="user", entity_id="u3",
                            columns=["target_entity_id"])
    assert sorted(cols["target_entity_id"].tolist()) == sorted(got)
    client.close()


@pytest.fixture(scope="module")
def tied_pio_db(tmp_path_factory):
    """One pio.db per time pattern, written by the reference: 120 `rate`
    and `buy` events, 60 of them by user `target`; "tied" gives every
    event one event and creation time, "mixed" gives groups of seven one
    time and one creation time apart from the event time."""
    from predictionio_tpu.data.event import DataMap as JaxDataMap
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu.data.storage.sqlite import (
        SQLiteClient as JaxClient)

    t0 = ts("2026-01-01T00:00:00")
    paths = {}
    for pattern in ("tied", "mixed"):
        path = str(tmp_path_factory.mktemp(pattern) / "pio.db")
        client = JaxClient(path, namespace="ev")
        client.events().init(APP)
        evs = []
        for k in range(120):
            t = t0 if pattern == "tied" else \
                t0 + dt.timedelta(seconds=k // 7)
            created = t if pattern == "tied" else \
                t + dt.timedelta(minutes=k % 2)
            evs.append(JaxEvent(
                event="buy" if k % 10 == 4 else "rate", entity_type="user",
                entity_id="target" if k % 2 == 0 else f"u{k}",
                target_entity_type="item", target_entity_id=f"i{k}",
                properties=JaxDataMap({}), event_time=t,
                creation_time=created))
        client.events().insert_batch(evs, APP)
        client.close()
        paths[pattern] = path
    return paths


@pytest.mark.parametrize("pattern", ["tied", "mixed"])
@pytest.mark.parametrize("event_names", [None, ("rate", "buy")])
@pytest.mark.parametrize("limit", [1, 50, None])
@pytest.mark.parametrize("reverse", [True, False])
def test_sqlite_one_entity_read_orders_ties_as_the_reference(
        tied_pio_db, pattern, event_names, limit, reverse):
    """A one-entity read through the entity index answers the ids, in the
    order, that the reference's time-index walk gives: under a limit
    that cuts rows tied in (eventtime, creationtime), newest row first
    when reversed."""
    from predictionio_tpu.data.storage.sqlite import (
        SQLiteClient as JaxClient)
    from predictionio_tpu_torch.data.storage.sqlite import SQLiteClient

    path = tied_pio_db[pattern]
    kw = dict(entity_type="user", entity_id="target",
              event_names=list(event_names) if event_names else None,
              target_entity_type="item", limit=limit, reversed=reverse)
    ref, port = JaxClient(path, namespace="ev"), \
        SQLiteClient(path, namespace="ev")
    try:
        want = [e.target_entity_id for e in ref.events().find(APP, **kw)]
        got = [e.target_entity_id for e in port.events().find(APP, **kw)]
    finally:
        ref.close()
        port.close()
    assert got == want
    assert len(got) == min(limit or 60, 60)
    if pattern == "tied" and limit == 50:
        # the tie is cut: the newest rows when reversed, the oldest not
        assert got[0] == ("i118" if reverse else "i0")
