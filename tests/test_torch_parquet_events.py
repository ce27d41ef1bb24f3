"""The ``parquetlog`` event store across packages: one directory of
Parquet part files, written by the reference's ``ParquetEvents``
(pyarrow) or the port's (its own codec), read by both.

- every read (``find`` with each filter, ``find_columnar`` ordered and
  unordered, projected, ``get``, ``latest_event_time``) gives the same
  rows whichever package wrote the directory;
- the reference's filter semantics, which the segment read's differ
  from: an empty ``event_names`` and ``target_entity_id=""`` (against
  null targets) match nothing, in both packages;
- ties in event and creation time keep the reference's order across
  parts (sorted part names, then rows as written);
- a port ``delete`` in a reference-written file reads right in the
  reference; a batch the reference created under tokens, replayed
  through the port's ``create_batch``, adds no row (and a half-landed
  one only the missing half);
- the slice as a whole: the quickstart loop through both CLIs with
  EVENTDATA on ``PARQUET`` (ids equal except within ties, scores within
  atol 1e-4 + rtol 1e-3), and the port's train over a reference-written
  store within atol 1e-4 + rtol 1e-3 of the reference's train after 3
  iterations, both reading the same files in the same order.
"""

import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.data.event import DataMap as RefDataMap
from predictionio_tpu.data.event import Event as RefEvent
from predictionio_tpu.data.storage.parquet_events import (
    ParquetEvents as RefParquetEvents,
)
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage.base import EVENT_COLUMNS
from predictionio_tpu_torch.data.storage.parquet_events import (
    ParquetEvents,
)
from test_torch_cli import _agree, _clean_env, _variant, _write_events

UTC = dt.timezone.utc
T0 = dt.datetime(2026, 3, 1, tzinfo=UTC)
APP = 3
ATOL, RTOL = 1e-4, 1e-3

PACKAGES = {"reference": (RefParquetEvents, RefEvent, RefDataMap),
            "port": (ParquetEvents, Event, DataMap)}


def _spec(n, event="rate", target="i", props=None, t=None, c=None,
          pr=None, etype="user"):
    return dict(event=event, entity_type=etype, entity_id=f"u{n % 7}",
                target_entity_type="item" if target else None,
                target_entity_id=f"{target}{n % 5}" if target else None,
                properties=props if props is not None else
                {"rating": (n % 10 + 1) * 0.5},
                event_time=t if t is not None else
                T0 + dt.timedelta(minutes=n % 13),
                creation_time=c if c is not None else
                T0 + dt.timedelta(hours=1, seconds=n),
                pr_id=pr)


def _make(cls_event, cls_map, spec):
    s = dict(spec)
    s["properties"] = cls_map(s["properties"])
    return cls_event(**s)


def _columns(specs):
    us = lambda d: int(d.timestamp() * 1_000_000)      # noqa: E731
    return {"event": [s["event"] for s in specs],
            "entity_type": [s["entity_type"] for s in specs],
            "entity_id": [s["entity_id"] for s in specs],
            "target_entity_type": [s["target_entity_type"] for s in specs],
            "target_entity_id": [s["target_entity_id"] for s in specs],
            "event_time_us": [us(s["event_time"]) for s in specs],
            "creation_time_us": [us(s["creation_time"]) for s in specs]}


def _fill(writer, root):
    """A directory with several parts: batches, single inserts (flushed
    by the reads), a columnar batch, a token batch, ties in time across
    parts, null targets, a pr id, a second channel; returns the batch's
    tokens."""
    cls, cls_event, cls_map = PACKAGES[writer]
    ev = cls(str(root))
    ev.init(APP)
    ev.init(APP, 2)
    mk = lambda s: _make(cls_event, cls_map, s)           # noqa: E731
    tie_t, tie_c = T0 + dt.timedelta(minutes=5), T0 + dt.timedelta(hours=2)
    for part in range(3):
        ev.insert_batch([mk(_spec(10 * part + k)) for k in range(8)]
                        + [mk(_spec(99 + part, event="view", t=tie_t,
                                    c=tie_c))], APP)
    ev.insert_batch([mk(_spec(40, event="$set", target=None,
                              props={"genre": "é"}, pr="p1")),
                     mk(_spec(41, event="buy", props={}))], APP)
    for k in range(3):
        ev.insert(mk(_spec(50 + k, event="view", t=tie_t, c=tie_c)), APP)
    if writer == "reference":
        import pyarrow as pa

        cols = _columns([_spec(60 + k) for k in range(6)])
        cols["properties_json"] = ['{"rating": 2.5}'] * 6
        ev.insert_columnar(pa.table(cols), APP)
    else:
        cols = _columns([_spec(60 + k) for k in range(6)])
        cols["properties"] = ['{"rating": 2.5}'] * 6
        ev.insert_columnar(cols, APP)
    tokens = [f"tok.{k}" for k in range(4)]
    ev.create_batch([mk(_spec(70 + k, event="buy")) for k in range(4)],
                    APP, tokens=tokens)
    ev.insert(mk(_spec(80, event="rate")), APP, channel_id=2)
    ev.close()
    return tokens


def _rows(events):
    return [(e.event_id, e.event, e.entity_type, e.entity_id,
             e.target_entity_type, e.target_entity_id,
             e.properties.to_dict(), e.event_time, e.pr_id, e.creation_time)
            for e in events]


def _port_columns(table):
    return {c: v.tolist() for c, v in table.items()}


def _ref_columns(table):
    return {("properties" if c == "properties_json" else c):
            table.column(c).to_pylist() for c in table.column_names}


FIND_KWARGS = [
    {},
    {"reversed": True, "limit": 5},
    {"entity_type": "user", "entity_id": "u3"},
    {"event_names": ["rate", "buy"]},
    {"event_names": []},
    {"target_entity_type": "item", "target_entity_id": "i2"},
    {"target_entity_id": ""},
    {"target_entity_type": ""},
    {"start_time": T0 + dt.timedelta(minutes=5),
     "until_time": T0 + dt.timedelta(minutes=9)},
    {"entity_type": "user", "target_entity_type": "item",
     "event_names": ["rate", "buy"]},
]
COLUMNAR = [
    dict(kw, ordered=ordered, columns=columns)
    for kw in FIND_KWARGS if "limit" not in kw and "reversed" not in kw
    for ordered in (True, False)
    for columns in (None, ["event", "entity_id", "target_entity_id",
                           "properties"])]


@pytest.fixture(params=sorted(PACKAGES))
def written(request, tmp_path):
    root = tmp_path / request.param
    tokens = _fill(request.param, root)
    return request.param, root, tokens


@pytest.mark.parametrize("k", range(len(FIND_KWARGS)))
def test_find_reads_the_same_in_both_packages(written, k):
    _, root, _ = written
    kw = FIND_KWARGS[k]
    want = _rows(RefParquetEvents(str(root)).find(APP, **kw))
    got = _rows(ParquetEvents(str(root)).find(APP, **kw))
    assert got == want
    # the reference's semantics: no name, and a null equals nothing
    empty = kw.get("event_names") == [] or "" in (
        kw.get("target_entity_id"), kw.get("target_entity_type"))
    assert (got == []) if empty else len(got) > 1


@pytest.mark.parametrize("k", range(len(COLUMNAR)))
def test_find_columnar_reads_the_same_in_both_packages(written, k):
    _, root, _ = written
    kw = COLUMNAR[k]
    ref_kw = dict(kw)
    if kw["columns"] is not None:
        ref_kw["columns"] = ["properties_json" if c == "properties" else c
                             for c in kw["columns"]]
    want = _ref_columns(RefParquetEvents(str(root)).find_columnar(
        APP, **ref_kw))
    got = ParquetEvents(str(root)).find_columnar(APP, **kw)
    assert list(got) == list(kw["columns"] or EVENT_COLUMNS)
    if "event_time_us" in got:
        assert got["event_time_us"].dtype == np.int64
    assert _port_columns(got) == want


def test_get_and_latest_event_time_read_the_same(written):
    _, root, tokens = written
    ref, port = RefParquetEvents(str(root)), ParquetEvents(str(root))
    ids = [e.event_id for e in ref.find(APP)]
    assert len(ids) == 42
    for eid in ids[::3] + [f"bt{tokens[1]}", "no-such-id"]:
        want = ref.get(eid, APP)
        got = port.get(eid, APP)
        assert (_rows([got]) if got else None) == \
            (_rows([want]) if want else None)
    assert port.get("no-such-id", APP) is None
    for chan in (None, 2):
        assert port.latest_event_time(APP, chan) == \
            ref.latest_event_time(APP, chan)
    assert port.latest_event_time(APP) == T0 + dt.timedelta(minutes=12)


def test_ties_keep_the_reference_order_across_parts(written):
    """Six views share one event and creation time, in four parts (one
    the flush of three single inserts): both packages order them by part
    name, then as written."""
    _, root, _ = written
    t = T0 + dt.timedelta(minutes=5)
    kw = {"event_names": ["view"], "start_time": t,
          "until_time": t + dt.timedelta(seconds=1)}
    want = [e.event_id for e in RefParquetEvents(str(root)).find(APP, **kw)]
    got = [e.event_id for e in ParquetEvents(str(root)).find(APP, **kw)]
    assert got == want and len(got) == 6
    parts = sorted(p.name for p in (root / f"app_{APP}" / "default").glob(
        "part-*.parquet"))
    assert len(parts) == 7


def test_port_delete_reads_right_in_the_reference(tmp_path):
    root = tmp_path / "ref"
    _fill("reference", root)
    ref = RefParquetEvents(str(root))
    events = _rows(ref.find(APP))
    single = next(r for r in events if r[1] == "$set")[0]   # a 2-row part
    victims = [events[0][0], single, events[-1][0]]
    port = ParquetEvents(str(root))
    for eid in victims:
        assert port.delete(eid, APP) is True
        assert port.delete(eid, APP) is False
    want = [r for r in events if r[0] not in victims]
    assert _rows(RefParquetEvents(str(root)).find(APP)) == want
    assert _rows(port.find(APP)) == want
    for eid in victims:
        assert RefParquetEvents(str(root)).get(eid, APP) is None


@pytest.mark.parametrize("landed", [4, 2])
def test_replayed_token_batch_adds_no_rows(tmp_path, landed):
    """The reference created the batch (all of it, or its first half as
    a crashed landing would leave it); the port's replay of the whole
    batch lands only what is missing and answers the same ids."""
    root = tmp_path / "ev"
    ref = RefParquetEvents(str(root))
    ref.init(APP)
    specs = [_spec(k, event="buy") for k in range(4)]
    tokens = [f"b1.{k}" for k in range(4)]
    ref.create_batch([_make(RefEvent, RefDataMap, s) for s in
                      specs[:landed]], APP, tokens=tokens[:landed])
    port = ParquetEvents(str(root))
    ids = port.create_batch([_make(Event, DataMap, s) for s in specs], APP,
                            tokens=tokens)
    assert ids == [f"bt{t}" for t in tokens]
    rows = _rows(RefParquetEvents(str(root)).find(APP))
    assert sorted(r[0] for r in rows) == sorted(ids)
    assert port.create_batch([_make(Event, DataMap, s) for s in specs], APP,
                             tokens=tokens) == ids
    assert len(list(port.find(APP))) == 4
    assert port.delete(ids[0], APP)
    port.create_batch([_make(Event, DataMap, specs[0])], APP,
                      tokens=tokens[:1])
    assert sorted(e.event_id for e in
                  RefParquetEvents(str(root)).find(APP)) == sorted(ids)


def _parquet_env(monkeypatch, home):
    _clean_env(monkeypatch, home)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE",
                       "PARQUET")


def test_quickstart_parity_on_parquet(tmp_path, monkeypatch, capsys):
    """app new → import → train → batchpredict through each package's
    CLI with EVENTDATA on PARQUET (rank 10, 3 iterations)."""
    from predictionio_tpu.cli.main import main as jax_main
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.data.storage import reset_storage

    src = _write_events(tmp_path / "ev.jsonl")
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(json.dumps({"user": f"u{u}", "num": 6})
                               + "\n" for u in range(20)))
    answers = {}
    try:
        for name, cli, factory, extra in (
                ("reference", jax_main,
                 "predictionio_tpu.templates.recommendation:engine", []),
                ("port", main, "predictionio_tpu_torch.templates."
                 "recommendation:engine", ["--device", "cpu"])):
            home = tmp_path / name
            home.mkdir()
            _parquet_env(monkeypatch, home)
            ej = _variant(home / "engine.json", factory=factory, rank=10,
                          numIterations=3)
            out = home / "pred.jsonl"
            for argv in (["app", "new", "qsapp"],
                         ["import", "--appid", "1", "--input", str(src)],
                         ["train", "--engine-json", str(ej), *extra],
                         ["batchpredict", "--engine-json", str(ej),
                          "--input", str(queries), "--output", str(out),
                          *extra]):
                assert cli(argv) == 0, (name, argv)
            parts = list((home / "storage" / "events").rglob(
                "part-*.parquet"))
            assert parts, name
            assert not (home / "storage" / "pio.db").stat().st_size == 0
            answers[name] = {json.loads(ln)["query"]["user"]:
                             json.loads(ln)["prediction"]
                             for ln in out.read_text().splitlines()}
    finally:
        capsys.readouterr()
        jax_reset()
        reset_storage()
    assert sorted(answers["port"]) == sorted(answers["reference"])
    for user, want in answers["reference"].items():
        _agree(answers["port"][user], want)


def test_port_train_over_a_reference_store(tmp_path, monkeypatch):
    """The reference writes the store (several parts); each package then
    trains on it (rank 8, 3 iterations, same seed): the same numbering
    and factors within atol 1e-4 + rtol 1e-3."""
    from predictionio_tpu.controller import EngineVariant as RefVariant
    from predictionio_tpu.controller import RuntimeContext as RefContext
    from predictionio_tpu.data.storage import App as RefApp
    from predictionio_tpu.data.storage import get_storage as ref_storage
    from predictionio_tpu.data.storage import reset_storage as ref_reset
    from predictionio_tpu.templates.recommendation import (
        engine as ref_engine,
    )
    from predictionio_tpu.workflow.core_workflow import (
        load_models as ref_load,
    )
    from predictionio_tpu.workflow.core_workflow import (
        run_train as ref_train,
    )
    from predictionio_tpu_torch.controller import (
        EngineVariant,
        RuntimeContext,
    )
    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.templates.recommendation import engine
    from predictionio_tpu_torch.workflow.core_workflow import (
        load_models,
        run_train,
    )

    _parquet_env(monkeypatch, tmp_path)
    spec = {"id": "default", "datasource": {"params": {"appName": "pq"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 8, "numIterations": 3, "lambda_": 0.1,
                "seed": 5}}]}
    rng = np.random.default_rng(21)
    try:
        storage = ref_storage()
        app_id = storage.get_apps().insert(RefApp(id=None, name="pq"))
        events = storage.get_events()
        events.init(app_id)
        for part in range(5):
            events.insert_batch([RefEvent(
                event="buy" if k % 9 == 0 else "rate", entity_type="user",
                entity_id=f"u{rng.integers(30)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.zipf(1.3) % 25}",
                properties=RefDataMap({} if k % 9 == 0 else
                                      {"rating": float(rng.integers(1, 11))
                                       * 0.5}),
                event_time=T0 + dt.timedelta(seconds=k))
                for k in range(120)], app_id)
        ref_spec = dict(spec, engineFactory="predictionio_tpu.templates."
                        "recommendation:engine")
        ctx = RefContext.create(storage=storage)
        rid = ref_train(ref_engine(), RefVariant.from_dict(ref_spec), ctx)
        [want] = ref_load(ref_engine(),
                          storage.get_engine_instances().get(rid), ctx)
        port_spec = dict(spec, engineFactory="predictionio_tpu_torch."
                         "templates.recommendation:engine")
        pstorage = get_storage()
        pid = run_train(engine(), EngineVariant.from_dict(port_spec),
                        RuntimeContext.create(storage=pstorage,
                                              device="cpu"))
        [got] = load_models(engine(),
                            pstorage.get_engine_instances().get(pid),
                            RuntimeContext(storage=pstorage, device="cpu"))
    finally:
        ref_reset()
        reset_storage()
    assert list(got.user_index.keys()) == list(want.user_index.keys())
    assert list(got.item_index.keys()) == list(want.item_index.keys())
    uf, itf = got.host_factors()
    np.testing.assert_allclose(uf, np.asarray(want.model.user_factors),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(itf, np.asarray(want.model.item_factors),
                               rtol=RTOL, atol=ATOL)
    assert got.n_examples == want.n_examples
