"""The port's Arrow IPC stream codec (``predictionio_tpu_torch.data.ipc``)
against pyarrow, on the reference's segment schema.

Each stream the port writes reads in pyarrow to the table the
reference's ``events_to_arrow`` builds from the same events, and is the
very bytes the reference's ``_table_to_payload`` writes; each stream
the reference writes (one record batch or many) reads in the port to
equal columns.  Hypothesis draws nullable unicode strings (empty,
``None``, astral code points), int64 at its extremes and 0 rows.  What
the codec does not read (a body compression, a dictionary, another
type, big-endian data, broken bytes) raises ``ArrowIpcError``, and a
sealed segment holding such a payload reads as damage: ``read_window``
answers None and the windowed read falls back to the primary store.
"""

import datetime as dt
import json
import zlib

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu.data import DataMap as RefDataMap
from predictionio_tpu.data import Event as RefEvent
from predictionio_tpu.data.columnar import _table_to_payload
from predictionio_tpu.data.storage.base import (
    EVENT_ARROW_SCHEMA,
    events_to_arrow,
)
from predictionio_tpu_torch.data import ipc
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage.base import (
    SEGMENT_FIELDS,
    events_to_segment_columns,
)

UTC = dt.timezone.utc
SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

text = st.text(st.characters(codec="utf-8"), max_size=12)
nullable_text = st.one_of(st.none(), st.just(""), text,
                          st.sampled_from(["\U0001F600", "a\U00010348b"]))
int64 = st.one_of(st.none(), st.integers(-2**63, 2**63 - 1),
                  st.sampled_from([-2**63, 2**63 - 1, 0, -1]))


def _columns(draw_rows):
    """A dict of columns of SEGMENT_FIELDS from rows of field values."""
    return {name: [row[k] for row in draw_rows]
            for k, (name, _) in enumerate(SEGMENT_FIELDS)}


row = st.tuples(*[nullable_text if kind == "utf8" else int64
                  for _, kind in SEGMENT_FIELDS])


def _table(cols):
    return pa.table(cols, schema=EVENT_ARROW_SCHEMA)


def _as_lists(cols):
    return {k: [None if v is None else (int(v) if isinstance(
        v, (np.integer,)) else v) for v in col] for k, col in cols.items()}


@SETTINGS
@given(st.lists(row, max_size=8))
def test_port_streams_are_pyarrows_bytes_and_read_back(rows):
    cols = _columns(rows)
    got = ipc.write_stream(cols, SEGMENT_FIELDS)
    assert pa.ipc.open_stream(got).read_all().equals(_table(cols))
    if rows:   # pyarrow writes no batch for an empty table, as the port
        assert got == _table_to_payload(_table(cols))
    fields, back = ipc.read_stream(got)
    assert fields == list(SEGMENT_FIELDS)
    assert _as_lists(back) == cols


@SETTINGS
@given(st.lists(st.lists(row, max_size=6), max_size=4))
def test_reference_streams_of_many_batches_read_in_the_port(chunks):
    tables = [_table(_columns(c)) for c in chunks]
    merged = pa.concat_tables(tables) if tables \
        else _table(_columns([]))
    payload = _table_to_payload(merged)
    fields, cols = ipc.read_stream(payload)
    assert fields == list(SEGMENT_FIELDS)
    assert _as_lists(cols) == merged.to_pydict()
    assert ipc.stream_rows(payload) == merged.num_rows
    # the port's writer keeps the batches, byte for byte
    _, batches = ipc.read_batches(payload)
    assert ipc.write_batches(batches, SEGMENT_FIELDS) == payload


def _events(pkg_event, pkg_map, rows):
    return [pkg_event(
        event=name, entity_type="user", entity_id=eid,
        target_entity_type=ttype, target_entity_id=tid,
        properties=pkg_map(props),
        event_time=dt.datetime(2026, 1, 1, tzinfo=UTC)
        + dt.timedelta(microseconds=t),
        pr_id=pr, event_id=evid,
        creation_time=dt.datetime(2026, 2, 1, tzinfo=UTC)
        + dt.timedelta(microseconds=c))
        for name, eid, ttype, tid, props, t, pr, evid, c in rows]


json_value = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-2**53, 2**53),
              st.floats(allow_nan=False, allow_infinity=False), text),
    lambda inner: st.lists(inner, max_size=3)
    | st.dictionaries(text, inner, max_size=3), max_leaves=6)
event_row = st.tuples(
    st.sampled_from(["rate", "buy", "$set"]),
    text.filter(bool), st.one_of(st.none(), st.just("item")),
    st.one_of(st.none(), text), st.dictionaries(text, json_value,
                                                max_size=3),
    st.integers(0, 10**12), st.one_of(st.none(), text),
    st.one_of(st.none(), text.filter(bool)), st.integers(0, 10**12))


@SETTINGS
@given(st.lists(event_row, max_size=6))
def test_port_payload_of_events_is_the_references_table(rows):
    """The tee's path: landed events → the segment columns → a payload;
    pyarrow reads it to ``events_to_arrow`` of the same events, and the
    payload is ``_table_to_payload``'s bytes."""
    ref = events_to_arrow(_events(RefEvent, RefDataMap, rows))
    cols = events_to_segment_columns(_events(Event, DataMap, rows))
    payload = ipc.write_stream(cols, SEGMENT_FIELDS)
    assert pa.ipc.open_stream(payload).read_all().equals(ref)
    if rows:
        assert payload == _table_to_payload(ref)


def test_segment_json_is_the_reference_text_for_nested_bags():
    """``json.dumps(to_dict())`` (the segment) and ``json.dumps(dict())``
    (``normalize_event_columns``) give one text for a nested bag."""
    bag = {"a": {"b": [1, 2.5, None, True]}, "c": "\U0001F600", "d": -0.0}
    [ev] = _events(Event, DataMap, [("rate", "u", None, None, bag, 0,
                                      None, None, 0)])
    [ref] = _events(RefEvent, RefDataMap, [("rate", "u", None, None, bag,
                                            0, None, None, 0)])
    text_ = events_to_segment_columns([ev])["properties_json"][0]
    assert text_ == events_to_arrow([ref]).column(
        "properties_json")[0].as_py() == json.dumps(dict(ev.properties))


# -- refusals -----------------------------------------------------------------

def _small():
    return _table({name: (["x", None] if kind == "utf8" else [1, 2])
                   for name, kind in SEGMENT_FIELDS})


def _written(table, **options):
    sink = pa.BufferOutputStream()
    opts = pa.ipc.IpcWriteOptions(**options)
    with pa.ipc.new_stream(sink, table.schema, options=opts) as wr:
        wr.write_table(table)
    return sink.getvalue().to_pybytes()


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_a_compressed_body_is_refused(codec):
    payload = _written(_small(), compression=codec)
    with pytest.raises(ipc.ArrowIpcError, match="compressed"):
        ipc.read_stream(payload)
    with pytest.raises(ipc.ArrowIpcError, match="compressed"):
        ipc.stream_rows(payload)


def test_a_dictionary_is_refused():
    t = pa.table({"event": pa.array(["a", "b", "a"]).dictionary_encode()})
    with pytest.raises(ipc.ArrowIpcError, match="dictionary"):
        ipc.read_stream(_written(t))


@pytest.mark.parametrize("array", [
    pa.array([1.5, 2.0]), pa.array([1, 2], pa.int32()),
    pa.array([True, False]), pa.array([b"x", b"y"]),
    pa.array(["a", "b"], pa.large_string())],
    ids=["float64", "int32", "bool", "binary", "large_utf8"])
def test_another_type_is_refused(array):
    t = pa.table({"event": pa.array(["a", "b"]), "other": array})
    with pytest.raises(ipc.ArrowIpcError, match="'other'"):
        ipc.read_stream(_written(t))


def test_big_endian_is_refused(monkeypatch):
    monkeypatch.setattr(ipc, "_LITTLE_ENDIAN", 1)
    payload = ipc.write_stream({"event": ["a"]}, [("event", "utf8")])
    monkeypatch.undo()
    with pytest.raises(ipc.ArrowIpcError, match="big-endian"):
        ipc.read_stream(payload)


@pytest.mark.parametrize("cut", [1, 9, 100, 601])
def test_broken_bytes_are_refused(cut):
    payload = _table_to_payload(_small())
    with pytest.raises(ipc.ArrowIpcError):
        ipc.read_stream(payload[:cut] + b"\x00" * 3)


@pytest.mark.parametrize("payload", ["compressed", "other_fields"])
def test_a_refused_payload_in_a_sealed_segment_reads_as_damage(tmp_path,
                                                               payload):
    """A block whose CRC holds but whose payload the codec refuses ends
    the scan like a bad CRC, and one of another schema is refused when
    it is decoded: either way ``read_window`` answers None (primary-store
    fallback), as the reference's reader does for any damage."""
    from predictionio_tpu_torch.data.columnar import (
        SegmentStore,
        recover_segment_tail,
    )

    t = [1000.0]
    st_ = SegmentStore(tmp_path, roll_bytes=1 << 30, roll_s=1e9,
                       grace_s=0.0, compact_trigger=0, clock=lambda: t[0])
    ev = Event(event="view", entity_type="user", entity_id="u0",
               event_time=dt.datetime.fromtimestamp(1001, UTC))
    st_.append_events(7, None, [ev])
    t[0] = 1100.0
    st_.seal_all()
    assert st_.read_window(7, None, int(1000e6), 1 << 62) is not None
    [seg] = [p for p in (tmp_path / "app_7" / "default").iterdir()
             if p.suffix == ".seg"]
    row = _table(_columns([("e", "x", None, "u0", None, None, "{}",
                            1001_000_000, None, 0)]))
    if payload == "compressed":
        data = _written(row, compression="zstd")
    else:
        data = _written(row.drop_columns(["pr_id"]))
    block = (len(data).to_bytes(4, "little") + data
             + zlib.crc32(data).to_bytes(4, "little"))
    seg.write_bytes(b"PSEG1\n" + block)
    rec = recover_segment_tail(seg, truncate=False)
    if payload == "compressed":
        assert rec["blocks"] == 0 and rec["torn_bytes"] == len(block)
    else:
        assert rec["blocks"] == 1 and rec["rows"] == 1
    assert st_.read_window(7, None, int(1000e6), 1 << 62) is None
