"""The port's Parquet codec (``predictionio_tpu_torch/data/parquet.py``)
against pyarrow, which the reference writes its event store with.

- hypothesis-generated event columns (nulls in every field, empty and
  non-ASCII strings, int64 extremes) written by the port read in
  ``pyarrow.parquet.read_table`` as equal columns of types ``string``
  and ``int64``, in one row group and in several;
- the same columns written by ``pq.write_table`` read in the port as
  equal columns, at pyarrow's defaults (snappy, dictionary) and under
  options that force the hard cases: several row groups, several pages,
  a dictionary that outgrows its limit (PLAIN pages after dictionary
  pages in one chunk), no compression, no dictionary;
- the snappy decoder against pyarrow's own codec on hypothesis bytes,
  long repeats (overlapping copies) included;
- refusals: a V2 data page, zstd, a truncated footer, a wrong magic, a
  repeated field and a float column each raise ``ParquetError``.

The module skips itself where pyarrow is absent.
"""

import io

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu_torch.data import parquet
from predictionio_tpu_torch.data.parquet import ParquetError
from predictionio_tpu_torch.data.storage.base import SEGMENT_FIELDS

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

I64 = (-2 ** 63, 2 ** 63 - 1, 0, -1, 1)
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _arrow_schema():
    return pa.schema([pa.field(name, pa.string() if kind == "utf8"
                               else pa.int64()) for name, kind in
                      SEGMENT_FIELDS])


@st.composite
def event_columns(draw, max_rows=60):
    """Columns of the event schema with nulls in every field, empty and
    non-ASCII strings and the int64 extremes; a few distinct values so
    that dictionaries form."""
    n = draw(st.integers(0, max_rows))
    text = st.one_of(st.none(), st.sampled_from(["", "rate", "é", "用户",
                                                 "a\x00b"]),
                     st.text(max_size=8))
    ints = st.one_of(st.none(), st.sampled_from(I64),
                     st.integers(-2 ** 63, 2 ** 63 - 1))
    return {name: draw(st.lists(text if kind == "utf8" else ints,
                                min_size=n, max_size=n))
            for name, kind in SEGMENT_FIELDS}


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, col in want.items():
        assert list(got[name]) == list(col), name


@SETTINGS
@given(cols=event_columns(), row_group_rows=st.sampled_from([7, 1 << 20]))
def test_port_writes_and_pyarrow_reads(cols, row_group_rows):
    data = parquet.table_bytes(cols, SEGMENT_FIELDS, row_group_rows)
    table = pq.read_table(io.BytesIO(data))
    assert table.schema.equals(_arrow_schema())
    _assert_equal(table.to_pydict(), cols)
    n = len(cols["event"])
    assert pq.ParquetFile(io.BytesIO(data)).metadata.num_row_groups == \
        -(-n // row_group_rows)
    _assert_equal(_read(data), cols)


def _read(data, columns=None):
    return parquet.read_table(io.BytesIO(data), columns)


# pq.write_table options: pyarrow's defaults and the hard cases
WRITE_OPTIONS = {
    "defaults": {},
    "row_groups": {"row_group_size": 7},
    "pages": {"data_page_size": 64, "write_batch_size": 4},
    "dictionary_fallback": {"dictionary_pagesize_limit": 32,
                            "data_page_size": 64, "write_batch_size": 4},
    "uncompressed": {"compression": "none"},
    "no_dictionary": {"use_dictionary": False},
}


@pytest.mark.parametrize("option", sorted(WRITE_OPTIONS))
@SETTINGS
@given(cols=event_columns())
def test_pyarrow_writes_and_port_reads(option, cols):
    buf = io.BytesIO()
    pq.write_table(pa.table(cols, schema=_arrow_schema()), buf,
                   **WRITE_OPTIONS[option])
    _assert_equal(_read(buf.getvalue()), cols)
    proj = ["properties_json", "event_time_us", "entity_id"]
    got = _read(buf.getvalue(), proj)
    assert list(got) == proj
    _assert_equal(got, {c: cols[c] for c in proj})


def _chunk_pages(data, column):
    """(page type, encoding) of every page of the first row group's
    chunk of ``column``, read with the codec's own Thrift reader."""
    f = io.BytesIO(data)
    meta = parquet._footer(f)
    names = [el[4].decode() for el in meta[2][1:]]
    cmeta = meta[4][0][1][names.index(column)][3]
    start = min(v for v in (cmeta[9], cmeta.get(11)) if v)
    buf = data[start:start + cmeta[7]]
    pos, pages = 0, []
    while pos < len(buf):
        header, pos = parquet._read_struct(buf, pos)
        pos += header[3]
        dph = header.get(5) or header.get(7)
        pages.append((header[1], dph[2]))
    return pages


def test_the_hard_cases_are_what_pyarrow_wrote():
    """The options above really make pyarrow write several row groups,
    several pages and a PLAIN page after dictionary pages in one chunk;
    the port reads each file as it was written, ids past the fallback
    included."""
    n = 3000
    rng = np.random.default_rng(5)
    cols = {name: ([f"id-{k:06d}-é" for k in range(n)] if name ==
                   "event_id" else
                   [None if k % 11 == 0 else f"u{v}" for k, v in
                    enumerate(rng.integers(0, 40, n))] if kind == "utf8"
                   else rng.integers(-2 ** 62, 2 ** 62, n).tolist())
            for name, kind in SEGMENT_FIELDS}
    table = pa.table(cols, schema=_arrow_schema())
    buf = io.BytesIO()
    pq.write_table(table, buf, row_group_size=1000, data_page_size=2048,
                   dictionary_pagesize_limit=4096, write_batch_size=64)
    data = buf.getvalue()
    assert pq.ParquetFile(io.BytesIO(data)).metadata.num_row_groups == 3
    pages = _chunk_pages(data, "event_id")
    kinds = [(ptype, enc) for ptype, enc in pages]
    assert kinds[0] == (2, 0)                      # the dictionary page
    assert (0, 8) in kinds and (0, 0) in kinds     # dictionary, then PLAIN
    assert kinds.index((0, 0)) > kinds.index((0, 8))
    assert sum(1 for p, _ in pages if p == 0) > 2
    _assert_equal(_read(data), cols)


def test_port_written_string_chunks_choose_their_encoding():
    """A low-cardinality column is dictionary-encoded, an id column
    (its first 65,536 values distinct) PLAIN; pyarrow reads both."""
    n = 70_000
    cols = {name: ([f"e{k}" for k in range(n)] if name == "event_id"
                   else [f"v{k % 300}" for k in range(n)] if kind == "utf8"
                   else list(range(n)))
            for name, kind in SEGMENT_FIELDS}
    data = parquet.table_bytes(cols, SEGMENT_FIELDS)
    md = pq.ParquetFile(io.BytesIO(data)).metadata.row_group(0)
    enc = {md.column(k).path_in_schema: md.column(k).encodings
           for k in range(md.num_columns)}
    assert "RLE_DICTIONARY" in enc["entity_id"]
    assert "RLE_DICTIONARY" not in enc["event_id"]
    assert pq.read_table(io.BytesIO(data)).to_pydict() == cols


repeats = st.lists(st.tuples(st.binary(min_size=1, max_size=9),
                             st.integers(1, 400)), max_size=8).map(
    lambda parts: b"".join(p * k for p, k in parts))


@SETTINGS
@given(data=st.one_of(st.binary(max_size=5000), repeats,
                      st.tuples(st.binary(max_size=200), repeats,
                                st.binary(max_size=200)).map(b"".join)))
def test_snappy_decodes_what_pyarrow_compresses(data):
    packed = pa.compress(data, codec="snappy", asbytes=True)
    assert parquet.snappy_decompress(packed) == data


def test_snappy_refuses_a_copy_before_the_start():
    # length 4, then a 1-byte-offset copy 5 back with nothing written
    with pytest.raises(ParquetError):
        parquet.snappy_decompress(bytes([4, 0b000_001_01, 5]))


def _written(**options):
    cols = {name: (["a", None, "b"] if kind == "utf8" else [1, 2, None])
            for name, kind in SEGMENT_FIELDS}
    buf = io.BytesIO()
    pq.write_table(pa.table(cols, schema=_arrow_schema()), buf, **options)
    return buf.getvalue()


REFUSED = {
    "data_page_v2": lambda: _written(data_page_version="2.0"),
    "zstd": lambda: _written(compression="zstd"),
    "truncated_footer": lambda: _written()[:-30],
    "wrong_magic": lambda: b"PAR2" + _written()[4:],
    "footer_length": lambda: (lambda d: d[:-8] + (len(d)).to_bytes(
        4, "little") + b"PAR1")(_written()),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_raise_parquet_error(case):
    with pytest.raises(ParquetError):
        _read(REFUSED[case]())


@pytest.mark.parametrize("column", [
    pa.array([["a"], None, ["b", "c"]], pa.list_(pa.string())),
    pa.array([1.5, None, 2.0], pa.float64()),
    pa.array([b"x", None, b"y"], pa.binary()),
    pa.array([{"a": 1}, None, {"a": 2}], pa.struct([("a", pa.int64())])),
])
def test_other_types_and_nesting_raise_parquet_error(column):
    buf = io.BytesIO()
    pq.write_table(pa.table({"c": column}), buf)
    with pytest.raises(ParquetError):
        _read(buf.getvalue())
