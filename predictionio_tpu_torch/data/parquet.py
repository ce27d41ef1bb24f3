"""A Parquet codec for the event table, in numpy and ``struct`` (no
pyarrow).

The ``parquetlog`` event store
(:mod:`predictionio_tpu_torch.data.storage.parquet_events`) keeps the
reference's files, which the reference writes with
``pyarrow.parquet.write_table``.  This module reads and writes exactly
the part of the format such a file uses: flat schemas of optional or
required ``BYTE_ARRAY`` (String / UTF8) and ``INT64`` columns, any
number of row groups and pages, data pages V1, definition levels (max
level 1), PLAIN values, dictionary pages with ``RLE_DICTIONARY`` /
``PLAIN_DICTIONARY`` data pages (and PLAIN pages after them in the same
chunk, where pyarrow's dictionary outgrew its limit), uncompressed or
SNAPPY (decoded by the raw-format decoder below).  Anything else (a
``DATA_PAGE_V2``, another codec or encoding, a repeated or nested
field, another physical type, a bad magic or footer) raises
:class:`ParquetError`.

Layout (the public ``parquet.thrift``): ``PAR1``, the column chunks,
the ``FileMetaData`` in Thrift's compact protocol, its length as a
little-endian uint32, ``PAR1``.  Every page starts with a compact
``PageHeader``.  The reader decodes every Thrift struct generically
(field id → value), so fields it does not use (statistics, size
statistics, page indexes, ``ARROW:schema``) cost nothing and a newer
writer's extra fields are skipped.

What the writer writes: every field optional, strings as ``BYTE_ARRAY``
with logical type String (converted type UTF8), data pages V1 of about
1 MiB, row groups of at most :data:`ROW_GROUP_ROWS` rows, nothing
compressed.  A string column chunk is dictionary-encoded unless its
dictionary would pass :data:`DICTIONARY_LIMIT` (8 MiB of PLAIN values;
pyarrow falls back to PLAIN pages past 1 MiB) or its first 65,536
values are all distinct (an id column), decided once per chunk; the
indices go into one bit-packed run a page.  The reason is the read: a
PLAIN byte-array page can only be walked value by value, while a
dictionary chunk decodes as one numpy gather of the decoded dictionary
by its indices, and the training read projects exactly the
low-cardinality columns (MovieLens-25M's 162,541 user ids come to about
1.8 MB, past pyarrow's limit and well inside this one).  ``INT64`` columns are PLAIN.  pyarrow reads
these files as the table that was written (``string`` and ``int64``
fields); their bytes are not pyarrow's, which nothing depends on.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ParquetError", "UTF8", "INT64", "ROW_GROUP_ROWS",
           "DICTIONARY_LIMIT", "write_table", "table_bytes", "read_table",
           "snappy_decompress"]

UTF8, INT64 = "utf8", "int64"

ROW_GROUP_ROWS = 1 << 20     # pyarrow's default row group size
DICTIONARY_LIMIT = 8 << 20   # a string chunk's dictionary, at most
PAGE_BYTES = 1 << 20         # pyarrow's default data_page_size

_MAGIC = b"PAR1"
_U32 = struct.Struct("<I")
_CREATED_BY = "predictionio_tpu_torch.data.parquet version 1.0.0"

# parquet.thrift enums
_BYTE_ARRAY, _INT64_TYPE = 6, 2
_REQUIRED, _OPTIONAL, _REPEATED = 0, 1, 2
_CONVERTED_UTF8, _CONVERTED_INT_64 = 0, 18
_UNCOMPRESSED, _SNAPPY = 0, 1
_PLAIN, _PLAIN_DICTIONARY, _RLE, _RLE_DICTIONARY = 0, 2, 3, 8
_DATA_PAGE, _INDEX_PAGE, _DICTIONARY_PAGE, _DATA_PAGE_V2 = 0, 1, 2, 3
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
           4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}

# Thrift compact protocol type ids
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = 1, 2, 3, 4, 5, 6
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = \
    7, 8, 9, 10, 11, 12


class ParquetError(ValueError):
    """A file outside what this codec reads (another page version,
    codec, encoding, type or nesting), or bytes that are not a
    well-formed Parquet file."""


# -- Thrift compact protocol ---------------------------------------------------

def _varint(buf, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 70:
            raise ParquetError("a varint runs past 10 bytes")


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf, pos: int, kind: int):
    if kind in (_T_TRUE, _T_FALSE):          # a bool inside a list
        return buf[pos] == _T_TRUE, pos + 1
    if kind == _T_BYTE:
        return struct.unpack_from("<b", buf, pos)[0], pos + 1
    if kind in (_T_I16, _T_I32, _T_I64):
        n, pos = _varint(buf, pos)
        return _zigzag(n), pos
    if kind == _T_DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if kind == _T_BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ParquetError("a binary field runs past its buffer")
        return bytes(buf[pos:pos + n]), pos + n
    if kind in (_T_LIST, _T_SET):
        head = buf[pos]
        pos += 1
        size, elem = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        out = []
        for _ in range(size):
            v, pos = _read_value(buf, pos, elem)
            out.append(v)
        return out, pos
    if kind == _T_MAP:
        size, pos = _varint(buf, pos)
        out = {}
        if size:
            types = buf[pos]
            pos += 1
            for _ in range(size):
                k, pos = _read_value(buf, pos, types >> 4)
                out[k], pos = _read_value(buf, pos, types & 0x0F)
        return out, pos
    if kind == _T_STRUCT:
        return _read_struct(buf, pos)
    raise ParquetError(f"unknown Thrift compact type {kind}")


def _read_struct(buf, pos: int) -> Tuple[Dict[int, object], int]:
    """One compact struct as {field id: value}, every field decoded (a
    field the codec does not use is read past and ignored)."""
    out: Dict[int, object] = {}
    last = 0
    while True:
        head = buf[pos]
        pos += 1
        if head == 0:
            return out, pos
        kind, delta = head & 0x0F, head >> 4
        if delta:
            fid = last + delta
        else:
            n, pos = _varint(buf, pos)
            fid = _zigzag(n)
        if kind in (_T_TRUE, _T_FALSE):
            out[fid] = kind == _T_TRUE
        else:
            out[fid], pos = _read_value(buf, pos, kind)
        last = fid


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _write_value(kind: int, value) -> bytes:
    if kind in (_T_I16, _T_I32, _T_I64):
        return _uvarint((value << 1) ^ (value >> 63))
    if kind == _T_BINARY:
        data = value.encode() if isinstance(value, str) else bytes(value)
        return _uvarint(len(data)) + data
    if kind == _T_STRUCT:
        return _write_struct(value)
    raise ParquetError(f"the writer has no Thrift type {kind}")


def _write_struct(fields: Sequence[Tuple[int, int, object]]) -> bytes:
    """A compact struct of ``(field id, type, value)`` in field-id order;
    a list is ``(id, (_T_LIST, element type), values)``."""
    out = bytearray()
    last = 0
    for fid, kind, value in fields:
        tid = kind[0] if isinstance(kind, tuple) else kind
        if 0 < fid - last <= 15:
            out.append(((fid - last) << 4) | tid)
        else:
            out.append(tid)
            out += _uvarint((fid << 1) ^ (fid >> 15))
        if tid == _T_LIST:
            elem = kind[1]
            n = len(value)
            out.append((n << 4 | elem) if n < 15 else (0xF0 | elem))
            if n >= 15:
                out += _uvarint(n)
            for v in value:
                out += _write_value(elem, v)
        else:
            out += _write_value(tid, value)
        last = fid
    out.append(0)
    return bytes(out)


# -- snappy (raw block format), decode only ------------------------------------

def snappy_decompress(data) -> bytes:
    """Snappy's raw block format: a varint of the uncompressed length,
    then literal and copy elements.  A copy that overlaps the bytes it
    writes repeats its source as a byte-by-byte copy would."""
    buf = bytes(data)
    try:
        want, pos = _varint(buf, 0)
        out = bytearray()
        size = 0                  # len(out), kept by hand: it is hot
        end = len(buf)
        while pos < end:
            tag = buf[pos]
            pos += 1
            kind = tag & 3
            if kind == 0:
                n = (tag >> 2) + 1
                if n > 60:
                    extra = n - 60
                    n = int.from_bytes(buf[pos:pos + extra], "little") + 1
                    pos += extra
                if pos + n > end:
                    raise ParquetError("a snappy literal runs past the block")
                out += buf[pos:pos + n]
                pos += n
                size += n
                continue
            if kind == 1:
                n = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                n = (tag >> 2) + 1
                off = buf[pos] | (buf[pos + 1] << 8)
                pos += 2
            else:
                n = (tag >> 2) + 1
                off = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            if not 0 < off <= size:
                raise ParquetError(f"a snappy copy reaches {off} bytes back "
                                   f"of {size}")
            start = size - off
            if off >= n:
                out += out[start:start + n]
            else:
                out += (out[start:] * -(-n // off))[:n]
            size += n
    except IndexError as e:
        raise ParquetError(f"a snappy block ends early: {e}") from e
    if size != want:
        raise ParquetError(f"a snappy block gave {size} bytes, not {want}")
    return bytes(out)


# -- the RLE / bit-packed hybrid -------------------------------------------------

def _unpack_bits(data, width: int, count: int) -> np.ndarray:
    """``count`` little-endian bit-packed values of ``width`` bits."""
    if width == 0:
        return np.zeros(count, np.uint32)
    raw = np.frombuffer(data, np.uint8)
    bits = np.unpackbits(raw, bitorder="little", count=count * width)
    wide = np.zeros((count, 32), np.uint8)
    wide[:, :width] = bits.reshape(count, width)
    return np.packbits(wide, axis=1, bitorder="little").view("<u4").ravel()


def _pack_bits(values: np.ndarray, width: int) -> bytes:
    bits = ((values.astype(np.uint32)[:, None]
             >> np.arange(width, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def _rle_decode(buf, width: int, n: int) -> np.ndarray:
    """The first ``n`` values of an RLE / bit-packed hybrid run list."""
    parts: List[np.ndarray] = []
    got = pos = 0
    value_bytes = (width + 7) // 8
    while got < n:
        if pos >= len(buf):
            raise ParquetError(f"an RLE run list ends after {got} of {n} "
                               "values")
        header, pos = _varint(buf, pos)
        if header & 1:
            count = (header >> 1) * 8
            nbytes = (header >> 1) * width
            chunk = bytes(buf[pos:pos + nbytes])
            pos += nbytes
            if len(chunk) < nbytes:           # a short final group
                chunk += bytes(nbytes - len(chunk))
            parts.append(_unpack_bits(chunk, width, count))
        else:
            count = header >> 1
            if count == 0:
                raise ParquetError("an RLE run of length 0")
            value = int.from_bytes(buf[pos:pos + value_bytes], "little")
            pos += value_bytes
            parts.append(np.full(count, value, np.uint32))
        got += count
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return out[:n]


def _rle_bit_packed(values: np.ndarray, width: int) -> bytes:
    """One bit-packed run of ``values`` (padded to a group of 8)."""
    groups = -(-len(values) // 8)
    padded = np.zeros(groups * 8, np.uint32)
    padded[:len(values)] = values
    return _uvarint(groups << 1 | 1) + _pack_bits(padded, width)


def _levels(valid: Optional[np.ndarray], n: int) -> bytes:
    """Definition levels (max 1) with their V1 length prefix: one RLE run
    of 1 when no value is null, else one bit-packed run."""
    if valid is None:
        body = _uvarint(n << 1) + b"\x01"
    else:
        body = _rle_bit_packed(valid.astype(np.uint32), 1)
    return struct.pack("<I", len(body)) + body


# -- PLAIN values ---------------------------------------------------------------

def _plain_strings(values: Sequence[str]) -> bytes:
    """PLAIN ``BYTE_ARRAY``: each value as a uint32 length and its
    UTF-8 bytes, built in numpy."""
    m = len(values)
    if m == 0:
        return b""
    text = "".join(values)
    raw = text.encode()
    if len(raw) == len(text):             # ASCII: a char is a byte
        lens = np.fromiter(map(len, values), np.int64, count=m)
    else:
        lens = np.fromiter((len(v.encode()) for v in values), np.int64,
                           count=m)
    heads = np.arange(m, dtype=np.int64) * 4
    heads[1:] += np.cumsum(lens)[:-1]
    out = np.empty(4 * m + len(raw), np.uint8)
    at = (heads[:, None] + np.arange(4)).ravel()
    out[at] = lens.astype("<u4").view(np.uint8)
    data = np.ones(len(out), bool)
    data[at] = False
    out[data] = np.frombuffer(raw, np.uint8)
    return out.tobytes()


def _decode_strings(buf, n: int) -> np.ndarray:
    """``n`` PLAIN ``BYTE_ARRAY`` values as an object array of str."""
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    mv = memoryview(buf)
    (first,) = struct.unpack_from("<I", mv, 0)
    width = 4 + first
    if len(mv) >= n * width:
        rows = np.frombuffer(mv, np.uint8, count=n * width).reshape(n, width)
        if (rows[:, :4].copy().view("<u4").ravel() == first).all():
            raw = rows[:, 4:].tobytes()          # every value one length
            text = raw.decode()
            if len(text) == len(raw):            # ASCII: slice the text
                out[:] = [text[k * first:(k + 1) * first] for k in range(n)]
            else:
                out[:] = [raw[k * first:(k + 1) * first].decode()
                          for k in range(n)]
            return out
    data = bytes(mv)
    unpack = _U32.unpack_from
    starts = [0] * n
    pos = 0
    for k in range(n):
        starts[k] = pos + 4
        pos += 4 + unpack(data, pos)[0]
    if pos > len(data):
        raise ParquetError("a byte array runs past its page")
    ends = [a - 4 for a in starts[1:]] + [pos]
    out[:] = [data[a:b].decode() for a, b in zip(starts, ends)]
    return out


def _decode_plain(buf, kind: str, n: int) -> np.ndarray:
    if kind == UTF8:
        return _decode_strings(buf, n)
    if len(buf) < 8 * n:
        raise ParquetError("an INT64 page is short")
    return np.frombuffer(buf, "<i8", count=n).astype(np.int64)


# -- reader -------------------------------------------------------------------------

def _footer(f) -> Dict[int, object]:
    f.seek(0, os.SEEK_END)
    size = f.tell()
    if size < 12:
        raise ParquetError(f"{size} bytes are too few for a Parquet file")
    f.seek(0)
    if f.read(4) != _MAGIC:
        raise ParquetError("the file does not start with PAR1")
    f.seek(size - 8)
    tail = f.read(8)
    if tail[4:] != _MAGIC:
        raise ParquetError("the file does not end with PAR1")
    (length,) = struct.unpack("<I", tail[:4])
    if length > size - 12:
        raise ParquetError(f"a footer of {length} bytes in a file of {size}")
    f.seek(size - 8 - length)
    meta, _ = _read_struct(f.read(length), 0)
    return meta


def _schema(meta) -> List[Tuple[str, str, int]]:
    """(name, kind, max definition level) of each leaf."""
    elems = meta.get(2) or []
    if not elems:
        raise ParquetError("the file has no schema")
    root = elems[0]
    if root.get(5, 0) != len(elems) - 1:
        raise ParquetError("the schema is nested")
    fields = []
    for el in elems[1:]:
        name = el[4].decode()
        if el.get(5):
            raise ParquetError(f"field {name!r} is a nested group")
        rep = el.get(3, _REQUIRED)
        if rep == _REPEATED:
            raise ParquetError(f"field {name!r} is repeated")
        ptype = el.get(1)
        logical = el.get(10) or {}
        if ptype == _BYTE_ARRAY and (1 in logical
                                     or el.get(6) == _CONVERTED_UTF8):
            kind = UTF8
        elif ptype == _INT64_TYPE and (
                logical.get(10, {}) == {1: 64, 2: True} if logical
                else el.get(6, _CONVERTED_INT_64) == _CONVERTED_INT_64):
            kind = INT64
        else:
            raise ParquetError(f"field {name!r} has physical type {ptype} "
                               f"(logical {sorted(logical)}); this codec "
                               "reads String byte arrays and INT64")
        fields.append((name, kind, 1 if rep == _OPTIONAL else 0))
    return fields


def _decompress(page, codec: int, size: int) -> bytes:
    if codec == _UNCOMPRESSED:
        data = bytes(page)
    elif codec == _SNAPPY:
        data = snappy_decompress(page)
    else:
        raise ParquetError(f"codec {_CODECS.get(codec, codec)} is not "
                           "UNCOMPRESSED or SNAPPY")
    if len(data) != size:
        raise ParquetError(f"a page holds {len(data)} bytes, its header "
                           f"says {size}")
    return data


def _read_chunk(f, cmeta, kind: str, max_def: int, name: str):
    """One column chunk as a list of (values, valid or None) a page."""
    codec = cmeta[4]
    total = cmeta[5]
    start = cmeta[9]
    dict_off = cmeta.get(11)
    if dict_off is not None and 0 < dict_off < start:
        start = dict_off
    f.seek(start)
    buf = memoryview(f.read(cmeta[7]))
    pos = got = 0
    dictionary = None
    pages = []
    while got < total:
        header, pos = _read_struct(buf, pos)
        ptype, size, csize = header[1], header[2], header[3]
        if pos + csize > len(buf):
            raise ParquetError(f"column {name!r}: a page runs past its chunk")
        body = buf[pos:pos + csize]
        pos += csize
        if ptype == _DATA_PAGE_V2:
            raise ParquetError(f"column {name!r} holds a DATA_PAGE_V2")
        if ptype == _INDEX_PAGE:
            continue
        page = _decompress(body, codec, size)
        if ptype == _DICTIONARY_PAGE:
            dph = header[7]
            if dph.get(2, _PLAIN) not in (_PLAIN, _PLAIN_DICTIONARY):
                raise ParquetError(f"column {name!r}: dictionary encoding "
                                   f"{dph.get(2)}")
            dictionary = _decode_plain(page, kind, dph[1])
            continue
        if ptype != _DATA_PAGE:
            raise ParquetError(f"column {name!r}: page type {ptype}")
        dph = header[5]
        n, enc = dph[1], dph[2]
        valid, at = None, 0
        if max_def:
            if dph[3] != _RLE:
                raise ParquetError(f"column {name!r}: definition level "
                                   f"encoding {dph[3]}")
            (ln,) = struct.unpack_from("<I", page, 0)
            levels = _rle_decode(memoryview(page)[4:4 + ln], 1, n)
            at = 4 + ln
            if not levels.all():
                valid = levels.astype(bool)
        count = n if valid is None else int(valid.sum())
        rest = memoryview(page)[at:]
        if enc == _PLAIN:
            values = _decode_plain(rest, kind, count)
        elif enc in (_RLE_DICTIONARY, _PLAIN_DICTIONARY):
            if dictionary is None:
                raise ParquetError(f"column {name!r}: a dictionary page "
                                   "is missing")
            idx = _rle_decode(rest[1:], rest[0], count) if count else \
                np.zeros(0, np.uint32)
            if count and int(idx.max()) >= len(dictionary):
                raise ParquetError(f"column {name!r}: a dictionary index "
                                   "is out of range")
            values = dictionary[idx]
        else:
            raise ParquetError(f"column {name!r}: encoding {enc} is not "
                               "PLAIN or a dictionary encoding")
        pages.append((values, valid))
        got += n
    return pages


def _assemble(pages, kind: str) -> np.ndarray:
    """A column from its pages: object arrays for strings (``None`` for
    a null), int64 for ``INT64`` (an object array where one is null)."""
    if not pages:
        return np.empty(0, dtype=object if kind == UTF8 else np.int64)
    if kind == INT64 and all(v is None for _, v in pages):
        vals = [p for p, _ in pages]
        return vals[0] if len(vals) == 1 else np.concatenate(vals)
    parts = []
    for values, valid in pages:
        if valid is None:
            parts.append(values.astype(object) if kind == INT64
                         else values)
        else:
            col = np.empty(len(valid), dtype=object)
            col[valid] = values
            parts.append(col)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def read_table(source, columns: Optional[Sequence[str]] = None
               ) -> Dict[str, np.ndarray]:
    """The columns of a file (a path or a seekable binary file;
    ``columns`` projects and orders them) as numpy arrays: object arrays
    of str for strings (``None`` for a null), int64 arrays for
    ``INT64`` (object arrays where a value is null).  Raises
    :class:`ParquetError` on what it does not read, naming the file."""
    own = not hasattr(source, "read")
    f = open(source, "rb") if own else source
    try:
        return _read(f, columns)
    except ParquetError as e:
        raise ParquetError(f"{source}: {e}") from e
    except (struct.error, IndexError, KeyError, TypeError,
            UnicodeDecodeError) as e:
        raise ParquetError(f"{source}: malformed file: {e!r}") from e
    finally:
        if own:
            f.close()


def _read(f, columns) -> Dict[str, np.ndarray]:
    meta = _footer(f)
    fields = _schema(meta)
    at = {name: k for k, (name, _, _) in enumerate(fields)}
    names = list(columns) if columns is not None else [n for n, _, _ in
                                                       fields]
    missing = [n for n in names if n not in at]
    if missing:
        raise ParquetError(f"no column(s) {missing} in the file")
    pages: Dict[str, list] = {n: [] for n in names}
    for rg in meta.get(4) or []:
        chunks = rg[1]
        if len(chunks) != len(fields):
            raise ParquetError(f"a row group holds {len(chunks)} columns "
                               f"for {len(fields)} fields")
        for name in names:
            _, kind, max_def = fields[at[name]]
            cmeta = chunks[at[name]][3]
            pages[name] += _read_chunk(f, cmeta, kind, max_def, name)
    return {n: _assemble(pages[n], fields[at[n]][1]) for n in names}


# -- writer -------------------------------------------------------------------------

def _page(values: bytes, valid: Optional[np.ndarray], n: int,
          encoding: int) -> bytes:
    body = _levels(valid, n) + values
    header = _write_struct([
        (1, _T_I32, _DATA_PAGE), (2, _T_I32, len(body)),
        (3, _T_I32, len(body)),
        (5, _T_STRUCT, [(1, _T_I32, n), (2, _T_I32, encoding),
                        (3, _T_I32, _RLE), (4, _T_I32, _RLE)])])
    return header + body


def _dictionary(values: Sequence[str]) -> Optional[Dict[str, int]]:
    """Value → index in first-appearance order; None for a chunk whose
    first 65,536 values are all distinct (an id column) or whose
    dictionary's PLAIN size passes :data:`DICTIONARY_LIMIT`."""
    head = 65536
    if len(values) >= head and len(dict.fromkeys(values[:head])) == head:
        return None
    uniq = dict.fromkeys(values)
    if 4 * len(uniq) + sum(map(len, uniq)) > DICTIONARY_LIMIT:
        return None
    return {v: k for k, v in enumerate(uniq)}


def _page_bounds(sizes: np.ndarray) -> List[Tuple[int, int]]:
    """Row ranges of about :data:`PAGE_BYTES` of encoded values each."""
    n = len(sizes)
    if n == 0:
        return [(0, 0)]
    cum = np.cumsum(sizes)
    cuts = np.searchsorted(cum, np.arange(PAGE_BYTES, int(cum[-1]),
                                          PAGE_BYTES), side="right")
    edges = sorted(set([0, *cuts.tolist(), n]))
    return [(a, b) for a, b in zip(edges, edges[1:]) if b > a] or [(0, n)]


def _chunk(col: Sequence, kind: str, name: str, offset: int
           ) -> Tuple[bytes, list]:
    """One column chunk's bytes and its ``ColumnMetaData`` fields."""
    n = len(col)
    if isinstance(col, np.ndarray) and col.dtype != object:
        vals, nulls = col, 0
    else:
        vals = col.tolist() if isinstance(col, np.ndarray) else list(col)
        nulls = vals.count(None)
    valid = None if not nulls else np.zeros(n, bool) if nulls == n else \
        np.fromiter((v is not None for v in vals), bool, count=n)
    present = vals if valid is None else [v for v in vals if v is not None]
    out = bytearray()
    dict_offset = None
    encodings = [_PLAIN, _RLE]
    if kind == INT64:
        values = np.asarray(present, dtype=np.int64).astype("<i8")
        sizes = np.full(n, 8, np.int64)
        encode = lambda a, b: values[a:b].tobytes()        # noqa: E731
        encoding = _PLAIN
    elif kind == UTF8:
        strs = present.tolist() if isinstance(present, np.ndarray) \
            else present
        index = _dictionary(strs)
        if index is not None:
            dict_offset = offset
            uniq = list(index)
            plain = _plain_strings(uniq)
            out += _write_struct([
                (1, _T_I32, _DICTIONARY_PAGE), (2, _T_I32, len(plain)),
                (3, _T_I32, len(plain)),
                (7, _T_STRUCT, [(1, _T_I32, len(uniq)),
                                (2, _T_I32, _PLAIN)])]) + plain
            codes = np.zeros(len(strs), np.uint32) if len(index) == 1 else \
                np.array([index[v] for v in strs], dtype=np.uint32)
            width = max(1, int(len(uniq) - 1).bit_length())
            sizes = np.full(n, width / 8)
            encode = lambda a, b: (bytes([width])                 # noqa: E731
                                   + _rle_bit_packed(codes[a:b], width))
            encoding = _RLE_DICTIONARY
            encodings.append(_RLE_DICTIONARY)
        else:
            lens = 4 + np.fromiter(
                map(len, strs) if "".join(strs).isascii() else
                (len(v.encode()) for v in strs), np.int64, count=len(strs))
            encode = lambda a, b: _plain_strings(strs[a:b])      # noqa: E731
            encoding = _PLAIN
            sizes = np.zeros(n, np.int64)
            if valid is None:
                sizes[:] = lens
            else:
                sizes[valid] = lens
    else:
        raise ParquetError(f"field {name!r}: type {kind!r} is not one of "
                           f"{UTF8}, {INT64}")
    data_offset = offset + len(out)
    # value index of each page's first row
    before = np.zeros(n + 1, np.int64)
    if valid is not None:
        before[1:] = np.cumsum(valid)
    else:
        before[1:] = np.arange(1, n + 1)
    for a, b in _page_bounds(sizes):
        va, vb = int(before[a]), int(before[b])
        page_valid = None if valid is None else valid[a:b]
        if page_valid is not None and page_valid.all():
            page_valid = None
        out += _page(encode(va, vb), page_valid, b - a, encoding)
    meta = [(1, _T_I32, _BYTE_ARRAY if kind == UTF8 else _INT64_TYPE),
            (2, (_T_LIST, _T_I32), encodings),
            (3, (_T_LIST, _T_BINARY), [name]),
            (4, _T_I32, _UNCOMPRESSED), (5, _T_I64, n),
            (6, _T_I64, len(out)), (7, _T_I64, len(out)),
            (9, _T_I64, data_offset)]
    if dict_offset is not None:
        meta.append((11, _T_I64, dict_offset))
    return bytes(out), meta


def table_bytes(columns: Mapping[str, Sequence],
                fields: Sequence[Tuple[str, str]],
                row_group_rows: int = ROW_GROUP_ROWS) -> bytes:
    """One Parquet file of ``fields`` (``(name, "utf8" | "int64")``,
    every field optional) holding ``columns`` (a sequence a field,
    ``None`` for a null), in row groups of at most ``row_group_rows``."""
    n = len(columns[fields[0][0]]) if fields else 0
    for name, _ in fields:
        if len(columns[name]) != n:
            raise ParquetError(f"column {name!r} has {len(columns[name])} "
                               f"values, not {n}")
    out = bytearray(_MAGIC)
    groups = []
    for lo in range(0, n, row_group_rows):
        hi = min(n, lo + row_group_rows)
        chunks, size = [], 0
        for name, kind in fields:
            start = len(out)
            try:
                data, cmeta = _chunk(columns[name][lo:hi], kind, name, start)
            except (TypeError, AttributeError) as e:
                raise ParquetError(f"column {name!r} holds a value that is "
                                   f"not a {kind}: {e}") from e
            out += data
            size += len(data)
            chunks.append([(2, _T_I64, 0), (3, _T_STRUCT, cmeta)])
        groups.append([(1, (_T_LIST, _T_STRUCT), chunks),
                       (2, _T_I64, size), (3, _T_I64, hi - lo)])
    schema = [[(4, _T_BINARY, "schema"), (5, _T_I32, len(fields))]]
    for name, kind in fields:
        el = [(1, _T_I32, _BYTE_ARRAY if kind == UTF8 else _INT64_TYPE),
              (3, _T_I32, _OPTIONAL), (4, _T_BINARY, name)]
        if kind == UTF8:
            el += [(6, _T_I32, _CONVERTED_UTF8),
                   (10, _T_STRUCT, [(1, _T_STRUCT, [])])]
        schema.append(el)
    meta = _write_struct([
        (1, _T_I32, 2), (2, (_T_LIST, _T_STRUCT), schema),
        (3, _T_I64, n), (4, (_T_LIST, _T_STRUCT), groups),
        (6, _T_BINARY, _CREATED_BY)])
    out += meta + struct.pack("<I", len(meta)) + _MAGIC
    return bytes(out)


def write_table(path, columns: Mapping[str, Sequence],
                fields: Sequence[Tuple[str, str]]) -> int:
    """:func:`table_bytes` written to ``path``; returns its size."""
    data = table_bytes(columns, fields)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
