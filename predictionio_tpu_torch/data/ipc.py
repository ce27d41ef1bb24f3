"""An Arrow IPC stream codec for the event segment schema, in numpy and
``struct`` (no pyarrow).

The segment store (:mod:`predictionio_tpu_torch.data.columnar`) keeps the
reference's file format, whose blocks are Arrow IPC *streams* that the
reference writes with ``pyarrow.ipc.new_stream``.  This module reads and
writes exactly the part of that format such a stream uses: nullable
``utf8`` and ``int64`` fields, uncompressed, little-endian, metadata
version V5, any number of record batches after the schema.  Anything
else (a body compression, a dictionary, another type, big-endian data)
raises :class:`ArrowIpcError`.

Layout (the Arrow columnar format's "Streaming format", with the
``Message``, ``Schema`` and ``RecordBatch`` tables of its public
``Message.fbs`` and ``Schema.fbs``): each message is ``0xFFFFFFFF``, an
int32 metadata length, a flatbuffer ``Message`` padded to 8 bytes, then
``bodyLength`` bytes of buffers, each padded to 8; ``0xFFFFFFFF
00000000`` ends the stream.  A ``utf8`` column carries a validity bitmap
(empty when it has no null), int32 offsets and the UTF-8 bytes; an
``int64`` column a validity bitmap and the values.

What pyarrow writes reads here, and what this writes reads in pyarrow,
to equal columns.  The writer builds its flatbuffers as Arrow's C++
writer does (the same object order, defaults left out, vtables
shared), so for this schema its bytes are pyarrow's: the two packages'
segment files are the same size, and their roll and compaction
decisions the same.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["ArrowIpcError", "UTF8", "INT64", "write_stream",
           "write_batches", "read_stream", "read_batches", "concat_batches",
           "stream_rows"]

UTF8, INT64 = "utf8", "int64"

_CONTINUATION = b"\xff\xff\xff\xff"
_EOS = _CONTINUATION + b"\x00\x00\x00\x00"
_METADATA_V5 = 4
# MessageHeader union members; Type union members (Schema.fbs)
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3
_TYPE_INT, _TYPE_UTF8 = 2, 5
_LITTLE_ENDIAN = 0


class ArrowIpcError(ValueError):
    """An IPC stream outside what this codec reads: a body compression, a
    dictionary, a type other than utf8 and int64, big-endian data, or
    bytes that are not a well-formed stream."""


# -- flatbuffers: a writer ------------------------------------------------------
#
# flatbuffers' own C++ writer, in miniature: the buffer grows from its
# end towards its start, scalars are aligned to their size, a field at
# its default value is left out, and a vtable equal to one already
# written is shared.  Arrow's writer builds each message's objects in
# the order ``_schema_message`` and ``_batch_message`` follow, so the
# bytes come out as pyarrow's do.

class _FlatWriter:
    def __init__(self):
        self.rev = bytearray()       # the buffer, last byte first
        self.minalign = 1
        self.vtables: List[int] = []  # sizes at which vtables end
        self.fields: List[Tuple[int, int]] = []
        self.max_voffset = 0

    def size(self) -> int:
        return len(self.rev)

    def _prepend(self, data: bytes) -> None:
        self.rev += data[::-1]

    def prealign(self, length: int, align: int) -> None:
        self.minalign = max(self.minalign, align)
        self.rev += bytes(-(self.size() + length) % align)

    def push(self, fmt: str, value) -> int:
        data = struct.pack("<" + fmt, value)
        self.prealign(0, len(data))
        self._prepend(data)
        return self.size()

    def _refer(self, off: int) -> int:
        self.prealign(0, 4)
        return self.size() - off + 4

    def add(self, slot: int, fmt: str, value, default=0) -> None:
        if value != default:
            self._track(slot, self.push(fmt, value))

    def add_offset(self, slot: int, off: int) -> None:
        if off:
            self._track(slot, self.push("I", self._refer(off)))

    def _track(self, slot: int, off: int) -> None:
        self.fields.append((4 + 2 * slot, off))
        self.max_voffset = max(self.max_voffset, 4 + 2 * slot)

    def start(self) -> int:
        self.fields, self.max_voffset = [], 0
        return self.size()

    def end(self, start: int) -> int:
        loc = self.push("i", 0)
        vsize = max(self.max_voffset + 2, 4)
        vt = [0] * (vsize // 2)
        vt[0], vt[1] = vsize, loc - start
        for vid, off in self.fields:
            vt[vid // 2] = loc - off
        data = struct.pack(f"<{len(vt)}H", *vt)
        use = next((at for at in self.vtables
                    if bytes(self.rev[at - len(data):at][::-1]) == data),
                   None)
        if use is None:
            self._prepend(data)
            use = self.size()
            self.vtables.append(use)
        self.rev[loc - 4:loc] = struct.pack("<i", use - loc)[::-1]
        self.fields, self.max_voffset = [], 0
        return loc

    def string(self, text: str) -> int:
        data = text.encode()
        self.prealign(len(data) + 1, 4)
        self.rev += b"\0"
        self._prepend(data)
        return self.push("I", len(data))

    def offsets(self, offs: Sequence[int]) -> int:
        self.prealign(4 * len(offs), 4)
        for off in reversed(offs):
            self.push("I", self._refer(off))
        return self.push("I", len(offs))

    def structs(self, rows: Sequence[Tuple[int, int]]) -> int:
        self.prealign(16 * len(rows), 4)
        self.prealign(16 * len(rows), 8)
        for row in reversed(rows):
            self._prepend(struct.pack("<qq", *row))
        return self.push("I", len(rows))

    def finish(self, root: int) -> bytes:
        self.prealign(4, self.minalign)
        self.push("I", self._refer(root))
        return bytes(self.rev[::-1])


# -- flatbuffers: a generic table reader ---------------------------------------

class _Read:
    """One flatbuffer table: fields by slot, absent ones as defaults.
    Slots beyond the vtable (fields a newer writer added) read absent;
    slots this codec does not ask for are ignored."""

    __slots__ = ("buf", "pos", "vt", "slots")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.slots = (struct.unpack_from("<H", buf, self.vt)[0] - 4) // 2

    def _at(self, slot: int) -> int:
        if slot >= self.slots:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vt + 4 + 2 * slot)[0]
        return self.pos + off if off else 0

    def scalar(self, slot: int, fmt: str, default=0):
        at = self._at(slot)
        return struct.unpack_from("<" + fmt, self.buf, at)[0] if at \
            else default

    def _ref(self, slot: int):
        at = self._at(slot)
        return at + struct.unpack_from("<I", self.buf, at)[0] if at else None

    def table(self, slot: int):
        at = self._ref(slot)
        return None if at is None else _Read(self.buf, at)

    def _vector(self, slot: int) -> Tuple[int, int]:
        at = self._ref(slot)
        if at is None:
            return 0, 0
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def tables(self, slot: int) -> List["_Read"]:
        start, n = self._vector(slot)
        out = []
        for k in range(n):
            at = start + 4 * k
            out.append(_Read(self.buf,
                             at + struct.unpack_from("<I", self.buf, at)[0]))
        return out

    def structs(self, slot: int) -> List[Tuple[int, int]]:
        start, n = self._vector(slot)
        return [struct.unpack_from("<qq", self.buf, start + 16 * k)
                for k in range(n)]

    def string(self, slot: int) -> str:
        start, n = self._vector(slot)
        return bytes(self.buf[start:start + n]).decode()


# -- writer -------------------------------------------------------------------

def _field(b: _FlatWriter, name: str, kind: str) -> int:
    t = b.start()
    if kind == INT64:
        b.add(0, "i", 64)                    # bitWidth
        b.add(1, "?", True, False)           # is_signed
        type_id = _TYPE_INT
    elif kind == UTF8:
        type_id = _TYPE_UTF8
    else:
        raise ArrowIpcError(f"field {name!r}: type {kind!r} is not one of "
                            f"{UTF8}, {INT64}")
    type_table = b.end(t)
    fb_name = b.string(name)
    children = b.offsets(())
    f = b.start()
    b.add_offset(5, children)
    b.add_offset(3, type_table)
    b.add_offset(0, fb_name)
    b.add(2, "B", type_id)                   # type_type
    b.add(1, "?", True, False)               # nullable
    return b.end(f)


def _frame(b: _FlatWriter, header_type: int, header: int, body_len: int) -> bytes:
    m = b.start()
    b.add(3, "q", body_len)                  # bodyLength
    b.add_offset(2, header)
    b.add(0, "h", _METADATA_V5)              # version
    b.add(1, "B", header_type)
    meta = b.finish(b.end(m))
    meta += bytes(-(len(meta) + 8) % 8)
    return _CONTINUATION + struct.pack("<i", len(meta)) + meta


@functools.lru_cache(maxsize=16)
def _schema_message(fields: Tuple[Tuple[str, str], ...]) -> bytes:
    # one schema for every block of a segment file: built once
    b = _FlatWriter()
    offs = [_field(b, name, kind) for name, kind in fields]
    vec = b.offsets(offs)
    s = b.start()
    b.add_offset(1, vec)
    b.add(0, "h", _LITTLE_ENDIAN)            # endianness
    return _frame(b, _SCHEMA, b.end(s), 0)


def _batch_message(n: int, nodes, buffers, body_len: int) -> bytes:
    b = _FlatWriter()
    fb_nodes, fb_buffers = b.structs(nodes), b.structs(buffers)
    r = b.start()
    b.add(0, "q", n)                         # length
    b.add_offset(2, fb_buffers)
    b.add_offset(1, fb_nodes)
    return _frame(b, _RECORD_BATCH, b.end(r), body_len)


def _bitmap(valid: np.ndarray) -> bytes:
    return np.packbits(valid, bitorder="little").tobytes()


def write_stream(columns: Mapping[str, Sequence],
                 fields: Sequence[Tuple[str, str]]) -> bytes:
    """One IPC stream: the schema of ``fields`` (``(name, "utf8" |
    "int64")``, every field nullable), one record batch of ``columns``
    (a sequence a field, ``None`` for a null), end-of-stream."""
    return write_batches([columns], fields)


def write_batches(batches: Sequence[Mapping[str, Sequence]],
                  fields: Sequence[Tuple[str, str]]) -> bytes:
    """One IPC stream of ``fields`` holding a record batch per entry of
    ``batches`` up to the last that has rows, as pyarrow's
    ``write_table`` writes a table's chunks (it stops once every row is
    written: an empty table gets no batch)."""
    sizes = [len(b[fields[0][0]]) if fields else 0 for b in batches]
    last = max((k for k, n in enumerate(sizes) if n), default=-1)
    out = _schema_message(tuple(map(tuple, fields)))
    for columns in batches[:last + 1]:
        out += _batch(columns, fields)
    return out + _EOS


def _batch(columns: Mapping[str, Sequence],
           fields: Sequence[Tuple[str, str]]) -> bytes:
    n = len(columns[fields[0][0]]) if fields else 0
    body = bytearray()
    nodes, buffers = [], []

    def add(data: bytes) -> None:
        buffers.append((len(body), len(data)))
        body.extend(data)
        body.extend(bytes(-len(body) % 8))

    for name, kind in fields:
        col = columns[name]
        if len(col) != n:
            raise ArrowIpcError(f"column {name!r} has {len(col)} values, "
                                f"not {n}")
        dense = isinstance(col, np.ndarray) and col.dtype != object
        nulls = 0 if dense else list(col).count(None)
        add(_bitmap(np.fromiter((v is not None for v in col), bool,
                                count=n)) if nulls else b"")
        if kind == UTF8:
            data = [b"" if v is None else v.encode() for v in col]
            lengths = np.fromiter(map(len, data), np.int64, count=n)
            if lengths.sum() > np.iinfo(np.int32).max:
                raise ArrowIpcError(f"column {name!r} holds more than 2 GiB")
            offsets = np.zeros(n + 1, "<i4")
            offsets[1:] = np.cumsum(lengths)
            add(offsets.tobytes())
            add(b"".join(data))
        elif kind == INT64:
            values = col if dense else np.fromiter(
                (0 if v is None else v for v in col), np.int64, count=n)
            add(np.asarray(values).astype("<i8").tobytes())
        else:
            raise ArrowIpcError(f"field {name!r}: type {kind!r} is not one "
                                f"of {UTF8}, {INT64}")
        nodes.append((n, nulls))
    return _batch_message(n, nodes, buffers, len(body)) + bytes(body)


# -- reader -------------------------------------------------------------------

def _messages(payload):
    """(message table, body, metadata bytes) for each message before
    end-of-stream (or the end of the bytes)."""
    pos, end = 0, len(payload)
    while pos < end:
        (length,) = struct.unpack_from("<i", payload, pos)
        pos += 4
        if length == -1:                     # the continuation marker
            (length,) = struct.unpack_from("<i", payload, pos)
            pos += 4
        if length == 0:
            return
        if length < 0 or pos + length > end:
            raise ArrowIpcError("a message runs past the stream's end")
        msg = _Read(payload, pos + struct.unpack_from("<I", payload, pos)[0])
        meta = payload[pos:pos + length]
        pos += length
        body_len = msg.scalar(3, "q")
        if body_len < 0 or pos + body_len > end:
            raise ArrowIpcError("a message body runs past the stream's end")
        yield msg, payload[pos:pos + body_len], meta
        pos += body_len


# Schema messages already parsed, by their bytes: every block of a
# segment file repeats one schema.
_SCHEMAS: Dict[bytes, List[Tuple[str, str]]] = {}


def _schema_of(header: "_Read", meta) -> List[Tuple[str, str]]:
    key = bytes(meta)
    fields = _SCHEMAS.get(key)
    if fields is None:
        fields = _schema(header)
        if len(_SCHEMAS) < 64:
            _SCHEMAS[key] = fields
    return list(fields)


def _schema(header: _Read) -> List[Tuple[str, str]]:
    if header.scalar(0, "h") != _LITTLE_ENDIAN:
        raise ArrowIpcError("the stream is big-endian")
    fields = []
    for f in header.tables(1):
        name = f.string(0)
        if f.table(4) is not None:
            raise ArrowIpcError(f"field {name!r} is dictionary-encoded")
        type_id = f.scalar(2, "B")
        if type_id == _TYPE_UTF8:
            fields.append((name, UTF8))
            continue
        if type_id == _TYPE_INT:
            t = f.table(3)
            width = t.scalar(0, "i") if t is not None else 0
            signed = t.scalar(1, "?", False) if t is not None else False
            if (width, signed) == (64, True):
                fields.append((name, INT64))
                continue
        raise ArrowIpcError(f"field {name!r} has Arrow type id {type_id}; "
                            f"this codec reads {UTF8} and {INT64}")
    return fields


def _header(msg: _Read):
    kind = msg.scalar(1, "B")
    if kind == _DICTIONARY_BATCH:
        raise ArrowIpcError("the stream holds a dictionary batch")
    if kind not in (_SCHEMA, _RECORD_BATCH):
        raise ArrowIpcError(f"message header type {kind} is neither a "
                            "schema nor a record batch")
    header = msg.table(2)
    if header is None:
        raise ArrowIpcError("a message has no header")
    if kind == _RECORD_BATCH and header.table(3) is not None:
        raise ArrowIpcError("the record batch body is compressed")
    return kind, header


def _valid(body, buf, n: int, nulls: int):
    if nulls == 0:
        return None
    off, ln = buf
    bits = np.frombuffer(body, np.uint8, count=ln, offset=off)
    return np.unpackbits(bits, bitorder="little", count=n).astype(bool)


def _utf8(body, bufs, n: int, nulls: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    (ooff, oln), (doff, dln) = bufs[1], bufs[2]
    if oln < 4 * (n + 1):
        raise ArrowIpcError("a utf8 offsets buffer is short")
    offs = np.frombuffer(body, "<i4", count=n + 1, offset=ooff)
    if offs[0] < 0 or offs[-1] > dln or np.any(offs[1:] < offs[:-1]):
        raise ArrowIpcError("utf8 offsets run outside their data")
    offs = offs.tolist()
    raw = bytes(body[doff + offs[0]:doff + offs[-1]])
    text = raw.decode()
    base = offs[0]
    if len(text) == len(raw):                # ASCII: slice the text itself
        out[:] = [text[a - base:b - base] for a, b in zip(offs, offs[1:])]
    else:
        out[:] = [raw[a - base:b - base].decode()
                  for a, b in zip(offs, offs[1:])]
    valid = _valid(body, bufs[0], n, nulls)
    if valid is not None:
        out[~valid] = None
    return out


def _int64(body, bufs, n: int, nulls: int) -> np.ndarray:
    off, ln = bufs[1]
    if ln < 8 * n:
        raise ArrowIpcError("an int64 values buffer is short")
    values = np.frombuffer(body, "<i8", count=n, offset=off).astype(np.int64)
    valid = _valid(body, bufs[0], n, nulls)
    if valid is None:
        return values
    out = values.astype(object)
    out[~valid] = None
    return out


def read_stream(payload) -> Tuple[List[Tuple[str, str]],
                                  Dict[str, np.ndarray]]:
    """``(fields, columns)`` of one IPC stream, its record batches
    concatenated: object arrays for ``utf8`` (``None`` for a null),
    int64 arrays for ``int64`` (object arrays where a batch holds a
    null).  Raises :class:`ArrowIpcError` on what it does not read."""
    fields, batches = read_batches(payload)
    return fields, concat_batches(batches, fields)


def concat_batches(batches: Sequence[Mapping[str, np.ndarray]],
                   fields: Sequence[Tuple[str, str]]
                   ) -> Dict[str, np.ndarray]:
    """One column a field out of record batches' columns."""
    columns = {}
    for name, kind in fields:
        got = [b[name] for b in batches]
        if not got:
            columns[name] = np.empty(0, dtype=object if kind == UTF8
                                     else np.int64)
        else:
            columns[name] = got[0] if len(got) == 1 else np.concatenate(got)
    return columns


def read_batches(payload) -> Tuple[List[Tuple[str, str]],
                                   List[Dict[str, np.ndarray]]]:
    """``(fields, batches)`` of one IPC stream: each record batch's
    columns as :func:`read_stream` gives them."""
    try:
        return _read(memoryview(payload))
    except ArrowIpcError:
        raise
    except (struct.error, IndexError, ValueError, TypeError) as e:
        raise ArrowIpcError(f"malformed IPC stream: {e}") from e


def _read(payload):
    fields = None
    batches: List[Dict[str, np.ndarray]] = []
    for msg, body, meta in _messages(payload):
        kind, header = _header(msg)
        if kind == _SCHEMA:
            if fields is not None:
                raise ArrowIpcError("the stream holds a second schema")
            fields = _schema_of(header, meta)
            continue
        if fields is None:
            raise ArrowIpcError("a record batch before the schema")
        nodes, bufs = header.structs(1), header.structs(2)
        if len(nodes) != len(fields):
            raise ArrowIpcError(f"{len(nodes)} field nodes for "
                                f"{len(fields)} fields")
        k, batch = 0, {}
        for (name, kind), (n, nulls) in zip(fields, nodes):
            width = 3 if kind == UTF8 else 2
            mine = bufs[k:k + width]
            k += width
            if len(mine) != width or any(
                    o < 0 or o + ln > len(body) for o, ln in mine):
                raise ArrowIpcError(f"column {name!r}: buffers outside the "
                                    "body")
            batch[name] = (_utf8 if kind == UTF8 else _int64)(
                body, mine, n, nulls)
        batches.append(batch)
    if fields is None:
        raise ArrowIpcError("the stream holds no schema")
    return fields, batches


def stream_rows(payload) -> int:
    """Rows in one IPC stream, from its metadata alone (the record
    batches' lengths); raises :class:`ArrowIpcError` as
    :func:`read_stream` does on what the codec does not read."""
    try:
        rows, schema = 0, False
        for msg, _, meta in _messages(memoryview(payload)):
            kind, header = _header(msg)
            if kind == _SCHEMA:
                _schema_of(header, meta)
                schema = True
            else:
                rows += header.scalar(0, "q")
        if not schema:
            raise ArrowIpcError("the stream holds no schema")
        return rows
    except ArrowIpcError:
        raise
    except (struct.error, IndexError, ValueError, TypeError) as e:
        raise ArrowIpcError(f"malformed IPC stream: {e}") from e
