"""Columnar decoding of event scans into training arrays (numpy), and
the append-only columnar segment store.

Port of ``predictionio_tpu/data/columnar.py``.  The first half:
``encode_ids``, ``numeric_property``, ``bool_property`` and
``event_mask``.  The
reference runs Arrow kernels over an Arrow table; the port reads the
dict of numpy columns that
:meth:`~predictionio_tpu_torch.data.store.EventStore.find_columnar`
answers, with each property bag as a ``DataMap`` (the memory backend)
or as its JSON text (sqlite).  Semantics match the reference's:
first-appearance id order, a numeric property read from the bag's
top-level key, and a boolean one matched in the bag's JSON text.

The second half is the segment store the event server tees landed writes
into, so that a warm refresh reads its delta from window-sized sealed
segments (the banner below).  Its files are the reference's (the
``PSEG1`` frame around Arrow IPC streams, read and written by
:mod:`predictionio_tpu_torch.data.ipc`), so a directory either package
wrote reads in the other.  The lint ``tools/lint_ingest.py`` keeps every
``open()`` of a segment file in this module.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import re
import shutil
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from predictionio_tpu_torch.data import ipc
from predictionio_tpu_torch.data.event import BiMap
from predictionio_tpu_torch.resilience.faults import fault_point

logger = logging.getLogger(__name__)

__all__ = ["encode_ids", "numeric_property", "bool_property",
           "event_mask", "SegmentStore", "SegmentDiskPressure",
           "filter_event_table", "resolve_segment_root", "SEGMENT_SUFFIX"]

_Columns = Mapping[str, np.ndarray]


def encode_ids(col: Sequence) -> Tuple[np.ndarray, BiMap]:
    """Id strings → (dense int64 codes, BiMap), the BiMap built from the
    ids present in first-appearance order (``BiMap.string_int``
    semantics).  Raises ``ValueError`` on a null id."""
    keys = col.tolist() if isinstance(col, np.ndarray) else list(col)
    # dict.fromkeys keeps first appearances in order, in one C loop
    seen = {key: code for code, key in enumerate(dict.fromkeys(keys))}
    if None in seen:
        raise ValueError("encode_ids: id column contains a null — "
                         "entity ids must be non-null (filter or fill "
                         "before encoding)")
    codes = np.array([seen[key] for key in keys], dtype=np.int64)
    return codes, BiMap(seen)


def _number(props, key: str, default: float) -> float:
    """The reference's rule for one bag: the top-level ``key``; a bool,
    null, or anything ``float()`` refuses gives ``default``."""
    if props is None or key not in props:
        return default
    value = props[key]
    if value is None or isinstance(value, bool):
        return default
    try:
        return float(value)
    except (TypeError, ValueError, OverflowError):
        return default


def numeric_property(table_or_col: Union[_Columns, Sequence], key: str,
                     default: float = 0.0) -> np.ndarray:
    """A numeric property per event as float64, ``default`` where absent,
    null, boolean or not a number.  Takes the scan's columns (reads
    ``properties``) or the property column itself.  Bags given as JSON
    text are parsed once per distinct string and the values fanned out
    by the inverse index (the reference's dictionary route: ML-style
    data has about ten distinct rating bags); mapping bags are read one
    by one.  The rule per bag is :func:`_number` either way."""
    col = table_or_col["properties"] if isinstance(table_or_col, Mapping) \
        else table_or_col
    if not isinstance(col, np.ndarray):
        # element by element: numpy would unpack equal-length bags
        arr = np.empty(len(col), dtype=object)
        for i, p in enumerate(col):
            arr[i] = p
        col = arr
    out = np.empty(len(col), np.float64)
    is_text = np.fromiter((isinstance(p, str) for p in col), bool,
                          count=len(col))
    text = np.flatnonzero(is_text)
    if len(text):
        bags = col[text].tolist()
        uniq = {u: k for k, u in enumerate(dict.fromkeys(bags))}
        vals = np.fromiter((_number(json.loads(u), key, default)
                            for u in uniq), np.float64, count=len(uniq))
        out[text] = vals[np.array([uniq[u] for u in bags], dtype=np.int64)]
    rest = np.flatnonzero(~is_text)
    out[rest] = np.fromiter((_number(col[i], key, default) for i in rest),
                            np.float64, count=len(rest))
    return out


def bool_property(table_or_col: Union[_Columns, Sequence],
                  key: str) -> np.ndarray:
    """True where property ``key`` is JSON ``true`` or ``1`` (``1.0``,
    ``1.00``...): the reference's one regex over the bag's JSON text,
    ``"key"`` then ``:`` then the value, each side of the colon allowing
    whitespace, the value ended by ``,``, ``}``, whitespace or the end.
    Like the reference's, it matches the key at any depth.  Takes the
    scan's columns (reads ``properties``) or the property column itself.
    A JSON text bag (sqlite) is matched once per distinct string; a
    mapping bag (the memory store's DataMap) is ``json.dumps``'d first,
    as the reference's store writes ``properties_json``; a null bag is
    False."""
    col = table_or_col["properties"] if isinstance(table_or_col, Mapping) \
        else table_or_col
    # RE2's \s and $ (the reference runs Arrow's regex kernel), spelled
    # out: Python's \s also takes Unicode spaces, its $ a final newline.
    ws = "[\t\n\f\r ]"
    pattern = re.compile('"' + re.escape(key) + '"' + ws + "*:" + ws
                         + "*(true|1(?:\\.0*)?)([,}\t\n\f\r ]|\\Z)")
    memo: Dict[str, bool] = {}
    out = np.zeros(len(col), bool)
    for i, bag in enumerate(col):
        if bag is None:
            continue
        text = bag if isinstance(bag, str) else json.dumps(dict(bag))
        hit = memo.get(text)
        if hit is None:
            hit = memo[text] = pattern.search(text) is not None
        out[i] = hit
    return out


def event_mask(table: _Columns, names: Sequence[str],
               column: str = "event") -> np.ndarray:
    """Boolean mask of rows whose event name is in ``names``."""
    wanted = frozenset(names)
    col = table[column]
    return np.fromiter((e in wanted for e in col), bool, count=len(col))


# ===========================================================================
# The columnar segment store
# ===========================================================================
#
# Port of the second half of ``predictionio_tpu/data/columnar.py``, in
# the reference's own file format, so either package reads a directory
# the other wrote.  On-disk layout (one writer per root, the event
# server; readers take no lock and may be other processes):
#
#     <root>/app_<id>/<default|ch_N>/
#         manifest.json                   # the commit point (tmp+rename)
#         seg-<seq>-<wStart>-<wEnd>.seg   # sealed, fsynced, immutable
#         active-<wStart>-<rand>.tmp      # the open window, never claimed
#
# A segment file is the 6-byte magic, then blocks of [u32 len][payload]
# [u32 crc32]; a payload is one Arrow IPC stream of the reference's
# ``EVENT_ARROW_SCHEMA`` (``storage.base.SEGMENT_FIELDS``), written and
# read by ``data.ipc``.  Sealed files are fsynced before the rename, so
# a bad CRC there is damage: the reader drops coverage and the caller
# reads the primary store.  The active file is not fsynced per block, so
# a crash can tear its tail; the writer's next open truncates it to the
# last valid block (counted, logged) and discards it: its window was
# never claimed, and the primary store holds its rows.
#
# Coverage is one interval per (app, channel), [floorUs, activeStartUs):
# every event the primary store holds with an event time in it is in
# the sealed segments.  A seal ends its window at ``now - grace``, so
# rows between the primary commit and the tee are not claimed early; a
# late event (stamped before the open window) ratchets the floor up to
# the window start.  A read overlaps segments by their data range
# (minUs/maxUs) as well as their window, so a straggler teed into the
# next window is still found.
#
# Two repairs of the reference.  When the writer discards a crashed
# window at open, it raises the floor and the window start to that time
# and writes the manifest at once: the crashed window's rows may be
# missing from the segments, and a seal from the old window start would
# claim them (the reference's does), also after further restarts.  And a
# batch posted again under its token lands once in the primary store but
# is teed twice, so the reader keeps the first row of each event id
# (``read_window``; the port's event server tees the ids the store gave,
# the reference's mostly none, which are never merged).
#
# One writer a root, which the crash sweep needs: an event server tees
# only while it holds the root's ``writer.lock`` (an exclusive flock,
# freed by the kernel when its process dies).  A second server on the
# root bypasses the tee: it holds ``bypass.lock`` shared for its life and
# leaves a ``bypassed`` marker in each directory it lands writes for.  A
# reader answers None for a marked directory.  The writer clears a marker
# only when no bypassing server is left, by withdrawing every claim
# below its own clock, as for a discarded window.
# ===========================================================================

SEGMENT_SUFFIX = ".seg"
_SEG_MAGIC = b"PSEG1\n"
_WRITER_LOCK = "writer.lock"
_BYPASS_LOCK = "bypass.lock"
_BYPASSED = "bypassed"
_U32 = 4


class SegmentDiskPressure(RuntimeError):
    """Free disk below PIO_DISK_MIN_FREE_BYTES: the segment writer backs
    off before ENOSPC can tear a write; ingest itself goes on (segments
    are derived data) with /ready reporting the degradation."""


def resolve_segment_root(explicit: Optional[str] = None) -> Optional[Path]:
    """Segment root: explicit arg > $PIO_SEGMENT_DIR > $PIO_HOME/segments.
    ``PIO_SEGMENTS=off`` disables segments entirely (returns None)."""
    if os.environ.get("PIO_SEGMENTS", "").lower() in ("off", "0", "false"):
        return None
    if explicit:
        return Path(explicit)
    env = os.environ.get("PIO_SEGMENT_DIR")
    if env:
        return Path(env)
    home = os.environ.get("PIO_HOME")
    if home:
        return Path(home) / "segments"
    return None


def _env_f(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("bad %s=%r; using %s", name, raw, default)
        return default


def _now_us(clock) -> int:
    return int(clock() * 1e6)


def _block(payload: bytes) -> bytes:
    return (len(payload).to_bytes(_U32, "little") + payload
            + zlib.crc32(payload).to_bytes(_U32, "little"))


def recover_segment_tail(path: Path, truncate: bool = True) -> Dict[str, Any]:
    """Torn-tail recovery for one segment file: scan ``[len][payload]
    [crc]`` blocks, stop at the first short read, CRC mismatch or payload
    the IPC codec refuses, truncate the file to the last valid block, and
    report what happened.

    Returns ``{"rows", "blocks", "valid_bytes", "torn_bytes",
    "payloads"}`` (payloads as raw bytes, CRC-verified).  Never raises on
    damage: damage is the expected input.
    """
    payloads: List[bytes] = []
    rows = 0
    size = path.stat().st_size
    with open(path, "r+b" if truncate else "rb") as f:
        magic = f.read(len(_SEG_MAGIC))
        if magic != _SEG_MAGIC:
            valid = 0
        else:
            valid = len(_SEG_MAGIC)
            while True:
                head = f.read(_U32)
                if len(head) < _U32:
                    break
                ln = int.from_bytes(head, "little")
                body = f.read(ln + _U32)
                if len(body) < ln + _U32:
                    break
                payload, crc = body[:ln], body[ln:]
                if zlib.crc32(payload) != int.from_bytes(crc, "little"):
                    break
                try:
                    rows += ipc.stream_rows(payload)
                except ipc.ArrowIpcError as e:
                    logger.warning("segment %s: block %d refused by the IPC "
                                   "codec (%s)", path, len(payloads), e)
                    break
                payloads.append(payload)
                valid += _U32 + ln + _U32
        torn = size - valid
        if torn and truncate:
            f.truncate(valid)
    if torn:
        logger.warning(
            "segment %s: torn tail — truncated %d byte(s) to last valid "
            "block (%d block(s), %d row(s) kept)",
            path, torn, len(payloads), rows)
        _seg_counter("pio_segment_torn_bytes_total", torn)
    return {"rows": rows, "blocks": len(payloads), "valid_bytes": valid,
            "torn_bytes": torn, "payloads": payloads}


def _payload_batches(payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
    """Every record batch of ``payloads``, in order, as the segment
    fields' columns (raises
    :class:`~predictionio_tpu_torch.data.ipc.ArrowIpcError`)."""
    from predictionio_tpu_torch.data.storage.base import SEGMENT_FIELDS

    out = []
    for p in payloads:
        fields, batches = ipc.read_batches(p)
        if fields != list(SEGMENT_FIELDS):
            raise ipc.ArrowIpcError(f"a segment payload of fields {fields}")
        out.extend(batches)
    return out


def _payloads_to_columns(payloads: Sequence[bytes]) -> Dict[str, np.ndarray]:
    from predictionio_tpu_torch.data.storage.base import SEGMENT_FIELDS

    return ipc.concat_batches(_payload_batches(payloads), SEGMENT_FIELDS)


def _batches_to_payload(batches: Sequence[Mapping[str, Sequence]]) -> bytes:
    """One IPC stream of ``batches``, a record batch each: what the
    reference's ``_table_to_payload`` writes for a table of those
    chunks."""
    from predictionio_tpu_torch.data.storage.base import SEGMENT_FIELDS

    return ipc.write_batches(batches, SEGMENT_FIELDS)


def _seg_counter(name: str, by: int = 1) -> None:
    try:
        from predictionio_tpu_torch.obs import get_registry

        reg = get_registry()
        # get-or-create with literal names (metrics-lint schema check)
        counters = {
            "pio_segment_torn_bytes_total": reg.counter(
                "pio_segment_torn_bytes_total",
                "Bytes truncated from torn segment tails on recovery."),
            "pio_segment_active_discarded_total": reg.counter(
                "pio_segment_active_discarded_total",
                "Crashed unsealed windows discarded on reopen."),
            "pio_segment_late_events_total": reg.counter(
                "pio_segment_late_events_total",
                "Events below the open window start (floor ratcheted)."),
            "pio_segment_seals_total": reg.counter(
                "pio_segment_seals_total",
                "Segment windows sealed (manifest commits)."),
            "pio_segment_compactions_total": reg.counter(
                "pio_segment_compactions_total",
                "Small-segment compaction runs committed."),
        }
        counters[name].inc(by)
    except Exception:  # metrics must never break the data plane
        pass


def filter_event_table(
    table: Dict[str, np.ndarray],
    start_us: Optional[int] = None,
    until_us: Optional[int] = None,
    entity_type: Optional[str] = None,
    entity_id: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Apply the ``find_columnar`` filter set to a dict of event columns
    (segment reads return raw window slices; this brings them to what a
    storage backend's filtered scan would have returned).  A null string
    matches only ``""``, as the reference's ``fill_null(col, "")``."""
    n = len(table["event_time_us"])
    if n == 0:
        return table
    mask = np.ones(n, dtype=bool)
    if start_us is not None or until_us is not None:
        ts = np.asarray(table["event_time_us"], dtype=np.int64)
        if start_us is not None:
            mask &= ts >= start_us
        if until_us is not None:
            mask &= ts < until_us
    for col, want in (("entity_type", entity_type),
                      ("entity_id", entity_id),
                      ("target_entity_type", target_entity_type),
                      ("target_entity_id", target_entity_id)):
        if want is not None:
            mask &= np.fromiter(
                ((v if v is not None else "") == want for v in table[col]),
                bool, count=n)
    if event_names:
        mask &= event_mask(table, event_names)
    if bool(mask.all()):
        return table
    return {k: v[mask] for k, v in table.items()}


def _first_of_each_id(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop a row whose event id an earlier row has (a replayed batch,
    teed again); rows without an id are all kept."""
    seen = set()
    keep = np.ones(len(cols["event_id"]), dtype=bool)
    for i, eid in enumerate(cols["event_id"]):
        if eid is not None:
            if eid in seen:
                keep[i] = False
            seen.add(eid)
    if keep.all():
        return cols
    return {k: v[keep] for k, v in cols.items()}


class _SegmentDir:
    """Writer-side state for one (app, channel) segment directory."""

    def __init__(self, path: Path, clock):
        self.path = path
        self.lock = threading.Lock()
        self.clock = clock
        self.active_file = None  # open file handle for the active window
        self.active_path: Optional[Path] = None
        self.active_rows = 0
        self.active_bytes = 0
        self.active_min_us: Optional[int] = None
        self.active_max_us: Optional[int] = None
        self.active_opened_s = 0.0
        self.manifest, discarded = self._load_and_recover()
        if discarded:
            # the crashed window's rows may be missing: no claim may
            # reach below now (see the banner), durably
            self.withdraw_claims()

    # -- manifest -----------------------------------------------------------

    def _load_and_recover(self) -> Tuple[Dict[str, Any], bool]:
        """The manifest, and whether a crashed active window was
        discarded."""
        self.path.mkdir(parents=True, exist_ok=True)
        mpath = self.path / "manifest.json"
        if mpath.exists():
            manifest = json.loads(mpath.read_text())
        else:
            now = _now_us(self.clock)
            manifest = {"version": 1, "floorUs": now, "nextSeq": 0,
                        "activeStartUs": now, "segments": []}
        # Crash recovery (single writer): anything on disk the manifest
        # does not reference is garbage from an interrupted seal/compact —
        # except a leftover active file, which gets the torn-tail
        # treatment first so the damage is measured and logged, then is
        # discarded: its window was never claimed, the primary store holds
        # those rows, and keeping it would let a future seal claim a
        # window with rows lost from the in-flight tee.
        referenced = {e["file"] for e in manifest["segments"]}
        discarded = False
        for p in sorted(self.path.iterdir()):
            if p.name == "manifest.json" or p.name in referenced:
                continue
            if p.name.startswith("active-") and p.suffix == ".tmp":
                try:
                    stats = recover_segment_tail(p)
                    logger.warning(
                        "segment dir %s: discarding crashed active window "
                        "(%d recoverable row(s); primary store is "
                        "authoritative, window was never claimed)",
                        self.path, stats["rows"])
                    _seg_counter("pio_segment_active_discarded_total")
                    discarded = True
                except OSError:
                    pass
            elif p.suffix not in (SEGMENT_SUFFIX, ".tmp"):
                continue  # not ours — leave unknown files alone
            else:
                logger.warning("segment dir %s: sweeping orphan %s "
                               "(interrupted seal/compaction)",
                               self.path, p.name)
            try:
                p.unlink()
            except OSError:
                pass
        return manifest, discarded

    def withdraw_claims(self) -> None:
        """Raise the floor and the window start to now and commit the
        manifest: the segments claim nothing below this call.  Called
        with no active window open."""
        now = _now_us(self.clock)
        logger.warning("segment dir %s: coverage restarts at %dus",
                       self.path, now)
        self.manifest["floorUs"] = self.manifest["activeStartUs"] = max(
            now, self.manifest["activeStartUs"])
        self.write_manifest()

    def write_manifest(self) -> None:
        fault_point("segment.manifest")
        tmp = self.path / "manifest.tmp"
        data = json.dumps(self.manifest, indent=0).encode()
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self.path / "manifest.json")
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    # -- active window ------------------------------------------------------

    def append_table(self, columns: Mapping[str, Sequence]) -> None:
        """One CRC block per tee (no cross-call buffering: a crash may
        tear only the last write, never lose earlier acknowledged ones).
        ``columns``: one sequence per field of ``SEGMENT_FIELDS``."""
        ts = np.asarray(columns["event_time_us"], dtype=np.int64)
        if len(ts) == 0:
            return
        fault_point("segment.append")
        tmin, tmax = int(ts.min()), int(ts.max())
        if tmin < self.manifest["activeStartUs"]:
            # A late event: older than the open window, i.e. inside (or
            # below) ranges sealed segments claim complete coverage of.
            # Keeping the claim would be a silent lie — ratchet the floor
            # to the window start instead; reads below it fall back to
            # the primary store, which has the row.
            if self.manifest["floorUs"] < self.manifest["activeStartUs"]:
                logger.warning(
                    "segment dir %s: late event (event_time %dus < window "
                    "start %dus) — raising coverage floor; delta reads "
                    "below it fall back to the primary store",
                    self.path, tmin, self.manifest["activeStartUs"])
                self.manifest["floorUs"] = self.manifest["activeStartUs"]
                self.write_manifest()
            _seg_counter("pio_segment_late_events_total", len(ts))
        if self.active_file is None:
            start = self.manifest["activeStartUs"]
            self.active_path = self.path / (
                f"active-{start}-{uuid.uuid4().hex[:8]}.tmp")
            self.active_file = open(self.active_path, "wb")
            self.active_file.write(_SEG_MAGIC)
            self.active_bytes = len(_SEG_MAGIC)
            self.active_opened_s = self.clock()
        block = _block(_batches_to_payload([columns]))
        self.active_file.write(block)
        self.active_bytes += len(block)
        self.active_rows += len(ts)
        self.active_min_us = (tmin if self.active_min_us is None
                              else min(self.active_min_us, tmin))
        self.active_max_us = (tmax if self.active_max_us is None
                              else max(self.active_max_us, tmax))

    def seal(self, grace_us: int) -> Optional[Dict[str, Any]]:
        """Seal the active window: fsync, rename to its final ``.seg``
        name, commit to the manifest.  Window end is ``now - grace`` so
        rows still in flight between primary commit and segment tee
        cannot fall inside a claimed range."""
        if self.active_file is None or self.active_rows == 0:
            if self.active_file is not None:
                self.active_file.close()
                try:
                    self.active_path.unlink()
                except OSError:
                    pass
                self.active_file = None
                self.active_path = None
            return None
        fault_point("segment.seal")
        self.active_file.flush()
        os.fsync(self.active_file.fileno())
        self.active_file.close()
        w_start = self.manifest["activeStartUs"]
        w_end = max(w_start + 1, _now_us(self.clock) - grace_us)
        seq = self.manifest["nextSeq"]
        final = self.path / f"seg-{seq:08d}-{w_start}-{w_end}{SEGMENT_SUFFIX}"
        os.rename(self.active_path, final)
        entry = {"file": final.name, "wStartUs": w_start, "wEndUs": w_end,
                 "minUs": self.active_min_us, "maxUs": self.active_max_us,
                 "rows": self.active_rows, "bytes": self.active_bytes}
        self.manifest["segments"].append(entry)
        self.manifest["nextSeq"] = seq + 1
        self.manifest["activeStartUs"] = w_end
        self.write_manifest()  # fsyncs the dir → covers the rename too
        self.active_file = None
        self.active_path = None
        self.active_rows = 0
        self.active_bytes = 0
        self.active_min_us = None
        self.active_max_us = None
        _seg_counter("pio_segment_seals_total")
        return entry

    # -- compaction ---------------------------------------------------------

    def compact(self, small_bytes: int) -> Dict[str, int]:
        """Merge maximal runs of adjacent small sealed segments.

        Crash-safe by construction: the merged file is written aside and
        fsynced, then the manifest rename commits the swap, then the old
        files are unlinked.  A kill at any point leaves either the old
        set (manifest not yet renamed — the merged tmp is swept at next
        open) or the new set (manifest renamed — leftover old files are
        swept at next open) fully readable.  Never both (the manifest
        references exactly one set), never neither.
        """
        segs = self.manifest["segments"]
        runs: List[Tuple[int, int]] = []
        i = 0
        while i < len(segs):
            j = i
            while j < len(segs) and segs[j]["bytes"] < small_bytes:
                j += 1
            if j - i >= 2:
                runs.append((i, j))
            i = max(j, i + 1)
        stats = {"runs": 0, "segments_in": 0, "segments_out": 0}
        for start, end in reversed(runs):  # right-to-left: indices stable
            run = segs[start:end]
            fault_point("segment.compact")
            payloads = []
            for e in run:
                rec = recover_segment_tail(self.path / e["file"],
                                           truncate=False)
                if rec["torn_bytes"] or rec["rows"] != e["rows"]:
                    logger.error(
                        "segment %s: sealed file damaged (%d torn bytes, "
                        "%d/%d rows) — skipping compaction of this run",
                        e["file"], rec["torn_bytes"], rec["rows"], e["rows"])
                    payloads = None
                    break
                payloads.extend(rec["payloads"])
            if payloads is None:
                continue
            # one record batch a source batch, as the reference's
            # concat_tables + write_table keep its chunks
            merged = _payload_batches(payloads)
            n_rows = sum(len(b["event_time_us"]) for b in merged)
            block = _block(_batches_to_payload(merged))
            seq = self.manifest["nextSeq"]
            w_start, w_end = run[0]["wStartUs"], run[-1]["wEndUs"]
            final = self.path / (
                f"seg-{seq:08d}-{w_start}-{w_end}{SEGMENT_SUFFIX}")
            tmp = self.path / f"compact-{uuid.uuid4().hex[:8]}.tmp"
            with open(tmp, "wb") as f:
                f.write(_SEG_MAGIC + block)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)
            fault_point("segment.compact.commit")
            entry = {"file": final.name, "wStartUs": w_start,
                     "wEndUs": w_end,
                     "minUs": min(e["minUs"] for e in run),
                     "maxUs": max(e["maxUs"] for e in run),
                     "rows": n_rows,
                     "bytes": len(_SEG_MAGIC) + len(block)}
            self.manifest["segments"][start:end] = [entry]
            self.manifest["nextSeq"] = seq + 1
            self.write_manifest()  # ← the commit point
            fault_point("segment.compact.cleanup")
            for e in run:
                try:
                    (self.path / e["file"]).unlink()
                except OSError:
                    pass
            stats["runs"] += 1
            stats["segments_in"] += len(run)
            stats["segments_out"] += 1
            _seg_counter("pio_segment_compactions_total")
        return stats


class SegmentStore:
    """Per-(app, channel) append-only columnar segment files.

    Single writer per root (the event server that holds
    :meth:`acquire_writer` tees landed writes through
    :meth:`append_events`); any number of cross-process readers go
    through :meth:`read_window`, which consults only ``manifest.json``
    and sealed files.  See the banner above for the crash model.
    """

    def __init__(self, root, *, roll_bytes: Optional[int] = None,
                 roll_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 min_free_bytes: Optional[int] = None,
                 compact_small_bytes: Optional[int] = None,
                 compact_trigger: Optional[int] = None,
                 clock=time.time):
        self.root = Path(root)
        self.roll_bytes = int(roll_bytes if roll_bytes is not None
                              else _env_f("PIO_SEGMENT_ROLL_BYTES", 4 << 20))
        self.roll_s = float(roll_s if roll_s is not None
                            else _env_f("PIO_SEGMENT_ROLL_S", 60.0))
        self.grace_us = int(1e6 * (grace_s if grace_s is not None
                                   else _env_f("PIO_SEGMENT_GRACE_S", 5.0)))
        self.min_free_bytes = int(
            min_free_bytes if min_free_bytes is not None
            else _env_f("PIO_DISK_MIN_FREE_BYTES", 0))
        self.compact_small_bytes = int(
            compact_small_bytes if compact_small_bytes is not None
            else _env_f("PIO_SEGMENT_COMPACT_BYTES", 1 << 20))
        self.compact_trigger = int(
            compact_trigger if compact_trigger is not None
            else _env_f("PIO_SEGMENT_COMPACT_TRIGGER", 16))
        self.clock = clock
        self._dirs: Dict[Tuple[int, Optional[int]], _SegmentDir] = {}
        self._dirs_lock = threading.Lock()
        self._disk_checked_s = 0.0
        self._disk_free = None
        self._lock_file = None  # writer.lock or bypass.lock, while held

    @classmethod
    def open_default(cls, **kwargs) -> Optional["SegmentStore"]:
        root = resolve_segment_root()
        return cls(root, **kwargs) if root is not None else None

    # -- plumbing -----------------------------------------------------------

    @staticmethod
    def _dir_name(app_id: int, channel_id: Optional[int]) -> str:
        ch = "default" if channel_id is None else f"ch_{channel_id}"
        return f"app_{app_id}/{ch}"

    def _dir(self, app_id: int, channel_id: Optional[int]) -> _SegmentDir:
        key = (app_id, channel_id)
        with self._dirs_lock:
            d = self._dirs.get(key)
            if d is None:
                d = _SegmentDir(self.root / self._dir_name(app_id,
                                                           channel_id),
                                self.clock)
                self._dirs[key] = d
            return d

    def open_dir(self, app_id: int,
                 channel_id: Optional[int] = None) -> Dict[str, Any]:
        """Open (app, channel)'s directory and commit its manifest now,
        so its coverage starts at this call and not at its first tee.
        Returns a copy of the manifest."""
        d = self._dir(app_id, channel_id)
        with d.lock:
            if not (d.path / "manifest.json").exists():
                d.write_manifest()
            return json.loads(json.dumps(d.manifest))

    # -- one writer a root (see the banner) ---------------------------------

    def _flock(self, name: str, mode: int):
        self.root.mkdir(parents=True, exist_ok=True)
        f = open(self.root / name, "a")
        try:
            fcntl.flock(f, mode)
        except OSError:
            f.close()
            return None
        return f

    def acquire_writer(self) -> bool:
        """Take the root's writer lock; False when another live process
        (or another store in this one) holds it.  Held until
        :meth:`release`."""
        if self._lock_file is None:
            self._lock_file = self._flock(_WRITER_LOCK,
                                          fcntl.LOCK_EX | fcntl.LOCK_NB)
        return self._lock_file is not None

    def enter_bypass(self) -> None:
        """Hold ``bypass.lock`` shared until :meth:`release`: a writer
        then keeps every ``bypassed`` marker (waits out a writer's brief
        clear)."""
        self._lock_file = self._flock(_BYPASS_LOCK, fcntl.LOCK_SH)

    def mark_bypassed(self, app_id: int, channel_id: Optional[int]) -> None:
        """Record that writes for (app, channel) landed without a tee:
        readers answer None there until the writer clears the marker."""
        path = self.root / self._dir_name(app_id, channel_id)
        path.mkdir(parents=True, exist_ok=True)
        (path / _BYPASSED).touch()

    def release(self) -> None:
        if self._lock_file is not None:
            self._lock_file.close()
            self._lock_file = None

    def _clear_bypass(self, d: _SegmentDir) -> None:
        """Under ``d.lock``, with no active window: when ``d`` is marked
        and no bypassing server is left, withdraw every claim below now,
        then remove the marker."""
        marker = d.path / _BYPASSED
        if not marker.exists():
            return
        held = self._flock(_BYPASS_LOCK, fcntl.LOCK_EX | fcntl.LOCK_NB)
        if held is None:
            return  # a bypassing server still lands writes
        try:
            d.withdraw_claims()
            marker.unlink()
        finally:
            held.close()

    def recover(self) -> int:
        """Open every (app, channel) directory on disk now: a crashed
        writer's windows are measured and discarded at start, not at the
        first write.  A directory that fails to open (a damaged manifest)
        is left to fail its own tees, as the reference's lazy open does.
        Returns the directories opened."""
        opened = 0
        for mpath in sorted(self.root.glob("app_*/*/manifest.json")):
            app, ch = mpath.parent.parent.name, mpath.parent.name
            try:
                app_id = int(app[len("app_"):])
                channel_id = (None if ch == "default"
                              else int(ch[len("ch_"):]))
                d = self._dir(app_id, channel_id)
                with d.lock:
                    self._clear_bypass(d)
            except (OSError, ValueError) as e:
                logger.warning("segment dir %s not opened: %s",
                               mpath.parent, e)
                continue
            opened += 1
        return opened

    def disk_pressure(self) -> bool:
        """True when free space under the root is below the configured
        floor (~1s cached — this runs on every tee)."""
        if self.min_free_bytes <= 0:
            return False
        now = self.clock()
        if now - self._disk_checked_s > 1.0 or self._disk_free is None:
            self._disk_checked_s = now
            try:
                self.root.mkdir(parents=True, exist_ok=True)
                self._disk_free = shutil.disk_usage(self.root).free
            except OSError:
                self._disk_free = 0
        return self._disk_free < self.min_free_bytes

    # -- write path ---------------------------------------------------------

    def append_events(self, app_id: int, channel_id: Optional[int],
                      events, event_ids=None) -> None:
        """Tee one landed batch into the active window (raises
        :class:`SegmentDiskPressure` instead of risking a torn ENOSPC
        write; any other failure is the caller's to contain — ingest
        must never fail because a derived file could not be written).
        ``event_ids``: the ids the store gave the events, when theirs
        are not set."""
        from predictionio_tpu_torch.data.storage.base import \
            events_to_segment_columns

        self.append_table(app_id, channel_id,
                          events_to_segment_columns(list(events), event_ids))

    def append_table(self, app_id: int, channel_id: Optional[int],
                     columns: Mapping[str, Sequence]) -> None:
        """Tee one batch given as one sequence per field of
        ``SEGMENT_FIELDS``."""
        if len(columns["event_time_us"]) == 0:
            return
        if self.disk_pressure():
            raise SegmentDiskPressure(
                f"free disk under {self.root} below "
                f"PIO_DISK_MIN_FREE_BYTES={self.min_free_bytes}")
        d = self._dir(app_id, channel_id)
        with d.lock:
            d.append_table(columns)
            if (d.active_bytes >= self.roll_bytes
                    or self.clock() - d.active_opened_s >= self.roll_s):
                d.seal(self.grace_us)
                self._maybe_compact(d)
                self._clear_bypass(d)

    def seal_all(self) -> int:
        """Seal every open window (server drain/stop, bench barriers)."""
        sealed = 0
        with self._dirs_lock:
            dirs = list(self._dirs.values())
        for d in dirs:
            with d.lock:
                if d.seal(self.grace_us) is not None:
                    sealed += 1
                    self._maybe_compact(d)
                self._clear_bypass(d)
        return sealed

    def _maybe_compact(self, d: _SegmentDir) -> None:
        if self.compact_trigger <= 0:
            return
        small = sum(1 for e in d.manifest["segments"]
                    if e["bytes"] < self.compact_small_bytes)
        if small >= self.compact_trigger:
            d.compact(self.compact_small_bytes)

    def compact(self, app_id: int,
                channel_id: Optional[int] = None) -> Dict[str, int]:
        d = self._dir(app_id, channel_id)
        with d.lock:
            return d.compact(self.compact_small_bytes)

    # -- read path (cross-process safe: manifest + sealed files only) -------

    def read_window(
        self, app_id: int, channel_id: Optional[int],
        start_us: int, until_us: int, **filters
    ) -> Optional[Tuple[Dict[str, np.ndarray], int]]:
        """Columnar slice of ``[start_us, min(until_us, covered))``.

        Returns ``(columns, covered_until_us)``: the columns are
        ``find_columnar``'s dict of numpy columns (the reference answers
        an Arrow table), each bag as its JSON text under ``properties``;
        the caller reads the remaining ``[covered_until_us, until_us)``
        tail from the primary store.  None when the segments cannot
        prove coverage from ``start_us``, or a sealed file is damaged or
        holds a payload the IPC codec refuses (the reader then falls
        back entirely; it never guesses).
        """
        path = self.root / self._dir_name(app_id, channel_id)
        if (path / _BYPASSED).exists():
            return None  # writes landed here without a tee
        try:
            manifest = json.loads((path / "manifest.json").read_text())
        except (OSError, ValueError):
            return None
        floor = manifest.get("floorUs", 0)
        covered = manifest.get("activeStartUs", floor)
        if start_us < floor:
            return None  # claim does not reach back that far
        covered_until = min(until_us, covered)
        if covered_until <= start_us:
            return None  # nothing useful covered — pure fallback
        payloads: List[bytes] = []
        for e in manifest.get("segments", []):
            lo = min(e["wStartUs"], e["minUs"])
            hi = max(e["wEndUs"], e["maxUs"] + 1)
            if hi <= start_us or lo >= covered_until:
                continue
            rec = recover_segment_tail(path / e["file"], truncate=False)
            if rec["torn_bytes"] or rec["rows"] != e["rows"]:
                logger.error(
                    "segment %s damaged (%d torn bytes, %d/%d rows) — "
                    "dropping segment coverage, falling back to primary "
                    "store", e["file"], rec["torn_bytes"], rec["rows"],
                    e["rows"])
                return None
            payloads.extend(rec["payloads"])
        try:
            cols = _payloads_to_columns(payloads)
        except ipc.ArrowIpcError as e:
            logger.error("segment payload refused (%s) — falling back to "
                         "primary store", e)
            return None
        cols["properties"] = cols.pop("properties_json")
        cols = _first_of_each_id(cols)
        cols = filter_event_table(cols, start_us=start_us,
                                  until_us=covered_until, **filters)
        return cols, covered_until

    # -- observability ------------------------------------------------------

    def status(self) -> List[Dict[str, Any]]:
        """One row per (app, channel) dir on disk — for /ready and
        ``pio status`` (reads manifests; safe cross-process)."""
        out: List[Dict[str, Any]] = []
        if not self.root.exists():
            return out
        for mpath in sorted(self.root.glob("app_*/*/manifest.json")):
            try:
                manifest = json.loads(mpath.read_text())
            except (OSError, ValueError):
                continue
            segs = manifest.get("segments", [])
            out.append({
                "dir": str(mpath.parent.relative_to(self.root)),
                "segments": len(segs),
                "rows": sum(e["rows"] for e in segs),
                "bytes": sum(e["bytes"] for e in segs),
                "floorUs": manifest.get("floorUs", 0),
                "coveredUntilUs": manifest.get("activeStartUs", 0),
            })
        return out

    def close(self) -> None:
        self.seal_all()
        self.release()
