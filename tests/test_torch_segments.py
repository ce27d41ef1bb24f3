"""The port's columnar segment store against the reference's.

Every scenario of ``tests/test_segments.py`` runs here through both
packages' ``SegmentStore`` under one fake clock, each over its own root,
and must leave equal manifests (8-hex uuids in file names masked), equal
reads (column for column: the reference's ``properties_json`` against
the port's ``properties``, as text), equal ``pio_segment_*`` counters
and equal files on disk, byte for byte: the port's IPC codec writes what
pyarrow writes.  The reference's own assertions hold on the port's side.

Then: a directory either package wrote reads in the other's
``read_window`` as in its own (torn tails, a late event's floor ratchet,
a compacted run); the port's durable withdrawal of the claims over a
crashed window; ``WindowedEventStore``'s windowed read through segments against
the same read with segments off and against the reference's, on
MEMORY, sqlite and ``pioserver``, tied event times included; and both
event servers' tee as ``/ready`` reports it.
"""

import contextlib
import dataclasses
import datetime as dt
import json
import os
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import predictionio_tpu.data.columnar as ref_columnar
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.resilience.faults as ref_faults
import predictionio_tpu_torch.data.columnar as port_columnar
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.resilience.faults as port_faults
from predictionio_tpu.data import DataMap as RefDataMap
from predictionio_tpu.data import Event as RefEvent
from predictionio_tpu_torch.data.event import DataMap, Event

UTC = dt.timezone.utc
APP = 7
REF = SimpleNamespace(name="ref", col=ref_columnar, Event=RefEvent,
                      DataMap=RefDataMap, faults=ref_faults,
                      registry=ref_obs.get_registry,
                      reset=ref_obs.reset_observability)
PORT = SimpleNamespace(name="port", col=port_columnar, Event=Event,
                       DataMap=DataMap, faults=port_faults,
                       registry=port_obs.get_registry,
                       reset=lambda: port_obs.get_registry().reset())
PKGS = (REF, PORT)
COUNTERS = ("pio_segment_torn_bytes_total",
            "pio_segment_active_discarded_total",
            "pio_segment_late_events_total", "pio_segment_seals_total",
            "pio_segment_compactions_total")
UUID = re.compile(r"-[0-9a-f]{8}\.tmp")


@contextlib.contextmanager
def own_segment_root(path):
    """``PIO_SEGMENT_DIR`` set to ``path`` while an event server is made
    (it reads the variable once, at construction): a segment root takes
    one writer, so two servers of one test each get their own."""
    old = os.environ.get("PIO_SEGMENT_DIR")
    os.environ["PIO_SEGMENT_DIR"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PIO_SEGMENT_DIR", None)
        else:
            os.environ["PIO_SEGMENT_DIR"] = old


class Run:
    """One package's side of a scenario: its store, events and reads
    under its own fake clock."""

    def __init__(self, pkg, root: Path):
        self.pkg, self.root = pkg, root
        self.clk = SimpleNamespace(t=1000.0)

    def store(self, **kw):
        kw.setdefault("roll_bytes", 1 << 30)
        kw.setdefault("roll_s", 1e9)
        kw.setdefault("grace_s", 0.0)
        kw.setdefault("compact_trigger", 0)
        return self.pkg.col.SegmentStore(self.root,
                                         clock=lambda: self.clk.t, **kw)

    def ev(self, i, t_s, name="view", props=None):
        return self.pkg.Event(
            event=name, entity_type="user", entity_id=f"u{i}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=self.pkg.DataMap(props or {}),
            event_time=dt.datetime.fromtimestamp(t_s, UTC),
            creation_time=dt.datetime.fromtimestamp(t_s + 0.5, UTC))

    def read(self, st, start_s=1000.0, **filters):
        """``read_window`` as comparable values: None, or (columns as
        lists under the reference's names, covered_until_us)."""
        got = st.read_window(APP, None, int(start_s * 1e6), 1 << 62,
                             **filters)
        if got is None:
            return None
        table, covered = got
        if self.pkg is REF:
            return table.to_pydict(), covered
        cols = {("properties_json" if k == "properties" else k):
                [None if v is None else int(v) if isinstance(v, np.integer)
                 else v for v in col] for k, col in table.items()}
        return cols, covered

    def seg_dir(self):
        return self.root / "app_7" / "default"

    def seg_files(self):
        return sorted(p.name for p in self.seg_dir().iterdir()
                      if p.suffix == ".seg")

    def manifest(self):
        return json.loads((self.seg_dir() / "manifest.json").read_text())

    def fault(self, point):
        self.pkg.faults.install(f"{point}:error:1.0")

    def state(self):
        """Manifests, files (name and bytes) and counters."""
        files = {}
        for p in sorted(self.root.rglob("*")):
            if p.is_file():
                rel = UUID.sub("-<uuid>.tmp", str(p.relative_to(self.root)))
                files[rel] = p.read_bytes()
        manifests = {k: json.loads(v) for k, v in files.items()
                     if k.endswith("manifest.json")}
        reg = self.pkg.registry()
        counters = {}
        for name in COUNTERS:
            m = reg.get(name)
            counters[name] = 0.0 if m is None else m.value()
        return {"manifests": manifests, "files": files,
                "counters": counters}


def _withdrawn(state, at_us):
    """``state`` with every manifest's floor and window start raised to
    ``at_us`` and written again, as the port's writer does when it
    discards a crashed window."""
    manifests, files = {}, dict(state["files"])
    for name, m in state["manifests"].items():
        m = dict(m)
        m["floorUs"] = m["activeStartUs"] = max(at_us, m["activeStartUs"])
        manifests[name] = m
        files[name] = json.dumps(m, indent=0).encode()
    return {**state, "manifests": manifests, "files": files}


def both(tmp_path, scenario, withdrawn_at=None):
    """Run ``scenario(run)`` in each package; the observations it returns
    and the state it leaves must be equal.  ``withdrawn_at``: the
    scenario reopens a directory holding a crashed window at this clock
    (s).  The port then withdraws every claim below it, durably (the
    banner of its ``data/columnar.py``): its scenario observes None, and
    its state must be the reference's with the floor and the window
    start raised there."""
    out = []
    for pkg in PKGS:
        pkg.reset()
        pkg.faults.clear()
        run = Run(pkg, tmp_path / pkg.name)
        try:
            seen = scenario(run)
        finally:
            pkg.faults.clear()
        out.append((seen, run.state()))
    (ref_seen, ref_state), (port_seen, port_state) = out
    if withdrawn_at is None:
        assert port_seen == ref_seen
    else:
        assert ref_seen is not None and port_seen is None
        ref_state = _withdrawn(ref_state, int(withdrawn_at * 1e6))
    assert port_state["manifests"] == ref_state["manifests"]
    assert port_state["counters"] == ref_state["counters"]
    assert port_state["files"].keys() == ref_state["files"].keys()
    for name, data in ref_state["files"].items():
        assert port_state["files"][name] == data, name
    return port_seen


# -- roundtrip + coverage honesty ---------------------------------------------

def test_append_seal_read_roundtrip(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001), r.ev(1, 1002)])
        st.append_events(APP, None, [r.ev(2, 1003, name="buy",
                                          props={"n": [1, {"x": None}]})])
        r.clk.t = 1100.0
        st.seal_all()
        full = r.read(st)
        assert full[1] == int(1100e6) and len(full[0]["event"]) == 3
        buys = r.read(st, event_names=["buy"])
        assert len(buys[0]["event"]) == 1
        u0 = r.read(st, entity_id="u0")
        assert len(u0[0]["event"]) == 1
        below = r.read(st, start_s=900.0)
        assert below is None
        return full, buys, u0, below

    both(tmp_path, scenario)


def test_unsealed_rows_are_never_claimed(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        r.clk.t = 1100.0
        st.seal_all()
        st.append_events(APP, None, [r.ev(1, 1150)])  # active, not sealed
        cols, covered = got = r.read(st)
        assert covered == int(1100e6) and len(cols["event"]) == 1
        return got

    both(tmp_path, scenario)


def test_late_event_ratchets_floor(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        r.clk.t = 1100.0
        st.seal_all()
        before = r.read(st)
        assert before is not None
        st.append_events(APP, None, [r.ev(1, 1050)])  # < window start
        assert r.manifest()["floorUs"] == int(1100e6)
        after = r.read(st)
        assert after is None
        return before, after

    both(tmp_path, scenario)


def test_straggler_teed_into_next_window_is_still_found(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        r.clk.t = 1100.0
        st.seal_all()
        st.append_events(APP, None, [r.ev(1, 1100), r.ev(2, 1150)])
        r.clk.t = 1200.0
        st.seal_all()
        cols, covered = got = r.read(st)
        assert covered == int(1200e6) and len(cols["event"]) == 3
        return got

    both(tmp_path, scenario)


# -- torn tails + CRC -----------------------------------------------------------

def test_torn_tail_truncated_counted_idempotent(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        st.append_events(APP, None, [r.ev(1, 1002)])
        r.clk.t = 1100.0
        st.seal_all()
        seg = r.seg_dir() / r.seg_files()[0]
        good = seg.read_bytes()
        seg.write_bytes(good[: len(good) - 7])
        rec = r.pkg.col.recover_segment_tail(seg)
        assert rec["blocks"] == 1 and rec["rows"] == 1
        assert rec["torn_bytes"] > 0
        assert seg.stat().st_size == rec["valid_bytes"]
        rec2 = r.pkg.col.recover_segment_tail(seg)
        assert rec2["torn_bytes"] == 0 and rec2["blocks"] == 1
        return rec, rec2

    both(tmp_path, scenario)


def test_corrupt_crc_stops_scan(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        st.append_events(APP, None, [r.ev(1, 1002)])
        r.clk.t = 1100.0
        st.seal_all()
        seg = r.seg_dir() / r.seg_files()[0]
        raw = bytearray(seg.read_bytes())
        raw[-3] ^= 0xFF
        seg.write_bytes(bytes(raw))
        rec = r.pkg.col.recover_segment_tail(seg, truncate=False)
        assert rec["blocks"] == 1
        return rec, r.read(st)

    both(tmp_path, scenario)


def test_damaged_sealed_segment_means_full_fallback(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001), r.ev(1, 1002)])
        st.append_events(APP, None, [r.ev(2, 1003)])
        r.clk.t = 1100.0
        st.seal_all()
        seg = r.seg_dir() / r.seg_files()[0]
        seg.write_bytes(seg.read_bytes()[:-5])
        got = r.read(st)
        assert got is None
        return got

    both(tmp_path, scenario)


def test_crashed_active_window_is_discarded_at_open(tmp_path):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        r.clk.t = 1100.0
        st.seal_all()
        st.append_events(APP, None, [r.ev(1, 1150)])
        st2 = r.store()
        st2._dir(APP, None)  # a cold reopen: _load_and_recover
        assert [p for p in r.seg_dir().iterdir() if p.suffix == ".tmp"] \
            == []
        got = r.read(st2)
        if r.pkg is PORT:    # the claim below the reopen is withdrawn
            assert got is None and r.manifest()["floorUs"] == int(1100e6)
            return None
        cols, covered = got
        assert len(cols["event"]) == 1 and covered == int(1100e6)
        return got

    both(tmp_path, scenario, withdrawn_at=1100.0)


# -- compaction -------------------------------------------------------------------

def _three_small_segments(r):
    st = r.store()
    for k in range(3):
        st.append_events(APP, None, [r.ev(2 * k, 1001 + 100 * k),
                                     r.ev(2 * k + 1, 1002 + 100 * k)])
        r.clk.t = 1100.0 + 100 * k
        st.seal_all()
    assert len(r.seg_files()) == 3
    return st


def _sorted_by_time(cols):
    order = np.argsort(cols["event_time_us"], kind="stable")
    return {k: [v[i] for i in order] for k, v in cols.items()}


def test_compaction_merges_and_preserves_reads(tmp_path):
    def scenario(r):
        st = _three_small_segments(r)
        before, cov_before = r.read(st)
        stats = st.compact(APP, None)
        assert stats == {"runs": 1, "segments_in": 3, "segments_out": 1}
        assert len(r.seg_files()) == 1
        assert [e["file"] for e in r.manifest()["segments"]] == \
            r.seg_files()
        after, cov_after = r.read(st)
        assert cov_after == cov_before
        assert _sorted_by_time(after) == _sorted_by_time(before)
        return stats, after, cov_after

    both(tmp_path, scenario)


@pytest.mark.parametrize("point", ["segment.compact",
                                   "segment.compact.commit",
                                   "segment.compact.cleanup"])
def test_compaction_crash_leaves_one_readable_set(tmp_path, point):
    def scenario(r):
        st = _three_small_segments(r)
        r.fault(point)
        with pytest.raises(ConnectionError):   # FaultInjected, both
            st.compact(APP, None)
        r.pkg.faults.clear()
        st2 = r.store()
        st2._dir(APP, None)
        assert [e["file"] for e in r.manifest()["segments"]] == \
            r.seg_files()
        cols, covered = got = r.read(st2)
        assert sorted(cols["entity_id"]) == [f"u{i}" for i in range(6)]
        return got

    both(tmp_path, scenario)


# -- kill at every boundary of the append/seal path ---------------------------------

@pytest.mark.parametrize("point", ["segment.append", "segment.seal",
                                   "segment.manifest"])
def test_seal_path_crash_never_overclaims(tmp_path, point):
    def scenario(r):
        st = r.store()
        st.append_events(APP, None, [r.ev(0, 1001)])
        r.clk.t = 1100.0
        st.seal_all()
        r.fault(point)
        with pytest.raises(ConnectionError):
            st.append_events(APP, None, [r.ev(1, 1150)])
            r.clk.t = 1200.0
            st.seal_all()
        r.pkg.faults.clear()
        st2 = r.store()
        st2._dir(APP, None)
        m = r.manifest()
        assert [e["file"] for e in m["segments"]] == r.seg_files()
        got = r.read(st2)
        if r.pkg is PORT and point == "segment.seal":
            # the window left open was discarded: no claim below now
            assert got is None and m["floorUs"] == int(1200e6)
            return None
        cols, covered = got
        claimed = [t for t in cols["event_time_us"] if t < int(1100e6)]
        assert len(claimed) == 1
        assert covered <= m["activeStartUs"]
        return got

    both(tmp_path, scenario,
         withdrawn_at=1200.0 if point == "segment.seal" else None)


def test_disk_pressure_raises_before_write(tmp_path):
    def scenario(r):
        st = r.store(min_free_bytes=1 << 60)
        with pytest.raises(r.pkg.col.SegmentDiskPressure):
            st.append_events(APP, None, [r.ev(0, 1001)])
        st2 = r.store(min_free_bytes=1)
        st2.append_events(APP, None, [r.ev(0, 1001)])
        return st.disk_pressure(), st2.disk_pressure()

    both(tmp_path, scenario)


def test_resolve_segment_root_env(tmp_path, monkeypatch):
    for pkg in PKGS:
        resolve = pkg.col.resolve_segment_root
        monkeypatch.setenv("PIO_SEGMENT_DIR", str(tmp_path / "x"))
        assert resolve() == tmp_path / "x"
        assert resolve(str(tmp_path / "y")) == tmp_path / "y"
        monkeypatch.setenv("PIO_SEGMENTS", "off")
        assert resolve() is None
        monkeypatch.delenv("PIO_SEGMENTS")
        monkeypatch.delenv("PIO_SEGMENT_DIR")
        monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
        assert resolve() == tmp_path / "home" / "segments"
        monkeypatch.delenv("PIO_HOME")
        assert resolve() is None


def test_knobs_read_the_same_environment(tmp_path, monkeypatch):
    knobs = {"PIO_SEGMENT_ROLL_BYTES": "1234", "PIO_SEGMENT_ROLL_S": "2.5",
             "PIO_SEGMENT_GRACE_S": "0.25", "PIO_DISK_MIN_FREE_BYTES": "7",
             "PIO_SEGMENT_COMPACT_BYTES": "999",
             "PIO_SEGMENT_COMPACT_TRIGGER": "3"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PIO_SEGMENT_DIR", str(tmp_path / "segs"))
    seen = []
    for pkg in PKGS:
        st = pkg.col.SegmentStore.open_default()
        seen.append((st.root, st.roll_bytes, st.roll_s, st.grace_us,
                     st.min_free_bytes, st.compact_small_bytes,
                     st.compact_trigger))
    assert seen[0] == seen[1] == (tmp_path / "segs", 1234, 2.5, 250_000,
                                  7, 999, 3)


def test_roll_and_auto_compaction_by_bytes_and_time(tmp_path):
    """The store's own triggers (roll by bytes and by age, compaction
    once enough small segments pile up) make the same decisions in both
    packages: the files are the same size."""
    def scenario(r):
        st = r.store(roll_bytes=3000, roll_s=30.0, compact_trigger=3,
                     compact_small_bytes=2500)
        for k in range(12):
            r.clk.t = 1000.0 + 7 * k
            st.append_events(APP, None,
                             [r.ev(k * 3 + j, r.clk.t + 0.1 * j)
                              for j in range(1 + k % 3)])
        r.clk.t = 1200.0
        st.seal_all()
        return r.manifest(), r.read(st)

    both(tmp_path, scenario)


# -- across the packages --------------------------------------------------------------

def _write_dir(r, case):
    """Leave a directory for the other package to read."""
    st = r.store()
    if case == "torn_tail":
        st.append_events(APP, None, [r.ev(0, 1001), r.ev(1, 1002)])
        r.clk.t = 1100.0
        st.seal_all()
        st.append_events(APP, None, [r.ev(2, 1150)])
        r.clk.t = 1200.0
        st.seal_all()
        seg = r.seg_dir() / r.seg_files()[-1]
        seg.write_bytes(seg.read_bytes()[:-9])
    elif case == "late_event":
        st.append_events(APP, None, [r.ev(0, 1001)])
        r.clk.t = 1100.0
        st.seal_all()
        st.append_events(APP, None, [r.ev(1, 1120), r.ev(2, 1050)])
        r.clk.t = 1200.0
        st.seal_all()
    elif case == "compacted":
        for k in range(4):
            st.append_events(APP, None, [r.ev(3 * k + j, 1001 + 100 * k + j,
                                              props={"k": k, "j": [j]})
                                         for j in range(3)])
            r.clk.t = 1100.0 + 100 * k
            st.seal_all()
        st.compact(APP, None)
        st.append_events(APP, None, [r.ev(99, 1450)])
        r.clk.t = 1500.0
        st.seal_all()
    return st


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("case", ["torn_tail", "late_event", "compacted"])
def test_a_directory_reads_the_same_in_both_packages(tmp_path, writer, case):
    w = REF if writer == "ref" else PORT
    run = Run(w, tmp_path / "segs")
    _write_dir(run, case)
    for start_s in (1000.0, 1100.0, 1150.0):
        reads = [Run(pkg, tmp_path / "segs").read(
            Run(pkg, tmp_path / "segs").store(), start_s=start_s)
            for pkg in PKGS]
        assert reads[1] == reads[0], (case, start_s)
    if case == "compacted":
        assert reads[0] is not None and len(reads[0][0]["event"]) == 7
    if case == "late_event":
        assert Run(PORT, tmp_path / "segs").read(
            Run(PORT, tmp_path / "segs").store()) is None


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_appends_to_the_others_directory(tmp_path, writer):
    """One writer after the other on one root (a server restarted on the
    other package): the second seals and compacts what the first left."""
    first, second = (REF, PORT) if writer == "ref" else (PORT, REF)
    a = Run(first, tmp_path / "segs")
    st = a.store()
    st.append_events(APP, None, [a.ev(0, 1001), a.ev(1, 1002)])
    a.clk.t = 1100.0
    st.seal_all()
    b = Run(second, tmp_path / "segs")
    b.clk.t = 1100.0
    st2 = b.store()
    st2.append_events(APP, None, [b.ev(2, 1150)])
    b.clk.t = 1200.0
    st2.seal_all()
    st2.compact(APP, None)
    reads = [Run(pkg, tmp_path / "segs").read(
        Run(pkg, tmp_path / "segs").store()) for pkg in PKGS]
    assert reads[0] == reads[1]
    assert sorted(reads[0][0]["entity_id"]) == ["u0", "u1", "u2"]


# -- the port's repair: no claim over a discarded window ----------------------------

def test_recover_skips_a_damaged_manifest(tmp_path):
    """A directory whose manifest does not parse stays closed at start
    (its own tees fail, as the reference's lazy open makes them); the
    other directories open."""
    r = Run(PORT, tmp_path)
    st = r.store()
    st.append_events(APP, None, [r.ev(0, 1001)])
    st.append_events(APP, 3, [r.ev(1, 1002)])
    r.clk.t = 1100.0
    st.seal_all()
    (tmp_path / "app_7" / "ch_3" / "manifest.json").write_text("{broken")
    st2 = r.store()
    assert st2.recover() == 1
    with pytest.raises(ValueError):
        st2.append_events(APP, 3, [r.ev(2, 1150)])
    st2.append_events(APP, None, [r.ev(3, 1150)])


def test_a_discarded_window_stays_unclaimed_across_restarts(tmp_path):
    """A crashed window's rows may be missing from the segments.  The
    reference keeps its manifest, so its next seal claims them (its
    window starts where the crashed one did), also after a clean restart
    with no write in between.  The port withdraws every claim below the
    discard in the manifest at once: no later writer claims the crashed
    range, and a read from before it falls back."""
    port_obs.get_registry().reset()
    r = Run(PORT, tmp_path)
    st = r.store()
    st.append_events(APP, None, [r.ev(0, 1001)])
    r.clk.t = 1100.0
    st.seal_all()
    st.append_events(APP, None, [r.ev(1, 1150)])     # then a kill -9
    r.clk.t = 1300.0
    st2 = r.store()
    assert st2.recover() == 1                         # discarded at start
    m = r.manifest()
    assert m["floorUs"] == m["activeStartUs"] == int(1300e6)
    assert r.read(st2) is None                        # 1150 is not claimed
    st2.close()                                       # a clean stop
    r.clk.t = 1350.0
    st3 = r.store()
    assert st3.recover() == 1
    assert r.manifest() == m                          # the withdrawal held
    st3.append_events(APP, None, [r.ev(2, 1360)])
    r.clk.t = 1400.0
    st3.seal_all()
    assert r.read(st3) is None
    cols, covered = r.read(st3, start_s=1300.0)
    assert cols["entity_id"] == ["u2"] and covered == int(1400e6)
    assert port_obs.get_registry().get(
        "pio_segment_active_discarded_total").value() == 1


# -- the windowed read ------------------------------------------------------------------

TIES = (1001, 1001, 1002, 1003, 1003, 1003, 1004, 1005, 1005, 1006)
TAIL = (2010, 2010, 2011)


def _rows():
    """(token, user, item, rating or None, event time s): ties included,
    inserted against time order, creation times rising with the insert
    order."""
    rows = [(f"c{k}", f"u{k % 4}", f"i{k % 3}", 0.5 * (k % 10) + 0.5, t)
            for k, t in enumerate(TIES)][::-1]
    rows += [(f"t{k}", f"u{k}", "i9", None, t) for k, t in enumerate(TAIL)]
    return rows


def _events(pkg, rows):
    base = dt.datetime(2026, 5, 1, tzinfo=UTC)
    return [pkg.Event(
        event="buy" if r is None else "rate", entity_type="user",
        entity_id=u, target_entity_type="item", target_entity_id=i,
        properties=pkg.DataMap({} if r is None else {"rating": r,
                                                     "ctx": {"k": [1]}}),
        event_time=dt.datetime.fromtimestamp(t, UTC),
        creation_time=base + dt.timedelta(microseconds=n))
        for n, (_, u, i, r, t) in enumerate(rows)]


def _port_storage(kind, home: Path, stack):
    from predictionio_tpu_torch.config import load_config, memory_config
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage import remote as port_remote

    if kind == "memory":
        return Storage(memory_config(home))
    if kind == "sqlite":
        st = Storage(load_config(env={"PIO_HOME": str(home)}))
        stack.append(st.close)
        return st
    hosted = Storage(load_config(env={"PIO_HOME": str(home / "h")}))
    server = port_remote.StorageServer(hosted)
    server.start()
    env = {"PIO_HOME": str(home / "c"),
           "PIO_STORAGE_SOURCES_REMOTE_TYPE": "pioserver",
           "PIO_STORAGE_SOURCES_REMOTE_PORTS": str(server.port)}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "REMOTE"
    client = Storage(load_config(env=env))
    stack.extend([hosted.close, server.stop, client.close])
    return client


def _ref_storage(kind, home: Path, stack):
    from predictionio_tpu.config import load_config
    from predictionio_tpu.data.storage import Storage

    env = {"PIO_HOME": str(home)}
    if kind == "memory":
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "MEMORY"
    st = Storage(load_config(env=env))
    stack.append(st.close)
    return st


def _fill(pkg, storage, rows, seg_root, clock):
    """The app, every event in the primary store (ids from tokens), and
    the covered prefix teed into sealed segments under the same ids."""
    from predictionio_tpu_torch.data.storage import App as PortApp

    if pkg is PORT:
        App = PortApp
    else:
        from predictionio_tpu.data.storage import App
    app_id = storage.get_apps().insert(App(id=None, name="segapp"))
    storage.get_events().init(app_id)
    evs = _events(pkg, rows)
    ids = storage.get_events().create_batch(
        evs, app_id, tokens=[r[0] for r in rows])
    landed = [dataclasses.replace(e, event_id=i) for e, i in zip(evs, ids)]
    st = pkg.col.SegmentStore(seg_root, roll_bytes=1 << 30, roll_s=1e9,
                              grace_s=0.0, compact_trigger=0,
                              clock=lambda: clock.t)
    clock.t = 1000.0
    covered = [e for e in landed if e.event_time.timestamp() < 2000]
    st.append_events(app_id, None, covered[:4])
    st.append_events(app_id, None, covered[4:])
    clock.t = 2000.0
    st.seal_all()
    return app_id


def _as_text(col):
    """A column as comparable values: bags parsed, ints as int."""
    out = []
    for v in col:
        if isinstance(v, str) and v.startswith("{"):
            v = json.loads(v)
        elif hasattr(v, "to_dict"):
            v = v.to_dict()
        elif isinstance(v, np.integer):
            v = int(v)
        out.append(v)
    return out


READS = [dict(), dict(columns=("entity_id", "target_entity_id",
                               "properties", "event_time_us")),
         dict(event_names=["rate"]), dict(ordered=False),
         dict(until_time=dt.datetime.fromtimestamp(1004, UTC))]


@pytest.mark.parametrize("kind", ["memory", "sqlite", "pioserver"])
def test_windowed_read_through_segments_equals_the_primary_read(
        tmp_path, monkeypatch, kind):
    from predictionio_tpu_torch.data.store import WindowedEventStore

    stack = []
    seg_root = tmp_path / "segs"
    try:
        storage = _port_storage(kind, tmp_path / "home", stack)
        _fill(PORT, storage, _rows(), seg_root, SimpleNamespace(t=0.0))
        start = dt.datetime.fromtimestamp(1000, UTC)
        for kw in READS:
            monkeypatch.setenv("PIO_SEGMENT_DIR", str(seg_root))
            monkeypatch.delenv("PIO_SEGMENTS", raising=False)
            windowed = WindowedEventStore(storage, start, None)
            sliced = windowed._segment_slice(
                "segapp", None, windowed._clamped(dict(kw)))
            until = kw.get("until_time")
            assert sliced is not None and sliced[1] == (
                int(2000e6) if until is None else int(until.timestamp() * 1e6))
            got = windowed.find_columnar("segapp", **kw)
            monkeypatch.setenv("PIO_SEGMENTS", "off")
            want = WindowedEventStore(storage, start, None).find_columnar(
                "segapp", **kw)
            assert list(got) == list(want), kw
            for c in want:
                assert got[c].dtype == want[c].dtype, (kw, c)
                assert list(got[c]) == list(want[c]), (kw, c)
        # the slice really came from the segments: 10 covered rows
        monkeypatch.delenv("PIO_SEGMENTS")
        w = WindowedEventStore(storage, start, None)
        cols, covered = w._segment_slice("segapp", None,
                                         w._clamped({}))
        assert len(cols["event_id"]) == len(TIES)
        assert sorted(cols["event_id"]) == sorted(
            f"btc{k}" for k in range(len(TIES)))
    finally:
        for close in reversed(stack):
            close()


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_windowed_read_equals_the_references(tmp_path, monkeypatch, kind):
    """The same events and one segment directory (the reference's store
    wrote it): both packages' WindowedEventStore give the same rows,
    column for column."""
    from predictionio_tpu.data.store import \
        WindowedEventStore as RefWindowed
    from predictionio_tpu_torch.data.store import WindowedEventStore

    stack = []
    try:
        seg_root = tmp_path / "segs"
        ref = _ref_storage(kind, tmp_path / "ref", stack)
        _fill(REF, ref, _rows(), seg_root, SimpleNamespace(t=0.0))
        port = _port_storage(kind, tmp_path / "port", stack)
        # the port's primary store only; the directory is the reference's
        from predictionio_tpu_torch.data.storage import App
        app_id = port.get_apps().insert(App(id=None, name="segapp"))
        port.get_events().init(app_id)
        port.get_events().create_batch(_events(PORT, _rows()), app_id,
                                       tokens=[r[0] for r in _rows()])
        monkeypatch.setenv("PIO_SEGMENT_DIR", str(seg_root))
        start = dt.datetime.fromtimestamp(1000, UTC)
        for kw in (dict(), dict(event_names=["buy"]),
                   dict(columns=("entity_id", "event_time_us",
                                 "properties"))):
            ref_kw = dict(kw)
            if "columns" in kw:
                ref_kw["columns"] = [("properties_json" if c == "properties"
                                      else c) for c in kw["columns"]]
            want = RefWindowed(ref, start, None).find_columnar(
                "segapp", **ref_kw).to_pydict()
            got = WindowedEventStore(port, start, None).find_columnar(
                "segapp", **kw)
            want = {("properties" if k == "properties_json" else k): v
                    for k, v in want.items()}
            assert list(got) == list(want)
            for c in want:
                assert _as_text(got[c]) == _as_text(want[c]), (kw, c)
    finally:
        for close in reversed(stack):
            close()


def test_windowed_read_falls_back_when_segments_cannot_answer(
        tmp_path, monkeypatch):
    """No coverage from the window start, a damaged sealed file, and a
    full-history read: each is the primary store's read."""
    from predictionio_tpu_torch.data.store import WindowedEventStore

    stack = []
    try:
        storage = _port_storage("sqlite", tmp_path / "home", stack)
        seg_root = tmp_path / "segs"
        _fill(PORT, storage, _rows(), seg_root, SimpleNamespace(t=0.0))
        monkeypatch.setenv("PIO_SEGMENT_DIR", str(seg_root))
        early = dt.datetime.fromtimestamp(900, UTC)
        w = WindowedEventStore(storage, early, None)
        assert w._segment_slice("segapp", None, w._clamped({})) is None
        assert len(w.find_columnar("segapp")["event"]) == 13
        full = WindowedEventStore(storage, None, None)
        assert full._segment_slice("segapp", None, full._clamped({})) \
            is None
        [seg] = list(seg_root.rglob("*.seg"))
        raw = bytearray(seg.read_bytes())
        raw[40] ^= 0x01
        seg.write_bytes(bytes(raw))
        start = dt.datetime.fromtimestamp(1000, UTC)
        w = WindowedEventStore(storage, start, None)
        assert w._segment_slice("segapp", None, w._clamped({})) is None
        got = w.find_columnar("segapp")
        monkeypatch.setenv("PIO_SEGMENTS", "off")
        want = WindowedEventStore(storage, start, None).find_columnar(
            "segapp")
        for c in want:
            assert list(got[c]) == list(want[c])
    finally:
        for close in reversed(stack):
            close()


# -- the event server's tee -------------------------------------------------------------

def _servers(tmp_path, monkeypatch, **env):
    """Both packages' event servers, each over its own sqlite home and
    segment root, one app ``tee`` with key ``K``."""
    import predictionio_tpu.config as ref_config
    import predictionio_tpu.data.storage as ref_storage
    import predictionio_tpu.server.event_server as ref_es
    import predictionio_tpu_torch.config as port_config
    import predictionio_tpu_torch.data.storage as port_storage
    import predictionio_tpu_torch.server.event_server as port_es

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for pkg, config, storage_mod, es in (
            (REF, ref_config, ref_storage, ref_es),
            (PORT, port_config, port_storage, port_es)):
        pkg.reset()
        home = tmp_path / pkg.name
        monkeypatch.setenv("PIO_SEGMENT_DIR", str(home / "segments"))
        storage = storage_mod.Storage(config.load_config(
            env={"PIO_HOME": str(home)}))
        app_id = storage.get_apps().insert(storage_mod.App(id=None,
                                                           name="tee"))
        storage.get_events().init(app_id)
        storage.get_access_keys().insert(storage_mod.AccessKey(
            key="K", app_id=app_id))
        srv = es.EventServer(storage=storage, host="127.0.0.1", port=0)
        out.append(SimpleNamespace(pkg=pkg, srv=srv, storage=storage,
                                   app_id=app_id, home=home))
    return out


def _ev_json(i):
    t = dt.datetime(2026, 5, 1, tzinfo=UTC) + dt.timedelta(seconds=i)
    return {"event": "rate", "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "properties": {"rating": 4},
            "eventTime": t.isoformat(timespec="milliseconds")}


def _post(srv, path, body, params=None):
    return srv.handle("POST", path, {"accessKey": ["K"], **(params or {})},
                      json.dumps(body).encode(), {})


@pytest.mark.parametrize("route", ["single", "batch"])
def test_both_servers_tee_landed_writes_and_report_them(
        tmp_path, monkeypatch, route):
    stacks = _servers(tmp_path, monkeypatch)
    try:
        readies = []
        for s in stacks:
            if route == "single":
                for i in range(3):
                    assert _post(s.srv, "/events.json", _ev_json(i))[0] \
                        == 201
            else:
                st, res = _post(s.srv, "/batch/events.json",
                                [_ev_json(i) for i in range(3)],
                                {"batchToken": ["b1"]})
                assert st == 200 and [r["status"] for r in res] == [201] * 3
            s.srv.segments.seal_all()
            readies.append(s.srv.handle("GET", "/ready", {}, b"", {}))
        assert readies[0] == readies[1]
        assert readies[1][0] == 200 and readies[1][1]["segmentDirs"] == 1
        assert readies[1][1]["segmentCount"] == 1
        assert readies[1][1]["diskDegraded"] is False
        # the port tees the ids the store gave each event
        port = stacks[1]
        payloads = [p for seg in sorted(port.home.rglob("*.seg"))
                    for p in port_columnar.recover_segment_tail(
                        seg, truncate=False)["payloads"]]
        cols = port_columnar._payloads_to_columns(payloads)
        cols["properties"] = cols.pop("properties_json")
        stored = port.storage.get_events().find_columnar(port.app_id)
        assert sorted(cols["event_id"]) == sorted(stored["event_id"])
        assert list(cols["properties"]) == list(stored["properties"])
    finally:
        for s in stacks:
            s.srv.stop()
            s.storage.close()


def test_disk_pressure_degrades_ready_not_ingest(tmp_path, monkeypatch):
    stacks = _servers(tmp_path, monkeypatch,
                      PIO_DISK_MIN_FREE_BYTES=str(1 << 60))
    try:
        seen = []
        for s in stacks:
            assert s.srv.segments is not None
            st, _ = _post(s.srv, "/events.json", _ev_json(0))
            assert st == 201                      # ingest unaffected
            seen.append(s.srv.handle("GET", "/ready", {}, b"", {}))
            reg = s.pkg.registry()
            seen.append(reg.get("pio_segment_tee_errors_total").value(
                kind="disk_pressure"))
        assert seen[:2] == seen[2:]
        assert seen[2][0] == 200 and seen[2][1]["status"] == "degraded"
        assert seen[2][1]["diskDegraded"] is True and seen[3] == 1
    finally:
        for s in stacks:
            s.srv.stop()
            s.storage.close()


def _windowed_reads(storage, start, monkeypatch):
    """The windowed read of app ``tee`` from ``start`` through segments,
    and the same read with them off."""
    from predictionio_tpu_torch.data.store import WindowedEventStore

    via = WindowedEventStore(storage, start, None).find_columnar("tee")
    monkeypatch.setenv("PIO_SEGMENTS", "off")
    try:
        want = WindowedEventStore(storage, start, None).find_columnar("tee")
    finally:
        monkeypatch.delenv("PIO_SEGMENTS")
    return ({c: _as_text(v) for c, v in via.items()},
            {c: _as_text(v) for c, v in want.items()})


def _ev_now(i):
    """An event stamped now, so a window opened before it covers it."""
    t = dt.datetime.now(UTC)
    return {**_ev_json(i), "eventTime": t.isoformat(timespec="milliseconds")}


def test_stop_seals_and_a_restart_discards_a_crashed_window(tmp_path,
                                                            monkeypatch):
    """``stop()`` seals the open window; a window left open by a killed
    server is discarded when the next server starts, and its claim stays
    withdrawn through a clean restart with no write and a later one that
    writes and seals: the windowed read is the primary read throughout."""
    import predictionio_tpu_torch.server.event_server as port_es

    [_, port] = _servers(tmp_path, monkeypatch, PIO_SEGMENT_GRACE_S="0")
    port.srv.segments.open_dir(port.app_id)
    start = dt.datetime.now(UTC)
    time.sleep(0.002)             # events are stamped to the millisecond
    assert _post(port.srv, "/batch/events.json",
                 [_ev_now(i) for i in range(4)])[0] == 200
    port.srv.stop()
    [status] = port.srv.segments.status()
    assert status["segments"] == 1 and status["rows"] == 4
    srv = port_es.EventServer(storage=port.storage, host="127.0.0.1",
                              port=0)
    assert _post(srv, "/events.json", _ev_now(9))[0] == 201
    # a kill: no stop(), the window stays open, the kernel frees the lock
    srv._httpd = None
    srv.segments.release()
    assert list((port.home / "segments").rglob("active-*.tmp"))
    port_obs.get_registry().reset()
    again = port_es.EventServer(storage=port.storage, host="127.0.0.1",
                                port=0)
    assert not list((port.home / "segments").rglob("active-*.tmp"))
    assert port_obs.get_registry().get(
        "pio_segment_active_discarded_total").value() == 1
    [after] = again.segments.status()
    assert after["floorUs"] == after["coveredUntilUs"] > \
        status["coveredUntilUs"]
    again.stop()                  # a clean restart and stop, no write
    third = port_es.EventServer(storage=port.storage, host="127.0.0.1",
                                port=0)
    assert third.segments.status() == [after]
    assert _post(third, "/events.json", _ev_now(10))[0] == 201
    third.stop()                  # seals the new window
    [last] = third.segments.status()
    assert last["segments"] == 2 and last["floorUs"] == after["floorUs"]
    assert third.segments.read_window(
        port.app_id, None, int(start.timestamp() * 1e6), 1 << 62) is None
    via, want = _windowed_reads(port.storage, start, monkeypatch)
    assert len(want["event_id"]) == 6 and via == want
    port.storage.close()


def test_a_second_server_on_a_root_bypasses_the_tee(tmp_path, monkeypatch):
    """One server a root tees, under its writer lock.  A second on the
    same root leaves the first's open window alone and does not tee: it
    counts and reports the bypass and marks what it lands, so a read
    there falls back to the primary store (the first's seal alone would
    claim a range without the second's rows).  Once the second is gone,
    the writer's next seal withdraws its claims and clears the mark."""
    import predictionio_tpu_torch.server.event_server as port_es

    [_, port] = _servers(tmp_path, monkeypatch, PIO_SEGMENT_GRACE_S="0")
    first = port.srv
    first.segments.open_dir(port.app_id)
    start = dt.datetime.now(UTC)
    start_us = int(start.timestamp() * 1e6)
    time.sleep(0.002)             # events are stamped to the millisecond
    assert _post(first, "/events.json", _ev_now(0))[0] == 201
    [active] = list((port.home / "segments").rglob("active-*.tmp"))
    second = port_es.EventServer(storage=port.storage, host="127.0.0.1",
                                 port=0)
    assert active.exists()
    st, body = second.handle("GET", "/ready", {}, b"", {})
    assert st == 200 and body["status"] == "ready"
    assert body["segmentTee"] == "bypassed"
    assert "segmentTee" not in first.handle("GET", "/ready", {}, b"", {})[1]
    assert port_obs.get_registry().get(
        "pio_segment_tee_errors_total").value(kind="writer_locked") == 1
    assert _post(second, "/events.json", _ev_now(1))[0] == 201
    marker = active.parent / "bypassed"
    assert marker.exists()
    first.segments.seal_all()     # the second still lands writes
    assert marker.exists()
    [status] = first.segments.status()
    assert status["rows"] == 1 and status["floorUs"] <= start_us
    assert first.segments.read_window(port.app_id, None, start_us,
                                      1 << 62) is None
    via, want = _windowed_reads(port.storage, start, monkeypatch)
    assert len(want["event_id"]) == 2 and via == want
    second.stop()
    first.segments.seal_all()
    assert not marker.exists()
    [status] = first.segments.status()
    assert status["floorUs"] == status["coveredUntilUs"] > start_us
    via, want = _windowed_reads(port.storage, start, monkeypatch)
    assert len(want["event_id"]) == 2 and via == want
    first.stop()
    port.storage.close()


@pytest.mark.parametrize("kind", ["memory", "sqlite", "pioserver"])
def test_each_backend_answers_bags_in_its_declared_form(tmp_path, kind):
    """``Events.columnar_properties`` is what the windowed read converts
    a segment slice to: each backend's own read answers in that form."""
    stack = []
    try:
        storage = _port_storage(kind, tmp_path / "home", stack)
        _fill(PORT, storage, _rows(), tmp_path / "segs",
              SimpleNamespace(t=0.0))
        events = storage.get_events()
        [app] = [a for a in storage.get_apps().get_all()
                 if a.name == "segapp"]
        bags = events.find_columnar(app.id)["properties"]
        want = {"json": str, "map": DataMap}[events.columnar_properties]
        assert len(bags) == 13
        assert all(isinstance(b, want) for b in bags)
    finally:
        for close in reversed(stack):
            close()


def test_a_batch_teed_twice_reads_once(tmp_path):
    """A client posting a batch again under its token lands it once in
    the primary store and tees it twice (a replay in a later window is
    a late event, and ratchets the floor instead); the read keeps the
    first row of each event id (rows without an id are never merged)."""
    r = Run(PORT, tmp_path)
    st = r.store()
    landed = [e.with_event_id(f"btb1.{k}") for k, e in
              enumerate([r.ev(0, 1001), r.ev(1, 1002)])]
    st.append_events(APP, None, landed)
    st.append_events(APP, None, [r.ev(2, 1003), r.ev(2, 1003)])
    st.append_events(APP, None, landed)               # the replay's tee
    r.clk.t = 1100.0
    st.seal_all()
    cols, covered = r.read(st)
    assert cols["event_id"] == ["btb1.0", "btb1.1", None, None]
    assert covered == int(1100e6)
