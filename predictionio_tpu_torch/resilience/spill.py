"""Storage-outage spill journal + recovery replay.

Port of ``predictionio_tpu/resilience/spill.py``: the same file layout
and record format, so ``pio spill`` of either package reads a journal
the other wrote.

When the event store is unreachable (breaker open or a write fails with
an availability error), the event server must not 500 and silently drop
the batch — ingest durability is the product promise.  Instead the
failed write's events are appended to a durable JSONL journal on local
disk, the client gets **202 + Retry-After**, and a background
:class:`ReplayWorker` drains the journal into storage once it recovers.

Journal layout (``PIO_SPILL_DIR``, default ``$PIO_HOME/spill``)::

    spill.jsonl       one record per FAILED WRITE (a single insert or a
                      whole batch), carrying the idempotency token that
                      write was issued under:
                      {"token": ..., "appId": ..., "channelId": ...,
                       "events": [{...}, ...]}
    spill.offset      count of leading records already replayed
    spill.dead.jsonl  dead-lettered records (permanent replay failures)

Records keep the ORIGINAL write's idempotency token so replay re-issues
the semantically identical request: if the outage was really a lost
reply (the backend committed before the connection died), the storage
server's dedup window answers the replay without re-inserting.  Records
are only marked replayed AFTER the insert succeeds (advance the offset,
never rewrite history), so a crash mid-replay re-runs at-least-once and
the token turns that into exactly-once against dedup-capable backends.

A partial trailing line (crash mid-append, before the fsync returned and
therefore before any 202 was sent) is truncated away at open.  A record
that fails replay with a PERMANENT error (validation, schema drift) is
dead-lettered — logged, counted, moved to ``spill.dead.jsonl`` — instead
of blocking every record behind it forever.

Metrics: ``pio_spill_queue_depth`` (gauge, in events),
``pio_spill_spilled_total`` / ``pio_spill_replayed_total`` /
``pio_spill_dead_lettered_total`` (counters, in events).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from predictionio_tpu_torch.obs import get_registry, publish_event
from predictionio_tpu_torch.resilience.policy import CircuitOpenError

logger = logging.getLogger(__name__)

__all__ = ["SpillJournal", "ReplayWorker", "resolve_spill_dir",
           "journal_summary"]

_DISABLED = ("off", "none", "disabled", "0")


def resolve_spill_dir(explicit: Optional[str], home: Optional[Path]
                      ) -> Optional[Path]:
    """Spill directory per precedence: explicit arg > ``PIO_SPILL_DIR``
    env > ``<home>/spill``; the sentinel values off/none/disabled/0 (or
    no resolvable home) disable spilling entirely."""
    cand = explicit if explicit is not None else os.environ.get("PIO_SPILL_DIR")
    if cand is not None:
        return None if cand.strip().lower() in _DISABLED or not cand.strip() \
            else Path(cand)
    return Path(home) / "spill" if home else None


class SpillJournal:
    """Durable append-only JSONL queue with a persisted replay offset.

    One record per failed write; ``depth()`` counts pending EVENTS (what
    operators care about), the offset counts records.

    ``divert_if_locked=False`` (the ``pio spill`` manual-ops path) turns
    the locked-directory divert into a hard error instead — an operator
    draining a journal wants THE journal, not a fresh private one."""

    def __init__(self, directory: Path, registry=None, *,
                 divert_if_locked: bool = True):
        base = Path(directory)
        base.mkdir(parents=True, exist_ok=True)
        # Cross-process exclusion: the journal format assumes a SINGLE
        # appender/replayer.  First comer flocks the directory; any other
        # process (second event server on the same PIO_HOME) diverts to a
        # private instance-<pid>-<rand> subdirectory so neither can
        # truncate under the other or double-replay the same records.
        self._lock_f = None
        self._divert_if_locked = divert_if_locked
        self.dir = self._acquire_dir(base)
        self.path = self.dir / "spill.jsonl"
        self.offset_path = self.dir / "spill.offset"
        self.dead_path = self.dir / "spill.dead.jsonl"
        self._lock = threading.RLock()
        reg = registry or get_registry()
        self._depth_gauge = reg.gauge(
            "pio_spill_queue_depth",
            "Spilled events awaiting replay into storage.")
        self._spilled = reg.counter(
            "pio_spill_spilled_total",
            "Events diverted to the spill journal during storage outages.")
        self._replayed = reg.counter(
            "pio_spill_replayed_total",
            "Spilled events successfully replayed into storage.")
        self._dead = reg.counter(
            "pio_spill_dead_lettered_total",
            "Spilled events moved to the dead-letter file after a "
            "permanent replay failure.")
        self._offset = 0
        if self.offset_path.exists():
            try:
                self._offset = int(self.offset_path.read_text().strip() or 0)
            except ValueError:
                self._offset = 0
        self._count = 0            # valid records on disk
        self._pending_events = 0   # events in records past the offset
        self._read_pos = 0         # byte position of record #_offset
        self._recover()
        self._f = open(self.path, "a", encoding="utf-8")
        self._depth_gauge.set(self._pending_events)
        # Trace-ring incident record: a journal opening with backlog is
        # the first sign of a prior outage or crash worth correlating.
        publish_event("spill.open", dir=str(self.dir),
                      pendingEvents=self._pending_events)

    def _acquire_dir(self, base: Path) -> Path:
        try:
            import fcntl
        except ImportError:  # non-posix: single-instance risk accepted
            return base
        f = open(base / ".lock", "a")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            self._lock_f = f
            return base
        except OSError:
            f.close()
        if not self._divert_if_locked:
            raise RuntimeError(
                f"spill journal {base} is locked by a running event "
                "server — stop it (or point --dir at its private "
                "instance-* directory) before draining/requeueing")
        inst = base / f"instance-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        inst.mkdir(parents=True, exist_ok=True)
        logger.warning(
            "spill journal %s is locked by another instance; using "
            "private directory %s (its records replay only while THIS "
            "process lives — prefer one event server per PIO_SPILL_DIR)",
            base, inst)
        f = open(inst / ".lock", "a")
        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)  # fresh dir: free
        self._lock_f = f
        return inst

    def _recover(self) -> None:
        """Count records/pending events; truncate a partial trailing line
        (crash mid-append — its 202 was never sent, dropping it is safe);
        reconcile a stale offset file (crash between drain-truncate and
        offset reset) so the journal can never wedge."""
        if not self.path.exists():
            return
        valid_bytes = 0
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break  # no terminator: partial trailing line
            line = data[pos:nl].strip()
            if line:
                try:
                    rec = json.loads(line)
                    n_events = len(rec["events"])
                except (ValueError, KeyError, TypeError):
                    # corruption mid-file cannot happen with our single
                    # appender; treat everything from here as the torn tail
                    break
                if self._count >= self._offset:
                    self._pending_events += n_events
                self._count += 1
                if self._count == self._offset:
                    self._read_pos = nl + 1
            pos = nl + 1
            valid_bytes = pos
        if valid_bytes < len(data):
            logger.warning("spill journal: truncating %d torn byte(s) at "
                           "the tail of %s", len(data) - valid_bytes,
                           self.path)
            with open(self.path, "r+b") as f:
                f.truncate(valid_bytes)
        if self._offset > self._count:
            # stale offset file outliving a drain-truncate: without this
            # clamp peek() would skip PAST every future record forever
            logger.warning("spill journal: clamping stale offset %d to "
                           "%d record(s)", self._offset, self._count)
            self._offset = self._count
            self._read_pos = valid_bytes

    def depth(self) -> int:
        """Events (not records) awaiting replay."""
        with self._lock:
            return self._pending_events

    def append(self, events_json: List[Dict[str, Any]], app_id: int,
               channel_id: Optional[int], token: Optional[str] = None,
               tokens: Optional[List[str]] = None) -> str:
        """Durably queue one failed write (1..n events) under the
        idempotency token that write was issued with; returns the token.

        ``tokens`` carries the bulk endpoint's PER-ITEM
        sub-tokens: replay then lands through ``create_batch`` with ids
        derived from them, so a batch that partially committed before
        the crash dedups row-by-row instead of all-or-nothing."""
        token = token or uuid.uuid4().hex
        record = {"token": token, "appId": app_id, "channelId": channel_id,
                  "events": list(events_json)}
        if tokens is not None:
            record["tokens"] = list(tokens)
        line = json.dumps(record, separators=(",", ":"))
        with self._lock:
            # Remember the pre-write size and roll back to it if the
            # write/flush/fsync fails: a half-durable line that the
            # in-memory accounting never counted would desynchronize the
            # position-based peek()/advance() from the file and could
            # truncate a LATER acked record unreplayed.
            pos = self._f.seek(0, os.SEEK_END)
            try:
                self._f.write(line + "\n")
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                try:
                    self._f.truncate(pos)
                except OSError:
                    logger.exception(
                        "spill journal rollback failed; closing the "
                        "journal (fails ingest to 503 rather than "
                        "risking misaligned replay)")
                    self._f.close()
                raise
            self._count += 1
            self._pending_events += len(record["events"])
            self._depth_gauge.set(self._pending_events)
        self._spilled.inc(len(record["events"]))
        # Inside the ingest request's trace: THIS request degraded to the
        # journal, so the 202 in the ring explains itself.
        publish_event("spill.append", token=token,
                      events=len(record["events"]),
                      pendingEvents=self.depth())
        return token

    def peek(self, n: int) -> List[Dict[str, Any]]:
        """Next ``n`` unreplayed records (oldest first).  Seeks straight
        to the current offset's byte position — no rescan of the
        already-replayed prefix, so a large-outage drain stays O(n)."""
        with self._lock:
            out: List[Dict[str, Any]] = []
            remaining = self._count - self._offset
            with open(self.path, "rb") as f:
                f.seek(self._read_pos)
                while len(out) < min(n, remaining):
                    line = f.readline()
                    if not line.endswith(b"\n"):
                        break  # torn tail (pre-truncation) — never acked
                    if line.strip():
                        out.append(json.loads(line))
            return out

    def _advance(self, records: List[Dict[str, Any]]) -> None:
        """Move the durable offset past ``records``; a fully drained
        journal truncates back to empty (call with the lock held)."""
        self._offset += len(records)
        self._pending_events -= sum(len(r["events"]) for r in records)
        if self._offset >= self._count:
            # Reset the offset file BEFORE truncating: a crash in between
            # then re-replays from 0 (at-least-once, token-dedup'd) rather
            # than leaving a stale offset pointing past an empty file.
            self.offset_path.unlink(missing_ok=True)
            self._f.close()
            self._f = open(self.path, "w", encoding="utf-8")
            self._offset = 0
            self._count = 0
            self._pending_events = 0
            self._read_pos = 0
        else:
            with open(self.path, "rb") as f:
                f.seek(self._read_pos)
                for _ in range(len(records)):
                    f.readline()
                self._read_pos = f.tell()
            tmp = self.offset_path.with_suffix(".offset.tmp")
            tmp.write_text(str(self._offset))
            tmp.replace(self.offset_path)
        self._depth_gauge.set(self._pending_events)

    def mark_replayed(self, records: List[Dict[str, Any]]) -> None:
        if not records:
            return
        with self._lock:
            self._advance(records)
        n = sum(len(r["events"]) for r in records)
        self._replayed.inc(n)
        publish_event("spill.replayed", events=n,
                      pendingEvents=self.depth())

    def dead_letter(self, record: Dict[str, Any], reason: str) -> None:
        """Skip a permanently unreplayable record: persist it to the
        dead-letter file for the operator, advance past it."""
        logger.error("spill replay dead-lettering %d event(s) "
                     "(token %s): %s", len(record["events"]),
                     record.get("token"), reason)
        with self._lock:
            with open(self.dead_path, "a", encoding="utf-8") as f:
                f.write(json.dumps({"reason": reason, **record},
                                   separators=(",", ":")) + "\n")
            self._advance([record])
        self._dead.inc(len(record["events"]))
        publish_event("spill.dead_letter", token=record.get("token"),
                      events=len(record["events"]), reason=reason)

    def dead_records(self) -> List[Dict[str, Any]]:
        """Parse the dead-letter file (operator inspection/requeue)."""
        if not self.dead_path.exists():
            return []
        out: List[Dict[str, Any]] = []
        with open(self.dead_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    logger.warning("spill dead-letter file has an "
                                   "unparseable line; skipping it")
        return out

    def requeue_dead(self) -> int:
        """Move every dead-lettered record back into the live journal
        (``pio spill requeue-dead`` — after the operator fixed whatever
        made replay reject them).  Each record re-queues under its
        ORIGINAL idempotency token, so a record that was dead-lettered
        for a transient miscategorized as permanent still dedups.
        Returns the number of EVENTS requeued."""
        records = self.dead_records()
        n_events = 0
        for rec in records:
            self.append(rec["events"], rec["appId"], rec.get("channelId"),
                        token=rec.get("token"))
            n_events += len(rec["events"])
        if records:
            self.dead_path.unlink()
            publish_event("spill.requeue_dead", records=len(records),
                          events=n_events)
        return n_events

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
            if self._lock_f is not None:
                self._lock_f.close()  # releases the flock
                self._lock_f = None


def journal_summary(directory: Path) -> Dict[str, Any]:
    """Read-only spill-journal summary (``pio spill inspect``) — parses
    the files directly, takes NO lock, never mutates: safe to run while
    the owning event server is live (the numbers are a point-in-time
    snapshot)."""
    d = Path(directory)
    path, offset_path, dead_path = (d / "spill.jsonl", d / "spill.offset",
                                    d / "spill.dead.jsonl")
    offset = 0
    if offset_path.exists():
        try:
            offset = int(offset_path.read_text().strip() or 0)
        except ValueError:
            offset = 0
    records = pending_events = 0
    tokens: List[str] = []
    if path.exists():
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n") or not line.strip():
                    continue  # torn tail / blank
                try:
                    rec = json.loads(line)
                    n = len(rec["events"])
                except (ValueError, KeyError, TypeError):
                    continue
                records += 1
                if records > offset:
                    pending_events += n
                    if len(tokens) < 5:
                        tokens.append(rec.get("token"))
    dead_records = dead_events = 0
    if dead_path.exists():
        with open(dead_path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                dead_records += 1
                dead_events += len(rec.get("events", []))
    instances = sorted(p.name for p in d.glob("instance-*") if p.is_dir())
    return {
        "dir": str(d),
        "records": records,
        "replayedOffset": min(offset, records),
        "pendingRecords": max(records - offset, 0),
        "pendingEvents": pending_events,
        "pendingTokens": tokens,
        "deadRecords": dead_records,
        "deadEvents": dead_events,
        "privateInstanceDirs": instances,
    }


# Replay failures that mean "storage still down, try again next tick" —
# anything else is permanent for that record and dead-letters it.
_DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    CircuitOpenError, ConnectionError, OSError)


class ReplayWorker:
    """Background thread draining a :class:`SpillJournal` into storage.

    ``insert_fn(record)`` performs one write (the event server routes it
    through its circuit breaker, making this worker the natural half-open
    prober).  A ``transient_types`` failure pauses the drain until the
    next tick; any other exception dead-letters THAT record and keeps
    draining — one poison record must not wedge the queue.  The journal
    only advances past records that landed (or were dead-lettered)."""

    def __init__(self, journal: SpillJournal,
                 insert_fn: Callable[[Dict[str, Any]], Any],
                 interval_s: float = 0.25, batch: int = 100,
                 transient_types: Tuple[Type[BaseException], ...]
                 = _DEFAULT_TRANSIENT,
                 wait: Optional[Callable[[threading.Event, float], bool]]
                 = None):
        self.journal = journal
        self.insert_fn = insert_fn
        self.interval_s = float(interval_s)
        self.batch = int(batch)
        self.transient_types = transient_types
        self._stop = threading.Event()
        # Injectable tick wait: the default rides the stop event's
        # wall-clock wait; tests inject a waiter that parks the thread
        # (or advances a fake clock) so replay timing is driven
        # deterministically, as CircuitBreaker's clock is.
        self._wait = wait if wait is not None else \
            (lambda ev, timeout: ev.wait(timeout))
        self._thread = threading.Thread(
            target=self._run, name="pio-spill-replay", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._wait(self._stop, self.interval_s):
            try:
                self.drain_once()
            except Exception:
                # belt-and-suspenders: a surprise here must not kill the
                # only thread that can ever drain the journal
                logger.exception("spill replay tick failed")

    def drain_once(self) -> int:
        """Replay as much as currently possible; returns events landed."""
        landed = 0
        while not self._stop.is_set():
            if self.journal.depth() == 0:
                break
            records = self.journal.peek(self.batch)
            if not records:
                break
            done: List[Dict[str, Any]] = []
            paused = False
            for rec in records:
                try:
                    self.insert_fn(rec)
                except self.transient_types as e:
                    logger.debug("spill replay paused after %d/%d: %s",
                                 len(done), len(records), e)
                    paused = True
                    break
                except Exception as e:
                    # flush what landed so the dead-letter advance (which
                    # also moves the offset) stays in order
                    self.journal.mark_replayed(done)
                    landed += sum(len(r["events"]) for r in done)
                    done = []
                    self.journal.dead_letter(rec, f"{type(e).__name__}: {e}")
                else:
                    done.append(rec)
            self.journal.mark_replayed(done)
            landed += sum(len(r["events"]) for r in done)
            if paused:
                break
        return landed

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self.journal.close()
