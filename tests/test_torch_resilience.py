"""The port's resilience stack against the reference's: retries, the
breaker, the ``PIO_FAULTS`` harness, the spill journal, the shared spill
queue, and the event server's exactly-once batches under outages.

Every drill runs once on each package with the same inputs, the same
fault plan and the same seed, over a sqlite ``PIO_HOME`` of its own, and
returns what it observed: status codes, ``Retry-After``, the breaker's
state after each step on a fake clock, the journal's and the shared
queue's depth, and the stored rows after replay (event ids included when
they derive from a client token; ingest stamps masked).  The two
observations must be equal, and each drill also asserts the contract
itself (every event lands exactly once).  The drills mirror the
reference's ``tests/test_bulk_ingest.py`` and ``tests/test_resilience.py``.
"""

import http.client
import json
import os
import random
import unittest.mock as mock
from types import SimpleNamespace

import pytest

import predictionio_tpu.cli.main as ref_cli
import predictionio_tpu.config as ref_config
import predictionio_tpu.data.json_support as ref_json
import predictionio_tpu.data.storage as ref_storage
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.resilience.faults as ref_faults
import predictionio_tpu.resilience.policy as ref_policy
import predictionio_tpu.resilience.shared_spill as ref_shared
import predictionio_tpu.resilience.spill as ref_spill
import predictionio_tpu.server.event_server as ref_es
import predictionio_tpu_torch.cli.main as port_cli
import predictionio_tpu_torch.config as port_config
import predictionio_tpu_torch.data.json_support as port_json
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.resilience.faults as port_faults
import predictionio_tpu_torch.resilience.policy as port_policy
import predictionio_tpu_torch.resilience.shared_spill as port_shared
import predictionio_tpu_torch.resilience.spill as port_spill
import predictionio_tpu_torch.server.event_server as port_es

REF = SimpleNamespace(
    name="ref", config=ref_config, storage=ref_storage, json=ref_json,
    es=ref_es, faults=ref_faults, policy=ref_policy, spill=ref_spill,
    shared=ref_shared, cli=ref_cli, registry=ref_obs.get_registry,
    reset_metrics=ref_obs.reset_observability)
PORT = SimpleNamespace(
    name="port", config=port_config, storage=port_storage, json=port_json,
    es=port_es, faults=port_faults, policy=port_policy, spill=port_spill,
    shared=port_shared, cli=port_cli, registry=port_obs.get_registry,
    reset_metrics=lambda: port_obs.get_registry().reset())
PKGS = (REF, PORT)
KEY = "K-drill"


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "env_home"))
    monkeypatch.setenv("PIO_SEGMENTS", "off")
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_SPILL", "PIO_FAULTS",
                         "PIO_MAX_BATCH", "PIO_INGEST", "PIO_BREAKER",
                         "PIO_RETRY_AFTER", "PIO_EVENTSERVER_PLUGINS")):
            monkeypatch.delenv(k, raising=False)
    yield
    for pkg in PKGS:
        pkg.faults.clear()
        pkg.reset_metrics()


def compare(drill, tmp_path, **kw):
    """Run ``drill`` on both packages; their observations must agree."""
    seen = []
    for pkg in PKGS:
        pkg.reset_metrics()
        seen.append(drill(pkg, tmp_path / pkg.name, **kw))
        pkg.faults.clear()
    assert seen[1] == seen[0]
    return seen[1]


def open_store(pkg, home):
    storage = pkg.storage.Storage(
        pkg.config.load_config(env={"PIO_HOME": str(home)}))
    app_id = storage.get_apps().insert(pkg.storage.App(id=None,
                                                       name="drill"))
    storage.get_events().init(app_id)
    storage.get_access_keys().insert(pkg.storage.AccessKey(key=KEY,
                                                           app_id=app_id))
    return storage, app_id


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def stack(pkg, home, clock=None, **server_kw):
    """An event server over a fresh sqlite home whose breaker (threshold
    2, recovery 30 s) runs on ``clock``; its replay and lease threads
    park until stop, so a drill drains with ``drain_once``."""
    storage, app_id = open_store(pkg, home)
    breaker = pkg.policy.CircuitBreaker(
        "eventdata", failure_threshold=2, recovery_time_s=30.0,
        failure_types=(pkg.storage.StorageUnavailable, ConnectionError),
        clock=clock or FakeClock())
    srv = pkg.es.EventServer(
        storage=storage, host="127.0.0.1", port=0, breaker=breaker,
        replay_interval_s=3600, replay_wait=lambda ev, t: ev.wait(),
        drain_wait=lambda ev, t: ev.wait(), **server_kw)
    return SimpleNamespace(srv=srv, storage=storage, app_id=app_id,
                           breaker=breaker)


def ev(i, name="view"):
    return {"event": name, "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i % 5}",
            "eventTime": f"2026-02-01T00:00:{i % 60:02d}Z"}


def post(st, path, payload, **params):
    p = {"accessKey": [KEY], **{k: [v] for k, v in params.items()}}
    return st.srv.handle("POST", path, p, json.dumps(payload).encode())


def rows(pkg, st, masked=True):
    out = [pkg.json.event_to_json(e)
           for e in st.storage.get_events().find(st.app_id)]
    if masked:
        for r in out:
            r.pop("creationTime")
            if not r["eventId"].startswith("bt") or "." not in r["eventId"]:
                r["eventId"] = "<id>"
    return out


def http_post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Retry-After"), json.loads(r.read())
    finally:
        conn.close()


# -- retries, the breaker, the fault plan -------------------------------------


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (7, {"base_delay_ms": 10, "multiplier": 3.0, "jitter": 0.5}),
    (123, {"max_delay_ms": 300, "jitter": 0.0})])
def test_retry_backoff_sequence_equals_the_reference(seed, kw):
    seqs = []
    for pkg in PKGS:
        pol = pkg.policy.RetryPolicy(max_attempts=6, rng=random.Random(seed),
                                     **kw)
        seq = [pol.backoff_ms(a) for a in range(10)]
        seq += [pol.backoff_ms(2, retry_after_ms=ra)
                for ra in (0.0, 1500.0, 99_999.0, -5.0)]
        slept = []
        pol._sleep = slept.append
        calls = {"n": 0}

        class Flaky(RuntimeError):
            retriable = True

        def fn():
            calls["n"] += 1
            if calls["n"] < 5:
                e = Flaky("again")
                e.retry_after_s = 0.25 if calls["n"] == 3 else None
                raise e
            return "done"

        assert pol.run(fn) == "done"
        seqs.append((seq, slept, calls["n"]))
    assert seqs[1] == seqs[0]


def test_breaker_state_sequence_equals_the_reference():
    def script(pkg):
        clock = FakeClock()
        br = pkg.policy.CircuitBreaker(
            "t", failure_threshold=3, recovery_time_s=30.0,
            half_open_successes=2, failure_types=(ConnectionError,),
            clock=clock)
        gauge = pkg.registry().get("pio_breaker_state")
        out = []

        def boom():
            raise ConnectionError("down")

        for step, (dt, fn) in enumerate(
                [(0, boom), (0, lambda: "ok"), (0, boom), (0, boom),
                 (0, boom), (10, boom), (19, boom), (1.5, boom),
                 (30.5, lambda: "ok"), (0, boom), (31, lambda: "ok"),
                 (0, lambda: "ok"), (0, lambda: (_ for _ in ()).throw(
                     ValueError("client fault")))]):
            clock.t += dt
            try:
                res = br.call(fn)
            except pkg.policy.CircuitOpenError as e:
                res = f"shed {e.retry_after_s:.3f}"
            except (ConnectionError, ValueError) as e:
                res = type(e).__name__
            out.append((step, res, br.state, round(br.retry_after_s(), 6),
                        gauge.value(breaker="t")))
        trans = pkg.registry().get("pio_breaker_transitions_total")
        return out, sorted(trans.series().items())

    pkg_runs = []
    for pkg in PKGS:
        pkg.reset_metrics()
        pkg_runs.append(script(pkg))
    assert pkg_runs[1] == pkg_runs[0]
    states = [s for _, _, s, _, _ in pkg_runs[1][0]]
    assert "half-open" in states and states[-1] == "closed"


def test_fault_plan_grammar_and_seeded_firing_equal_the_reference(
        monkeypatch):
    spec = ("storage.create:error:0.3,storage.find:delay:200ms,"
            "spillq.*:error:1.0:2,slowpoke:delay:1.5s:0.5:7")
    monkeypatch.setenv("PIO_FAULTS_SEED", "11")
    fired = []
    for pkg in PKGS:
        plan = pkg.faults.parse_plan(spec)
        naps = []
        plan.sleep = naps.append
        rules = [(r.match, r.kind, r.probability, r.delay_ms, r.max_count)
                 for r in plan.rules]
        seq = []
        for i in range(60):
            point = ("storage.create", "storage.find", "spillq.lease",
                     "slowpoke")[i % 4]
            try:
                plan.apply(point)
                seq.append((point, "ok"))
            except pkg.faults.FaultInjected as e:
                assert isinstance(e, ConnectionError) and e.point == point
                seq.append((point, "error"))
        fired.append((rules, seq, naps))
        for bad in ("nocolon", "x:teleport", "x:delay"):
            with pytest.raises(ValueError):
                pkg.faults.parse_plan(bad)
    assert fired[1] == fired[0]
    assert ("spillq.lease", "error") in fired[1][1]


# -- exactly-once batches ---------------------------------------------------


def _token_retry(pkg, home):
    st = stack(pkg, home)
    try:
        batch = [ev(0), ev(1), {"entityType": "user"}, ev(2)]
        s1, r1 = post(st, "/batch/events.json", batch, batchToken="tok-1")
        landed = rows(pkg, st, masked=False)
        s2, r2 = post(st, "/batch/events.json", batch, batchToken="tok-1")
        assert s1 == s2 == 200 and r1 == r2
        # the retry skips the committed rows: they keep their stamps
        assert rows(pkg, st, masked=False) == landed
        assert [r["status"] for r in r1] == [201, 201, 400, 201]
        got = rows(pkg, st)
        assert len(got) == 3
        return r1, got
    finally:
        st.srv.stop()


def test_token_retry_dedups_row_by_row(tmp_path):
    ids, _ = compare(_token_retry, tmp_path)
    assert [r.get("eventId") for r in ids] == \
        ["bttok-1.0", "bttok-1.1", None, "bttok-1.3"]


def _partial_landing(pkg, home):
    """Storage 'fails' a batch AFTER committing its first half (a lost
    reply): the batch spills with its per-item tokens, and the replay
    lands only the missing rows."""
    st = stack(pkg, home)
    try:
        repo = st.storage.get_events()
        real = type(repo).create_batch
        calls = {"n": 0}

        def flaky(self, evs, app_id_, channel_id=None, tokens=None):
            calls["n"] += 1
            if calls["n"] == 1:
                half = len(evs) // 2
                real(self, evs[:half], app_id_, channel_id,
                     tokens=list(tokens)[:half])
                raise pkg.storage.StorageUnavailable("crashed mid-batch")
            return real(self, evs, app_id_, channel_id, tokens=tokens)

        with mock.patch.object(type(repo), "create_batch", flaky):
            status, results = post(st, "/batch/events.json",
                                   [ev(i) for i in range(6)],
                                   batchToken="crashy")
            depth = st.srv.spill.depth()
            landed_before = len(rows(pkg, st))
            replayed = st.srv._replay.drain_once()
        got = rows(pkg, st)
        assert [r["status"] for r in results] == [202] * 6
        assert (depth, landed_before, replayed, len(got)) == (6, 3, 6, 6)
        assert {r["entityId"] for r in got} == {f"u{i}" for i in range(6)}
        return status, [r["status"] for r in results], got
    finally:
        st.srv.stop()


def test_spill_replay_of_a_partially_landed_batch_lands_once(tmp_path):
    compare(_partial_landing, tmp_path)


def _full_outage(pkg, home):
    """Every write fails (``storage.create:error:1.0``): 200 events spill
    with 202, the breaker opens; once the fault clears, a drain pauses
    while the breaker is open, then lands all 200 exactly once."""
    clock = FakeClock()
    st = stack(pkg, home, clock=clock)
    st.srv.start()
    obs = []
    try:
        pkg.faults.install("storage.create:error:1.0")
        for start in range(0, 200, 50):
            status, results = post(
                st, "/batch/events.json",
                [ev(start + i) for i in range(50)],
                batchToken=f"b{start}")
            obs.append((status, sorted({r["status"] for r in results}),
                        st.breaker.state, st.srv.spill.depth()))
        # one single POST over HTTP while the breaker is open: journaled
        code, retry_after, body = http_post(
            st.srv.port, f"/events.json?accessKey={KEY}", ev(999))
        obs.append((code, retry_after, sorted(body), st.srv.spill.depth()))
        pkg.faults.clear()
        obs.append(("drain while open", st.srv._replay.drain_once(),
                    st.breaker.state, st.srv.spill.depth()))
        clock.t += 30.5
        obs.append(("drain after recovery", st.srv._replay.drain_once(),
                    st.breaker.state, st.srv.spill.depth()))
        reg = pkg.registry()
        obs.append((reg.get("pio_spill_queue_depth").value(),
                    reg.get("pio_spill_spilled_total").value(),
                    reg.get("pio_spill_replayed_total").value(),
                    reg.get("pio_faults_injected_total").total()))
        got = rows(pkg, st)
        assert len(got) == 201
        assert len({(r["entityId"], r["eventTime"]) for r in got}) == 201
        return obs, got
    finally:
        st.srv.stop()


def test_full_outage_spills_then_replays_exactly_once(tmp_path):
    obs, _ = compare(_full_outage, tmp_path)
    assert obs[0] == (200, [202], "closed", 50)   # threshold 2
    assert obs[1] == (200, [202], "open", 100)
    assert obs[4] == (202, "5", ["message", "token"], 201)
    assert obs[5][1:] == (0, "open", 201)
    assert obs[6][1:] == (201, "closed", 0)


def _shared_queue(pkg, home, monkeypatch):
    """``PIO_SPILL_BACKEND=shared``: a failed batch goes to the sqlite
    spill queue (its enqueue is not a storage.create); the lease drainer
    replays it."""
    monkeypatch.setenv("PIO_SPILL_BACKEND", "shared")
    st = stack(pkg, home)
    try:
        assert st.srv.spill_backend == "shared"
        pkg.faults.install("storage.create:error:1.0:1")
        status, results = post(st, "/batch/events.json",
                               [ev(i) for i in range(7)], batchToken="sq")
        shared = st.srv.shared_spill
        obs = [(status, [r["status"] for r in results],
                shared.cached_depth(), shared.depth(),
                st.srv.spill.depth())]
        ready = st.srv.handle("GET", "/ready", {}, b"")
        landed = st.srv._lease_drainer.drain_once()
        obs.append((ready, landed, shared.depth(), shared.stats()))
        got = rows(pkg, st)
        assert len(got) == 7
        return obs, got
    finally:
        st.srv.stop()


def test_shared_queue_spill_and_lease_replay(tmp_path, monkeypatch):
    obs, _ = compare(_shared_queue, tmp_path, monkeypatch=monkeypatch)
    assert obs[0][2:] == (7, 7, 0) and obs[1][1:3] == (7, 0)


def _lease_steal_and_dead_letter(pkg, home):
    """Two drainers on one sqlite queue and a fake clock: A leases and
    stalls, its lease expires, B steals and lands the records; A's late
    ack finds nothing.  A poison record dead-letters; ``requeue_dead``
    brings it back."""
    storage, app_id = open_store(pkg, home)
    clock = FakeClock(5000.0)
    q = pkg.shared.SharedSpillQueue(storage, clock=clock)
    for i in range(3):
        q.append([ev(10 * i + j) for j in range(2)], app_id, None,
                 token=f"rec{i}", tokens=[f"rec{i}-{j}" for j in range(2)])
    q.append([ev(90)], app_id, None, token="rec0")   # token-idempotent
    landed = []

    def insert(record):
        if record["token"] == "rec2" and not landed.count("fixed"):
            raise ValueError("poison")
        evs = [pkg.json.event_from_json(e) for e in record["events"]]
        storage.get_events().create_batch(evs, record["appId"],
                                          tokens=record["tokens"])
        landed.append(record["token"])

    a = pkg.shared.LeaseDrainer(q, insert, owner="A", lease_ttl_s=10,
                                wait=lambda ev_, t: ev_.wait())
    b = pkg.shared.LeaseDrainer(q, insert, owner="B", lease_ttl_s=10,
                                wait=lambda ev_, t: ev_.wait())
    obs = [q.depth(), q.stats()]
    stalled = q.lease("A", 2, 10)
    obs.append(([r.token for r in stalled], q.stats()))
    clock.t += 11                          # A's lease lapses
    obs.append(("B lands", b.drain_once(), q.stats(), list(landed)))
    obs.append(("A acks late", q.ack([r.id for r in stalled], "A"),
                pkg.registry().get("pio_spill_lease_lost_total").value()))
    obs.append(("dead", q.dead_records() and
                [r["token"] for r in q.dead_records()], q.stats()))
    landed.append("fixed")
    obs.append(("requeue", q.requeue_dead(), a.drain_once(), q.stats()))
    got = [(e.event_id, e.entity_id)
           for e in storage.get_events().find(app_id)]
    storage.close()
    assert sorted(got) == sorted(
        (f"btrec{i}-{j}", f"u{10 * i + j}") for i in range(3)
        for j in range(2))
    return obs, got


def test_lease_steal_dead_letter_and_requeue(tmp_path):
    obs, _ = compare(_lease_steal_and_dead_letter, tmp_path)
    assert obs[4][1] == 0 and obs[4][2] == 2   # A's ack lost both


def test_shared_spill_events_as_the_reference(tmp_path):
    """The lease drill's trace-ring events (``spill.shared.append``,
    ``replayed``, ``dead_letter``, ``requeue_dead``) are published alike
    in both packages, tokens masked."""
    from tests.test_torch_traces import mask

    got = []
    for pkg, obs in ((REF, ref_obs), (PORT, port_obs)):
        pkg.reset_metrics()
        prev = obs.set_recorder(obs.TraceRecorder(256))
        try:
            _lease_steal_and_dead_letter(pkg, tmp_path / pkg.name)
            got.append([mask(t) for t in obs.get_recorder().recent(256)[::-1]
                        if t["name"].startswith("spill.")])
        finally:
            obs.set_recorder(prev)
    assert got[1] == got[0]
    assert {t["name"] for t in got[0]} == {
        "spill.shared.append", "spill.shared.replayed",
        "spill.shared.dead_letter", "spill.shared.requeue_dead"}


def _admission(pkg, home, monkeypatch):
    monkeypatch.setenv("PIO_INGEST_QUEUE_BUDGET", "2")
    st = stack(pkg, home)
    st.srv.start()
    try:
        obs = [http_post(st.srv.port, f"/batch/events.json?accessKey={KEY}",
                         [ev(i) for i in range(5)]),
               http_post(st.srv.port, f"/events.json?accessKey={KEY}",
                         ev(7))[:2],
               http_post(st.srv.port, f"/batch/events.json?accessKey={KEY}"
                         "&batchToken=adm", [ev(0), ev(1)]),
               st.srv._inflight,
               pkg.registry().get("pio_ingest_overload_total").value()]
        return obs, rows(pkg, st)
    finally:
        st.srv.stop()


def test_admission_budget_answers_429_with_retry_after(tmp_path,
                                                       monkeypatch):
    obs, got = compare(_admission, tmp_path, monkeypatch=monkeypatch)
    assert obs[0][:2] == (429, "5")
    assert "PIO_INGEST_QUEUE_BUDGET" in obs[0][2]["message"]
    assert obs[1][0] == 201 and obs[2][0] == 200 and len(got) == 3


# -- the spill journal --------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_journal_torn_tail_recovers_across_packages(tmp_path, writer,
                                                    reader):
    d = tmp_path / "sp"
    j = writer.spill.SpillJournal(d)
    for i in range(3):
        j.append([ev(i)], app_id=1, channel_id=None, token=f"t{i}",
                 tokens=[f"t{i}.0"])
    j.mark_replayed(j.peek(1))
    j.close()
    with open(d / "spill.jsonl", "a", encoding="utf-8") as f:
        f.write('{"token": "torn", "appId": 1, "eve')   # crash mid-append
    summaries = [pkg.spill.journal_summary(d) for pkg in (writer, reader)]
    assert summaries[1] == summaries[0]
    j2 = reader.spill.SpillJournal(d)
    assert j2.depth() == 2
    assert [r["token"] for r in j2.peek(10)] == ["t1", "t2"]
    assert j2.peek(10)[0]["tokens"] == ["t1.0"]
    j2.append([ev(5)], app_id=1, channel_id=None, token="t5")
    j2.mark_replayed(j2.peek(10))
    assert j2.depth() == 0
    j2.close()


def _poison_journal(pkg, home):
    """A permanent replay failure dead-letters THAT record and the rest
    drain; ``requeue_dead`` puts it back under its original token."""
    j = pkg.spill.SpillJournal(home / "sp")
    for i in range(4):
        j.append([ev(i)], app_id=1, channel_id=None, token=f"p{i}")
    done = []

    def insert(rec):
        if rec["token"] == "p1" and "fixed" not in done:
            raise ValueError("schema drift")
        if rec["token"] == "p3" and "up" not in done:
            raise ConnectionError("still down")
        done.append(rec["token"])

    w = pkg.spill.ReplayWorker(j, insert, wait=lambda ev_, t: ev_.wait())
    obs = [w.drain_once(), j.depth(), done[:]]
    done.append("up")
    obs.append((w.drain_once(), j.depth(),
                [r["token"] for r in j.dead_records()],
                pkg.spill.journal_summary(home / "sp")["deadEvents"]))
    done.append("fixed")
    obs.append((j.requeue_dead(), j.depth(), w.drain_once(), j.depth(),
                [t for t in done if t.startswith("p")]))
    j.close()
    return obs


def test_poison_record_dead_letters_and_requeues(tmp_path):
    obs = compare(_poison_journal, tmp_path)
    assert obs[0] == 2 and obs[-1][-1] == ["p0", "p2", "p3", "p1"]


# -- pio spill -----------------------------------------------------------------


def test_pio_spill_inspect_json_equals_the_reference(tmp_path, capsys,
                                                     monkeypatch):
    """A local journal (pending, replayed, dead-lettered records and a
    torn tail) and a shared sqlite queue, inspected by both CLIs."""
    home = tmp_path / "home"
    monkeypatch.setenv("PIO_HOME", str(home))
    ref_storage.reset_storage()
    port_storage.reset_storage()
    d = tmp_path / "journal"
    j = port_spill.SpillJournal(d)
    for i in range(4):
        j.append([ev(i), ev(i + 10)], app_id=1, channel_id=None,
                 token=f"j{i}")
    j.mark_replayed(j.peek(1))
    j.dead_letter(j.peek(1)[0], "ValueError: bad")
    j.close()
    with open(d / "spill.jsonl", "a") as f:
        f.write('{"tor')
    storage, app_id = open_store(PORT, home)
    q = port_shared.SharedSpillQueue(storage)
    for i in range(3):
        q.append([ev(i)], app_id, None, token=f"s{i}")
    q.lease("op", 1, 60)
    storage.close()

    def inspect(cli, *argv):
        assert cli.main(["spill", "inspect", *argv, "--json"]) == 0
        out = capsys.readouterr().out
        return out, json.loads(out.strip().splitlines()[-1])

    try:
        for argv in (["--dir", str(d)], ["--backend", "shared"]):
            (rout, rj), (pout, pj) = (inspect(ref_cli, *argv),
                                      inspect(port_cli, *argv))
            assert pj == rj and pout == rout
        assert rj["pending"] == 2 and rj["leased"] == 1
        # the port's CLI then drains the shared queue and requeues nothing
        assert port_cli.main(["spill", "requeue-dead", "--backend",
                              "shared"]) == 0
        assert "No dead-lettered records" in capsys.readouterr().out
        code = port_cli.main(["spill", "drain", "--backend", "shared"])
        out = capsys.readouterr().out
        assert code == 1 and "Replayed 2 event(s); 1 still pending" in out
    finally:
        ref_storage.reset_storage()
        port_storage.reset_storage()


def test_pio_spill_drain_lands_a_partially_landed_batch_once(tmp_path,
                                                             capsys,
                                                             monkeypatch):
    """The event server went away with a bulk record journaled after
    half of it committed: the port's `pio spill drain` replays it through
    ``create_batch`` under its per-item tokens, so each row lands once
    and keeps its token-derived id."""
    home = tmp_path / "home"
    monkeypatch.setenv("PIO_HOME", str(home))
    port_storage.reset_storage()
    try:
        storage, app_id = open_store(PORT, home)
        evs = [ev(i) for i in range(6)]
        tokens = [f"gone.{i}" for i in range(6)]
        storage.get_events().create_batch(
            [port_json.event_from_json(e) for e in evs[:3]], app_id,
            tokens=tokens[:3])
        storage.close()
        j = port_spill.SpillJournal(home / "spill")
        j.append(evs, app_id, None, token="gone", tokens=tokens)
        j.close()
        assert port_cli.main(["spill", "drain"]) == 0
        assert "Replayed 6 event(s); 0 still pending." in \
            capsys.readouterr().out
        got = [(e.event_id, e.entity_id) for e in
               port_storage.get_storage().get_events().find(app_id)]
        assert sorted(got) == [(f"btgone.{i}", f"u{i}") for i in range(6)]
    finally:
        port_storage.reset_storage()
