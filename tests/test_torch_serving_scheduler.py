"""The serving scheduler of the port against the reference's.

``predictionio_tpu_torch.serving`` (admission queue, micro-batcher, p99
autotuner, the ``ServingScheduler`` facade) is held against
``predictionio_tpu.serving`` on the CPU:

- every case of the reference's ``tests/test_serving_scheduler.py``
  whose substrate the port has runs on BOTH packages (``pkg``): the
  deadline-aware window under a fake clock with zero wall sleeps,
  generation atomicity, admission, the inline path and the autotuner;
- one scripted arrival sequence under a fake clock goes through both
  packages' queue, batcher and autotuner: the cohorts (sizes and members,
  in order), the ``QueueFull`` points, the shed reasons, the autotuner's
  window and batch size after every step and the shutdown's
  ``SchedulerClosed`` answers are equal;
- the generation hand-back: the generation a dispatch returned is
  stamped on each member's latency waterfall, as in the reference, and
  ``submit_and_wait`` hands back the result alone — on the batcher, the
  inline path and a per-member retry;
- coalescing is shown by holding the first dispatch on a
  ``threading.Event`` until the other requests are queued, never by
  timing.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.resilience.deadline as ref_deadline
import predictionio_tpu.serving as ref_serving
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.resilience.deadline as port_deadline
import predictionio_tpu_torch.serving as port_serving
from predictionio_tpu_torch.obs.waterfall import Waterfall, begin_request

REF = SimpleNamespace(
    name="ref", s=ref_serving, deadline=ref_deadline,
    registry=ref_obs.get_registry, reset=ref_obs.reset_observability,
    submit=lambda sched, m, q: sched.submit_and_wait(m, q))
PORT = SimpleNamespace(
    name="port", s=port_serving, deadline=port_deadline,
    registry=port_obs.get_registry, reset=port_obs.reset_observability,
    submit=lambda sched, m, q: sched.submit_and_wait(m, q))
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_registries():
    for p in PKGS:
        p.reset()
    yield
    for p in PKGS:
        p.reset()


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


class FakeClock:
    """now() is a dial; wait() advances it by the timeout and reports
    'no arrival' — a gather window passes with zero wall time."""

    def __init__(self, t=0.0):
        self.t = t
        self.waits = []

    def now(self):
        return self.t

    def wait(self, cond, timeout):
        self.waits.append(timeout)
        if timeout is not None:
            self.t += timeout
        return False


class FakeEngine:
    """Records each dispatch (queries, generation at snapshot); the
    generation is snapshotted once per call under a lock, as the engine
    server's ``_dispatch_batch`` does, and ``swap_mid_dispatch``
    simulates a reload landing while the batch is in flight."""

    def __init__(self):
        self.generation = 1
        self.calls = []
        self.swap_mid_dispatch = False
        self._lock = threading.Lock()

    def dispatch(self, queries):
        with self._lock:
            gen = self.generation
            if self.swap_mid_dispatch:
                self.generation += 1
        self.calls.append((list(queries), gen))
        return [(q, gen) for q in queries], gen


def _batcher(pkg, engine=None, clock=None, depth=16, window_s=0.010,
             max_size=8, autotuner=None):
    engine = engine or FakeEngine()
    clock = clock or FakeClock()
    q = pkg.s.ModelQueue("m", depth)
    b = pkg.s.MicroBatcher("m", q, engine.dispatch, window_s=window_s,
                           max_size=max_size, clock=clock,
                           autotuner=autotuner)
    return engine, clock, q, b


# -- the reference's cases, on both packages -----------------------------------

def test_window_closes_early_under_deadline_pressure(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.010)
    b._est_dispatch_s = 0.004
    tight = pkg.s.Pending("tight", clock.now(), deadline_s=0.006)
    loose = pkg.s.Pending("loose", clock.now(), deadline_s=None)
    q.put(tight)
    q.put(loose)
    batch = b.gather()
    assert {e.query for e in batch} == {"tight", "loose"}
    assert clock.t == pytest.approx(0.002)   # deadline - est, not 10 ms
    assert b.dispatch(batch) == 2
    assert len(engine.calls) == 1
    assert tight.result == ("tight", 1) and tight.error is None


def test_no_deadline_runs_the_full_window(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.010)
    q.put(pkg.s.Pending("a", clock.now()))
    assert len(b.gather()) == 1
    assert clock.t == pytest.approx(0.010)


def test_full_batch_skips_the_window(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.010, max_size=3)
    for i in range(3):
        q.put(pkg.s.Pending(i, clock.now()))
    assert len(b.gather()) == 3
    assert clock.t == 0.0


def test_lone_client_stream_stops_paying_the_window(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.010)
    for _ in range(2):
        q.put(pkg.s.Pending("s", clock.now()))
        t0 = clock.t
        b.gather()
        assert clock.t == pytest.approx(t0 + 0.010)
    q.put(pkg.s.Pending("s", clock.now()))
    t0 = clock.t
    assert len(b.gather()) == 1
    assert clock.t == t0
    q.put(pkg.s.Pending("a", clock.now()))
    q.put(pkg.s.Pending("b", clock.now()))
    assert len(b.gather()) == 2
    q.put(pkg.s.Pending("s", clock.now()))
    t0 = clock.t
    b.gather()
    assert clock.t == pytest.approx(t0 + 0.010)


def test_zero_window_still_coalesces_the_backlog(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.0, max_size=8)
    for i in range(5):
        q.put(pkg.s.Pending(i, clock.now()))
    assert len(b.gather()) == 5
    assert clock.t == 0.0


def test_expired_entries_shed_before_device_work(pkg):
    engine, clock, q, b = _batcher(pkg)
    clock.t = 1.0
    dead = pkg.s.Pending("dead", 0.0, deadline_s=0.5)
    live = pkg.s.Pending("live", 0.9, deadline_s=None)
    b.dispatch([dead, live])
    assert isinstance(dead.error, pkg.deadline.DeadlineExceeded)
    assert live.result == ("live", 1)
    assert engine.calls == [(["live"], 1)]
    shed = pkg.registry().get("pio_queue_shed_total")
    assert shed.value(model="m", reason="expired") == 1


def test_abandoned_entries_dropped_silently(pkg):
    engine, clock, q, b = _batcher(pkg)
    gone = pkg.s.Pending("gone", 0.0)
    assert gone.abandon()
    b.dispatch([gone])
    assert engine.calls == []


def test_failed_singleton_is_not_dispatched_twice(pkg):
    calls = []

    def boom(queries):
        calls.append(list(queries))
        raise ValueError("kaput")

    b = pkg.s.MicroBatcher("m", pkg.s.ModelQueue("m", 4), boom,
                           clock=FakeClock())
    solo = pkg.s.Pending("q", 0.0)
    b.dispatch([solo])
    assert isinstance(solo.error, ValueError)
    assert len(calls) == 1


def test_batch_error_isolates_per_member(pkg):
    calls = []

    def picky(queries):
        calls.append(list(queries))
        if "bad" in queries:
            raise ValueError("cannot bind 'bad'")
        return [q.upper() for q in queries], 3

    b = pkg.s.MicroBatcher("m", pkg.s.ModelQueue("m", 8), picky,
                           clock=FakeClock())
    good, bad = pkg.s.Pending("ok", 0.0), pkg.s.Pending("bad", 0.0)
    b.dispatch([good, bad])
    assert good.result == "OK"
    assert isinstance(bad.error, ValueError)
    assert len(calls) == 3


def test_batch_never_spans_a_mid_flight_swap(pkg):
    engine, clock, q, b = _batcher(pkg)
    engine.swap_mid_dispatch = True
    first = [pkg.s.Pending(f"a{i}", 0.0) for i in range(4)]
    b.dispatch(first)
    assert {e.result[1] for e in first} == {1}
    second = [pkg.s.Pending(f"b{i}", 0.0) for i in range(4)]
    b.dispatch(second)
    assert {e.result[1] for e in second} == {2}
    assert [g for _, g in engine.calls] == [1, 2]


def test_concurrent_reloads_never_split_any_batch(pkg):
    engine = FakeEngine()
    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        window_ms=2.0, max_batch=8, queue_depth=64, autotune=False))
    sched.register("m", engine.dispatch)
    stop = threading.Event()

    def reloader():
        while not stop.is_set():
            with engine._lock:
                engine.generation += 1
            time.sleep(0.0005)

    results, res_lock = [], threading.Lock()

    def submitter(base):
        for i in range(16):
            r = pkg.submit(sched, "m", f"{base}-{i}")
            with res_lock:
                results.append(r)

    rt = threading.Thread(target=reloader)
    rt.start()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        stop.set()
        rt.join()
        sched.close()
    assert len(results) == 64
    for queries, gen in engine.calls:
        assert {g for rq, g in results if rq in queries} == {gen}


def test_queue_full_rejects(pkg):
    q = pkg.s.ModelQueue("m", 2)
    q.put(pkg.s.Pending("a", 0.0))
    q.put(pkg.s.Pending("b", 0.0))
    with pytest.raises(pkg.s.QueueFull):
        q.put(pkg.s.Pending("c", 0.0))


def test_abandoned_corpses_free_admission_slots(pkg):
    q = pkg.s.ModelQueue("m", 2)
    dead1, dead2 = pkg.s.Pending("d1", 0.0), pkg.s.Pending("d2", 0.0)
    q.put(dead1)
    q.put(dead2)
    assert dead1.abandon() and dead2.abandon()
    q.put(pkg.s.Pending("live", 0.0))
    assert len(q) == 1


def test_batch_retry_sheds_expired_members(pkg):
    clock = FakeClock()
    calls = []

    def flaky(queries):
        calls.append(list(queries))
        if len(calls) == 1:
            clock.t = 1.0   # the failed attempt burns doomed's budget
            raise ConnectionError("backend blip")
        return [q.upper() for q in queries], 1

    b = pkg.s.MicroBatcher("m", pkg.s.ModelQueue("m", 8), flaky,
                           clock=clock)
    doomed = pkg.s.Pending("dead", 0.0, deadline_s=0.5)
    alive = pkg.s.Pending("ok", 0.0, deadline_s=None)
    clock.t = 0.3
    b.dispatch([doomed, alive])
    assert isinstance(doomed.error, pkg.deadline.DeadlineExceeded)
    assert alive.result == "OK"
    assert calls == [["dead", "ok"], ["ok"]]


def test_per_model_isolation(pkg):
    qa, qb = pkg.s.ModelQueue("a", 1), pkg.s.ModelQueue("b", 1)
    qa.put(pkg.s.Pending("x", 0.0))
    with pytest.raises(pkg.s.QueueFull):
        qa.put(pkg.s.Pending("y", 0.0))
    qb.put(pkg.s.Pending("z", 0.0))
    assert len(qb) == 1


def test_scheduler_per_model_isolation_end_to_end(pkg):
    engine = FakeEngine()
    full = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        enabled=False, queue_depth=0))
    full.register("full", engine.dispatch)
    open_ = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        enabled=False, queue_depth=4))
    open_.register("open", engine.dispatch)
    with pytest.raises(pkg.s.QueueFull):
        pkg.submit(full, "full", "q")
    assert pkg.submit(open_, "open", "q") == ("q", 1)


def test_inline_mode_dispatches_and_counts(pkg):
    engine = FakeEngine()
    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        enabled=False, queue_depth=4))
    sched.register("m", engine.dispatch)
    assert pkg.submit(sched, "m", "q1") == ("q1", 1)
    snap = sched.snapshot()["m"]
    assert snap["batching"] is False
    assert snap["requests"] == 1 and snap["dispatches"] == 1
    sched.close()


def test_inline_expired_deadline_sheds_504(pkg):
    engine = FakeEngine()
    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        enabled=False, queue_depth=4))
    sched.register("m", engine.dispatch)
    with pkg.deadline.deadline_scope(0):
        with pytest.raises(pkg.deadline.DeadlineExceeded):
            pkg.submit(sched, "m", "q")
    assert engine.calls == []
    sched.close()


def test_closed_scheduler_rejects(pkg):
    engine = FakeEngine()
    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(enabled=False))
    sched.register("m", engine.dispatch)
    sched.close()
    with pytest.raises(pkg.s.SchedulerClosed):
        pkg.submit(sched, "m", "q")


def test_config_from_env(pkg, monkeypatch):
    monkeypatch.setenv("PIO_BATCH_ENABLED", "off")
    monkeypatch.setenv("PIO_QUEUE_DEPTH", "7")
    monkeypatch.setenv("PIO_BATCH_WINDOW_MS", "3.5")
    monkeypatch.setenv("PIO_BATCH_MAX", "bogus")
    cfg = pkg.s.SchedulerConfig.from_env()
    assert (cfg.enabled, cfg.queue_depth, cfg.window_ms,
            cfg.max_batch) == (False, 7, 3.5, 64)
    assert pkg.s.SchedulerConfig.from_env(queue_depth=9).queue_depth == 9


def test_config_from_env_equal_across_packages(monkeypatch):
    env = {"PIO_BATCH_ENABLED": "1", "PIO_QUEUE_DEPTH": "12",
           "PIO_BATCH_WINDOW_MS": "0.5", "PIO_BATCH_WINDOW_MAX_MS": "7",
           "PIO_BATCH_MAX": "32", "PIO_BATCH_AUTOTUNE": "no",
           "PIO_BATCH_P99_TARGET_MS": "40", "PIO_QUEUE_WAIT_MAX_S": "x"}
    for overrides in ({}, {"max_batch": 8, "enabled": False,
                           "window_ms": None}):
        got = port_serving.SchedulerConfig.from_env(env, **overrides)
        want = ref_serving.SchedulerConfig.from_env(env, **overrides)
        assert vars(got) == vars(want)


def _tuner_pair(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.004, max_size=8)
    return b, pkg.s.WindowAutotuner("m", 100.0, window_max_s=0.020,
                                    max_size_cap=64)


def test_over_target_shrinks_window_then_batch(pkg):
    b, tuner = _tuner_pair(pkg)
    tuner.retune(b, p99_ms=400.0)
    assert b.window_s == pytest.approx(0.002)
    tuner.retune(b, p99_ms=400.0)
    assert b.window_s == pytest.approx(0.001)
    for _ in range(8):
        tuner.retune(b, p99_ms=400.0)
        if b.window_s == 0.0:
            break
    assert b.window_s == 0.0
    b._est_dispatch_s = 0.050
    tuner.retune(b, p99_ms=400.0)
    assert b.max_size == 4


def test_backlog_latency_never_shrinks_the_batch(pkg):
    b, tuner = _tuner_pair(pkg)
    b.set_knobs(window_s=0.0)
    b._est_dispatch_s = 0.003
    tuner.retune(b, p99_ms=400.0)
    assert b.max_size == 8
    acts = pkg.registry().get("pio_batch_autotune_total")
    assert acts.value(model="m", action="floor") == 1


def test_under_target_grows_batch_then_window(pkg):
    b, tuner = _tuner_pair(pkg)
    tuner.retune(b, p99_ms=10.0)
    assert b.max_size == 16
    b.set_knobs(max_size=64)
    w0 = b.window_s
    tuner.retune(b, p99_ms=10.0)
    assert b.window_s > w0


def test_hysteresis_band_holds(pkg):
    b, tuner = _tuner_pair(pkg)
    w0, m0 = b.window_s, b.max_size
    tuner.retune(b, p99_ms=80.0)
    assert (b.window_s, b.max_size) == (w0, m0)
    acts = pkg.registry().get("pio_batch_autotune_total")
    assert acts.value(model="m", action="hold") == 1


def test_after_dispatch_retunes_on_interval(pkg):
    engine, clock, q, b = _batcher(pkg, window_s=0.004)
    tuner = pkg.s.WindowAutotuner("m", 100.0, interval=4)
    b.autotuner = tuner
    for _ in range(400):
        tuner.observe(500.0)
    for _ in range(4):
        tuner.after_dispatch(b)
    assert b.window_s < 0.004
    assert tuner.last_p99_ms == pytest.approx(500.0)


def test_saturation_after_a_streak_of_floors(pkg):
    b, tuner = _tuner_pair(pkg)
    b.set_knobs(window_s=0.0)
    b._est_dispatch_s = 0.001
    for k in range(3):
        assert not tuner.saturated()
        tuner.retune(b, p99_ms=400.0)
    assert tuner.saturated()
    assert pkg.registry().get("pio_batch_saturated").value(model="m") == 1
    tuner.retune(b, p99_ms=10.0)
    assert not tuner.saturated()


# -- one scripted sequence through both packages --------------------------------

def _scripted_run(pkg):
    """A fixed arrival script under a fake clock: bursts, deadlines that
    expire in the queue, a full queue, then a latency history that walks
    the autotuner down and up.  Returns everything observable, step by
    step."""
    clock = FakeClock()
    gens = iter(range(1, 1000))
    dispatched = []

    def dispatch(queries):
        g = next(gens)
        dispatched.append((list(queries), g))
        clock.t += 0.003 * len(queries)      # the dispatch's own cost
        return [f"{q}@{g}" for q in queries], g

    queue = pkg.s.ModelQueue("m", 6)
    tuner = pkg.s.WindowAutotuner("m", 50.0, window_max_s=0.010,
                                  window_step_s=0.001, max_size_cap=8,
                                  interval=2)
    b = pkg.s.MicroBatcher("m", queue, dispatch, window_s=0.004,
                           max_size=4, clock=clock, autotuner=tuner)
    log = []
    # (arrivals: [(query, budget_s or None)], clock advance before them)
    script = [
        ([("a", None)], 0.0),
        ([("b", None), ("c", None), ("d", None)], 0.001),
        ([("e", 0.001), ("f", None), ("g", 0.5), ("h", None), ("i", None),
          ("j", None), ("k", None), ("l", None)], 0.0),
        ([("m", None)], 0.02),
        ([("n", 0.0001), ("o", None)], 0.0),
        ([("p", None), ("q", None), ("r", None), ("s", None), ("t", None)],
         0.5),
    ]
    for arrivals, advance in script:
        clock.t += advance
        pendings = []
        for name, budget in arrivals:
            p = pkg.s.Pending(name, clock.t,
                              None if budget is None else clock.t + budget)
            try:
                queue.put(p)
                pendings.append(p)
            except pkg.s.QueueFull:
                log.append(("full", name))
        clock.t += 0.002      # the queue sits while earlier work runs
        while len(queue):
            batch = b.gather()
            b.dispatch(batch)
            log.append(("cohort", [e.query for e in batch],
                        round(b.window_s, 9), b.max_size))
        for p in pendings:
            log.append(("done", p.query, p.result,
                        type(p.error).__name__ if p.error else None))
    for p99 in (400.0, 400.0, 400.0, 10.0, 10.0, 10.0, 40.0, 400.0):
        tuner.retune(b, p99_ms=p99)
        log.append(("tune", p99, round(b.window_s, 9), b.max_size,
                    tuner.saturated()))
    # shutdown: what is still queued fails SchedulerClosed (503), and a
    # later admission is refused the same way
    left = [pkg.s.Pending(f"late{i}", clock.t) for i in range(2)]
    for p in left:
        queue.put(p)
    b.close()
    try:
        queue.put(pkg.s.Pending("after", clock.t))
    except pkg.s.SchedulerClosed:
        log.append(("closed", "after"))
    log.append(("drained", [(p.query, type(p.error).__name__)
                            for p in left]))
    shed = pkg.registry().get("pio_queue_shed_total")
    log.append(("shed", {k: v for k, v in shed.series().items() if v}))
    log.append(("dispatched", dispatched))
    return log


def test_scripted_sequence_is_equal_across_packages():
    ref = _scripted_run(REF)
    port = _scripted_run(PORT)
    assert port == ref
    kinds = {entry[0] for entry in ref}
    assert {"full", "cohort", "done", "tune", "shed", "closed"} <= kinds
    assert any(e[0] == "done" and e[3] == "DeadlineExceeded" for e in ref)
    assert any(e[0] == "cohort" and len(e[1]) > 1 for e in ref)


# -- the generation hand-back: on each member's waterfall ----------------------

def test_pending_carries_the_dispatch_generation():
    engine, clock, q, b = _batcher(PORT)
    engine.generation = 7
    members = [port_serving.Pending(f"u{i}", 0.0, waterfall=Waterfall())
               for i in range(3)]
    b.dispatch(members)
    assert [(m.result, m.waterfall.attr("generation")) for m in members] \
        == [((f"u{i}", 7), 7) for i in range(3)]
    assert all({"queue_wait", "batch_wait", "dispatch"}
               <= set(m.waterfall.snapshot()) for m in members)


def test_retried_members_carry_their_own_generation():
    gen = iter((5, 6, 7))

    def flaky(queries):
        g = next(gen)
        if g == 5:
            raise ConnectionError("blip")
        return [q.upper() for q in queries], g

    b = port_serving.MicroBatcher("m", port_serving.ModelQueue("m", 4),
                                  flaky, clock=FakeClock())
    a, c = (port_serving.Pending(x, 0.0, waterfall=Waterfall())
            for x in "ac")
    b.dispatch([a, c])
    assert (a.result, a.waterfall.attr("generation")) == ("A", 6)
    assert (c.result, c.waterfall.attr("generation")) == ("C", 7)
    # the failed cohort attempt and the retry both bill "dispatch"
    assert a.waterfall.attr("isolated") is True


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["batcher", "inline"])
def test_submit_and_wait_hands_back_the_generation(enabled):
    engine = FakeEngine()
    engine.generation = 42
    sched = port_serving.ServingScheduler(port_serving.SchedulerConfig(
        enabled=enabled, autotune=False, window_ms=0.0))
    sched.register("m", engine.dispatch)
    try:
        with begin_request() as wf:
            assert sched.submit_and_wait("m", "q") == ("q", 42)
        assert wf.attr("generation") == 42
    finally:
        sched.close()


def test_a_failed_dispatch_hands_back_no_generation():
    def boom(queries):
        raise ValueError("kaput")

    sched = port_serving.ServingScheduler(port_serving.SchedulerConfig(
        enabled=False))
    sched.register("m", boom)
    with pytest.raises(ValueError):
        sched.submit_and_wait("m", "q")


# -- coalescing, gated (no timing) ----------------------------------------------

@pytest.mark.parametrize("n", [8, 33])
def test_gated_requests_coalesce_into_one_dispatch(pkg, n):
    """The first dispatch is held until the other ``n - 1`` requests are
    queued; they then leave in one cohort (the backlog scoop), so the
    scheduler counts 2 dispatches for ``n`` requests."""
    gate = threading.Event()
    calls = []

    def dispatch(queries):
        calls.append(list(queries))
        if len(calls) == 1:
            assert gate.wait(30)
        return [q * 2 for q in queries], 3

    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        window_ms=0.0, max_batch=64, queue_depth=64, autotune=False))
    sched.register("m", dispatch)
    lane_queue = sched._lanes["m"].queue
    out = {}

    def one(i):
        out[i] = pkg.submit(sched, "m", i)

    threads = [threading.Thread(target=one, args=(0,))]
    threads[0].start()
    deadline = time.monotonic() + 30
    while not calls and time.monotonic() < deadline:
        time.sleep(0.001)
    threads += [threading.Thread(target=one, args=(i,)) for i in range(1, n)]
    for t in threads[1:]:
        t.start()
    while len(lane_queue) < n - 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(30)
    sched.close()
    assert out == {i: i * 2 for i in range(n)}
    assert [len(c) for c in calls] == [1, n - 1]
    snap = sched.snapshot()["m"]
    assert (snap["dispatches"], snap["requests"]) == (2, n)
    assert snap["meanBatch"] == round(n / 2, 2)


def test_full_queue_under_a_held_dispatch_rejects_429(pkg):
    """Depth 2 with the first dispatch held: two more requests queue, the
    third is rejected at admission and counted."""
    gate = threading.Event()
    started = threading.Event()

    def dispatch(queries):
        started.set()
        assert gate.wait(30)
        return list(queries), 1

    sched = pkg.s.ServingScheduler(pkg.s.SchedulerConfig(
        window_ms=0.0, queue_depth=2, autotune=False))
    sched.register("m", dispatch)
    threads = [threading.Thread(target=pkg.submit, args=(sched, "m", 0))]
    threads[0].start()
    assert started.wait(30)
    threads += [threading.Thread(target=pkg.submit, args=(sched, "m", i))
                for i in (1, 2)]
    for t in threads[1:]:
        t.start()
    queue = sched._lanes["m"].queue
    deadline = time.monotonic() + 30
    while len(queue) < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    with pytest.raises(pkg.s.QueueFull):
        pkg.submit(sched, "m", 3)
    gate.set()
    for t in threads:
        t.join(30)
    assert sched.snapshot()["m"]["rejected"] == 1
    sched.close()


def test_snapshot_keys_equal_across_packages():
    snaps = []
    for p in PKGS:
        sched = p.s.ServingScheduler(p.s.SchedulerConfig(enabled=False))
        sched.register("default", FakeEngine().dispatch)
        p.submit(sched, "default", "q")
        snaps.append(sched.snapshot())
        sched.close()
    assert snaps[0] == snaps[1]
