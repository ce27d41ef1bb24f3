"""The port's overlapped input pipeline against the reference's.

``predictionio_tpu_torch.data.prefetch.DevicePrefetcher`` is the
reference's prefetcher with a PyTorch transfer.  The cases of the
reference's ``tests/test_prefetch.py`` and the superbatch-staging cases
of ``tests/test_fused_steps.py`` run on BOTH packages (``pkg``) with
injected put/clock fakes, so each outcome is held to the reference's:
ordering and step numbers, bounded-depth backpressure, ``skip_steps``
resume spending no prep, exceptions from the source, the prep and the
put reaching the consumer, close on the supervision exceptions, tail
padding, window stacking, batch-scale concatenation, mid-window resume,
tail flush, live retargeting, and the reusable staging pool.  Port only:
the CPU put (``torch.from_numpy``, zero-copy), the default put onto a
named device, ``PIO_PINNED_STAGING=auto`` reading the device, and the
two-tower train's staged batches equal to the inline prep bit for bit.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import predictionio_tpu.data.fusion as ref_fusion
import predictionio_tpu.data.prefetch as ref_prefetch
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.metrics as ref_metrics
import predictionio_tpu.resilience.supervision as ref_supervision
import predictionio_tpu_torch.data.fusion as port_fusion
import predictionio_tpu_torch.data.prefetch as port_prefetch
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.metrics as port_metrics
import predictionio_tpu_torch.resilience.supervision as port_supervision

REF = SimpleNamespace(name="ref", prefetch=ref_prefetch, fusion=ref_fusion,
                      metrics=ref_metrics, obs=ref_obs,
                      supervision=ref_supervision)
PORT = SimpleNamespace(name="port", prefetch=port_prefetch,
                       fusion=port_fusion, metrics=port_metrics,
                       obs=port_obs, supervision=port_supervision)


@pytest.fixture(params=(REF, PORT), ids=lambda p: p.name)
def pkg(request):
    return request.param


def _identity(x):
    return x


class _RecordingSource:
    """Iterator that records pulls and whether close() ran."""

    def __init__(self, batches):
        self._batches = list(batches)
        self._i = 0
        self.pulled = 0
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._batches):
            raise StopIteration
        self.pulled += 1
        b = self._batches[self._i]
        self._i += 1
        return b

    def close(self):
        self.closed = True


def _batches(n, size=4):
    return [(np.full(size, k, np.int64),) for k in range(1, n + 1)]


def _pf(pkg, *args, **kw):
    kw.setdefault("put_fn", _identity)
    return pkg.prefetch.DevicePrefetcher(*args, **kw)


# -- the prefetcher ------------------------------------------------------------

def test_ordering_and_step_numbers(pkg):
    src = _RecordingSource(_batches(5))
    with _pf(pkg, src, lambda b: b[0] * 2, depth=2) as pf:
        seen = list(pf)
    assert [b.step for b in seen] == [1, 2, 3, 4, 5]
    for k, b in enumerate(seen, start=1):
        assert np.array_equal(b.args, np.full(4, 2 * k))
        assert b.examples == 4
    assert src.closed


def test_bounded_depth_backpressure(pkg):
    src = _RecordingSource(_batches(50))
    pf = _pf(pkg, src, _identity, depth=2)
    try:
        deadline = time.time() + 5.0
        while src.pulled < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert src.pulled == 3  # depth (2) + 1 blocked on the full queue
        next(iter(pf))
        deadline = time.time() + 5.0
        while src.pulled < 4 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert src.pulled == 4
    finally:
        pf.close()


def test_skip_steps_spends_no_prep_work(pkg):
    prepped = []

    def prep(b):
        prepped.append(int(b[0][0]))
        return b

    src = _RecordingSource(_batches(5))
    with _pf(pkg, src, prep, depth=2, skip_steps=3) as pf:
        steps = [b.step for b in pf]
    assert steps == [4, 5] and prepped == [4, 5] and src.pulled == 5


def test_prep_exception_propagates_to_consumer(pkg):
    def prep(b):
        if int(b[0][0]) == 3:
            raise ValueError("bad batch")
        return b

    src = _RecordingSource(_batches(5))
    seen = []
    with pytest.raises(ValueError, match="bad batch"):
        with _pf(pkg, src, prep, depth=2) as pf:
            for batch in pf:
                seen.append(batch.step)
    assert seen == [1, 2] and src.closed


def test_source_exception_propagates(pkg):
    def bad_source():
        yield (np.ones(2),)
        raise RuntimeError("feeder died")

    with pytest.raises(RuntimeError, match="feeder died"):
        with _pf(pkg, bad_source(), _identity) as pf:
            for _ in pf:
                pass


def test_put_exception_propagates(pkg):
    def put(arrays):
        raise MemoryError("HBM full")

    with pytest.raises(MemoryError):
        with _pf(pkg, iter(_batches(2)), _identity, put_fn=put) as pf:
            for _ in pf:
                pass


@pytest.mark.parametrize("exc_name", ["TrainPreempted", "TrainDiverged"])
def test_shutdown_on_supervision_exceptions(pkg, exc_name):
    sup = pkg.supervision
    exc = sup.TrainPreempted("m", 1, True) if exc_name == "TrainPreempted" \
        else sup.TrainDiverged("m", 1, "loss=nan", 0)
    src = _RecordingSource(_batches(50))
    pf = _pf(pkg, src, _identity, depth=2)
    with pytest.raises(type(exc)):
        with pf:
            for _ in pf:
                raise exc  # mid-stream abort, queue still full
    assert not pf._thread.is_alive() and src.closed
    assert list(pf) == []


def test_close_is_idempotent_and_unblocks_producer(pkg):
    src = _RecordingSource(_batches(100))
    pf = _pf(pkg, src, _identity, depth=1)
    deadline = time.time() + 5.0
    while src.pulled < 2 and time.time() < deadline:
        time.sleep(0.01)
    pf.close()
    pf.close()
    assert not pf._thread.is_alive()


def test_tail_batch_padding_and_examples(pkg):
    bs = 8

    def prep(b):
        (x,) = b
        return np.concatenate([x, np.zeros(bs - len(x), x.dtype)])

    src = iter([(np.arange(8, dtype=np.int64),),
                (np.arange(3, dtype=np.int64),)])
    with _pf(pkg, src, prep) as pf:
        got = list(pf)
    assert [b.examples for b in got] == [8, 3]
    assert np.array_equal(got[1].args, np.concatenate(
        [np.arange(3), np.zeros(5, np.int64)]))


def test_h2d_ms_uses_injected_clock(pkg):
    t = [0.0]

    def prep(b):
        t[0] += 0.25
        return b

    with _pf(pkg, iter(_batches(1)), prep, clock=lambda: t[0]) as pf:
        (batch,) = list(pf)
    assert batch.h2d_ms == pytest.approx(250.0)


def test_depth_env_parsing(pkg, monkeypatch):
    depth = pkg.prefetch.prefetch_depth
    for raw, want in (("4", 4), ("0", 1), ("not-a-number", 2)):
        monkeypatch.setenv("PIO_PREFETCH_DEPTH", raw)
        assert depth() == want
    monkeypatch.delenv("PIO_PREFETCH_DEPTH")
    assert depth() == 2


def test_prefetched_loop_overlaps_staging(pkg):
    def prep(b):
        time.sleep(0.05)
        return b

    with _pf(pkg, iter(_batches(4)), prep, depth=2) as pf:
        it = iter(pf)
        next(it)
        t0 = time.perf_counter()
        time.sleep(0.12)            # the "device step" of batch 1
        next(it)                    # batch 2 is already staged
        waited = time.perf_counter() - t0 - 0.12
    assert waited < 0.04


def test_queue_depth_gauge_counts_real_batches_only(pkg):
    reg = pkg.metrics.MetricsRegistry()
    with _pf(pkg, _RecordingSource(_batches(3)), _identity, depth=2,
             model="toy", registry=reg) as pf:
        g = reg.get("pio_prefetch_queue_depth")
        seen = 0
        for _ in pf:
            seen += 1
            assert 0 <= g.value(model="toy") <= 2
    assert seen == 3 and g.value(model="toy") == 0


# -- superbatch staging (the fused-window cases) --------------------------------

def _steps(got):
    return [(b.step, b.steps, b.k) for b in got]


def test_stacks_k_batches_with_leading_axis(pkg):
    with _pf(pkg, iter(_batches(8)), _identity, fuse_steps=4) as pf:
        got = list(pf)
    assert _steps(got) == [(4, 4, 4), (8, 4, 4)]
    assert got[0].args[0].shape == (4, 4)
    assert np.array_equal(got[0].args[0][:, 0], [1, 2, 3, 4])
    assert got[0].examples == 16


def test_fused_put_fn_receives_the_superbatch(pkg):
    seen = {"fused": 0, "single": 0}

    def put(arrays):
        seen["single"] += 1
        return arrays

    def fused_put(arrays):
        seen["fused"] += 1
        return arrays

    with _pf(pkg, iter(_batches(9)), _identity, put_fn=put,
             fused_put_fn=fused_put, fuse_steps=4) as pf:
        got = list(pf)
    assert seen == {"fused": 2, "single": 1}
    assert [(b.steps, b.k) for b in got] == [(4, 4), (4, 4), (1, 1)]


def test_batch_scale_concatenates_per_slot(pkg):
    with _pf(pkg, iter(_batches(8)), _identity, fuse_steps=2,
             batch_scale=2) as pf:
        got = list(pf)
    assert _steps(got) == [(4, 4, 2), (8, 4, 2)]
    assert np.array_equal(got[0].args[0][0], [1, 1, 1, 1, 2, 2, 2, 2])
    assert np.array_equal(got[0].args[0][1], [3, 3, 3, 3, 4, 4, 4, 4])


def test_mid_window_resume_replays_remainder_unfused(pkg):
    with _pf(pkg, iter(_batches(12)), _identity, fuse_steps=4,
             skip_steps=5) as pf:
        got = list(pf)
    assert _steps(got) == [(6, 1, 1), (7, 1, 1), (8, 1, 1), (12, 4, 4)]


def test_tail_flush_emits_base_shapes(pkg):
    with _pf(pkg, iter(_batches(6)), _identity, fuse_steps=4) as pf:
        got = list(pf)
    assert _steps(got) == [(4, 4, 4), (5, 1, 1), (6, 1, 1)]


def test_live_plan_retarget_applies_at_next_window(pkg):
    plan = pkg.fusion.FusionPlan(1)
    out = []
    with _pf(pkg, iter(_batches(12)), _identity, fuse_plan=plan,
             depth=1) as pf:
        for b in pf:
            out.append((b.step, b.steps, b.k))
            if b.step == 2:
                plan.set(fuse_steps=4)
    assert any(k == 4 for (_, _, k) in out)
    assert sum(s for (_, s, _) in out) == 12 and out[-1][0] == 12


# -- the staging pool -----------------------------------------------------------

def test_pool_aligned_and_rotates_after_slots(pkg):
    pool = pkg.prefetch.StagingPool(3)
    bufs = [pool.take((4, 8), np.float32) for _ in range(3)]
    assert all(b.ctypes.data % 4096 == 0 for b in bufs)
    assert pool.allocated == 3 and pool.reused == 0
    again = [pool.take((4, 8), np.float32) for _ in range(3)]
    assert [id(b) for b in again] == [id(b) for b in bufs]
    assert pool.reused == 3
    assert id(pool.take((2, 8), np.float32)) not in {id(b) for b in bufs}


def test_pool_tagged_leaves_do_not_share_rings(pkg):
    pool = pkg.prefetch.StagingPool(2)
    a = pool.take((4,), np.int64, tag=0)
    b = pool.take((4,), np.int64, tag=1)
    assert id(a) != id(b)
    pool.take((4,), np.int64, tag=0)
    assert id(pool.take((4,), np.int64, tag=0)) == id(a)


def test_pooled_concat_handles_unequal_rows(pkg):
    pool = pkg.prefetch.StagingPool(2)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = pkg.prefetch._pooled_concat([a, b], pool)
    np.testing.assert_array_equal(out, np.concatenate([a, b]))
    assert out.ctypes.data % 4096 == 0


def test_superbatch_parity_and_reuse(pkg):
    raw = _batches(15, size=4)
    leaf_ids, contents = [], []
    with _pf(pkg, iter(raw), _identity, depth=1, fuse_steps=3,
             pin_buffers=True) as pf:
        for batch in pf:
            leaf_ids.append(id(batch.args[0]))
            contents.append(np.array(batch.args[0]))
    for w, got in enumerate(contents):
        np.testing.assert_array_equal(
            got, np.stack([raw[w * 3 + j][0] for j in range(3)]))
    assert leaf_ids[3] == leaf_ids[0] and len(set(leaf_ids[:3])) == 3


def test_env_on_engages_and_counter_counts(pkg, monkeypatch):
    monkeypatch.setenv("PIO_PINNED_STAGING", "on")
    c = pkg.obs.get_registry().counter(
        "pio_prefetch_pinned_reuse_total", "", ("model",))
    before = c.value(model="pin-toy")
    with _pf(pkg, iter(_batches(15)), _identity, depth=1, fuse_steps=3,
             model="pin-toy") as pf:
        list(pf)
    assert pf._pin is True
    assert c.value(model="pin-toy") - before == 2


def test_env_off_wins(pkg, monkeypatch):
    monkeypatch.setenv("PIO_PINNED_STAGING", "off")
    with _pf(pkg, iter(_batches(9)), _identity, depth=1,
             fuse_steps=3) as pf:
        list(pf)
    assert pf._pin is False


# -- port only: the PyTorch transfer ----------------------------------------------

def test_auto_gate_reads_the_device(monkeypatch):
    """auto pools when the device is CUDA: a CPU device (or a caller's
    put with no device named) stages fresh arrays every window."""
    monkeypatch.delenv("PIO_PINNED_STAGING", raising=False)
    for kw in ({"device": "cpu"}, {"put_fn": _identity}):
        ids = []
        with port_prefetch.DevicePrefetcher(
                iter(_batches(9)), _identity, depth=1, fuse_steps=3,
                **kw) as pf:
            for batch in pf:
                ids.append(id(batch.args[0]))
        assert pf._pin is False and len(set(ids)) == 3


def test_cpu_put_is_zero_copy_torch():
    a = np.arange(6, dtype=np.int32)
    b = np.ones(3, np.float32)
    out = port_prefetch.device_put((a, b), torch.device("cpu"))
    assert isinstance(out, tuple) and out[0].dtype == torch.int32
    assert out[0].data_ptr() == a.ctypes.data       # no copy
    assert torch.equal(out[1], torch.ones(3))
    single = port_prefetch.device_put(a, "cpu")
    assert torch.equal(single, torch.from_numpy(a))


def test_default_put_onto_a_named_device():
    with port_prefetch.DevicePrefetcher(
            iter([(np.arange(4, dtype=np.int32),)]), _identity,
            device="cpu") as pf:
        (batch,) = list(pf)
    assert isinstance(batch.args[0], torch.Tensor)
    assert torch.equal(batch.args[0], torch.arange(4, dtype=torch.int32))


def test_default_put_without_cuda_raises():
    """No named device means the card: without CUDA the prefetcher
    refuses instead of staging on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_prefetch.DevicePrefetcher(iter([]), _identity)


def test_two_tower_staged_batches_equal_inline_prep():
    """The prefetched train is a scheduling change only: the loop's
    staged batches (int32 ids, float32 weights, weight-0 tail padding)
    and its final state equal an inline loop over the same order."""
    from predictionio_tpu_torch.models import two_tower as tt

    rng = np.random.default_rng(7)
    n = 100
    users, items = rng.integers(0, 24, n), rng.integers(0, 12, n)
    cfg = tt.TwoTowerConfig(n_users=24, n_items=12, embed_dim=8,
                            hidden_dims=(16,), out_dim=8, batch_size=32,
                            epochs=2, seed=5)
    state = tt.init_state(cfg, device="cpu")
    inline = []
    for epoch in range(cfg.epochs):
        order = np.random.default_rng(cfg.seed + epoch).permutation(n)
        for start in range(0, n, cfg.batch_size):
            sel = order[start:start + cfg.batch_size]
            pad = cfg.batch_size - len(sel)
            u = np.concatenate([users[sel], np.zeros(pad, np.int64)])
            i = np.concatenate([items[sel], np.zeros(pad, np.int64)])
            w = np.concatenate([np.ones(len(sel), np.float32),
                                np.zeros(pad, np.float32)])
            args = (torch.from_numpy(u.astype(np.int32)),
                    torch.from_numpy(i.astype(np.int32)),
                    torch.from_numpy(w))
            inline.append(args)
            state, _ = tt.train_step(state, *args, cfg)
    staged = []
    real = tt.train_step

    def recording(s, u, i, w, c):
        staged.append((u, i, w))
        return real(s, u, i, w, c)

    tt.train_step = recording
    try:
        out = tt.train(users, items, cfg, data_source="numpy",
                       device="cpu", fuse_steps=1)
    finally:
        tt.train_step = real
    assert len(staged) == len(inline)
    for got, want in zip(staged, inline):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    for a, b in zip(tt._leaves(state.params), tt._leaves(out.params)):
        assert torch.equal(a, b)
    assert out.step == state.step


def test_prefetch_thread_closes_the_source_on_its_own_thread():
    """The source generator's cleanup runs on the prep thread (temp dirs
    and native feeders belong to it)."""
    where = []

    def source():
        try:
            yield (np.ones(2),)
            yield (np.ones(2),)
        finally:
            where.append(threading.current_thread().name)

    with port_prefetch.DevicePrefetcher(source(), _identity,
                                        put_fn=_identity,
                                        model="toy") as pf:
        next(iter(pf))
    assert where == ["pio-prefetch-toy"]
