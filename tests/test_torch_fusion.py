"""K-step fusion, its autotuner, the memory sampler, the step timeline
and the pipeline probe: the port against the reference.

The cases of the reference's ``tests/test_fused_steps.py`` (boundary
helpers, the env knobs, the HBM-guided autotuner with a scripted
sampler, the fused loss-vector check, the watchdog's deadline scaled by
K, the probe attributing one dispatch to K steps) and of
``tests/test_obs.py`` for the memory sampler (fake devices: gauges, the
run peak, the headroom warning and ``headroom_exceeded``) and the step
timeline (ring, shares, Chrome export) run on BOTH packages (``pkg``).
Port only: the sampler's CUDA kinds come from ``torch.cuda``, a process
that never touched CUDA samples no device, and the probe's sync is a
no-op wait for CPU outputs.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import predictionio_tpu.data.fusion as ref_fusion
import predictionio_tpu.obs.metrics as ref_metrics
import predictionio_tpu.obs.pipeline as ref_pipeline
import predictionio_tpu.obs.runtime as ref_runtime
import predictionio_tpu.resilience.supervision as ref_supervision
import predictionio_tpu_torch.data.fusion as port_fusion
import predictionio_tpu_torch.obs.metrics as port_metrics
import predictionio_tpu_torch.obs.pipeline as port_pipeline
import predictionio_tpu_torch.obs.runtime as port_runtime
import predictionio_tpu_torch.resilience.supervision as port_supervision

REF = SimpleNamespace(name="ref", fusion=ref_fusion, metrics=ref_metrics,
                      pipeline=ref_pipeline, runtime=ref_runtime,
                      supervision=ref_supervision)
PORT = SimpleNamespace(name="port", fusion=port_fusion,
                       metrics=port_metrics, pipeline=port_pipeline,
                       runtime=port_runtime, supervision=port_supervision)


@pytest.fixture(params=(REF, PORT), ids=lambda p: p.name)
def pkg(request):
    return request.param


# -- boundary helpers and knobs ---------------------------------------------------

def test_crossed_save_point(pkg):
    f = pkg.fusion.crossed_save_point
    for step in range(1, 20):
        assert f(step, 1, 5) == (step % 5 == 0)
    assert f(8, 4, 6) and not f(4, 4, 6) and f(12, 4, 6)
    assert not f(16, 4, 6) and not f(8, 4, 0)


def test_slot_steps(pkg):
    assert pkg.fusion.slot_steps(
        SimpleNamespace(step=12, steps=4, k=4)) == [9, 10, 11, 12]
    assert pkg.fusion.slot_steps(
        SimpleNamespace(step=16, steps=8, k=2)) == [12, 16]


def test_fuse_steps_config(pkg, monkeypatch):
    f = pkg.fusion.fuse_steps_config
    monkeypatch.delenv("PIO_FUSE_STEPS", raising=False)
    assert f() == (1, False)
    for raw, want in (("8", (8, False)), ("auto", (1, True)),
                      ("junk", (1, False)), ("0", (1, False))):
        monkeypatch.setenv("PIO_FUSE_STEPS", raw)
        assert f() == want
    assert f(4) == (4, False) and f("auto") == (1, True)


def test_env_knobs(pkg, monkeypatch):
    monkeypatch.delenv("PIO_BATCH_AUTOSCALE", raising=False)
    assert not pkg.fusion.batch_autoscale_enabled()
    monkeypatch.setenv("PIO_BATCH_AUTOSCALE", "on")
    assert pkg.fusion.batch_autoscale_enabled()
    monkeypatch.setenv("PIO_FUSE_STEPS_MAX", "5")
    assert pkg.fusion.fuse_steps_max() == 5
    monkeypatch.setenv("PIO_FUSE_STEPS_MAX", "x")
    assert pkg.fusion.fuse_steps_max() == 32


def test_plan_window_batches(pkg):
    plan = pkg.fusion.FusionPlan(4, 2)
    assert plan.get() == (4, 2) and plan.window_batches == 8
    plan.set(fuse_steps=0)
    assert plan.get() == (1, 2)


# -- the autotuner -----------------------------------------------------------------

class _ScriptedSampler:
    def __init__(self, verdicts):
        self.verdicts = list(verdicts)

    def headroom_exceeded(self):
        return self.verdicts.pop(0) if self.verdicts else False


def _tuner(pkg, plan, verdicts, **kw):
    kw.setdefault("round_windows", 1)
    return pkg.fusion.FusionAutotuner(
        "toy", plan, sampler=_ScriptedSampler(verdicts),
        registry=pkg.metrics.MetricsRegistry(), **kw)


def test_autotune_grows_then_backs_off_and_pins(pkg):
    plan = pkg.fusion.FusionPlan(1)
    tuner = _tuner(pkg, plan, [False, False, True], max_fuse_steps=32)
    seen = []
    for _ in range(4):
        tuner.on_window()
        seen.append(plan.get())
    assert seen == [(2, 1), (4, 1), (2, 1), (2, 1)] and tuner.pinned


def test_autotune_caps_at_max(pkg):
    plan = pkg.fusion.FusionPlan(1)
    tuner = _tuner(pkg, plan, [], max_fuse_steps=4, batch_scale=False)
    for _ in range(5):
        tuner.on_window()
    assert plan.get() == (4, 1) and tuner.pinned


def test_autotune_batch_scale_after_fuse_cap(pkg):
    plan = pkg.fusion.FusionPlan(1)
    tuner = _tuner(pkg, plan, [], max_fuse_steps=2, batch_scale=True,
                   max_batch_scale=4)
    seen = []
    for _ in range(4):
        tuner.on_window()
        seen.append(plan.get())
    assert seen == [(2, 1), (2, 2), (2, 4), (2, 4)] and tuner.pinned


def test_autotune_backoff_unwinds_batch_scale_first(pkg):
    plan = pkg.fusion.FusionPlan(4, 2)
    tuner = _tuner(pkg, plan, [True], max_fuse_steps=4, batch_scale=True)
    tuner.on_window()
    assert plan.get() == (4, 1) and tuner.pinned


def test_autotune_round_cadence_and_gauges(pkg):
    plan = pkg.fusion.FusionPlan(1)
    tuner = _tuner(pkg, plan, [False], round_windows=3)
    tuner.on_window()
    tuner.on_window()
    assert plan.get() == (1, 1)
    tuner.on_window()
    assert plan.get() == (2, 1)
    g = tuner._registry.get("pio_train_fuse_steps")
    assert g.value(model="toy") == 2


# -- supervision at the window boundary -------------------------------------------

def test_nan_slot_attributes_the_right_step(pkg):
    sup = pkg.supervision
    guard = sup.DivergenceGuard("toy", max_rollbacks=1,
                                registry=pkg.metrics.MetricsRegistry())
    guard.check_vector([1.0, 2.0, 3.0, 4.0], [5, 6, 7, 8])
    with pytest.raises(sup.RollbackRequested) as e:
        guard.check_vector([1.0, float("nan"), 3.0, float("nan")],
                           [5, 6, 7, 8])
    assert e.value.step == 6
    assert "slot 2/4" in e.value.what


def test_scalar_loss_still_works(pkg):
    sup = pkg.supervision
    guard = sup.DivergenceGuard("toy", max_rollbacks=0,
                                registry=pkg.metrics.MetricsRegistry())
    guard.check_vector(np.float32(1.5), [3])
    with pytest.raises(sup.TrainDiverged):
        guard.check_vector(np.float32("nan"), [3])


def test_loss_vector_as_a_tensor():
    guard = port_supervision.DivergenceGuard(
        "toy", max_rollbacks=0, registry=port_metrics.MetricsRegistry())
    guard.check_vector(torch.tensor([1.0, 2.0]), [1, 2])
    with pytest.raises(port_supervision.TrainDiverged) as e:
        guard.check_vector(torch.tensor([1.0, float("inf")]), [1, 2])
    assert e.value.step == 2


def test_deadline_scales_with_fused_steps(pkg):
    t = [0.0]
    fired = []
    wd = pkg.supervision.StepWatchdog(
        "toy", timeout_s=10.0, clock=lambda: t[0],
        abort_fn=lambda: fired.append(True), poll_interval_s=0,
        registry=pkg.metrics.MetricsRegistry())
    wd.arm(1, scale=4)
    t[0] = 35.0
    assert not wd.poll() and not fired
    t[0] = 41.0
    assert wd.poll() and fired


# -- the probe --------------------------------------------------------------------

def test_probe_attributes_dispatch_wall_to_k_steps(pkg):
    reg = pkg.metrics.MetricsRegistry()
    tl = pkg.runtime.StepTimeline(capacity=64)
    probe = pkg.pipeline.PipelineProbe("toy", registry=reg, timeline=tl)
    for _ in probe.iter_host(iter([1, 2])):
        probe.sync()
        probe.dispatched(np.zeros(2), examples=8, steps=4)
    probe.finish()
    s = tl.summary("toy")
    assert (s["dispatches"], s["steps"], s["fuse_steps"]) == (2, 8, 4.0)
    assert reg.get("pio_train_steps_total").value(model="toy") == 8
    assert reg.get("pio_train_examples_total").value(model="toy") == 16
    assert reg.get("pio_train_device_wait_ms").count(model="toy") == 2


def test_probe_feeds_timeline_per_step(pkg):
    reg = pkg.metrics.MetricsRegistry()
    tl = pkg.runtime.StepTimeline(capacity=16)
    probe = pkg.pipeline.PipelineProbe("toy", registry=reg, timeline=tl)
    for b in probe.iter_host(iter([([1, 2],), ([3],)])):
        with probe.h2d():
            pass
        probe.sync()
        probe.dispatched({"x": 1}, examples=len(b[0]))
    probe.finish()
    steps = tl.recent(10, model="toy")
    assert [r["step"] for r in steps] == [2, 1]
    assert [r["examples"] for r in steps] == [1, 2]
    for r in steps:
        for k in ("hostWaitMs", "h2dMs", "deviceWaitMs", "deviceStepMs"):
            assert r[k] >= 0


def test_probe_sync_target_walks_dataclasses_and_dicts():
    """The port's sync finds the tensors inside a model state (a plain
    dataclass holding dicts); CPU tensors record no CUDA event, so the
    wait returns at once."""
    from predictionio_tpu_torch.models.two_tower import TwoTowerState

    state = TwoTowerState(params={"a": torch.ones(2)},
                          opt_state=(torch.zeros(1),), step=3)
    flat = port_pipeline._sync_target((state, torch.ones(1)))
    leaves = []

    def walk(x):
        if isinstance(x, list):
            for y in x:
                walk(y)
        else:
            leaves.append(x)

    walk(flat)
    assert sum(isinstance(x, torch.Tensor) for x in leaves) == 3
    mark = port_pipeline._DispatchMark((state, torch.ones(1)))
    assert mark.events == []
    mark.wait()


# -- the memory sampler ------------------------------------------------------------

class _FakeDevice:
    def __init__(self, platform, id, stats):
        self.platform = platform
        self.id = id
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _sampler(pkg, devices, **kw):
    if pkg is REF:
        kw["live_arrays_fn"] = lambda: []
    return pkg.runtime.DeviceMemorySampler(
        interval_s=0, registry=pkg.metrics.MetricsRegistry(),
        devices_fn=lambda: devices, **kw)


def test_sampler_gauges_and_run_peak(pkg):
    stats = {"bytes_in_use": 1000, "peak_bytes_in_use": 1500,
             "bytes_limit": 4000}
    s = _sampler(pkg, [_FakeDevice("gpu", 0, stats)])
    assert s.sample_once()["gpu:0"]["bytes_in_use"] == 1000
    g = s._reg().get("pio_device_mem_bytes")
    peak = s._reg().get("pio_device_mem_peak_bytes")
    assert g.value(device="gpu:0", kind="bytes_limit") == 4000
    assert peak.value(device="gpu:0") == 1000
    stats["bytes_in_use"] = 200
    s.sample_once()
    assert peak.value(device="gpu:0") == 1000
    s.reset_peak()
    s.sample_once()
    assert peak.value(device="gpu:0") == 200


def test_sampler_statless_device(pkg):
    """A device whose allocator reports nothing: the reference sums its
    live arrays (none here); the port has no such walk.  Neither can
    push back on headroom."""
    s = _sampler(pkg, [_FakeDevice("cpu", 0, None)])
    assert s.sample_once() == {}
    assert s.headroom_exceeded(fraction=1e-9) is False


def test_sampler_headroom_warning_and_latched_peak(pkg, caplog):
    stats = {"bytes_in_use": 950, "bytes_limit": 1000}
    s = _sampler(pkg, [_FakeDevice("gpu", 0, stats)])
    with caplog.at_level("WARNING"):
        s.sample_once()
        s.sample_once()
    warns = [r for r in caplog.records if "HBM headroom" in r.message]
    assert len(warns) == 1 and "PIO_PREFETCH_DEPTH" in warns[0].message
    stats["bytes_in_use"] = 100          # the trough between windows
    assert s.headroom_exceeded() is True
    s.reset_peak()
    assert s.headroom_exceeded() is False
    assert s.headroom_exceeded(fraction=0.05) is True


def test_sampler_quiet_failures(pkg):
    def boom():
        raise RuntimeError("gone")

    s = _sampler(pkg, [])
    s._devices_fn = boom
    assert s.sample_once() == {} and s.start() is False


def test_sampler_reads_cuda_kinds(monkeypatch):
    """A CUDA device's kinds come from the caching allocator and the
    card's totals; the default device list is empty until CUDA is
    initialised in the process."""
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": 700,
        "allocated_bytes.all.peak": 900,
        "reserved_bytes.all.current": 1024})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (300, 1000))
    s = _sampler(PORT, [torch.device("cuda", 0)])
    row = s.sample_once()["cuda:0"]
    assert row == {"bytes_in_use": 700.0, "peak_bytes_in_use": 900.0,
                   "bytes_reserved": 1024.0, "bytes_free": 300.0,
                   "bytes_limit": 1000.0}
    assert s.headroom_exceeded(fraction=0.5) is True
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert port_runtime._default_devices() == ()


# -- the step timeline ---------------------------------------------------------------

def test_timeline_ring_and_shares(pkg):
    tl = pkg.runtime.StepTimeline(capacity=3)
    for i in range(5):
        tl.record("m", host_wait_ms=10, h2d_ms=30, device_wait_ms=60,
                  device_step_ms=70, examples=8, start_s=1000.0 + i)
    s = tl.summary("m")
    assert len(tl.recent(10)) == 3 and s["examples"] == 24
    assert abs(s["phase_share"]["device_wait"] - 0.6) < 1e-6
    assert "device_step" not in s["phase_share"]


def test_timeline_chrome_export(pkg):
    tl = pkg.runtime.StepTimeline(capacity=8)
    tl.record("m", host_wait_ms=1.0, h2d_overlap_ms=4.0, device_wait_ms=3.0,
              device_step_ms=9.0, start_s=100.0, dispatch_s=100.005,
              staged_s=99.999, examples=8)
    doc = tl.to_chrome_trace()
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert xs["device_step"]["ts"] == pytest.approx(100.005e6)
    assert xs["h2d_overlap"]["tid"] == 2
    assert xs["h2d_overlap"]["ts"] + xs["h2d_overlap"]["dur"] == \
        pytest.approx(99.999e6)
    json.dumps(doc)


def test_timeline_swap(pkg):
    prev = pkg.runtime.set_timeline(pkg.runtime.StepTimeline(capacity=4))
    try:
        pkg.runtime.get_timeline().record("x", host_wait_ms=1)
        assert pkg.runtime.get_timeline().models() == ["x"]
    finally:
        pkg.runtime.set_timeline(prev)
