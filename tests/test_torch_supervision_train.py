"""Training supervision in the port against the reference.

The reference's ``tests/test_supervision.py`` scripts run on BOTH
packages (``pkg``) and must end the same way:

- the step watchdog on a fake clock: fires once (checkpoint flush
  before the abort), disarm prevents firing, disabled without
  ``PIO_STEP_TIMEOUT_S``, the ``PIO_STEP_TIMEOUT_KILL`` escalation fires
  once after the grace and stands down when the run unwinds;
- the divergence guard: finite values pass, two rollbacks, then
  ``TrainDiverged``, counted in ``pio_train_divergence_total``;
- the two-tower NaN scripts: a NaN injected once at step 5 (with
  checkpoints every 3 steps) rolls back and converges to the clean run;
  a loss that is always NaN raises ``TrainDiverged`` with no checkpoint
  directory; a NaN at slot 3 of a K=4 window rolls back to a finite
  window-boundary checkpoint and the result equals the clean K=1 run;
- SIGTERM sets the preemption flag; a preempted K=1 run resumed at K=4
  equals the uninterrupted run.

The port's results are held bit for bit against the port's own clean
run (the reference's against its own), the packages' two runs against
each other within the two-tower train tolerance of
``tests/test_torch_two_tower.py``.
"""

import os
import signal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import predictionio_tpu.models.two_tower as ref_tt
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.runtime as ref_runtime
import predictionio_tpu.resilience.supervision as ref_sup
import predictionio_tpu_torch.models.two_tower as port_tt
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.runtime as port_runtime
import predictionio_tpu_torch.resilience.supervision as port_sup

REF = SimpleNamespace(name="ref", sup=ref_sup, obs=ref_obs,
                      runtime=ref_runtime, tt=ref_tt)
PORT = SimpleNamespace(name="port", sup=port_sup, obs=port_obs,
                       runtime=port_runtime, tt=port_tt)


@pytest.fixture(params=(REF, PORT), ids=lambda p: p.name)
def pkg(request):
    request.param.sup.clear_preemption()
    yield request.param
    request.param.sup.clear_preemption()


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# -- the watchdog --------------------------------------------------------------

def test_watchdog_fires_once_with_metric_and_checkpoint(pkg):
    clock = FakeClock()
    tl = pkg.runtime.StepTimeline(capacity=8)
    tl.record("two_tower", host_wait_ms=1.0, device_step_ms=5.0, step=41)
    actions = []
    wd = pkg.sup.StepWatchdog("two_tower", timeout_s=30.0, clock=clock,
                              checkpoint_fn=lambda: actions.append("ckpt"),
                              abort_fn=lambda: actions.append("abort"),
                              poll_interval_s=0, timeline=tl)
    before = pkg.obs.get_registry().counter(
        "pio_watchdog_fired_total", "", ("fn",)).value(fn="two_tower")
    assert wd.enabled
    wd.arm(42)
    assert wd.poll() is False
    clock.t += 31.0
    assert wd.poll() is True
    assert actions == ["ckpt", "abort"] and wd.fired_steps == [42]
    assert wd.poll() is False
    assert pkg.obs.get_registry().counter(
        "pio_watchdog_fired_total", "", ("fn",)).value(
        fn="two_tower") == before + 1


def test_watchdog_disarm_and_disabled(pkg, monkeypatch):
    clock = FakeClock()
    fired = []
    wd = pkg.sup.StepWatchdog("x", timeout_s=10.0, clock=clock,
                              abort_fn=lambda: fired.append(1),
                              poll_interval_s=0)
    wd.arm(1)
    wd.disarm()
    clock.t += 1000.0
    assert wd.poll() is False and not fired
    monkeypatch.delenv("PIO_STEP_TIMEOUT_S", raising=False)
    off = pkg.sup.StepWatchdog("x", poll_interval_s=0)
    off.arm(1)
    assert not off.enabled and off.poll() is False


def test_kill_escalates_once_after_the_grace(pkg):
    clock = FakeClock()
    actions = []
    wd = pkg.sup.StepWatchdog("x", timeout_s=10.0, kill_grace_s=20.0,
                              clock=clock,
                              abort_fn=lambda: actions.append("abort"),
                              kill_fn=lambda: actions.append("KILL"),
                              poll_interval_s=0)
    wd.arm(5)
    clock.t += 11.0
    assert wd.poll() is True and actions == ["abort"]
    clock.t += 19.0
    assert wd.poll() is False
    clock.t += 2.0
    assert wd.poll() is True and actions == ["abort", "KILL"]
    assert wd.poll() is False


def test_kill_stands_down_when_run_unwinds(pkg):
    clock = FakeClock()
    actions = []
    wd = pkg.sup.StepWatchdog("x", timeout_s=10.0, kill_grace_s=20.0,
                              clock=clock,
                              abort_fn=lambda: actions.append("abort"),
                              kill_fn=lambda: actions.append("KILL"),
                              poll_interval_s=0)
    wd.arm(5)
    clock.t += 11.0
    assert wd.poll() is True
    wd.stop()
    clock.t += 1000.0
    assert wd.poll() is False and actions == ["abort"]


def test_kill_grace_reads_env(pkg, monkeypatch):
    monkeypatch.setenv("PIO_STEP_TIMEOUT_KILL", "45")
    assert pkg.sup.StepWatchdog("x", timeout_s=1.0,
                                poll_interval_s=0).kill_grace_s == 45.0
    monkeypatch.setenv("PIO_STEP_TIMEOUT_KILL", "nonsense")
    assert pkg.sup.StepWatchdog("x", timeout_s=1.0,
                                poll_interval_s=0).kill_grace_s == 0.0


def test_watchdog_aborts_a_hung_step_in_a_real_train(monkeypatch):
    """With PIO_STEP_TIMEOUT_S set, a step that hangs fires the poller
    thread's abort (KeyboardInterrupt in the main thread) and the train
    unwinds."""
    import time

    monkeypatch.setenv("PIO_STEP_TIMEOUT_S", "0.2")
    users, items = _data()
    real = port_tt.train_step
    calls = {"n": 0}

    def hang_at_3(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            time.sleep(5.0)
        return real(*a, **k)

    monkeypatch.setattr(port_tt, "train_step", hang_at_3)
    t0 = time.perf_counter()
    with pytest.raises(KeyboardInterrupt):
        port_tt.train(users, items, _cfg(port_tt), data_source="numpy",
                      device="cpu")
    assert time.perf_counter() - t0 < 5.0


# -- the divergence guard -------------------------------------------------------------

def test_guard_allows_finite_and_bounds_rollbacks(pkg):
    c = pkg.obs.get_registry().counter("pio_train_divergence_total", "",
                                       ("fn",))
    before = c.value(fn="tt")
    g = pkg.sup.DivergenceGuard("tt", max_rollbacks=2)
    g.check(0.5, 1)
    with pytest.raises(pkg.sup.RollbackRequested):
        g.check(float("nan"), 2)
    with pytest.raises(pkg.sup.RollbackRequested):
        g.check(float("inf"), 3)
    with pytest.raises(pkg.sup.TrainDiverged) as ei:
        g.check(float("nan"), 4)
    assert "rollback" in str(ei.value)
    assert c.value(fn="tt") == before + 3


def test_guard_retries_read_env(pkg, monkeypatch):
    monkeypatch.setenv("PIO_DIVERGENCE_RETRIES", "5")
    assert pkg.sup.DivergenceGuard("x").max_rollbacks == 5
    monkeypatch.setenv("PIO_DIVERGENCE_RETRIES", "x")
    assert pkg.sup.DivergenceGuard("x").max_rollbacks == 2


# -- the NaN scripts on a real two-tower train --------------------------------------

def _data():
    rng = np.random.default_rng(0)
    return rng.integers(0, 16, 200), rng.integers(0, 8, 200)


def _cfg(tt, **kw):
    base = dict(n_users=16, n_items=8, embed_dim=8, hidden_dims=(16,),
                out_dim=8, batch_size=32, epochs=2, seed=7)
    base.update(kw)
    return tt.TwoTowerConfig(**base)


def _train(pkg, *a, **kw):
    if pkg is PORT:
        kw["device"] = "cpu"
    return pkg.tt.train(*a, **kw)


def _embed(pkg, state):
    return np.asarray(state.params["user_embed"])


def _poisoned(pkg, s2, losses):
    """``s2`` with NaN params, and the NaN loss(es)."""
    if pkg is PORT:
        params = port_tt._map(lambda x: x * float("nan"), s2.params)
        return port_tt.TwoTowerState(params, s2.opt_state, s2.step), losses
    import jax
    import jax.numpy as jnp

    params = jax.tree.map(lambda x: x * jnp.nan, s2.params)
    return ref_tt.TwoTowerState(params, s2.opt_state, s2.step), losses


def _nan_like(pkg, losses):
    if pkg is PORT:
        return torch.full_like(losses, float("nan"))
    import jax.numpy as jnp

    return jnp.full_like(losses, jnp.nan)


def test_nan_injected_loss_rolls_back_and_converges(pkg, tmp_path,
                                                    monkeypatch):
    users, items = _data()
    cfg = _cfg(pkg.tt)
    clean = _train(pkg, users, items, cfg, data_source="numpy")
    real = pkg.tt.train_step
    seen = {"n": 0, "injected": False}

    def nan_once(state, u, i, w, c):
        s2, loss = real(state, u, i, w, c)
        seen["n"] += 1
        if seen["n"] == 5 and not seen["injected"]:
            seen["injected"] = True
            return _poisoned(pkg, s2, _nan_like(pkg, loss))
        return s2, loss

    monkeypatch.setattr(pkg.tt, "train_step", nan_once)
    out = _train(pkg, users, items, cfg, checkpoint_dir=tmp_path / "ck",
                 save_every=3, data_source="numpy")
    assert seen["injected"]
    got = _embed(pkg, out)
    assert np.isfinite(got).all()
    if pkg is PORT:     # a replay on the same ops: bit for bit
        np.testing.assert_array_equal(got, _embed(pkg, clean))
    else:
        np.testing.assert_allclose(got, _embed(pkg, clean), rtol=1e-5,
                                   atol=1e-6)


def test_persistent_divergence_raises_without_checkpoints(pkg,
                                                          monkeypatch):
    users, items = _data()
    real = pkg.tt.train_step

    def always_nan(state, u, i, w, c):
        s2, loss = real(state, u, i, w, c)
        return s2, _nan_like(pkg, loss)

    monkeypatch.setattr(pkg.tt, "train_step", always_nan)
    with pytest.raises(pkg.sup.TrainDiverged) as e:
        _train(pkg, users, items, _cfg(pkg.tt), data_source="numpy")
    assert e.value.step == 1 and e.value.rollbacks == 0


def test_nan_at_slot_k_rolls_back_to_a_window_boundary(pkg, tmp_path,
                                                        monkeypatch):
    users, items = _data()
    cfg = _cfg(pkg.tt, n_users=24, n_items=12, seed=5)
    clean = _train(pkg, users, items, cfg, data_source="numpy",
                   fuse_steps=1)
    real = pkg.tt.train_steps_fused
    seen = {"n": 0, "injected": False}

    def nan_at_slot(state, u, i, w, c):
        s2, losses = real(state, u, i, w, c)
        seen["n"] += 1
        if seen["n"] == 2 and not seen["injected"]:
            seen["injected"] = True
            if pkg is PORT:
                losses = losses.clone()
                losses[2] = float("nan")
            else:
                import jax.numpy as jnp

                losses = losses.at[2].set(jnp.nan)
            return _poisoned(pkg, s2, losses)
        return s2, losses

    monkeypatch.setattr(pkg.tt, "train_steps_fused", nan_at_slot)
    out = _train(pkg, users, items, cfg, checkpoint_dir=tmp_path / "ck",
                 save_every=4, data_source="numpy", fuse_steps=4)
    assert seen["injected"]
    np.testing.assert_array_equal(_embed(pkg, out), _embed(pkg, clean))


def test_sigterm_sets_the_preemption_flag(pkg):
    assert pkg.sup.install_preemption_handler()
    try:
        assert not pkg.sup.preemption_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert pkg.sup.preemption_requested()
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        pkg.sup.clear_preemption()
    assert pkg.sup.PREEMPTED_EXIT_CODE == 143


def test_preempted_k1_run_resumes_fused(pkg, monkeypatch, tmp_path):
    users, items = _data()
    cfg = _cfg(pkg.tt, n_users=24, n_items=12, seed=5)
    clean = _train(pkg, users, items, cfg, data_source="numpy",
                   fuse_steps=1)
    real = pkg.tt.train_step
    calls = {"n": 0}

    def preempt_at_5(*a):
        out = real(*a)
        calls["n"] += 1
        if calls["n"] == 5:
            pkg.sup.request_preemption()
        return out

    monkeypatch.setattr(pkg.tt, "train_step", preempt_at_5)
    with pytest.raises(pkg.sup.TrainPreempted) as e:
        _train(pkg, users, items, cfg, checkpoint_dir=tmp_path / "ck",
               save_every=1, data_source="numpy", fuse_steps=1)
    assert e.value.step == 5 and e.value.checkpointed
    pkg.sup.clear_preemption()
    monkeypatch.setattr(pkg.tt, "train_step", real)
    out = _train(pkg, users, items, cfg, checkpoint_dir=tmp_path / "ck",
                 save_every=1, data_source="numpy", fuse_steps=4)
    np.testing.assert_array_equal(_embed(pkg, out), _embed(pkg, clean))
    assert int(out.step) == int(clean.step)


def test_preemption_without_checkpoints_hands_back():
    users, items = _data()
    port_sup.request_preemption()
    try:
        with pytest.raises(port_sup.TrainPreempted) as e:
            port_tt.train(users, items, _cfg(port_tt), data_source="numpy",
                          device="cpu")
    finally:
        port_sup.clear_preemption()
    assert e.value.step == 1 and not e.value.checkpointed
