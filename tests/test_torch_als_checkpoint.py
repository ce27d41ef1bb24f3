"""ALS under supervision with sweep checkpoints: the port against itself
and against the JAX package on the CPU.

Port counterparts of ``tests/test_checkpoint_resume.py``'s ALS cases and
of the reference's supervision cases, on the same seeded COO:

- a checkpointed train that is never interrupted equals the plain train
  bit for bit; a train killed after two chunks resumes from the last
  complete sweep and equals the uninterrupted one bit for bit; a
  completed run clears its files; checkpoints of another config are
  discarded;
- a preemption (the SIGTERM flag) saves the current sweep and raises
  ``TrainPreempted``; the rerun equals the uninterrupted train;
- a non-finite chunk rolls back in place and the train ends equal to the
  clean one; non-finite chunks past ``PIO_DIVERGENCE_RETRIES`` raise
  ``TrainDiverged``;
- the watchdog is armed around each chunk, and around the whole loop
  without checkpoints;
- the port's resumed factors agree with the reference's uninterrupted
  ones within the sweep tolerance (atol 1e-4 + rtol 1e-3);
- ``pio train --checkpoint-dir D --checkpoint-every N`` through both
  CLIs: a SIGTERM during the read gives exit 143 and a PREEMPTED
  instance in both; the rerun completes and its factors equal an
  uninterrupted train's by entity id, bit for bit within the port, and
  their top-6 answers agree across the packages as the quickstart
  parity test's do; the flag-pair errors give equal exit codes and
  messages.
"""

import json
import os
import signal

import numpy as np
import pytest

from predictionio_tpu.models import als as jax_als
from tests.test_torch_cli import _agree
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.resilience import supervision as sup

ATOL, RTOL = 1e-4, 1e-3
N_USERS, N_ITEMS = 40, 30


def _coo(seed=3):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, 1200)
    items = (rng.zipf(1.4, 1200) % N_ITEMS).astype(np.int64)
    ratings = rng.integers(1, 6, 1200).astype(np.float32)
    return users, items, ratings


def _cfg(iterations=8, **kw):
    # split_above 64: Zipf items split, so the merged segment sums run.
    return als.ALSConfig(rank=8, iterations=iterations, reg=0.05, seed=4,
                         split_above=64, **kw)


def _train(cfg, **kw):
    return als.train_als(*_coo(), N_USERS, N_ITEMS, cfg, device="cpu", **kw)


def _equal(a, b):
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)


@pytest.fixture(autouse=True)
def _no_flag(monkeypatch):
    for k in ("PIO_STEP_TIMEOUT_S", "PIO_DIVERGENCE_RETRIES"):
        monkeypatch.delenv(k, raising=False)
    sup.clear_preemption()
    yield
    sup.clear_preemption()


def _split_chunks():
    inputs = als.prepare_als_inputs(*_coo(), N_USERS, N_ITEMS, _cfg(),
                                    device="cpu")
    return sum(c.kind == "merged" for c in inputs.item_buckets)


def test_the_data_splits_buckets():
    assert _split_chunks() >= 1


@pytest.mark.parametrize("save_every", [1, 2, 3])
def test_uninterrupted_checkpointing_equals_plain(tmp_path, save_every):
    cfg = _cfg(iterations=7)
    _equal(_train(cfg, checkpoint_dir=tmp_path / "als",
                  save_every=save_every), _train(cfg))


def _dying_loop(monkeypatch, after: int, exc=RuntimeError("injected")):
    """``als._train_loop`` that raises ``exc`` on its call ``after + 1``."""
    real = als._train_loop
    calls = {"n": 0}

    def loop(*a, **k):
        calls["n"] += 1
        if calls["n"] > after:
            raise exc
        return real(*a, **k)

    monkeypatch.setattr(als, "_train_loop", loop)
    return calls


def test_killed_train_resumes_bit_for_bit(tmp_path, monkeypatch):
    cfg = _cfg()
    expected = _train(cfg)
    ck = tmp_path / "als"
    _dying_loop(monkeypatch, after=2)   # dies after 2 chunks: 4 of 8 saved
    with pytest.raises(RuntimeError, match="injected"):
        _train(cfg, checkpoint_dir=ck, save_every=2)
    monkeypatch.undo()
    assert sorted(p.name for p in ck.glob("*.pt")) == ["2.pt", "4.pt"]
    resumed = _train(cfg, checkpoint_dir=ck, save_every=2)
    _equal(resumed, expected)


def test_completed_run_clears_checkpoints(tmp_path, monkeypatch):
    cfg = _cfg(iterations=6)
    ck = tmp_path / "als"
    calls = _dying_loop(monkeypatch, after=10 ** 6)
    _train(cfg, checkpoint_dir=ck, save_every=2)
    assert calls["n"] == 3
    assert list(ck.iterdir()) == []
    _train(cfg, checkpoint_dir=ck, save_every=2)   # fresh: all 3 chunks
    assert calls["n"] == 6


def test_fingerprint_mismatch_discards_stale_checkpoints(tmp_path,
                                                        monkeypatch):
    ck = tmp_path / "als"
    _dying_loop(monkeypatch, after=2)
    with pytest.raises(RuntimeError, match="injected"):
        _train(_cfg(), checkpoint_dir=ck, save_every=2)
    monkeypatch.undo()
    other = als.ALSConfig(rank=8, iterations=6, reg=0.2, seed=5,
                          split_above=64)
    _equal(_train(other, checkpoint_dir=ck, save_every=2), _train(other))


def test_preemption_saves_the_sweep_and_the_rerun_equals_uninterrupted(
        tmp_path, monkeypatch):
    cfg = _cfg(iterations=7)
    expected = _train(cfg)
    real = als._train_loop
    calls = {"n": 0}

    def loop(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            sup.request_preemption()      # SIGTERM after the 2nd chunk
        return out

    monkeypatch.setattr(als, "_train_loop", loop)
    ck = tmp_path / "als"
    with pytest.raises(sup.TrainPreempted) as e:
        _train(cfg, checkpoint_dir=ck, save_every=3)
    assert (e.value.fn, e.value.step, e.value.checkpointed) == \
        ("als", 6, True)
    assert "6.pt" in {p.name for p in ck.iterdir()}
    sup.clear_preemption()
    monkeypatch.undo()
    _equal(_train(cfg, checkpoint_dir=ck, save_every=3), expected)
    assert not list(ck.glob("*.pt"))


def _nan_loop(monkeypatch, bad_calls):
    """``als._train_loop`` whose calls numbered in ``bad_calls`` (from 1)
    return NaN user factors."""
    real = als._train_loop
    calls = {"n": 0}

    def loop(*a, **k):
        uf, itf = real(*a, **k)
        calls["n"] += 1
        if calls["n"] in bad_calls:
            uf = uf.clone()
            uf[0, 0] = float("nan")
        return uf, itf

    monkeypatch.setattr(als, "_train_loop", loop)
    return calls


def test_a_nan_chunk_rolls_back_and_ends_equal_to_the_clean_run(
        tmp_path, monkeypatch):
    from predictionio_tpu_torch.obs import get_registry

    cfg = _cfg()
    expected = _train(cfg)
    before = get_registry().counter(
        "pio_train_divergence_total", "", ("fn",)).value(fn="als")
    calls = _nan_loop(monkeypatch, bad_calls={3})
    got = _train(cfg, checkpoint_dir=tmp_path / "als", save_every=2)
    _equal(got, expected)
    assert calls["n"] == 5                 # 4 chunks + the replayed one
    assert get_registry().counter(
        "pio_train_divergence_total", "", ("fn",)).value(fn="als") \
        == before + 1


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_nan_past_the_retries_raises_train_diverged(tmp_path, monkeypatch,
                                                    pkg):
    """Every chunk non-finite: PIO_DIVERGENCE_RETRIES (1) rollbacks,
    then TrainDiverged, in both packages; nothing is left to resume
    past the last good sweep."""
    monkeypatch.setenv("PIO_DIVERGENCE_RETRIES", "1")
    if pkg == "port":
        _nan_loop(monkeypatch, bad_calls=set(range(1, 100)))
        with pytest.raises(sup.TrainDiverged, match="after 1 rollback"):
            _train(_cfg(), checkpoint_dir=tmp_path / "als", save_every=2)
        return
    from predictionio_tpu.resilience import supervision as jsup

    real = jax_als._train_loop

    def loop(*a, **k):
        uf, itf = real(*a, **k)
        return uf.at[0, 0].set(np.nan), itf

    monkeypatch.setattr(jax_als, "_train_loop", loop)
    with pytest.raises(jsup.TrainDiverged, match="after 1 rollback"):
        jax_als.train_als(*_coo(), N_USERS, N_ITEMS, jax_als.ALSConfig(
            rank=8, iterations=8, reg=0.05, seed=4, split_above=64),
            checkpoint_dir=tmp_path / "als", save_every=2)


class _Recorder:
    """A StepWatchdog stand-in that records its arms."""

    made = []

    def __init__(self, fn, **kw):
        self.fn, self.arms, self.stopped = fn, [], False
        _Recorder.made.append(self)

    def arm(self, step, scale=1):
        self.arms.append(step)

    def disarm(self):
        pass

    def stop(self):
        self.stopped = True


@pytest.mark.parametrize("save_every, arms", [(0, [7]), (2, [2, 4, 6, 7])])
def test_the_watchdog_is_armed_around_each_chunk(tmp_path, monkeypatch,
                                                 save_every, arms):
    _Recorder.made = []
    monkeypatch.setattr(als, "StepWatchdog", _Recorder)
    _train(_cfg(iterations=7), checkpoint_dir=tmp_path / "als",
           save_every=save_every)
    [wd] = _Recorder.made
    assert (wd.fn, wd.arms, wd.stopped) == ("als", arms, True)


def test_resumed_factors_agree_with_the_reference_uninterrupted(
        tmp_path, monkeypatch):
    cfg = _cfg()
    want = jax_als.train_als(*_coo(), N_USERS, N_ITEMS, jax_als.ALSConfig(
        rank=8, iterations=8, reg=0.05, seed=4, split_above=64))
    ck = tmp_path / "als"
    _dying_loop(monkeypatch, after=1)
    with pytest.raises(RuntimeError, match="injected"):
        _train(cfg, checkpoint_dir=ck, save_every=3)
    monkeypatch.undo()
    got = _train(cfg, checkpoint_dir=ck, save_every=3)
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


# -- pio train --checkpoint-dir, both CLIs ------------------------------------

REF_FACTORY = "predictionio_tpu.templates.recommendation:engine"
PORT_FACTORY = "predictionio_tpu_torch.templates.recommendation:engine"


def _cli(pkg):
    """(main, the template's engine module, supervision, get_storage,
    load_models, the factory, the extra train flags) of one package."""
    import importlib

    root = "predictionio_tpu" if pkg == "reference" else \
        "predictionio_tpu_torch"
    mod = importlib.import_module(f"{root}.templates.recommendation.engine")
    main = importlib.import_module(f"{root}.cli.main").main
    s = importlib.import_module(f"{root}.resilience.supervision")
    get_storage = importlib.import_module(f"{root}.data.storage").get_storage
    load_models = importlib.import_module(
        f"{root}.workflow.core_workflow").load_models
    if pkg == "reference":
        return main, mod, s, get_storage, load_models, REF_FACTORY, ()
    return main, mod, s, get_storage, load_models, PORT_FACTORY, \
        ("--device", "cpu")


@pytest.fixture()
def cli_home(tmp_path, monkeypatch):
    """A clean sqlite home per package; the variables either CLI sets in
    the process are set here first, so teardown restores them."""
    from tests.test_torch_cli import _clean_env

    for k in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    previous = signal.getsignal(signal.SIGTERM)
    yield lambda pkg: _clean_env(monkeypatch, tmp_path / pkg)
    signal.signal(signal.SIGTERM, previous)
    from predictionio_tpu.resilience import supervision as jsup
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu_torch.data.storage import reset_storage

    jsup.clear_preemption()
    sup.clear_preemption()
    jax_reset()
    reset_storage()


def _factors_by_id(models):
    w = models[0]
    uf = np.asarray(w.model.user_factors)
    itf = np.asarray(w.model.item_factors)
    return ({u: uf[i].tolist() for u, i in w.user_index.items()},
            {t: itf[i].tolist() for t, i in w.item_index.items()})


def _loop(pkg, home, tmp_path, monkeypatch, capsys):
    """app new → import → a train SIGTERM'd during its read (143) → the
    same train again → an uninterrupted train; returns (the first
    exit code, the statuses, the resumed and uninterrupted factors)."""
    from tests.test_torch_cli import _variant, _write_events

    main, mod, s, get_storage, load_models, factory, extra = _cli(pkg)
    home.mkdir()
    # The quickstart parity test's rank and iterations: the sweep
    # tolerance holds after 3 iterations (PERF.md §2).
    ej = _variant(home / "engine.json", factory=factory, rank=10,
                  numIterations=3)
    ck = home / "ck"
    assert main(["app", "new", "qsapp"]) == 0
    assert main(["import", "--appid", "1", "--input",
                 str(_write_events(tmp_path / f"ev_{pkg}.jsonl"))]) == 0
    real_read = mod.RecommendationDataSource.read_training

    def read_then_sigterm(self, ctx):
        os.kill(os.getpid(), signal.SIGTERM)   # lands during the read
        return real_read(self, ctx)

    monkeypatch.setattr(mod.RecommendationDataSource, "read_training",
                        read_then_sigterm)
    train = ["train", "--engine-json", str(ej), "--checkpoint-dir", str(ck),
             "--checkpoint-every", "2", *extra]
    code = main(train)
    monkeypatch.setattr(mod.RecommendationDataSource, "read_training",
                        real_read)
    s.clear_preemption()
    left = sorted(p.name for p in (ck / "als").iterdir())
    assert main(train) == 0
    for k in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY"):
        monkeypatch.delenv(k, raising=False)
    assert main(["train", "--engine-json", str(ej), *extra]) == 0
    storage = get_storage()
    insts = sorted(storage.get_engine_instances().get_all(),
                   key=lambda i: i.start_time)
    statuses = [i.status for i in insts]
    eng = mod.engine()
    if pkg == "port":
        from predictionio_tpu_torch.controller import RuntimeContext

        ctx = (RuntimeContext.create(storage=storage, device="cpu"),)
    else:
        ctx = ()
    resumed = _factors_by_id(load_models(eng, insts[1], *ctx))
    plain = _factors_by_id(load_models(eng, insts[2], *ctx))
    capsys.readouterr()
    return code, statuses, left, resumed, plain


def test_pio_train_sigterm_during_the_read_resumes_in_both_clis(
        cli_home, tmp_path, monkeypatch, capsys):
    out = {}
    for pkg in ("reference", "port"):
        cli_home(pkg)
        out[pkg] = _loop(pkg, tmp_path / pkg, tmp_path, monkeypatch, capsys)
    (jcode, jst, jleft, jres, jplain), (pcode, pst, pleft, pres, pplain) = \
        out.values()
    assert pcode == jcode == sup.PREEMPTED_EXIT_CODE == 143
    assert pst == jst == ["PREEMPTED", "COMPLETED", "COMPLETED"]
    assert "2.pt" in pleft and jleft        # the step-2 save, each format
    assert pres == pplain                   # bit for bit in the port
    # Across the packages: each user's top 6 by the factors, as the
    # quickstart parity test holds its answers.
    for user in jres[0]:
        answers = []
        for users, items in (pres, jres):
            names = sorted(items)
            scores = np.asarray([items[t] for t in names]) @ \
                np.asarray(users[user])
            top = np.argsort(-scores, kind="stable")[:6]
            answers.append({"itemScores": [
                {"item": names[j], "score": float(scores[j])} for j in top]})
        _agree(*answers)


@pytest.mark.parametrize("flags", [["--checkpoint-dir", "D"],
                                   ["--checkpoint-every", "2"],
                                   ["--checkpoint-dir", "D",
                                    "--checkpoint-every", "0"]])
def test_the_flag_pair_errors_equal_the_reference(cli_home, tmp_path,
                                                  capsys, flags):
    got = []
    for pkg in ("reference", "port"):
        cli_home(pkg)
        main, *_, extra = _cli(pkg)
        with pytest.raises(SystemExit) as e:
            main(["train", "--engine-json", str(tmp_path / "none.json"),
                  *flags, *extra])
        got.append((e.value.code, capsys.readouterr().err.strip()))
    assert got[0] == got[1] and got[0][0] == 1
    assert "--checkpoint-" in got[0][1]
    assert json.dumps(got[0][1]).startswith('"[error] --checkpoint-')


def test_pio_train_follow_exits_143_on_a_sigterm_during_an_als_cycle(
        cli_home, tmp_path, monkeypatch, capsys):
    """``pio train --follow`` with checkpoints: a SIGTERM during the
    cycle's read stops the ALS train after its first chunk, the verb
    exits 143 and the cycle's instance lands PREEMPTED, in both
    packages (the port finished the cycle and exited 0 before ALS had
    checkpoints)."""
    from tests.test_torch_cli import _variant, _write_events

    got = []
    for pkg in ("reference", "port"):
        cli_home(pkg)
        main, mod, s, get_storage, _, factory, extra = _cli(pkg)
        home = tmp_path / pkg
        home.mkdir()
        ej = _variant(home / "engine.json", factory=factory, rank=4,
                      numIterations=3)
        assert main(["app", "new", "qsapp"]) == 0
        assert main(["import", "--appid", "1", "--input",
                     str(_write_events(tmp_path / f"ev_{pkg}.jsonl"))]) == 0
        real_read = mod.RecommendationDataSource.read_training

        def read_then_sigterm(self, ctx):
            os.kill(os.getpid(), signal.SIGTERM)
            return real_read(self, ctx)

        monkeypatch.setattr(mod.RecommendationDataSource, "read_training",
                            read_then_sigterm)
        code = main(["train", "--engine-json", str(ej), "--checkpoint-dir",
                     str(home / "ck"), "--checkpoint-every", "1",
                     "--follow", "--refresh-interval", "600",
                     "--canary-window", "0", *extra])
        monkeypatch.setattr(mod.RecommendationDataSource, "read_training",
                            real_read)
        s.clear_preemption()
        got.append((code, [i.status for i in
                           get_storage().get_engine_instances().get_all()]))
        capsys.readouterr()
    assert got[1] == got[0] == (143, ["PREEMPTED"])
