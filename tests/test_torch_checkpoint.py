"""The port's training checkpoints (``workflow/checkpoint.py``).

The port stores each step with ``torch.save`` to a temporary name and
``os.replace`` (the reference uses orbax; neither package reads the
other's checkpoints).  The lifecycle is the reference's: the
fingerprint file and the purge of stale steps, ``restore_step`` /
``restored_state``, ``maybe_save`` on the cadence, ``save`` off it
(never rewriting a step), ``keep``, ``flush``, ``complete`` (clears)
and ``close``.  End to end, in the port only: a two-tower train killed
mid-epoch and resumed over the same directory equals an uninterrupted
one bit for bit; checkpointing changes nothing; a completed run leaves
no checkpoint behind; a warm continuation's checkpoints do not resume
another base generation's run.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models import two_tower as tt
from predictionio_tpu_torch.workflow.checkpoint import TrainCheckpointer


def _state(v: float):
    return ({"w": torch.full((3, 2), v), "layers": [{"b": torch.ones(2)}]},
            (tt.AdamState(count=4, mu={"w": torch.zeros(2)},
                          nu={"w": torch.ones(2)}), tt.EmptyState()),
            7)


def test_disabled_does_nothing(tmp_path):
    ck = TrainCheckpointer(tmp_path / "ck", save_every=0, fingerprint="a")
    assert not ck.enabled
    assert ck.restore_step(_state(0.0)) == 0
    assert ck.maybe_save(5, _state(1.0)) is False
    ck.save(5, _state(1.0))
    ck.complete()
    assert not (tmp_path / "ck").exists()


def test_save_restore_round_trip_and_cadence(tmp_path):
    d = tmp_path / "ck"
    ck = TrainCheckpointer(d, save_every=2, fingerprint="fp")
    assert (d / "fingerprint.txt").read_text() == "fp"
    assert ck.maybe_save(3, _state(3.0)) is False
    assert ck.maybe_save(4, _state(4.0)) is True
    ck.save(5, _state(5.0))
    ck.save(5, _state(99.0))           # a step on disk is not rewritten
    ck.flush()
    ck.close()
    assert sorted(p.name for p in d.iterdir()) == [
        "4.pt", "5.pt", "fingerprint.txt"]
    again = TrainCheckpointer(d, save_every=2, fingerprint="fp")
    assert again.restore_step(_state(0.0), total_steps=10) == 5
    params, opt, step = again.restored_state
    assert torch.equal(params["w"], torch.full((3, 2), 5.0))
    assert torch.equal(params["layers"][0]["b"], torch.ones(2))
    assert isinstance(opt[0], tt.AdamState) and opt[0].count == 4
    assert torch.equal(opt[0].nu["w"], torch.ones(2)) and step == 7


def test_keep_bounds_the_files_and_no_temporaries_remain(tmp_path):
    d = tmp_path / "ck"
    ck = TrainCheckpointer(d, save_every=1, keep=2, fingerprint="fp")
    for step in range(1, 6):
        ck.maybe_save(step, _state(float(step)))
    assert sorted(p.name for p in d.iterdir()) == [
        "4.pt", "5.pt", "fingerprint.txt"]


def test_fingerprint_mismatch_purges_only_checkpoints(tmp_path):
    d = tmp_path / "ck"
    first = TrainCheckpointer(d, save_every=1, fingerprint="old")
    first.maybe_save(1, _state(1.0))
    (d / "notes.txt").write_text("mine")
    (d / "2024").mkdir()
    (d / "3.pt.123.pt.tmp").write_bytes(b"half")
    fresh = TrainCheckpointer(d, save_every=1, fingerprint="new")
    assert fresh.restore_step(_state(0.0)) == 0
    assert fresh.restored_state is None
    assert sorted(p.name for p in d.iterdir()) == [
        "2024", "fingerprint.txt", "notes.txt"]
    assert (d / "fingerprint.txt").read_text() == "new"


def test_steps_without_a_fingerprint_are_stale(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    torch.save(_state(1.0), d / "3.pt")
    ck = TrainCheckpointer(d, save_every=1, fingerprint="fp")
    assert ck.restore_step(_state(0.0)) == 0
    assert not (d / "3.pt").exists()


def test_complete_clears(tmp_path):
    d = tmp_path / "ck"
    ck = TrainCheckpointer(d, save_every=1, fingerprint="fp")
    ck.maybe_save(1, _state(1.0))
    ck.complete()
    assert list(d.iterdir()) == []


def test_restore_maps_onto_the_like_states_device(tmp_path):
    d = tmp_path / "ck"
    TrainCheckpointer(d, save_every=1, fingerprint="fp").maybe_save(
        1, _state(1.0))
    ck = TrainCheckpointer(d, save_every=1, fingerprint="fp")
    ck.restore_step(_state(0.0))
    assert ck.restored_state[0]["w"].device.type == "cpu"


# -- end to end on the two-tower loop ----------------------------------------------

def _data(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, 200), rng.integers(0, 8, 200)


def _cfg(**kw):
    base = dict(n_users=16, n_items=8, embed_dim=8, hidden_dims=(16,),
                out_dim=8, batch_size=32, epochs=3, seed=7)
    base.update(kw)
    return tt.TwoTowerConfig(**base)


def _leaves(state):
    adam = state.opt_state[0]
    return (tt._leaves(state.params) + tt._leaves(adam.mu)
            + tt._leaves(adam.nu))


def _equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert (a.step, a.opt_state[0].count) == (b.step, b.opt_state[0].count)


def test_checkpointing_changes_nothing(tmp_path):
    users, items = _data()
    plain = tt.train(users, items, _cfg(), data_source="numpy",
                     device="cpu")
    ck = tt.train(users, items, _cfg(), data_source="numpy", device="cpu",
                  checkpoint_dir=tmp_path / "ck", save_every=4)
    _equal(plain, ck)


@pytest.mark.parametrize("source", ["numpy", "feeder"])
def test_killed_and_resumed_equals_uninterrupted(tmp_path, monkeypatch,
                                                 source):
    users, items = _data(seed=1)
    cfg = _cfg(seed=9)
    expected = tt.train(users, items, cfg, data_source=source,
                        device="cpu")
    real = tt.train_step
    calls = {"n": 0}

    def dying_step(*a):
        calls["n"] += 1
        if calls["n"] > 9:
            raise RuntimeError("injected trainer crash")
        return real(*a)

    ck = tmp_path / "ck"
    monkeypatch.setattr(tt, "train_step", dying_step)
    with pytest.raises(RuntimeError, match="injected"):
        tt.train(users, items, cfg, data_source=source, device="cpu",
                 checkpoint_dir=ck, save_every=3)
    assert sorted(p.name for p in ck.iterdir()) == [
        "3.pt", "6.pt", "9.pt", "fingerprint.txt"]
    monkeypatch.setattr(tt, "train_step", real)
    resumed = tt.train(users, items, cfg, data_source=source, device="cpu",
                       checkpoint_dir=ck, save_every=3)
    _equal(expected, resumed)
    assert sorted(p.name for p in ck.iterdir()) == []


def test_completed_run_leaves_nothing_to_resume(tmp_path):
    users, items = _data(seed=2)
    cfg = _cfg(seed=11)
    ck = tmp_path / "ck"
    first = tt.train(users, items, cfg, data_source="numpy", device="cpu",
                     checkpoint_dir=ck, save_every=1)
    assert not [p for p in ck.iterdir() if p.suffix == ".pt"]
    second = tt.train(users, items, cfg, data_source="numpy",
                      device="cpu", checkpoint_dir=ck, save_every=1)
    _equal(first, second)


def test_warm_runs_fingerprint_their_base_step(tmp_path):
    """A crash-resume checkpoint of one warm continuation is not
    restored into a continuation from another base generation."""
    users, items = _data(seed=3)
    cfg = _cfg(epochs=1)
    base = tt.train(users, items, cfg, data_source="numpy", device="cpu")
    ck = tmp_path / "ck"
    ckpt = TrainCheckpointer(
        ck, save_every=1,
        fingerprint=f"two_tower|{cfg}|n={len(users)}|warm@{base.step}")
    ckpt.maybe_save(2, (base.params, base.opt_state, base.step))
    other = tt.train(users, items, cfg, data_source="numpy", device="cpu")
    other = tt.TwoTowerState(other.params, other.opt_state,
                             other.step + 100)
    out = tt.train(users, items, cfg, data_source="numpy", device="cpu",
                   warm_state=other, checkpoint_dir=ck, save_every=1)
    assert out.step == other.step + 7      # ran every step, resumed none
