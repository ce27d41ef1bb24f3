"""ALS on a mesh that spans a gang of processes, and its checkpoints.

Two gloo processes with 2 CPU positions each train on a ``data=4`` mesh
beside one process with all 4 (the harness of
``tests/test_torch_gang_collectives.py``): each process buckets every
block on the host, solves the shards of its own positions and exchanges
the factor gathers, the sums over shards and the solved rows.  The
gang's factors are ``torch.equal`` to the one process's for replicated
factors, row-sharded windowed ones (explicit and implicit) and split
buckets, and within rtol = atol = 1e-3 of the reference's mesh train of
the same configuration (PR 22's bound).

Checkpoints: a gang preempted after its second chunk (the SIGTERM flag
raised in process 1 only: the gang agrees to stop at one sweep) leaves
one step file a process, then resumes to the uninterrupted gang's
factors bit for bit; a chunk made NaN in process 0 only is rolled back
and replayed by both.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_gang_collectives import assert_equal_trees, run_gang

RTOL = ATOL = 1e-3
N = 4


def _ratings():
    rng = np.random.default_rng(5)
    mask = rng.random((30, 20)) < 0.3
    users, items = np.nonzero(mask)
    ratings = rng.uniform(1, 5, len(users)).astype(np.float32)
    return users.astype(np.int32), items.astype(np.int32), ratings, 30, 20


def _windowed():
    rng = np.random.default_rng(11)
    users = rng.integers(0, 96, 1500)
    items = rng.integers(0, 100, 1500)
    ratings = rng.uniform(1, 5, 1500).astype(np.float32)
    return users, items, ratings, 96, 400


def _split():
    rng = np.random.default_rng(3)
    users = rng.integers(0, 40, 900).astype(np.int32)
    items = rng.integers(0, 24, 900).astype(np.int32)
    ratings = rng.uniform(1, 5, 900).astype(np.float32)
    return users, items, ratings, 40, 24


BASE = dict(rank=4, iterations=3, reg=0.05, seed=9)
CONFIGS = {
    "replicated": (_ratings, dict(BASE, bucket_bounds=(8,),
                                  factor_sharding="replicated")),
    "sharded": (_ratings, dict(BASE, bucket_bounds=(8,),
                               factor_sharding="sharded")),
    "windowed": (_windowed, dict(BASE, bucket_bounds=(16,),
                                 factor_sharding="sharded",
                                 gather_window=True)),
    "windowed_implicit": (_windowed, dict(BASE, bucket_bounds=(16,),
                                          factor_sharding="sharded",
                                          gather_window=True,
                                          implicit=True, alpha=40.0)),
    "split": (_split, dict(BASE, split_above=16, max_block_floats=2048,
                           factor_sharding="sharded")),
}
SUPERVISE = dict(BASE, bucket_bounds=(16,), factor_sharding="sharded",
                 gather_window=True, iterations=6)


def _mesh():
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"data": N}, device="cpu")


# -- the cases (run in every process) -----------------------------------------


def case_trains() -> dict:
    """Every configuration's factors, trained on the ``data=4`` mesh."""
    from predictionio_tpu_torch.models import als

    out = {}
    for name, (data, cfg) in CONFIGS.items():
        users, items, ratings, n_u, n_i = data()
        mesh = _mesh()
        inputs = als.prepare_als_inputs(users, items, ratings, n_u, n_i,
                                        als.ALSConfig(**cfg), mesh=mesh)
        if name.startswith("windowed"):
            assert any(c.win is not None for c in inputs.user_buckets)
        m = als.train_als_prepared(inputs, als.ALSConfig(**cfg))
        out[name] = (m.user_factors, m.item_factors)
    return out


def case_supervised() -> dict:
    """The windowed configuration under sweep checkpoints every 2 sweeps:
    uninterrupted; preempted after its second chunk by process 1's flag
    alone, then resumed; one chunk made NaN in process 0 alone."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )
    from predictionio_tpu_torch.resilience import supervision as sup

    users, items, ratings, n_u, n_i = _windowed()
    cfg = als.ALSConfig(**SUPERVISE)
    inputs = als.prepare_als_inputs(users, items, ratings, n_u, n_i, cfg,
                                    mesh=_mesh())
    me, size = process_index(), process_count()
    work = Path(os.environ["PIO_GANG_OUT"]) / f"ckpt-{size}"
    real = als._mesh_train_loop
    out = {"whole": als.train_als_prepared(inputs, cfg)}
    calls = [0]

    def preempting(*a, **k):
        real(*a, **k)
        calls[0] += 1
        if calls[0] == 2 and me == size - 1:
            sup.request_preemption()           # one process's SIGTERM

    als._mesh_train_loop = preempting
    try:
        als.train_als_prepared(inputs, cfg, checkpoint_dir=work / "p",
                               save_every=2)
        out["preempted_at"] = None
    except sup.TrainPreempted as e:
        out["preempted_at"] = (e.step, e.checkpointed)
    finally:
        als._mesh_train_loop = real
        sup.clear_preemption()
    out["files"] = sorted(os.listdir(work / "p"))
    out["resumed"] = als.train_als_prepared(
        inputs, cfg, checkpoint_dir=work / "p", save_every=2)

    calls[0] = 0

    def poisoning(uf, itf, *a, **k):
        real(uf, itf, *a, **k)
        calls[0] += 1
        if calls[0] == 2 and me == 0:
            blk = next(t for t in uf.shards if t is not None)
            blk[0, 0] = float("nan")

    als._mesh_train_loop = poisoning
    try:
        out["replayed"] = als.train_als_prepared(
            inputs, cfg, checkpoint_dir=work / "nan", save_every=2)
    finally:
        als._mesh_train_loop = real
    out["calls"] = calls[0]
    return {k: ((v.user_factors, v.item_factors)
                if isinstance(v, als.ALSModel) else v)
            for k, v in out.items()}


# -- the tests ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return run_gang("tests.test_torch_gang_als:case_trains,case_supervised",
                    tmp_path_factory.mktemp("gang_als"))


def _ref_train(name):
    import jax

    from predictionio_tpu.models.als import ALSConfig, train_als
    from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh

    data, cfg = CONFIGS[name]
    users, items, ratings, n_u, n_i = data()
    m = train_als(users, items, ratings, n_u, n_i, ALSConfig(**cfg),
                  mesh=jmake_mesh({"data": N}))
    return (np.asarray(jax.device_get(m.user_factors)),
            np.asarray(jax.device_get(m.item_factors)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gang_als_equals_one_process_and_the_reference(gang, name):
    one = gang["one"]["case_trains"][name]
    for r in gang["gang"]:
        # every process of the gang returns the whole factors
        assert_equal_trees(r["case_trains"][name], one, name)
    for g, w in zip(one, _ref_train(name)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_gang_checkpoints_resume_to_the_uninterrupted_train(gang):
    want = gang["one"]["case_supervised"]
    for rank, r in enumerate(gang["gang"]):
        got = r["case_supervised"]
        assert_equal_trees(got["whole"], want["whole"], "whole")
        # the flag was raised in process 1 only; both stopped at sweep 4
        assert got["preempted_at"] == (4, True)
        # each process wrote its own files, and only its own
        assert got["files"] == sorted(
            f"{name}.p{r}of2.{ext}" for r in (0, 1)
            for name, ext in (("2", "pt"), ("4", "pt"),
                              ("fingerprint", "txt")))
        assert_equal_trees(got["resumed"], want["whole"], "resumed")
        # the NaN chunk of process 0 was replayed by both
        assert got["calls"] == want["calls"] == 4
        assert_equal_trees(got["replayed"], want["whole"], "replayed")
    assert want["preempted_at"] == (4, True)
    assert want["files"] == ["2.pt", "4.pt", "fingerprint.txt"]
