"""ALS on a device mesh, and the host route's staging through the
prefetcher (F14), in the port against the reference.

The reference trains on its own mesh of the 8 virtual CPU devices that
``tests/conftest.py`` sets up; the port on a CPU mesh of as many shards
(``make_mesh(device="cpu")``).  Both take the same seeded numpy ratings.
Tolerances are the reference's own mesh tests' (``tests/test_als.py``):
rtol 1e-3 and atol 1e-3 on the factors.  Two port mesh trains from the
same inputs are equal bit for bit.

F14's pins: the staged chunks equal, ``torch.equal`` field by field,
those of the staging as it was before the repair (kept below, in this
file only); two trains from one prep are equal; the prefetcher's thread
is joined on every exit, an exception partway included; the reference's
``lint_trainloop``, ``lint_metrics``, ``lint_retrieval`` and
``lint_ingest`` report nothing on the port's tree; and both registries
hold ``pio_prefetch_queue_depth{model="als"} 0`` after
``prepare_als_inputs``.
"""

import threading
from pathlib import Path
from typing import List

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models import als as pals
from predictionio_tpu_torch.ops.ragged import LEN_ALIGN, bucket_by_length
from predictionio_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-3


def _ratings(seed=5, n_u=30, n_i=20, density=0.3):
    rng = np.random.default_rng(seed)
    mask = rng.random((n_u, n_i)) < density
    users, items = np.nonzero(mask)
    ratings = rng.uniform(1, 5, len(users)).astype(np.float32)
    return users.astype(np.int32), items.astype(np.int32), ratings


def _windowed_ratings():
    """The reference's windowed-gather data: user-side chunks touch less
    than half of the item matrix (windows engage), the item side more."""
    rng = np.random.default_rng(11)
    n_u, n_i, nnz = 96, 400, 1500
    users = rng.integers(0, n_u, nnz)
    items = rng.integers(0, 100, nnz)
    ratings = rng.uniform(1, 5, nnz).astype(np.float32)
    return users, items, ratings, n_u, n_i


def _ref_train(users, items, ratings, n_u, n_i, mesh_size=None, **cfg):
    import jax

    from predictionio_tpu.models.als import ALSConfig, train_als
    from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh

    mesh = jmake_mesh({"data": mesh_size}) if mesh_size else None
    m = train_als(users, items, ratings, n_u, n_i, ALSConfig(**cfg),
                  mesh=mesh)
    return (np.asarray(jax.device_get(m.user_factors)),
            np.asarray(jax.device_get(m.item_factors)))


def _port_train(users, items, ratings, n_u, n_i, mesh_size=None, **cfg):
    mesh = make_mesh({"data": mesh_size}, device="cpu") if mesh_size \
        else None
    m = pals.train_als(users, items, ratings, n_u, n_i,
                       pals.ALSConfig(**cfg), mesh=mesh, device="cpu")
    return m.user_factors, m.item_factors


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


BASE = dict(rank=4, iterations=3, reg=0.05, seed=9, bucket_bounds=(8,))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("sharding", ["replicated", "sharded"])
def test_mesh_train_matches_the_reference_mesh_train(shards, sharding):
    users, items, ratings = _ratings()
    cfg = dict(BASE, factor_sharding=sharding)
    got = _port_train(users, items, ratings, 30, 20, shards, **cfg)
    _close(got, _ref_train(users, items, ratings, 30, 20, shards, **cfg))
    _close(got, _port_train(users, items, ratings, 30, 20, **BASE))
    again = _port_train(users, items, ratings, 30, 20, shards, **cfg)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("extra", [{}, {"implicit": True, "alpha": 40.0}],
                         ids=["explicit", "implicit"])
def test_windowed_blocked_train_matches_the_reference(extra):
    users, items, ratings, n_u, n_i = _windowed_ratings()
    base = dict(rank=4, iterations=3, reg=0.05, seed=9,
                bucket_bounds=(16,), **extra)
    cfg = pals.ALSConfig(**base, factor_sharding="sharded",
                         gather_window=True)
    mesh = make_mesh({"data": 8}, device="cpu")
    inputs = pals.prepare_als_inputs(users, items, ratings, n_u, n_i, cfg,
                                     mesh=mesh)
    assert any(c.win is not None for c in inputs.user_buckets)
    assert not any(c.win is not None for c in inputs.item_buckets)
    got = pals.train_als_prepared(inputs, cfg)
    again = pals.train_als_prepared(inputs, cfg)
    assert np.array_equal(got.user_factors, again.user_factors)
    assert np.array_equal(got.item_factors, again.item_factors)
    want = _ref_train(users, items, ratings, n_u, n_i, 8,
                      factor_sharding="sharded", gather_window=True, **base)
    _close((got.user_factors, got.item_factors), want)
    _close((got.user_factors, got.item_factors),
           _port_train(users, items, ratings, n_u, n_i, **base))


def test_split_buckets_on_a_mesh_match_the_reference():
    """Entities over ``split_above`` train as partial rows whose pieces
    sum across shards before the solve."""
    rng = np.random.default_rng(3)
    users = rng.integers(0, 40, 900).astype(np.int32)
    items = rng.integers(0, 24, 900).astype(np.int32)
    ratings = rng.uniform(1, 5, 900).astype(np.float32)
    cfg = dict(rank=4, iterations=3, reg=0.05, seed=9, split_above=16,
               max_block_floats=2048, factor_sharding="sharded")
    got = _port_train(users, items, ratings, 40, 24, 4, **cfg)
    _close(got, _ref_train(users, items, ratings, 40, 24, 4, **cfg))


def test_padded_factors_keep_the_true_extents():
    users, items, ratings = _ratings()
    mesh = make_mesh({"data": 8}, device="cpu")
    cfg = pals.ALSConfig(**BASE, factor_sharding="sharded")
    inputs = pals.prepare_als_inputs(users, items, ratings, 30, 20, cfg,
                                     mesh=mesh)
    assert inputs.uf0.shape == (32, 4) and inputs.itf0.shape == (24, 4)
    assert pals._factor_constraint(inputs.uf0) is not None
    m = pals.train_als_prepared(inputs, cfg)
    assert m.user_factors.shape == (30, 4)
    assert m.item_factors.shape == (20, 4)


def test_factor_sharding_auto_threshold_as_the_reference():
    from predictionio_tpu.models.als import ALSConfig, _shard_factors

    for kw, n in (({"rank": 4}, (30, 20)),
                  ({"rank": 128, "factor_shard_threshold": 1 << 20},
                   (100_000, 50_000))):
        assert pals._shard_factors(pals.ALSConfig(**kw), *n) \
            == _shard_factors(ALSConfig(**kw), *n)
    with pytest.raises(ValueError, match="factor_sharding"):
        pals._shard_factors(pals.ALSConfig(factor_sharding="rows"), 1, 1)


def test_window_gather_equals_a_plain_take():
    """Each row lives in one shard: the masked takes summed in shard
    order give the row's exact bits."""
    from predictionio_tpu_torch.parallel.mesh import PartitionSpec, put_sharded

    rng = np.random.default_rng(0)
    src = rng.normal(size=(64, 5)).astype(np.float32)
    win = np.sort(rng.choice(64, 20, replace=False)).astype(np.int32)
    for shards in (1, 2, 4, 8):
        mesh = make_mesh({"data": shards}, device="cpu")
        sh = put_sharded(src, mesh, PartitionSpec("data", None))
        got = pals._window_gather(sh, torch.from_numpy(win))
        assert torch.equal(got, torch.from_numpy(src[win]))


def test_chunk_window_equals_the_reference():
    from predictionio_tpu.models.als import _chunk_window

    rng = np.random.default_rng(1)
    idx = rng.integers(0, 300, (16, 8)).astype(np.int32)
    msk = rng.random((16, 8)) < 0.8
    got, want = pals._chunk_window(idx, msk, 1000), _chunk_window(idx, msk,
                                                                   1000)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert pals._chunk_window(idx, msk, 100) is None \
        and _chunk_window(idx, msk, 100) is None


def test_gather_window_must_be_a_bool_or_auto():
    users, items, ratings = _ratings()
    mesh = make_mesh({"data": 2}, device="cpu")
    with pytest.raises(ValueError, match="gather_window"):
        pals.prepare_als_inputs(users, items, ratings, 30, 20,
                                pals.ALSConfig(gather_window="yes"),
                                mesh=mesh)


@pytest.mark.parametrize("sharding", ["replicated", "sharded"])
def test_a_mesh_trains_resume_equals_its_uninterrupted_train(
        tmp_path, monkeypatch, sharding):
    """Sweep checkpoints of a mesh train: each factor block saved with its
    spec and restored onto its position.  Preempted after its second
    chunk, the train resumes to the uninterrupted mesh train's factors
    bit for bit, and the resumed blocks keep the mesh layout; a NaN
    chunk is rolled back and replayed to the same factors."""
    from predictionio_tpu_torch.resilience import supervision as sup

    users, items, ratings = _ratings()
    mesh = make_mesh({"data": 4}, device="cpu")
    cfg = pals.ALSConfig(**dict(BASE, iterations=7),
                         factor_sharding=sharding, gather_window=False)
    inputs = pals.prepare_als_inputs(users, items, ratings, 30, 20, cfg,
                                     mesh=mesh)
    want = pals.train_als_prepared(inputs, cfg)
    real = pals._mesh_train_loop
    calls = [0]

    def preempting(*a, **k):
        real(*a, **k)
        calls[0] += 1
        if calls[0] == 2:
            sup.request_preemption()

    monkeypatch.setattr(pals, "_mesh_train_loop", preempting)
    sup.clear_preemption()
    try:
        with pytest.raises(sup.TrainPreempted) as e:
            pals.train_als_prepared(inputs, cfg, checkpoint_dir=tmp_path,
                                    save_every=2)
    finally:
        sup.clear_preemption()
    assert (e.value.step, e.value.checkpointed) == (4, True)
    saved = torch.load(tmp_path / "4.pt", weights_only=False)
    assert tuple(saved[0]["spec"]) == tuple(inputs.uf0.spec)
    monkeypatch.setattr(pals, "_mesh_train_loop", real)
    got = pals.train_als_prepared(inputs, cfg, checkpoint_dir=tmp_path,
                                  save_every=2)
    assert np.array_equal(got.user_factors, want.user_factors)
    assert np.array_equal(got.item_factors, want.item_factors)
    assert not list(tmp_path.glob("*.pt"))
    calls[0] = 0

    def poisoning(uf, itf, *a, **k):
        real(uf, itf, *a, **k)
        calls[0] += 1
        if calls[0] == 2:
            uf.shards[0][0, 0] = float("nan")

    monkeypatch.setattr(pals, "_mesh_train_loop", poisoning)
    got = pals.train_als_prepared(inputs, cfg,
                                  checkpoint_dir=tmp_path / "nan",
                                  save_every=2)
    assert calls[0] == 5                     # 4 chunks and the replayed one
    assert np.array_equal(got.user_factors, want.user_factors)


# -- F14: the host route's staging through the prefetcher --------------------

def _unrepaired_device_buckets(buckets, rank, max_block_floats, pad_rows,
                               device) -> List:
    """The host route's staging before F14's repair: a host loop of
    uploads, with no prefetcher."""
    out = []
    for p in buckets:
        if p.split:
            for idx, vals, msk, seg, ent in pals._chunk_split_bucket(
                    p, rank, max_block_floats, pad_rows):
                out.append(pals._upload("merged", idx, vals, msk, ent, device,
                                        seg=seg))
            continue
        r, l = p.indices.shape
        rows_max = max(pad_rows,
                       (max_block_floats // max(l * rank, 1))
                       // pad_rows * pad_rows)
        for start in range(0, r, rows_max):
            sl = slice(start, start + rows_max)
            idx, vals = p.indices[sl], p.values[sl]
            msk, rid = p.mask[sl], p.row_ids[sl]
            short = (-idx.shape[0]) % pad_rows
            if short:
                idx = np.pad(idx, ((0, short), (0, 0)))
                vals = np.pad(vals, ((0, short), (0, 0)))
                msk = np.pad(msk, ((0, short), (0, 0)))
                rid = np.pad(rid, (0, short), constant_values=-1)
            out.append(pals._upload("plain", idx, vals, msk, rid, device))
    return out


def _f14_input():
    rng = np.random.default_rng(14)
    users = rng.integers(0, 200, 3000).astype(np.int32)
    items = rng.integers(0, 100, 3000).astype(np.int32)
    ratings = rng.uniform(1, 5, 3000).astype(np.float32)
    return users, items, ratings


@pytest.mark.parametrize("max_block_floats,split_above",
                         [(1 << 27, 4096), (2048, 40), (512, 24)])
def test_staged_chunks_equal_the_unrepaired_staging(max_block_floats,
                                                    split_above):
    users, items, ratings = _f14_input()
    for rows, cols, n in ((users, items, 200), (items, users, 100)):
        buckets = bucket_by_length(rows, cols, ratings, n,
                                   pad_rows_to=LEN_ALIGN,
                                   split_above=split_above)
        got = pals._device_buckets(buckets, 8, max_block_floats, LEN_ALIGN,
                                   torch.device("cpu"))
        want = _unrepaired_device_buckets(buckets, 8, max_block_floats,
                                          LEN_ALIGN, torch.device("cpu"))
        assert len(got) == len(want) and len(got) >= 1
        for g, w in zip(got, want):
            assert g.kind == w.kind and g.n_seg == w.n_seg
            for f in ("indices", "values", "mask", "keep", "targets",
                      "seg_ids"):
                a, b = getattr(g, f), getattr(w, f)
                assert (a is None and b is None) or torch.equal(a, b), f


def test_two_trains_from_one_prep_are_equal():
    users, items, ratings = _f14_input()
    cfg = pals.ALSConfig(rank=8, iterations=3, split_above=40,
                         max_block_floats=2048)
    inputs = pals.prepare_als_inputs(users, items, ratings, 200, 100, cfg,
                                     device="cpu")
    a = pals.train_als_prepared(inputs, cfg)
    b = pals.train_als_prepared(inputs, cfg)
    assert np.array_equal(a.user_factors, b.user_factors)
    assert np.array_equal(a.item_factors, b.item_factors)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "pio-prefetch-als" and t.is_alive()]


def test_the_staging_thread_is_joined_on_every_exit(monkeypatch):
    users, items, ratings = _f14_input()
    cfg = pals.ALSConfig(rank=8, iterations=1, max_block_floats=2048)
    pals.prepare_als_inputs(users, items, ratings, 200, 100, cfg,
                            device="cpu")
    assert _prefetch_threads() == []
    real, calls = pals._upload, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("upload failed")
        return real(*a, **kw)

    monkeypatch.setattr(pals, "_upload", failing)
    with pytest.raises(RuntimeError, match="upload failed"):
        pals.prepare_als_inputs(users, items, ratings, 200, 100, cfg,
                                device="cpu")
    assert len(calls) == 3
    assert _prefetch_threads() == []


def test_the_reference_lints_pass_on_the_port_tree(tmp_path):
    """``lint_trainloop``, ``lint_metrics``, ``lint_retrieval`` and
    ``lint_ingest`` key their rules on the reference's package path, so
    they read the port through an alias of that name."""
    import importlib

    (tmp_path / "predictionio_tpu").symlink_to(ROOT / "predictionio_tpu_torch")
    for name in ("lint_trainloop", "lint_metrics", "lint_retrieval",
                 "lint_ingest"):
        lint = importlib.import_module(f"tools.{name}")
        assert lint.check(tmp_path) == [], name


def _prefetch_samples(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("pio_prefetch_")
                  and 'model="als"' in line)


def test_both_registries_show_the_als_staging(pio_home):
    from predictionio_tpu.models.als import ALSConfig
    from predictionio_tpu.models.als import prepare_als_inputs as ref_prep
    from predictionio_tpu.obs import get_registry as ref_registry
    from predictionio_tpu_torch.obs import get_registry

    users, items, ratings = _f14_input()
    ref_prep(users, items, ratings, 200, 100,
             ALSConfig(rank=8, device_prep=False))
    pals.prepare_als_inputs(users, items, ratings, 200, 100,
                            pals.ALSConfig(rank=8), device="cpu")
    want = ['pio_prefetch_queue_depth{model="als"} 0']
    assert _prefetch_samples(ref_registry().render()) == want
    assert _prefetch_samples(get_registry().render()) == want
