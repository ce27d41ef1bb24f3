"""ALS training: the PyTorch port's ``train_als`` vs the JAX package's.

Both train from the same COO ratings (numpy, from a seed) and the same
seed: the port draws the reference's threefry init itself (within a few
float32 ulps), so the two sweeps start equal.  After 3
iterations the factors agree within atol 1e-4 + rtol 1e-3 (float32 Gram
sums and Cholesky solves in another order, compounded over 6 half
sweeps; the largest gap measured is printed) and ``rmse`` within 1e-5.
Cases: explicit and implicit feedback, a split bucket (small
``split_above``), forced chunking (small ``max_block_floats``), and
padded rows (``row_id == -1``) everywhere.
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.models import als as jax_als
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.resilience.supervision import (
    TrainDiverged,
    all_finite,
)

ATOL = 1e-4
RTOL = 1e-3
RMSE_TOL = 1e-5
N_USERS, N_ITEMS, N_RATINGS, RANK = 70, 50, 1200, 8
CPU = torch.device("cpu")


def _ratings(seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, N_RATINGS)
    items = (rng.zipf(1.25, N_RATINGS) % N_ITEMS).astype(np.int64)
    ratings = (rng.integers(1, 11, N_RATINGS) * 0.5).astype(np.float32)
    return users, items, ratings


CASES = {
    "explicit": {},
    "implicit": {"implicit": True, "alpha": 0.5},
    "split": {"split_above": 16},
    "implicit_split": {"implicit": True, "split_above": 16},
    "chunked": {"max_block_floats": 8 * 16 * RANK},
    "split_chunked": {"split_above": 16, "max_block_floats": 16 * 16 * RANK},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_als_matches_jax(case):
    users, items, ratings = _ratings()
    cfg = dict(rank=RANK, iterations=3, reg=0.05, seed=5, **CASES[case])
    want = jax_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                             jax_als.ALSConfig(**cfg))
    inputs = port_als.prepare_als_inputs(users, items, ratings, N_USERS,
                                         N_ITEMS, port_als.ALSConfig(**cfg),
                                         device=CPU)
    chunks = inputs.user_buckets + inputs.item_buckets
    # padded rows (row_id == -1) are present and dropped by the scatter
    assert any(len(c.keep) < (c.n_seg or c.indices.shape[0]) for c in chunks)
    if "split" in case:
        assert any(c.kind == "merged" for c in chunks)
    if "chunked" in case:
        assert len(chunks) > len(port_als.bucket_by_length(
            users, items, ratings, N_USERS, split_above=cfg.get(
                "split_above", 4096), pad_rows_to=8)) + 1
    got = port_als.train_als_prepared(inputs, port_als.ALSConfig(**cfg))
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        w = np.asarray(jax.device_get(w))
        print(f"{case}: max |port - JAX| {np.abs(g - w).max():.3g}")
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert got.rank == RANK and got.implicit == cfg.get("implicit", False)
    want_rmse = jax_als.rmse(want, users, items, ratings)
    got_rmse = port_als.rmse(got, users, items, ratings, device=CPU)
    assert abs(got_rmse - want_rmse) <= RMSE_TOL


@pytest.mark.parametrize("solver", ["lu", "gj"])
@pytest.mark.parametrize("implicit", [False, True])
def test_elimination_solvers_match_cholesky(solver, implicit):
    """The plain K2/K4 paths train the same model as the Cholesky path."""
    users, items, ratings = _ratings(1)
    base = dict(rank=RANK, iterations=3, reg=0.05, seed=2,
                implicit=implicit, split_above=16)
    want = port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                              port_als.ALSConfig(**base), device=CPU)
    got = port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                             port_als.ALSConfig(solver=solver, **base),
                             device=CPU)
    np.testing.assert_allclose(got.user_factors, want.user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item_factors, want.item_factors,
                               rtol=RTOL, atol=ATOL)


def test_init_is_seeded_scaled_and_device_independent():
    a = port_als._init_factors(30, 20, 16, 7)
    b = port_als._init_factors(30, 20, 16, 7)
    c = port_als._init_factors(30, 20, 16, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (30, 16) and a[1].shape == (20, 16)
    assert a[0].dtype == torch.float32
    # normal / sqrt(k): the standard deviation is about 1/4 at k = 16
    assert 0.2 < float(torch.cat([a[0], a[1]]).std()) < 0.3
    inputs = port_als.prepare_als_inputs(
        *_ratings(), N_USERS, N_ITEMS,
        port_als.ALSConfig(rank=RANK, seed=3), device="cpu")
    uf, itf = port_als._init_factors(N_USERS, N_ITEMS, RANK, 3)
    assert torch.equal(inputs.uf0, uf) and torch.equal(inputs.itf0, itf)


def test_route_choices():
    cuda = torch.device("cuda")   # a device object; nothing launches
    statics = port_als._resolve_loop_statics
    assert statics(port_als.ALSConfig(rank=64), CPU) == dict(
        gram_route="k1", gram_dtype="float32", solver="cholesky", implicit=False)
    assert statics(port_als.ALSConfig(rank=64), cuda) == dict(
        gram_route="k1", gram_dtype="float32", solver="lu", implicit=False)
    # K1 takes rank 256 (band_gram_kernel); the solve kernels stop at
    # 128, so "auto" takes the Cholesky solve there, as the reference
    # does above gj_fits_vmem
    assert statics(port_als.ALSConfig(rank=256), cuda) == dict(
        gram_route="k1", gram_dtype="float32", solver="cholesky", implicit=False)
    forced = statics(port_als.ALSConfig(rank=10, solver="gj",
                                        use_pallas=True,
                                        gram_dtype="bfloat16"), cuda)
    assert forced == dict(gram_route="k1", gram_dtype="bfloat16", solver="gj",
                          implicit=False)
    # above K1's ranks, or with use_pallas=False, the library route on
    # either device, as the reference's _bucket_pallas chooses
    assert statics(port_als.ALSConfig(rank=300, use_pallas=False),
                   CPU) == dict(gram_route="library", gram_dtype="float32",
                                solver="cholesky", implicit=False)
    for cfg in (port_als.ALSConfig(rank=257),
                port_als.ALSConfig(rank=300, use_pallas=True)):
        assert statics(cfg, cuda) == dict(
            gram_route="library", gram_dtype="float32", solver="cholesky",
            implicit=False)
    assert statics(port_als.ALSConfig(rank=64, use_pallas=False),
                   cuda) == dict(gram_route="library", gram_dtype="float32",
                                 solver="lu", implicit=False)
    with pytest.raises(NotImplementedError, match="ridge-solve"):
        statics(port_als.ALSConfig(rank=200, solver="lu"), cuda)
    with pytest.raises(NotImplementedError, match="ridge-solve"):
        statics(port_als.ALSConfig(rank=300, solver="gj"), cuda)
    with pytest.raises(ValueError, match="solver"):
        statics(port_als.ALSConfig(solver="qr"), CPU)
    with pytest.raises(ValueError, match="gram_dtype"):
        statics(port_als.ALSConfig(gram_dtype="float16"), CPU)


def test_row_chunks_pad_only_to_a_multiple_of_len_align():
    """A bucket cut into row chunks pads its last chunk only up to a
    multiple of LEN_ALIGN, not to the full chunk: every chunk has fewer
    than LEN_ALIGN rows of padding (index -1), yet the sweep still cuts."""
    from predictionio_tpu_torch.tools.exp_gram_calls import dead_rows

    users, items, ratings = _ratings()
    cfg = port_als.ALSConfig(rank=RANK, max_block_floats=24 * 16 * RANK)
    inputs = port_als.prepare_als_inputs(users, items, ratings, N_USERS,
                                         N_ITEMS, cfg, device=CPU)
    chunks = inputs.user_buckets + inputs.item_buckets
    plain = [c for c in chunks if c.kind == "plain"]
    lens = [c.indices.shape[1] for c in plain]
    assert len(lens) > len(set(lens))          # some bucket was cut
    for c in plain:
        assert c.indices.shape[0] % port_als.LEN_ALIGN == 0
        assert c.indices.shape[0] - len(c.keep) < port_als.LEN_ALIGN
    dead = dead_rows(chunks, RANK, cfg.max_block_floats)
    assert dead["k2_dead_rows_untrimmed"] > dead["k2_dead_rows"]
    assert dead["k2_rows_untrimmed"] - dead["k2_rows"] == \
        dead["k2_dead_rows_untrimmed"] - dead["k2_dead_rows"]


def test_scatter_drops_padded_rows_never_clamps():
    dst = torch.zeros((4, 2))
    row_ids = np.array([2, -1, 0, -1], np.int32)
    rows = torch.tensor([[1.0, 1.0], [9.0, 9.0], [3.0, 3.0], [7.0, 7.0]])
    keep, targets = port_als._valid_rows(row_ids, CPU)
    port_als._scatter_rows(dst, keep, targets, rows)
    assert dst.tolist() == [[3.0, 3.0], [0.0, 0.0], [1.0, 1.0], [0.0, 0.0]]


def test_non_finite_result_raises_train_diverged():
    users, items, ratings = _ratings()
    ratings = ratings.copy()
    ratings[5] = np.inf
    with pytest.raises(TrainDiverged, match="non-finite"):
        port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                           port_als.ALSConfig(rank=4, iterations=1),
                           device=CPU)


def test_all_finite_on_tensors_arrays_and_trees():
    assert all_finite((torch.ones(3), np.zeros(2), 1.5, {"a": [2]}))
    assert not all_finite([torch.tensor([1.0, float("nan")])])
    assert not all_finite({"x": np.array([np.inf])})
    assert not all_finite(float("inf"))
    assert all_finite(torch.arange(3))          # integers are always finite


def test_one_device_only_and_card_by_default(monkeypatch):
    users, items, ratings = _ratings()
    cfg = port_als.ALSConfig(rank=4, iterations=1)
    # A mesh trains (tests/test_torch_als_mesh.py) within one process and
    # across a gang (tests/test_torch_gang_als.py); a mesh whose shards
    # span two processes in another layout is refused.
    from predictionio_tpu_torch.parallel.mesh import Mesh

    two_processes = Mesh(np.array([CPU, CPU], dtype=object), ("data",),
                         np.array([1, 0]))
    with pytest.raises(ValueError, match="mesh"):
        port_als.train_als(users, items, ratings, N_USERS, N_ITEMS, cfg,
                           mesh=two_processes, device=CPU)
    # bucketing on the training device is ported: on the CPU it trains
    # what the host route trains
    on_dev = port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                                port_als.ALSConfig(rank=4, iterations=1,
                                                   device_prep=True),
                                device=CPU)
    on_host = port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                                 port_als.ALSConfig(rank=4, iterations=1,
                                                    device_prep=False),
                                 device=CPU)
    np.testing.assert_allclose(on_dev.user_factors, on_host.user_factors,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(on_dev.item_factors, on_host.item_factors,
                               rtol=0, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_als.train_als(users, items, ratings, N_USERS, N_ITEMS, cfg)
