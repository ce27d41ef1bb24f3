"""The ALS training kernels' plain versions and host layout vs the JAX package.

Same numpy inputs, made from a seed, through the reference and the port:

- ``ops/ragged.py``: the port's copy must build identical arrays
  (``split_above``, ``pad_rows_to`` and ``max_len`` included);
- K1 (fused gram): the port's plain version against the Pallas kernel in
  interpret mode, with ragged rows and masked tails;
- K2 (LU) and K4 (Gauss-Jordan): the port's plain versions against the
  Pallas kernels in interpret mode and ``np.linalg.solve``.

The CUDA kernels themselves run in ``tests/test_torch_cuda_kernels.py``
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import ragged as jax_ragged
from predictionio_tpu.ops.pallas_kernels import (
    fused_gram_vector_pallas,
    ridge_solve_gj_pallas,
    ridge_solve_lu_pallas,
)
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import ragged as port_ragged
from predictionio_tpu_torch.ops import ridge_solve as rs

GRAM_RTOL = 1e-5   # float32 sums of the same products in another order;
GRAM_ATOL = 1e-6   # times max |A|: an entry that cancels to near zero
                   # keeps the rounding of its large terms
SOLVE_RTOL = 1e-4  # float32 elimination, condition numbers up to ~1e3
SOLVE_ATOL = 1e-5


def _coo(seed, n_rows=60, n_cols=45, n=900):
    rng = np.random.default_rng(seed)
    rows = (rng.zipf(1.3, n) - 1) % n_rows
    cols = rng.integers(0, n_cols, n)
    vals = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    return rows, cols, vals, n_rows


def _assert_padded_equal(got, want):
    for name in ("indices", "values", "mask", "row_ids", "seg_ids",
                 "ent_ids"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("split_above,pad_rows_to,max_len", [
    (None, 1, None), (4096, 8, None), (16, 8, None), (8, 3, None),
    (24, 8, 40), (None, 8, 12), (16, 1, 30)])
def test_bucket_by_length_identical(seed, split_above, pad_rows_to, max_len):
    rows, cols, vals, n_rows = _coo(seed)
    kw = dict(bucket_bounds="auto", max_len=max_len, pad_rows_to=pad_rows_to,
              split_above=split_above)
    want = jax_ragged.bucket_by_length(rows, cols, vals, n_rows, **kw)
    got = port_ragged.bucket_by_length(rows, cols, vals, n_rows, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_padded_equal(g, w)
    if split_above == 8:
        assert want[-1].split   # the case really splits


@pytest.mark.parametrize("seed", range(3))
def test_pad_ragged_fit_bounds_and_pinned_bounds_identical(seed):
    rows, cols, vals, n_rows = _coo(seed)
    _assert_padded_equal(
        port_ragged.pad_ragged(rows, cols, vals, n_rows, max_len=9,
                               pad_rows_to=8),
        jax_ragged.pad_ragged(rows, cols, vals, n_rows, max_len=9,
                              pad_rows_to=8))
    counts = port_ragged.segment_counts(rows, n_rows)
    np.testing.assert_array_equal(
        counts, jax_ragged.segment_counts(rows, n_rows))
    for kw in ({}, {"max_buckets": 3}, {"cap": 20}, {"align": 4}):
        assert port_ragged.fit_bounds(counts, **kw) == \
            jax_ragged.fit_bounds(counts, **kw)
    pinned = dict(bucket_bounds=(4, 16), pad_rows_to=8, split_above=32)
    for g, w in zip(
            port_ragged.bucket_by_length(rows, cols, None, n_rows, **pinned),
            jax_ragged.bucket_by_length(rows, cols, None, n_rows, **pinned)):
        _assert_padded_equal(g, w)


def _gram_inputs(seed, r, l, k, n=50):
    """Factors, indices and weights with a per-row ragged degree: slots
    past a row's degree carry index 0 and w = c = 0, as the ALS buckets
    do."""
    rng = np.random.default_rng(seed)
    factors = rng.standard_normal((n, k)).astype(np.float32)
    idx = rng.integers(0, n, (r, l)).astype(np.int32)
    w = np.abs(rng.standard_normal((r, l))).astype(np.float32)
    c = rng.standard_normal((r, l)).astype(np.float32)
    degree = rng.integers(1, l + 1, r)
    tail = np.arange(l)[None, :] >= degree[:, None]
    idx[tail] = 0
    w[tail] = 0.0
    c[tail] = 0.0
    return factors, idx, w, c


@pytest.mark.parametrize("r,l,k", [(5, 16, 8), (3, 37, 10), (9, 1030, 64),
                                   (1, 8, 3), (2, 40, 200),
                                   # ranks the band kernel takes on the
                                   # card (129..256), a padded tail each
                                   (3, 33, 129), (2, 17, 136), (2, 40, 192),
                                   (2, 17, 256)])
def test_gram_plain_matches_pallas_interpret(r, l, k):
    factors, idx, w, c = _gram_inputs(r * l + k, r, l, k)
    want_a, want_b = fused_gram_vector_pallas(
        jnp.asarray(factors[idx]), jnp.asarray(w), jnp.asarray(c),
        interpret=True)
    before = fg.LAUNCHES
    got_a, got_b = fg.fused_gram_vector(
        torch.from_numpy(factors), torch.from_numpy(idx),
        torch.from_numpy(w), torch.from_numpy(c))
    assert fg.LAUNCHES == before          # the CPU takes the plain version
    err = float(np.abs(got_a.numpy() - np.asarray(want_a)).max())
    print(f"K1 plain vs Pallas R={r} L={l} K={k}: max |A err| {err:.3g}")
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               rtol=GRAM_RTOL,
                               atol=GRAM_ATOL * np.abs(want_a).max())
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=GRAM_RTOL,
                               atol=GRAM_ATOL * np.abs(want_b).max())


def test_gram_plain_takes_bfloat16_factors():
    """bfloat16 factors are widened to float32 on the gather; every sum
    is float32 (oracle: numpy float64 over the rounded factors)."""
    factors, idx, w, c = _gram_inputs(3, 4, 24, 16)
    fb = torch.from_numpy(factors).bfloat16()
    a, b = fg.fused_gram_vector(fb, torch.from_numpy(idx),
                                torch.from_numpy(w), torch.from_numpy(c))
    f = fb.double().numpy()[idx]
    want_a = np.einsum("blk,bl,blm->bkm", f, w, f)
    want_b = np.einsum("blk,bl->bk", f, c)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=GRAM_RTOL,
                               atol=GRAM_ATOL * np.abs(want_a).max())
    np.testing.assert_allclose(b.numpy(), want_b, rtol=GRAM_RTOL,
                               atol=GRAM_ATOL * np.abs(want_b).max())


def test_gram_kernel_wrapper_refuses_cpu_tensors():
    factors, idx, w, c = _gram_inputs(0, 2, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fg.fused_gram_vector_cuda(
            torch.from_numpy(factors), torch.from_numpy(idx),
            torch.from_numpy(w), torch.from_numpy(c))
    assert fg.supports(64) and fg.supports(256) and not fg.supports(257)


def _spd(seed, b, k):
    """ALS-shaped systems: Gram matrices of 2k random rows plus a ridge
    reg = λ·degree, and a right-hand side."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, 2 * k, k)).astype(np.float32)
    a = np.einsum("blk,blm->bkm", y, y).astype(np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = (0.05 * rng.integers(1, 40, b)).astype(np.float32)
    return a, rhs, reg


# Ranks at the CUDA kernels' design edges: K4's one thread a system to
# 12, one warp to 64 (KP 32 to rank 32), shared memory above; K2's one
# thread to 16.  Every rank here is one gj_fits_vmem takes (k <= 68).
@pytest.mark.parametrize("k", [8, 10, 16, 17, 33, 64, 65])
@pytest.mark.parametrize("b", [1, 127, 129])
def test_ridge_plain_matches_pallas_interpret_and_numpy(b, k):
    a, rhs, reg = _spd(b * 100 + k, b, k)
    exact = np.linalg.solve(
        a.astype(np.float64) + reg[:, None, None] * np.eye(k),
        rhs.astype(np.float64)[..., None])[..., 0]
    ta, tb, tr = map(torch.from_numpy, (a, rhs, reg))
    for name, plain, pallas in (
            ("lu", rs.ridge_solve_lu, ridge_solve_lu_pallas),
            ("gj", rs.ridge_solve_gj, ridge_solve_gj_pallas)):
        before = (rs.LU_LAUNCHES, rs.GJ_LAUNCHES)
        got = plain(ta, tb, tr).numpy()
        assert (rs.LU_LAUNCHES, rs.GJ_LAUNCHES) == before
        want = np.asarray(pallas(jnp.asarray(a), jnp.asarray(rhs),
                                 jnp.asarray(reg), interpret=True))
        scale = np.abs(exact).max()
        print(f"{name} B={b} K={k}: max |x - Pallas| "
              f"{np.abs(got - want).max():.3g}, max |x - exact| "
              f"{np.abs(got - exact).max():.3g} (|x| up to {scale:.3g})")
        np.testing.assert_allclose(got, want, rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL * scale)
        np.testing.assert_allclose(got, exact, rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL * scale)


@pytest.mark.parametrize("b,k", [(1, 10), (127, 17), (129, 64)])
def test_ridge_gj_plain_solves_a_non_symmetric_a(b, k):
    """K4 solves A as it is given, as the TPU kernel does: on a
    non-symmetric, diagonally dominant A the port's Gauss-Jordan matches
    the Pallas kernel in interpret mode and a float64 solve, and differs
    from the solve of A's symmetric part."""
    rng = np.random.default_rng(1000 * b + k)
    a = (0.5 * rng.standard_normal((b, k, k))
         + k * np.eye(k)).astype(np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = (0.05 * rng.integers(1, 40, b)).astype(np.float32)
    assert not np.array_equal(a, np.swapaxes(a, 1, 2))
    exact = np.linalg.solve(
        a.astype(np.float64) + reg[:, None, None] * np.eye(k),
        rhs.astype(np.float64)[..., None])[..., 0]
    got = rs.ridge_solve_gj(*map(torch.from_numpy, (a, rhs, reg))).numpy()
    want = np.asarray(ridge_solve_gj_pallas(
        jnp.asarray(a), jnp.asarray(rhs), jnp.asarray(reg), interpret=True))
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, want, rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL * scale)
    np.testing.assert_allclose(got, exact, rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL * scale)
    sym = (a + np.swapaxes(a, 1, 2)) / 2
    other = rs.ridge_solve_gj(*map(torch.from_numpy, (sym, rhs, reg)))
    assert np.abs(other.numpy() - exact).max() > 100 * SOLVE_ATOL * scale


def test_ridge_wrapper_refuses_cpu_tensors_and_counts_flops():
    a, rhs, reg = _spd(0, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rs.ridge_solve_cuda(*map(torch.from_numpy, (a, rhs, reg)), "lu")
    with pytest.raises(ValueError, match="method"):
        rs.ridge_solve_cuda(*map(torch.from_numpy, (a, rhs, reg)), "qr")
    # LU: ~2K³/3 elimination flops; Gauss-Jordan: ~K³
    assert rs.solve_flops(64, "lu") == 181_024
    assert rs.solve_flops(64, "gj") == 264_224
    assert rs.supports(128) and not rs.supports(129)


@pytest.mark.parametrize("n,k", [(1, 1), (9, 1), (3, 10), (7, 10), (5, 17),
                                 (2, 64), (3, 65)])
def test_solve_cost_reads_the_lower_triangle_by_sectors(n, k):
    """K2's bound counts the 32-byte sectors that hold A's lower
    triangles up to REG_MAX_RANK (all of A above it and for K4), plus b
    and reg read and x written: held against a direct count."""
    flat = np.arange(n * k * k).reshape(n, k, k)
    rows, cols = np.tril_indices(k)
    lower = np.unique(flat[:, rows, cols] // 8).size * 32
    vectors = n * (2 * k + 1) * 4
    n_bytes, flops = rs.solve_cost(n, k, "lu")
    if k <= rs.REG_MAX_RANK:
        assert (n_bytes, flops) == (lower + vectors,
                                    n * rs.solve_flops(k, "cholesky"))
    else:
        assert (n_bytes, flops) == (n * k * k * 4 + vectors,
                                    n * rs.solve_flops(k, "lu"))
    assert rs.solve_cost(n, k, "gj") == (n * k * k * 4 + vectors,
                                         n * rs.solve_flops(k, "gj"))


def test_cholesky_flops_about_half_the_lu_count():
    # rank 64: row i of the lower triangle fills ⌈(i + 1) / 8⌉ sectors
    assert rs.solve_cost(1, 64, "lu")[0] == 288 * 32 + 129 * 4
    assert rs.solve_flops(64, "cholesky") == 97_696
    assert rs.solve_flops(1, "cholesky") == 4
    with pytest.raises(ValueError, match="method"):
        rs.solve_flops(8, "qr")
