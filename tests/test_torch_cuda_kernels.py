"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc (the kernels have no CPU
mode) and skips without them.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from predictionio_tpu_torch import device as port_device
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.ops import gather as gt
from predictionio_tpu_torch.ops import pq_scan as pqs
from predictionio_tpu_torch.ops import ridge_solve as rs
from predictionio_tpu_torch.ops.topk import topk_mismatch

RTOL = 1e-5   # float32 sums in another order: a few ulps of the score
ATOL = 1e-5
GRAM_RTOL = 1e-5   # K1: float32 sums of the same products in another
GRAM_SIGMAS = 5.0  # order; atol: 5·√L·2^-24·Σ|terms| per entry, five
                   # standard deviations of a float32 sum of L terms
SOLVE_RTOL = 1e-4  # K2/K4: float32 elimination vs the same elimination
SOLVE_ATOL = 1e-5  # in batched steps (FMA contraction differs); × max |x|


@pytest.fixture()
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; the CUDA kernels have "
                    "no CPU mode")
    port_device.set_float32_precision()
    return torch.device("cuda")


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    items = rng.standard_normal((n, d)).astype(np.float32)
    return q, items


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k,n_valid", [
    (1, 700, 16, 1, None), (3, 700, 16, 10, None), (8, 5000, 64, 100, None),
    (9, 5000, 64, 1000, None), (16, 3001, 10, 10, 2500),
    (64, 20_000, 64, 10, 19_999), (2, 1200, 64, 1000, None),
    (4, 300, 64, 300, None),
    # the tiled route: B around the crossover (D 10: 4-byte copies) and a
    # 64-query block, D 10 at B 64, k 100 and 1000 (fewer queries a
    # block), n_valid inside a tile, N no tile multiple; the small-B
    # route at D 64 past a tiled block's k
    (ft.TILED_MIN_BATCH - 1, 20_000, 10, 10, None),
    (ft.TILED_MIN_BATCH, 20_000, 10, 10, None),
    (ft.TILED_MIN_BATCH + 1, 20_000, 10, 10, None),
    (63, 20_000, 64, 10, None), (64, 20_000, 64, 10, None),
    (65, 5000, 64, 100, None), (128, 20_000, 64, 10, None),
    (64, 10_000, 10, 10, None), (64, 20_000, 64, 100, None),
    (64, 20_000, 64, 1000, None), (64, 20_000, 64, 10, 19_950),
    (64, 20_001, 64, 10, None), (33, 3001, 10, 10, 2500),
    (40, 100, 64, 100, None), (3, 3001, 10, 10, 2500),
    (5, 5000, 64, 2000, None), (64, 5000, 64, 1025, 4999),
])
def test_fused_topk_matches_reference(cuda_dev, b, n, d, k, n_valid):
    q, items = _inputs(b, n, d, seed=b + n)
    qt = torch.from_numpy(q).to(cuda_dev)
    it = torch.from_numpy(items).to(cuda_dev)
    before = ft.LAUNCHES
    s, i = ft.fused_topk_cuda(qt, it, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == before + 1
    n_real = n if n_valid is None else n_valid
    rs, ri = ft.fused_topk_reference(qt, it, min(k + 1, n_real),
                                     n_valid=n_valid)
    next_s = rs[:, k].cpu().numpy() if rs.shape[1] > k else None
    assert topk_mismatch(s.cpu().numpy(), i.cpu().numpy(),
                         rs[:, :k].cpu().numpy(), ri[:, :k].cpu().numpy(),
                         next_s, rtol=RTOL, atol=ATOL) is None
    if n_valid is not None:
        assert int(i.max()) < n_valid


@pytest.mark.cuda
def test_fused_topk_ties_prefer_lower_id(cuda_dev):
    """Duplicate item rows score exactly equal; the lower id ranks first."""
    q, items = _inputs(2, 2000, 64, seed=7)
    items[1500] = items[10]
    items[1999] = items[10]
    qt = torch.from_numpy(q).to(cuda_dev)
    it = torch.from_numpy(items).to(cuda_dev)
    _, i = ft.fused_topk_cuda(qt, it, 2000)
    i = i.cpu().numpy()
    for row in range(2):
        pos = {int(x): p for p, x in enumerate(i[row])}
        assert sorted(pos) == list(range(2000))
        assert pos[10] < pos[1500] < pos[1999]


@pytest.mark.cuda
def test_fused_topk_tiled_ties_prefer_lower_id(cuda_dev):
    """The tiled route: four copies of the best row in other tiles and
    chunks tie exactly for every query and come out lowest id first."""
    b, n = 64, 2000
    q, items = _inputs(b, n, 64, seed=11)
    q = np.abs(q)
    for row in (10, 300, 1500, 1999):
        items[row] = 5.0
    assert ft.plan(b, n, 64, 10).tiled
    qt = torch.from_numpy(q).to(cuda_dev)
    it = torch.from_numpy(items).to(cuda_dev)
    s, i = ft.fused_topk_cuda(qt, it, 10)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    assert (i[:, :4] == [10, 300, 1500, 1999]).all()
    assert (s[:, :4] == s[:, :1]).all() and (s[:, 4] < s[:, 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 10])
def test_fused_topk_tiled_unaligned_rows(cuda_dev, d):
    """A corpus whose rows are not 16-byte aligned takes 4-byte copies."""
    q, items = _inputs(64, 3000, d, seed=d)
    base = torch.empty(items.size + 1, dtype=torch.float32, device=cuda_dev)
    it = base[1:].view(3000, d)
    it.copy_(torch.from_numpy(items))
    assert it.data_ptr() % 16 != 0
    qt = torch.from_numpy(q).to(cuda_dev)
    s, i = ft.fused_topk_cuda(qt, it, 10)
    rs, ri = ft.fused_topk_reference(qt, it, 11)
    assert topk_mismatch(s.cpu().numpy(), i.cpu().numpy(),
                         rs[:, :10].cpu().numpy(), ri[:, :10].cpu().numpy(),
                         rs[:, 10].cpu().numpy(), rtol=RTOL,
                         atol=ATOL) is None


@pytest.mark.cuda
def test_fused_topk_unfilled_slots(cuda_dev):
    """Fewer valid rows than k: the tail slots read NEG_INF / -1."""
    q, items = _inputs(3, 400, 64, seed=3)
    qt = torch.from_numpy(q).to(cuda_dev)
    it = torch.from_numpy(items).to(cuda_dev)
    s, i = ft.fused_topk_cuda(qt, it, 10, n_valid=4)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    assert (np.sort(i[:, :4], axis=1) == np.arange(4)).all()
    assert (s[:, 4:] == np.float32(-3.4e38)).all() and (i[:, 4:] == -1).all()


@pytest.mark.cuda
def test_fused_topk_dispatcher_on_card(cuda_dev):
    q, items = _inputs(3, 500, 64, seed=5)
    qt = torch.from_numpy(q).to(cuda_dev)
    it = torch.from_numpy(items).to(cuda_dev)
    before = ft.LAUNCHES
    s, i = ft.fused_topk(qt, it, 10)
    assert ft.LAUNCHES == before + 1 and s.is_cuda and i.dtype == torch.int32
    with pytest.raises(ValueError, match="one CUDA device"):
        ft.fused_topk(qt, it.cpu(), 10)
    with pytest.raises(TypeError, match="float32"):
        ft.fused_topk(qt.double(), it.double(), 10)


def _gram_inputs(r, l, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    factors = torch.from_numpy(
        rng.standard_normal((n, k)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, n, (r, l)).astype(np.int32)
    w = np.abs(rng.standard_normal((r, l))).astype(np.float32)
    c = rng.standard_normal((r, l)).astype(np.float32)
    tail = np.arange(l)[None, :] >= rng.integers(1, l + 1, r)[:, None]
    idx[tail], w[tail], c[tail] = 0, 0.0, 0.0
    return factors, torch.from_numpy(idx), torch.from_numpy(w), \
        torch.from_numpy(c)


# K1's edges up to rank 128 (the symmetric-tile kernel): R below, at and
# past a block's rows, L around the 16-slot pipeline step, odd ranks
# (rows of no 16-byte width) and both register-tile widths; then R large
# enough that a block holds several rows and the last block is partial.
GRAM_EDGES = [(r, l, k) for r in (1, 3, 13) for l in (1, 17, 33, 4096)
              for k in (10, 17, 63, 65, 100, 127, 128)]
GRAM_MULTI_ROW = [(10_001, 9, 3), (11_111, 17, 10), (5003, 8, 17),
                  (4501, 20, 33), (2001, 33, 64), (601, 50, 100),
                  (3001, 40, 128)]
# Above rank 128 (one solve row a block, A written in bands): the first
# rank of each padded width (160, 192, 224, 256), ranks of no 16-byte row,
# one band (136) and two (200, 255, 256), then more rows than the card
# holds blocks at once.
GRAM_WIDE_RANKS = (129, 136, 200, 255, 256)
GRAM_WIDE = [(r, l, k) for r in (1, 3, 13) for l in (1, 17, 33, 4096)
             for k in GRAM_WIDE_RANKS] + [(1001, 40, 136), (601, 17, 256),
                                          (300, 65, 193), (300, 20, 225)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,l,k", [(1, 8, 3), (8, 8, 10), (8, 64, 64),
                                   (37, 1000, 64), (8, 4096, 128),
                                   (300, 200, 17), (5, 33, 100),
                                   (16, 1000, 129), (7, 300, 200),
                                   (3, 64, 256)] + GRAM_EDGES + GRAM_MULTI_ROW
                         + GRAM_WIDE)
def test_fused_gram_matches_reference(cuda_dev, r, l, k, dtype):
    args = [t.to(cuda_dev) for t in _gram_inputs(r, l, k, 3000, r + l + k,
                                                 dtype)]
    before = fg.LAUNCHES
    a, b = fg.fused_gram_vector(*args)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    ra, rb = fg.fused_gram_vector_reference(*args)
    fac, idx, w, c = args
    abs_a, abs_b = fg.fused_gram_vector_reference(fac.abs(), idx, w.abs(),
                                                  c.abs())
    sigma = GRAM_SIGMAS * l ** 0.5 * 2.0 ** -24
    assert bool(((a - ra).abs() <= sigma * abs_a + GRAM_RTOL * ra.abs())
                .all())
    assert bool(((b - rb).abs() <= sigma * abs_b + GRAM_RTOL * rb.abs())
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,l,k", [(5, 17, 10), (2001, 33, 64),
                                   (13, 64, 128), (13, 64, 129),
                                   (9, 40, 136), (9, 40, 200), (7, 33, 255),
                                   (301, 17, 256)])
def test_fused_gram_padding_rows_are_exact_zero(cuda_dev, r, l, k, dtype):
    """Rows whose every slot is padding (index 0, w = c = 0) give A = 0
    and b = 0 exactly, beside rows that are not."""
    fac, idx, w, c = [t.to(cuda_dev) for t in _gram_inputs(r, l, k, 3000,
                                                           r + l, dtype)]
    dead = torch.arange(r, device=cuda_dev) % 3 == 1
    idx[dead], w[dead], c[dead] = 0, 0.0, 0.0
    a, b = fg.fused_gram_vector(fac, idx, w, c)
    torch.cuda.synchronize()
    assert bool((a[dead] == 0).all()) and bool((b[dead] == 0).all())
    assert bool((a[~dead].abs().sum((1, 2)) > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 10, 17, 32, 33, 63, 64, 65, 100, 127, 128,
                               129, 136, 200, 255, 256])
def test_gram_a_is_exactly_symmetric(cuda_dev, k, dtype):
    """At every rank K1 and T1 compute the tiles on or above A's
    diagonal and write each with its transpose: A equals Aᵀ bitwise, and
    K1's A equals T1's bitwise."""
    fac, idx, w, c = [t.to(cuda_dev) for t in _gram_inputs(700, 37, k, 3000,
                                                           k, dtype)]
    a, _ = fg.fused_gram_vector(fac, idx, w, c)
    a1 = fg.gather_gram(fac, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(a, a.mT) and torch.equal(a1, a1.mT)
    assert torch.equal(a, a1)


def _spd(b, k, seed, dev):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, 2 * k, k)).astype(np.float32)
    a = torch.from_numpy(np.einsum("blk,blm->bkm", y, y).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    reg = torch.from_numpy((0.05 * rng.integers(1, 40, b)).astype(np.float32))
    return a.to(dev), rhs.to(dev), reg.to(dev)


def _exact(a, rhs, reg):
    """float64 ``torch.linalg.solve`` of the same systems."""
    k = a.shape[-1]
    eye = torch.eye(k, dtype=torch.float64, device=a.device)
    return torch.linalg.solve(a.double() + reg.double()[:, None, None] * eye,
                              rhs.double()[..., None])[..., 0].float()


# K2's compiled sizes: one thread per system (KP 4, 8, 12, 16), one warp
# (KP 32, 64), identity padding between them, the shared-memory LU above
# 64; B not a multiple of a tile (32 systems) or a block (4 warps).
@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lu", "gj"])
@pytest.mark.parametrize("b,k", [(1, 10), (127, 64), (128, 8), (131, 128),
                                 (5000, 64), (3, 33), (33, 1), (97, 10),
                                 (1001, 16), (31, 17), (65, 32), (129, 33),
                                 (4099, 64), (35, 65), (7, 128)])
def test_ridge_solve_matches_reference(cuda_dev, method, b, k):
    a, rhs, reg = _spd(b, k, b + k, cuda_dev)
    plain = rs.ridge_solve_lu_reference if method == "lu" \
        else rs.ridge_solve_gj_reference
    before = (rs.LU_LAUNCHES, rs.GJ_LAUNCHES)
    x = rs.ridge_solve_cuda(a, rhs, reg, method)
    torch.cuda.synchronize()
    after = (rs.LU_LAUNCHES, rs.GJ_LAUNCHES)
    assert after == ((before[0] + 1, before[1]) if method == "lu"
                     else (before[0], before[1] + 1))
    want = plain(a, rhs, reg)
    torch.testing.assert_close(x, want, rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL * float(want.abs().max()))
    torch.testing.assert_close(x, _exact(a, rhs, reg), rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16, 17, 32, 33, 64, 65, 128])
def test_ridge_solve_lu_takes_the_register_kernel_to_rank_64(cuda_dev, k):
    """K2 never launches the shared-memory LU at or below REG_MAX_RANK
    (one thread a system to rank 16, one warp above), as the library
    reports the kernel it launched; above it, and under method
    "lu_shared", it does."""
    a, rhs, reg = _spd(37, k, k, cuda_dev)
    before = dict(rs.KERNEL_LAUNCHES)
    x = rs.ridge_solve_lu(a, rhs, reg)
    torch.cuda.synchronize()
    want_kernel = ("chol_thread" if k <= 16 else
                   "chol_warp" if k <= rs.REG_MAX_RANK else "lu_shared")
    assert rs.KERNEL_LAUNCHES == {**before,
                                  want_kernel: before[want_kernel] + 1}
    before = (rs.LU_LAUNCHES, dict(rs.KERNEL_LAUNCHES))
    old = rs.ridge_solve_cuda(a, rhs, reg, "lu_shared")
    torch.cuda.synchronize()
    assert (rs.LU_LAUNCHES, rs.KERNEL_LAUNCHES) == \
        (before[0], {**before[1], "lu_shared": before[1]["lu_shared"] + 1})
    want = rs.ridge_solve_lu_reference(a, rhs, reg)
    for got in (x, old):
        torch.testing.assert_close(got, want, rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method,k", [("chol_warp", 1), ("chol_warp", 10),
                                      ("chol_warp", 64),
                                      ("chol_thread16", 1),
                                      ("chol_thread16", 10),
                                      ("chol_thread16", 16)])
def test_ridge_solve_forced_designs_match_reference(cuda_dev, method, k):
    """The designs the tools force for timing solve the same systems, and
    refuse a rank they do not take."""
    a, rhs, reg = _spd(45, k, 3 * k, cuda_dev)
    before = dict(rs.KERNEL_LAUNCHES)
    x = rs.ridge_solve_cuda(a, rhs, reg, method)
    torch.cuda.synchronize()
    kernel = "chol_warp" if method == "chol_warp" else "chol_thread"
    assert rs.KERNEL_LAUNCHES[kernel] == before[kernel] + 1
    want = rs.ridge_solve_lu_reference(a, rhs, reg)
    torch.testing.assert_close(x, want, rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL * float(want.abs().max()))
    too_big = rs.REG_MAX_RANK + 1 if method == "chol_warp" else 17
    a, rhs, reg = _spd(3, too_big, 1, cuda_dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        rs.ridge_solve_cuda(a, rhs, reg, method)


# K4's designs: one thread a system (KP 4, 8, 12) to rank 12, one warp
# (KP 32, 64) to 64, the shared-memory kernel above; B around a tile of
# 32 systems and a block of 4 warps.
GJ_RANKS = (1, 4, 5, 8, 9, 12, 13, 16, 17, 32, 33, 63, 64, 65, 128)


def _gj_kernel(k):
    return ("gj_thread" if k <= rs.GJ_THREAD_MAX_RANK else
            "gj_warp" if k <= rs.REG_MAX_RANK else "gj_shared")


@pytest.mark.cuda
@pytest.mark.parametrize("k", GJ_RANKS)
@pytest.mark.parametrize("b", [1, 31, 32, 33])
def test_ridge_solve_gj_designs_match_reference_and_float64(cuda_dev, b, k):
    """K4 at every design edge takes the design of its rank, as the
    library reports it, and matches its plain version and a float64
    solve."""
    a, rhs, reg = _spd(b, k, 11 * b + k, cuda_dev)
    before = (rs.GJ_LAUNCHES, dict(rs.KERNEL_LAUNCHES))
    x = rs.ridge_solve_gj(a, rhs, reg)
    torch.cuda.synchronize()
    kernel = _gj_kernel(k)
    assert (rs.GJ_LAUNCHES, rs.KERNEL_LAUNCHES) == \
        (before[0] + 1, {**before[1], kernel: before[1][kernel] + 1})
    want = rs.ridge_solve_gj_reference(a, rhs, reg)
    atol = SOLVE_ATOL * float(want.abs().max())
    torch.testing.assert_close(x, want, rtol=SOLVE_RTOL, atol=atol)
    torch.testing.assert_close(x, _exact(a, rhs, reg), rtol=SOLVE_RTOL,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(40, 3), (70, 10), (33, 12), (9, 13),
                                 (40, 33), (100, 64), (5, 100)])
def test_ridge_solve_gj_reads_all_of_a_non_symmetric(cuda_dev, b, k):
    """K4 solves A as it is given: a non-symmetric, diagonally dominant A
    matches the plain version and a float64 solve, and A stored at an
    address that is not 16-byte aligned takes the scalar staging."""
    rng = np.random.default_rng(b * k)
    a = (0.5 * rng.standard_normal((b, k, k)) + k * np.eye(k))
    rhs = rng.standard_normal((b, k))
    reg = 0.05 * rng.integers(1, 40, b)
    a, rhs, reg = (torch.from_numpy(t.astype(np.float32)).to(cuda_dev)
                   for t in (a, rhs, reg))
    flat = torch.empty(b * k * k + 1, device=cuda_dev)
    shifted = flat[1:].view(b, k, k)
    shifted.copy_(a)
    want = rs.ridge_solve_gj_reference(a, rhs, reg)
    atol = SOLVE_ATOL * float(want.abs().max())
    for given in (a, shifted):
        x = rs.ridge_solve_gj(given, rhs, reg)
        torch.testing.assert_close(x, want, rtol=SOLVE_RTOL, atol=atol)
        torch.testing.assert_close(x, _exact(a, rhs, reg), rtol=SOLVE_RTOL,
                                   atol=atol)
    sym = rs.ridge_solve_gj(((a + a.mT) / 2).contiguous(), rhs, reg)
    assert float((sym - want).abs().max()) > 100 * atol


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(45, 3), (70, 10), (33, 16), (9, 17),
                                 (40, 33), (100, 64)])
def test_ridge_solve_lu_reads_the_lower_triangle(cuda_dev, b, k):
    """Up to REG_MAX_RANK, K2 solves the symmetric system of A's lower
    triangle: whatever lies above the diagonal is never read."""
    a, rhs, reg = _spd(b, k, 7 * k, cuda_dev)
    a = (a + a.mT) / 2                        # exactly symmetric
    low = torch.tril(a)
    noisy = low + torch.triu(torch.full_like(a, float("nan")), diagonal=1)
    x = rs.ridge_solve_lu(noisy, rhs, reg)
    want = rs.ridge_solve_lu_reference(a, rhs, reg)
    torch.testing.assert_close(x, want, rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL * float(want.abs().max()))
    torch.testing.assert_close(rs.ridge_solve_lu(a, rhs, reg), x,
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_training_on_the_card_launches_k1_k2_and_matches_plain(cuda_dev):
    rng = np.random.default_rng(0)
    n_users, n_items, n = 500, 300, 20_000
    users = rng.integers(0, n_users, n)
    items = (rng.zipf(1.25, n) % n_items).astype(np.int64)
    ratings = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    cfg = port_als.ALSConfig(rank=16, iterations=2, split_above=256)
    before = (fg.LAUNCHES, rs.LU_LAUNCHES)
    got = port_als.train_als(users, items, ratings, n_users, n_items, cfg,
                             device=cuda_dev)
    assert fg.LAUNCHES > before[0] and rs.LU_LAUNCHES > before[1]
    # use_pallas=False takes the library gram, as the reference's
    # _bucket_pallas does: no K1 launch, the same factors within the
    # smoke's kernel-vs-plain training tolerance (chip_smoke.py
    # TRAIN_RTOL / TRAIN_ATOL: K1 and torch.bmm sum in another order, and
    # reg 0.01 carries the difference through two iterations; 1.9e-4 was
    # the largest gap measured on an H100)
    before = fg.LAUNCHES
    library = port_als.train_als(
        users, items, ratings, n_users, n_items,
        dataclasses.replace(cfg, use_pallas=False), device=cuda_dev)
    assert fg.LAUNCHES == before
    np.testing.assert_allclose(library.user_factors, got.user_factors,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(library.item_factors, got.item_factors,
                               rtol=1e-3, atol=1e-3)
    # the plain versions run on the CPU (and Cholesky solves there)
    plain = port_als.train_als(users, items, ratings, n_users, n_items, cfg,
                               device="cpu")
    np.testing.assert_allclose(got.user_factors, plain.user_factors,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, plain.item_factors,
                               rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_a_k1_that_fails_to_load_raises_and_takes_no_library_route(
        cuda_dev, monkeypatch):
    """The library gram is chosen by rank and ``use_pallas`` alone: at a
    rank K1 takes, a K1 library that does not load ends the train."""
    calls = []
    real = fg.fused_gram_vector_library
    monkeypatch.setattr(fg, "fused_gram_vector_library",
                        lambda *a: calls.append(1) or real(*a))

    def broken():
        raise RuntimeError("fused_gram: the library did not build")

    monkeypatch.setattr(fg, "_lib", broken)
    rng = np.random.default_rng(3)
    users, items = rng.integers(0, 200, 4000), rng.integers(0, 100, 4000)
    ratings = (rng.integers(1, 11, 4000) * 0.5).astype(np.float32)
    for rank in (16, 256):
        with pytest.raises(RuntimeError, match="did not build"):
            port_als.train_als(users, items, ratings, 200, 100,
                               port_als.ALSConfig(rank=rank, iterations=1),
                               device=cuda_dev)
    assert calls == []


def _pq_inputs(b, s, n, seed, dev):
    rng = np.random.default_rng(seed)
    luts = torch.from_numpy(
        rng.standard_normal((b, s, 256)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(
        rng.integers(0, 256, (s, n)).astype(np.uint8)).to(dev)
    return luts, codes


# The plan's edges: 16 items a thread a round at B 1 (one 16-byte code
# load a table when N % 16 == 0, byte loads otherwise), 4 at B > 1 (a
# 4-byte load when N % 4 == 0); B 1/7/8/9/64 around the 8 queries a block;
# n_valid tails inside a round; k up to the plan's limit.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n,k,n_valid", [
    (1, 17, 100_003, 40, None), (3, 1, 511, 10, None), (8, 5, 1, 1, None),
    (9, 17, 20_000, 1000, 19_000), (64, 33, 5000, 40, None),
    (2, 65, 12_000, 4000, None), (5, 65, 3000, 300, 2999),
    (1, 17, 1_048_576, 40, None), (1, 17, 65_536, 40, 65_535),
    (1, 17, 65_540, 40, None), (1, 5, 4095, 100, 4001),
    (7, 17, 65_536, 40, None), (8, 17, 65_540, 40, 40_001),
    (9, 17, 65_539, 40, None), (64, 17, 131_072, 40, 131_071),
    (1, 3, 100, 100, None), (2, 17, 40_000, 16_128, None),
    (1, 17, 20_000, 256, None), (1, 17, 20_000, 257, None),
])
def test_pq_scan_matches_reference(cuda_dev, b, s, n, k, n_valid):
    luts, codes = _pq_inputs(b, s, n, b + s + n, cuda_dev)
    before = pqs.LAUNCHES
    got_s, got_i = pqs.pq_scan_cuda(luts, codes, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert pqs.LAUNCHES == before + 1
    n_real = n if n_valid is None else n_valid
    ref_s, ref_i = pqs.pq_scan_reference(luts, codes, min(k + 1, n_real),
                                         n_valid=n_valid)
    next_s = ref_s[:, k].cpu().numpy() if ref_s.shape[1] > k else None
    assert topk_mismatch(got_s.cpu().numpy(), got_i.cpu().numpy(),
                         ref_s[:, :k].cpu().numpy(),
                         ref_i[:, :k].cpu().numpy(), next_s, rtol=RTOL,
                         atol=ATOL) is None
    assert int(got_i.max()) < n_real


@pytest.mark.cuda
def test_pq_scan_ties_prefer_lower_id_and_unfilled_slots(cuda_dev):
    """One table: every item scores one of 256 values, so scores tie;
    the kernel ranks the lower id first, in blocks of one query and of
    several.  Fewer valid items than k: the tail slots read NEG_INF /
    -1."""
    for b, n, k in ((2, 3000, 3000), (9, 3000, 3000), (1, 50_000, 40),
                    (9, 50_001, 40)):
        luts, codes = _pq_inputs(b, 1, n, n + b, cuda_dev)
        s, i = pqs.pq_scan_cuda(luts, codes, k)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        ref = luts[:, 0].cpu().numpy()[:, codes[0].long().cpu().numpy()]
        for row in range(b):
            key = np.lexsort((np.arange(n), -ref[row]))[:k]
            assert (i[row] == key).all() and (s[row] == ref[row][key]).all()
    luts, codes = _pq_inputs(2, 1, 3000, 1, cuda_dev)
    s, i = pqs.pq_scan_cuda(luts, codes, 10, n_valid=4)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    assert (np.sort(i[:, :4], axis=1) == np.arange(4)).all()
    assert (s[:, 4:] == np.float32(-3.4e38)).all() and (i[:, 4:] == -1).all()
    with pytest.raises(TypeError, match="uint8"):
        pqs.pq_scan(luts, codes.int(), 10)


def _gather_inputs(i, k, r, l, seed, dev):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((i, k)).astype(np.float32))
    idx = torch.from_numpy((rng.zipf(1.25, (r, l)) % i).astype(np.int32))
    w = torch.from_numpy(rng.random((r, l)).astype(np.float32))
    return y.to(dev), idx.to(dev), w.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("i,k,r,l", [(3000, 64, 300, 256), (500, 7, 9, 33),
                                     (1000, 130, 20, 100), (50, 1, 3, 1),
                                     (2000, 255, 5, 64),
                                     # the vec4 design: 8/16/32 lanes a
                                     # row, R odd, L no multiple of 16
                                     # or of 4 (scalar index loads)
                                     (3000, 4, 17, 256), (3000, 32, 31, 40),
                                     (3000, 36, 7, 13), (3000, 128, 33, 257),
                                     (59_047, 64, 1001, 256)])
def test_gather_sum_matches_reference(cuda_dev, i, k, r, l):
    y, idx, _ = _gather_inputs(i, k, r, l, i + k + r + l, cuda_dev)
    before = gt.LAUNCHES
    got = gt.gather_sum(y, idx)
    torch.cuda.synchronize()
    assert gt.LAUNCHES == before + 1
    want = gt.gather_sum_reference(y, idx)
    abs_sum = gt.gather_sum_reference(y.abs(), idx)
    sigma = GRAM_SIGMAS * l ** 0.5 * 2.0 ** -24
    assert bool(((got - want).abs() <= sigma * abs_sum).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["zipf", "zero", "uniform"])
@pytest.mark.parametrize("i,k,r,l", [(59_047, 64, 300, 256),
                                     (3000, 32, 9, 33), (3000, 128, 5, 16)])
def test_gather_sum_designs_give_the_same_bits(cuda_dev, dist, i, k, r, l):
    """The vec4 and warp designs add each column's terms in l order, so
    they agree bit for bit, with every index on one row, on the Zipf
    head, or spread uniformly."""
    y, idx, _ = _gather_inputs(i, k, r, l, i + k + r + l, cuda_dev)
    if dist == "zero":
        idx.zero_()
    elif dist == "uniform":
        idx = torch.randint(0, i, (r, l), device=cuda_dev, dtype=torch.int32)
    assert gt.design_for(k, y.data_ptr()) == "vec4"
    got = gt.gather_sum_cuda(y, idx)
    warp = gt.gather_sum_cuda(y, idx, design="warp")
    assert torch.equal(got, warp)
    want = gt.gather_sum_reference(y, idx)
    abs_sum = gt.gather_sum_reference(y.abs(), idx)
    sigma = GRAM_SIGMAS * l ** 0.5 * 2.0 ** -24
    assert bool(((got - want).abs() <= sigma * abs_sum).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i,k,r,l", [(3000, 64, 64, 256), (500, 10, 9, 33),
                                     (2000, 200, 4, 64), (3000, 17, 13, 1),
                                     (3000, 63, 3, 4096),
                                     (3000, 128, 2001, 33),
                                     (3000, 65, 11_111, 17)])
def test_gather_gram_matches_reference(cuda_dev, dtype, i, k, r, l):
    y, idx, w = _gather_inputs(i, k, r, l, i + k + r + l, cuda_dev)
    y = y.to(dtype)
    before = (fg.LAUNCHES, fg.GATHER_GRAM_LAUNCHES)
    got = fg.gather_gram(y, idx, w)
    torch.cuda.synchronize()
    assert (fg.LAUNCHES, fg.GATHER_GRAM_LAUNCHES) == \
        (before[0], before[1] + 1)
    want = fg.gather_gram_reference(y, idx, w)
    abs_a = fg.gather_gram_reference(y.abs(), idx, w)
    sigma = GRAM_SIGMAS * l ** 0.5 * 2.0 ** -24
    assert bool(((got - want).abs() <= sigma * abs_a + GRAM_RTOL * want.abs())
                .all())
