"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc (the kernels have no CPU
mode) and skips without them.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,l,k", [(1, 8, 3), (8, 8, 10), (8, 64, 64),
                                   (37, 1000, 64), (8, 4096, 128),
                                   (300, 200, 17), (5, 33, 100),
                                   (16, 1000, 129), (7, 300, 200),
                                   (3, 64, 256)])
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


def _spd(b, k, seed, dev):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, 2 * k, k)).astype(np.float32)
    a = torch.from_numpy(np.einsum("blk,blm->bkm", y, y).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    reg = torch.from_numpy((0.05 * rng.integers(1, 40, b)).astype(np.float32))
    return a.to(dev), rhs.to(dev), reg.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lu", "gj"])
@pytest.mark.parametrize("b,k", [(1, 10), (127, 64), (128, 8), (131, 128),
                                 (5000, 64), (3, 33)])
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
    with pytest.raises(ValueError, match="use_pallas=False"):
        port_als.train_als(users, items, ratings, n_users, n_items,
                           port_als.ALSConfig(rank=16, use_pallas=False),
                           device=cuda_dev)
    # the plain versions run on the CPU (and Cholesky solves there)
    plain = port_als.train_als(users, items, ratings, n_users, n_items, cfg,
                               device="cpu")
    np.testing.assert_allclose(got.user_factors, plain.user_factors,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, plain.item_factors,
                               rtol=1e-3, atol=1e-4)


def _pq_inputs(b, s, n, seed, dev):
    rng = np.random.default_rng(seed)
    luts = torch.from_numpy(
        rng.standard_normal((b, s, 256)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(
        rng.integers(0, 256, (s, n)).astype(np.uint8)).to(dev)
    return luts, codes


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n,k,n_valid", [
    (1, 17, 100_003, 40, None), (3, 1, 511, 10, None), (8, 5, 1, 1, None),
    (9, 17, 20_000, 1000, 19_000), (64, 33, 5000, 40, None),
    (2, 65, 12_000, 4000, None), (5, 65, 3000, 300, 2999),
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
    the kernel ranks the lower id first.  Fewer valid items than k: the
    tail slots read NEG_INF / -1."""
    luts, codes = _pq_inputs(2, 1, 3000, 1, cuda_dev)
    s, i = pqs.pq_scan_cuda(luts, codes, 3000)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    for row in range(2):
        assert sorted(i[row].tolist()) == list(range(3000))
        key = np.lexsort((i[row], -s[row]))
        assert (key == np.arange(3000)).all()
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
                                     (2000, 255, 5, 64)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i,k,r,l", [(3000, 64, 64, 256), (500, 10, 9, 33),
                                     (2000, 200, 4, 64)])
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
