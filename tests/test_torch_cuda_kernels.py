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
from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.ops.topk import topk_mismatch

RTOL = 1e-5   # float32 sums in another order: a few ulps of the score
ATOL = 1e-5


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
