"""The gather experiments' kernels (T1, T2): plain versions vs the JAX package.

``tools/exp_gram.py`` and ``tools/exp_gather2.py`` build their full-size
arrays at import, so they are not imported here; their functions are
held against the reference's own spellings at small shapes, on the CPU:

- T2 (``pallas_gather``: ``out[r] = Σ_l y[idx[r, l]]``):
  ``ops.gather.gather_sum_reference`` against ``jnp`` indexing and a sum
  — the Pallas kernel keeps its indices in SMEM and does not run on the
  CPU.
- T1 (``pallas_vmem_gather_gram``: ``_gk`` computes ``(y[idx]·w)ᵀ
  y[idx]``): ``ops.fused_gram.gather_gram_reference`` against the
  reference's ``fused_gram_vector_xla`` on the gathered block, whose
  ``A`` is that function.

Tolerance: float32 sums of the same terms in another order, rtol 1e-5
and an absolute 1e-5 × the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import fused_gram_vector_xla
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.ops import gather as gt

RTOL = 1e-5
ATOL = 1e-5   # × max |want|


def _inputs(i, k, r, l, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((i, k)).astype(np.float32)
    idx = (rng.zipf(1.25, size=(r, l)) % i).astype(np.int32)
    w = rng.random((r, l)).astype(np.float32)
    return y, idx, w


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("i,k,r,l", [(597, 64, 24, 256), (50, 7, 3, 33),
                                     (1000, 130, 5, 1), (9, 1, 4, 64)])
def test_gather_sum_plain_matches_jnp(i, k, r, l):
    y, idx, _ = _inputs(i, k, r, l, i + k)
    want = np.asarray(jnp.sum(jnp.asarray(y)[jnp.asarray(idx)], axis=1))
    before = gt.LAUNCHES
    got = gt.gather_sum(torch.from_numpy(y), torch.from_numpy(idx))
    assert gt.LAUNCHES == before          # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (r, k)
    _close(got.numpy(), want)


@pytest.mark.parametrize("i,k,r,l", [(597, 64, 16, 256), (50, 10, 3, 33),
                                     (300, 200, 2, 40)])
def test_gather_gram_plain_matches_fused_gram_vector_xla(i, k, r, l):
    y, idx, w = _inputs(i, k, r, l, i + k)
    want_a, _ = fused_gram_vector_xla(jnp.asarray(y[idx]), jnp.asarray(w),
                                      jnp.zeros((r, l), jnp.float32))
    before = (fg.LAUNCHES, fg.GATHER_GRAM_LAUNCHES)
    got = fg.gather_gram(torch.from_numpy(y), torch.from_numpy(idx),
                         torch.from_numpy(w))
    assert (fg.LAUNCHES, fg.GATHER_GRAM_LAUNCHES) == before
    assert got.shape == (r, k, k)
    _close(got.numpy(), np.asarray(want_a))
    # T1 is K1's A: the same function as the training kernel's plain half
    a, _ = fg.fused_gram_vector_reference(
        torch.from_numpy(y), torch.from_numpy(idx), torch.from_numpy(w),
        torch.zeros((r, l)))
    np.testing.assert_array_equal(got.numpy(), a.numpy())


def test_gather_wrappers_never_fall_back_on_cpu_tensors():
    y, idx, w = (torch.from_numpy(a) for a in _inputs(20, 8, 2, 4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        gt.gather_sum_cuda(y, idx)
    with pytest.raises(ValueError, match="CUDA"):
        fg.gather_gram_cuda(y, idx, w)
