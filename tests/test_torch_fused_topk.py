"""Fused top-k (K3) in the PyTorch port against the JAX reference.

The port's plain version (``fused_topk_reference``) against the Pallas
kernel in interpret mode, the dispatcher's edge contract, the launch
plan's geometry, and the no-fallback rules.  The CUDA kernel itself is
held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import fused_topk_pallas
from predictionio_tpu_torch import device as port_device
from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.ops.topk import topk_mismatch

RTOL = 1e-5   # float32 sums in another order: a few ulps of the score
ATOL = 1e-5


def _inputs(b=3, n=700, d=16, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    items = rng.standard_normal((n, d)).astype(np.float32)
    return q, items


def _assert_topk_matches(s, i, ref_s, ref_i):
    assert topk_mismatch(s, i, ref_s, ref_i, rtol=RTOL, atol=ATOL) is None


@pytest.mark.parametrize("k", [1, 10, 100])
def test_reference_matches_pallas_interpret(k):
    q, items = _inputs()
    ps, pi = fused_topk_pallas(jnp.asarray(q), jnp.asarray(items), k,
                               tile=256, interpret=True)
    s, i = ft.fused_topk_reference(torch.from_numpy(q),
                                   torch.from_numpy(items), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    _assert_topk_matches(s.numpy(), i.numpy(), np.asarray(ps),
                         np.asarray(pi))
    print(f"k={k}: max |score - Pallas score| "
          f"{np.max(np.abs(s.numpy() - np.asarray(ps))):.3g}")


def test_reference_n_valid_tail_matches_pallas():
    """Poisoned rows past n_valid (and a corpus that is not a tile
    multiple) never win a slot, in the port as in the reference."""
    q, items = _inputs(n=600)
    items[500:] = 50.0
    ps, pi = fused_topk_pallas(jnp.asarray(q), jnp.asarray(items), 8,
                               tile=256, n_valid=500, interpret=True)
    s, i = ft.fused_topk_reference(torch.from_numpy(q),
                                   torch.from_numpy(items), 8, n_valid=500)
    assert int(i.max()) < 500
    _assert_topk_matches(s.numpy(), i.numpy(), np.asarray(ps),
                         np.asarray(pi))


def test_dispatcher_edges_on_cpu():
    q, items = _inputs(n=300)
    qt, it = torch.from_numpy(q), torch.from_numpy(items)
    s0, i0 = ft.fused_topk(qt, it, 0)
    assert s0.shape == (3, 0) and i0.shape == (3, 0)
    assert s0.dtype == torch.float32 and i0.dtype == torch.int32
    s, i = ft.fused_topk(qt, it, 1000)           # clamped to N
    assert s.shape == (3, 300)
    assert sorted(i[0].tolist()) == list(range(300))


def test_dispatcher_cpu_takes_reference_and_counts_no_launch():
    q, items = _inputs(n=300)
    before = ft.LAUNCHES
    s, i = ft.fused_topk(torch.from_numpy(q), torch.from_numpy(items), 7)
    assert ft.LAUNCHES == before == 0
    rs, ri = ft.fused_topk_reference(torch.from_numpy(q),
                                     torch.from_numpy(items), 7)
    assert torch.equal(s, rs) and torch.equal(i, ri)


def test_cuda_wrapper_never_falls_back_on_cpu_tensors():
    q, items = _inputs(n=300)
    with pytest.raises(ValueError, match="CUDA"):
        ft.fused_topk_cuda(torch.from_numpy(q), torch.from_numpy(items), 7)


def test_device_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.device("cuda")
    assert port_device.device("cpu") == torch.device("cpu")


def test_set_float32_precision_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    port_device.set_float32_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("b,n,d,k", [
    (1, 59_047, 64, 10), (8, 59_047, 64, 100), (64, 59_047, 64, 1000),
    (1, 4_194_304, 64, 10), (64, 4_194_304, 64, 10),
    (64, 4_194_304, 64, 1000), (3, 700, 10, 1), (1, 0, 8, 5),
    (5, 100_000, 16, 4000),
    # the tiled route's edges: B around the crossover (D 10) and a
    # 64-query block, D 10 and 64 at k 10/100/1000, N below one chunk
    # and no tile multiple, k at and past a tiled block's limit, D too
    # wide for two staged tiles
    (ft.TILED_MIN_BATCH - 1, 59_047, 10, 10),
    (ft.TILED_MIN_BATCH, 59_047, 10, 10),
    (ft.TILED_MIN_BATCH + 1, 59_047, 10, 10),
    (63, 59_047, 64, 10), (65, 59_047, 64, 10), (128, 4_194_304, 64, 10),
    (64, 59_047, 10, 10), (64, 59_047, 10, 100), (64, 59_047, 10, 1000),
    (64, 59_047, 64, 100), (64, 4_194_304, 10, 1000), (64, 1000, 64, 10),
    (64, 100_003, 64, 10), (32, 0, 64, 10), (64, 59_047, 64, 4000),
    (64, 59_047, 64, 1024), (64, 59_047, 64, 1025), (16, 59_047, 256, 10),
])
def test_plan_geometry(b, n, d, k):
    """The launch plan covers every row exactly once and stays inside the
    shared-memory and merge-pass budgets.  The small-B route keeps a
    power-of-two buffer with a full tile of headroom over k; the tiled
    route (B at or above the crossover) a power-of-two buffer of at
    least 2k, one of its compiled block sizes, and whole tiles a chunk."""
    p = ft.plan(b, n, d, k)
    assert p.buffer & (p.buffer - 1) == 0
    assert p.merge_buffer & (p.merge_buffer - 1) == 0
    assert p.merge_buffer >= k + ft.THREADS
    assert p.queries_per_block >= 1
    if p.tiled:
        assert d % 4 == 0 or b >= ft.TILED_MIN_BATCH
        assert p.queries_per_block in ft.TILED_QUERIES
        assert p.buffer >= 2 * k
        assert ft.tiled_smem_bytes(p.queries_per_block, d,
                                   p.buffer) <= ft.SMEM_BUDGET
        assert p.rows_per_chunk % ft.TILE_ROWS == 0
    else:
        assert p.buffer >= k + ft.THREADS
        assert 1 <= p.queries_per_block <= ft.MAX_QUERIES_PER_BLOCK
        assert p.queries_per_block * (p.buffer * 8 + d * 4) \
            <= ft.SMEM_BUDGET
        assert p.rows_per_chunk % ft.THREADS == 0
    assert p.n_chunks * p.rows_per_chunk >= n
    assert (p.n_chunks - 1) * p.rows_per_chunk < max(n, 1)
    assert p.n_chunks * k <= max(ft.MAX_CANDIDATES, k)


@pytest.mark.parametrize("d", [10, 64])
@pytest.mark.parametrize("k", [10, 100, 1000])
def test_plan_switches_route_at_the_crossover(d, k):
    """Rows of whole float4s take the tiled route at every B; other rows
    take it from ``TILED_MIN_BATCH`` on, the small-B route below.  Larger
    k takes fewer queries a block, never more."""
    below = ft.plan(ft.TILED_MIN_BATCH - 1, 59_047, d, k)
    at = ft.plan(ft.TILED_MIN_BATCH, 59_047, d, k)
    assert below.tiled == (d % 4 == 0) and at.tiled
    assert ft.plan(1, 59_047, d, k).tiled == (d % 4 == 0)
    full = [ft.plan(64, 59_047, d, kk).queries_per_block
            for kk in (10, 100, 1000)]
    assert full == sorted(full, reverse=True) and full[0] == 64


@pytest.mark.parametrize("b,n,d,k", [(64, 59_047, 64, 1025),
                                     (16, 59_047, 256, 10),
                                     (1, 4_194_304, 64, 2000)])
def test_plan_takes_the_small_route_where_no_tiled_block_fits(b, n, d, k):
    """Past a tiled block's shared memory (k > 1,024 at D 64, or D 256)
    the plan takes the small-B route, whatever B."""
    assert ft.tiled_plan(b, n, d, k) is None
    assert ft.plan(b, n, d, k) == ft.small_plan(b, n, d, k)


def test_tiled_smem_bytes_counts_every_array():
    """QB 64, D 64, 32 slots: two stages of 128 rows of 68 floats, the
    64 x 64 queries, 64 x (32 + 9) candidate slots, three counters."""
    assert ft.tiled_smem_bytes(64, 64, 32) == (
        2 * 128 * 68 * 4 + 64 * 64 * 4 + 64 * 41 * 8 + 64 * 12)
    # D 10: rows padded to 12 floats, three float4s, already odd
    assert ft.tiled_smem_bytes(8, 10, 32) == (
        2 * 128 * 12 * 4 + 8 * 12 * 4 + 8 * 41 * 8 + 8 * 12)


def test_plan_rejects_k_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ft.plan(1, 10 ** 6, 64, 30_000)


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """K3 and K5 share csrc/topk_select.cuh: editing the header must give
    both libraries new names (so they rebuild) and leave the others'."""
    import shutil

    from predictionio_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = sorted(_build.sources())
    assert {"fused_topk", "pq_scan", "gather_sum"} <= set(names)
    before = {n: _build.library_path(n) for n in names}
    header = csrc / "topk_select.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    changed = {n for n in names if after[n] != before[n]}
    assert changed == {"fused_topk", "pq_scan"}
