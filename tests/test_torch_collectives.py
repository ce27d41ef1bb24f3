"""The port's shard collectives against JAX's inside the reference's
``shard_map``: ``ppermute``, ``psum_scatter`` (tiled) and ``all_to_all``
(tiled, any ``split_dim`` / ``concat_dim``) on the 8 virtual CPU devices
of ``tests/conftest.py`` and on 8 CPU positions of the port.  The same
seeded numpy blocks go into both; the results are equal exactly (a
rotation, a split and a concatenation move bits; ``psum_scatter`` adds
8 float32 blocks, in shard order in the port, within 1e-6 of XLA's
order).  Each collective is differentiable in one process; across
processes (``tests/test_torch_gang_collectives.py``) it needs the gang
to split the mesh's first axis, and refuses another layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from predictionio_tpu.parallel.compat import shard_map as jax_shard_map
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from predictionio_tpu_torch.parallel.compat import (
    all_to_all,
    axis_lane,
    lane_outputs,
    ppermute,
    psum,
    psum_scatter,
    shard_map,
)
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    PartitionSpec,
    make_mesh,
)

N = 8
SUM_ATOL = 1e-6


def _blocks(shape, seed=0):
    """N seeded blocks of ``shape`` (numpy) and their concatenation."""
    rng = np.random.default_rng(seed)
    blocks = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(N)]
    return blocks, np.concatenate(blocks, axis=0)


def _jax(fn, whole):
    """``fn`` of each shard's block inside the reference's shard_map over
    ``data`` (8 devices); returns the blocks it gives back, in order."""
    mesh = jax_make_mesh({"data": N})
    out = jax_shard_map(fn, mesh=mesh, in_specs=JP("data"),
                        out_specs=JP("data"))(jnp.asarray(whole))
    return np.split(np.asarray(out), N, axis=0)


def _parts(blocks):
    return [torch.from_numpy(b.copy()) for b in blocks]


@pytest.mark.parametrize("shift", [1, 3])
def test_ppermute_equals_lax_ppermute(shift):
    blocks, whole = _blocks((2, 5))
    perm = [(i, (i + shift) % N) for i in range(N)]
    want = _jax(lambda x: jax.lax.ppermute(x, "data", perm), whole)
    got = ppermute(_parts(blocks), perm=perm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_ppermute_gives_zeros_where_no_pair_sends():
    blocks, whole = _blocks((2, 3), seed=1)
    perm = [(0, 1), (1, 2)]
    want = _jax(lambda x: jax.lax.ppermute(x, "data", perm), whole)
    got = ppermute(_parts(blocks), perm=perm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="permutation"):
        ppermute(_parts(blocks), perm=[(0, 1), (2, 1)])


@pytest.mark.parametrize("dim", [0, 1])
def test_psum_scatter_equals_lax_psum_scatter(dim):
    blocks, whole = _blocks((N * 2, N * 3), seed=2)
    want = _jax(lambda x: jax.lax.psum_scatter(
        x, "data", scatter_dimension=dim, tiled=True), whole)
    got = psum_scatter(_parts(blocks), dim=dim)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=SUM_ATOL)
    # shard order: shard j's piece is the running sum in shard order
    j = 5
    acc = np.zeros_like(np.split(blocks[0], N, axis=dim)[j])
    for b in blocks:
        acc = acc + np.split(b, N, axis=dim)[j]
    np.testing.assert_array_equal(got[j].numpy(), acc)


@pytest.mark.parametrize("split,concat", [(0, 0), (2, 1), (1, 2)])
def test_all_to_all_equals_lax_all_to_all(split, concat):
    blocks, whole = _blocks((N, N * 2, N, 3), seed=3)
    want = _jax(lambda x: jax.lax.all_to_all(
        x, "data", split_axis=split, concat_axis=concat, tiled=True), whole)
    got = all_to_all(_parts(blocks), split_dim=split, concat_dim=concat)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_collectives_are_differentiable_in_one_process():
    blocks, _ = _blocks((N, N), seed=4)
    leaves = [torch.from_numpy(b).requires_grad_(True) for b in blocks]
    perm = [(i, (i + 1) % N) for i in range(N)]
    total = sum((p * (k + 1)).sum() for k, p in enumerate(
        ppermute(leaves, perm=perm)))
    total = total + sum(p.sum() for p in psum_scatter(leaves))
    total = total + sum((p ** 2).sum() for p in all_to_all(
        leaves, split_dim=1, concat_dim=0))
    total = total + psum(leaves).sum()
    total.backward()
    for src, leaf in enumerate(leaves):
        dst = (src + 1) % N
        want = (dst + 1) + 1 + 2 * blocks[src] + 1
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-6)


def test_a_collective_across_processes_refuses_gradients():
    """Across processes a collective with gradients runs on a gang that
    splits the mesh's first axis in order
    (``tests/test_torch_gang_collectives.py``); on another layout (here
    the processes in reverse order) it refuses before any exchange."""
    cpu = torch.device("cpu")
    two = Mesh(np.array([cpu, cpu], dtype=object), ("data",),
               np.array([1, 0]))
    part = torch.ones(2, 2, requires_grad=True)
    for fn in (lambda: psum([part], two),
               lambda: psum_scatter([part], two),
               lambda: ppermute([part], two, perm=[(0, 1), (1, 0)]),
               lambda: all_to_all([part], two)):
        with pytest.raises(ValueError, match="first axis"):
            fn()


def test_shard_map_stages_with_a_collective_between_them():
    """The port's idiom for a reference body with a collective inside:
    a shard_map stage, the collective on the lane's outputs, another
    stage — equal to the reference's one body."""
    blocks, whole = _blocks((2, 6), seed=5)
    mesh = make_mesh({"data": N}, device="cpu")
    first = shard_map(lambda ax, x: x * (ax("data") + 1), mesh=mesh,
                      in_specs=PartitionSpec("data"),
                      out_specs=None)(torch.from_numpy(whole))
    moved = ppermute(lane_outputs(first, mesh, "data"),
                     perm=[(i, (i + 1) % N) for i in range(N)])
    got = [m + 1.0 for m in moved]

    def body(x):
        i = jax.lax.axis_index("data")
        y = jax.lax.ppermute(x * (i + 1), "data",
                             [(k, (k + 1) % N) for k in range(N)])
        return y + 1.0

    for g, w in zip(got, _jax(body, whole)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert axis_lane(mesh, "data") == list(range(N))
