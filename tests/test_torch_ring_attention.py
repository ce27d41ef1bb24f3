"""The port's ring and Ulysses attention against the reference's
(``predictionio_tpu/parallel/ring.py``; ``tests/test_ring_attention.py``).

The reference runs on its ``sequence=8`` mesh of the 8 virtual CPU
devices of ``tests/conftest.py``, the port on a ``sequence=8`` mesh of 8
CPU positions; both take the same seeded numpy Q/K/V ``[B, S, H, D]``.
Tolerances: outputs within 1e-5 of the reference's (the same float32
einsums and online softmax, another order of float32 sums); gradients
of a sum of squares within 1e-5 of ``jax.grad``'s; the reference's own
bounds against plain attention (rtol 2e-4, atol 2e-5) hold for the port
too.  The first token of a causal ring attends to itself only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import ring as ref
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from predictionio_tpu_torch.parallel import (
    local_attention,
    make_mesh,
    ring_attention,
    ulysses_attention,
)

ATOL = 1e-5
GRAD_ATOL = 1e-5


def _qkv(seed=0, b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh({"sequence": 8}),
            make_mesh({"sequence": 8}, device="cpu"))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_the_reference(meshes, causal):
    jmesh, mesh = meshes
    qkv = _qkv()
    want = np.asarray(ref.ring_attention(*map(jnp.asarray, qkv), jmesh,
                                         causal=causal))
    got = ring_attention(*_t(qkv), mesh, causal=causal)
    assert tuple(got.spec) == (None, "sequence")
    np.testing.assert_allclose(got.full().numpy(), want, rtol=0, atol=ATOL)
    full = local_attention(*_t(qkv), causal=causal).numpy()
    np.testing.assert_allclose(got.full().numpy(), full, rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_reference(meshes, causal):
    jmesh, mesh = meshes
    qkv = _qkv(seed=1, h=8)
    want = np.asarray(ref.ulysses_attention(*map(jnp.asarray, qkv), jmesh,
                                            causal=causal))
    got = ulysses_attention(*_t(qkv), mesh, causal=causal).full().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_matches_the_reference(causal):
    qkv = _qkv(seed=4)
    want = np.asarray(ref.local_attention(*map(jnp.asarray, qkv),
                                          causal=causal, q_offset=3,
                                          k_offset=1))
    got = local_attention(*_t(qkv), causal=causal, q_offset=3, k_offset=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_gradients_match_jax_grad(meshes, kind):
    jmesh, mesh = meshes
    qkv = _qkv(seed=2, s=16, h=8)
    jfn = {"ring": ref.ring_attention, "ulysses": ref.ulysses_attention}[kind]
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[kind]
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, jmesh) ** 2),
                    argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    leaves = [t.requires_grad_(True) for t in _t(qkv)]
    (fn(*leaves, mesh).full() ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_ATOL)


def test_causal_first_token_attends_self_only(meshes):
    _, mesh = meshes
    q, k, v = _t(_qkv(seed=3))
    out = ring_attention(q, k, v, mesh, causal=True).full()
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_other_axes_replicate_the_sequence_blocks():
    """On ``data=2 x sequence=4`` the ring runs along ``sequence``; the
    positions of the other axis share their lane's block."""
    mesh = make_mesh({"data": 2, "sequence": 4}, device="cpu")
    q, k, v = _t(_qkv(seed=5))
    out = ring_attention(q, k, v, mesh, causal=True)
    assert out.shards[0] is out.shards[4]
    np.testing.assert_allclose(
        out.full().numpy(), local_attention(q, k, v, causal=True).numpy(),
        rtol=2e-4, atol=2e-5)


def test_the_reference_asserts_hold():
    mesh = make_mesh({"sequence": 8}, device="cpu")
    q = torch.zeros(1, 12, 8, 4)
    with pytest.raises(AssertionError, match="pad sequence"):
        ring_attention(q, q, q, mesh)
    q = torch.zeros(1, 16, 4, 4)
    with pytest.raises(AssertionError, match="heads"):
        ulysses_attention(q, q, q, mesh)
