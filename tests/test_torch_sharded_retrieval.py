"""The mesh-sharded exact rung: ``ops.topk.sharded_top_k`` and the
``sharded`` rung of the ``Retriever``, in the port against the reference.

The reference shards its corpus over its own mesh of the 8 virtual CPU
devices (``tests/conftest.py``); the port over a CPU mesh of as many
shards.  Each shard of the port scores its rows with ``fused_topk`` (K3
on the card, its plain version here).  Scores agree within rtol 1e-5;
ids are equal, or equal as sets where scores tie.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.ops.topk import NEG_INF, sharded_top_k, topk_mismatch
from predictionio_tpu_torch.parallel.mesh import (
    PartitionSpec,
    make_mesh,
    put_sharded,
)
from predictionio_tpu_torch.retrieval import Retriever

RTOL = 1e-5


def _corpus(n=320, d=16, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _ref_sharded(q, items, shards, k, n_valid=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from predictionio_tpu.ops.topk import sharded_top_k as ref
    from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh

    mesh = jmake_mesh({"data": shards})
    it = jax.device_put(jnp.asarray(items), NamedSharding(mesh, P("data")))
    s, i = ref(mesh, "data", jnp.asarray(q), it, k, n_valid=n_valid)
    return np.asarray(s), np.asarray(i)


def _port_sharded(q, items, shards, k, n_valid=None):
    mesh = make_mesh({"data": shards}, device="cpu")
    it = put_sharded(items, mesh, PartitionSpec("data"))
    s, i = sharded_top_k(mesh, "data", torch.from_numpy(q), it, k,
                         n_valid=n_valid)
    return s.numpy(), i.numpy()


def _agree(got, want, q, items, n_valid=None):
    """topk_mismatch with the (k+1)-th exact score as the tie edge."""
    scores = q @ items.T
    if n_valid is not None:
        scores[:, n_valid:] = NEG_INF
    k = want[0].shape[1]
    edge = -np.sort(-scores, axis=1)[:, k] if k < scores.shape[1] else None
    return topk_mismatch(*got, *want, edge, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_top_k_matches_the_reference(shards):
    q, items = _corpus()
    got = _port_sharded(q, items, shards, 10)
    assert got[1].dtype == np.int32 and got[0].shape == (4, 10)
    assert _agree(got, _ref_sharded(q, items, shards, 10), q, items) is None
    meshless = ft.fused_topk(torch.from_numpy(q), torch.from_numpy(items), 10)
    assert _agree(got, tuple(t.numpy() for t in meshless), q, items) is None


@pytest.mark.parametrize("shards", [2, 8])
def test_tail_padded_corpus_masks_the_padding(shards):
    q, items = _corpus(n=304)
    items[301:] = 0.0         # the host pad of a 301-item corpus
    got = _port_sharded(q, items, shards, 20, n_valid=301)
    assert int(got[1].max()) < 301
    want = _ref_sharded(q, items, shards, 20, n_valid=301)
    assert _agree(got, want, q, items, n_valid=301) is None


def test_k_at_least_a_shards_rows():
    """k above a shard's rows: the local top-k takes the whole shard and
    the merge stays globally exact (reference: ``min(k, per)``)."""
    q, items = _corpus(n=32)
    got = _port_sharded(q, items, 8, 10)    # 4 rows a shard
    want = _ref_sharded(q, items, 8, 10)
    assert _agree(got, want, q, items) is None


def test_a_masked_slot_never_becomes_a_real_id(monkeypatch):
    """K3 gives id -1 to a slot its shard cannot fill; the offset must
    leave it -1, so a fully padded shard adds no id of another shard."""
    real = ft.fused_topk

    def like_the_kernel(queries, items, k, *, n_valid=None):
        s, i = real(queries, items, k, n_valid=n_valid)
        return s, torch.where(s <= NEG_INF, torch.full_like(i, -1), i)

    monkeypatch.setattr(ft, "fused_topk", like_the_kernel)
    q, items = _corpus(n=64)
    s, i = _port_sharded(q, items, 8, 12, n_valid=10)   # 8 rows a shard
    assert set(i[:, :10].ravel().tolist()) <= set(range(10))
    assert (i[:, 10:] == -1).all() and (s[:, 10:] <= NEG_INF).all()


def test_equal_scores_rank_the_lower_id_first(monkeypatch):
    """The merge is a stable sort of the candidates in shard order, so
    exact ties keep K3's order — the lower id first — across shards
    (stood in for here by a stable sort of each shard's scores)."""
    def like_the_kernel(queries, items, k, *, n_valid=None):
        scores = queries @ items.T
        s, i = torch.sort(scores, dim=1, descending=True, stable=True)
        return s[:, :k], i[:, :k].to(torch.int32)

    monkeypatch.setattr(ft, "fused_topk", like_the_kernel)
    q = np.ones((2, 4), np.float32)
    items = np.tile(np.eye(4, dtype=np.float32), (8, 1))   # 32 rows
    s, i = _port_sharded(q, items, 4, 6)
    np.testing.assert_array_equal(s, np.ones((2, 6), np.float32))
    assert (np.diff(i, axis=1) > 0).all()


# -- the sharded rung ------------------------------------------------------------

def _sharded_retrievers(items, shards, monkeypatch, n_items=None):
    from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh
    from predictionio_tpu.retrieval import Retriever as RefRetriever

    monkeypatch.setenv("PIO_SERVE_SHARD_ABOVE", "1")
    monkeypatch.setenv("PIO_SERVE_HOST_MACS", "1")
    r = Retriever(items, n_items=n_items, name=f"t-sh{shards}",
                  device="cpu")
    assert r.maybe_shard(make_mesh({"data": shards}, device="cpu"))
    assert r.sharded
    ref = RefRetriever(items, n_items=n_items, name=f"t-sh{shards}")
    assert ref.maybe_shard(jmake_mesh({"data": shards}))
    return r, ref


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_the_sharded_rung_matches_the_reference(shards, monkeypatch):
    q, items = _corpus()
    r, ref = _sharded_retrievers(items, shards, monkeypatch)
    assert r.plan(4, 10).rung == ref.plan(4, 10).rung == "sharded"
    s, i, info = r.topk(q, 10)
    assert info["rung"] == "sharded" and info["candidates"] == 4 * 320
    rs, ri, _ = ref.topk(q, 10)
    assert _agree((s, i), (rs, ri), q, items) is None


def test_the_sharded_rung_pads_a_corpus_that_does_not_divide(monkeypatch):
    q, items = _corpus(n=301)
    r, ref = _sharded_retrievers(items, 8, monkeypatch)
    assert r.vecs.shape[0] == ref.vecs.shape[0] == 304
    s, i, _ = r.topk(q, 20)            # the menu pads k to 100
    assert int(i.max()) < 301
    rs, ri, _ = ref.topk(q, 20)
    assert _agree((s, i), (rs, ri), q, items) is None
    np.testing.assert_array_equal(r.host_vecs(), items)


def test_the_sharded_rung_with_k_past_a_shards_rows(monkeypatch):
    q, items = _corpus(n=32)
    r, ref = _sharded_retrievers(items, 8, monkeypatch)   # 4 rows a shard
    s, i, _ = r.topk(q, 8)
    rs, ri, _ = ref.topk(q, 8)
    assert _agree((s, i), (rs, ri), q, items) is None


def test_below_the_threshold_nothing_shards(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_SHARD_ABOVE", "1000000")
    _, items = _corpus()
    r = Retriever(items, name="t-noshard", device="cpu")
    assert not r.maybe_shard(make_mesh({"data": 2}, device="cpu"))
    assert not r.sharded and r.vecs is items
    assert not r.maybe_shard(None)


def test_forced_sharded_without_a_mesh_serves_exact_device(monkeypatch,
                                                           caplog):
    from predictionio_tpu.retrieval import Retriever as RefRetriever

    q, items = _corpus()
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", "sharded")
    r = Retriever(items, name="t-force", device="cpu")
    with caplog.at_level("WARNING"):
        assert r.plan(1, 10).rung == "device"
    assert "is not mesh-sharded" in caplog.text
    assert RefRetriever(items, name="t-force").plan(1, 10).rung == "device"
    s, i, info = r.topk(q, 10)
    assert info["rung"] == "device"


def test_an_exclude_mask_keeps_a_sharded_corpus_exact(monkeypatch):
    q, items = _corpus()
    r, _ = _sharded_retrievers(items, 4, monkeypatch)
    excl = np.zeros((4, 320), dtype=bool)
    excl[:, :5] = True
    assert r.plan(4, 10, has_exclude=True).rung != "sharded"
    _, i, info = r.topk(q, 10, exclude=excl)
    assert info["rung"] in ("host", "device", "chunked")
    assert int(i.min()) >= 5


def test_vecs_is_the_staged_corpus():
    """``Retriever.vecs`` (item 15): the array backing retrieval, as
    the reference's property gives it."""
    from predictionio_tpu.retrieval import Retriever as RefRetriever

    _, items = _corpus()
    assert Retriever(items, name="t-v", device="cpu").vecs is items
    assert np.asarray(RefRetriever(items, name="t-v").vecs).shape \
        == items.shape
