"""Top-k ops and the retrieval facade: the PyTorch port vs the JAX reference.

Same numpy inputs through ``predictionio_tpu.ops.topk`` /
``predictionio_tpu.retrieval`` and their ports, on the CPU: scores within
float32 tolerance, the same id sets, the same routing plans under the
same environment, and the same metric families.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.obs import get_registry as jax_registry
from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu.retrieval import Retriever as JaxRetriever
from predictionio_tpu.retrieval import build_ivf as jax_build_ivf
from predictionio_tpu.retrieval import build_pq as jax_build_pq
from predictionio_tpu.retrieval import menu_k as jax_menu_k
from predictionio_tpu_torch.obs import get_registry as port_registry
from predictionio_tpu_torch.ops import topk as ttopk
from predictionio_tpu_torch.retrieval import (
    Retriever,
    build_ivf,
    build_pq,
    menu_k,
)

RTOL = 1e-5   # float32 sums in another order: a few ulps of the score
ATOL = 1e-5

_ROUTING_ENV = ("PIO_RETRIEVAL_RUNG", "PIO_SERVE_HOST_MACS",
                "PIO_SERVE_CHUNK_ABOVE")


@pytest.fixture(autouse=True)
def _clean_routing_env(monkeypatch):
    for name in _ROUTING_ENV:
        monkeypatch.delenv(name, raising=False)


def _data(b=5, n=1000, d=12, seed=0, p_exclude=0.3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    items = rng.standard_normal((n, d)).astype(np.float32)
    excl = rng.random((b, n)) < p_exclude
    return q, items, excl


def _agree(got, want):
    (s, i), (rs, ri) = got, want
    why = ttopk.topk_mismatch(np.asarray(s), np.asarray(i), np.asarray(rs),
                              np.asarray(ri), rtol=RTOL, atol=ATOL)
    assert why is None, why


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("with_exclude", [False, True])
def test_top_k_scores_matches_reference(k, with_exclude):
    q, items, excl = _data()
    e = excl if with_exclude else None
    want = jtopk.top_k_scores(jnp.asarray(q), jnp.asarray(items), k,
                              exclude=None if e is None else jnp.asarray(e))
    s, i = ttopk.top_k_scores(torch.from_numpy(q), torch.from_numpy(items),
                              k, exclude=None if e is None
                              else torch.from_numpy(e))
    assert i.dtype == torch.int32
    _agree((s.numpy(), i.numpy()), want)


@pytest.mark.parametrize("chunk,n_valid,with_exclude", [
    (256, None, False),    # clamped tail window: 1000 = 3*256 + 232
    (256, 900, False),     # n_valid masks trailing padding rows
    (256, 900, True),      # ... and the exclude mask rides chunk by chunk
    (4096, 700, True),     # single-chunk path folds n_valid into exclude
])
def test_chunked_top_k_matches_reference(chunk, n_valid, with_exclude):
    q, items, excl = _data()
    if n_valid is not None:
        items[n_valid:] = 40.0  # poison: must never win once masked
    e = excl if with_exclude else None
    want = jtopk.chunked_top_k(
        jnp.asarray(q), jnp.asarray(items), 10, chunk=chunk,
        n_valid=n_valid, exclude=None if e is None else jnp.asarray(e))
    s, i = ttopk.chunked_top_k(
        torch.from_numpy(q), torch.from_numpy(items), 10, chunk=chunk,
        n_valid=n_valid, exclude=None if e is None else torch.from_numpy(e))
    assert i.dtype == torch.int32
    _agree((s.numpy(), i.numpy()), want)


@pytest.mark.parametrize("k", [0, 7, 1000, 2000])
def test_host_top_k_is_the_reference(k):
    q, items, excl = _data()
    for e in (None, excl):
        rs, ri = jtopk.host_top_k(q, items, k, exclude=e)
        s, i = ttopk.host_top_k(q, items, k, exclude=e)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(i, ri)
        assert i.dtype == np.int32


# -- the retrieval facade ----------------------------------------------------

_N_ROWS, _N_ITEMS, _DIM = 1200, 1100, 12  # rows past n_items are padding


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((_N_ROWS, _DIM)).astype(np.float32)
    vecs[_N_ITEMS:] = 30.0  # padding rows must never be returned
    jax_r = JaxRetriever(jnp.asarray(vecs), n_items=_N_ITEMS, name="parity")
    port_r = Retriever(vecs, n_items=_N_ITEMS, name="parity", device="cpu")
    return rng, vecs, jax_r, port_r


@pytest.fixture(scope="module")
def structured(corpus):
    """The same corpus with an IVF index and PQ codes, each package's
    own build over the real rows."""
    _, vecs, _, _ = corpus
    items = vecs[:_N_ITEMS]
    jivf = jax_build_ivf(items, nlist=12, force=True)
    jpq = jax_build_pq(items, m=4, ivf=jivf)
    tivf = build_ivf(items, nlist=12, force=True)
    tpq = build_pq(items, m=4, ivf=tivf)
    return (JaxRetriever(jnp.asarray(vecs), n_items=_N_ITEMS, ivf=jivf,
                         pq=jpq, name="parity-ivf-pq"),
            Retriever(vecs, n_items=_N_ITEMS, ivf=tivf, pq=tpq,
                      name="parity-ivf-pq", device="cpu"))


@pytest.mark.parametrize("rung", ["host", "device", "chunked"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("num", [5, 10, 100])
@pytest.mark.parametrize("with_exclude", [False, True])
def test_retriever_topk_matches_reference(corpus, monkeypatch, rung, b, num,
                                          with_exclude):
    rng, vecs, jax_r, port_r = corpus
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
    q = rng.standard_normal((b, _DIM)).astype(np.float32)
    excl = (rng.random((b, _N_ITEMS)) < 0.3) if with_exclude else None
    rs, ri, rinfo = jax_r.topk(q, num, exclude=excl)
    s, i, info = port_r.topk(q, num, exclude=excl)
    assert info["rung"] == rinfo["rung"] == rung
    assert info["k"] == rinfo["k"] and s.shape == (b, info["k"])
    assert info["candidates"] == rinfo["candidates"]
    assert i.dtype == np.int32 and int(i.max()) < _N_ITEMS
    _agree((s, i), (rs, ri))
    if excl is not None:
        assert not excl[np.arange(b)[:, None], i].any()


@pytest.mark.parametrize("env", [
    {}, {"PIO_RETRIEVAL_RUNG": "chunked"}, {"PIO_RETRIEVAL_RUNG": "device"},
    {"PIO_RETRIEVAL_RUNG": "ivf"}, {"PIO_RETRIEVAL_RUNG": "ivf_pq"},
    {"PIO_RETRIEVAL_RUNG": "pq_flat"}, {"PIO_RETRIEVAL_RUNG": "sharded"},
    {"PIO_RETRIEVAL_RUNG": "bogus"}, {"PIO_SERVE_HOST_MACS": "0"},
    {"PIO_SERVE_HOST_MACS": "0", "PIO_SERVE_CHUNK_ABOVE": "1000"},
])
def test_plan_and_menu_agree_with_reference(corpus, structured, monkeypatch,
                                            env):
    """Each environment against the plain corpus and against the same
    corpus carrying an IVF index and PQ codes."""
    _, _, jax_r, port_r = corpus
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for jr, pr in ((jax_r, port_r), structured):
        for b in (1, 3, 64):
            for num in (0, 1, 7, 100, 5000):
                assert menu_k(num, _N_ITEMS) == jax_menu_k(num, _N_ITEMS)
                for has_exclude in (False, True):
                    want = jr.plan(b, num, has_exclude=has_exclude)
                    got = pr.plan(b, num, has_exclude=has_exclude)
                    assert (got.rung, got.k, got.nprobe, got.rerank) == \
                        (want.rung, want.k, want.nprobe, want.rerank), \
                        (pr.name, env, b, num, has_exclude)


def test_large_catalog_routes_to_chunked_by_default():
    """The reference's thresholds: > 2,000,000 items and > 2e8 MACs."""
    vecs = np.zeros((1, 64), np.float32)
    r = Retriever(vecs, n_items=4_194_304, device="cpu")
    assert r.plan(1, 10).rung == "chunked"
    assert r.plan(1, 10, has_exclude=True).rung == "chunked"
    ml25m = Retriever(vecs, n_items=59_047, device="cpu")
    assert ml25m.plan(1, 10).rung == "host"
    assert ml25m.plan(64, 10).rung == "device"   # 64*59,047*64 > 2e8


def test_metric_families_match_reference(corpus):
    _, _, _, _ = corpus  # both retrievers registered their families
    jax_reg, port_reg = jax_registry(), port_registry()
    for name in ("pio_retrieval_requests_total",
                 "pio_retrieval_candidates_total", "pio_retrieval_ms"):
        want, got = jax_reg.get(name), port_reg.get(name)
        assert got is not None and want is not None
        assert (got.kind, got.labelnames, got.help) == \
            (want.kind, want.labelnames, want.help)
        if got.kind == "histogram":
            assert got.buckets == want.buckets


def test_retriever_refuses_unported_structures():
    """An IVF index and PQ codes are accepted now; a structure is refused
    (dropped, counted, serving exact) only when its fingerprint does not
    match the served corpus.  A forced ``sharded`` on a corpus that is
    not mesh-sharded serves exact-device, as the reference does."""
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((600, 8)).astype(np.float32)
    ivf = build_ivf(vecs, nlist=6, force=True)
    pq = build_pq(vecs, m=2, ivf=ivf)
    r = Retriever(vecs, ivf=ivf, pq=pq, name="accepts", device="cpu")
    assert r.ivf_index() is ivf and r.pq_codebook() is pq
    assert r.plan(1, 10).rung == "ivf_pq"
    stale = Retriever(vecs + 1.0, ivf=ivf, pq=pq, name="refuses",
                      device="cpu")
    assert stale.ivf_index() is None and stale.pq_codebook() is None
    assert stale.plan(1, 10).rung == "host"
    reg = port_registry()
    assert reg.get("pio_retrieval_ivf_rejected_total").value(
        corpus="refuses") == 1.0
    assert reg.get("pio_retrieval_pq_rejected_total").value(
        corpus="accepts") == 0.0


def test_retriever_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Retriever(np.zeros((10, 4), np.float32))
