"""IVF/PQ retrieval and the PQ scan (K5): the PyTorch port vs the JAX package.

Same numpy inputs through ``predictionio_tpu.retrieval`` /
``predictionio_tpu.ops.pallas_kernels`` and their ports, on the CPU:

- the host builds and searches (``build_ivf``, ``build_pq``,
  ``lut_tables``, ``decode_pq``, the numpy searches, ``quantize_int8``)
  give identical arrays;
- K5's plain version against ``pq_scan_pallas(interpret=True)`` and
  ``pq_scan_xla``: equal id sets, scores within rtol = atol = 1e-5
  (float32 sums of S terms in another order), ``n_valid`` masks;
- the device searches on the CPU against the reference's, with the same
  candidates counted;
- the ``Retriever`` facade over the same corpus and structures: equal
  plans and answers under every routing knob, and a stale index or
  codebook dropped and counted.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import pq_scan_pallas, pq_scan_xla
from predictionio_tpu.retrieval import Retriever as JaxRetriever
from predictionio_tpu.retrieval import ivf as jivf
from predictionio_tpu.retrieval import pq as jpq
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.ops import pq_scan as pqs
from predictionio_tpu_torch.ops.topk import topk_mismatch
from predictionio_tpu_torch.retrieval import Retriever
from predictionio_tpu_torch.retrieval import ivf as tivf
from predictionio_tpu_torch.retrieval import pq as tpq

RTOL = 1e-5   # float32 sums in another order: a few ulps of the score
ATOL = 1e-5
CPU = torch.device("cpu")

_ENV = ("PIO_RETRIEVAL_RUNG", "PIO_SERVE_HOST_MACS", "PIO_SERVE_CHUNK_ABOVE",
        "PIO_IVF", "PIO_IVF_NLIST", "PIO_IVF_NPROBE", "PIO_IVF_MIN_ITEMS",
        "PIO_PQ", "PIO_PQ_M", "PIO_PQ_MIN_ITEMS", "PIO_PQ_RERANK",
        "PIO_CORPUS_DTYPE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)


def _corpus(n=2000, d=16, n_clusters=30, seed=0, n_q=8):
    """Direction clusters with a spread of norms (the shape of ALS
    factors) and queries near members."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    items = centers[rng.integers(0, n_clusters, n)] \
        + 0.2 * rng.normal(size=(n, d))
    items *= rng.uniform(0.5, 2.0, size=(n, 1))
    queries = items[rng.integers(0, n, n_q)] + 0.05 * rng.normal(
        size=(n_q, d))
    return queries.astype(np.float32), items.astype(np.float32)


def _assert_same(a, b):
    """Every dataclass field equal: arrays element for element."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _agree(got, want, next_s=None):
    why = topk_mismatch(np.asarray(got[0]), np.asarray(got[1]),
                        np.asarray(want[0]), np.asarray(want[1]), next_s,
                        rtol=RTOL, atol=ATOL)
    assert why is None, why


# -- host builds and searches: identical arrays -------------------------------


@pytest.mark.parametrize("nlist,seed", [(20, 0), (300, 1), (None, 2)])
def test_build_ivf_and_host_search_identical(nlist, seed):
    q, items = _corpus(n=3000, seed=seed)
    want = jivf.build_ivf(items, nlist=nlist, force=True, seed=seed)
    got = tivf.build_ivf(items, nlist=nlist, force=True, seed=seed)
    _assert_same(got, want)
    assert got.fingerprint == tivf.corpus_fingerprint(items) \
        == jivf.corpus_fingerprint(items)
    for k in (1, 10, 50):
        assert got.min_nprobe_for(k) == want.min_nprobe_for(k)
    assert got.default_nprobe() == want.default_nprobe()
    for nprobe in (1, 4, got.nlist):
        ws, wi, wn = jivf.search_ivf_host(want, items, q, 10, nprobe)
        gs, gi, gn = tivf.search_ivf_host(got, items, q, 10, nprobe)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gi, wi)
        assert gn == wn


@pytest.mark.parametrize("m,ivf_nlist", [
    (4, None),     # coarse book from the sample
    (5, 12),       # m not a divisor of 16 (rounds down to 4); IVF reused
    (8, 300),      # nlist > 256: the heaviest lists' centroids, refined
])
def test_build_pq_lut_decode_and_host_searches_identical(m, ivf_nlist):
    q, items = _corpus(n=3000)
    jv = tv = None
    if ivf_nlist is not None:
        jv = jivf.build_ivf(items, nlist=ivf_nlist, force=True)
        tv = tivf.build_ivf(items, nlist=ivf_nlist, force=True)
    want = jpq.build_pq(items, m=m, ivf=jv, sample=2048, iters=4)
    got = tpq.build_pq(items, m=m, ivf=tv, sample=2048, iters=4)
    _assert_same(got, want)
    assert (got.dsub, got.n_tables, got.bytes_per_item()) == \
        (want.dsub, want.n_tables, want.bytes_per_item())
    np.testing.assert_array_equal(tpq.lut_tables(got, q),
                                  jpq.lut_tables(want, q))
    np.testing.assert_array_equal(tpq.decode_pq(got), jpq.decode_pq(want))
    ids = np.array([0, 5, 2999])
    np.testing.assert_array_equal(tpq.decode_pq(got, ids),
                                  jpq.decode_pq(want, ids))
    for k, rerank in ((10, 40), (1, 1), (10, 3000)):
        for a, b in zip(tpq.search_pq_host(got, items, q, k, rerank,
                                           chunk=1024),
                        jpq.search_pq_host(want, items, q, k, rerank,
                                           chunk=1024)):
            np.testing.assert_array_equal(a, b)
        if tv is not None:
            for a, b in zip(
                    tpq.search_ivf_pq_host(tv, got, items, q, k, 3, rerank),
                    jpq.search_ivf_pq_host(jv, want, items, q, k, 3,
                                           rerank)):
                np.testing.assert_array_equal(a, b)


def test_quantize_int8_and_build_policies_identical(monkeypatch):
    _, items = _corpus(n=300)
    items[7] = 0.0
    for a, b in zip(tpq.quantize_int8(items), jpq.quantize_int8(items)):
        np.testing.assert_array_equal(a, b)
    envs = [{}, {"PIO_IVF": "off"}, {"PIO_IVF_MIN_ITEMS": "10",
                                     "PIO_IVF_NLIST": "7"},
            {"PIO_IVF_MIN_ITEMS": "10", "PIO_IVF_NLIST": "junk"},
            {"PIO_PQ_MIN_ITEMS": "100", "PIO_PQ_M": "6"},
            {"PIO_PQ_MIN_ITEMS": "100", "PIO_PQ": "0ff"},
            {"PIO_PQ_MIN_ITEMS": "100", "PIO_PQ": "off"}]
    for env in envs:
        for name in _ENV:
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        for n in (50, 1000, 300_000):
            assert tivf.ivf_build_config(n) == jivf.ivf_build_config(n), env
            for d in (16, 64, 30):
                assert tpq.pq_build_config(n, d) == \
                    jpq.pq_build_config(n, d), env
        monkeypatch.setenv("PIO_IVF_NPROBE", "3")
        idx = tivf.build_ivf(items, nlist=9, force=True)
        assert idx.default_nprobe() == 3


# -- K5's plain version vs the Pallas kernel and its XLA fallback -------------


def _luts_codes(n, m=4, n_q=8, seed=0):
    q, items = _corpus(n=n, n_q=n_q, seed=seed)
    pq = tpq.build_pq(items, m=m, sample=1024, iters=3)
    return tpq.lut_tables(pq, q), np.ascontiguousarray(pq.codes.T)


@pytest.mark.parametrize("n,k,m", [(1500, 23, 4), (900, 1, 8), (700, 100, 2),
                                   (40, 40, 4)])
def test_pq_scan_reference_matches_pallas_and_xla(n, k, m):
    luts, codes = _luts_codes(n, m=m)
    before = pqs.LAUNCHES
    s, i = pqs.pq_scan(torch.from_numpy(luts), torch.from_numpy(codes), k)
    assert pqs.LAUNCHES == before          # the CPU takes the plain version
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    want_p = pq_scan_pallas(jnp.asarray(luts), jnp.asarray(codes), k,
                            interpret=True)
    want_x = pq_scan_xla(jnp.asarray(luts), jnp.asarray(codes), k, chunk=256)
    for ws, wi in (want_p, want_x):
        ws, wi = np.asarray(ws), np.asarray(wi)
        np.testing.assert_allclose(s.numpy(), ws, rtol=RTOL, atol=ATOL)
        for row in range(len(ws)):
            assert set(i.numpy()[row]) == set(wi[row])


def test_pq_scan_n_valid_masks_and_dispatcher_edges():
    luts, codes = _luts_codes(900)
    lt, ct = torch.from_numpy(luts), torch.from_numpy(codes)
    s, i = pqs.pq_scan(lt, ct, 9, n_valid=700)
    assert int(i.max()) < 700
    for fn, kw in ((pq_scan_pallas, {"interpret": True}),
                   (pq_scan_xla, {"chunk": 256})):
        ws, wi = fn(jnp.asarray(luts), jnp.asarray(codes), 9, n_valid=700,
                    **kw)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL,
                                   atol=ATOL)
        assert all(set(i.numpy()[r]) == set(np.asarray(wi)[r])
                   for r in range(len(luts)))
    s0, i0 = pqs.pq_scan(lt, ct, 0)
    assert s0.shape == i0.shape == (8, 0)
    s, i = pqs.pq_scan(lt, ct, 5000)           # k clamps to N
    assert s.shape == (8, 900)
    with pytest.raises(ValueError, match="CUDA"):
        pqs.pq_scan_cuda(lt, ct, 9)            # no quiet CPU fallback


@pytest.mark.parametrize("b,n,s,k", [(1, 1, 1, 1), (1, 1_048_576, 17, 40),
                                     (64, 1_048_576, 17, 40),
                                     (3, 100_003, 65, 4000),
                                     (8, 511, 33, 1000), (9, 4095, 17, 10),
                                     (2, 40_000, 17, 16_128),
                                     (7, 0, 5, 3)])
def test_pq_scan_plan_geometry(b, n, s, k):
    """A block of one query scores 16 items a thread a round, a block of
    several 4; every chunk is whole rounds and the chunks cover the
    scanned items; the merge's candidates stay within MAX_CANDIDATES."""
    p = pqs.plan(b, n, s, k)
    assert p.buffer >= k + pqs.THREADS and p.buffer & (p.buffer - 1) == 0
    per_query = s * 256 * 4 + p.buffer * 8
    assert 1 <= p.queries_per_block <= min(b, pqs.MAX_QUERIES_PER_BLOCK)
    assert p.queries_per_block * per_query <= pqs.SMEM_BUDGET
    assert p.items_per_thread == (16 if p.queries_per_block == 1 else 4)
    assert p.rows_per_chunk % (pqs.THREADS * p.items_per_thread) == 0
    assert (p.n_chunks - 1) * p.rows_per_chunk < max(n, 1) \
        <= p.n_chunks * p.rows_per_chunk
    assert p.n_chunks * k <= max(pqs.MAX_CANDIDATES, k)
    groups = -(-b // p.queries_per_block)
    assert groups * p.n_chunks <= max(pqs.TARGET_BLOCKS + groups, groups)


def test_pq_scan_plan_rejects_k_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        pqs.plan(1, 10_000, 65, 20_000)


# -- device searches on the CPU vs the reference's ---------------------------


@pytest.fixture(scope="module")
def structures():
    q, items = _corpus(n=2000, n_q=8)
    jv = jivf.build_ivf(items, nlist=20, force=True)
    tv = tivf.build_ivf(items, nlist=20, force=True)
    jp = jpq.build_pq(items, m=4, ivf=jv)
    tp = tpq.build_pq(items, m=4, ivf=tv)
    return q, items, (jv, jp), (tv, tp)


def _staged(tv, tp, items, dtype="f32"):
    ivf_c = (torch.from_numpy(tv.centroids), torch.from_numpy(tv.lists))
    pq_c = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (tp.coarse, tp.codebooks, tp.codes.T))
    if dtype == "int8":
        q8, sc = tpq.quantize_int8(items)
        rr = (torch.from_numpy(q8), torch.from_numpy(sc))
    else:
        rr = (torch.from_numpy(items).to(
            torch.bfloat16 if dtype == "bf16" else torch.float32), None)
    return ivf_c, pq_c, rr


def _jax_staged(jv, jp, items, dtype="f32"):
    ivf_c = (jnp.asarray(jv.centroids), jnp.asarray(jv.lists))
    pq_c = (jnp.asarray(jp.coarse), jnp.asarray(jp.codebooks),
            jnp.asarray(np.ascontiguousarray(jp.codes.T)))
    if dtype == "int8":
        q8, sc = jpq.quantize_int8(items)
        rr = (jnp.asarray(q8), jnp.asarray(sc))
    else:
        rr = (jnp.asarray(items, jnp.bfloat16 if dtype == "bf16"
                          else jnp.float32), None)
    return ivf_c, pq_c, rr


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("k,nprobe,rerank", [(10, 3, 40), (1, 1, 1),
                                             (10, 20, 2000)])
def test_device_searches_match_reference(structures, dtype, k, nprobe,
                                         rerank):
    q, items, (jv, jp), (tv, tp) = structures
    ivf_c, pq_c, rr = _staged(tv, tp, items, dtype)
    jivf_c, jpq_c, jrr = _jax_staged(jv, jp, items, dtype)
    got = tpq.search_pq_device(tp, q, k, rerank, consts=pq_c,
                               rerank_consts=rr)
    want = jpq.search_pq_device(jp, q, k, rerank, jit_cache={},
                                consts=jpq_c, rerank_consts=jrr)
    _agree(got[:2], want[:2])
    assert got[2] == want[2]
    got = tpq.search_ivf_pq_device(tv, tp, q, k, nprobe, rerank,
                                   ivf_consts=ivf_c, pq_consts=pq_c,
                                   rerank_consts=rr)
    want = jpq.search_ivf_pq_device(jv, jp, q, k, nprobe, rerank,
                                    jit_cache={}, ivf_consts=jivf_c,
                                    pq_consts=jpq_c, rerank_consts=jrr)
    _agree(got[:2], want[:2])
    assert got[2] == want[2]
    if dtype == "f32":
        got = tivf.search_ivf_device(tv, torch.from_numpy(items), q, k,
                                     nprobe, jit_cache={}, consts=ivf_c)
        want = jivf.search_ivf_device(jv, jnp.asarray(items), q, k, nprobe,
                                      jit_cache={}, consts=jivf_c)
        _agree(got[:2], want[:2])
        assert got[2] == want[2]
        assert got[1].dtype == np.int32


def test_ivf_device_search_stages_its_constants_once(structures):
    q, items, _, (tv, _) = structures
    cache = {}
    first = tivf.search_ivf_device(tv, torch.from_numpy(items), q, 10, 4,
                                   jit_cache=cache)
    staged = cache[("ivf_consts",)]
    second = tivf.search_ivf_device(tv, torch.from_numpy(items), q, 10, 4,
                                    jit_cache=cache)
    assert cache[("ivf_consts",)] is staged
    np.testing.assert_array_equal(first[1], second[1])


# -- the facade ---------------------------------------------------------------


_N_ROWS, _N_ITEMS = 2100, 2000   # rows past n_items are padding


@pytest.fixture(scope="module")
def facades():
    """Reference and port retrievers over one padded corpus: with IVF
    and PQ, with PQ only, and with IVF only."""
    q, items = _corpus(n=_N_ITEMS, n_q=64, seed=5)
    vecs = np.concatenate([items, np.full((_N_ROWS - _N_ITEMS, 16), 30.0,
                                          np.float32)])
    out = {}
    for kind in ("ivf+pq", "pq", "ivf"):
        jv = tv = jp = tp = None
        if "ivf" in kind:
            jv = jivf.build_ivf(items, nlist=16, force=True)
            tv = tivf.build_ivf(items, nlist=16, force=True)
        if "pq" in kind:
            jp = jpq.build_pq(items, m=4, ivf=jv)
            tp = tpq.build_pq(items, m=4, ivf=tv)
        out[kind] = (
            JaxRetriever(jnp.asarray(vecs), n_items=_N_ITEMS, ivf=jv, pq=jp,
                         name=f"parity-{kind}"),
            Retriever(vecs, n_items=_N_ITEMS, ivf=tv, pq=tp,
                      name=f"parity-{kind}", device="cpu"))
    return q, items, out


_PLAN_ENVS = [
    {}, {"PIO_RETRIEVAL_RUNG": "ivf"}, {"PIO_RETRIEVAL_RUNG": "ivf_pq"},
    {"PIO_RETRIEVAL_RUNG": "pq_flat"}, {"PIO_RETRIEVAL_RUNG": "host"},
    {"PIO_RETRIEVAL_RUNG": "device"}, {"PIO_RETRIEVAL_RUNG": "chunked"},
    {"PIO_RETRIEVAL_RUNG": "sharded"}, {"PIO_PQ_RERANK": "7"},
    {"PIO_PQ_RERANK": "300"}, {"PIO_PQ_RERANK": "junk"},
    {"PIO_IVF_NPROBE": "2"}, {"PIO_IVF_NPROBE": "1000"},
    {"PIO_SERVE_HOST_MACS": "0"},
    {"PIO_RETRIEVAL_RUNG": "ivf_pq", "PIO_PQ_RERANK": "1500",
     "PIO_IVF_NPROBE": "1"},
]


@pytest.mark.parametrize("kind", ["ivf+pq", "pq", "ivf"])
@pytest.mark.parametrize("env", _PLAN_ENVS, ids=lambda e: ",".join(
    f"{k[4:]}={v}" for k, v in e.items()) or "auto")
def test_plans_agree_with_reference(facades, monkeypatch, kind, env):
    _, _, out = facades
    jax_r, port_r = out[kind]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for b in (1, 3, 64):
        for num in (0, 1, 7, 100, 5000):
            for has_exclude in (False, True):
                want = jax_r.plan(b, num, has_exclude=has_exclude)
                got = port_r.plan(b, num, has_exclude=has_exclude)
                assert (got.rung, got.k, got.nprobe, got.rerank) == \
                    (want.rung, want.k, want.nprobe, want.rerank), \
                    (env, b, num, has_exclude)


@pytest.mark.parametrize("kind", ["ivf+pq", "pq", "ivf"])
@pytest.mark.parametrize("rung", ["auto", "ivf", "ivf_pq", "pq_flat"])
@pytest.mark.parametrize("host_macs", [None, "0"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_answers_agree_with_reference(facades, monkeypatch, kind, rung,
                                      host_macs, dtype):
    q, items, out = facades
    jax_r, port_r = out[kind]
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", rung)
    monkeypatch.setenv("PIO_CORPUS_DTYPE", dtype)
    if host_macs is not None:
        monkeypatch.setenv("PIO_SERVE_HOST_MACS", host_macs)
    for b, num, extra in ((1, 10, {}), (5, 7, {"PIO_PQ_RERANK": "100"}),
                          (64, 10, {"PIO_IVF_NPROBE": "3"})):
        for name, value in extra.items():
            monkeypatch.setenv(name, value)
        rs, ri, rinfo = jax_r.topk(q[:b], num)
        s, i, info = port_r.topk(q[:b], num)
        for key in ("rung", "k", "nprobe", "rerank", "candidates"):
            assert info[key] == rinfo[key], key
        assert i.dtype == np.int32 and int(i.max()) < _N_ITEMS
        _agree((s, i), (rs, ri))
        for name in extra:
            monkeypatch.delenv(name)


@pytest.mark.parametrize("kind", ["ivf+pq", "pq"])
def test_exclude_pins_an_exact_rung_like_the_reference(facades, monkeypatch,
                                                       kind):
    q, _, out = facades
    jax_r, port_r = out[kind]
    monkeypatch.setenv("PIO_RETRIEVAL_RUNG", "pq_flat")
    excl = np.random.default_rng(3).random((3, _N_ITEMS)) < 0.3
    rs, ri, rinfo = jax_r.topk(q[:3], 10, exclude=excl)
    s, i, info = port_r.topk(q[:3], 10, exclude=excl)
    assert info["rung"] == rinfo["rung"] == "host"
    _agree((s, i), (rs, ri))
    assert not excl[np.arange(3)[:, None], i].any()


def test_stale_structures_are_dropped_and_counted():
    q, items = _corpus(n=500, n_q=2, seed=7)
    other = items.copy()
    other[0] += 1.0                           # another generation's vectors
    ivf = tivf.build_ivf(other, nlist=8, force=True)
    pq = tpq.build_pq(other, m=4, ivf=ivf)
    reg = get_registry()
    r = Retriever(items, ivf=ivf, pq=pq, name="stale-corpus", device="cpu")
    assert r.plan(1, 10).rung == "host"       # exact serving continues
    assert r.ivf_index() is None and r.pq_codebook() is None
    for name in ("pio_retrieval_ivf_rejected_total",
                 "pio_retrieval_pq_rejected_total"):
        assert reg.get(name).value(corpus="stale-corpus") == 1.0
    s, i, info = r.topk(q, 10)
    assert info["rung"] == "host"
    fresh = Retriever(other, ivf=ivf, pq=pq, name="fresh-corpus",
                      device="cpu")
    assert fresh.plan(1, 10).rung == "ivf_pq"
    assert reg.get("pio_retrieval_ivf_rejected_total").value(
        corpus="fresh-corpus") == 0.0


def test_rejected_counter_families_match_reference():
    from predictionio_tpu.obs import get_registry as jax_registry

    q, items = _corpus(n=300, n_q=1)
    JaxRetriever(items, name="fam")
    Retriever(items, name="fam", device="cpu")
    for name in ("pio_retrieval_ivf_rejected_total",
                 "pio_retrieval_pq_rejected_total"):
        want, got = jax_registry().get(name), get_registry().get(name)
        assert (got.kind, got.labelnames, got.help) == \
            (want.kind, want.labelnames, want.help)


def test_staged_constants_and_rerank_corpus(facades, monkeypatch):
    _, items, out = facades
    _, port_r = out["ivf+pq"]
    cent, lists = port_r.ivf_device_arrays()
    assert port_r.ivf_device_arrays()[0] is cent
    coarse, books, codes = port_r.pq_device_arrays()
    assert codes.dtype == torch.uint8 and codes.shape == (5, _N_ITEMS)
    np.testing.assert_array_equal(codes.numpy(),
                                  port_r.pq_codebook().codes.T)
    assert port_r.rerank_arrays()[0] is port_r.device_vecs()
    monkeypatch.setenv("PIO_CORPUS_DTYPE", "bf16")
    vecs, scales = port_r.rerank_arrays()
    assert vecs.dtype == torch.bfloat16 and scales is None
    assert vecs.shape == (_N_ITEMS, 16)
    monkeypatch.setenv("PIO_CORPUS_DTYPE", "int8")
    vecs, scales = port_r.rerank_arrays()
    assert vecs.dtype == torch.int8 and scales.shape == (_N_ITEMS,)
    assert port_r.rerank_arrays()[0] is vecs
    monkeypatch.setenv("PIO_CORPUS_DTYPE", "fp4")   # warns, stages f32
    assert port_r.rerank_arrays()[1] is None
