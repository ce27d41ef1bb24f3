"""The result cache of the port against the reference's.

``predictionio_tpu_torch.serving.result_cache`` is held against
``predictionio_tpu.serving.result_cache`` on the CPU:

- the cases of the reference's ``tests/test_result_cache.py`` on BOTH
  packages (``pkg``): canonical serialization, the LRU's entry and byte
  bounds, the negative TTL under an injectable clock (no sleeps),
  generation keying with mid-flight fills, the kill switch, and the
  shared tier over each package's ``MemoryKV``;
- ``canonical_query`` gives the same string in both packages on
  hypothesis-generated queries, dataclass and dict;
- one hit/miss/eviction/negative-TTL script under a fake clock gives the
  same results, snapshots and counters in both;
- the port's server seam: a repeated ``/queries.json`` is a hit under the
  generation the dispatch stamped on the request's waterfall (the fill is
  dropped when that stamp is missing), a reload misses, and the kill
  switch registers nothing.
"""

import dataclasses
import json
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import predictionio_tpu.data.storage.memory as ref_memory
import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.metrics as ref_metrics
import predictionio_tpu.serving.result_cache as ref_rc
import predictionio_tpu_torch.data.storage.memory as port_memory
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.metrics as port_metrics
import predictionio_tpu_torch.serving.result_cache as port_rc
from predictionio_tpu_torch.obs.waterfall import current_waterfall

REF = SimpleNamespace(name="ref", rc=ref_rc, memory=ref_memory,
                      metrics=ref_metrics, registry=ref_obs.get_registry,
                      reset=ref_obs.reset_observability)
PORT = SimpleNamespace(name="port", rc=port_rc, memory=port_memory,
                       metrics=port_metrics, registry=port_obs.get_registry,
                       reset=lambda: port_obs.get_registry().reset())
PKGS = (REF, PORT)

POS = {"itemScores": [{"item": "i1", "score": 1.5}]}
NEG = {"itemScores": []}


@pytest.fixture(autouse=True)
def _fresh_registries():
    for p in PKGS:
        p.reset()
    yield
    for p in PKGS:
        p.reset()


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@dataclasses.dataclass
class Q:
    user: str
    num: int = 10
    exclude: list = dataclasses.field(default_factory=list)


def _cache(pkg, clock=None, **cfg):
    kw = {"clock": clock} if clock is not None else {}
    c = pkg.rc.ResultCache(pkg.rc.ResultCacheConfig(**cfg), **kw)
    c.on_generation(1, "fpA")
    return c


# -- canonical serialization ---------------------------------------------------

def test_key_order_never_matters(pkg):
    cq = pkg.rc.canonical_query
    assert cq({"num": 3, "user": "u1"}) == cq({"user": "u1", "num": 3})


def test_explicit_default_strips_to_the_same_entry(pkg):
    cq = pkg.rc.canonical_query
    assert cq(Q("u1")) == cq(Q("u1", 10))
    d = pkg.rc.query_defaults(Q)
    assert cq({"user": "u1"}, d) == cq({"user": "u1", "num": 10}, d)
    assert cq(Q("u1", 5)) != cq(Q("u1"))


def test_integral_floats_normalize(pkg):
    cq, d = pkg.rc.canonical_query, pkg.rc.query_defaults(Q)
    assert cq({"user": "u1", "num": 10.0}, d) == cq({"user": "u1"}, d)
    assert cq({"user": "u1", "num": 3.0}, d) == cq({"user": "u1", "num": 3},
                                                   d)


def test_default_factory_container_strips(pkg):
    cq = pkg.rc.canonical_query
    assert cq(Q("u1", exclude=[])) == cq(Q("u1"))


def test_exclude_carrying_queries_key_distinctly(pkg):
    cq = pkg.rc.canonical_query
    a, b = cq(Q("u1", exclude=["i1"])), cq(Q("u1", exclude=["i1"]))
    assert a == b
    assert a != cq(Q("u1", exclude=["i2"])) and a != cq(Q("u1"))


def test_uncacheable_shapes_raise(pkg):
    with pytest.raises(TypeError):
        pkg.rc.canonical_query("not a query")
    with pytest.raises(TypeError):
        json.loads(pkg.rc.canonical_query({"user": object()}))


_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-10 ** 6, 10 ** 6),
    st.floats(allow_nan=False, allow_infinity=False, width=32),
    st.text(max_size=8))
_values = st.recursive(
    _scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(st.text(max_size=5), inner, max_size=4),
        st.frozensets(st.one_of(st.integers(-50, 50),
                                st.text(max_size=3)), max_size=4)),
    max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(doc=st.dictionaries(st.text(max_size=6), _values, max_size=6))
def test_canonical_dicts_equal_across_packages(doc):
    want = got = None
    try:
        want = ref_rc.canonical_query(doc)
    except TypeError:
        with pytest.raises(TypeError):
            port_rc.canonical_query(doc)
        return
    got = port_rc.canonical_query(doc)
    assert got == want


@dataclasses.dataclass
class RecQuery:
    """The shape of the shipped templates' queries (recommendation /
    similarproduct / ecommerce)."""

    user: str = ""
    num: int = 10
    categories: Optional[List[str]] = None
    whiteList: Optional[List[str]] = None
    blackList: Optional[List[str]] = None


@settings(max_examples=150, deadline=None)
@given(user=st.text(max_size=8),
       num=st.one_of(st.integers(0, 100),
                     st.integers(0, 100).map(float)),
       cats=st.one_of(st.none(), st.lists(st.text(max_size=4),
                                          max_size=3)),
       white=st.one_of(st.none(), st.lists(st.text(max_size=4),
                                           max_size=3)),
       black=st.one_of(st.none(), st.lists(st.text(max_size=4),
                                           max_size=3)))
def test_canonical_queries_equal_across_packages(user, num, cats, white,
                                                 black):
    q = RecQuery(user, num, cats, white, black)
    assert port_rc.canonical_query(q) == ref_rc.canonical_query(q)
    d_port = port_rc.query_defaults(RecQuery)
    d_ref = ref_rc.query_defaults(RecQuery)
    assert d_port == d_ref
    doc = {k: v for k, v in dataclasses.asdict(q).items() if v is not None}
    assert port_rc.canonical_query(doc, d_port) == \
        ref_rc.canonical_query(doc, d_ref)


# -- LRU bounds ----------------------------------------------------------------

def _key(pkg, user):
    return pkg.rc.canonical_query({"user": user})


def test_entry_bound_evicts_lru(pkg):
    c = _cache(pkg, max_entries=3)
    for u in range(4):
        c.fill(_key(pkg, f"u{u}"), POS, 1)
    assert c.lookup(_key(pkg, "u0")) is None
    assert c.lookup(_key(pkg, "u3")) is not None
    assert c.snapshot()["entries"] == 3
    assert pkg.registry().get(
        "pio_result_cache_evictions_total").total() >= 1


def test_lookup_refreshes_recency(pkg):
    c = _cache(pkg, max_entries=3)
    for u in range(3):
        c.fill(_key(pkg, f"u{u}"), POS, 1)
    assert c.lookup(_key(pkg, "u0")) is not None
    c.fill(_key(pkg, "u3"), POS, 1)
    assert c.lookup(_key(pkg, "u0")) is not None
    assert c.lookup(_key(pkg, "u1")) is None


def test_byte_bound_evicts(pkg):
    big = {"itemScores": [{"item": "i" * 64, "score": 1.0}
                          for _ in range(16)]}
    one = len(json.dumps(big, separators=(",", ":")))
    c = _cache(pkg, max_entries=1000, max_bytes=3 * one)
    for u in range(4):
        c.fill(_key(pkg, f"u{u}"), big, 1)
    snap = c.snapshot()
    assert snap["bytes"] <= 3 * one and snap["entries"] < 4
    assert c.lookup(_key(pkg, "u0")) is None


def test_oversized_entry_never_sticks(pkg):
    c = _cache(pkg, max_bytes=8)
    c.fill(_key(pkg, "u0"), POS, 1)
    assert c.snapshot()["entries"] == 0
    assert c.lookup(_key(pkg, "u0")) is None


# -- negative TTL ----------------------------------------------------------------

def test_negative_expires_positive_does_not(pkg):
    t = [0.0]
    c = _cache(pkg, clock=lambda: t[0], neg_ttl_s=5.0)
    pos_k, neg_k = _key(pkg, "known"), _key(pkg, "unknown")
    assert c.fill(pos_k, POS, 1) == "positive"
    assert c.fill(neg_k, NEG, 1) == "negative"
    t[0] = 4.9
    hit = c.lookup(neg_k)
    assert hit is not None and hit.negative
    t[0] = 5.1
    assert c.lookup(neg_k) is None
    assert c.lookup(pos_k) is not None
    assert c.snapshot()["entries"] == 1


def test_expired_negative_refill_restarts_ttl(pkg):
    t = [0.0]
    c = _cache(pkg, clock=lambda: t[0], neg_ttl_s=5.0)
    k = _key(pkg, "u")
    c.fill(k, NEG, 1)
    t[0] = 6.0
    assert c.lookup(k) is None
    c.fill(k, NEG, 1)
    t[0] = 10.0
    assert c.lookup(k) is not None


@pytest.mark.parametrize("result,kind", [
    (POS, "positive"), (NEG, "negative"), ({"score": 0.5}, "positive"),
    ({"label": "a"}, "positive"), ([1, 2], "positive"),
    ({"itemScores": [{"item": "x"}]}, "negative")])
def test_fill_kind_by_result_shape(pkg, result, kind):
    assert _cache(pkg).fill(_key(pkg, "u"), result, 1) == kind


# -- generation keying -------------------------------------------------------------

def test_swap_misses_rollback_revalidates(pkg):
    c = _cache(pkg)
    k = _key(pkg, "u1")
    c.fill(k, POS, 1)
    assert c.lookup(k) is not None
    c.on_generation(2, "fpB")
    assert c.lookup(k) is None
    c.on_generation(3, "fpA")
    hit = c.lookup(k)
    assert hit is not None and hit.generation == 1


def test_midflight_fill_lands_under_stamped_generation(pkg):
    c = _cache(pkg)
    c.on_generation(2, "fpB")
    k = _key(pkg, "u1")
    assert c.fill(k, POS, 1) == "positive"
    assert c.lookup(k) is None
    c.on_generation(3, "fpA")
    assert c.lookup(k) is not None


def test_unknown_generation_drops_the_fill(pkg):
    c = _cache(pkg)
    k = _key(pkg, "u1")
    assert c.fill(k, POS, 99) == "dropped"
    assert c.fill(k, POS, None) == "dropped"
    assert c.lookup(k) is None
    assert pkg.registry().get(
        "pio_result_cache_fills_total").value(kind="dropped") == 2


def test_gen_map_is_bounded(pkg):
    c = _cache(pkg)
    for g in range(2, 20):
        c.on_generation(g, f"fp{g}")
    k = _key(pkg, "u1")
    assert c.fill(k, POS, 1) == "dropped"
    assert c.fill(k, POS, 19) == "positive"


def test_unserializable_result_drops(pkg):
    assert _cache(pkg).fill(_key(pkg, "u"), {"x": object()}, 1) == "dropped"


def test_disabled_cache_registers_zero_instruments(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = pkg.rc.ResultCache(pkg.rc.ResultCacheConfig(enabled=False),
                           registry=reg)
    c.on_generation(1, "fp")
    assert c.lookup("{}") is None
    assert c.fill("{}", POS, 1) == "disabled"
    for name in pkg.rc.RESULT_CACHE_METRICS:
        assert reg.get(name) is None, name
    c.set_enabled(True)
    assert reg.get("pio_result_cache_hits_total") is not None


def test_metric_family_equal_across_packages():
    assert port_rc.RESULT_CACHE_METRICS == ref_rc.RESULT_CACHE_METRICS
    regs = []
    for p in PKGS:
        reg = p.metrics.MetricsRegistry()
        p.rc.ResultCache(p.rc.ResultCacheConfig(), registry=reg)
        regs.append(sorted((m.name, type(m).__name__, tuple(m.labelnames))
                           for m in reg.metrics()))
    assert regs[0] == regs[1]


@pytest.mark.parametrize("env", [
    {}, {"PIO_RESULT_CACHE": "0"}, {"PIO_RESULT_CACHE": "off",
                                    "PIO_RESULT_CACHE_SIZE": "5"},
    {"PIO_RESULT_CACHE_SIZE": "12", "PIO_RESULT_CACHE_BYTES": "4096",
     "PIO_RESULT_CACHE_NEG_TTL_S": "0.5", "PIO_RESULT_CACHE_SHARED": "1"},
    {"PIO_RESULT_CACHE_SIZE": "-3", "PIO_RESULT_CACHE_BYTES": "lots",
     "PIO_RESULT_CACHE_NEG_TTL_S": ""}])
def test_config_from_env_equal_across_packages(env):
    got = dataclasses.asdict(port_rc.ResultCacheConfig.from_env(env))
    want = dataclasses.asdict(ref_rc.ResultCacheConfig.from_env(env))
    assert got == want


# -- the shared tier -----------------------------------------------------------------

def _shared_pair(pkg, kv, clock=None):
    kw = {"clock": clock} if clock is not None else {}
    cfg = pkg.rc.ResultCacheConfig(shared=True)
    a = pkg.rc.ResultCache(cfg, kv=kv, **kw)
    b = pkg.rc.ResultCache(cfg, kv=kv, **kw)
    a.on_generation(1, "fpX")
    b.on_generation(7, "fpX")
    return a, b


class _BlippyKV:
    def __init__(self, pkg):
        self.kv = pkg.memory.MemoryKV()
        self.fail = False
        self.gets = 0

    def get(self, ns, key):
        self.gets += 1
        if self.fail:
            raise ConnectionError("kv down")
        return self.kv.get(ns, key)

    def put(self, ns, key, value):
        if self.fail:
            raise ConnectionError("kv down")
        return self.kv.put(ns, key, value)

    def prune(self, ns, keep):
        return self.kv.prune(ns, keep)


def test_instance_b_hits_what_a_filled(pkg):
    a, b = _shared_pair(pkg, pkg.memory.MemoryKV())
    k = _key(pkg, "u1")
    assert a.fill(k, POS, 1) == "positive"
    hit = b.lookup(k)
    assert hit is not None and hit.tier == "shared" and hit.result == POS
    assert b.lookup(k).tier == "local"


def test_negatives_are_never_shared(pkg):
    a, b = _shared_pair(pkg, pkg.memory.MemoryKV())
    k = _key(pkg, "ghost")
    assert a.fill(k, NEG, 1) == "negative"
    assert a.lookup(k) is not None
    assert b.lookup(k) is None


def test_fingerprint_scopes_the_namespace(pkg):
    a, b = _shared_pair(pkg, pkg.memory.MemoryKV())
    b.on_generation(8, "fpOTHER")
    k = _key(pkg, "u1")
    a.fill(k, POS, 1)
    assert b.lookup(k) is None


def test_blip_degrades_with_cooldown_then_recovers(pkg):
    t = [0.0]
    kv = _BlippyKV(pkg)
    a, b = _shared_pair(pkg, kv, clock=lambda: t[0])
    k = _key(pkg, "u1")
    a.fill(k, POS, 1)
    kv.fail = True
    assert b.lookup(k) is None
    n = kv.gets
    assert b.lookup(k) is None
    assert kv.gets == n
    assert pkg.registry().get(
        "pio_result_cache_shared_errors_total").total() >= 1
    kv.fail = False
    t[0] = 31.0
    assert b.lookup(k) is not None
    assert kv.gets > n


def test_foreign_bytes_in_namespace_read_as_miss(pkg):
    kv = pkg.memory.MemoryKV()
    a, b = _shared_pair(pkg, kv)
    k = _key(pkg, "u1")
    kv.put(a._ns("fpX"), a._shared_key(k), b"not json at all")
    assert b.lookup(k) is None


def test_shared_bytes_readable_across_packages():
    """One instance of each package on one KV: each hits what the other
    filled (the same namespace, key and payload)."""
    kv = port_memory.MemoryKV()
    caches = []
    for p in PKGS:
        c = p.rc.ResultCache(p.rc.ResultCacheConfig(shared=True), kv=kv)
        c.on_generation(1, "fpS")
        caches.append(c)
    ref_c, port_c = caches
    ref_c.fill(_key(REF, "r"), POS, 1)
    port_c.fill(_key(PORT, "p"), {"itemScores": [{"item": "i2",
                                                  "score": 0.25}]}, 1)
    hit = port_c.lookup(_key(PORT, "r"))
    assert hit.tier == "shared" and hit.result == POS
    hit = ref_c.lookup(_key(REF, "p"))
    assert hit.tier == "shared" and hit.result["itemScores"][0]["item"] == \
        "i2"


# -- one script through both packages ---------------------------------------------

def _script(pkg):
    t = [0.0]
    c = pkg.rc.ResultCache(pkg.rc.ResultCacheConfig(
        max_entries=4, max_bytes=400, neg_ttl_s=2.0), clock=lambda: t[0],
        wall_clock=lambda: 1000.0 + t[0])
    c.on_generation(1, "g1")
    rng = np.random.default_rng(3)
    out = []
    for step in range(120):
        t[0] += float(rng.choice([0.1, 0.5, 1.5]))
        user = f"u{int(rng.integers(7))}"
        k = pkg.rc.canonical_query({"user": user, "num": 3})
        op = rng.random()
        if op < 0.05:
            gen = int(rng.integers(1, 4))
            c.on_generation(gen, f"g{gen}")
            out.append(("gen", gen))
        elif op < 0.55:
            hit = c.lookup(k)
            out.append(("lookup", user, None if hit is None else (
                hit.result_json, hit.generation, hit.negative,
                round(hit.age_s, 9), hit.tier)))
        else:
            n = int(rng.integers(0, 4))
            res = {"itemScores": [{"item": f"i{j}", "score": j * 0.5}
                                  for j in range(n)]}
            gen = int(rng.choice([1, 2, 3, 9]))
            out.append(("fill", user, c.fill(k, res, gen)))
        out.append(("snap", c.snapshot()))
    reg = pkg.registry()
    out.append(("counters", {name: sorted(reg.get(name).series().items())
                             for name in ("pio_result_cache_hits_total",
                                          "pio_result_cache_misses_total",
                                          "pio_result_cache_fills_total",
                                          "pio_result_cache_evictions_total")
                             if reg.get(name) is not None}))
    return out


def test_scripted_sequence_is_equal_across_packages():
    ref, port = _script(REF), _script(PORT)
    assert port == ref
    assert any(e[0] == "lookup" and e[2] is not None for e in ref)
    assert any(e[0] == "fill" and e[2] == "negative" for e in ref)
    assert any(e[0] == "fill" and e[2] == "dropped" for e in ref)


# -- the port's server seam ------------------------------------------------------------

@pytest.fixture()
def port_server(tmp_path, monkeypatch):
    """A port EngineServer on the CPU over a small random ALS generation
    carried in with ``wrapper_from_numpy``."""
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import (
        engine, wrapper_from_numpy)
    from predictionio_tpu_torch.workflow.core_workflow import (
        persist_instance)

    for k in ("PIO_RESULT_CACHE", "PIO_RESULT_CACHE_SIZE",
              "PIO_RETRIEVAL_RUNG", "PIO_BATCH_ENABLED"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(0)
    storage = Storage(memory_config(tmp_path))
    eng = engine()
    variant = EngineVariant.from_dict({
        "engineFactory":
            "predictionio_tpu_torch.templates.recommendation:engine",
        "datasource": {"params": {"appName": "x"}},
        "algorithms": [{"name": "als", "params": {"rank": 4}}]})

    def persist():
        w = wrapper_from_numpy(
            rng.standard_normal((12, 4), np.float32),
            rng.standard_normal((9, 4), np.float32),
            [f"u{i}" for i in range(12)], [f"i{i}" for i in range(9)],
            rank=4)
        persist_instance(eng, variant, [w], storage)

    persist()
    servers = []

    def make():
        srv = EngineServer(eng, variant, storage, device="cpu")
        servers.append(srv)
        return srv

    yield SimpleNamespace(make=make, persist=persist)
    for srv in servers:
        srv.stop()


def _q(srv, user="u1", num=3, **extra):
    out = srv.handle("POST", "/queries.json",
                     json.dumps({"user": user, "num": num, **extra}).encode())
    payload = out[1]
    if isinstance(payload, (bytes, bytearray)):
        payload = json.loads(payload)
    return out[0], payload, out


def test_repeat_query_hits_under_the_dispatch_generation(port_server):
    srv = port_server.make()
    st1, r1, raw1 = _q(srv)
    st2, r2, raw2 = _q(srv)
    assert st1 == st2 == 200 and r1 == r2
    assert raw1[1] == raw2[1]                 # the same bytes
    reg = port_obs.get_registry()
    assert reg.get("pio_result_cache_hits_total").total() == 1
    assert reg.get("pio_result_cache_fills_total").value(
        kind="positive") == 1
    _, root = srv.handle("GET", "/", b"")
    assert root["resultCache"]["hits"] == 1
    assert root["resultCache"]["fingerprint"] == srv._instance.id
    _, stats = srv.handle("GET", "/stats.json", b"")
    assert stats["resultCache"]["hits"] == 1
    assert stats["batcher"]["default"]["requests"] == 1
    assert srv.result_cache.lookup(
        port_rc.canonical_query(srv._bind_query({"user": "u1", "num": 3}))
    ).generation == srv._generation


def test_without_the_generation_every_fill_is_dropped(port_server,
                                                      monkeypatch):
    """The pin of the hand-back: were the dispatch's generation missing
    from the request's waterfall (where the batcher stamps it, as in the
    reference), every fill would drop and nothing would hit."""
    srv = port_server.make()
    real = srv.scheduler.submit_and_wait

    def without_generation(m, q):
        result = real(m, q)
        wf = current_waterfall()
        with wf._lock:
            wf.attrs.pop("generation")
        return result

    monkeypatch.setattr(srv.scheduler, "submit_and_wait",
                        without_generation)
    _q(srv)
    _q(srv)
    reg = port_obs.get_registry()
    assert reg.get("pio_result_cache_fills_total").value(
        kind="dropped") == 2
    assert reg.get("pio_result_cache_hits_total").total() == 0


def test_semantically_equal_queries_share_one_entry(port_server):
    srv = port_server.make()
    assert srv.handle("POST", "/queries.json", b'{"user": "u2"}')[0] == 200
    reg = port_obs.get_registry()
    assert _q(srv, user="u2", num=10)[0] == 200
    assert reg.get("pio_result_cache_hits_total").total() == 1
    assert _q(srv, user="u2", num=4)[0] == 200      # another question
    assert reg.get("pio_result_cache_hits_total").total() == 1


def test_reload_misses_by_construction(port_server):
    srv = port_server.make()
    _q(srv)
    port_server.persist()                      # a newer instance
    srv.reload()
    reg = port_obs.get_registry()
    misses = reg.get("pio_result_cache_misses_total").total()
    _q(srv)
    assert reg.get("pio_result_cache_misses_total").total() == misses + 1
    assert reg.get("pio_result_cache_hits_total").total() == 0
    _q(srv)
    assert reg.get("pio_result_cache_hits_total").total() == 1


def test_unknown_user_is_a_negative_entry(port_server):
    srv = port_server.make()
    st, r, _ = _q(srv, user="ghost")
    assert st == 200 and r == {"itemScores": []}
    assert port_obs.get_registry().get("pio_result_cache_fills_total"
                                       ).value(kind="negative") == 1
    assert _q(srv, user="ghost")[1] == r


def test_kill_switch_bypasses_and_registers_nothing(port_server,
                                                   monkeypatch):
    monkeypatch.setenv("PIO_RESULT_CACHE", "off")
    srv = port_server.make()
    assert _q(srv)[0] == _q(srv)[0] == 200
    reg = port_obs.get_registry()
    for name in port_rc.RESULT_CACHE_METRICS:
        assert reg.get(name) is None, name
    assert srv.handle("GET", "/", b"")[1]["resultCache"]["enabled"] is False
    assert srv.scheduler.snapshot()["default"]["requests"] == 2
