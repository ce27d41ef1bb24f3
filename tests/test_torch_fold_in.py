"""Serve-time ALS fold-in: the PyTorch port vs the JAX package.

An unseen user who has ``rate``/``buy`` events is folded in: one host
ridge solve against the frozen item factors (``models.als.fold_in``),
whose factor then rides the same retrieval call as the trained users.
Checks, on seeded factors and events:

- the port's ``fold_in`` is bitwise the reference's (both float64
  numpy): explicit, implicit with ``YᵀY``, and a singular system that
  takes the ``lstsq`` fallback;
- the port's template answers an unseen user with the reference
  template's items, scores within 1e-5, from the same events (the
  limit, newest-first order and drop rules included) and factors;
- the contract of the wrapper: a user with no events stays cold and is
  cached negatively, ``PIO_FOLD_IN=off``, ``PIO_FOLD_IN_CACHE``, no
  transient in the pickle, a storage error degrades to the cold answer,
  and the ``pio_fold_in_total{result}`` counts;
- the shared cache: a second server on the same sqlite storage answers
  from the KV (``result="shared"``), ``PIO_FOLD_IN_SHARED`` and the max
  age behave as the reference's, and the KV entries read across
  packages.
"""

import datetime as dt
import importlib
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import BiMap as JaxBiMap
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import get_storage as jax_storage
from predictionio_tpu.models import als as jax_als
from predictionio_tpu.templates.recommendation.engine import (
    ALSAlgorithm as JaxAlgorithm,
)
from predictionio_tpu.templates.recommendation.engine import (
    ALSAlgorithmParams as JaxAlgorithmParams,
)
from predictionio_tpu.templates.recommendation.engine import (
    ALSModelWrapper as JaxWrapper,
)
from predictionio_tpu.templates.recommendation.engine import Query as JaxQuery
from predictionio_tpu_torch.controller import RuntimeContext
from predictionio_tpu_torch.data.event import BiMap, DataMap, Event
from predictionio_tpu_torch.config import memory_config
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.obs import MetricsRegistry, get_registry, \
    set_registry
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModelWrapper,
    Query,
)

PORT_ENGINE = importlib.import_module(
    "predictionio_tpu_torch.templates.recommendation.engine")
SCORE_TOL = 1e-5
APP = "foldin"
N_USERS, N_ITEMS, RANK = 30, 40, 8
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _factors(seed=0):
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    itf = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    return uf, itf


# (event, user, target type, item, properties), in event-time order.
SPECS = [
    ("rate", "unew", "item", "i3", {"rating": 5.0}),
    ("rate", "unew", "item", "i7", {"rating": 1.5}),
    ("buy", "unew", "item", "i11", {}),
    ("rate", "unew", "item", "i_unknown", {"rating": 4.0}),  # not trained
    ("rate", "unew", "item", "i5", {"rating": "4.5"}),       # not numeric
    ("rate", "unew", "item", "i6", {}),                      # no rating
    ("rate", "unew", "item", "i8", {"rating": True}),        # an int: 1.0
    ("view", "unew", "item", "i9", {"rating": 5.0}),         # not read
    ("rate", "unew", "shop", "s1", {"rating": 5.0}),         # not an item
    ("rate", "unew", "item", "i3", {"rating": 2.0}),         # again, newer
    ("rate", "uother", "item", "i1", {"rating": 3.0}),
    ("buy", "uother", "item", "i2", {}),
    ("buy", "uother", "item", "i4", {}),
]


def _insert(storage, app_cls, event_cls, map_cls, specs):
    app_id = storage.get_apps().insert(app_cls(id=None, name=APP))
    events = storage.get_events()
    events.init(app_id)
    for n, (e, u, tt, t, p) in enumerate(specs):
        events.insert(event_cls(
            event=e, entity_type="user", entity_id=u,
            target_entity_type=tt, target_entity_id=t,
            properties=map_cls(p),
            event_time=T0 + dt.timedelta(seconds=n)), app_id)
    return app_id


@pytest.fixture
def registry():
    """A fresh port registry for the test; the old one comes back."""
    old = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(old)


def _port_wrapper(tmp_path, *, implicit=False, specs=SPECS, reg=0.1):
    uf, itf = _factors()
    storage = Storage(memory_config(tmp_path / "port"))
    _insert(storage, App, Event, DataMap, specs)
    w = ALSModelWrapper(
        model=port_als.als_model_from_numpy(uf, itf, rank=RANK,
                                            implicit=implicit),
        user_index=BiMap({f"u{j}": j for j in range(N_USERS)}),
        item_index=BiMap({f"i{j}": j for j in range(N_ITEMS)}),
        app_name=APP, fold_event_names=("rate", "buy"), buy_rating=4.0,
        reg=reg, alpha=0.5)
    w.post_load(RuntimeContext.create(storage=storage, device="cpu"))
    return w, ALSAlgorithm(ALSAlgorithmParams(rank=RANK))


def _jax_wrapper(*, implicit=False, specs=SPECS, reg=0.1):
    uf, itf = _factors()
    storage = jax_storage()
    _insert(storage, JaxApp, JaxEvent, JaxDataMap, specs)
    w = JaxWrapper(
        model=jax_als.ALSModel(user_factors=jnp.asarray(uf),
                               item_factors=jnp.asarray(itf), rank=RANK,
                               implicit=implicit),
        user_index=JaxBiMap({f"u{j}": j for j in range(N_USERS)}),
        item_index=JaxBiMap({f"i{j}": j for j in range(N_ITEMS)}),
        app_name=APP, fold_event_names=("rate", "buy"), buy_rating=4.0,
        reg=reg, alpha=0.5)
    w.post_load(JaxContext.create(storage=storage))
    algo = JaxAlgorithm(JaxAlgorithmParams(rank=RANK))
    return w, algo


def _answer(algo, w, query_cls, user, num=5):
    (_, res), = algo.batch_predict(w, [(0, query_cls(user=user, num=num))])
    return [(s.item, s.score) for s in res.itemScores]


# -- fold_in itself -------------------------------------------------------

FOLD_CASES = {
    "explicit": dict(implicit=False),
    "implicit": dict(implicit=True),
    "singular": dict(implicit=False, singular=True),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_in_is_bitwise_the_reference(case):
    opts = dict(FOLD_CASES[case])
    singular = opts.pop("singular", False)
    rng = np.random.default_rng(4)
    itf = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    reg = 0.05
    if singular:
        itf[:, 3:] = 0.0          # A = YᵀY has zero rows; with reg 0 the
        reg = 0.0                 # solve raises and lstsq answers
    ids = rng.integers(0, N_ITEMS, 12)
    vals = (rng.integers(0, 11, 12) * 0.5).astype(np.float32)
    kw = dict(reg=reg, alpha=0.7, **opts)
    if opts["implicit"]:
        f = itf.astype(np.float64)
        kw["yty"] = f.T @ f
    got = port_als.fold_in(itf, ids, vals, **kw)
    want = jax_als.fold_in(itf, ids, vals, **kw)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.isfinite(got).all()
    if singular:
        with pytest.raises(np.linalg.LinAlgError):
            np.linalg.solve(itf.T.astype(np.float64) @ itf, np.ones(RANK))


def test_implicit_fold_in_needs_yty():
    _, itf = _factors()
    with pytest.raises(ValueError, match="YᵀY"):
        port_als.fold_in(itf, [1, 2], [1.0, 2.0], reg=0.1, implicit=True)


# -- the template against the reference's --------------------------------

@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("limit", [None, "4"], ids=["all", "limit4"])
def test_unseen_user_gets_the_reference_answer(pio_home, tmp_path,
                                               monkeypatch, registry,
                                               implicit, limit):
    """The repaired fault: an unseen user with events gets the
    reference's items (scores within 1e-5), not the empty answer."""
    monkeypatch.setenv("PIO_FOLD_IN_SHARED", "off")
    if limit is not None:
        monkeypatch.setenv("PIO_FOLD_IN_EVENTS", limit)
    jw, jalgo = _jax_wrapper(implicit=implicit)
    pw, palgo = _port_wrapper(tmp_path, implicit=implicit)
    for user in ("unew", "uother"):
        want = _answer(jalgo, jw, JaxQuery, user)
        got = _answer(palgo, pw, Query, user)
        assert len(want) == 5
        assert [i for i, _ in got] == [i for i, _ in want], user
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=0,
                                   atol=SCORE_TOL)
        vec_j = jw.fold_in_user(user)
        vec_p = pw.fold_in_user(user)
        assert np.array_equal(vec_p, vec_j)


def test_folded_row_rides_the_trained_users_retrieval_call(tmp_path,
                                                            registry):
    """One retrieval call for a batch of trained and folded users; the
    folded user's answer is the plain top-k of its factor."""
    pw, palgo = _port_wrapper(tmp_path)
    calls = []
    retriever = pw.retriever()
    real = retriever.topk

    def counting(q, k, *a, **kw):
        calls.append(np.asarray(q).shape)
        return real(q, k, *a, **kw)

    retriever.topk = counting
    out = dict(palgo.batch_predict(pw, [(0, Query(user="u3", num=4)),
                                        (1, Query(user="unew", num=4)),
                                        (2, Query(user="ughost", num=4))]))
    assert calls == [(2, RANK)]
    vec = pw.fold_in_user("unew")
    _, itf = pw.host_factors()
    scores = itf @ vec
    top = np.argsort(-scores, kind="stable")[:4]
    assert [s.item for s in out[1].itemScores] == [f"i{j}" for j in top]
    np.testing.assert_allclose([s.score for s in out[1].itemScores],
                               scores[top], rtol=1e-5, atol=1e-6)
    assert out[2].itemScores == []
    assert len(out[0].itemScores) == 4


# -- the wrapper's contract (reference: tests/test_refresh.py TestFoldIn) --

def test_user_with_no_events_stays_cold(tmp_path, registry):
    pw, palgo = _port_wrapper(tmp_path)
    assert _answer(palgo, pw, Query, "ughost") == []
    c = registry.get("pio_fold_in_total")
    assert c.value(result="no_events") == 1
    # the negative outcome is cached: a repeat query reads no events
    assert _answer(palgo, pw, Query, "ughost") == []
    assert c.value(result="no_events") == 1
    assert c.value(result="cached") == 1
    assert pw._fold_cache["ughost"][0] is None


def test_negative_entry_expires(tmp_path, registry):
    from predictionio_tpu_torch.templates.recommendation.engine import (
        _FOLD_NEG_TTL_S,
    )

    pw, _ = _port_wrapper(tmp_path)
    assert pw.fold_in_user("ughost") is None
    vec, stamp = pw._fold_cache["ughost"]
    pw._fold_cache["ughost"] = (vec, stamp - _FOLD_NEG_TTL_S - 1)
    assert pw.fold_in_user("ughost") is None
    c = registry.get("pio_fold_in_total")
    assert c.value(result="no_events") == 2
    assert c.value(result="cached") == 0


def test_counts_solved_then_cached(tmp_path, registry):
    pw, palgo = _port_wrapper(tmp_path)
    assert len(_answer(palgo, pw, Query, "unew", num=4)) == 4
    assert len(_answer(palgo, pw, Query, "unew", num=4)) == 4
    c = registry.get("pio_fold_in_total")
    assert c.value(result="solved") == 1
    assert c.value(result="cached") == 1
    assert c.value(result="no_events") == 0
    assert c.value(result="unavailable") == 0
    # trained users never touch fold-in
    _answer(palgo, pw, Query, "u1")
    assert c.value(result="cached") == 1


def test_fold_in_off_switch(tmp_path, registry, monkeypatch):
    pw, palgo = _port_wrapper(tmp_path)
    monkeypatch.setenv("PIO_FOLD_IN", "off")
    assert _answer(palgo, pw, Query, "unew") == []
    assert registry.get("pio_fold_in_total") is None
    monkeypatch.setenv("PIO_FOLD_IN", "")
    assert len(_answer(palgo, pw, Query, "unew")) == 5


def test_cache_is_bounded(tmp_path, registry, monkeypatch):
    specs = [("rate", f"u{name}", "item", "i0", {"rating": 4.0})
             for name in ("a", "b", "c")]
    pw, palgo = _port_wrapper(tmp_path, specs=specs)
    monkeypatch.setenv("PIO_FOLD_IN_CACHE", "2")
    for name in ("a", "b", "c"):
        assert len(_answer(palgo, pw, Query, f"u{name}", num=2)) == 2
    assert list(pw._fold_cache) == ["ub", "uc"]


def test_fold_cache_does_not_survive_pickle(tmp_path, registry):
    pw, _ = _port_wrapper(tmp_path, implicit=True)
    assert pw.fold_in_user("unew") is not None
    assert pw._yty is not None
    clone = pickle.loads(pickle.dumps(pw))
    assert len(clone._fold_cache) == 0
    assert clone._event_store is None and clone._yty is None
    assert clone._device is None
    assert clone.fold_in_user("unew") is None    # no store until post_load


def test_storage_error_degrades_to_cold_start(tmp_path, registry):
    pw, palgo = _port_wrapper(tmp_path)

    class Broken:
        def find_by_entity(self, *a, **kw):
            raise OSError("storage is down")

    pw._event_store = Broken()
    assert _answer(palgo, pw, Query, "unew") == []
    assert registry.get("pio_fold_in_total").value(
        result="unavailable") == 1
    assert "unew" not in pw._fold_cache      # the next request retries


def test_find_by_entity_newest_first_with_limit(tmp_path):
    from predictionio_tpu_torch.data.store import (
        EventStore,
        WindowedEventStore,
    )

    storage = Storage(memory_config(tmp_path / "store"))
    _insert(storage, App, Event, DataMap, SPECS)
    es = EventStore(storage)
    got = es.find_by_entity(APP, "user", "unew", event_names=["rate"],
                            target_entity_type="item", limit=3)
    assert [e.target_entity_id for e in got] == ["i3", "i8", "i6"]
    oldest = es.find_by_entity(APP, "user", "unew", latest=False, limit=2)
    assert [e.target_entity_id for e in oldest] == ["i3", "i7"]
    windowed = WindowedEventStore(storage, None, T0 + dt.timedelta(
        seconds=2))
    assert [e.target_entity_id for e in windowed.find_by_entity(
        APP, "user", "unew")] == ["i7", "i3"]


# -- the shared fold-in cache (reference: tests/test_fleet.py) -----------------

def _sqlite_wrapper(home, storage=None):
    """A wrapper served from the default sqlite storage under ``home``:
    a second call with a new Storage is a second server process."""
    from predictionio_tpu_torch.config import load_config

    uf, itf = _factors()
    storage = storage or Storage(load_config(env={"PIO_HOME": str(home)}))
    w = ALSModelWrapper(
        model=port_als.als_model_from_numpy(uf, itf, rank=RANK,
                                            implicit=False),
        user_index=BiMap({f"u{j}": j for j in range(N_USERS)}),
        item_index=BiMap({f"i{j}": j for j in range(N_ITEMS)}),
        app_name=APP, fold_event_names=("rate", "buy"), buy_rating=4.0,
        reg=0.1, alpha=0.5)
    w.post_load(RuntimeContext.create(storage=storage, device="cpu"))
    return w, storage


@pytest.fixture
def shared_pair(tmp_path, registry):
    """Two servers' wrappers on one sqlite storage, the events in it."""
    a, storage = _sqlite_wrapper(tmp_path)
    _insert(storage, App, Event, DataMap, SPECS)
    b, other = _sqlite_wrapper(tmp_path)
    yield a, b
    storage.close()
    other.close()


def test_second_server_answers_from_the_shared_cache(shared_pair, registry):
    a, b = shared_pair
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=RANK))
    first = _answer(algo, a, Query, "unew")
    c = registry.get("pio_fold_in_total")
    assert (c.value(result="solved"), c.value(result="shared")) == (1, 0)
    second = _answer(algo, b, Query, "unew")
    assert (c.value(result="solved"), c.value(result="shared")) == (1, 1)
    assert second == first and len(first) == 5
    assert b._fold_cache["unew"][0] is not None     # now in b's LRU
    _answer(algo, b, Query, "unew")
    assert c.value(result="cached") == 1
    # a user with no events is never shared
    assert _answer(algo, a, Query, "ughost") == []
    assert a._shared_kv.count(a._fold_ns()) == 1


def test_shared_switch_off(shared_pair, registry, monkeypatch):
    a, b = shared_pair
    monkeypatch.setenv("PIO_FOLD_IN_SHARED", "0")
    assert a.fold_in_user("unew") is not None
    assert a._shared_kv.count(a._fold_ns()) == 0
    assert b.fold_in_user("unew") is not None
    c = registry.get("pio_fold_in_total")
    assert (c.value(result="solved"), c.value(result="shared")) == (2, 0)


def test_shared_entry_older_than_max_age_is_a_miss(shared_pair, registry,
                                                   monkeypatch):
    a, b = shared_pair
    vec = a.fold_in_user("unew")
    monkeypatch.setenv("PIO_FOLD_IN_SHARED_MAX_AGE_S", "60")
    assert np.array_equal(b._fold_shared_get("unew"), vec)
    head, raw = PORT_ENGINE._fold_encode(vec, None).split(b"\n", 1)
    stale = json.dumps({**json.loads(head), "ts": 1.0}).encode() \
        + b"\n" + raw
    a._shared_kv.put(a._fold_ns(), "unew", stale)
    assert b._fold_shared_get("unew") is None
    assert b.fold_in_user("unew") is not None
    c = registry.get("pio_fold_in_total")
    assert (c.value(result="solved"), c.value(result="shared")) == (2, 0)
    monkeypatch.setenv("PIO_FOLD_IN_SHARED_MAX_AGE_S", "0")
    a._shared_kv.put(a._fold_ns(), "unew", stale)
    assert np.array_equal(b._fold_shared_get("unew"), vec)


def test_shared_entries_read_across_packages():
    """The KV value format is the reference's: each package decodes the
    other's entry, and a malformed or wrong-length one is a miss."""
    je = importlib.import_module(
        "predictionio_tpu.templates.recommendation.engine")
    vec = np.arange(RANK, dtype=np.float32) / 3
    for enc, dec in ((je._fold_encode, PORT_ENGINE._fold_decode),
                     (PORT_ENGINE._fold_encode, je._fold_decode)):
        got, ts = dec(enc(vec, 1_700_000_000_000_000))
        assert np.array_equal(got, vec) and ts > 1.7e9
    assert PORT_ENGINE._fold_decode(b"garbage") is None
    assert PORT_ENGINE._fold_decode(
        b'{"n": 3, "ts": 1}\n' + vec.tobytes()) is None
